"""``serve.VocoderRunner.submit`` on the CPU: a future of the audio that
``__call__`` gives and that the plain reference generator
(``benchmark/reference/hifigan.py``) gives for the mel padded to its bucket
and trimmed back; and submits from many threads at once, run in the order
they were made, one at a time, on the runner's one thread. On the card
(marker ``gpu``, skipped without one), the runner's CUDA graph of a bucket
gives the eager generator's audio."""

import sys
import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from benchmark import weights_hifigan
from benchmark.reference import hifigan as ref
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.infer import load_vocoder
from tacotron2_tpu_torch.models import hifigan as th
from tacotron2_tpu_torch.serve import VocoderRunner

KW = dict(n_mel_channels=8, upsample_rates=(4, 4),
          upsample_kernel_sizes=(8, 8), upsample_initial_channel=16,
          resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3),
                                                                 (1, 3)))
V = {"resblock": "1", "num_mels": 8, "upsample_rates": [4, 4],
     "upsample_kernel_sizes": [8, 8], "upsample_initial_channel": 16,
     "resblock_kernel_sizes": [3, 5],
     "resblock_dilation_sizes": [[1, 3], [1, 3]], "hop_size": 16}
STEP, MAX_FRAMES = 8, 32


@pytest.fixture(scope="module")
def runner():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = th.HiFiGANConfig(**KW)
    gen = th.Generator(cfg)
    gen.load_state_dict(weights_hifigan.generator(V, 3, "cpu"), strict=True)
    yield VocoderRunner("hifigan", gen, cfg, max_frames=MAX_FRAMES,
                        bucket_step=STEP, device="cpu")
    torch.set_num_threads(n)


def mel(frames, seed=0):
    return (0.15 * np.random.RandomState(seed).randn(frames, 8)).astype(
        np.float32)


@pytest.mark.parametrize("frames", [13, 1, 33])
def test_submit_matches_call_and_the_reference(runner, frames):
    """13 frames vocode in a bucket of 16, 1 in one of 8, 33 (past
    ``max_frames``) unpadded: the future's audio is ``__call__``'s, bit
    for bit, and the reference's on the mel zero-padded to its bucket,
    trimmed to frames x hop samples, within fp32 rounding (atol 1e-5 on
    audio of order 0.1: the same convolutions, channels last against
    channels first, summed in another order)."""
    m = mel(frames, seed=frames)
    fut = runner.submit(m)
    assert isinstance(fut, Future)
    got = fut.result()
    assert got.shape == (frames * 16,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, runner(m))
    bucket = min(-(-frames // STEP) * STEP, max(MAX_FRAMES, frames))
    assert bucket == {13: 16, 1: 8, 33: 33}[frames]
    padded = torch.zeros(1, 8, bucket)
    padded[0, :, :frames] = torch.from_numpy(m).T
    want = ref.generator(weights_hifigan.generator(V, 3, "cpu"), padded,
                         ref.Dims.of(V))[0, :frames * 16]
    assert float(want.abs().max()) > 1e-2
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5)


def test_submits_from_many_threads_run_in_order_on_one(runner):
    """Eight threads submit three mels each at once, with a short switch
    interval: every call runs on the runner's one thread, in the order
    the submits were made, each future resolved before the next call
    starts, each with its own audio."""
    vocode = runner._vocode
    ran, lock = [], threading.Lock()
    order, futures = [], {}

    def spy(m):
        ran.append((threading.get_ident(), int(m[0, 0] * 1e6)))
        assert all(futures[k].done() for k in order[:len(ran) - 1])
        return vocode(m)
    mels = {(t, j): mel(3 + j, seed=10 * t + j) for t in range(8)
            for j in range(3)}
    want = {k: vocode(m) for k, m in mels.items()}
    runner._vocode = spy
    start = threading.Barrier(8)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def submitter(t):
        start.wait()
        for j in range(3):
            with lock:
                order.append((t, j))
                futures[(t, j)] = runner.submit(mels[(t, j)])
    try:
        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(8)]
        for th_ in threads:
            th_.start()
        for th_ in threads:
            th_.join(timeout=120)
            assert not th_.is_alive()
        got = {k: f.result(timeout=120) for k, f in futures.items()}
    finally:
        runner._vocode = vocode
        sys.setswitchinterval(interval)
    callers = {th_.ident for th_ in threads} | {threading.get_ident()}
    assert len({tid for tid, _ in ran}) == 1
    assert not {tid for tid, _ in ran} & callers
    assert [key for _, key in ran] == [int(mels[k][0, 0] * 1e6)
                                       for k in order]
    for k in mels:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("saved, slope", [(None, th.LRELU_SLOPE),
                                          (0.01, 0.01), (0.1, 0.1)])
def test_checkpoint_keeps_its_slope(tmp_path, saved, slope):
    """A HiFi-GAN checkpoint carries its slope before ``conv_post``; one
    written before that slope was a setting (no such key) was trained at
    ``LRELU_SLOPE`` there, and loads so."""
    cfg = th.HiFiGANConfig(**KW)
    config = cfg._asdict()
    if saved is None:
        del config["post_lrelu_slope"]
    else:
        config["post_lrelu_slope"] = saved
    path = str(tmp_path / "hifigan.pt")
    torch.save({"kind": "hifigan", "config": config,
                "state_dict": th.Generator(cfg).state_dict()}, path)
    _, got = load_vocoder("hifigan", path,
                          Tacotron2Config(n_mel_channels=8, hop_length=16),
                          device="cpu")
    assert got.post_lrelu_slope == slope


@pytest.mark.gpu
def test_graphed_buckets_match_the_eager_generator():
    """On a CUDA device a bucket up to ``max_frames`` vocodes through one
    CUDA graph, captured on its first call; 13 then 9 frames share the
    bucket of 16 (the second call zeroes the frames the first left in the
    buffer), 1 frame takes the bucket of 8, and 33 frames (past
    ``max_frames``) run eagerly and capture nothing. Each call's audio is
    the eager generator's on the same padded mel within 1e-6: the same
    cuDNN convolutions on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    cfg = th.HiFiGANConfig(**KW)
    gen = th.Generator(cfg)
    gen.load_state_dict(weights_hifigan.generator(V, 5, "cpu"), strict=True)
    runner = VocoderRunner("hifigan", gen, cfg, max_frames=MAX_FRAMES,
                           bucket_step=STEP, device="cuda")
    for frames, bucket in [(13, 16), (9, 16), (1, 8), (33, 33)]:
        m = mel(frames, seed=20 + frames)
        got = runner(m)
        padded = torch.zeros(1, bucket, 8, device="cuda")
        padded[0, :frames] = torch.from_numpy(m)
        with torch.no_grad():
            want = th.generator(runner.model, padded, cfg)[0, :frames * 16]
        assert got.shape == (frames * 16,)
        assert float(want.abs().max()) > 1e-2
        np.testing.assert_allclose(got, want.cpu().numpy(), atol=1e-6)
    assert sorted(runner._graphs) == [8, 16]
