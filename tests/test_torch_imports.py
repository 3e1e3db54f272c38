"""The port stands alone: it imports torch and never JAX or the JAX package,
and its entry points refuse to run on the CPU unless asked to."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tacotron2_tpu_torch import http_server, infer
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.infer import synthesize
from tacotron2_tpu_torch.models import hifigan, waveglow
from tacotron2_tpu_torch.models import tacotron2 as tm
from tacotron2_tpu_torch.serve import BatchingSynthesizer, VocoderRunner
from tacotron2_tpu_torch.streaming import StreamingSynthesizer
from tacotron2_tpu_torch.training.hifigan_trainer import create_hifigan_state
from tacotron2_tpu_torch.training.vocoder_trainer import create_vocoder_state

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "tacotron2_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "tacotron2_tpu")

SMALL = Tacotron2Config(
    n_symbols=148, symbols_embedding_dim=16, encoder_embedding_dim=16,
    encoder_n_convolutions=1, attention_rnn_dim=16, decoder_rnn_dim=16,
    prenet_dim=8, attention_dim=8, attention_location_n_filters=2,
    attention_location_kernel_size=5, postnet_embedding_dim=8,
    postnet_n_convolutions=2, n_mel_channels=8)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tacotron2_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split()
    assert "tacotron2_tpu_torch.serve" in out
    assert "tacotron2_tpu_torch.kernels.decoder_batch" in out
    for new in ("audio.filters", "audio.stft", "audio.mel", "infer",
                "streaming", "models.hifigan", "kernels.decoder_step",
                "kernels.int8_matmul", "kernels.mel_kernel",
                "data.dataset", "data.pipeline", "text.arpabet",
                "training.schedules", "training.diagnostics",
                "training.logging", "training.checkpoint",
                "training.trainer", "train", "tools.train_demo",
                "tools.synthesis_check", "kernels.gate_probe",
                "models.waveglow", "convert_waveglow", "http_server",
                "training.vocoder_trainer", "training.hifigan_trainer",
                "training.audio_batch", "tools.train_vocoder",
                "tools.train_hifigan", "parallel.mesh", "parallel.sharding",
                "parallel.step", "training.accumulate",
                "training.loss_scaler", "utils.profiling", "data.native"):
        assert f"tacotron2_tpu_torch.{new}" in out
    assert [m for m in out if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


HG = hifigan.HiFiGANConfig(
    n_mel_channels=8, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
    upsample_initial_channel=8, resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1,),))
WG = waveglow.WaveGlowConfig(n_mel_channels=8, n_flows=2, n_early_every=4,
                             wn_layers=2, wn_channels=8, upsample_kernel=8,
                             upsample_stride=4)


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    model = tm.Tacotron2(SMALL)
    voc = hifigan.Generator(HG)
    text, lengths = torch.ones(1, 4, dtype=torch.long), torch.tensor([4])
    makers = {
        "BatchingSynthesizer": lambda **kw: BatchingSynthesizer(
            model, SMALL, **kw).close(),
        "StreamingSynthesizer": lambda **kw: StreamingSynthesizer(
            model, SMALL, vocoder=voc, vocoder_cfg=HG, **kw),
        "VocoderRunner": lambda **kw: VocoderRunner(
            "hifigan", voc, HG, max_frames=8, **kw),
        "synthesize": lambda **kw: synthesize(
            model, ["hi"], SMALL, vocoder="none", max_steps=2, **kw),
    }
    for entry in (tm.infer, tm.infer_batch_fused, tm.infer_fused):
        makers[entry.__name__] = lambda entry=entry, **kw: entry(
            model, text, lengths, SMALL, max_steps=2, **kw)

    def server(**kw):
        srv = http_server.make_server(model, SMALL, port=0, **kw)
        srv.server_close()
        srv.RequestHandlerClass.synthesizer.close()
    makers["make_server"] = server
    makers["WaveGlow VocoderRunner"] = lambda **kw: VocoderRunner(
        "waveglow", waveglow.WaveGlow(WG), WG, max_frames=8, **kw)
    makers["create_vocoder_state"] = lambda **kw: create_vocoder_state(
        WG, **kw)
    makers["create_hifigan_state"] = lambda **kw: create_hifigan_state(
        HG, **kw)
    for name, make in makers.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        make(device="cpu")
    for main in (infer.main, http_server.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["-c", "unused", "-t", "hi"] if main is infer.main
                 else ["-c", "unused"])
    # refused before the file is read
    from tacotron2_tpu_torch.convert_waveglow import load_waveglow_checkpoint
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_waveglow_checkpoint("unused.pt", WG)


def test_int8_weights_are_refused():
    """A state_dict with int8 weights is served (it was refused until the
    int8 kernel was ported); one whose ``w_q`` does not fit the config's
    cells is still refused, by the strict load."""
    model = tm.quantize_for_serving(tm.Tacotron2(SMALL))
    sd = dict(model.state_dict())
    synth = BatchingSynthesizer(sd, SMALL, device="cpu")
    try:
        assert synth.quantized
    finally:
        synth.close()
    sd["decoder.attention_rnn.w_q"] = torch.zeros(4, dtype=torch.int8)
    with pytest.raises(RuntimeError, match="size mismatch"):
        BatchingSynthesizer(sd, SMALL, device="cpu")


def test_kernel_wrappers_take_plain_versions_on_cpu():
    """A CPU model runs the whole serving path through the plain versions:
    neither kernel's launch count moves."""
    from tacotron2_tpu_torch.kernels import decoder_batch as db
    from tacotron2_tpu_torch.kernels import encoder_lstm as el
    launches = (el.bilstm_forward.launches, db.decoder_chunk.launches)
    plain = (el.bilstm_forward_plain.calls, db.decoder_chunk_plain.calls)
    cfg = SMALL.replace(gate_threshold=1.0)  # never latches: 2 chunks
    model = tm.Tacotron2(cfg, torch.Generator().manual_seed(0))
    res = tm.infer_batch_fused(model, torch.ones(2, 5, dtype=torch.long),
                               torch.tensor([5, 3]), cfg, max_steps=4,
                               chunk_steps=2, device="cpu")
    assert res.mel_postnet.shape == (2, 4, 8)
    assert (el.bilstm_forward.launches, db.decoder_chunk.launches) == launches
    assert el.bilstm_forward_plain.calls == plain[0] + 1
    assert db.decoder_chunk_plain.calls == plain[1] + 2


def test_training_entry_points_need_a_card_unless_asked_for_cpu(tmp_path):
    """``Trainer``, the train CLI, the tone demo and the gate's check run
    on CUDA by default and raise without a card; none carries on on the
    CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from tacotron2_tpu_torch import train
    from tacotron2_tpu_torch.data.pipeline import DeviceTransfer
    from tacotron2_tpu_torch.tools import synthesis_check, train_demo
    from tacotron2_tpu_torch.training.trainer import Trainer
    hp = ("symbols_embedding_dim=16,encoder_embedding_dim=16,"
          "attention_rnn_dim=16,decoder_rnn_dim=16,prenet_dim=8")
    calls = {
        "Trainer": lambda: Trainer(SMALL, str(tmp_path / "t")),
        "train.main": lambda: train.main(["-o", str(tmp_path / "c"),
                                          "--hparams", hp]),
        "train_demo.run": lambda: train_demo.run(
            1, str(tmp_path / "d"), hparams=hp, n_utts=2),
        "check_checkpoint": lambda: synthesis_check.check_checkpoint(
            str(tmp_path / "none"), hparams=hp),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="CUDA device"):
        DeviceTransfer("cpu")
    Trainer(SMALL, str(tmp_path / "cpu"), device="cpu")
