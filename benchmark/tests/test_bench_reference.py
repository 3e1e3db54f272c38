"""The plain references against themselves in fp64, at small widths."""

import torch

from benchmark import weights
from benchmark.reference import tacotron2 as ref
from benchmark.tests import tiny

torch.set_num_threads(2)


def _batch(c, B=3, T_in=12, T_out=20, seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, 60, (B, T_in), generator=g)
    lens = torch.tensor([T_in, T_in - 3, T_in - 5])
    for b in range(B):
        ids[b, lens[b]:] = 0
    mel_l = torch.tensor([T_out, T_out - 4, T_out - 9])
    target = torch.randn(B, T_out, c["n_mel_channels"], generator=g)
    gate = torch.zeros(B, T_out)
    for b in range(B):
        target[b, mel_l[b]:] = 0
        gate[b, mel_l[b] - 1:] = 1
    return ids, lens, target, mel_l, gate


def _as(W, dtype):
    return {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in W.items()}


def test_training_forward_and_gradients_fp32_against_fp64():
    c = tiny.config()
    d = ref.Dims.of(c)
    W = weights.tacotron2(c, 5, "cpu")
    ids, lens, target, mel_l, gate = _batch(c)
    masks = ref.draw_masks(d, 3, ids.shape[1], target.shape[1],
                           torch.Generator().manual_seed(9))
    names = weights.parameter_names(W)
    out = {}
    for dtype in (torch.float32, torch.float64):
        Wd = _as(W, dtype)
        leaves = [Wd[k].requires_grad_(True) for k in names]
        net = ref.Net(Wd, d)
        mel, post, g = net.train_forward(ids, lens, target.to(dtype), mel_l,
                                         masks)
        loss = ref.loss(mel, post, g, target.to(dtype), gate.to(dtype))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out[dtype] = (float(loss), [None if x is None else x.double()
                                    for x in grads])
    (l32, g32), (l64, g64) = out[torch.float32], out[torch.float64]
    assert abs(l32 - l64) <= 1e-5 * abs(l64)
    # against the leaf's largest |value| or the median leaf's, whichever
    # is larger: the conv biases before batchnorm have none but round-off
    scales = sorted(float(b.abs().max()) for b in g64 if b is not None)
    median = scales[len(scales) // 2]
    for name, a, b in zip(names, g32, g64):
        if b is None:
            assert a is None
            continue
        scale = max(float(b.abs().max()), median)
        assert float((a - b).abs().max()) <= 1e-4 * scale, name


def test_decode_fp32_against_fp64():
    c = tiny.config()
    d = ref.Dims.of(c)
    W = weights.tacotron2(c, 6, "cpu", gate_bias=-30.0)
    ids, lens, target, _, _ = _batch(c)
    res = {}
    for dtype in (torch.float32, torch.float64):
        net = ref.Net(_as(W, dtype), d)
        with torch.no_grad():
            memory = net.encode(ids, lens)
            go = torch.zeros_like(target[:, :1])
            frames = torch.cat([go, target[:, :-1]], 1).to(dtype)
            mel, gate, align = net.decode(memory, lens, frames)
            post = net.postnet(mel)
        res[dtype] = (mel.double(), post.double(), align.double())
    for a, b in zip(res[torch.float32], res[torch.float64]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    # padded positions take no attention
    align = res[torch.float64][2]
    assert float(align[1, :, lens[1]:].abs().max()) == 0.0


def test_packed_bilstm_ignores_padding():
    c = tiny.config()
    d = ref.Dims.of(c)
    W = weights.tacotron2(c, 7, "cpu")
    net = ref.Net(W, d)
    x = torch.randn(2, 10, d.embed)
    lens = torch.tensor([10, 6])
    y = net.bilstm(x, lens)
    x2 = x.clone()
    x2[1, 6:] = 123.0
    y2 = net.bilstm(x2, lens)
    assert torch.equal(y, y2)
    assert float(y[1, 6:].abs().max()) == 0.0
    alone = net.bilstm(x[1:, :6], lens[1:])
    assert torch.allclose(alone[0], y[1, :6], atol=1e-6)
