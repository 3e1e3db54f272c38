"""The port's teacher-forced decoder scan (tacotron2_tpu_torch/kernels/
train_scan and models/decoder_vjp) against the JAX package's.

Rows 1 and 2 of the kernel table: the plain versions, which carry the CUDA
kernels' arithmetic (the kernels are held against them on the card by
tests/test_torch_kernels_gpu.py), against the Pallas kernels in interpret
mode at bf16, with dropout off and with the keep masks the JAX package
draws (``train_scan.keep_masks``). The same residual stacks and cotangents
go into both backward chains. Then ``core_scan``, the autograd Function,
against ``jax.vjp`` of the JAX ``core_scan`` at fp32, and against the
port's plain per-step decoder under autograd.

Sizes are the JAX package's own tests' (tests/test_train_scan.py): widths
of 128, B = 8, T_in = 24 with ragged lengths, 5 steps. Every comparison is
field by field: the largest |err| as a share of the field's largest
|value|. Tolerances: at bf16, 2e-2 (the two sides round the same operands
to bf16 but sum in other orders, which now and then flips a rounding; the
readings are up to ~5e-3); at fp32, 2e-4 for the forward stacks and 5e-4
for gradients (sums over T*B in other orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron2_tpu.config import Tacotron2Config as JaxConfig
from tacotron2_tpu.kernels import train_scan as jts
from tacotron2_tpu.models import decoder_vjp as jdv
from tacotron2_tpu.models import tacotron2 as jm

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.convert import state_dict_from_jax
from tacotron2_tpu_torch.kernels import train_scan as ts
from tacotron2_tpu_torch.kernels.decoder_batch import attention_inputs
from tacotron2_tpu_torch.models import decoder_vjp as dv
from tacotron2_tpu_torch.models import tacotron2 as tm

B, T_IN, T_STEPS = 8, 24, 5
DIMS = dict(n_symbols=40, symbols_embedding_dim=128,
            encoder_embedding_dim=128, encoder_n_convolutions=1,
            attention_rnn_dim=128, decoder_rnn_dim=128, prenet_dim=128,
            attention_dim=128, attention_location_n_filters=4,
            attention_location_kernel_size=7, n_mel_channels=16,
            postnet_embedding_dim=32, postnet_n_convolutions=2)
REL_BF16, REL_FWD32, REL_GRAD32 = 2e-2, 2e-4, 5e-4


def configs(dtype, **kw):
    kw = {**DIMS, "compute_dtype": dtype, **kw}
    return JaxConfig(**kw), Tacotron2Config(**kw)


def as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float()
    return np.array(x, np.float32)


def rel_err(got, want):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / (scale if scale > 0 else 1.0))


def assert_fields(got, want, names, rel):
    errs = {n: rel_err(g, w) for n, g, w in zip(names, got, want)}
    bad = {n: e for n, e in errs.items() if e > rel}
    assert not bad, f"beyond {rel} of the field's largest value: {bad}"


def setup(dtype, seed=0):
    jcfg, tcfg = configs(dtype)
    params, stats = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    model = tm.Tacotron2(tcfg)
    model.load_state_dict(state_dict_from_jax(params, stats, tcfg))
    dp = params["decoder"]
    core = {"attention_rnn": dp["attention_rnn"],
            "attention": {k: dp["attention"][k] for k in
                          ("query", "v", "location_conv", "location_dense")},
            "decoder_rnn": dp["decoder_rnn"]}
    r = np.random.RandomState(seed)
    prenet = (r.randn(T_STEPS, B, jcfg.prenet_dim) * .3).astype(np.float32)
    memory = (r.randn(B, T_IN, jcfg.encoder_embedding_dim) * .3
              ).astype(np.float32)
    proc = (r.randn(B, T_IN, jcfg.attention_dim) * .3).astype(np.float32)
    lengths = np.full((B,), T_IN)
    lengths[B // 2:] = T_IN - 5
    mask = np.arange(T_IN)[None, :] < lengths[:, None]
    return jcfg, tcfg, core, model, prenet, memory, proc, mask


def jax_keep(jcfg, seed=3):
    """The JAX package's keep masks: (its (katt, kdec), the port's bool)."""
    dims = jts.scan_dims(jcfg, T_IN)
    katt, kdec = jts.keep_masks(jax.random.PRNGKey(seed), T_STEPS, B, dims,
                                jcfg.p_attention_dropout,
                                jcfg.p_decoder_dropout)
    port = tuple(torch.from_numpy(np.asarray(k, np.float32) > 0.5)
                 for k in (katt, kdec))
    return (katt, kdec), port


def port_inputs(model, prenet, memory, proc, mask, dtype):
    sw = dv._pack(dv.core_weights(model), dtype)
    mem, prc, emask = attention_inputs(torch.from_numpy(memory),
                                       torch.from_numpy(proc),
                                       torch.from_numpy(mask), dtype)
    return sw, torch.from_numpy(prenet).to(dtype), mem, prc, emask


@pytest.mark.parametrize("dropout", [False, True])
def test_forward_plain_matches_jax_kernel(dropout):
    """Row 1: all eight residual stacks at bf16."""
    jcfg, _, core, model, prenet, memory, proc, mask = setup("bfloat16")
    jkeep, keep = jax_keep(jcfg) if dropout else (None, None)
    want = jts.forward_residuals(
        core, jnp.asarray(prenet), jnp.asarray(memory), jnp.asarray(proc),
        jnp.asarray(mask), None, jcfg, dropout, interpret=True, keep=jkeep)
    sw, pre, mem, prc, emask = port_inputs(model, prenet, memory, proc, mask,
                                           torch.bfloat16)
    got = ts.forward_residuals(sw, pre, mem, prc, emask, keep=keep,
                               p_att=jcfg.p_attention_dropout,
                               p_dec=jcfg.p_decoder_dropout)
    for g, w in zip(got, want):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert_fields([g.float() for g in got], want, ts.Residuals._fields,
                  REL_BF16)
    # masked encoder positions get exactly zero attention
    assert torch.all(got.w[:, B // 2:, T_IN - 5:] == 0.0)
    if dropout:
        np.testing.assert_array_equal(got.dec_h.float().numpy() == 0.0,
                                      np.asarray(want[3], np.float32) == 0.0)


@pytest.mark.parametrize("dropout", [False, True])
def test_backward_plain_matches_jax_kernel(dropout):
    """Row 2 at bf16, from the same residuals and cotangents: dga, dgd,
    d_prenet, d_ctx, d_processed and each attention parameter gradient."""
    jcfg, _, core, model, prenet, memory, proc, mask = setup("bfloat16")
    jkeep, keep = jax_keep(jcfg) if dropout else (None, None)
    args = (jnp.asarray(memory), jnp.asarray(proc), jnp.asarray(mask))
    res = jts.forward_residuals(core, jnp.asarray(prenet), *args, None, jcfg,
                                dropout, interpret=True, keep=jkeep)
    r = np.random.RandomState(5)
    cots = [(r.randn(*s) * .1).astype(np.float32) for s in
            ((T_STEPS, B, 128), (T_STEPS, B, 128), (T_STEPS, B, T_IN))]
    cots[2] *= mask[None]
    want = jts.backward_chain(core, res, *args, None, *map(jnp.asarray, cots),
                              jcfg, dropout, interpret=True, keep=jkeep)
    sw, _, mem, prc, _ = port_inputs(model, prenet, memory, proc, mask,
                                     torch.bfloat16)
    tres = ts.Residuals(*(torch.from_numpy(as_np(x)).to(
        torch.bfloat16 if i < 4 else torch.float32)
        for i, x in enumerate(res)))
    got = ts.backward_chain(sw, tres, mem, prc,
                            *(torch.from_numpy(c) for c in cots), keep=keep,
                            p_att=jcfg.p_attention_dropout,
                            p_dec=jcfg.p_decoder_dropout)
    dga, dgd, dpre, dctx, dproc, d_attp = want
    assert_fields([got.dga.float(), got.dgd.float(), got.d_prenet,
                   got.d_ctx.float(), got.d_processed],
                  [dga, dgd, dpre, dctx, dproc],
                  ["dga", "dgd", "d_prenet", "d_ctx", "d_processed"],
                  REL_BF16)
    dec = model.decoder.attention_layer
    conv_w = dec.location_layer.location_conv.conv.weight
    dense_w = dec.location_layer.location_dense.linear_layer.weight
    dq, dvw, dconv, ddense = dv.attention_param_grads(
        got.d_q, tres.att_h, got.d_k2, got.d_v, conv_w, dense_w)
    assert_fields([dq.t(), dvw.t(), dconv.permute(2, 1, 0), ddense.t()],
                  [d_attp["query"]["kernel"], d_attp["v"]["kernel"],
                   d_attp["location_conv"]["kernel"],
                   d_attp["location_dense"]["kernel"]],
                  ["query", "v", "location_conv", "location_dense"],
                  REL_BF16)


def test_forward_kernel_contract_dtypes():
    """The stacks come back in the operand type (gates and h) and fp32
    (c, ctx, w), and the attention weights of each step sum to one."""
    jcfg, _, _, model, prenet, memory, proc, mask = setup("bfloat16")
    sw, pre, mem, prc, emask = port_inputs(model, prenet, memory, proc, mask,
                                           torch.bfloat16)
    res = ts.forward_residuals(sw, pre, mem, prc, emask)
    assert [x.dtype for x in res] == [torch.bfloat16] * 4 + [torch.float32] * 4
    torch.testing.assert_close(res.w.sum(-1), torch.ones(T_STEPS, B),
                               atol=1e-5, rtol=0)


def _jax_core_grads(jcfg, core, prenet, memory, proc, mask, rng, cot):
    def f(c, p, m, pr):
        h, cx, w = jdv.core_scan(c, p, m, pr, jnp.asarray(mask), rng, jcfg,
                                 True)
        return (jnp.sum(h.astype(jnp.float32) * cot[0])
                + jnp.sum(cx * cot[1]) + jnp.sum(w * cot[2]))
    return jax.grad(f, argnums=(0, 1, 2, 3))(
        core, jnp.asarray(prenet), jnp.asarray(memory), jnp.asarray(proc))


def _port_core_grads(model, tcfg, prenet, memory, proc, mask, keep, cot):
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    p, m, pr = (torch.tensor(x, requires_grad=True)
                for x in (prenet, memory, proc))
    h, cx, w = dv.core_scan(model, p, m, pr, torch.from_numpy(mask), tcfg,
                            keep=keep)
    loss = ((h.float() * torch.from_numpy(cot[0])).sum()
            + (cx * torch.from_numpy(cot[1])).sum()
            + (w * torch.from_numpy(cot[2])).sum())
    loss.backward()
    named = dict(model.named_parameters())
    grads = {k: named[k].grad for k in
             ("decoder.attention_rnn.weight_ih", "decoder.attention_rnn.bias_hh",
              "decoder.decoder_rnn.weight_hh", "decoder.decoder_rnn.bias_ih",
              "decoder.attention_layer.query_layer.linear_layer.weight",
              "decoder.attention_layer.v.linear_layer.weight",
              "decoder.attention_layer.location_layer.location_conv.conv.weight",
              "decoder.attention_layer.location_layer.location_dense."
              "linear_layer.weight")}
    return grads, p.grad, m.grad, pr.grad, (h, cx, w)


def _jax_named(jg):
    """The JAX core gradients under the port's names and layouts."""
    a, d = jg["attention_rnn"], jg["decoder_rnn"]
    at = jg["attention"]
    t = lambda x: np.asarray(x, np.float32)
    return {"decoder.attention_rnn.weight_ih": t(a["wi"]).T,
            "decoder.attention_rnn.bias_hh": t(a["bh"]),
            "decoder.decoder_rnn.weight_hh": t(d["wh"]).T,
            "decoder.decoder_rnn.bias_ih": t(d["bi"]),
            "decoder.attention_layer.query_layer.linear_layer.weight":
                t(at["query"]["kernel"]).T,
            "decoder.attention_layer.v.linear_layer.weight":
                t(at["v"]["kernel"]).T,
            "decoder.attention_layer.location_layer.location_conv.conv.weight":
                t(at["location_conv"]["kernel"]).transpose(2, 1, 0),
            "decoder.attention_layer.location_layer.location_dense."
            "linear_layer.weight": t(at["location_dense"]["kernel"]).T}


@pytest.mark.parametrize("dropout", [False, True])
def test_core_scan_function_matches_jax_vjp(dropout):
    """``CoreScan`` (plain versions on the CPU) against ``jax.vjp`` of the
    JAX ``core_scan`` at fp32: the decoder parameters' gradients and those
    of the prenet, memory and processed memory."""
    jcfg, tcfg, core, model, prenet, memory, proc, mask = setup("float32")
    rng = jax.random.PRNGKey(3) if dropout else None
    _, keep = jax_keep(jcfg) if dropout else (None, None)
    r = np.random.RandomState(9)
    cot = [(r.randn(*s) * .1).astype(np.float32) for s in
           ((T_STEPS, B, 128), (T_STEPS, B, 128), (T_STEPS, B, T_IN))]
    jg = _jax_core_grads(jcfg, core, prenet, memory, proc, mask, rng, cot)
    grads, dp, dm, dpr, _ = _port_core_grads(model, tcfg, prenet, memory,
                                             proc, mask, keep, cot)
    want = _jax_named(jg[0])
    assert_fields([grads[k] for k in want] + [dp, dm, dpr],
                  list(want.values()) + list(jg[1:]),
                  list(want) + ["prenet", "memory", "processed"], REL_GRAD32)


@pytest.mark.parametrize("dropout", [False, True])
def test_core_scan_function_matches_plain_autograd(dropout):
    """The Function and the plain per-step decoder under autograd
    (``custom_vjp_decoder=False``) agree at fp32 on outputs and gradients."""
    jcfg, tcfg, core, model, prenet, memory, proc, mask = setup("float32")
    _, keep = jax_keep(jcfg) if dropout else (None, None)
    r = np.random.RandomState(10)
    cot = [(r.randn(*s) * .1).astype(np.float32) for s in
           ((T_STEPS, B, 128), (T_STEPS, B, 128), (T_STEPS, B, T_IN))]
    outs = {}
    for custom in (True, False):
        cfg = tcfg.replace(custom_vjp_decoder=custom)
        outs[custom] = _port_core_grads(model, cfg, prenet, memory, proc,
                                        mask, keep, cot)
    (g1, *d1, o1), (g0, *d0, o0) = outs[True], outs[False]
    assert_fields(o1, o0, ["dec_h", "ctx", "w"], REL_FWD32)
    assert_fields([g1[k] for k in g1] + d1, [g0[k] for k in g1] + d0,
                  list(g1) + ["prenet", "memory", "processed"], REL_GRAD32)


def test_plain_versions_count_calls():
    """CPU tensors take the plain versions, and only them."""
    jcfg, _, _, model, prenet, memory, proc, mask = setup("float32")
    counts = (ts.forward_residuals.launches, ts.backward_chain.launches)
    calls = (ts.forward_residuals_plain.calls, ts.backward_chain_plain.calls)
    sw, pre, mem, prc, emask = port_inputs(model, prenet[:2], memory, proc,
                                           mask, torch.float32)
    res = ts.forward_residuals(sw, pre, mem, prc, emask)
    z = lambda x: torch.zeros_like(x, dtype=torch.float32)
    ts.backward_chain(sw, res, mem, prc, z(res.dec_h), z(res.ctx), z(res.w))
    assert (ts.forward_residuals.launches, ts.backward_chain.launches) == counts
    assert ts.forward_residuals_plain.calls == calls[0] + 1
    assert ts.backward_chain_plain.calls == calls[1] + 1


TILE = 32   # encoder positions per tile of the bf16 chain (AB_TT)


@pytest.mark.parametrize("T_in,ks", [(24, 7), (70, 31), (128, 31)])
def test_tiled_location_identities_match_the_conv_form(T_in, ks):
    """The forms the bf16 backward chain computes, tile by tile of 32
    positions, against ``backward_chain_plain``'s conv form at fp32 (1e-5
    of each field's largest value): the energy's location term as an im2col
    window tile @ K2, d_K2 as windows^T @ W(dm) summed over tiles, and the
    window cotangents as shifted sums of G = W(dm) @ K2^T, each tile's
    partial covering its positions and a halo of (ks - 1) / 2 on each side,
    the partials added in tile order."""
    import torch.nn.functional as F
    r = np.random.RandomState(T_in + ks)
    Bn, datt, pad = 3, 64, (ks - 1) // 2
    win = torch.from_numpy(r.rand(Bn, 2, T_in).astype(np.float32))
    k2 = torch.from_numpy(r.randn(ks, 2, datt).astype(np.float32) * .1)
    dm = torch.from_numpy(r.randn(Bn, T_in, datt).astype(np.float32))
    kw = k2.permute(2, 1, 0)                         # (datt, 2, ks)
    loc_want = F.conv1d(win, kw, padding=pad).transpose(1, 2)
    dk2_want = torch.nn.grad.conv1d_weight(
        win, kw.shape, dm.transpose(1, 2), padding=pad).permute(2, 1, 0)
    dwin_want = torch.nn.grad.conv1d_input(win.shape, kw, dm.transpose(1, 2),
                                           padding=pad)
    nt, wl = -(-T_in // TILE), TILE + ks - 1
    k2m = k2.reshape(2 * ks, datt)                   # rows 2k + c
    padded = F.pad(win, (pad, pad + nt * TILE - T_in))
    loc = torch.zeros(Bn, nt * TILE, datt)
    dk2 = torch.zeros(2 * ks, datt)
    parts = torch.zeros(Bn, nt, 2, wl)
    dmp = F.pad(dm, (0, 0, 0, nt * TILE - T_in))
    for ti in range(nt):
        t0 = ti * TILE
        # im2col: cols[b, t, 2k + c] = win[b, c, t0 + t + k - pad]
        cols = torch.stack([padded[:, :, t0 + k:t0 + k + TILE]
                            for k in range(ks)], dim=1)   # (B, ks, 2, TT)
        cols = cols.permute(0, 3, 1, 2).reshape(Bn, TILE, 2 * ks)
        loc[:, t0:t0 + TILE] = cols @ k2m
        tile_dm = dmp[:, t0:t0 + TILE]
        dk2 += torch.einsum("btk,btd->kd", cols, tile_dm)
        g = tile_dm @ k2m.t()                              # (B, TT, 2 ks)
        for jl in range(wl):
            for k in range(ks):
                tl = jl - k
                if 0 <= tl < TILE:
                    parts[:, ti, :, jl] += g[:, tl, 2 * k:2 * k + 2]
    dwin = torch.zeros(Bn, 2, T_in)
    for j in range(T_in):
        for ti in range(nt):
            jl = j - (ti * TILE - pad)
            if 0 <= jl < wl:
                dwin[:, :, j] += parts[:, ti, :, jl]
    assert_fields([loc[:, :T_in], dk2.reshape(ks, 2, datt), dwin],
                  [loc_want, dk2_want, dwin_want],
                  ["location term", "d_K2", "window cotangents"], 1e-5)


@pytest.mark.parametrize("M,H,nslice", [(13, 32, 2), (128, 64, 2),
                                        (200, 32, 1)])
def test_forward_cell_epilogue_index_map(M, H, nslice):
    """The bf16 forward's scan_cell_kernel, emulated: the product of the
    rows with the block-major weights (lstm_layout.to_blocks at 8 units,
    read as column tiles of 32) in K slices added in slice order, each
    m16n8 accumulator element (i, j, e) of a warp (wm, wn) of a block
    (64 columns, 128 rows) taken as gate j of unit 8 * tile + 2 t4 + (e & 1)
    of row 16 i + g + 8 (e >> 1). The cell on that map equals the plain
    cell on X @ W (fp32; the sums in another order)."""
    from tacotron2_tpu_torch.kernels.decoder_batch import _cell
    from tacotron2_tpu_torch.kernels.lstm_layout import to_blocks
    K = 96
    r = np.random.RandomState(M + H)
    x = torch.from_numpy(r.randn(M, K).astype(np.float32))
    w = torch.from_numpy(r.randn(K, 4 * H).astype(np.float32) * 0.2)
    bias = torch.from_numpy(r.randn(4 * H).astype(np.float32))
    c = torch.from_numpy(r.randn(M, H).astype(np.float32))
    wb = to_blocks(w, 8)                          # (H / 8, K, 32)
    wcols = wb.permute(1, 0, 2).reshape(K, -1)    # column tile * 32 + c
    nch = K // 32
    prod = torch.zeros(M, 4 * H)
    for z in range(nslice):                       # slices added in order
        k0, k1 = 32 * (z * nch // nslice), 32 * ((z + 1) * nch // nslice)
        prod = prod + x[:, k0:k1] @ wcols[k0:k1]
    gates = torch.full((M, 4 * H), float("nan"))
    for m0 in range(0, M, 128):
        for n0 in range(0, 4 * H, 64):
            for warp in range(8):
                wm, wn = warp >> 1, warp & 1
                tile = n0 // 32 + wn
                for lane in range(32):
                    g, t4 = lane >> 2, lane & 3
                    for i in range(2):
                        for j in range(4):
                            for e in range(4):
                                m = m0 + wm * 32 + i * 16 + g + (e >> 1) * 8
                                n = n0 + wn * 32 + j * 8 + 2 * t4 + (e & 1)
                                if m >= M:
                                    continue
                                unit = tile * 8 + 2 * t4 + (e & 1)
                                gates[m, j * H + unit] = prod[m, n]
    assert not torch.isnan(gates).any()
    h, cn = _cell(gates + bias, c)
    h_want, c_want = _cell(x @ w + bias, c)
    torch.testing.assert_close(h, h_want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(cn, c_want, atol=1e-5, rtol=1e-5)
