"""Weights between the packages: the port's ``state_dict_from_jax`` against
the JAX package's ``convert.export_state_dict``, key by key, and a strict
load into the port's ``Tacotron2``."""

import numpy as np
import pytest
import torch

import jax

from tacotron2_tpu.config import Tacotron2Config as JaxConfig
from tacotron2_tpu.convert import convert_state_dict, export_state_dict
from tacotron2_tpu.models import tacotron2 as jm

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.convert import state_dict_from_jax
from tacotron2_tpu_torch.models import tacotron2 as tm

DIMS = dict(
    n_symbols=148, symbols_embedding_dim=24, encoder_embedding_dim=24,
    encoder_n_convolutions=2, attention_rnn_dim=20, decoder_rnn_dim=28,
    prenet_dim=12, attention_dim=16, attention_location_n_filters=4,
    attention_location_kernel_size=11, postnet_embedding_dim=24,
    postnet_n_convolutions=3, n_mel_channels=10)


@pytest.fixture(scope="module", params=[1, 2], ids=["r1", "r2"])
def trees(request):
    kw = dict(DIMS, n_frames_per_step=request.param)
    jcfg, tcfg = JaxConfig(**kw), Tacotron2Config(**kw)
    params, stats = jm.init_params(jax.random.PRNGKey(0), jcfg)
    # non-trivial running statistics, so the stats mapping is exercised
    rng = np.random.RandomState(1)
    stats = jax.tree.map(
        lambda x: np.abs(rng.randn(*x.shape)).astype(np.float32) + 0.1, stats)
    return params, stats, jcfg, tcfg


def test_state_dict_equals_export_key_by_key(trees):
    params, stats, jcfg, tcfg = trees
    want = export_state_dict(params, stats, jcfg)
    got = state_dict_from_jax(params, stats, tcfg)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.tensor(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_loads_strict_into_the_port(trees):
    params, stats, _, tcfg = trees
    sd = state_dict_from_jax(params, stats, tcfg)
    model = tm.Tacotron2(tcfg)
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_port_weights_round_trip_through_jax(trees):
    """The port's own (seeded) weights go to the JAX package through its
    reference-format importer and come back unchanged."""
    _, _, jcfg, tcfg = trees
    model = tm.Tacotron2(tcfg, torch.Generator().manual_seed(3))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = convert_state_dict(sd, jcfg)
    back = state_dict_from_jax(params, stats, tcfg)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
