"""The port's text frontend, config and bucketing against the JAX
package's pure-Python originals."""

import dataclasses
import warnings

import pytest
import torch

from tacotron2_tpu import text as jtext
from tacotron2_tpu.config import Tacotron2Config as JaxConfig
from tacotron2_tpu.config import create_config as jax_create_config
from tacotron2_tpu.data.bucketing import text_bucket as jax_text_bucket

from tacotron2_tpu_torch import text as ttext
from tacotron2_tpu_torch.config import (IGNORED_KNOBS, Tacotron2Config,
                                        create_config)
from tacotron2_tpu_torch.data.bucketing import text_bucket

SENTENCES = [
    "Hello world.",
    "Dr. Smith paid $12.50 for 2 books on Jan. 3rd, 1999.",
    "Mr. and Mrs. Jones live at No. 221B; it cost £4,000,000!",
    "The 1st, 22nd and 103rd entries (of 1,234) were wrong.",
    "Turn left on {T ER1 N} street, then {L EH1 F T} again.",
    "Café naïve résumé -- with   extra   spaces.",
    "{HH AH0 L OW1} {W ER1 L D}",
]


@pytest.mark.parametrize("sentence", SENTENCES)
@pytest.mark.parametrize("cleaners", [["english_cleaners"],
                                      ["basic_cleaners"]])
def test_text_to_sequence_matches_jax(sentence, cleaners):
    got = ttext.text_to_sequence(sentence, cleaners)
    assert got == jtext.text_to_sequence(sentence, cleaners)
    assert ttext.sequence_to_text(got) == jtext.sequence_to_text(got)


def test_symbols_match():
    assert ttext.SYMBOLS == jtext.SYMBOLS
    assert ttext.N_SYMBOLS == 148


def test_config_fields_and_defaults_match():
    jf = {f.name: f.default if f.default is not dataclasses.MISSING
          else f.default_factory() for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.default if f.default is not dataclasses.MISSING
          else f.default_factory() for f in dataclasses.fields(Tacotron2Config)}
    assert tf == jf
    assert set(IGNORED_KNOBS) <= set(tf)


def test_config_overrides_and_dtype():
    s = "text_buckets=32;64,compute_dtype=float32,gate_threshold=0.3"
    assert create_config(s) == Tacotron2Config(**dataclasses.asdict(
        jax_create_config(s)))
    assert create_config(s).torch_compute_dtype == torch.float32
    assert create_config().torch_compute_dtype == torch.bfloat16


@pytest.mark.parametrize("length", [1, 64, 65, 128, 192, 193, 300])
def test_text_bucket_matches_jax(length):
    buckets = (64, 128, 192)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert text_bucket(length, buckets) == jax_text_bucket(length,
                                                               buckets)
