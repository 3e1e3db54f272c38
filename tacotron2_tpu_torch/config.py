"""Experiment configuration of the PyTorch port.

The port's own copy of ``Tacotron2Config``: the same flat field namespace,
the same defaults and the same ``"key=value,key=value"`` override string as
the JAX package, so one config string drives both. Knobs that only steer
XLA scheduling or Pallas/Mosaic lowering are accepted and ignored; they are
listed in ``IGNORED_KNOBS``.
"""

from __future__ import annotations

import dataclasses
import re
import typing
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

# Fields that only steer XLA or the Pallas/Mosaic lowering of the JAX
# package. The port accepts them (so configs and override strings carry
# over unchanged) and reads none of them. The training-kernel switches
# (``pallas_train_scan*``, ``pallas_stream_feat``, ``pallas_encoder_lstm``)
# belong here too: on a CUDA tensor the port always runs its own kernels.
IGNORED_KNOBS = (
    "decoder_scan_unroll", "decoder_interleave",
    "decoder_scan_split_transpose", "prng_impl", "pallas_interpret",
    "pallas_train_scan", "pallas_train_scan_bwd", "pallas_stream_feat",
    "pallas_encoder_lstm", "remat_decoder", "decoder_remat_policy",
    "remat_attention_energies", "debug_nans",
)


@dataclass(frozen=True)
class Tacotron2Config:
    # ---- Experiment (reference hparams.py:12-22) ----
    epochs: int = 500
    iters_per_checkpoint: int = 1000
    seed: int = 1234
    ignore_layers: List[str] = field(default_factory=lambda: ["embedding"])

    # ---- Data (reference hparams.py:27-31) ----
    load_mel_from_disk: bool = False
    training_files: str = "filelists/ljs_audio_text_train_filelist.txt"
    validation_files: str = "filelists/ljs_audio_text_val_filelist.txt"
    text_cleaners: List[str] = field(default_factory=lambda: ["english_cleaners"])
    # probability of swapping each word for its {ARPAbet} pronunciation
    p_arpabet: float = 0.0
    cmudict_path: Optional[str] = None

    # ---- Audio (reference hparams.py:35-42) ----
    max_wav_value: float = 32768.0
    sampling_rate: int = 22050
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0

    # ---- Model (reference hparams.py:47-75) ----
    n_symbols: int = 148  # len(text.SYMBOLS)
    symbols_embedding_dim: int = 512

    encoder_kernel_size: int = 5
    encoder_n_convolutions: int = 3
    encoder_embedding_dim: int = 512

    n_frames_per_step: int = 1
    decoder_rnn_dim: int = 1024
    prenet_dim: int = 256
    max_decoder_steps: int = 1000
    gate_threshold: float = 0.5
    p_attention_dropout: float = 0.1
    p_decoder_dropout: float = 0.1

    attention_rnn_dim: int = 1024
    attention_dim: int = 128

    attention_location_n_filters: int = 32
    attention_location_kernel_size: int = 31

    postnet_embedding_dim: int = 512
    postnet_kernel_size: int = 5
    postnet_n_convolutions: int = 5

    # ---- Optimization (reference hparams.py:80-85) ----
    use_saved_learning_rate: bool = False
    learning_rate: float = 1e-3
    weight_decay: float = 1e-6
    grad_clip_thresh: float = 1.0
    batch_size: int = 64
    mask_padding: bool = True

    # ---- Additions without a reference equivalent ----
    log_interval: int = 10
    # Operand type of the products; parameters and recurrent state stay
    # fp32. "float32" for full-precision runs and exact parity tests.
    compute_dtype: str = "bfloat16"  # "float32" | "bfloat16"
    mesh_shape: Tuple[int, int] = (1, 1)
    # Static text-length buckets; lengths past the last bucket extend the
    # grid (data/bucketing.text_bucket).
    text_buckets: Tuple[int, ...] = (64, 128, 192)
    mel_bucket_step: int = 128
    max_mel_length: int = 1024
    # Prenet dropout is active at inference in the reference (model.py:99).
    prenet_dropout_at_inference: bool = True
    eval_prenet_dropout: bool = True
    custom_vjp_decoder: bool = True
    grad_accum_steps: int = 1
    # Accepted and ignored by the port (see IGNORED_KNOBS).
    decoder_scan_unroll: int = 8
    remat_decoder: bool = False
    decoder_interleave: int = 1
    pallas_train_scan: bool = True
    pallas_train_scan_bwd: bool = True
    pallas_stream_feat: bool = True
    pallas_encoder_lstm: bool = True
    pallas_interpret: Optional[bool] = None
    decoder_remat_policy: Optional[str] = None
    remat_attention_energies: bool = False
    decoder_scan_split_transpose: bool = False
    debug_nans: bool = False
    prng_impl: str = "threefry"  # "threefry" | "rbg" | "unsafe_rbg"

    def replace(self, **kw) -> "Tacotron2Config":
        return dataclasses.replace(self, **kw)

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        """The operand dtype of the products (torch.float32 or bfloat16)."""
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.compute_dtype]

    def validate(self) -> "Tacotron2Config":
        """Check cross-field invariants; returns self for chaining."""
        errors = []
        if self.encoder_kernel_size % 2 == 0:
            errors.append("encoder_kernel_size must be odd (SAME padding)")
        if self.attention_location_kernel_size % 2 == 0:
            errors.append("attention_location_kernel_size must be odd")
        if self.postnet_kernel_size % 2 == 0:
            errors.append("postnet_kernel_size must be odd")
        if self.encoder_embedding_dim % 2:
            errors.append("encoder_embedding_dim must be even (BiLSTM halves)")
        if self.win_length > self.filter_length:
            errors.append("win_length must be <= filter_length")
        if self.n_frames_per_step < 1:
            errors.append("n_frames_per_step must be >= 1")
        if self.max_mel_length % self.mel_bucket_step:
            errors.append("max_mel_length must be a multiple of "
                          "mel_bucket_step")
        if self.compute_dtype not in ("float32", "bfloat16"):
            errors.append(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.prng_impl not in ("threefry", "rbg", "unsafe_rbg"):
            errors.append(f"unknown prng_impl {self.prng_impl!r}")
        if not 0.0 <= self.p_arpabet <= 1.0:
            errors.append("p_arpabet must be in [0, 1]")
        if self.p_arpabet > 0.0 and not self.cmudict_path:
            errors.append("p_arpabet > 0 requires cmudict_path")
        if errors:
            raise ValueError("invalid config: " + "; ".join(errors))
        return self


_LIST_SPLIT = re.compile(r"[;+]")


def _coerce(value: str, ftype):
    """Coerce a string override to the declared field type."""
    origin = typing.get_origin(ftype)
    if origin in (list, tuple):
        (etype,) = set(typing.get_args(ftype)) - {Ellipsis}
        items = [v for v in _LIST_SPLIT.split(value) if v]
        seq = [_coerce(v, etype) for v in items]
        return tuple(seq) if origin is tuple else seq
    if ftype is bool or ftype == Optional[bool]:
        low = value.strip().lower()
        if low in ("true", "1", "yes"):
            return True
        if low in ("false", "0", "no"):
            return False
        raise ValueError(f"cannot parse boolean from {value!r}")
    if ftype is int:
        return int(value)
    if ftype is float:
        return float(value)
    return value


def parse_overrides(config: Tacotron2Config, overrides: str) -> Tacotron2Config:
    """Apply a ``"k=v,k=v"`` override string (reference hparams.py:88-90).

    List-valued fields use ``;`` or ``+`` as the element separator so that
    ``,`` stays the pair separator, e.g. ``text_buckets=32;64;96``.
    """
    if not overrides:
        return config
    hints = typing.get_type_hints(Tacotron2Config)
    updates = {}
    for pair in overrides.split(","):
        pair = pair.strip()
        if not pair:
            continue
        if "=" not in pair:
            raise ValueError(f"malformed override {pair!r}; expected key=value")
        key, value = pair.split("=", 1)
        key = key.strip()
        if key not in hints:
            raise KeyError(f"unknown config field {key!r}")
        updates[key] = _coerce(value.strip(), hints[key])
    return config.replace(**updates)


def create_config(overrides: Optional[str] = None, **kw) -> Tacotron2Config:
    """Build a config from defaults, an override string, and keyword args."""
    config = Tacotron2Config(**kw)
    if overrides:
        config = parse_overrides(config, overrides)
    return config
