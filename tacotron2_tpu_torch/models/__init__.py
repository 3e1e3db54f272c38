"""Tacotron 2 acoustic model."""

from tacotron2_tpu_torch.models import tacotron2

__all__ = ["tacotron2"]
