"""Tacotron 2 acoustic model and the HiFi-GAN generator."""

from tacotron2_tpu_torch.models import hifigan, tacotron2

__all__ = ["tacotron2", "hifigan"]
