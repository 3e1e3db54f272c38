"""Audio/DSP front end: STFT, mel extraction, Griffin-Lim."""

from tacotron2_tpu_torch.audio.mel import (
    MelConfig, dynamic_range_compression, dynamic_range_decompression,
    mel_spectrogram, mel_spectrogram_backend,
)
from tacotron2_tpu_torch.audio.stft import (STFTConfig, griffin_lim, istft,
                                            stft)

__all__ = [
    "MelConfig", "STFTConfig", "mel_spectrogram", "mel_spectrogram_backend",
    "stft", "istft", "griffin_lim", "dynamic_range_compression",
    "dynamic_range_decompression",
]
