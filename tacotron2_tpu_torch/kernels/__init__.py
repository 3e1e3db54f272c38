"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each beside
its plain PyTorch version: ``encoder_lstm``, ``decoder_batch``,
``train_scan``, ``decoder_step``, ``int8_matmul`` and ``mel_kernel``."""

from tacotron2_tpu_torch.kernels.int8_matmul import int8_matmul, quantize_int8
from tacotron2_tpu_torch.kernels.mel_kernel import mel_spectrogram_fused

__all__ = ["mel_spectrogram_fused", "int8_matmul", "quantize_int8"]
