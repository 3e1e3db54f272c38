"""tacotron2_tpu_torch: the PyTorch and CUDA port of tacotron2_tpu.

A package of its own beside the JAX package, which stays the reference the
port is tested against. It imports torch and never JAX. Its entry points
run on a CUDA device unless the caller passes ``device="cpu"``; on a CUDA
tensor each ported TPU kernel is a hand-written CUDA kernel for Hopper
(``kernels/csrc``), built with nvcc at first use, and on a CPU tensor it is
that kernel's plain PyTorch version.
"""

__version__ = "0.1.0"

from tacotron2_tpu_torch.config import Tacotron2Config, create_config

__all__ = ["Tacotron2Config", "create_config", "__version__"]
