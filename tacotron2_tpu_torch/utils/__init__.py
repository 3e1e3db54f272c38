"""Shared utilities: profiling."""

from tacotron2_tpu_torch.utils.profiling import profile_trace, span

__all__ = ["profile_trace", "span"]
