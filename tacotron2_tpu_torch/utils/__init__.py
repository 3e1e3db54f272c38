"""Shared utilities: profiling."""

from tacotron2_tpu_torch.utils.profiling import (StepTimer, profile_trace,
                                                 start_profiler_server)

__all__ = ["StepTimer", "profile_trace", "start_profiler_server"]
