"""Cross-cutting utilities (the JAX package's ``utils/__init__.py``):
the profiler hook (:mod:`.profiling`), device-honest timing
(:mod:`.timing`) and rank-0-only printing (:mod:`.logging`)."""

from distributedtensorflowexample_tpu_torch.utils.logging import chief_print
from distributedtensorflowexample_tpu_torch.utils.profiling import (
    ProfilerHook)
from distributedtensorflowexample_tpu_torch.utils.timing import (
    RateMeter, Timer, timed_block)

__all__ = ["ProfilerHook", "Timer", "RateMeter", "timed_block",
           "chief_print"]
