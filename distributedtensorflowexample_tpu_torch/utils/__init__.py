"""Cross-cutting utilities (the JAX package's ``utils/__init__.py``):
the profiler hook (:mod:`.profiling`), device-honest timing
(:mod:`.timing`) and rank-0-only printing (:mod:`.logging`).  They are
exported lazily (PEP 562): the profiler and the timers import torch,
and the torch-free control plane imports :mod:`.signals` from here."""

import importlib

_HOME = {"ProfilerHook": "profiling", "Timer": "timing",
         "RateMeter": "timing", "timed_block": "timing",
         "chief_print": "logging"}

__all__ = ["ProfilerHook", "Timer", "RateMeter", "timed_block",
           "chief_print"]


def __getattr__(name):
    if name in _HOME:
        return getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
