"""engine/ — the one replicated-execution front-end.  ``spec`` is the
declarative half (the MODES registry and the pure mode/layout resolvers:
stdlib-only, importable from torch-free tools); ``engine`` is the
executing half (``Engine`` and ``RunSpec``).  The executing half is
exported lazily, as in the JAX package's ``engine/__init__.py``, so
``engine.spec`` consumers (``tools.obs_query``) never import torch.
"""

from distributedtensorflowexample_tpu_torch.engine.spec import (
    MODES, ModeDecl, resolve_mode, resolve_update_layout)

__all__ = ["MODES", "ModeDecl", "RunSpec", "resolve_mode",
           "resolve_update_layout", "Engine", "EngineBuild",
           "apply_update_layout", "auto_steps_per_loop"]


def __getattr__(name):
    if name in ("Engine", "EngineBuild", "RunSpec", "apply_update_layout",
                "auto_steps_per_loop"):
        from distributedtensorflowexample_tpu_torch.engine import (
            engine as _eng)
        return getattr(_eng, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
