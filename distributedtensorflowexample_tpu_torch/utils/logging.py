"""Chief-aware stdout logging (the JAX package's ``utils/logging.py``):
the chief (rank 0) owns user-facing output, since every rank runs the
same program."""

from __future__ import annotations

import torch.distributed as dist


def chief_print(*args, **kwargs) -> None:
    """``print`` on rank 0 only (before a process group exists, every
    process is rank 0 and prints)."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        kwargs.setdefault("flush", True)
        print(*args, **kwargs)
