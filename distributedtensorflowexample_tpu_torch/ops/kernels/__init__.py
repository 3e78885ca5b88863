"""The port's hand-written CUDA kernels, one per Pallas kernel of the JAX
package, each beside its plain PyTorch version and a launch counter.

| wrapper                           | replaces (Pallas kernel)                         |
|-----------------------------------|--------------------------------------------------|
| ``dequant.fused_gather_dequant``  | ``ops/pallas/dequant.py`` ``_dequant_row_kernel``|
| ``cross_entropy.ce_fwd``          | ``ops/pallas/cross_entropy.py`` ``_ce_fwd_kernel``|
| ``cross_entropy.ce_bwd``          | ``ops/pallas/cross_entropy.py`` ``_ce_bwd_kernel``|
| ``sgd.fused_sgd_apply``           | ``ops/pallas/sgd.py`` ``_sgd_kernel``            |

Each wrapper adds one to its ``launches`` attribute where it launches its
kernel, and nowhere else; :func:`launch_counts` reads them all and
:func:`reset_launch_counts` sets them to 0.  At that same place it hands
every open bytes audit (``utils/profiling.BytesAudit``, which cannot see
a ``ctypes`` launch) one row through :func:`charge`: its inputs at full
size plus its output, and the bytes it really moves, its module's
``bytes_per_launch``.
"""

from __future__ import annotations

#: The bytes audits open now, innermost last (``BytesAudit`` pushes and
#: pops itself).  Defined before the wrappers are imported: they import
#: :func:`charge` from here.
AUDITS: list = []


def charge(name: str, category: str, inputs: tuple, outputs: tuple,
           effective_bytes: int) -> None:
    """One launch of kernel ``name`` as a row of every open audit; nothing
    when none is open."""
    for audit in AUDITS:
        audit.kernel_row(name, category, inputs, outputs, effective_bytes)


from distributedtensorflowexample_tpu_torch.ops.kernels.cross_entropy import (
    ce_bwd, ce_fwd, fused_softmax_cross_entropy_rows)
from distributedtensorflowexample_tpu_torch.ops.kernels.dequant import (
    fused_gather_dequant)
from distributedtensorflowexample_tpu_torch.ops.kernels.sgd import (
    fused_sgd_apply)

#: kernel name -> its wrapper (the one that counts launches)
WRAPPERS = {
    "dequant": fused_gather_dequant,
    "ce_fwd": ce_fwd,
    "ce_bwd": ce_bwd,
    "sgd": fused_sgd_apply,
}


def launch_counts() -> dict[str, int]:
    return {name: w.launches for name, w in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


__all__ = ["AUDITS", "WRAPPERS", "ce_bwd", "ce_fwd", "charge",
           "fused_gather_dequant", "fused_sgd_apply",
           "fused_softmax_cross_entropy_rows", "launch_counts",
           "reset_launch_counts"]
