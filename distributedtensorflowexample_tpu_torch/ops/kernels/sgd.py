"""Fused momentum-SGD apply over flat float32 buffers, in place.

The port of ``ops/pallas/sgd.py`` (``fused_sgd_flat`` /
``fused_sgd_apply``): ``m = mu * m + g``, ``p = p - lr * m`` over every
parameter at once.  The port's optimizer keeps the model's parameters,
the momentum and the gradients as views into three flat buffers
(``training/optimizers.py``), so one call of :func:`fused_sgd_apply` is
the whole update: one launch, no pack or unpack.

On CUDA tensors the wrapper launches ``csrc/sgd.cu``, which rounds each
line once (two fmas), as the JAX reference does on the CPU.  On CPU
tensors it runs :func:`sgd_plain`, which computes each line in float64
and casts once.  The float64 product is exact, so the two agree bitwise
except where the float64 sum's own rounding lands a value exactly on a
float32 rounding midpoint (double rounding): at most 1 ulp, on a
vanishing share of elements.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from distributedtensorflowexample_tpu_torch.ops.kernels import build, charge

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def bytes_per_launch(n: int) -> int:
    """The bytes one launch over ``n`` float32 parameters moves: ``p``,
    ``m`` and ``g`` read, ``p`` and ``m`` written (20 a parameter).  The
    kernel's bound (``chip_smoke.py``) and its rows in the bytes audit."""
    return 20 * n


def sgd_plain(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
              lr: float, mu: float) -> None:
    """The plain version, in place: each line rounded once via float64.
    ``lr`` and ``mu`` are taken at float32 precision, as the kernel
    receives them."""
    lr64, mu64 = float(np.float32(lr)), float(np.float32(mu))
    m.copy_(m.double().mul_(mu64).add_(g.double()))
    p.copy_(p.double().sub_(m.double().mul_(lr64)))


def fused_sgd_apply(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
                    lr: float, mu: float) -> None:
    """One momentum-SGD step over flat float32 buffers ``p`` (params),
    ``m`` (momentum) and ``g`` (grads), updating ``p`` and ``m`` in
    place.  ``lr`` is the host-side schedule value for this step."""
    for name, t in (("p", p), ("m", m), ("g", g)):
        if t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous 1-D float32 "
                            f"buffer, got {t.dtype} of shape "
                            f"{tuple(t.shape)}")
    if not p.shape == m.shape == g.shape:
        raise ValueError(f"buffer sizes differ: p {p.numel()}, "
                         f"m {m.numel()}, g {g.numel()}")
    if not build.on_cuda("sgd", p, m, g):
        sgd_plain(p, m, g, lr, mu)
        return
    if any(t.data_ptr() % 16 for t in (p, m, g)):
        raise ValueError("the SGD kernel's float4 accesses need 16-byte "
                         "aligned buffers")
    fn = build.bind("sgd", "sgd_momentum", _ARGTYPES)
    code = fn(p.data_ptr(), m.data_ptr(), g.data_ptr(), p.numel(),
              float(lr), float(mu), build.stream_of(p))
    build.check("sgd", code)
    fused_sgd_apply.launches += 1
    charge("sgd", "elementwise", (p, m, g), (p, m),
           bytes_per_launch(p.numel()))


fused_sgd_apply.launches = 0
