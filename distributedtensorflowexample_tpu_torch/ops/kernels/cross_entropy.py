"""Fused softmax cross-entropy rows, forward and backward.

The port of ``ops/pallas/cross_entropy.py``
(``fused_softmax_cross_entropy_rows``): per-row losses [B] from float32
logits [B, C] and int labels [B], with label smoothing; rows whose label
is negative give zero loss and zero gradient.  The gradient is a
``torch.autograd.Function`` whose backward launches the backward kernel,
recomputing the softmax from the saved logits.

On CUDA tensors :func:`ce_fwd` / :func:`ce_bwd` launch
``csrc/cross_entropy.cu``; on CPU tensors they run the plain versions
below, which spell out the Pallas kernels' formulas in PyTorch.  The two
differ only in summation order (a shuffle tree over each row's lanes
against PyTorch's row reduction), a few float32 ulps of the row's
log-sum-exp.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from distributedtensorflowexample_tpu_torch.ops.kernels import build

_FWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_float, ctypes.c_float,
                 ctypes.c_void_p, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                 ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]


@functools.lru_cache(maxsize=64)
def _smoothing_constants(smoothing: float, classes: int):
    """(1 - s), s and s / C folded in double and rounded to float32 once,
    as the JAX kernel folds its Python-float constants.  Cached per
    ``(smoothing, classes)``: every wrapper call reads them."""
    s = float(smoothing)
    return (float(np.float32(1.0 - s)), float(np.float32(s)),
            float(np.float32(s / classes)))


def ce_fwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                 smoothing: float = 0.0) -> torch.Tensor:
    """Per-row loss [B]: ``lse - target``, 0 where the label is < 0."""
    classes = logits.shape[1]
    m = logits.max(dim=1, keepdim=True).values
    lse = m[:, 0] + torch.log(torch.exp(logits - m).sum(dim=1))
    col = torch.arange(classes, device=logits.device)
    picked = torch.where(col[None, :] == labels[:, None], logits,
                         0.0).sum(dim=1)
    if smoothing > 0.0:
        one_minus_s, s, _ = _smoothing_constants(smoothing, classes)
        target = one_minus_s * picked + s * (logits.sum(dim=1) / classes)
    else:
        target = picked
    return torch.where(labels >= 0, lse - target, 0.0)


def ce_bwd_plain(logits: torch.Tensor, labels: torch.Tensor, g: torch.Tensor,
                 smoothing: float = 0.0) -> torch.Tensor:
    """dlogits [B, C] = ``(softmax - target) * g``, 0 on label < 0 rows."""
    classes = logits.shape[1]
    ex = torch.exp(logits - logits.max(dim=1, keepdim=True).values)
    softmax = ex / ex.sum(dim=1, keepdim=True)
    col = torch.arange(classes, device=logits.device)
    onehot = (col[None, :] == labels[:, None]).to(logits.dtype)
    if smoothing > 0.0:
        one_minus_s, _, s_over_c = _smoothing_constants(smoothing, classes)
        target = one_minus_s * onehot + s_over_c
    else:
        target = onehot
    grad = (softmax - target) * g[:, None]
    return torch.where((labels >= 0)[:, None], grad, 0.0)


def _check(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.dim() != 2 or logits.dtype != torch.float32 \
            or not logits.is_contiguous():
        raise TypeError(f"logits must be contiguous float32 [B, C], got "
                        f"{logits.dtype} of shape {tuple(logits.shape)}")
    if labels.dim() != 1 or labels.shape[0] != logits.shape[0] \
            or labels.dtype != torch.int32 or not labels.is_contiguous():
        raise TypeError(f"labels must be contiguous int32 [B], got "
                        f"{labels.dtype} of shape {tuple(labels.shape)}")


def ce_fwd(logits: torch.Tensor, labels: torch.Tensor,
           smoothing: float = 0.0) -> torch.Tensor:
    """Forward kernel wrapper: per-row losses [B] float32."""
    _check(logits, labels)
    if not build.on_cuda("cross_entropy", logits, labels):
        return ce_fwd_plain(logits, labels, smoothing)
    batch, classes = logits.shape
    one_minus_s, s, _ = _smoothing_constants(smoothing, classes)
    loss = logits.new_empty(batch)
    fn = build.bind("cross_entropy", "ce_fwd", _FWD_ARGTYPES)
    code = fn(logits.data_ptr(), labels.data_ptr(), batch, classes,
              int(smoothing > 0.0), one_minus_s, s, loss.data_ptr(),
              build.stream_of(logits))
    build.check("cross_entropy", code)
    ce_fwd.launches += 1
    return loss


def ce_bwd(logits: torch.Tensor, labels: torch.Tensor, g: torch.Tensor,
           smoothing: float = 0.0) -> torch.Tensor:
    """Backward kernel wrapper: dlogits [B, C] float32 for upstream
    per-row gradients ``g`` [B]."""
    _check(logits, labels)
    if g.dim() != 1 or g.shape[0] != labels.shape[0] \
            or g.dtype != torch.float32 or not g.is_contiguous():
        raise TypeError(f"g must be contiguous float32 [B], got {g.dtype} "
                        f"of shape {tuple(g.shape)}")
    if not build.on_cuda("cross_entropy", logits, labels, g):
        return ce_bwd_plain(logits, labels, g, smoothing)
    batch, classes = logits.shape
    one_minus_s, _, s_over_c = _smoothing_constants(smoothing, classes)
    dlogits = torch.empty_like(logits)
    fn = build.bind("cross_entropy", "ce_bwd", _BWD_ARGTYPES)
    code = fn(logits.data_ptr(), labels.data_ptr(), g.data_ptr(), batch,
              classes, int(smoothing > 0.0), one_minus_s, s_over_c,
              dlogits.data_ptr(), build.stream_of(logits))
    build.check("cross_entropy", code)
    ce_bwd.launches += 1
    return dlogits


ce_fwd.launches = 0
ce_bwd.launches = 0


class _SoftmaxCrossEntropyRows(torch.autograd.Function):
    """Forward = :func:`ce_fwd`; backward = :func:`ce_bwd` (gradient to
    the logits only), the port of the Pallas ``custom_vjp``."""

    @staticmethod
    def forward(ctx, logits, labels, smoothing):
        ctx.save_for_backward(logits, labels)
        ctx.smoothing = smoothing
        return ce_fwd(logits, labels, smoothing)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        return ce_bwd(logits, labels, g.contiguous(), ctx.smoothing), \
            None, None


def fused_softmax_cross_entropy_rows(logits: torch.Tensor,
                                     labels: torch.Tensor,
                                     label_smoothing: float = 0.0
                                     ) -> torch.Tensor:
    """Per-row cross-entropy losses [B] through the fused kernel pair.
    Gradients flow to ``logits`` only."""
    return _SoftmaxCrossEntropyRows.apply(
        logits.float().contiguous(), labels.to(torch.int32).contiguous(),
        float(label_smoothing))
