"""Fused row gather + affine dequant: ``affine(images[idx])`` in one pass.

The port of ``ops/pallas/dequant.py`` (``fused_gather_dequant``).  On a
CUDA tensor the wrapper launches ``csrc/dequant.cu``; on a CPU tensor it
runs :func:`gather_dequant_plain`, the same function in plain PyTorch.
Both round once (a true fma in the kernel, float64 then one cast in the
plain version), so they are bitwise equal to ``data/dequant.affine_numpy``
and to each other.  Both clamp an out-of-range index to the nearest row.
"""

from __future__ import annotations

import ctypes

import torch

from distributedtensorflowexample_tpu_torch.ops.kernels import build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p]


def gather_dequant_plain(images: torch.Tensor, idx: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor
                         ) -> torch.Tensor:
    """The plain version: rows ``images[clamp(idx)]`` dequantized as
    ``f32(u) * scale + bias`` with one rounding (computed in float64,
    where the product and sum are exact for bytes, then cast once).
    ``scale``/``bias`` broadcast over the last (channel) axis."""
    rows = images.index_select(0, idx.long().clamp(0, images.shape[0] - 1))
    return (rows.double() * scale.double() + bias.double()).float()


def fused_gather_dequant(images: torch.Tensor, idx: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor
                         ) -> torch.Tensor:
    """``images``: [N, ...] uint8 resident split (channel last); ``idx``:
    [B] int32 row ids; ``scale``/``bias``: [C] float32 (C = 1 or the
    channel count).  Returns the [B, ...] float32 batch."""
    if images.dtype != torch.uint8 or not images.is_contiguous():
        raise TypeError(f"fused_gather_dequant reads contiguous uint8 rows, "
                        f"got {images.dtype} contiguous="
                        f"{images.is_contiguous()}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise TypeError(f"idx must be a contiguous 1-D int32 tensor, got "
                        f"{idx.dtype} of shape {tuple(idx.shape)}")
    if scale.shape != bias.shape or scale.dim() != 1 \
            or scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("scale and bias must be 1-D float32 of one shape")
    row_len = images[0].numel() if images.shape[0] else 0
    channels = scale.shape[0]
    if channels not in (1, images.shape[-1]):
        raise ValueError(f"{channels} dequant channels do not match the "
                         f"sample's last (channel) axis {images.shape[-1]}")
    if not build.on_cuda("dequant", images, idx, scale, bias):
        return gather_dequant_plain(images, idx, scale, bias)
    scale, bias = scale.contiguous(), bias.contiguous()
    out = torch.empty((idx.shape[0],) + tuple(images.shape[1:]),
                      dtype=torch.float32, device=images.device)
    fn = build.bind("dequant", "dequant_gather", _ARGTYPES)
    code = fn(images.data_ptr(), images.shape[0], row_len, idx.data_ptr(),
              idx.shape[0], scale.data_ptr(), bias.data_ptr(), channels,
              out.data_ptr(), build.stream_of(images))
    build.check("dequant", code)
    fused_gather_dequant.launches += 1
    return out


fused_gather_dequant.launches = 0
