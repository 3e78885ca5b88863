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

from distributedtensorflowexample_tpu_torch.ops.kernels import build, charge

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]

#: Bytes per load on the kernel's vector path (one ``uint4``).
VECTOR_BYTES = 16
_INT32_LIMIT = 2 ** 31


def vector_path(row_len: int, images_ptr: int, out_ptr: int) -> bool:
    """Whether the kernel takes its 16-byte path: every source row and
    every output row starts on a 16-byte boundary, i.e. the row length
    and both base addresses are multiples of 16 bytes.  Otherwise (a
    5x7x1 sample, a split sliced at an odd byte) it takes its scalar
    path, one byte per thread."""
    return (row_len % VECTOR_BYTES == 0 and images_ptr % VECTOR_BYTES == 0
            and out_ptr % VECTOR_BYTES == 0)


def bytes_per_launch(batch: int, row_len: int, channels: int) -> int:
    """The bytes one launch moves: each gathered uint8 byte read and its
    float32 written (5 a sample element), the int32 row ids, and the
    float32 ``scale`` and ``bias`` of ``channels``.  The kernel's bound
    (``chip_smoke.py``) and its rows in the bytes audit."""
    return batch * row_len * (1 + 4) + batch * 4 + 2 * 4 * channels


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
    [B] int32 row ids; ``scale``/``bias``: contiguous [C] float32 (C = 1
    or the channel count).  Returns the [B, ...] float32 batch."""
    if images.dtype != torch.uint8 or not images.is_contiguous():
        raise TypeError(f"fused_gather_dequant reads contiguous uint8 rows, "
                        f"got {images.dtype} contiguous="
                        f"{images.is_contiguous()}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise TypeError(f"idx must be a contiguous 1-D int32 tensor, got "
                        f"{idx.dtype} of shape {tuple(idx.shape)}")
    channels = scale.shape[0] if scale.dim() == 1 else 0
    if not channels or bias.dim() != 1 or bias.shape[0] != channels \
            or scale.dtype != torch.float32 or bias.dtype != torch.float32 \
            or not (scale.is_contiguous() and bias.is_contiguous()):
        raise TypeError("scale and bias must be contiguous 1-D float32 of "
                        "one shape")
    shape = images.shape
    if channels not in (1, shape[-1]):
        raise ValueError(f"{channels} dequant channels do not match the "
                         f"sample's last (channel) axis {shape[-1]}")
    if not build.on_cuda("dequant", images, idx, scale, bias):
        return gather_dequant_plain(images, idx, scale, bias)
    n_rows, batch = shape[0], idx.shape[0]
    row_len = images.numel() // n_rows if n_rows else 0
    if batch and not n_rows:
        raise ValueError("fused_gather_dequant: no rows to gather from")
    if n_rows >= _INT32_LIMIT or batch * row_len >= _INT32_LIMIT:
        raise ValueError(f"fused_gather_dequant indexes with 32-bit ints: "
                         f"{n_rows} rows, {batch} x {row_len} outputs")
    out = torch.empty((batch, *shape[1:]), dtype=torch.float32,
                      device=images.device)
    images_ptr, out_ptr = images.data_ptr(), out.data_ptr()
    fn = build.bind("dequant", "dequant_gather", _ARGTYPES)
    code = fn(images_ptr, n_rows, row_len, idx.data_ptr(), batch,
              scale.data_ptr(), bias.data_ptr(), channels,
              vector_path(row_len, images_ptr, out_ptr), out_ptr,
              build.stream_of(images))
    build.check("dequant", code)
    fused_gather_dequant.launches += 1
    charge("dequant", "gather", (images, idx, scale, bias), (out,),
           bytes_per_launch(batch, row_len, channels))
    return out


fused_gather_dequant.launches = 0
