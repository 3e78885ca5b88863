"""On-device CIFAR augmentation (the JAX package's
``data/augment_device.py``): a random crop of the reflect-padded image
(4 pixels each side, offsets uniform on [0, 8]) and a horizontal flip with
probability 1/2, inside the train step.

The transform is pure routing, written here as one index gather per
batch: output pixel ``(b, r, k)`` reads input pixel ``(b, row[b, r],
col[b, k])``, where the row and column maps fold the reflect padding, the
crop offset and the flip (:func:`crop_flip_maps`).  It is bitwise for
uint8 and float32 alike.  (The JAX package routes with one-hot selector
matrix products, a TPU workaround for a serial per-image loop; the
values are the same.)

The random draws ``(ys, xs, flips)`` are split from their application,
so a caller can inject the reference's draws (``parallel/sync.py``'s
``draws_fn``).  The train step draws them for the GLOBAL batch on every
rank from a generator seeded alike (:func:`step_draws`) and each rank
takes its rows, so N ranks at B see what one rank sees at N*B.
"""

from __future__ import annotations

import torch

from distributedtensorflowexample_tpu_torch.data.device_dataset import (
    apply_dequant_affine)

PAD = 4
#: Seed salt of the augment stream (the JAX package folds 0x5EED into its
#: state key for the same purpose).
_SALT = 0x5EED


def step_seed(seed: int, step: int) -> int:
    """The augment generator's seed at ``step``: a function of the run
    seed and the step alone, so every rank and a resumed run draw alike."""
    return (int(seed) * 0x9E3779B97F4A7C15 + _SALT * 1_000_003
            + int(step)) % (2 ** 63)


def step_draws(batch: int, seed: int, step: int,
               generator: torch.Generator) -> tuple[torch.Tensor, ...]:
    """The global batch's draws at ``step``: ``(ys, xs, flips)``, int64
    crop offsets on [0, 2*PAD] and bool flips, drawn in that order on the
    generator's device after reseeding it with :func:`step_seed`."""
    generator.manual_seed(step_seed(seed, step))
    dev = generator.device
    ys = torch.randint(0, 2 * PAD + 1, (batch,), generator=generator,
                       device=dev)
    xs = torch.randint(0, 2 * PAD + 1, (batch,), generator=generator,
                       device=dev)
    flips = torch.rand(batch, generator=generator, device=dev) < 0.5
    return ys, xs, flips


def _reflect(p: torch.Tensor, n: int) -> torch.Tensor:
    """Padded index ``p`` on [0, n + 2*PAD) -> the source index under
    ``np.pad(mode="reflect")`` (the edge is not repeated)."""
    s = (p - PAD).abs()
    return torch.where(s >= n, 2 * (n - 1) - s, s)


def crop_flip_maps(ys: torch.Tensor, xs: torch.Tensor, flips: torch.Tensor,
                   height: int, width: int) -> tuple[torch.Tensor, ...]:
    """``(rows [B, H], cols [B, W])``: the source row of output row ``r``
    is ``reflect(ys + r)``; the source column of output column ``k`` is
    ``reflect(xs + (W - 1 - k if flip else k))``."""
    dev = ys.device
    r = torch.arange(height, device=dev)
    rows = _reflect(ys[:, None] + r[None, :], height)
    k = torch.arange(width, device=dev)
    k = torch.where(flips[:, None], width - 1 - k[None, :], k[None, :])
    cols = _reflect(xs[:, None] + k, width)
    return rows, cols


def crop_flip(images: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
              flips: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] uint8 or float -> the same shape and dtype, each image
    cropped and flipped per its draws (``cifar_augment_device``)."""
    b, h, w, _ = images.shape
    dev = images.device
    rows, cols = crop_flip_maps(ys.to(dev), xs.to(dev), flips.to(dev), h, w)
    bi = torch.arange(b, device=dev)[:, None, None]
    return images[bi, rows[:, :, None], cols[:, None, :]]


def crop_flip_dequant(images: torch.Tensor, ys: torch.Tensor,
                      xs: torch.Tensor, flips: torch.Tensor,
                      scale: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] uint8 -> float32: the crop and flip AND the affine
    dequant ``f32(u) * scale + bias`` (one rounding), as
    ``cifar_augment_dequant_device``; bitwise :func:`crop_flip` then the
    dequant, since routing moves the bytes unchanged."""
    if images.dtype != torch.uint8:
        raise TypeError(f"crop_flip_dequant fuses the uint8 dequant; got "
                        f"{images.dtype} (use crop_flip)")
    return apply_dequant_affine(crop_flip(images, ys, xs, flips), scale,
                                bias)
