"""Canonical uint8 <-> float32 dequantization arithmetic (host side).

A numpy copy of the JAX package's ``data/dequant.py``: THE definition of
what a stored byte means in float, shared by the loaders, the device
appliers (``data/device_dataset.py``) and the dequant kernel
(``ops/kernels/dequant.py``).

The canonical form is the affine map ``f32(u) * scale + bias`` with ONE
rounding (a fused multiply-add).  The host reference reproduces it in
float64: for byte inputs and these constants the f64 product and sum are
exact, so the one f32 cast at the end IS the fma rounding.  Eager float32
``u.float() * s + b`` rounds twice and differs bitwise from this on many
of the 768 CIFAR (byte, channel) values; every port path computes either
in f64 and casts, or with a true fma.
"""

from __future__ import annotations

import numpy as np

#: CIFAR-10 per-channel normalization constants (a copy of the JAX
#: package's ``data/cifar10.py`` values).
CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], dtype=np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], dtype=np.float32)

#: float32 1/255 — the "unit" spec's scale.  Multiplying by this constant
#: (NOT dividing by 255: an f32 division rounds differently on 126 of the
#: 256 byte values) is the canonical byte -> [0,1] conversion.
U8_UNIT_SCALE = np.float32(1.0) / np.float32(255.0)


def make_dequant_affine(spec: str) -> tuple[np.ndarray, np.ndarray]:
    """(scale, bias) float32 vectors (shape [1] or [C]) of the canonical
    affine dequant ``f32(u) * scale + bias`` for ``spec``.

    - ``"unit"``: raw pixels, floats are ``u * (1/255)`` (bias 0).
    - ``"cifar"``: mean/std-normalized CIFAR pixels, the whole
      ``(u/255 - MEAN) / STD`` pipeline folded into one affine map with
      the constants reduced in float64.
    """
    if spec == "unit":
        return (np.asarray([U8_UNIT_SCALE], np.float32),
                np.zeros(1, np.float32))
    if spec == "cifar":
        scale = (1.0 / (255.0 * np.float64(CIFAR10_STD))).astype(np.float32)
        bias = (-np.float64(CIFAR10_MEAN) / CIFAR10_STD).astype(np.float32)
        return scale, bias
    raise ValueError(f"unknown dequant spec {spec!r}")


def affine_numpy(u8: np.ndarray, spec: str) -> np.ndarray:
    """The canonical host dequant: ``f32(u) * scale + bias`` with ONE
    rounding, reproduced exactly via float64."""
    s, b = make_dequant_affine(spec)
    x = u8.astype(np.float64) * s.astype(np.float64) + b.astype(np.float64)
    return x.astype(np.float32)


def make_dequant_lut(spec: str) -> np.ndarray:
    """The 256 float32 values a uint8 pixel dequantizes to — the
    canonical affine arithmetic tabulated.  Shape [256] ("unit") or
    [256, C] (per-channel normalization)."""
    u = np.arange(256, dtype=np.uint8)[:, None]
    out = affine_numpy(u, spec)
    return out[:, 0] if out.shape[1] == 1 else out


def affine_matches_lut(spec: str) -> bool:
    """True iff the affine form reproduces ALL 256 LUT entries bitwise
    (compared as integer bit patterns, so a -0.0/+0.0 swap fails)."""
    lut = make_dequant_lut(spec)
    u = np.arange(256, dtype=np.uint8)[:, None]
    aff = affine_numpy(u, spec)
    aff = aff[:, 0] if lut.ndim == 1 else aff
    return bool(np.array_equal(lut.view(np.int32), aff.view(np.int32)))


def try_quantize(x: np.ndarray, chunk: int = 4096):
    """(uint8 split, dequant spec) if ``x`` is EXACTLY representable as
    ``affine_numpy(u8, spec)`` for one of the known pipelines (raw [0,1]
    "unit" pixels, or CIFAR mean/std-normalized); else None.  Exactness is
    verified bitwise chunk by chunk, so no caller loses precision
    silently."""
    if x.dtype != np.float32 or x.ndim < 2 or x.size == 0:
        return None
    lo, hi = float(x.min()), float(x.max())
    candidates = []
    if 0.0 <= lo and hi <= 1.0:
        candidates.append(("unit", lambda c: np.rint(c * 255.0)))
    if x.shape[-1] == 3:
        candidates.append(("cifar", lambda c: np.rint(
            (c.astype(np.float64) * CIFAR10_STD + CIFAR10_MEAN) * 255.0)))
    for spec, recover in candidates:
        out = np.empty(x.shape, np.uint8)
        ok = True
        for i in range(0, len(x), chunk):
            c = x[i:i + chunk]
            u = recover(c)
            if u.min() < 0 or u.max() > 255:
                ok = False
                break
            u = u.astype(np.uint8)
            if not np.array_equal(affine_numpy(u, spec), c):
                ok = False
                break
            out[i:i + chunk] = u
        if ok:
            return out, spec
    return None
