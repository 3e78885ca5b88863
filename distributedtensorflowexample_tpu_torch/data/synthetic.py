"""Deterministic synthetic classification data (a copy of the JAX
package's ``data/synthetic.py``, so both packages train on the same bytes
for the same seed).

Each class is a fixed random template and samples are noisy blends of
their class template, snapped to the 8-bit grid so the split stores as
uint8 on the device.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from distributedtensorflowexample_tpu_torch.data.dequant import U8_UNIT_SCALE

_warned: set[tuple[str, str]] = set()


def warn_synthetic(dataset: str, split: str, data_dir: str,
                   expected: str) -> None:
    """Once-per-(dataset, split) notice that a real-data path fell back to
    the synthetic distribution.  Suppress with
    DISTTF_TPU_QUIET_SYNTHETIC=1."""
    if os.environ.get("DISTTF_TPU_QUIET_SYNTHETIC") == "1":
        return
    if (dataset, split) in _warned:
        return
    _warned.add((dataset, split))
    print(f"WARNING: {dataset} {split!r} bytes not found in {data_dir!r} "
          f"(expected {expected}); using the DETERMINISTIC SYNTHETIC "
          f"fallback split. Accuracy targets for the real dataset do not "
          f"apply.", file=sys.stderr, flush=True)


def make_synthetic(num: int, shape: tuple[int, ...], num_classes: int,
                   seed: int, noise: float = 0.35,
                   sample_seed: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Class-template images in [0,1] float32 + int32 labels.

    ``seed`` fixes the class templates; splits that must generalize to
    each other share ``seed`` and differ in ``sample_seed``.
    """
    rng = np.random.RandomState(seed)
    templates = rng.rand(num_classes, *shape).astype(np.float32)
    srng = np.random.RandomState(seed if sample_seed is None else sample_seed)
    labels = srng.randint(0, num_classes, size=(num,)).astype(np.int32)
    eps = srng.rand(num, *shape).astype(np.float32)
    images = (1.0 - noise) * templates[labels] + noise * eps
    images = np.clip(images, 0.0, 1.0)
    images = np.rint(images * 255.0).astype(np.float32) * U8_UNIT_SCALE
    return images, labels
