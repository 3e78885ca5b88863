"""MNIST input (the JAX package's ``data/mnist.py``): the IDX(.gz) numpy
parse and the ``real | synthetic | fallback`` sources.  Nothing is
downloaded.  The IDX bytes are parsed by the native C++ loader
(``native/``) when it is built, else by numpy: the same arrays.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from distributedtensorflowexample_tpu_torch import native
from distributedtensorflowexample_tpu_torch.data.dequant import U8_UNIT_SCALE
from distributedtensorflowexample_tpu_torch.data.synthetic import (
    make_synthetic, warn_synthetic)

_FILES = {
    "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}
_SYNTH_SIZES = {"train": 60000, "test": 10000}


def _read_idx(path: str) -> bytes:
    if os.path.exists(path + ".gz"):
        with gzip.open(path + ".gz", "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _read_idx_images(path: str) -> np.ndarray:
    raw = _read_idx(path)
    if native.available():
        return native.parse_idx_images(raw)
    magic, n, rows, cols = struct.unpack(">IIII", raw[:16])
    if magic != 2051:
        raise ValueError(f"bad IDX image magic {magic} in {path}")
    data = np.frombuffer(raw, dtype=np.uint8, count=n * rows * cols, offset=16)
    # Multiply by the canonical f32 1/255, NOT divide (data/dequant.py).
    return data.reshape(n, rows, cols, 1).astype(np.float32) * U8_UNIT_SCALE


def _read_idx_labels(path: str) -> np.ndarray:
    raw = _read_idx(path)
    if native.available():
        return native.parse_idx_labels(raw)
    magic, n = struct.unpack(">II", raw[:8])
    if magic != 2049:
        raise ValueError(f"bad IDX label magic {magic} in {path}")
    return np.frombuffer(raw, dtype=np.uint8, count=n, offset=8).astype(np.int32)


def load_mnist(data_dir: str, split: str = "train",
               synthetic_size: int | None = None,
               seed: int = 0,
               source: str = "real") -> tuple[np.ndarray, np.ndarray]:
    """Return (images [N,28,28,1] float32 in [0,1], labels [N] int32).

    - ``"real"`` (default): the IDX(.gz) files must exist in ``data_dir``;
      a missing file is a ``FileNotFoundError`` naming ``--dataset
      synthetic`` as the opt-in.
    - ``"synthetic"``: the deterministic synthetic split, explicitly
      requested.
    - ``"fallback"``: real if present, else synthetic with a loud
      once-per-split warning.
    """
    if source not in ("real", "synthetic", "fallback"):
        raise ValueError(f"unknown source {source!r}")
    img_name, lbl_name = _FILES[split]
    img_path = os.path.join(data_dir, img_name)
    lbl_path = os.path.join(data_dir, lbl_name)
    have = os.path.exists(img_path) or os.path.exists(img_path + ".gz")
    if source != "synthetic" and have:
        return _read_idx_images(img_path), _read_idx_labels(lbl_path)
    if source == "real":
        raise FileNotFoundError(
            f"MNIST {split!r} bytes not found in {data_dir!r} (expected "
            f"{img_name}[.gz]). Point --data_dir at the IDX files, or pass "
            f"--dataset synthetic to train on the deterministic synthetic "
            f"split instead.")
    if source == "fallback":
        warn_synthetic("MNIST", split, data_dir, img_name)
    num = synthetic_size or _SYNTH_SIZES[split]
    # Same class templates for both splits; disjoint sample draws.
    return make_synthetic(num, (28, 28, 1), 10, seed=seed,
                          sample_seed=seed * 2 + (1 if split == "train" else 2))
