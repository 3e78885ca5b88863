"""CIFAR-10 input (the JAX package's ``data/cifar10.py`` ``load_cifar10``):
the python-pickle, plain-binary and unextracted ``cifar-10-python.tar.gz``
layouts read with numpy, and the ``real | synthetic | fallback`` sources
of ``data/mnist.py``.  Nothing is downloaded.  The ``.bin`` layout is
parsed by the native C++ loader (``native/``) when it is built, else by
numpy: the same arrays.

Images are normalized by the fused ``"cifar"`` affine of
``data/dequant.py`` applied to the recovered bytes, so the split
quantizes back to uint8 exactly (``try_quantize``) and the device-side
dequant reproduces these floats bit for bit.

:func:`augment` is the host-fed path's random crop (4-pixel reflect pad)
and horizontal flip (``data/pipeline.Batcher``, ``--device_data off``):
its draws come from the Batcher's ``RandomState`` in a fixed order, and
the pixel work runs in the native loader (fused with the row gather) or
in numpy, bit-identically.
"""

from __future__ import annotations

import os
import pickle
import sys
import tarfile

import numpy as np

from distributedtensorflowexample_tpu_torch import native
from distributedtensorflowexample_tpu_torch.data.dequant import (
    U8_UNIT_SCALE, affine_numpy)
from distributedtensorflowexample_tpu_torch.data.synthetic import (
    make_synthetic, warn_synthetic)

_SYNTH_SIZES = {"train": 50000, "test": 10000}
_CHUNK = 4096


def _batch_names(split: str) -> list[str]:
    return ([f"data_batch_{i}" for i in range(1, 6)] if split == "train"
            else ["test_batch"])


def _to_nhwc(chw_rows: np.ndarray) -> np.ndarray:
    """[N, 3072] uint8 CHW rows -> [N, 32, 32, 3] float32 in [0, 1],
    multiplied by the float32 1/255 (not divided by 255)."""
    nhwc = chw_rows.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return nhwc.astype(np.float32) * U8_UNIT_SCALE


def _from_pickle(f) -> tuple[np.ndarray, np.ndarray]:
    d = pickle.load(f, encoding="bytes")
    return (_to_nhwc(np.asarray(d[b"data"], dtype=np.uint8)),
            np.asarray(d[b"labels"], dtype=np.int32))


def _load_from_tar(data_dir: str, split: str):
    """The pickle batches read straight out of an unextracted
    ``cifar-10-python.tar.gz`` (or ``.tar``); an unreadable or incomplete
    archive is skipped with a warning on stderr."""
    names = _batch_names(split)
    for tarname in ("cifar-10-python.tar.gz", "cifar-10-python.tar"):
        path = os.path.join(data_dir, tarname)
        if not os.path.exists(path):
            continue
        images, labels = [], []
        try:
            with tarfile.open(path) as tf:
                members = {os.path.basename(m.name): m
                           for m in tf.getmembers()}
                if any(n not in members for n in names):
                    continue
                for name in names:
                    x, y = _from_pickle(tf.extractfile(members[name]))
                    images.append(x)
                    labels.append(y)
        except Exception as e:
            print(f"warning: ignoring unreadable {path}: {e!r}",
                  file=sys.stderr, flush=True)
            continue
        return np.concatenate(images), np.concatenate(labels)
    return None


def _load_batches(data_dir: str, split: str):
    """The split from the pickle, ``.bin`` or tar layout, or None."""
    base = None
    for cand in (data_dir, os.path.join(data_dir, "cifar-10-batches-py"),
                 os.path.join(data_dir, "cifar-10-batches-bin")):
        if os.path.isdir(cand) and any(
                n.startswith(("data_batch", "test_batch"))
                for n in os.listdir(cand)):
            base = cand
            break
    if base is None:
        return _load_from_tar(data_dir, split)
    images, labels = [], []
    for name in _batch_names(split):
        path = os.path.join(base, name)
        if os.path.exists(path):                    # python pickle layout
            with open(path, "rb") as f:
                x, y = _from_pickle(f)
        elif os.path.exists(path + ".bin"):         # 1 label byte + 3072
            with open(path + ".bin", "rb") as f:
                raw = f.read()
            if native.available():
                x, y = native.parse_cifar(raw)
            else:
                rows = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3073)
                x, y = _to_nhwc(rows[:, 1:]), rows[:, 0].astype(np.int32)
        else:
            return None
        images.append(x)
        labels.append(y)
    return np.concatenate(images), np.concatenate(labels)


def load_cifar10(data_dir: str, split: str = "train",
                 synthetic_size: int | None = None, seed: int = 0,
                 normalize: bool = True,
                 source: str = "real") -> tuple[np.ndarray, np.ndarray]:
    """Return (images [N, 32, 32, 3] float32, labels [N] int32).

    ``source``: ``"real"`` (the batches must exist; missing bytes are a
    ``FileNotFoundError`` naming ``--dataset synthetic``),
    ``"synthetic"`` (the deterministic synthetic split), or
    ``"fallback"`` (real if present, else synthetic with a warning).
    ``normalize`` applies the per-channel mean/std normalization as the
    one-rounding ``"cifar"`` affine of the recovered bytes; a source
    whose pixels are not on the 8-bit grid is refused.
    """
    if source not in ("real", "synthetic", "fallback"):
        raise ValueError(f"unknown source {source!r}")
    loaded = None if source == "synthetic" else _load_batches(data_dir,
                                                              split)
    if loaded is None:
        if source == "real":
            raise FileNotFoundError(
                f"CIFAR-10 {split!r} bytes not found in {data_dir!r} "
                f"(expected data_batch_*/test_batch in pickle, .bin, or "
                f"cifar-10-python.tar.gz layout). Point --data_dir at the "
                f"batches, or pass --dataset synthetic to train on the "
                f"deterministic synthetic split instead.")
        if source == "fallback":
            warn_synthetic("CIFAR-10", split, data_dir,
                           "data_batch_*/cifar-10-*")
        num = synthetic_size or _SYNTH_SIZES[split]
        loaded = make_synthetic(
            num, (32, 32, 3), 10, seed=seed,
            sample_seed=seed * 2 + (1 if split == "train" else 2))
    images, labels = loaded
    if normalize:
        out = np.empty(images.shape, np.float32)
        for i in range(0, len(images), _CHUNK):
            c = images[i:i + _CHUNK]
            u8 = np.rint(np.clip(c, 0.0, 1.0) * 255.0).astype(np.uint8)
            if not np.array_equal(affine_numpy(u8, "unit"), c):
                raise ValueError(
                    "load_cifar10(normalize=True) expects byte-derived "
                    "[0,1] pixels (u/255 grid); got values off the grid "
                    "— normalize them upstream instead")
            out[i:i + _CHUNK] = affine_numpy(u8, "cifar")
        images = out
    return images, labels


def augment(images: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Random 4-pixel-pad crop and horizontal flip of a ``[N, H, W, C]``
    float32 or uint8 batch: the draws from ``rng`` in a fixed order
    (:func:`_draw`), then the native loader or numpy, bit-identically."""
    ys, xs, flips = _draw(rng, images.shape[0])
    if native.available() and images.dtype in (np.float32, np.uint8):
        return native.augment_crop_flip(images, ys, xs, flips)
    return _augment_numpy(images, ys, xs, flips)


def _draw(rng: np.random.RandomState, n: int):
    """The augmentation's draws, in one order for every route."""
    ys = rng.randint(0, 9, size=n)
    xs = rng.randint(0, 9, size=n)
    flips = rng.rand(n) < 0.5
    return ys, xs, flips


def _fused_gather_augment(src: np.ndarray, idx: np.ndarray,
                          rng: np.random.RandomState) -> np.ndarray:
    """The native one-pass gather plus crop and flip: the batch rows go
    from the split straight into the augmented output."""
    return native.gather_augment(src, idx, *_draw(rng, idx.size))


# The Batcher fuses the gather with this augmentation when the native
# loader is built; the draws keep augment()'s order.
augment.fused_native = _fused_gather_augment
# Pure pixel rearrangement: safe on uint8-quantized batches (the Batcher
# keeps a split uint8 only under an augment that says so).
augment.u8_safe = True


def _augment_numpy(images: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                   flips: np.ndarray) -> np.ndarray:
    """The numpy route: one strided-window gather and one masked flip."""
    n, h, w, _ = images.shape
    padded = np.pad(images, ((0, 0), (4, 4), (4, 4), (0, 0)),
                    mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(padded, (h, w),
                                                       axis=(1, 2))
    crops = windows[np.arange(n), ys, xs]          # [n, c, h, w] (copy)
    crops = np.moveaxis(crops, 1, -1)              # back to NHWC
    return np.where(flips[:, None, None, None], crops[:, :, ::-1, :], crops)
