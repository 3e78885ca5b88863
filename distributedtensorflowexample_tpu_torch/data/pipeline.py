"""Host-side batching and device prefetch: the host-fed input path of
``--device_data off`` (the JAX package's ``data/pipeline.py``).

:class:`Batcher` is the JAX package's, array for array: each epoch is
shuffled by ``np.random.RandomState(seed)``, every process draws the same
global batch of indices and keeps its own contiguous rows, and a split
that quantizes exactly is held as uint8 (4x fewer bytes through the host
gather and the upload; the step dequantizes, ``parallel/sync.py``
``dequant_host_batch``).  The gather, and the CIFAR crop and flip fused
with it, run in the native loader (``native/``) when it is built.

:class:`DevicePrefetcher` keeps ``depth`` batches in flight to the card:
each batch is copied into a pinned host buffer of a ring of ``depth + 1``
and uploaded with ``non_blocking`` copies on a side stream.  The step's
stream waits on the upload's event before it reads a batch, and the
uploaded tensors are marked as used on that stream (``record_stream``),
so their memory is not handed out again while the step may still read
it; a pinned buffer is refilled only after its last upload has landed.
On the CPU a batch is wrapped as tensors and nothing is in flight.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterator

import numpy as np
import torch

from distributedtensorflowexample_tpu_torch import native
from distributedtensorflowexample_tpu_torch.data.dequant import (
    affine_numpy, try_quantize)


def put_local_batch(batch: dict, device: torch.device | str) -> dict:
    """Upload a batch whose arrays are this rank's rows (what
    :class:`Batcher` yields), synchronously."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def put_global_batch(batch: dict, device: torch.device | str, rank: int = 0,
                     ranks: int = 1) -> dict:
    """Upload this rank's contiguous rows of a batch that every rank holds
    whole (the eval split): rank ``r`` of ``N`` keeps rows ``[r*B/N,
    (r+1)*B/N)``."""
    def local_rows(x):
        if x.shape[0] % ranks:
            raise ValueError(
                f"batch dim {x.shape[0]} not divisible by {ranks} ranks")
        per = x.shape[0] // ranks
        return x[rank * per:(rank + 1) * per]

    return put_local_batch({k: local_rows(v) for k, v in batch.items()},
                           device)


class Batcher:
    """Infinite shuffled minibatch stream over an in-memory array pair.

    ``process_index``/``process_count`` give each rank a disjoint part of
    every global batch."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, seed: int = 0, shuffle: bool = True,
                 process_index: int = 0, process_count: int = 1,
                 augment_fn: Callable[[np.ndarray, np.random.RandomState],
                                      np.ndarray] | None = None,
                 quantize: str = "auto"):
        """``quantize`` other than "off" keeps a split that an 8-bit
        pipeline reproduces bitwise as uint8 (``data/dequant.py``
        ``try_quantize``), and ``self.dequant`` names its spec; the step
        is then built with ``dequant=batcher.dequant``.  Only under an
        augment that is pure pixel rearrangement (``u8_safe``, as
        ``cifar10.augment``) or none."""
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{process_count} processes")
        if len(images) < batch_size:
            raise ValueError(
                f"dataset of {len(images)} examples is smaller than the "
                f"global batch {batch_size}; shapes downstream are static")
        if quantize not in ("auto", "off", "exact", "scale"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        u8_safe = augment_fn is None or getattr(augment_fn, "u8_safe", False)
        self.dequant: str | None = None
        if images.dtype == np.uint8:
            if u8_safe:
                self.dequant = "unit"   # raw bytes: floats are u/255
            else:
                # The hook expects floats: dequantize on the host.
                images = affine_numpy(images, "unit")
        elif quantize != "off" and u8_safe:
            q = try_quantize(np.asarray(images))
            if q is not None:
                images, self.dequant = q
        self._images = images
        self._labels = labels
        self._global_batch = batch_size
        self._local_batch = batch_size // process_count
        self._rng = np.random.RandomState(seed)
        self._shuffle = shuffle
        self._pidx = process_index
        self._pcount = process_count
        self._augment = augment_fn
        self._order = np.arange(len(images))
        self._pos = 0
        self._epoch = 0
        if shuffle:
            self._rng.shuffle(self._order)

    @property
    def local_batch_size(self) -> int:
        return self._local_batch

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        # Every rank draws the global batch of indices alike (one seed),
        # then keeps its contiguous rows.
        if self._pos + self._global_batch > len(self._order):
            self._epoch += 1
            self._pos = 0
            if self._shuffle:
                self._rng.shuffle(self._order)
        idx = self._order[self._pos:self._pos + self._global_batch]
        self._pos += self._global_batch
        lo = self._pidx * self._local_batch
        idx = idx[lo:lo + self._local_batch]
        return self._assemble(idx)

    def _assemble(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        """The batch rows: the native parallel gather when built (with an
        augment's ``fused_native`` gather-and-augment in one pass), numpy
        otherwise."""
        use_native = (native.available()
                      and self._images.dtype in (np.float32, np.uint8)
                      and self._labels.dtype == np.int32)
        if not use_native:
            images = self._images[idx]
            if self._augment is not None:
                images = self._augment(images, self._rng)
            return {"image": images, "label": self._labels[idx]}
        fused = getattr(self._augment, "fused_native", None)
        if fused is not None:
            images = fused(self._images, idx, self._rng)
        else:
            images = native.gather(self._images, idx)
            if self._augment is not None:
                images = self._augment(images, self._rng)
        return {"image": images, "label": native.gather(self._labels, idx)}


class DevicePrefetcher:
    """Keep ``depth`` batches of ``it`` in flight to ``device`` ahead of the
    train step (see the module docstring).  ``source`` is ``it``;
    ``bytes_per_batch`` is the host-to-device bytes of the last batch."""

    def __init__(self, it: Iterator[dict[str, np.ndarray]],
                 device: torch.device | str = "cpu", depth: int = 2):
        self.source = self._it = it
        self._device = torch.device(device)
        self._depth = max(1, depth)
        self._buf: collections.deque = collections.deque()
        self._cuda = self._device.type == "cuda"
        self._stream = (torch.cuda.Stream(self._device) if self._cuda
                        else None)
        # One more pinned slot than batches in flight: the slot being
        # refilled is never one whose batch the step has yet to read.
        self._slots: list = [None] * (self._depth + 1)
        self._next_slot = 0
        self.bytes_per_batch = 0

    def _pinned(self, slot: int, batch: dict) -> dict:
        """Slot ``slot``'s pinned buffers (the Batcher's shapes are
        static), filled with ``batch``; waits for the slot's previous
        upload to land before overwriting it."""
        held = self._slots[slot]
        if held is None:
            hosts = {k: torch.empty(v.shape, pin_memory=True, dtype=(
                         torch.from_numpy(np.empty(0, v.dtype)).dtype))
                     for k, v in batch.items()}
        else:
            hosts, done = held
            done.synchronize()
        for k, v in batch.items():
            hosts[k].numpy()[...] = v
        return hosts

    def _put(self, batch: dict):
        self.bytes_per_batch = sum(int(np.asarray(v).nbytes)
                                   for v in batch.values())
        if not self._cuda:
            return put_local_batch(batch, self._device), None
        slot = self._next_slot
        self._next_slot = (slot + 1) % len(self._slots)
        hosts = self._pinned(slot, batch)
        with torch.cuda.stream(self._stream):
            out = {k: h.to(self._device, non_blocking=True)
                   for k, h in hosts.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        self._slots[slot] = (hosts, done)
        return out, done

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        while len(self._buf) < self._depth:
            self._buf.append(self._put(next(self._it)))
        out, done = self._buf.popleft()
        if done is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(done)
            for t in out.values():
                t.record_stream(stream)
        return out
