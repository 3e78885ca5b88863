"""Device-resident dataset (the JAX package's ``data/device_dataset.py``):
the whole split lives on the device as uint8, and each step gathers its
minibatch there by index (``parallel/sync.make_device_gather``), so the
host moves nothing per step.

The epoch permutations live in a ring of ``num_slots`` rows on the device
(epoch ``e`` in slot ``e % num_slots``), sized by :meth:`ring_slots_for`
exactly as in the JAX package, so a fused window of ``steps_per_next``
steps may cross epoch boundaries and :meth:`prefetch` can fill the next
window's epochs while the current one runs.

Permutations are drawn with a ``torch.Generator`` seeded from ``(seed,
epoch)`` on the dataset's device, so a run is reproducible from its seed.
They cannot equal the JAX package's threefry permutations; a test that
compares the two packages injects the reference's index tape through
``perm_fn`` instead.

``token_data=True`` marks an integer split (the transformer LM's token
ids): nothing is dequantized, and the ids are stored as uint8 (any
``quantize`` but ``"off"``, which stores int32).  The train step's gather
is built with the same flag (``parallel/sync.make_device_gather``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from distributedtensorflowexample_tpu_torch.data.dequant import (
    affine_matches_lut, make_dequant_affine, try_quantize)
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal

#: The in-step dequant implementations a caller may request (the JAX
#: package's set).  This slice runs auto, affine and pallas; onehot and
#: lut are refused by name (``resolve_dequant_impl``).
DEQUANT_IMPLS = ("auto", "affine", "onehot", "lut", "pallas")


def resolve_dequant_impl(spec: str | None, dequant_impl: str = "auto") -> str:
    """The ONE rule for which in-step dequant runs, shared by the train
    gather and the resident eval.  ``auto`` lowers to ``affine`` when the
    affine form reproduces the split's 256-entry LUT bitwise (true for the
    "unit" and "cifar" specs); the port's affine rounds once by
    construction (float64 then one cast, or the kernel's fma), so no
    per-backend check is needed."""
    if dequant_impl not in DEQUANT_IMPLS:
        raise ValueError(f"unknown dequant_impl {dequant_impl!r} "
                         f"(one of {DEQUANT_IMPLS})")
    if dequant_impl in ("onehot", "lut"):
        raise ModeRefusal(
            f"--dequant_impl {dequant_impl} (the LUT-family dequant) is not "
            f"ported to the PyTorch package yet; use auto, affine or pallas")
    if dequant_impl != "auto":
        return dequant_impl
    if spec is None or affine_matches_lut(spec):
        return "affine"
    raise ModeRefusal(
        f"dequant spec {spec!r} is not affine-representable, and its "
        f"bitwise fallback (--dequant_impl onehot) is not ported to the "
        f"PyTorch package yet")


def apply_dequant_affine(u8: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> float32 ``f32(u) * scale + bias`` with ONE rounding:
    computed in float64 (exact for bytes and these constants) and cast
    once.  Eager float32 ``u.float() * s + b`` would round twice."""
    return (u8.double() * scale.double() + bias.double()).float()


def token_storage(ids: np.ndarray, quantize: str) -> np.ndarray:
    """How an integer token split is stored: uint8 unless ``quantize`` is
    ``"off"`` (then int32).  Ids outside [0, 255] are refused rather than
    wrapped into other ids."""
    ids = np.asarray(ids)
    if not np.issubdtype(ids.dtype, np.integer):
        raise ValueError(f"token_data=True expects an integer token split, "
                         f"got {ids.dtype} (float splits are the image path)")
    if quantize == "off":
        return ids.astype(np.int32, copy=False)
    if ids.dtype != np.uint8:
        if ids.size and (ids.min() < 0 or ids.max() > 255):
            raise ValueError(
                "token ids exceed uint8 range; store them int32 with "
                "quantize='off' (a silent wrap would corrupt every "
                "out-of-byte id)")
        ids = ids.astype(np.uint8)
    return ids


def _epoch_seed(seed: int, epoch: int) -> int:
    return (int(seed) * 1_000_003 + int(epoch)) % (2 ** 63)


class DeviceDataset:
    """Iterator yielding ``{"images", "labels", "perm", ...}`` dicts of
    device tensors (the same tensors every step; one perm row is replaced
    per epoch).  ``dq_scale``/``dq_bias`` ride along when the split is
    stored quantized.  ``perm_fn(epoch) -> [epoch_len]`` indices replaces
    the generator's permutation (an injected index tape)."""

    @staticmethod
    def ring_slots_for(window_steps: int, steps_per_epoch: int) -> int:
        """Perm-ring size for a ``window_steps``-step fused window: every
        epoch two consecutive windows can touch, plus one margin slot (the
        JAX package's sizing rule)."""
        return -(-2 * window_steps // steps_per_epoch) + 2

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, device: torch.device | str = "cpu",
                 seed: int = 0, start_step: int = 0, steps_per_next: int = 1,
                 quantize: str = "auto", dequant_impl: str = "auto",
                 perm_fn: Callable[[int], np.ndarray] | None = None,
                 token_data: bool = False):
        if quantize not in ("auto", "off", "exact", "scale"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.device = torch.device(device)
        self.dequant: str | None = None
        images = np.asarray(images)
        if token_data:
            images = token_storage(images, quantize)
        elif images.dtype == np.uint8:
            self.dequant = "unit"
        elif quantize != "off":
            q = try_quantize(images)
            if q is not None:
                images, self.dequant = q
        self.dequant_impl: str | None = (
            resolve_dequant_impl(self.dequant, dequant_impl)
            if self.dequant is not None else None)
        if len(images) < batch_size:
            raise ValueError(f"dataset of {len(images)} examples is smaller "
                             f"than batch {batch_size}")
        if steps_per_next < 1:
            raise ValueError(f"steps_per_next {steps_per_next} must be >= 1")
        self._n = len(images)
        self.steps_per_epoch = self._n // batch_size
        self.epoch_len = self.steps_per_epoch * batch_size
        self.num_slots = self.ring_slots_for(steps_per_next,
                                             self.steps_per_epoch)
        self._spn = steps_per_next
        self._step = int(start_step)
        self._seed = int(seed)
        self._perm_fn = perm_fn
        self._slot_epochs: list[int | None] = [None] * self.num_slots

        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        self.images = put(images)
        self.labels = put(np.asarray(labels, np.int32))
        self._affine = None
        if self.dequant_impl is not None:
            s, b = make_dequant_affine(self.dequant)
            self._affine = (put(s), put(b))
        self._ring = torch.zeros((self.num_slots, self.epoch_len),
                                 dtype=torch.int32, device=self.device)

    def _make_perm(self, epoch: int) -> torch.Tensor:
        if self._perm_fn is not None:
            order = torch.from_numpy(np.array(self._perm_fn(epoch), np.int64))
            return order[:self.epoch_len].to(self.device, torch.int32)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_epoch_seed(self._seed, epoch))
        order = torch.randperm(self._n, generator=gen, device=self.device)
        return order[:self.epoch_len].to(torch.int32)

    def _ensure_epoch(self, epoch: int) -> None:
        slot = epoch % self.num_slots
        if self._slot_epochs[slot] != epoch:
            self._ring[slot].copy_(self._make_perm(epoch))
            self._slot_epochs[slot] = epoch

    def _ensure_window(self) -> None:
        first = self._step // self.steps_per_epoch
        last = (self._step + self._spn - 1) // self.steps_per_epoch
        for epoch in range(first, last + 2):
            self._ensure_epoch(epoch)

    def __iter__(self):
        return self

    def peek(self) -> dict:
        """The next window's data WITHOUT consuming it."""
        self._ensure_window()
        data = {"images": self.images, "labels": self.labels,
                "perm": self._ring}
        if self._affine is not None:
            data["dq_scale"], data["dq_bias"] = self._affine
        return data

    def __next__(self) -> dict:
        data = self.peek()
        self._step += self._spn
        return data

    def prefetch(self) -> None:
        """Fill the NEXT window's epoch permutations (plus one of margin)
        — the loop calls this right after enqueueing a step, so the
        permutation work queues behind it on the device stream."""
        self._ensure_window()
