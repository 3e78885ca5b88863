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

``data_sharding="sharded"`` keeps only this rank's block of the split
resident: rank ``d`` of ``D`` holds rows ``[d*L, (d+1)*L)``, ``L = n //
D`` (rows past ``D*L`` are dropped).  Each epoch every block is shuffled
on its own and the blocks interleaved (the JAX package's order), so
global positions ``[s*B + d*bpd, s*B + (d+1)*bpd)`` of the ring always
hold rank ``d``'s rows (``bpd = B / D``): the gather translates them into
its local rows and no step moves a row between ranks.

The in-step dequant (``resolve_dequant_impl``) is the affine family
(``affine``; ``pallas``, its fused gather kernel) or the LUT family
(``onehot``: a one-hot product with the 256-entry table; ``lut``: the
table indexed), both bitwise the loader's floats; the yielded data
carries ``dq_scale``/``dq_bias`` or ``lut`` accordingly.

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
    affine_matches_lut, make_dequant_affine, make_dequant_lut, try_quantize)

#: The in-step dequant implementations a caller may request (the JAX
#: package's set): ``affine`` (one rounding of ``f32(u) * scale +
#: bias``), ``pallas`` (the affine fused with the row gather in the
#: dequant kernel), ``onehot`` (one-hot @ LUT), ``lut`` (``lut[u]``) and
#: ``auto`` (:func:`resolve_dequant_impl`).
DEQUANT_IMPLS = ("auto", "affine", "onehot", "lut", "pallas")

_AFFINE_DEVICE_OK: dict[tuple[str, str], bool] = {}


def dequant_affine_is_bitwise(spec: str,
                              device: torch.device | str = "cpu") -> bool:
    """True iff :func:`apply_dequant_affine` on ``device`` reproduces all
    256 LUT entries of ``spec`` bitwise (compared as int32 bit patterns).
    ``affine_matches_lut`` proves the arithmetic affine-representable on
    the host; this pins the device's own rounding.  Cached per (spec,
    device type)."""
    device = torch.device(device)
    key = (spec, device.type)
    hit = _AFFINE_DEVICE_OK.get(key)
    if hit is not None:
        return hit
    lut = make_dequant_lut(spec)
    s, b = make_dequant_affine(spec)
    u = torch.arange(256, dtype=torch.uint8, device=device)
    if lut.ndim == 2:
        u = u[:, None].expand(256, lut.shape[1])
    got = apply_dequant_affine(u, torch.from_numpy(s).to(device),
                               torch.from_numpy(b).to(device))
    ok = bool(np.array_equal(got.cpu().numpy().view(np.int32),
                             np.ascontiguousarray(lut).view(np.int32)))
    _AFFINE_DEVICE_OK[key] = ok
    return ok


def resolve_dequant_impl(spec: str | None, dequant_impl: str = "auto",
                         quantize: str = "auto",
                         device: torch.device | str = "cpu") -> str:
    """The ONE rule for which in-step dequant runs, shared by the train
    gather, the resident eval and the host-fed step (the JAX package's).
    ``auto`` lowers to ``affine`` when the affine form reproduces the
    split's 256-entry LUT bitwise on the host and on ``device`` (true for
    the "unit" and "cifar" specs); otherwise to the bitwise ``onehot``,
    unless ``quantize="scale"`` asks for speed over bits, which stays
    ``affine``."""
    if dequant_impl not in DEQUANT_IMPLS:
        raise ValueError(f"unknown dequant_impl {dequant_impl!r} "
                         f"(one of {DEQUANT_IMPLS})")
    if dequant_impl != "auto":
        return dequant_impl
    if spec is None:
        return "affine"         # nothing dequantizes; name the fast default
    if affine_matches_lut(spec) and dequant_affine_is_bitwise(spec, device):
        return "affine"
    return "affine" if quantize == "scale" else "onehot"


def apply_dequant_affine(u8: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> float32 ``f32(u) * scale + bias`` with ONE rounding:
    computed in float64 (exact for bytes and these constants) and cast
    once.  Eager float32 ``u.float() * s + b`` would round twice."""
    return (u8.double() * scale.double() + bias.double()).float()


def _bf16_parts(lut: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``lut`` (float32) as three bfloat16 parts whose float32 sum
    ``(hi + mid) + lo`` is ``lut`` exactly: float32's 24 significant bits
    are three bfloat16's 8, every split subtraction is exact (Sterbenz),
    and so is each partial sum."""
    hi = lut.to(torch.bfloat16)
    mid = (lut - hi.float()).to(torch.bfloat16)
    lo = (lut - hi.float() - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def apply_dequant_lut(u8: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> float32 through a [256] or [256, C] table, as a
    one-hot matrix product (the JAX package's ``apply_dequant_lut``).

    Bitwise by construction, whatever the card's matmul precision: the
    one-hot rows and the table's three bfloat16 parts (:func:`_bf16_parts`)
    are bfloat16, so each product is exact and each output of a part's
    product has ONE nonzero term, the part itself, which the bfloat16
    result holds exactly (TF32 rounds float32 operands only, and these are
    not float32).  The parts sum in float32 in the order ``(hi + mid) +
    lo``, exactly.  A float32 one-hot product would be exact only with
    TF32 off; the split needs no such setting."""
    oh = torch.nn.functional.one_hot(u8.long(), 256).to(torch.bfloat16)
    if lut.dim() == 1:
        part = lambda t: torch.matmul(oh, t).float()
    else:
        # Channel c of a pixel reads column c of the table.
        part = lambda t: torch.einsum("...ck,kc->...c", oh, t).float()
    hi, mid, lo = _bf16_parts(lut)
    return (part(hi) + part(mid)) + part(lo)


def apply_dequant_gather(u8: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> float32 by indexing the table: ``lut[u]``, or
    ``lut[u[..., c], c]`` per channel (the ``--dequant_impl lut``
    diagnostic; nothing resolves to it by itself)."""
    idx = u8.long()
    if lut.dim() == 1:
        return lut[idx]
    return lut[idx, torch.arange(lut.shape[1], device=lut.device)]


def dequantize_images(u8: torch.Tensor, spec: str,
                      dequant_impl: str = "onehot") -> torch.Tensor:
    """uint8 pixels -> the float32 values the loader would have produced,
    through a RESOLVED impl (``affine``, ``onehot`` or ``lut``; lower
    ``auto`` and ``pallas`` with :func:`resolve_dequant_impl` first)."""
    dev = u8.device
    if dequant_impl == "affine":
        s, b = make_dequant_affine(spec)
        return apply_dequant_affine(u8, torch.from_numpy(s).to(dev),
                                    torch.from_numpy(b).to(dev))
    if dequant_impl not in ("onehot", "lut"):
        raise ValueError(f"unresolved dequant_impl {dequant_impl!r} "
                         f"(expected affine, onehot, or lut)")
    lut = torch.from_numpy(make_dequant_lut(spec)).to(dev)
    if dequant_impl == "lut":
        return apply_dequant_gather(u8, lut)
    return apply_dequant_lut(u8, lut)


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
    per epoch).  ``dq_scale``/``dq_bias`` (the affine family) or ``lut``
    (the LUT family) ride along when the split is stored quantized.
    ``perm_fn(epoch) -> [epoch_len]`` indices replaces the generator's
    permutation (an injected index tape; under ``data_sharding="sharded"``
    the interleaved global order).  ``mesh`` (rank and size) places this
    rank's block under ``data_sharding="sharded"``."""

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
                 token_data: bool = False,
                 data_sharding: str = "replicated", mesh=None):
        if quantize not in ("auto", "off", "exact", "scale"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if data_sharding not in ("replicated", "sharded"):
            raise ValueError(f"unknown data_sharding {data_sharding!r}")
        if data_sharding == "sharded" and mesh is None:
            raise ValueError("data_sharding='sharded' requires a mesh")
        self.device = torch.device(device)
        self.data_sharding = data_sharding
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
            resolve_dequant_impl(self.dequant, dequant_impl, quantize,
                                 self.device)
            if self.dequant is not None else None)
        if len(images) < batch_size:
            raise ValueError(f"dataset of {len(images)} examples is smaller "
                             f"than batch {batch_size}")
        if steps_per_next < 1:
            raise ValueError(f"steps_per_next {steps_per_next} must be >= 1")
        labels = np.asarray(labels, np.int32)
        if data_sharding == "sharded":
            shards, rank = mesh.size, mesh.rank
            if batch_size % shards:
                raise ValueError(f"sharded data: batch {batch_size} must "
                                 f"divide across {shards} devices")
            self._shards = shards
            self._rows_per_shard = len(images) // shards
            self._bpd = batch_size // shards
            # Per-shard epochs: each rank steps through ITS rows in
            # bpd-row sub-batches.
            self.steps_per_epoch = self._rows_per_shard // self._bpd
            lo = rank * self._rows_per_shard
            block = slice(lo, lo + self._rows_per_shard)
            images, labels = images[block], labels[block]
            self._n = shards * self._rows_per_shard
        else:
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
        self.labels = put(labels)
        self._affine = self._lut = None
        if self.dequant_impl in ("affine", "pallas"):
            s, b = make_dequant_affine(self.dequant)
            self._affine = (put(s), put(b))
        elif self.dequant_impl is not None:
            self._lut = put(make_dequant_lut(self.dequant))
        self._ring = torch.zeros((self.num_slots, self.epoch_len),
                                 dtype=torch.int32, device=self.device)

    def _make_perm(self, epoch: int) -> torch.Tensor:
        if self._perm_fn is not None:
            order = torch.from_numpy(np.array(self._perm_fn(epoch), np.int64))
            return order[:self.epoch_len].to(self.device, torch.int32)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_epoch_seed(self._seed, epoch))
        if self.data_sharding == "replicated":
            order = torch.randperm(self._n, generator=gen,
                                   device=self.device)
            return order[:self.epoch_len].to(torch.int32)
        # Each shard's own shuffle, offset into the global row space and
        # interleaved: step s's positions [s*B + d*bpd, s*B + (d+1)*bpd)
        # are shard d's.
        d_rows, bpd = self._rows_per_shard, self._bpd
        local = torch.stack([
            torch.randperm(d_rows, generator=gen, device=self.device)
            [:self.steps_per_epoch * bpd] + d * d_rows
            for d in range(self._shards)])
        return (local.reshape(self._shards, self.steps_per_epoch, bpd)
                .transpose(0, 1).reshape(-1).to(torch.int32))

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
        if self._lut is not None:
            data["lut"] = self._lut
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
