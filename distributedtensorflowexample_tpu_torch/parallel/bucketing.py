"""Bucketed gradient collectives (``--bucket_grads``; the JAX package's
``parallel/bucketing.py``) and the bucket-row layout the ZeRO modes keep
their state in.

The plan: :func:`plan_buckets` groups the parameters, in the JAX
package's leaf order (``jax.tree.flatten``'s: dict keys sorted at every
level, :func:`jax_leaf_order`), into dtype-homogeneous buckets of at
most ``bucket_bytes`` (a larger leaf gets a bucket of its own, never
split).  The port's flat buffers hold the parameters in
``named_parameters()`` order (``training/optimizers.py``), so a
:class:`BucketPlan` maps each bucket's leaves onto their slices of those
buffers; bucket membership, the bucket count ``B`` and the padding are
the JAX plan's on the converted tree.

Two schedules run on the plan:

* **bucketed all-reduce** (``--bucket_grads`` alone): after the backward
  each bucket of the flat gradient is ONE all-reduce
  (:func:`bucketed_all_reduce`): ``B`` all-reduces a step instead of one.
  A bucket whose slices are contiguous in the flat buffer is reduced in
  place; any other is concatenated, reduced and copied back.  Bitwise
  the one-buffer all-reduce wherever the backend sums each element in
  the same order.
* **ZeRO-1** (with ``--shard_update``): per bucket, the gradient laid
  out ``[D, W]`` (each leaf zero-padded to a multiple of D and cut into D
  row blocks, the leaves' blocks side by side: :func:`_bucket_flat2d`)
  is reduce-scattered, so rank d receives row d of the summed layout;
  momentum SGD runs on that row against the matching parameter row and
  the momentum, which lives ONLY as rows (:meth:`MomentumSGD.shard_rows`);
  one all-gather of the updated row rebuilds the replicated parameters
  (:func:`sharded_update`): ``B`` reduce-scatters and ``B`` all-gathers
  a step.  The same schedule over one bucket holding every leaf is the
  tree form of ``--shard_update`` without ``--bucket_grads``.

Batch-norm models are refused by name in sync mode (the Engine), as in
the JAX package: its bucketed step computes per-shard statistics, a
different model.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal

#: ``--bucket_grads auto``: the JAX package's default cap
#: (``BUCKET_GRADS_AUTO_BYTES`` in the environment overrides it).
DEFAULT_BUCKET_BYTES = 1 << 20


def resolve_bucket_bytes(flag: str) -> int | None:
    """``--bucket_grads``: ``""`` = off (None), ``auto`` = the default cap
    (``BUCKET_GRADS_AUTO_BYTES`` overrides it, with the same checks),
    else a positive byte count; anything else is refused by name."""
    if not flag:
        return None
    if flag == "auto":
        env = os.environ.get("BUCKET_GRADS_AUTO_BYTES")
        if env is None:
            return DEFAULT_BUCKET_BYTES
        flag, source = env, "BUCKET_GRADS_AUTO_BYTES"
    else:
        source = "--bucket_grads"
    try:
        nbytes = int(flag)
    except ValueError:
        raise ModeRefusal(f"{source} must be 'auto' or a byte count, "
                          f"got {flag!r}") from None
    if nbytes <= 0:
        raise ModeRefusal(f"{source} byte count must be positive, "
                          f"got {nbytes}")
    return nbytes


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Shape and dtype of one parameter leaf: what the plan and the row
    layout need of it."""

    shape: tuple
    dtype: Any          # np.dtype

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))


def plan_buckets(leaves, bucket_bytes: int) -> list[list[int]]:
    """Leaf indices grouped into dtype-homogeneous buckets of at most
    ``bucket_bytes``, in order (a leaf over the cap gets its own bucket).
    ``leaves`` need ``.size`` and ``.dtype.itemsize``."""
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes, cur_dt = 0, None
    for i, leaf in enumerate(leaves):
        nb = leaf.size * leaf.dtype.itemsize
        if cur and (leaf.dtype != cur_dt or cur_bytes + nb > bucket_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
        cur_dt = leaf.dtype
    if cur:
        buckets.append(cur)
    return buckets


def bucket_padding_bytes(leaves, num_devices: int) -> int:
    """Bytes of zero padding the row layout adds: each leaf padded to a
    multiple of the mesh size, whatever its bucket."""
    return sum(((-leaf.size) % num_devices) * leaf.dtype.itemsize
               for leaf in leaves)


def jax_leaf_order(names) -> list[str]:
    """The port's dotted parameter names in ``jax.tree.flatten`` order.
    A port name is its flax path with the leaf renamed (``kernel``,
    ``scale`` and ``embedding`` to ``weight``, ``convert.py``); a module
    holds ``bias`` and one of the others, so sorting the dotted parts
    sorts as flax's keys do."""
    return sorted(names, key=lambda n: n.split("."))


def _rows2d(leaf: torch.Tensor, num_devices: int) -> torch.Tensor:
    """``leaf`` flattened, zero-padded to a multiple of D and cut into D
    row blocks: ``[D, ceil(n/D)]``."""
    flat = leaf.reshape(-1)
    return F.pad(flat, (0, (-flat.numel()) % num_devices)).view(
        num_devices, -1)


def _bucket_flat2d(leaves, idxs, num_devices: int) -> torch.Tensor:
    """The bucket's ``[D, W]`` layout: the leaves' row blocks side by
    side, so row d holds every leaf's d-th block."""
    return torch.cat([_rows2d(leaves[i], num_devices) for i in idxs], dim=1)


def _unbucket_rows(full_rows: torch.Tensor, leaves_template,
                   idxs) -> dict[int, torch.Tensor]:
    """Inverse of :func:`_bucket_flat2d`: the ``[D, W]`` rows cut back
    into leaf-shaped tensors (padding dropped).  Differentiable."""
    d = full_rows.shape[0]
    out = {}
    off = 0
    for i in idxs:
        leaf = leaves_template[i]
        w = -(-leaf.size // d)
        out[i] = full_rows[:, off:off + w].reshape(-1)[:leaf.size].view(
            leaf.shape)
        off += w
    return out


class BucketPlan:
    """The bucket plan of one model's parameters for a mesh of
    ``num_devices`` ranks, mapped onto the port's flat buffers.

    ``slices``: the optimizer's ``{name: (offset, shape)}`` in the flat
    buffers.  ``names`` and ``specs`` are the leaves in JAX order,
    ``plan`` the buckets (tuples of indices into them), ``widths`` each
    bucket's row width W (``sum(ceil(n_i / D))``), ``bucket_of`` each
    leaf's bucket by name."""

    def __init__(self, slices: dict, bucket_bytes: int, num_devices: int):
        self.names = jax_leaf_order(slices)
        self.offsets = [int(slices[n][0]) for n in self.names]
        self.specs = tuple(LeafSpec(tuple(slices[n][1]),
                                    np.dtype(np.float32))
                           for n in self.names)
        self.plan = tuple(tuple(b) for b in plan_buckets(self.specs,
                                                         bucket_bytes))
        self.num_devices = int(num_devices)
        d = self.num_devices
        self.widths = [sum(-(-self.specs[i].size // d) for i in idxs)
                       for idxs in self.plan]
        self.padding_bytes = bucket_padding_bytes(self.specs, d)
        self.bucket_of = {self.names[i]: b for b, idxs in enumerate(self.plan)
                          for i in idxs}
        # A bucket whose slices tile one range of the flat buffer is
        # reduced in place: (lo, hi), else None.
        self._runs = []
        for idxs in self.plan:
            spans = sorted((self.offsets[i], self.offsets[i]
                            + self.specs[i].size) for i in idxs)
            contiguous = all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            self._runs.append((spans[0][0], spans[-1][1])
                              if contiguous else None)

    @property
    def num_buckets(self) -> int:
        return len(self.plan)

    @property
    def row_elements(self) -> int:
        """Elements of one rank's rows over every bucket."""
        return sum(self.widths)

    def segments(self, flat: torch.Tensor, b: int) -> list[torch.Tensor]:
        """Bucket ``b``'s leaves as 1-D slices of ``flat``, in JAX order."""
        return [flat[self.offsets[i]:self.offsets[i] + self.specs[i].size]
                for i in self.plan[b]]

    def pack(self, flat: torch.Tensor, b: int) -> torch.Tensor:
        """Bucket ``b`` of ``flat`` in the row layout, raveled: ``[D*W]``,
        rank d's row at ``[d*W, (d+1)*W)``."""
        return _bucket_flat2d(self.segments(flat, b),
                              range(len(self.plan[b])),
                              self.num_devices).reshape(-1)

    def pack_row(self, flat: torch.Tensor, b: int, rank: int) -> torch.Tensor:
        """Row ``rank`` of :meth:`pack` alone: ``[W]``."""
        d = self.num_devices
        parts = []
        for seg in self.segments(flat, b):
            n = seg.numel()
            w = -(-n // d)
            lo, hi = min(rank * w, n), min((rank + 1) * w, n)
            parts.append(F.pad(seg[lo:hi], (0, w - (hi - lo))))
        return torch.cat(parts)

    def unpack_leaves(self, full: torch.Tensor,
                      b: int) -> dict[str, torch.Tensor]:
        """The ``[D*W]`` rows of bucket ``b`` cut into its leaves, by
        name (differentiable: the backward lays the cotangents out as
        rows)."""
        pieces = _unbucket_rows(full.view(self.num_devices, -1), self.specs,
                                self.plan[b])
        return {self.names[i]: pieces[i] for i in self.plan[b]}

    @torch.no_grad()
    def unpack(self, full: torch.Tensor, flat: torch.Tensor, b: int) -> None:
        """Write the ``[D*W]`` rows of bucket ``b`` into ``flat``."""
        torch._foreach_copy_(self.segments(flat, b),
                             [t.reshape(-1) for t in
                              self.unpack_leaves(full, b).values()])

    def all_reduce(self, flat: torch.Tensor, b: int, mesh) -> None:
        """Sum bucket ``b`` of ``flat`` over the ranks, in place: one
        all-reduce (counted)."""
        run = self._runs[b]
        if run is not None:
            mesh.all_reduce(flat[run[0]:run[1]])
            return
        segs = self.segments(flat, b)
        buf = mesh.all_reduce(torch.cat(segs))
        with torch.no_grad():
            torch._foreach_copy_(segs, list(buf.split([s.numel()
                                                        for s in segs])))


def bucketed_all_reduce(flat: torch.Tensor, plan: BucketPlan, mesh) -> None:
    """The sum over the ranks of ``flat`` (a flat gradient or parameter
    buffer), in place: one all-reduce per bucket of ``plan`` (the JAX
    package's per-bucket psum, and ``bucketed_tree_psum`` for async
    mode's average)."""
    for b in range(plan.num_buckets):
        plan.all_reduce(flat, b, mesh)


@torch.no_grad()
def sharded_update(opt, mesh) -> None:
    """One ZeRO-1 update of ``opt`` (a ``MomentumSGD`` whose momentum
    lives as this rank's rows of ``opt.plan``) from its flat gradient:
    per bucket one reduce-scatter of the gradient rows, momentum SGD on
    this rank's row, one all-gather of the updated row into the
    replicated flat parameters."""
    plan, lr = opt.plan, opt.learning_rate()
    for b in range(plan.num_buckets):
        g_row = mesh.reduce_scatter(plan.pack(opt.grads_flat, b))
        p_row = plan.pack_row(opt.params_flat, b, mesh.rank)
        m_row = None if opt.momentum_rows is None else opt.momentum_rows[b]
        opt.apply(p_row, m_row, g_row, lr)
        plan.unpack(mesh.all_gather_into(p_row), opt.params_flat, b)
    opt.count += 1
