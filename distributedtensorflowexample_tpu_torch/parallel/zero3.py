"""ZeRO-3 / FSDP: the parameters, their gradients and the momentum all
live as bucket rows (``--shard_params``; the JAX package's
``parallel/zero3.py``).

* **Resident layout**: each bucket of ``parallel/bucketing.BucketPlan``
  (the ``[D, W]`` layout: each leaf zero-padded to a multiple of D, cut
  into D row blocks, the leaves side by side) is held by rank d as its
  row ``[W]`` alone, for the parameters and the momentum
  (``MomentumSGD.shard_params``).  Per rank the state is (parameters +
  momentum) / D plus the rows' padding (:meth:`Zero3Layout.resident_bytes`);
  no full flat buffer is kept.
* **Gather at the first read**: for the forward, each module's
  parameter dict is swapped for one that, when the model first reads a
  leaf, gathers that leaf's bucket (:class:`_StepGathers`): the row goes
  through :class:`AllGather`, a ``torch.autograd.Function`` whose
  forward is the all-gather and whose backward is the reduce-scatter
  (its transpose, as ``jax.lax.all_gather``'s is ``psum_scatter``), and
  is cut into the bucket's leaves.  So each bucket is gathered just
  before its first consumer, wherever in the forward that is.  Autograd
  calls each bucket's backward once, with the bucket's summed
  cotangent, so each bucket's gradient is reduce-scattered exactly once,
  to this rank's row.  ``--remat block`` replays a block from the leaves
  it was given (``models/transformer_lm.py`` passes them to the
  checkpointed function as inputs), so the replay gathers nothing.
  The leaves the backward needs stay alive until it has run, as the JAX
  step's gathered buckets do (its budget holds one all-gather per
  bucket): the saving is at rest, and the step's peak holds the full
  parameters.
* **Overlap** (``--zero3_overlap``, the default): two bucket gathers are
  kept in flight (``async_op`` handles) ahead of the reads, in the order
  the previous step first read the buckets (the plan's order in the
  first step); off, each gather is issued at its bucket's first read and
  waited on at once.  Scheduling only: on and off are bitwise equal.
* **Update**: momentum SGD on this rank's gradient row against its
  parameter and momentum rows; the updated row stays where it is, with
  no all-gather (the next forward gathers it).

Per step: ``B`` all-gathers and ``B`` reduce-scatters, and no
step-closing all-gather (the ``zero3`` row of ``engine/spec.MODES``).
The eval runs on the full parameters, gathered once per eval
(:func:`materialized`, uncounted).  Batch-norm models are refused by
name (the Engine).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from distributedtensorflowexample_tpu_torch.ops.losses import accuracy
from distributedtensorflowexample_tpu_torch.parallel.bucketing import (
    BucketPlan, LeafSpec)
from distributedtensorflowexample_tpu_torch.parallel.mesh import Mesh

__all__ = ["AllGather", "LeafSpec", "Zero3Layout", "build_zero3_step_fn",
           "materialized"]


class Zero3Layout:
    """What is static about one ZeRO-3 layout: the bucket plan over the
    optimizer's ``slices`` (``{name: (offset, shape)}``) and the mesh
    size.  ``init_rows`` takes the full flat parameters to this rank's
    rows; :func:`materialized` gathers them back."""

    def __init__(self, slices: dict, bucket_bytes: int, mesh: Mesh):
        if mesh is None or mesh.size <= 1:
            raise ValueError(
                "ZeRO-3 param sharding needs a multi-device data mesh "
                "(there is nothing to shard on one device) — callers "
                "fall back to the plain step")
        self.plan = BucketPlan(slices, bucket_bytes, mesh.size)
        self.num_devices = mesh.size
        self.padding_bytes = self.plan.padding_bytes

    @property
    def num_buckets(self) -> int:
        return self.plan.num_buckets

    def init_rows(self, flat: torch.Tensor, rank: int) -> list[torch.Tensor]:
        """The full flat parameters -> this rank's row of each bucket."""
        return [self.plan.pack_row(flat, b, rank)
                for b in range(self.num_buckets)]

    def resident_bytes(self, momentum: bool = True) -> int:
        """Bytes of this rank's rows: parameters, and the momentum with
        ``momentum``: ``(1 + momentum) * (numel * 4 + padding) / D``."""
        return (1 + momentum) * self.plan.row_elements * 4


class _StepGathers:
    """One forward's bucket gathers.  :meth:`leaf` gathers a leaf's
    bucket at its first read; ``depth`` gathers are kept in flight ahead
    of the reads, in ``order`` (a list of bucket indices).  ``read`` is
    the order in which the buckets were first read."""

    def __init__(self, layout: Zero3Layout, rows: list[torch.Tensor],
                 mesh: Mesh, depth: int, order: list[int]):
        self.plan, self.rows, self.mesh = layout.plan, rows, mesh
        self.depth, self.order, self.next = depth, order, 0
        self.pending: dict = {}
        self.leaves: dict[str, torch.Tensor] = {}
        self.read: list[int] = []
        self._ahead()

    def _issue(self, b: int) -> None:
        self.pending[b] = self.mesh.all_gather_into(self.rows[b].detach(),
                                                    async_op=True)

    def _ahead(self) -> None:
        while len(self.pending) < self.depth and self.next < len(self.order):
            b = self.order[self.next]
            self.next += 1
            if b not in self.pending and b not in self.read:
                self._issue(b)

    def leaf(self, name: str) -> torch.Tensor:
        if name not in self.leaves:
            b = self.plan.bucket_of[name]
            if b not in self.pending:
                self._issue(b)
            full = AllGather.apply(self.rows[b], self.pending.pop(b),
                                   self.mesh)
            self.leaves.update(self.plan.unpack_leaves(full, b))
            self.read.append(b)
            self._ahead()
        return self.leaves[name]

    def close(self) -> None:
        """Wait for the gathers issued ahead and never read, and drop the
        references to the leaves (the graph keeps those it needs)."""
        for work in self.pending.values():
            work.wait()
        self.pending.clear()
        self.leaves.clear()


class _GatherOnRead(dict):
    """A module's ``_parameters`` during a ZeRO-3 forward: reading a leaf
    (``module.weight``, which ``nn.Module.__getattr__`` and
    ``functional_call`` read through ``__getitem__``) returns the
    gathered leaf, gathering its bucket first.  ``named_parameters()``
    still yields the placeholders."""

    def __init__(self, params: dict, prefix: str, gathers: _StepGathers):
        super().__init__(params)
        self.prefix, self.gathers = prefix, gathers

    def __getitem__(self, name: str):
        full = self.prefix + name
        if full in self.gathers.plan.bucket_of:
            return self.gathers.leaf(full)
        return super().__getitem__(name)


@contextlib.contextmanager
def _gathered_on_read(model: torch.nn.Module, gathers: _StepGathers):
    """``model``'s parameters read through ``gathers`` in the enclosed
    block; its own parameter dicts again after, every gather waited on."""
    held = {}
    for prefix, module in model.named_modules():
        if module._parameters:
            held[module] = module._parameters
            module.__dict__["_parameters"] = _GatherOnRead(
                module._parameters, f"{prefix}." if prefix else "", gathers)
    try:
        yield
    finally:
        for module, params in held.items():
            module.__dict__["_parameters"] = params
        gathers.close()


class AllGather(torch.autograd.Function):
    """A bucket's row -> its ``[D*W]`` gathered rows (forward: the
    all-gather, issued earlier as ``pending``); the cotangent -> its sum
    over the ranks, this rank's row (backward: the reduce-scatter)."""

    @staticmethod
    def forward(ctx, row: torch.Tensor, pending, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return pending.wait()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.mesh.reduce_scatter(grad), None, None


@contextlib.contextmanager
def materialized(state, mesh: Mesh):
    """The full parameters bound into ``state.model`` for the enclosed
    block (the JAX eval's ``Zero3Layout.materialize``): every bucket
    all-gathered once (uncounted) into a flat buffer in the port's
    order, whose views the model's parameters are inside; the
    placeholders again after.  Yields the flat buffer."""
    opt = state.optimizer
    plan = opt.plan
    total = sum(shape.numel() for _, shape in opt.slices.values())
    flat = opt.params_rows[0].new_empty(total)
    with torch.no_grad():
        for b, row in enumerate(opt.params_rows):
            plan.unpack(mesh.all_gather_into(row.detach(), counted=False),
                        flat, b)
    params = dict(state.model.named_parameters())
    held = {name: p.data for name, p in params.items()}
    for name, (off, shape) in opt.slices.items():
        params[name].data = flat[off:off + shape.numel()].view(shape)
    try:
        yield flat
    finally:
        for name, p in params.items():
            p.data = held[name]


def build_zero3_step_fn(loss_rows: Callable, share: Callable,
                        layout: Zero3Layout, mesh: Mesh,
                        overlap: bool = True) -> Callable:
    """The ZeRO-3 ``(state, batch) -> metrics`` step body: the forward,
    each bucket gathered at its first read, this rank's share of the
    global loss (``share(step)``, as the sync step's), backward (each
    bucket's gradient reduce-scattered to its row), the row update.  The
    state must hold rows (``MomentumSGD.shard_params``)."""
    n = mesh.size
    if layout.num_devices != n:
        raise ValueError(f"step mesh size {n} does not match the layout's "
                         f"{layout.num_devices} — the row layout is a "
                         f"function of D")
    depth = 2 if overlap else 0
    order = list(range(layout.num_buckets))     # the previous step's reads

    def step(state, batch) -> dict:
        opt = state.optimizer
        if opt.params_rows is None or len(opt.params_rows) != \
                layout.num_buckets:
            raise ValueError(
                f"ZeRO-3 step expects params as {layout.num_buckets} bucket "
                f"rows (MomentumSGD.shard_params); the state was not "
                f"converted to the resident row layout")
        opt.zero_grad()
        gathers = _StepGathers(layout, opt.params_rows, mesh, depth, order)
        with _gathered_on_read(state.model, gathers):
            logits = state.model(batch["image"], train=True,
                                 generator=state.generator)
        order[:] = gathers.read + [b for b in range(layout.num_buckets)
                                   if b not in gathers.read]
        loss = loss_rows(logits, batch["label"]).mean() * share(state.step)
        loss.backward()
        lr = opt.learning_rate()
        moms = opt.momentum_rows or [None] * layout.num_buckets
        for row, mom in zip(opt.params_rows, moms):
            opt.apply(row, mom, row.grad, lr)
        opt.count += 1
        state.step += 1
        return {"loss": loss.detach(),
                "accuracy": accuracy(logits.detach(), batch["label"]) / n}

    return step
