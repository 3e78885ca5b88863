# graftlint: stdlib-only
"""The replication modes (the JAX package's ``engine/spec.py``), stdlib
only.

:data:`MODES` is the registry of the engine's replication strategies:
each row declares its checkpoint layout (``update_layout``) and the
collective budget its step is held to.  ``resolve_mode`` and
``resolve_update_layout`` are pure functions of (config, mesh size), the
same cascade the JAX package applies, callable on a ``RunConfig`` or on
a plain dict.

``contract`` is the port's own budget: the gradient and parameter
collectives one step issues, by kind, as ``parallel/mesh.Mesh.collectives``
counts them (``"B"`` stands for the number of buckets in the plan).
:func:`resolve_contract` is the budget of a (config, mesh size), which
differs from its row's in one case: ``--shard_update``'s tree form, whose
``sync_dp`` step runs the ZeRO-1 schedule over one bucket.
:func:`collective_budget` resolves ``B``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModeDecl:
    """One replication strategy: its checkpoint layout and the collectives
    per step (by kind) its step is held to."""

    name: str
    update_layout: str              # tree | bucket_rows | zero3_rows
    contract: Optional[dict]        # None for async: its worker average
                                    # is period-gated, not per step
    summary: str


#: The mode registry, from the plainest to the most sharded; the
#: resolution below picks the FIRST row whose knobs are live.
MODES = {
    "sync_dp": ModeDecl(
        "sync_dp", "tree", {"all-reduce": 1},
        "sync data-parallel: one all-reduce of the flat gradient a step "
        "(--shard_update's tree form: one reduce-scatter and one "
        "all-gather over the whole buffer, momentum resident 1/D)"),
    "async_ps": ModeDecl(
        "async_ps", "tree", None,
        "async-PS emulation: one worker per rank, local SGD, parameter "
        "average every --async_period steps"),
    "bucketed": ModeDecl(
        "bucketed", "tree", {"all-reduce": "B"},
        "--bucket_grads: the gradient all-reduce split into knee-sized "
        "dtype-homogeneous buckets"),
    "zero1": ModeDecl(
        "zero1", "bucket_rows", {"reduce-scatter": "B", "all-gather": "B"},
        "--bucket_grads + --shard_update: per bucket reduce-scatter -> "
        "sharded update -> all-gather; optimizer state resident as 1/D "
        "bucket rows"),
    "zero3": ModeDecl(
        "zero3", "zero3_rows", {"all-gather": "B", "reduce-scatter": "B"},
        "--shard_params (ZeRO-3/FSDP): params, grads and optimizer state "
        "as 1/D bucket rows; per-bucket all-gather before the forward"),
}

#: ``--shard_update`` without ``--bucket_grads`` on N > 1 ranks (the
#: ``sync_dp`` row): one reduce-scatter and one all-gather over one
#: bucket holding every parameter, and no all-reduce.
TREE_FORM_CONTRACT = {"reduce-scatter": 1, "all-gather": 1}


def _get(config, key: str, default=None):
    """A knob of a RunConfig or of a plain dict."""
    if isinstance(config, dict):
        return config.get(key, default)
    return getattr(config, key, default)


def resolve_mode(config, mesh_size: int) -> ModeDecl:
    """The MODES row this (config, mesh size) resolves to.  No validation:
    the Engine refuses bad knob combinations by name first."""
    bucket_on = bool(_get(config, "bucket_grads", ""))
    sync = _get(config, "sync_mode", "sync") == "sync"
    if not sync:
        return MODES["async_ps"]
    if mesh_size > 1 and bucket_on and _get(config, "shard_params", False):
        return MODES["zero3"]
    if mesh_size > 1 and bucket_on and _get(config, "shard_update", False):
        return MODES["zero1"]
    if mesh_size > 1 and bucket_on:
        return MODES["bucketed"]
    return MODES["sync_dp"]


def resolve_update_layout(config, mesh_size: int) -> str:
    """The checkpoint layout of a (config, mesh size): what
    ``run_metadata.json`` records and the resume refusals compare."""
    return resolve_mode(config, mesh_size).update_layout


def shards_tree_update(config, mesh_size: int) -> bool:
    """``--shard_update``'s tree form: the ``sync_dp`` row with
    ``--shard_update`` on N > 1 ranks (its momentum lives as this rank's
    rows of one bucket; its checkpoint keeps the ``tree`` layout)."""
    return (mesh_size > 1 and bool(_get(config, "shard_update", False))
            and resolve_mode(config, mesh_size).name == "sync_dp")


def resolve_contract(config, mesh_size: int) -> Optional[dict]:
    """The collectives per step this (config, mesh size) is held to, by
    kind, ``"B"`` unresolved: its row's, or :data:`TREE_FORM_CONTRACT`."""
    if shards_tree_update(config, mesh_size):
        return TREE_FORM_CONTRACT
    return resolve_mode(config, mesh_size).contract


def collective_budget(config, mesh_size: int,
                      num_buckets: Optional[int]) -> Optional[dict]:
    """:func:`resolve_contract` with ``B`` = ``num_buckets``."""
    contract = resolve_contract(config, mesh_size)
    if contract is None:
        return None
    return {kind: num_buckets if n == "B" else n
            for kind, n in contract.items()}
