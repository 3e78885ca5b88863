"""Snapshot → serving promotion: the training stack's recovery format is
the serving stack's model source (the JAX package's
``serving/promote.py``).

A serving worker must never trust a snapshot MORE than a supervisor does,
so promotion goes through the SnapshotStore's validity machinery
(manifest-last commit, size and crc32 re-checked, newest-valid fallback
past a torn final write — ``resilience/snapshot.py``): a corrupted newest
snapshot costs one snapshot interval of model freshness, never the
serving worker.

The snapshot restores into a template state built the way the trainers
build theirs, with the repo-wide training default optimizer (momentum SGD,
momentum 0.9): restoring checks every name and shape against the
template, so a snapshot of another model, or of a run with another
optimizer, is refused by name rather than mis-bound.  Serving keeps the
model's parameters and drops the optimizer's momentum and gradient
buffers.

Layouts: snapshots are written in the layout the run trained in
(``meta.update_layout``): ``tree``, ZeRO-1 ``bucket_rows`` (momentum as
per-bucket rows) or ZeRO-3 ``zero3_rows`` (parameters and momentum as
rows).  A row-layout snapshot holds the single-controller view of the
rows, every bucket's full ``[D*W]`` flat (what the JAX package's global
arrays hold; :func:`full_row_state` makes that view of a state), so its
template rebuilds the row geometry from the manifest's ``mesh_size`` and
``bucket_bytes`` and :func:`promote` materializes the parameters from the
rows (``BucketPlan.unpack``, the bucket plan's own inverse).

:func:`promote_sharded` is the params-stay-sharded twin, run on every
rank of a group (``serving/sharded.py``'s engine): a ``zero3_rows``
snapshot hands each rank its own rows as they are, a ``tree`` or
``bucket_rows`` one converts down through ``Zero3Layout.init_rows``; the
full parameters live only in host memory while the snapshot is read, and
the model on the device holds empty placeholders.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
from torch import nn

from distributedtensorflowexample_tpu_torch.models import build_model
from distributedtensorflowexample_tpu_torch.parallel.bucketing import (
    DEFAULT_BUCKET_BYTES, BucketPlan)
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
from distributedtensorflowexample_tpu_torch.parallel.zero3 import Zero3Layout
from distributedtensorflowexample_tpu_torch.resilience.snapshot import (
    SnapshotStore)
from distributedtensorflowexample_tpu_torch.training.optimizers import (
    MomentumSGD)
from distributedtensorflowexample_tpu_torch.training.state import TrainState

_LAYOUTS = ("tree", "bucket_rows", "zero3_rows")


def _log(msg: str) -> None:
    print(f"serve.promote: {msg}", file=sys.stderr, flush=True)


def serve_snapshot_default() -> str:
    """``SERVE_SNAPSHOT``: the snapshot directory serving/serve_lm.py
    loads when ``--snapshot`` is not passed — empty means the flag is
    required."""
    return os.environ.get("SERVE_SNAPSHOT", "")


def _default_optimizer(model: nn.Module) -> MomentumSGD:
    # The repo-wide training default (trainer_lm: lr 0.1, momentum 0.9):
    # promotion templates must mirror what the snapshot writers ran.
    return MomentumSGD(model, lambda count: np.float32(0.1), 0.9,
                       fused=False)


def template_state(size: str, device: torch.device,
                   seed: int = 0) -> TrainState:
    """A fresh ``size`` LM state on ``device``, the way a trainer creates
    one (flax's init from ``seed``, the default optimizer)."""
    return TrainState.create(build_model(size), _default_optimizer, seed,
                             device)


@torch.no_grad()
def full_row_state(state: TrainState, update_layout: str, mesh_size: int,
                   bucket_bytes: int) -> TrainState:
    """``state`` (one process, ``tree`` layout) in the single-controller
    view of a row layout at ``mesh_size`` ranks, in place: the momentum
    (and under ``zero3_rows`` the parameters) as every bucket's full
    ``[D*W]`` rows, rank d's row at ``[d*W, (d+1)*W)`` — what a row-layout
    snapshot holds.  The flat parameters stay, for :func:`promote` to
    materialize into."""
    opt = state.optimizer
    plan = BucketPlan(opt.slices, bucket_bytes, mesh_size)
    opt.plan, opt.layout = plan, update_layout
    if opt.momentum_flat is not None:
        opt.momentum_rows = [plan.pack(opt.momentum_flat, b)
                             for b in range(plan.num_buckets)]
        opt.momentum_flat = None
    if update_layout == "zero3_rows":
        opt.params_rows = [plan.pack(opt.params_flat, b)
                           for b in range(plan.num_buckets)]
    return state


def _template(size: str, layout: str, meta: dict) -> TrainState:
    """The restore template of a snapshot's declared layout, on the host:
    row layouts rebuild the bucket geometry from the manifest's
    ``mesh_size`` and ``bucket_bytes``."""
    state = template_state(size, torch.device("cpu"))
    if layout == "tree":
        return state
    mesh_size, bucket_bytes = meta.get("mesh_size"), meta.get("bucket_bytes")
    if not mesh_size or not bucket_bytes:
        raise ValueError(
            f"snapshot layout {layout!r} needs manifest meta "
            f"mesh_size+bucket_bytes to rebuild the row geometry; this "
            f"manifest carries {sorted(meta)} — it was not written by a "
            f"layout-stamping writer")
    return full_row_state(state, layout, int(mesh_size), int(bucket_bytes))


def _restored(snapshot_dir: str, size: str, step: int | None):
    """(step, manifest, layout, restored host state) of the newest valid
    (or the given) snapshot, after the by-name checks."""
    store = SnapshotStore(snapshot_dir)
    if step is None:
        step = store.latest_valid()
    if step is None:
        raise ValueError(
            f"no valid snapshot in {snapshot_dir!r} — nothing to "
            f"promote (run training, or serve_lm's init_if_missing "
            f"mode for a demo-grade init)")
    man = store.manifest(step) or {}
    meta = man.get("meta") or {}
    snap_model = meta.get("model")
    if snap_model and snap_model != size:
        raise ModeRefusal(
            f"snapshot {step} in {snapshot_dir} was written by model "
            f"{snap_model!r}; this worker was asked to serve --size "
            f"{size!r} — refusing to bind across architectures")
    layout = meta.get("update_layout", "tree")
    if layout not in _LAYOUTS:
        raise ValueError(f"snapshot {step} declares unknown "
                         f"update_layout {layout!r} (one of {_LAYOUTS})")
    state = _template(size, layout, meta)
    store.restore(state, step=step, generators=False)
    return step, man, layout, state


def _serving_model(state: TrainState) -> nn.Module:
    model = state.model
    for p in model.parameters():
        p.grad = None            # the optimizer's buffers go with it
    return model.requires_grad_(False)


@dataclasses.dataclass
class PromotedModel:
    """What promotion hands the engine: the training ``TransformerLM``
    holding the snapshot's parameters, plus the provenance the serving
    stats carry."""
    model: nn.Module            # the training TransformerLM
    step: int                   # snapshot step served
    layout: str                 # update_layout the snapshot was written in
    manifest: dict              # the winning snapshot's manifest


def promote(snapshot_dir: str, size: str, *, step: int | None = None,
            device: torch.device = torch.device("cpu")) -> PromotedModel:
    """Load the newest VALID snapshot of an LM ``size`` from
    ``snapshot_dir`` onto ``device``.

    - newest-first with fallback: a torn or corrupt newest snapshot is
      discarded (counted on ``snapshot_fallbacks_total``) and the
      previous valid one serves;
    - a manifest stamped with another model than ``size`` is refused by
      name;
    - row layouts materialize: the parameters are cut back out of the
      bucket rows (``BucketPlan.unpack``).
    """
    step, man, layout, state = _restored(snapshot_dir, size, step)
    opt = state.optimizer
    if layout == "zero3_rows":
        for b, row in enumerate(opt.params_rows):
            opt.plan.unpack(row, opt.params_flat, b)
    model = _serving_model(state).to(device)
    _log(f"promoted snapshot step {step} ({layout}) from {snapshot_dir}")
    return PromotedModel(model=model, step=int(step), layout=layout,
                         manifest=man)


@dataclasses.dataclass
class ShardedPromotion:
    """What sharded promotion hands the row-resident engine on one rank:
    this rank's bucket rows (1/D of the parameters) and the layout that
    explains them — the full parameters are never a member, and the
    model's parameters on the device are empty placeholders."""
    model: nn.Module            # the training TransformerLM (placeholders)
    rows: list                  # this rank's [W_b] row of each bucket
    layout: Zero3Layout         # the plan over the group's D ranks
    step: int                   # snapshot step served
    source_layout: str          # update_layout the snapshot was written in
    manifest: dict              # the winning snapshot's manifest


def promote_sharded(snapshot_dir: str, size: str, *, mesh,
                    step: int | None = None, mesh_size: int | None = None,
                    bucket_bytes: int | None = None) -> ShardedPromotion:
    """Promotion that keeps the parameters SHARDED, on every rank of
    ``mesh`` (a ``parallel/mesh.Mesh`` of the serving group): the twin of
    :func:`promote` for ``serving/sharded.ShardedDecodeEngine``.

    A ``zero3_rows`` snapshot hands each rank its own row of every bucket
    as it is (its ``mesh_size`` must be this group's: the row layout is a
    function of D, and another ``mesh_size`` is refused by name).  A
    ``tree`` or ``bucket_rows`` snapshot converts down through
    ``Zero3Layout.init_rows`` at ``bucket_bytes`` (default: the
    manifest's, else ``--bucket_grads auto``'s cap).  ``mesh_size``
    (``--sharded_mesh``) wider than the group's ranks is refused by name.
    A one-rank ``mesh`` (``--sharded_mesh 1``, no group) holds every
    bucket whole.  The snapshot is read on the host; only the rows reach
    the device."""
    D = int(mesh_size or mesh.size)
    if D > mesh.size:
        raise ModeRefusal(
            f"--sharded_mesh {D} exceeds the {mesh.size} rank(s) of this "
            f"group — the row layout shards one row per rank; start "
            f"{D} ranks or ask for --sharded_mesh {mesh.size}")
    step, man, layout_name, state = _restored(snapshot_dir, size, step)
    meta = man.get("meta") or {}
    opt = state.optimizer
    if layout_name == "zero3_rows":
        snap_mesh = int(meta.get("mesh_size") or 0)
        if D != snap_mesh:
            raise ModeRefusal(
                f"snapshot {step} holds zero3_rows written at mesh_size "
                f"{snap_mesh} but --sharded_mesh {D} was requested — the "
                f"row layout is a function of D; re-shard through a "
                f"training-side conversion, or serve at the snapshot's "
                f"mesh size")
        bb = int(meta["bucket_bytes"])
        layout = Zero3Layout(opt.slices, bb, mesh, one_rank=True)
        rows = [full.view(D, -1)[mesh.rank].clone()
                for full in opt.params_rows]
    else:
        if D != mesh.size:
            raise ModeRefusal(
                f"--sharded_mesh {D} on a group of {mesh.size} ranks — "
                f"each rank holds one row; run {D} ranks")
        bb = int(bucket_bytes or meta.get("bucket_bytes")
                 or DEFAULT_BUCKET_BYTES)
        layout = Zero3Layout(opt.slices, bb, mesh, one_rank=True)
        rows = layout.init_rows(opt.params_flat, mesh.rank)
    model = _placeholders(_serving_model(state), mesh.device)
    del state, opt                   # the full host copy goes here
    rows = [r.to(mesh.device) for r in rows]
    _log(f"promoted snapshot step {step} ({layout_name}, rows sharded at "
         f"1/{D}, bucket_bytes {bb}) from "
         f"{snapshot_dir}")
    return ShardedPromotion(model=model, rows=rows, layout=layout,
                            step=int(step), source_layout=layout_name,
                            manifest=man)


@torch.no_grad()
def _placeholders(model: nn.Module, device: torch.device) -> nn.Module:
    """``model`` on ``device`` with empty placeholder parameters, made on
    the device: moving an expanded tensor would materialize it at full
    size."""
    for p in model.parameters():
        p.data = torch.zeros((), device=device).expand(p.shape)
        p.grad = None
    return model.to(device)


def shard_model(model: nn.Module, *, mesh, bucket_bytes: int) -> tuple:
    """``(rows, layout)``: ``model``'s parameters cut into this rank's row
    of each bucket of a ``Zero3Layout`` over ``mesh`` at ``bucket_bytes``,
    on the mesh's device, with the model's parameters left as placeholders
    there — :func:`promote_sharded`'s conversion for a model made in
    memory rather than read from a snapshot."""
    opt = MomentumSGD(model, lambda count: np.float32(0.1), 0.0,
                      fused=False)
    layout = Zero3Layout(opt.slices, bucket_bytes, mesh, one_rank=True)
    rows = layout.init_rows(opt.params_flat, mesh.rank)
    del opt
    _placeholders(model, mesh.device)
    return [r.to(mesh.device) for r in rows], layout


def init_lm_snapshot(snapshot_dir: str, size: str, seed: int = 0) -> int:
    """Write a demo-grade snapshot: a seeded, untrained LM state in the
    standard store format (the serving path exercises the full promotion
    machinery against it — validity checks, layout stamp, fallback).
    Returns the snapshot step (0).  Idempotent: an existing valid
    snapshot at that step wins (``save`` dedupes by step)."""
    state = template_state(size, torch.device("cpu"), seed)
    SnapshotStore(snapshot_dir).save(
        state, cursor={"seed": seed, "step": 0},
        meta={"model": size, "update_layout": "tree",
              "writer": "init_lm_snapshot"})
    return int(state.step)


# --- canary promotion (the JAX package's self-healing rung) ---------------

def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def canary_fraction_default() -> float:
    """``HEAL_CANARY_FRACTION``: share of requests routed to a canary
    candidate while it proves itself (default 0.25)."""
    return _env_float("HEAL_CANARY_FRACTION", 0.25)


def canary_window_default() -> int:
    """``HEAL_CANARY_WINDOW``: canary-arm completions required before a
    promote/rollback verdict (default 16)."""
    return int(_env_float("HEAL_CANARY_WINDOW", 16))


def canary_p99_ratio_default() -> float:
    """``HEAL_CANARY_P99_RATIO``: canary p99 over this multiple of the
    baseline arm's p99 inside the window = regression → rollback
    (default 2.0)."""
    return _env_float("HEAL_CANARY_P99_RATIO", 2.0)


def params_healthy(params) -> bool:
    """Every float tensor finite (``params``: a module or an iterable of
    tensors) — the pre-exposure canary probe: a NaN-poisoned snapshot
    (a diverged run an operator promoted by mistake) is caught BEFORE a
    single request routes to it.  One host sync for all of them."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    checks = [torch.isfinite(t).all() for t in params
              if torch.is_floating_point(t)]
    return bool(torch.stack(checks).all()) if checks else True


class Canary:
    """Canary promotion state machine: a candidate snapshot serves a
    deterministic ``fraction`` of requests first, and the promotion
    commits only after a clean observation window — auto-rollback on a
    NaN probe or a p99 regression vs the baseline arm.

    State: ``probing`` → (``rolled_back`` | ``serving``) →
    (``promoted`` | ``rolled_back``).  This object owns the DECISION
    only; the serving harness owns the two engine arms and the drain
    (an in-flight canary request always decodes to completion —
    rollback must never drop admitted work, exactly the eviction
    protocol's rule).  The remediation engine
    (``resilience/remediate.py``) records the verdicts as
    ``heal_canary_*`` rows (``tools.heal_drill``'s canary drill)."""

    def __init__(self, baseline_step: int, candidate_step: int, *,
                 fraction: float | None = None,
                 window: int | None = None,
                 p99_ratio: float | None = None):
        self.baseline_step = int(baseline_step)
        self.candidate_step = int(candidate_step)
        self.fraction = canary_fraction_default() if fraction is None \
            else float(fraction)
        self.window = canary_window_default() if window is None \
            else int(window)
        self.p99_ratio = canary_p99_ratio_default() if p99_ratio is None \
            else float(p99_ratio)
        self.state = "probing"
        self.reason = ""
        self._lat: dict[str, list] = {"canary": [], "baseline": []}
        self._bad: int = 0

    def admit_candidate(self, candidate_params) -> bool:
        """The pre-exposure probe; False = immediate rollback (the
        candidate never serves)."""
        if not params_healthy(candidate_params):
            self.state = "rolled_back"
            self.reason = ("candidate params carry non-finite values — "
                           "rolled back before serving a single request")
            return False
        self.state = "serving"
        return True

    def route(self, rid: str) -> str:
        """Deterministic request routing while ``serving``: the same
        rid always lands on the same arm (a retried request must not
        flap arms mid-experiment)."""
        if self.state != "serving":
            return "baseline"
        import zlib
        bucket = zlib.crc32(str(rid).encode()) % 10_000
        return "canary" if bucket < self.fraction * 10_000 else "baseline"

    def observe(self, arm: str, latency_s: float, ok: bool = True) -> None:
        if not ok and arm == "canary":
            self._bad += 1
        self._lat.setdefault(arm, []).append(float(latency_s))

    @staticmethod
    def _p99(tape: list) -> float | None:
        if not tape:
            return None
        from distributedtensorflowexample_tpu_torch.serving.queue import (
            percentile)
        return percentile(sorted(tape), 0.99)

    def verdict(self) -> str | None:
        """None while the window is still filling; else ``promote`` /
        ``rollback`` (state committed, latched)."""
        if self.state in ("promoted", "rolled_back"):
            return ("promote" if self.state == "promoted"
                    else "rollback")
        if self._bad:
            self.state = "rolled_back"
            self.reason = (f"{self._bad} canary request(s) failed "
                           f"(NaN/garbage outcome) inside the window")
            return "rollback"
        can = self._lat["canary"]
        if len(can) < self.window:
            return None
        p99c = self._p99(can)
        p99b = self._p99(self._lat["baseline"])
        if p99b and p99c is not None and p99c > self.p99_ratio * p99b:
            self.state = "rolled_back"
            self.reason = (f"canary p99 {p99c * 1000:.1f}ms > "
                           f"{self.p99_ratio:g}x baseline p99 "
                           f"{p99b * 1000:.1f}ms over {len(can)} "
                           f"canary completions")
            return "rollback"
        self.state = "promoted"
        self.reason = (f"clean window: {len(can)} canary completions, "
                       f"p99 {0 if p99c is None else p99c * 1000:.1f}ms"
                       + (f" vs baseline {p99b * 1000:.1f}ms" if p99b
                          else ""))
        return "promote"

    def payload(self) -> dict:
        p99c, p99b = self._p99(self._lat["canary"]), \
            self._p99(self._lat["baseline"])
        return {
            "state": self.state, "reason": self.reason,
            "baseline_step": self.baseline_step,
            "candidate_step": self.candidate_step,
            "fraction": self.fraction, "window": self.window,
            "p99_ratio": self.p99_ratio,
            "canary_n": len(self._lat["canary"]),
            "baseline_n": len(self._lat["baseline"]),
            "canary_p99_ms": (None if p99c is None
                              else round(p99c * 1000, 3)),
            "baseline_p99_ms": (None if p99b is None
                                else round(p99b * 1000, 3)),
            "canary_failures": self._bad}


def as_prompt(tokens, vocab: int) -> np.ndarray:
    """Validate a request's prompt tokens on the HOST, before anything
    reaches the device: out-of-vocab ids are refused by name — the
    training-side OOV NaN-poison guards corruption mid-run, but a live
    batch must never be poisoned by one bad request (the refusal is the
    serving analog: loud, per-request, batch untouched)."""
    arr = np.asarray(tokens)
    if arr.ndim != 1 or arr.size == 0:
        raise ValueError(f"prompt must be a non-empty 1-D token list, "
                         f"got shape {arr.shape}")
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"prompt tokens must be integers, got dtype "
                         f"{arr.dtype}")
    if int(arr.min()) < 0 or int(arr.max()) >= vocab:
        raise ModeRefusal(
            f"request carries out-of-vocab token id(s) (valid range "
            f"[0, {vocab})) — refused at admission; the --size model's "
            f"vocabulary is fixed at training time and an OOV gather "
            f"would silently clamp into a wrong embedding row")
    return arr.astype(np.int32)
