"""Deterministic, seed-addressable fault injection for the train loop
(the JAX package's ``resilience/faults.py`` over the port's loop, hooks and
torch batches).

Every fault kind the JAX package drills, reproducible on the CPU and on
the card at will.  The plan grammar, the named plans and the seeded draws
are the JAX package's, so the same ``(text, num_steps, seed)`` names the
same scenario in both packages, and a poisoned batch is bitwise the JAX
one (the garbage comes from the same ``numpy`` draw; only the container
differs: a tensor on the batch's device):

==================  =====================================================
kind                models
==================  =====================================================
``preemption``      the platform's SIGTERM before slice reclaim — raised
                    at an exact step boundary via the process's real
                    signal path, so the loop's cooperative-stop +
                    save-on-exit machinery is what gets exercised
``wedge``           a dispatch that blocks without raising (a hung
                    driver call, a lost backend) — a boundary sleep
                    that starves the supervisor's heartbeat
``nan_loss``        numeric blowup: the covered FLOAT batch is poisoned
                    so the loss goes non-finite (NaNGuardHook fails fast
                    before the poisoned state can be snapshotted);
                    refused loudly on uint8 batches — no NaN byte exists
                    (use ``corrupt_batch`` there)
``corrupt_batch``   a corrupted batch off the wire: deterministic
                    garbage bytes for uint8 images, wide garbage ids
                    for integer token batches (out-of-vocab by
                    construction — the LM's OOV poison turns them into
                    the NaN the guard fails fast on), non-finite-
                    driving magnitudes for float images.  Rank-
                    targeted (``corrupt_batch@N%RANK`` or the named
                    ``corrupt_batch_rank`` plan) it is the one-bad-
                    host ingest scenario for gang drills
``torn_snapshot``   a checkpoint write torn mid-file — applied to the
                    newest snapshot AFTER the final save (see
                    tools/faultline.py), so recovery must fall back to
                    the previous manifest-valid snapshot
``heartbeat_flap``  a beat delayed to exactly the supervisor's timeout
                    edge, measured from the LAST beat (arg = delay
                    seconds; 0 reads the edge from
                    ``SUPERVISE_HEARTBEAT_TIMEOUT_S``): the boundary
                    blocks until the beat file's age reaches the edge,
                    then touches it — a slow-but-alive run skating the
                    watchdog line, the near-miss a hard wedge never
                    exercises
``journal_torn``    the supervisor's own journal truncated mid-line
                    (post-exit, like torn_snapshot): ``Journal.replay``
                    must skip the torn tail and at worst re-run the one
                    idempotent task whose completion record tore
``kill``            a hard host/process loss — SIGKILL to self at the
                    boundary: no cooperative save, no exit hooks, no
                    flight dump (SIGKILL cannot be caught).  What
                    distinguishes a lost rank from a clean preemption;
                    the gang-supervision drill's "kill rank 1 at
                    step 37" (resilience/fleet.py)
``host_loss``       a host loss, not just a process loss: the rank
                    writes its fleet-exported tombstone
                    (``FLEET_HOST_DOWN_FILE``, the spawn-OSError seam
                    resilience/fleet.py checks before every spawn) and
                    then SIGKILLs itself — the next respawn of this
                    rank FAILS like a dead host, driving the fleet's
                    rank-loss taxonomy (elastic shrink / refusal) as
                    policy.  ``arg`` = seconds until the host answers
                    again (the tombstone self-expires, so the recovery
                    re-probe grows the gang back); 0 = down until the
                    tombstone is removed.  ``host_loss@N:SECS%rank``
``slow_rank``       a PERSISTENT straggler: every step boundary from the
                    fault step onward is delayed ``arg`` seconds
                    (default 0.25) — slow-but-alive, heartbeats keep
                    flowing, nothing crashes; only throughput suffers.
                    Pinned to one rank (``slow_rank@10:0.5%1``) it is
                    the reproducible scenario the lockstep-SPMD
                    ``replicas_to_aggregate`` shape exists for, and the
                    control case for the bucketed/overlapped collective
                    schedules (--bucket_grads): a straggler stretches
                    every rendezvous, so fewer collectives per step =
                    fewer stretch points.  Survives resume: a plan step
                    already passed at restart re-activates the delay
                    (the rank is still slow) instead of dropping it
``shard_loss``      (a plan kind here; ``tools/faultline.py`` refuses
                    it with ``--layout zero3``, which the port's
                    faultline does not run yet) one rank's shard directory deleted from the newest
                    shard-redundant snapshot set AFTER the final save
                    (post-exit, like torn_snapshot) — recovery must
                    reconstruct the missing shard from its ring mirror
                    (resilience/shardstore.py); ``%RANK`` names the
                    MESH-SHARD index inside this process's own store,
                    not a process rank
``bitflip``         (refused by the port's faultline, as above)
                    silent bit rot: one payload byte of one rank's own
                    shard flipped in place (post-exit) — the sha256
                    digest must catch it and restore must reconstruct
                    from the mirror, never silently load the rotten
                    bytes.  ``%RANK`` = mesh-shard index, as above
==================  =====================================================

A plan is addressed by ``(text, num_steps, seed)``: unpinned fault steps
are drawn from ``random.Random`` seeded with those, so the same CLI line
reproduces the same scenario anywhere (tools/faultline.py), and a
different seed explores a different schedule with no code change.

Multi-process drills add per-rank targeting: a spec may carry
``rank=N`` (CLI grammar ``kind[@step][:arg][%rank]``, e.g.
``kill@37%1`` = "kill rank 1 at step 37"), and each rank filters the
shared plan text through :meth:`FaultPlan.for_rank` — every rank parses
the SAME text with the SAME seed, so unpinned steps land on the same
anchor fleet-wide and the scenario stays one reproducible triple.

Loop-level faults ride the Hook surface (training/hooks.py); batch-level
faults wrap the batch iterator (FaultyBatches mirrors TrainLoop's
``steps_per_call`` arithmetic so a fault step inside a fused window
poisons exactly the window that covers it).
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import time

import numpy as np
import torch

from distributedtensorflowexample_tpu_torch.obs import metrics as obs_metrics
from distributedtensorflowexample_tpu_torch.obs import recorder as obs_recorder
from distributedtensorflowexample_tpu_torch.obs import trace as obs_trace
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
from distributedtensorflowexample_tpu_torch.training.hooks import (
    Hook, _EveryN, touch_heartbeat)

FAULT_KINDS = ("preemption", "wedge", "nan_loss", "corrupt_batch",
               "torn_snapshot", "heartbeat_flap", "journal_torn", "kill",
               "slow_rank", "host_loss", "shard_loss", "bitflip")
_BATCH_KINDS = ("nan_loss", "corrupt_batch")
_POST_EXIT_KINDS = ("torn_snapshot", "journal_torn", "shard_loss",
                    "bitflip")
# Shard-store faults address a MESH-SHARD index inside one process's own
# ShardStore (a single process owns all D shard files on a D-device CPU
# mesh), so %RANK on them must survive FaultPlan.for_rank's process-rank
# filter.
_SHARD_KINDS = ("shard_loss", "bitflip")

_INJECTED = obs_metrics.counter(
    "faults_injected_total", "fault-plan specs that fired, by kind")

# heartbeat_flap aims its beat at the watchdog edge MINUS this margin:
# time.sleep only ever overshoots, so aiming at the edge itself would
# land the beat strictly past it and a supervisor poll in that overshoot
# window would kill the child the drill says must survive.  The margin
# keeps the near-miss deterministic-survivable while staying far inside
# the supervisor's 0.2-s poll granularity.
FLAP_EDGE_MARGIN_S = 0.05

# Named plans: the scenario library tools/faultline.py exposes.  A None
# step is drawn deterministically from the plan seed (one shared anchor
# per plan, so e.g. torn_snapshot+preemption land at the SAME step — the
# "final write torn" shape).  Entries are (kind, step, arg) or
# (kind, step, arg, rank) — a 4-tuple pins the spec to one rank, the
# grammar's %RANK suffix as a named scenario.
NAMED_PLANS = {
    "none": [],
    "preempt": [("preemption", None, 0.0)],
    "wedge": [("wedge", None, 2.0)],
    "nan_loss": [("nan_loss", None, 0.0)],
    "corrupt_batch": [("corrupt_batch", None, 0.0)],
    # Rank-targeted corruption (the ROADMAP round-8 candidate): ONE
    # rank's batch goes bad off the wire — on a token pipeline the LM's
    # OOV poison NaNs that rank's loss, NaNGuard kills it, and the gang
    # supervisor must tear down + agree a resume step while the healthy
    # ranks were mid-stride.  Rank 1 by convention (the 2-rank drills'
    # non-chief rank); pin others with corrupt_batch@N%RANK.
    "corrupt_batch_rank": [("corrupt_batch", None, 0.0, 1)],
    "torn_snapshot": [("torn_snapshot", None, 0.0),
                      ("preemption", None, 0.0)],
    # arg 0.0: the flap delay defaults to the supervisor-exported
    # timeout itself — the exact edge.
    "heartbeat_flap": [("heartbeat_flap", None, 0.0)],
    # Paired with a preemption (same anchor step) so a supervised run
    # HAS a next attempt — the torn journal only matters at replay.
    "journal_torn": [("journal_torn", None, 0.0),
                     ("preemption", None, 0.0)],
    # Mild persistent straggle from the anchor step on; pin a rank with
    # the spec grammar (slow_rank@N:SECS%RANK) for gang drills.
    "slow_rank": [("slow_rank", None, 0.25)],
    # Rank 1's HOST dies at the anchor step and answers again 2 s later
    # (tombstone self-expiry): the elastic shrink-then-grow scenario the
    # scheduler's autoscaling policy drills.  Pin others / change the
    # outage length with the grammar (host_loss@N:SECS%RANK).
    "host_loss": [("host_loss", None, 2.0, 1)],
    # Mesh-shard 1's snapshot directory vanishes after the final save,
    # paired with a preemption at the same anchor so a supervised run
    # HAS a next attempt — which must reconstruct the shard from its
    # ring mirror and resume bitwise (the "any single-rank shard loss"
    # drill).  Pin another shard with the grammar (shard_loss@N%RANK).
    "shard_loss": [("shard_loss", None, 0.0, 1),
                   ("preemption", None, 0.0)],
    # One payload byte of mesh-shard 1's own file flips after the final
    # save (silent bit rot); the next attempt's restore must DETECT the
    # digest mismatch and reconstruct — never silently load rot.
    "bitflip": [("bitflip", None, 0.0, 1),
                ("preemption", None, 0.0)],
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    kind: str
    step: int           # global step the fault fires at (boundary/window)
    arg: float = 0.0    # kind-specific (wedge: seconds to block)
    rank: int | None = None   # None = every rank; N = that rank only

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {FAULT_KINDS})")
        if self.step < 1:
            raise ValueError(f"fault step {self.step} must be >= 1")
        if self.rank is not None and self.rank < 0:
            raise ValueError(f"fault rank {self.rank} must be >= 0")


class FaultPlan:
    """An ordered set of FaultSpecs plus the seed that addressed them."""

    def __init__(self, specs: list[FaultSpec], seed: int = 0,
                 name: str = ""):
        self.specs = sorted(specs, key=lambda s: (s.step, s.kind))
        self.seed = seed
        self.name = name

    def __bool__(self) -> bool:
        return bool(self.specs)

    @property
    def batch_specs(self) -> list[FaultSpec]:
        return [s for s in self.specs if s.kind in _BATCH_KINDS]

    @property
    def loop_specs(self) -> list[FaultSpec]:
        return [s for s in self.specs
                if s.kind not in _BATCH_KINDS + _POST_EXIT_KINDS]

    @property
    def post_exit_specs(self) -> list[FaultSpec]:
        return [s for s in self.specs if s.kind in _POST_EXIT_KINDS]

    def for_rank(self, rank: int) -> "FaultPlan":
        """This rank's view of a fleet-shared plan: specs pinned to
        another rank drop out; unpinned (rank=None) specs apply
        everywhere.  Every rank filters the SAME parsed plan, so the
        shared seed anchor stays identical fleet-wide — 'kill rank 1 at
        the seed-drawn step' names one step, not one per rank.  Shard-
        store faults (``_SHARD_KINDS``) are exempt: their %RANK names a
        mesh-shard index in THIS process's own store, so every process
        keeps them."""
        keep = [s for s in self.specs
                if s.rank is None or s.rank == rank
                or s.kind in _SHARD_KINDS]
        return FaultPlan(keep, seed=self.seed,
                         name=f"{self.name}[rank {rank}]")

    @classmethod
    def parse(cls, text: str, num_steps: int, seed: int = 0) -> "FaultPlan":
        """Build a plan from CLI text: comma-separated tokens, each a
        named plan from NAMED_PLANS or ``kind[@step][:arg][%rank]``
        (e.g. ``preemption@3``, ``wedge:5.0``, ``kill@37%1`` = kill
        rank 1 at step 37).  Unpinned steps share one anchor drawn
        deterministically from ``(text, num_steps, seed)`` in
        ``[1, num_steps-1]`` — mid-run, never the final step, so
        there is always work left for the recovery to prove itself on."""
        rng = random.Random(f"{text}|{num_steps}|{seed}")
        anchor = rng.randrange(1, max(2, num_steps))
        specs: list[FaultSpec] = []
        for token in filter(None, (t.strip() for t in text.split(","))):
            if token in NAMED_PLANS:
                for entry in NAMED_PLANS[token]:
                    kind, step, arg = entry[:3]
                    rank = entry[3] if len(entry) > 3 else None
                    specs.append(FaultSpec(kind, anchor if step is None
                                           else step, arg, rank=rank))
                continue
            body, _, ranktxt = token.partition("%")
            body, _, argtxt = body.partition(":")
            kind, _, steptxt = body.partition("@")
            specs.append(FaultSpec(
                kind, int(steptxt) if steptxt else anchor,
                float(argtxt) if argtxt else
                (2.0 if kind == "wedge" else
                 0.25 if kind == "slow_rank" else 0.0),
                rank=int(ranktxt) if ranktxt else None))
        return cls(specs, seed=seed, name=text)


def _mark_fired(spec: FaultSpec, step: int) -> None:
    """Every fired fault is telemetry: counted by kind and recorded as
    a zero-duration span, so a flight dump names the injection that
    preceded the death it documents."""
    _INJECTED.labels(kind=spec.kind).inc()
    obs_trace.event("fault", 0.0, kind=spec.kind, step=step)


def mark_host_down(path: str, down_s: float = 0.0,
                   rank: int | None = None) -> None:
    """Write the host-loss tombstone (atomically — the reader must see
    a whole record or none): ``down_s`` > 0 makes the outage self-heal
    after that long (resilience/fleet.py removes the expired tombstone
    at the next probe), 0 means down until the file is removed.  Split
    out of the hook so the seam is unit-testable without SIGKILLing the
    test process."""
    rec = {"ts": obs_metrics._wall(), "down_s": float(down_s),
           "rank": rank, "pid": os.getpid()}
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(rec, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def tear_journal(path: str) -> bool:
    """Truncate ``path`` mid-way through its LAST line — a journal
    append that died between bytes (the ``journal_torn`` fault).  The
    torn tail is exactly what ``supervisor.Journal.replay`` skips; at
    worst the one task whose completion record tore re-runs, and every
    capture phase is idempotent by design.  Returns False (no tear) on
    a missing or empty file."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return False
    body = data.rstrip(b"\n")
    if not body:
        return False
    start = body.rfind(b"\n") + 1
    cut = start + max(1, (len(body) - start) // 2)
    with open(path, "r+b") as f:
        f.truncate(cut)
    return True


class FaultInjectionHook(Hook):
    """Fires loop-level faults at their exact step boundaries.

    Boundary placement is load-bearing: the train step updates the
    state in place, so faults must land where the loop's own
    interruption machinery lands (see TrainLoop.should_stop) — after a
    completed step, never inside the step's call.  A resumed loop whose
    ``start_step`` already passed a fault marks it fired (the run
    already lived through it)."""

    def __init__(self, plan: FaultPlan):
        self._plan = plan
        self._fired: set[int] = set()
        # slow_rank accumulator: once its spec fires, every later
        # boundary sleeps this long (a straggler is a CONDITION, not an
        # event — unlike wedge's one-shot block).
        self._slow_s = 0.0

    def begin(self, loop) -> None:
        self._slow_s = 0.0
        for i, s in enumerate(self._plan.loop_specs):
            if s.step <= loop.start_step:
                self._fired.add(i)
                if s.kind == "slow_rank":
                    # A resumed run past the fault step is STILL slow —
                    # the condition re-activates without re-counting as
                    # a fresh injection.
                    self._slow_s += s.arg

    def after_step(self, step, state, metrics) -> bool:
        for i, s in enumerate(self._plan.loop_specs):
            if i in self._fired or step < s.step:
                continue
            self._fired.add(i)
            _mark_fired(s, step)
            if s.kind == "slow_rank":
                self._slow_s += s.arg
            elif s.kind == "wedge":
                # Blocks without raising — exactly what a hung driver
                # call does to a step.  The heartbeat goes stale; only an
                # external watchdog (resilience.supervisor) can act.
                time.sleep(s.arg)
            elif s.kind == "heartbeat_flap":
                # The near-miss: delay the NEXT beat to exactly the
                # watchdog's timeout edge (arg overrides; 0 reads the
                # edge the supervisor exported), then beat.  The edge
                # is measured from the LAST beat — the age the watchdog
                # actually polls — not from this boundary: the previous
                # boundary's beat landed a step ago, and sleeping the
                # full timeout on top of that would blow past the edge
                # and get the child killed mid-drill.  The staleness
                # check is strictly `age > timeout`, so a beat landing
                # ON the edge must survive — this fault is what keeps
                # that boundary honest.
                delay = s.arg or float(os.environ.get(
                    "SUPERVISE_HEARTBEAT_TIMEOUT_S", "0"))
                if not delay:
                    # Refused loudly, like nan_loss on uint8 batches: a
                    # flap with no edge to aim at would sleep 0 s and
                    # beat into nothing, yet report the drill as fired.
                    raise ValueError(
                        "heartbeat_flap has no timeout edge to aim at: "
                        "pass an explicit delay (heartbeat_flap@N:SECS) "
                        "or run under the supervisor, which exports "
                        "SUPERVISE_HEARTBEAT_TIMEOUT_S")
                hb = os.environ.get("SUPERVISE_HEARTBEAT", "")
                if not hb:
                    # Same discipline: without a beat file the "flap"
                    # would stall the boundary and beat into nothing.
                    raise ModeRefusal(
                        "heartbeat_flap has no heartbeat file to beat "
                        "(SUPERVISE_HEARTBEAT unset) — run under "
                        "supervise.py with --heartbeat/"
                        "--heartbeat_timeout_s, or export "
                        "SUPERVISE_HEARTBEAT")
                try:
                    delay -= time.time() - os.path.getmtime(hb)
                except OSError:
                    pass        # no beat yet: the full delay IS the edge
                time.sleep(max(0.0, delay - FLAP_EDGE_MARGIN_S))
                touch_heartbeat(hb)
            elif s.kind == "preemption":
                # Through the real signal path, not a direct flag poke:
                # the handler installation, the cooperative poll, and
                # the save-on-exit are all under test.
                signal.raise_signal(signal.SIGTERM)
            elif s.kind == "kill":
                # A lost host, not a preemption: SIGKILL is uncatchable,
                # so no save-on-exit, no exit hooks, no flight dump run
                # — recovery must come entirely from what was already on
                # disk (the snapshot this boundary's SnapshotHook wrote
                # before this hook fired) plus an external supervisor.
                os.kill(os.getpid(), signal.SIGKILL)
            elif s.kind == "host_loss":
                # kill's bigger sibling: the HOST goes too.  Tombstone
                # first (the fleet's spawn-OSError seam — the respawn of
                # this rank must fail like a dead host, for `arg`
                # seconds), then the uncatchable SIGKILL.  Refused
                # loudly without the seam: a "host loss" whose respawn
                # would quietly succeed drills nothing.
                down_file = os.environ.get("FLEET_HOST_DOWN_FILE", "")
                if not down_file:
                    raise ValueError(
                        "host_loss has no tombstone seam to write "
                        "(FLEET_HOST_DOWN_FILE unset) — run the drill "
                        "under tools/supervise_fleet.py or "
                        "tools/schedule.py, which export it per rank")
                mark_host_down(
                    down_file, down_s=s.arg,
                    rank=int(os.environ.get("OBS_RANK", "0") or 0))
                os.kill(os.getpid(), signal.SIGKILL)
        if self._slow_s:
            # The straggler condition: pure boundary delay, heartbeats
            # and hooks untouched — slow-but-alive by construction.
            time.sleep(self._slow_s)
        return False


class FaultyBatches:
    """Batch-iterator wrapper that corrupts the batch whose step window
    covers a batch-fault step.  Tracks the loop's position with the same
    ``start_step``/``steps_per_next`` arithmetic as DeviceDataset, so it
    composes with fused multi-step calls."""

    def __init__(self, batches, plan: FaultPlan, start_step: int = 0,
                 steps_per_next: int = 1):
        self._it = iter(batches)
        self._plan = plan
        self._step = int(start_step)
        self._spn = max(1, steps_per_next)
        self._rng = np.random.default_rng(plan.seed)
        self._fired = {i for i, s in enumerate(plan.batch_specs)
                       if s.step <= start_step}
        # TrainLoop reads .prefetch at construction; forward the wrapped
        # iterator's (None when absent keeps the loop's skip behavior).
        self.prefetch = getattr(batches, "prefetch", None)

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._it)
        lo, hi = self._step + 1, self._step + self._spn
        self._step = hi
        for i, s in enumerate(self._plan.batch_specs):
            if i in self._fired or not (lo <= s.step <= hi):
                continue
            self._fired.add(i)
            _mark_fired(s, s.step)
            batch = self._corrupt(batch, s.kind)
        return batch

    def _corrupt(self, batch, kind: str):
        src = batch["image"]
        img = (src.detach().cpu().numpy() if isinstance(src, torch.Tensor)
               else np.asarray(src))
        if kind == "nan_loss":
            # The kind check comes FIRST: a nan_loss that silently
            # degraded to legal random values on an integer pipeline
            # would make the NaN-guard drill pass vacuously — the guard
            # never fires, yet the scenario reports success.  (np.full
            # with NaN into an int dtype would not even produce a legal
            # batch — it raises or wraps to garbage silently.)
            if np.issubdtype(img.dtype, np.integer):
                raise ValueError(
                    f"nan_loss cannot be represented in a {img.dtype} "
                    f"batch (no NaN integer exists); use corrupt_batch "
                    f"for uint8/token pipelines or inject on the float "
                    f"(host-fed) path")
            bad = np.full(img.shape, np.nan, img.dtype)
        elif img.dtype == np.uint8:
            # A corrupted uint8 batch off the wire: every value is still
            # a legal byte, so only training dynamics (or a checksum
            # upstream) can notice — deterministic from the plan seed.
            # On a TOKEN pipeline (vocab < 256 by design — transformer_
            # lm.LM_VOCAB) random bytes land out-of-vocab and the LM's
            # OOV poison turns them into the NaN the guard fails fast on.
            bad = self._rng.integers(0, 256, img.shape, dtype=np.uint8)
        elif np.issubdtype(img.dtype, np.integer):
            # Wide-integer token ids off the wire: garbage ids far
            # outside any vocab — the LM poisons its logits on them
            # (models/transformer_lm.py OOV guard) rather than let an
            # embedding lookup read out of range.
            bad = self._rng.integers(0, np.iinfo(np.int32).max,
                                     img.shape).astype(img.dtype)
        else:
            # Finite but loss-exploding magnitudes: overflow to inf/nan
            # inside the forward pass, not in the input itself.
            bad = (self._rng.standard_normal(img.shape) * 1e38).astype(
                img.dtype)
        if isinstance(src, torch.Tensor):
            # The same bytes, back on the batch's device.
            bad = torch.from_numpy(bad).to(src.device)
        return {**batch, "image": bad}


class NaNGuardHook(Hook):
    """Fail fast on a non-finite loss.

    Raises at the call boundary (safe: the step's update completed) so
    the process dies BEFORE the poisoned state reaches a snapshot — the
    exception propagates past the end hooks, the last save on disk is
    the last healthy step, and a supervisor restart resumes from there
    instead of training forward on garbage."""

    def __init__(self, every: int = 1):
        self._due = _EveryN(max(1, every))

    def begin(self, loop) -> None:
        self._due = _EveryN(self._due._every, int(loop.start_step))

    def after_step(self, step, state, metrics) -> bool:
        if self._due(step):
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                # Dump the flight BEFORE raising: the exception kills
                # the process, and the poisoned-loss evidence (span
                # ring, counters, loss tail) is the postmortem.
                obs_recorder.dump_global("nan_guard")
                raise FloatingPointError(
                    f"non-finite loss {loss} at step {step} — refusing to "
                    f"snapshot a poisoned state; restart resumes from the "
                    f"last healthy snapshot")
        return False


class MetricsTapeHook(Hook):
    """Record the (step, loss) trajectory — the metric half of the
    bitwise resume-parity contract (a resumed run must reproduce not
    just the final params but every logged value along the way)."""

    def __init__(self):
        self.tape: list[tuple[int, float]] = []

    def after_step(self, step, state, metrics) -> bool:
        self.tape.append((step, float(metrics["loss"])))
        return False
