# graftlint: stdlib-only
"""Ledger-driven control plane: a journaled multi-run scheduler with
elastic autoscaling and loss-free SLO preemption (the JAX package's
``resilience/scheduler.py``; pure Python over the port's fleet,
supervisor and ``obs/``, with the same ``sched.jsonl`` records and
``sched_*`` ledger rows, so a journal written by either package replays
in the other).

A crash-tolerant queue of heterogeneous jobs (train / bench / faultline
drill / serving load tests) admitted against measured cost, packed onto
the available devices, and supervised with robustness as policy.  The
scheduler process itself never touches a device: it only starts gangs
(``FleetSupervisor``), whose ranks take their card by the port's rule
(``rank % device_count``, ``parallel/mesh.py``), so ``devices`` counts
gang slots, and one card can hold every slot.

- **admission against measured cost** — a job's step time is predicted
  from a trajectory file's family (the newest round's
  ``*steps_per_sec`` metric, conservatively the slowest) when the
  caller names one, falling back to the job's declared estimate; the prediction prices the admission
  row and, unless the job pins its own wall timeout, derives the
  fleet's per-attempt deadline (``cost_margin`` x predicted).
- **packing** — jobs take ``ranks`` devices each and launch, priority
  order, whenever they fit the free mesh.  A job wider than the mesh is
  refused at admission, never queued forever.
- **elastic shrink / grow-on-recovery** — each gang runs under the
  :class:`~distributedtensorflowexample_tpu_torch.resilience.fleet.
  FleetSupervisor`; a lost host shrinks an ``elastic`` job's gang
  (exercised end-to-end via the ``host_loss`` fault) and
  the scheduler records the shrink, then drives the recovery re-probe:
  when the lost rank answers again and the mesh has room, the job is
  cleanly stopped (TERM→143→snapshot) and relaunched at FULL width.
- **SLO preemption, loss-free** — a higher-priority job that cannot fit
  evicts the least-urgent running job(s) through
  ``FleetSupervisor.request_stop``: the victim's ranks save and exit
  143, the job requeues (preemptions are never charged to its retry
  budget), and its relaunch resumes from the agreed snapshot step with
  zero lost steps — bitwise-identical to an uninterrupted run.
- **bounded retry / quarantine** — crashes and exhausted fleets requeue
  with jittered exponential backoff up to the job's ``retries``; a
  gang that reports the backend wedged (rc 3) is QUARANTINED, never
  requeued — the supervisor protocol's "stop burning the window" rule
  as queue policy.

Every decision lands twice: in the scheduler's own write-ahead journal
(``sched.jsonl`` — the crash-tolerance surface) and as a ``sched_*``
row in the run ledger (``RUNS.jsonl`` — the query surface), so "why
was this job preempted / shrunk / quarantined" is answered after the
fact from ledger rows alone.

Crash tolerance is the fleet's ``resume_agreement`` pattern: mutating
decisions write an INTENT record before the side effect and an applied
record after, so a scheduler SIGKILLed mid-decision replays its journal
on restart — unmatched terminal intents are re-applied idempotently,
non-terminal jobs requeue, and rank process groups orphaned by the dead
incarnation are swept (their pids are in each job's fleet journal —
``rank_spawn`` rows with no matching ``rank_exit``) before anything
relaunches over their stores.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import sys
import threading
import time

from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
from distributedtensorflowexample_tpu_torch.obs import metrics as obs_metrics
from distributedtensorflowexample_tpu_torch.resilience import (
    remediate as heal_mod)
from distributedtensorflowexample_tpu_torch.resilience.fleet import (
    FleetSupervisor, GangResult, RankLostError)
from distributedtensorflowexample_tpu_torch.resilience.supervisor import (
    RC_PREEMPTED, Journal, RetryPolicy)
from distributedtensorflowexample_tpu_torch.utils.signals import sigterm_flag

# The sched_* ledger-row schema: every decision class the scheduler can
# take, written with src="sched" plus a "job" field (and queue-level
# rows with job=None).  The `why` verb of tools.obs_query (and of the
# JAX package's tools/obs_query.py) renders exactly this set, so it
# stays the JAX package's tuple (tests/test_torch_scheduler.py holds the
# two equal).
SCHED_EVENTS = (
    "sched_submit",       # job registered (kind, priority, ranks, argv)
    "sched_admit",        # admitted: predicted cost + its source
    "sched_refuse",       # refused at admission (unplaceable/over budget)
    "sched_place",        # gang launched onto the mesh (devices, attempt)
    "sched_shrink",       # elastic gang lost a rank and runs narrower
    "sched_grow",         # lost rank recovered; relaunch at full width
    "sched_evict",        # SLO preemption: TERM→143→snapshot, requeued
    "sched_retry",        # crash/exhaustion: requeued with backoff
    "sched_quarantine",   # backend wedged (rc 3): never requeued
    "sched_fail",         # retry budget exhausted
    "sched_done",         # job completed (rc 0 on every rank)
    "sched_orphan_killed",  # restart swept a dead incarnation's gang
    "sched_queue_done",   # queue drained; outcome counts
)

# The tick-loop sleep seam: the fleet simulator (sim/clock.py)
# swaps this for a virtual sleep that advances the simulated clock and
# fires due world events, so the REAL policy loop below runs unmodified
# at fleet scale.  All in-loop clock reads go through
# obs_metrics._now/_wall for the same reason.
_sleep = time.sleep

_DECISIONS = obs_metrics.counter(
    "sched_decisions_total", "scheduler decisions applied, by action")
_QUEUE_DEPTH = obs_metrics.gauge(
    "sched_queue_depth", "queued (not yet terminal, not running) jobs")
_DEVICES_BUSY = obs_metrics.gauge(
    "sched_devices_busy", "mesh devices held by running gangs")

#: States a job never leaves.
TERMINAL = ("done", "failed", "quarantined", "refused")

DEFAULT_TICK_S = 0.25
#: Default SLO priority per job kind — lower runs (and evicts) first.
#: Serving load tests outrank everything (the north star's traffic);
#: drills yield to real work.
DEFAULT_SLO_PRIORITIES = {"serve": 0, "train": 10, "bench": 20,
                          "drill": 30}


def _log(msg: str) -> None:
    print(f"sched: {msg}", file=sys.stderr, flush=True)


def queue_path_default() -> str:
    """``SCHED_QUEUE``: the queue file ``tools.schedule`` loads when
    ``--queue`` is not passed — empty means the flag is required."""
    return os.environ.get("SCHED_QUEUE", "")


def tick_default() -> float:
    """``SCHED_TICK_S``: the policy-loop cadence (reap, observe,
    evict/grow/admit) — the latency floor on every decision."""
    try:
        return float(os.environ.get("SCHED_TICK_S", ""))
    except ValueError:
        return DEFAULT_TICK_S


def slo_priorities() -> dict[str, int]:
    """Per-kind default priorities, env-overridable:
    ``SCHED_SLO_PRIORITIES=serve=0,bench=5`` updates/extends the
    defaults.  Malformed tokens are skipped loudly — a typo must not
    silently re-rank the queue to the hardcoded table."""
    out = dict(DEFAULT_SLO_PRIORITIES)
    txt = os.environ.get("SCHED_SLO_PRIORITIES", "")
    for token in filter(None, (t.strip() for t in txt.split(","))):
        kind, _, num = token.partition("=")
        try:
            out[kind.strip()] = int(num)
        except ValueError:
            _log(f"SCHED_SLO_PRIORITIES token {token!r} is not "
                 f"kind=int — ignored")
    return out


# --- job description -------------------------------------------------------

@dataclasses.dataclass
class Job:
    """One queue entry — the job DESCRIPTION, placement-free (the
    TF-Replicator separation): what to run, how wide, how urgent, and
    what it is predicted to cost."""

    job: str                       # unique id (also the workdir segment)
    argv: list                     # {rank}/{num_ranks} substituted
    kind: str = "train"            # train | bench | drill | serve | ...
    ranks: int = 1                 # gang width = device demand
    priority: int | None = None    # lower = more urgent; None = by kind
    steps: int | None = None       # work size, for the cost prediction
    family: str = ""               # BENCH_trajectory family for cost
    est_step_time_s: float | None = None   # declared fallback estimate
    retries: int = 1               # scheduler-level requeues (crashes)
    fleet_retries: int = 1         # gang restarts INSIDE one placement
    snapshots: str = ""            # per-rank SnapshotStore template
    state_bytes: int = 0           # snapshot state size — prices the
    #                              # cross-slice migration a multi-slice
    #                              # eviction may force on the victim
    elastic: bool = True           # shrink on rank loss (sync state)
    worker_tiled: bool = False     # async state: shrink is illegal
    wall_timeout_s: float = 0.0    # 0 = derive from predicted cost
    kill_grace_s: float = 10.0     # TERM→KILL grace (covers the save)
    heartbeat_timeout_s: float = 0.0
    start_after_s: float = 0.0     # ready this long after queue start
    after_file: str = ""           # ready once this path exists
    env: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if (not self.job or os.sep in self.job
                or (os.altsep and os.altsep in self.job)
                or self.job in (".", "..")
                or self.job != self.job.strip()):
            raise ValueError(f"job id {self.job!r} must be a non-empty "
                             f"path-safe token")
        if self.ranks < 1:
            raise ValueError(f"job {self.job}: ranks {self.ranks} "
                             f"must be >= 1")
        if not self.argv:
            raise ValueError(f"job {self.job}: empty argv")
        bad = [t for t in self.argv if not isinstance(t, str)]
        if bad:
            # A natural queue-file mistake ({"argv": [..., "--steps",
            # 12]}) must refuse loudly here, not burn the retry budget
            # on a deterministic AttributeError deep in rank spawn.
            raise ValueError(f"job {self.job}: argv tokens must be "
                             f"strings, got {bad!r}")

    @classmethod
    def from_dict(cls, rec: dict) -> "Job":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(rec) - known)
        if unknown:
            raise ValueError(
                f"job {rec.get('job')!r}: unknown field(s) {unknown} "
                f"(known: {sorted(known)})")
        return cls(**rec)

    def resolved_priority(self, slo: dict[str, int]) -> int:
        if self.priority is not None:
            return self.priority
        return slo.get(self.kind, max(slo.values(), default=99) + 1)


# --- the cost model --------------------------------------------------------

def trajectory_rows(path: str) -> list[dict]:
    """A trajectory file (the JAX package's BENCH_trajectory.json): one
    JSON line per bench family per round.  Missing or torn lines read as
    no data — cost prediction degrades to declared
    estimates, never raises."""
    rows: list[dict] = []
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return rows
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and rec.get("family"):
            rows.append(rec)
    return rows


def predict_cost(job: Job, trajectory_path: str = "") -> dict:
    """{"step_time_s", "predicted_s", "source"} — the admission price.

    Measured first: the NEWEST trajectory row whose family contains the
    job's ``family`` string, read at its slowest ``*steps_per_sec``
    metric (admission should be conservative — over-predicting cost
    reserves too much wall budget, under-predicting kills the job at a
    cost-derived deadline it never had a chance to meet).  Declared
    ``est_step_time_s`` is the fallback; no estimate at all prices the
    job as unknown (admitted, but with no derived deadline)."""
    step_time = None
    source = None
    if job.family and trajectory_path:
        rows = [r for r in trajectory_rows(trajectory_path)
                if job.family in str(r.get("family", ""))]
        if rows:
            newest = max(rows, key=lambda r: (r.get("round") is not None,
                                              r.get("round") or -1))
            rates = [v for k, v in (newest.get("metrics") or {}).items()
                     if k.endswith("steps_per_sec")
                     and isinstance(v, (int, float)) and v > 0]
            if rates:
                step_time = 1.0 / min(rates)
                source = f"trajectory:{newest.get('file')}"
    if step_time is None and job.est_step_time_s:
        step_time = float(job.est_step_time_s)
        source = "declared"
    predicted = (round(step_time * job.steps, 3)
                 if step_time and job.steps else None)
    return {"step_time_s": (round(step_time, 6) if step_time else None),
            "predicted_s": predicted, "source": source}


def load_collective_fit(path: str, devices: int) -> dict | None:
    """Read the fitted ``t(S) = alpha + S/beta`` psum line for the
    nearest measured device count out of a BENCH_collectives record
    (``knees.psum.<devices>.{alpha_s, beta_bytes_per_s}``) — the price
    model for moving a victim's snapshot state across slices.  Missing
    or malformed records read as "no fit" (pricing degrades to
    unpriced), never raise."""
    try:
        with open(path) as f:
            rec = json.load(f)
        knees = rec["detail"]["knees"]["psum"]
        fits = {int(k): v for k, v in knees.items()}
        nearest = min(fits, key=lambda d: (abs(d - devices), d))
        fit = fits[nearest]
        return {"alpha_s": float(fit["alpha_s"]),
                "beta_bytes_per_s": float(fit["beta_bytes_per_s"]),
                "fit_devices": nearest, "file": os.path.basename(path)}
    except (OSError, KeyError, TypeError, ValueError,
            json.JSONDecodeError):
        return None


# --- per-job runtime state -------------------------------------------------

@dataclasses.dataclass
class _JobState:
    job: Job
    priority: int
    submit_idx: int
    state: str = "queued"
    width: int = 0                 # devices currently held (0 = none)
    retries_used: int = 0
    preemptions: int = 0
    shrinks: int = 0
    grows: int = 0
    launches: int = 0
    not_before: float = 0.0        # backoff gate (monotonic)
    admitted: bool = False
    cost: dict = dataclasses.field(default_factory=dict)
    ran: bool = False              # a previous placement left snapshots
    slice_name: str = ""           # which mesh slice the gang holds
    fleet: FleetSupervisor | None = None
    thread: threading.Thread | None = None
    result: list = dataclasses.field(default_factory=list)
    stop: tuple | None = None      # (reason, seq, detail) once requested
    why_last: str = ""


class Scheduler:
    """The control plane: one single-threaded policy loop (tick) over
    per-job FleetSupervisor run threads.  See the module docstring for
    the decision rules."""

    def __init__(self, jobs: list[Job], devices: int = 4,
                 workdir: str = "/tmp/sched",
                 journal: Journal | None = None,
                 ledger_path: str | None = None,
                 tick_s: float | None = None,
                 poll_s: float = 0.05,
                 seed: int | None = 0,
                 cost_margin: float = 16.0,
                 max_job_s: float = 0.0,
                 trajectory_path: str = "",
                 retry_policy: RetryPolicy | None = None,
                 heal: bool = True,
                 slices: dict[str, int] | None = None,
                 collective_fit: dict | None = None,
                 fleet_factory=None):
        # Multi-slice packing: ``slices`` maps mesh-slice name →
        # device capacity (TF-Replicator's placement separation one
        # level up: a gang holds ONE slice, never spans two).  None =
        # the classic single-mesh mode — one implicit slice named
        # "mesh", every row byte-identical to the pre-slice scheduler.
        if slices is not None:
            if not slices:
                raise ValueError("slices must name at least one slice")
            for name, cap in slices.items():
                if not name or not isinstance(name, str):
                    raise ValueError(f"slice name {name!r} must be a "
                                     f"non-empty string")
                if not isinstance(cap, int) or cap < 1:
                    raise ValueError(f"slice {name}: capacity {cap!r} "
                                     f"must be an int >= 1")
            self.slices = dict(slices)
            devices = sum(self.slices.values())
        else:
            if devices < 1:
                raise ValueError(f"devices {devices} must be >= 1")
            self.slices = {"mesh": devices}
        self._multi = slices is not None
        self.devices = devices
        # The fitted collective model (load_collective_fit) pricing a
        # cross-slice eviction: the victim's snapshot state may have to
        # move slices on relaunch, t(S) = alpha + S/beta per rank.
        self.collective_fit = collective_fit
        # The spawn seam: a simulator injects a factory returning
        # simulated gangs with the FleetSupervisor run/stop/ranks
        # surface; the DECISION code below stays identical either way.
        self.fleet_factory = fleet_factory or FleetSupervisor
        self.workdir = os.path.abspath(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.journal = journal or Journal(
            os.path.join(self.workdir, "sched.jsonl"))
        # None = the workdir default (one RUNS.jsonl holding the whole
        # queue: sched rows + every gang's and rank's own rows); "" =
        # no ledger.  Same convention as the fleet.
        self.ledger_path = (os.path.join(self.workdir, "RUNS.jsonl")
                            if ledger_path is None else ledger_path)
        self.tick_s = tick_default() if tick_s is None else tick_s
        self.poll_s = poll_s
        self.seed = seed
        self.cost_margin = cost_margin
        self.max_job_s = max_job_s
        self.trajectory_path = trajectory_path
        self.retry_policy = retry_policy or RetryPolicy(
            retries=10**6,      # the per-job budget gates, not this
            backoff_base_s=0.25, backoff_max_s=10.0)
        import random as _random
        self._rng = _random.Random(seed)
        self._slo = slo_priorities()
        self._seq = 0
        self._submitted: set[str] = set()
        self._jobs: dict[str, _JobState] = {}
        for i, job in enumerate(jobs):
            if job.job in self._jobs:
                raise ValueError(f"duplicate job id {job.job!r}")
            self._jobs[job.job] = _JobState(
                job=job, priority=job.resolved_priority(self._slo),
                submit_idx=i)
        # Anomaly detections feed
        # eviction policy — a straggling job yields its devices to
        # queued healthy work (resilience/remediate.py; flap/cooldown/
        # budget guardrails + HEAL_DRY_RUN apply, and the heal_* rows
        # land in the same ledger the sched_* rows do).  The policy
        # engine shares this scheduler's journal: its WAL replays with
        # ours, and _replay ignores the heal_* rows it doesn't own.
        # Constructed AFTER _jobs: construction replays unmatched
        # heal_intents through _heal_evict, which reads _jobs (every
        # job is still "queued" here, so the replay resolves to the
        # documented idempotent noop, not an AttributeError row).
        self._remediator = heal_mod.Remediator(
            journal=self.journal, ledger_path=self.ledger_path or "",
            actuators={"evict": self._heal_evict},
            policy={"straggler": heal_mod.HealRule("evict")},
        ) if heal else None

    # --- journal + ledger plumbing ----------------------------------------
    def _wal(self, event: str, **fields) -> None:
        self.journal.write(event, **fields)
        die = os.environ.get("SCHED_DRILL_DIE_AT", "")
        if die:
            token = (f"{event}:{fields.get('action', '')}:"
                     f"{fields.get('job', '')}")
            if die in token:
                # The crash drill: die IMMEDIATELY after committing this
                # record — mid-decision, exactly between intent and
                # effect.  SIGKILL, not raise: no atexit, no cleanup,
                # like the real OOM-killer/power-loss shape.
                _log(f"SCHED_DRILL_DIE_AT={die}: dying after {token}")
                os.kill(os.getpid(), signal.SIGKILL)

    def _ledger(self, event: str, **fields) -> None:
        if self.ledger_path:
            obs_ledger.log_event(event, path=self.ledger_path,
                                 src="sched", **fields)

    def _intent(self, action: str, job: str | None, **fields) -> int:
        """Write-ahead half of a mutating decision (the fleet's
        ``resume_agreement`` pattern): the intent commits to the journal
        BEFORE the side effect, so a scheduler death in between leaves
        a record the restarted incarnation replays."""
        self._seq += 1
        self._wal("sched_intent", action=action, job=job, seq=self._seq,
                  **fields)
        return self._seq

    def _applied(self, seq: int | None, action: str, job: str | None,
                 **fields) -> None:
        """Completion half: the journal's applied record (matching the
        intent's seq) plus the ledger's queryable sched_* row."""
        _DECISIONS.labels(action=action).inc()
        self._wal(f"sched_{action}", job=job, seq=seq, **fields)
        self._ledger(f"sched_{action}", job=job, **fields)

    def _observe(self, event: str, job: str | None, **fields) -> None:
        """A decision the WORLD made (shrink; the fleet's own internal
        grow): recorded, not intended — there is no side effect to
        replay."""
        _DECISIONS.labels(action=event.removeprefix("sched_")).inc()
        self._wal(event, job=job, **fields)
        self._ledger(event, job=job, **fields)

    # --- replay (crash tolerance) -----------------------------------------
    def _replay(self) -> None:
        """Fold the journal back into job states: terminal decisions
        stick, retry counters restore, everything else requeues.  An
        INTENT with no applied record is a decision the dead scheduler
        committed to but never finished — terminal ones are re-applied
        here (idempotently), placement/eviction ones need no re-apply
        beyond the orphan sweep (the job requeues and relaunches
        through the normal path)."""
        intents: dict[int, dict] = {}
        for rec in self.journal.events():
            ev = rec.get("event", "")
            if not ev.startswith("sched_"):
                continue
            seq = rec.get("seq")
            if isinstance(seq, int):
                self._seq = max(self._seq, seq)
            if ev == "sched_intent":
                intents[seq] = rec
                continue
            if isinstance(seq, int):
                intents.pop(seq, None)
            if ev == "sched_submit":
                self._submitted.add(rec.get("job") or "")
            st = self._jobs.get(rec.get("job") or "")
            if st is None:
                continue
            if ev == "sched_done":
                st.state = "done"
            elif ev == "sched_quarantine":
                st.state = "quarantined"
            elif ev == "sched_fail":
                st.state = "failed"
            elif ev == "sched_refuse":
                st.state = "refused"
            elif ev == "sched_retry":
                st.retries_used = int(rec.get("retry") or 0)
            elif ev == "sched_evict":
                st.preemptions += 1
            elif ev == "sched_shrink":
                st.shrinks += 1
            elif ev == "sched_grow":
                st.grows += 1
            elif ev == "sched_place":
                # A placed job left snapshots behind: its relaunch must
                # run the resume agreement (agree_first) — and must not
                # reuse the dead placement's stdout dir.
                st.ran = True
                st.launches = max(st.launches,
                                  int(rec.get("attempt") or 0))
        for seq in sorted(intents):
            rec = intents[seq]
            action, job_id = rec.get("action"), rec.get("job")
            st = self._jobs.get(job_id or "")
            if action in ("done", "quarantine", "fail", "refuse") \
                    and st is not None:
                # Terminal decision committed but unapplied: finish it.
                st.state = {"done": "done", "quarantine": "quarantined",
                            "fail": "failed", "refuse": "refused"}[action]
                self._applied(seq, action, job_id, replayed=True,
                              **{k: v for k, v in rec.items()
                                 if k not in ("ts", "event", "action",
                                              "job", "seq")})
            elif action == "retry" and st is not None:
                st.retries_used = max(st.retries_used,
                                      int(rec.get("retry") or 0))
                self._applied(seq, action, job_id, replayed=True,
                              retry=st.retries_used)
            else:
                # place/evict/grow: the gang (victim or launch) died
                # with the scheduler; the orphan sweep below clears the
                # mesh and the job relaunches through the normal path.
                if action == "place" and st is not None:
                    # The spawn may have happened before the death —
                    # treat the placement as real (resume + fresh
                    # stdout dir), same as an applied place row.
                    st.ran = True
                    st.launches = max(st.launches,
                                      int(rec.get("attempt") or 0))
                self._applied(seq, "intent_dropped", job_id,
                              replayed=True, dropped=action)
        # Sweep gangs orphaned by the dead incarnation BEFORE anything
        # relaunches over their snapshot stores.
        for st in self._jobs.values():
            if st.state not in TERMINAL:
                self._sweep_orphans(st.job.job)

    def _job_dir(self, job_id: str) -> str:
        return os.path.join(self.workdir, "jobs", job_id)

    def _sweep_orphans(self, job_id: str) -> None:
        """Kill rank process groups a DEAD scheduler incarnation left
        running: every ``rank_spawn`` pid in the job's fleet journal
        with no matching ``rank_exit`` may still be alive (ranks live in
        their own sessions — they survive their supervisor).  Two gangs
        of one job writing the same store concurrently is the
        corruption this sweep exists to prevent.  Pid-reuse is the
        accepted residual risk: these pids come from THIS queue's own
        journal, and a vanished pid is simply skipped."""
        jp = os.path.join(self._job_dir(job_id), "fleet.jsonl")
        if not os.path.exists(jp):
            return
        spawned: dict[tuple, int] = {}
        intents: set[tuple] = set()
        for rec in Journal(jp).events():
            key = (rec.get("task"), rec.get("attempt"), rec.get("rank"))
            if rec.get("event") == "rank_spawn_intent":
                intents.add(key)
            elif rec.get("event") == "rank_spawn":
                spawned[key] = rec.get("pid")
                intents.discard(key)
            elif rec.get("event") == "rank_exit":
                spawned.pop(key, None)
                intents.discard(key)
            elif rec.get("event") == "rank_lost":
                # Popen itself raised (the genuine dead-host path): no
                # process ever existed, so the dangling intent must not
                # read as a maybe-orphan forever after.
                intents.discard(key)
        for key in sorted(intents, key=str):
            # Spawn intent with no pid row: the dead incarnation was
            # killed inside the spawn itself — an orphan MAY exist that
            # this sweep cannot address.  Loud, not silent.
            _log(f"{job_id}: spawn intent {key} has no recorded pid — "
                 f"an unswept orphan may exist; check `ps` before "
                 f"trusting this job's store")
        # TERM every orphan group first, then ONE shared grace window,
        # then KILL the stragglers — the fleet teardown's shape ("N
        # ranks pay one grace, not N"): a multi-gang sweep must not
        # serialize 5 s of grace per pid into a minute of startup.
        live: list[tuple[tuple, int]] = []
        for (task, attempt, rank), pid in sorted(spawned.items()):
            if not isinstance(pid, int):
                continue
            try:
                os.killpg(pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                continue
            live.append(((task, attempt, rank), pid))
            self._observe("sched_orphan_killed", job_id, rank=rank,
                          attempt=attempt, pid=pid)
            _log(f"{job_id}: swept orphaned rank {rank} group (pid "
                 f"{pid}) from a dead scheduler incarnation")
        # TERM first (lets a live trainer save); escalate after the
        # shared grace — the relaunch must not race a dying writer.
        deadline = obs_metrics._now() + 5.0
        while live and obs_metrics._now() < deadline:
            still = []
            for key, pid in live:
                try:
                    os.killpg(pid, 0)
                    still.append((key, pid))
                except ProcessLookupError:
                    continue
            live = still
            if live:
                _sleep(0.05)
        for _, pid in live:
            try:
                os.killpg(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass

    # --- admission + placement --------------------------------------------
    def _admit(self, st: _JobState) -> bool:
        """First time a job comes up for placement: price it (measured
        trajectory first, declared estimate second) and either admit —
        the sched_admit row carries the prediction — or refuse
        (unplaceable width / over the per-job cost ceiling)."""
        job = st.job
        cost = predict_cost(job, self.trajectory_path)
        widest = max(self.slices.values())
        if job.ranks > widest:
            seq = self._intent("refuse", job.job)
            st.state = "refused"
            if self._multi:
                # A gang holds ONE slice: wider than the widest slice
                # is unplaceable even with the whole fleet idle.
                st.why_last = (f"needs {job.ranks} device(s), widest "
                               f"slice has {widest} "
                               f"(slices: {self.slices})")
                self._applied(seq, "refuse", job.job, why=st.why_last,
                              ranks=job.ranks, devices=self.devices,
                              slices=dict(self.slices))
            else:
                st.why_last = (f"needs {job.ranks} device(s), mesh has "
                               f"{self.devices}")
                self._applied(seq, "refuse", job.job, why=st.why_last,
                              ranks=job.ranks, devices=self.devices)
            return False
        if self.max_job_s and cost["predicted_s"] \
                and cost["predicted_s"] > self.max_job_s:
            seq = self._intent("refuse", job.job)
            st.state = "refused"
            st.why_last = (f"predicted {cost['predicted_s']:g}s "
                           f"({cost['source']}) exceeds the per-job "
                           f"ceiling {self.max_job_s:g}s")
            self._applied(seq, "refuse", job.job, why=st.why_last,
                          **cost)
            return False
        st.admitted = True
        st.cost = cost
        self._applied(None, "admit", job.job, priority=st.priority,
                      ranks=job.ranks, **cost)
        return True

    def _wall_timeout(self, st: _JobState) -> float:
        if st.job.wall_timeout_s:
            return st.job.wall_timeout_s
        if st.cost.get("predicted_s"):
            return self.cost_margin * st.cost["predicted_s"]
        return 0.0

    def _launch(self, st: _JobState, free: int,
                slice_name: str = "mesh") -> None:
        job = st.job
        st.launches += 1
        seq = self._intent("place", job.job, ranks=job.ranks,
                           attempt=st.launches,
                           **({"slice": slice_name} if self._multi
                              else {}))
        jdir = self._job_dir(job.job)
        fleet = self.fleet_factory(
            job.ranks,
            policy=RetryPolicy(retries=job.fleet_retries,
                               backoff_base_s=0.05, backoff_max_s=0.5),
            journal=Journal(os.path.join(jdir, "fleet.jsonl")),
            heartbeat_timeout_s=job.heartbeat_timeout_s,
            wall_timeout_s=self._wall_timeout(st),
            kill_grace_s=job.kill_grace_s,
            poll_s=self.poll_s,
            seed=self.seed,
            elastic=job.elastic,
            worker_tiled=job.worker_tiled,
            workdir=os.path.join(jdir, "fleet"),
            ledger_path=self.ledger_path or "",
            # The fleet must not regrow itself mid-placement: a
            # recovered rank consumes a mesh device the scheduler may
            # have backfilled — only _drive_grow's capacity-gated
            # stop-and-relaunch may widen the gang.
            reprobe_on_relaunch=False)
        st.fleet = fleet
        st.state = "running"
        st.width = job.ranks
        st.slice_name = slice_name
        st.stop = None
        st.result = []
        resumed = st.ran

        def _run():
            try:
                st.result.append(fleet.run(
                    list(job.argv), name=job.job,
                    snapshot_dir_template=job.snapshots,
                    # per-placement stdout: a relaunch restarts the
                    # fleet's attempt numbering at 0, and the resumed
                    # run must not clobber the evicted placement's
                    # JSON tail (both are evidence).
                    stdout_dir=os.path.join(jdir, "out",
                                            f"place{st.launches}"),
                    env_extra=dict(job.env) or None,
                    # A relaunch resumes over stores a PREVIOUS fleet
                    # wrote; the agreement must run before the first
                    # gang too, or each rank restores its own newest.
                    agree_first=resumed))
            except BaseException as e:       # noqa: BLE001 — reap sorts it
                st.result.append(e)

        st.thread = threading.Thread(target=_run, daemon=True,
                                     name=f"sched-{job.job}")
        st.thread.start()
        self._applied(seq, "place", job.job, ranks=job.ranks,
                      attempt=st.launches, resumed=resumed,
                      free_before=free, devices=self.devices,
                      wall_timeout_s=round(self._wall_timeout(st), 3)
                      or None,
                      **({"slice": slice_name} if self._multi else {}),
                      **st.cost)
        where = (f"slice {slice_name}" if self._multi
                 else f"{job.ranks}/{self.devices} device(s)")
        _log(f"{job.job}: placed on {where} "
             f"(attempt {st.launches}"
             + (f", resuming" if resumed else "") + ")")

    # --- the policy tick ---------------------------------------------------
    def _running(self) -> list[_JobState]:
        return [s for s in self._jobs.values() if s.state == "running"]

    def _free(self) -> int:
        return self.devices - sum(s.width for s in self._running())

    def _slice_free(self) -> dict[str, int]:
        """Free devices per slice (single-mesh mode: one entry)."""
        free = dict(self.slices)
        for s in self._running():
            if s.slice_name in free:
                free[s.slice_name] -= s.width
        return free

    def _pick_slice(self, ranks: int, frees: dict[str, int]) -> str | None:
        """Best-fit packing: the slice with the LEAST free capacity
        that still fits ``ranks`` — wide future jobs keep a wide slice
        open instead of every slice fragmenting a little.  Name-sorted
        tie-break keeps placement deterministic."""
        fits = [(free, name) for name, free in sorted(frees.items())
                if free >= ranks]
        return min(fits)[1] if fits else None

    def _migrate_price_s(self, st: _JobState) -> float | None:
        """What evicting ``st`` may cost in collective-model time: its
        per-rank snapshot state crossing slices on relaunch, priced at
        the fitted ``t(S) = alpha + S/beta`` per rank.  None = unpriced
        (no fit, or the job declares no state)."""
        fit = self.collective_fit
        if not fit or not st.job.state_bytes:
            return None
        t = (fit["alpha_s"]
             + st.job.state_bytes / fit["beta_bytes_per_s"])
        return round(t * max(1, st.width or st.job.ranks), 6)

    def _reap(self) -> None:
        for st in self._running():
            if st.thread is None or st.thread.is_alive():
                continue
            st.thread.join()
            res = st.result[-1] if st.result else None
            stop = st.stop
            st.thread = None
            st.fleet = None
            st.ran = True
            if isinstance(res, GangResult):
                self._classify(st, res, stop)
                continue
            if stop is not None and stop[1] is not None:
                # The gang died of its own cause (exception) while a
                # stop was pending: the stop decision is moot, but its
                # intent must still resolve or the WAL never balances.
                self._wal("sched_stop_superseded", job=st.job.job,
                          seq=stop[1], reason=stop[0],
                          outcome="exception")
            if isinstance(res, RankLostError):
                # Non-elastic (or worker-tiled) job on a dead host:
                # retrying is still meaningful — the host may answer
                # again within the backoff — but it is budgeted.
                self._retry_or_fail(st, f"rank {res.rank} lost: "
                                        f"{res.cause}")
            else:
                self._retry_or_fail(st, f"fleet thread died: {res!r}")

    def _classify(self, st: _JobState, res: GangResult,
                  stop: tuple | None) -> None:
        job = st.job
        rcs = {str(r): rc for r, rc in sorted(res.last_rcs.items())}
        clean = bool(res.last_rcs) and all(
            rc in (0, RC_PREEMPTED) for rc in res.last_rcs.values())
        if stop is not None and res.status != "evicted" \
                and stop[1] is not None:
            # A stop was requested but the gang ended on its own terms
            # first (finished, crashed, wedged) — the decision is moot;
            # resolve its intent so the WAL balances.
            self._wal("sched_stop_superseded", job=job.job, seq=stop[1],
                      reason=stop[0], outcome=res.status)
        if res.status == "ok":
            seq = self._intent("done", job.job)
            st.state = "done"
            st.width = 0
            st.why_last = ""        # a retried-then-done job is done
            self._applied(seq, "done", job.job, rcs=rcs,
                          gang_attempts=res.gang_attempts,
                          restarts=res.restarts,
                          preempt_resumes=st.preemptions,
                          ranks=res.ranks)
            _log(f"{job.job}: done (gang_attempts={res.gang_attempts}, "
                 f"restarts={res.restarts})")
            return
        if res.status == "evicted" and stop is not None:
            reason, seq, detail = stop
            st.width = 0
            st.state = "queued"
            st.not_before = 0.0
            if reason == "grow":
                st.grows += 1
                self._applied(seq, "grow", job.job, recovered=detail,
                              rcs=rcs, clean=clean)
                _log(f"{job.job}: stopped cleanly to grow back to "
                     f"{job.ranks} rank(s) (recovered {detail})")
            elif reason == "evicted":
                st.preemptions += 1
                for_job, why = detail
                extra = ({"slice": st.slice_name} if self._multi
                         else {})
                price = (self._migrate_price_s(st) if self._multi
                         else None)
                if price is not None:
                    extra["price_s"] = price
                self._applied(seq, "evict", job.job, for_job=for_job,
                              why=why, rcs=rcs, clean=clean, **extra)
                _log(f"{job.job}: evicted ({why}); requeued — "
                     f"preemptions are not charged to the retry budget")
            # scheduler_terminated: queued for the next incarnation,
            # no decision row — the shutdown is the decision.
            return
        if res.status in ("evicted", "terminated"):
            # The scheduler itself is going down (SIGTERM) — leave the
            # job queued for the next incarnation; no decision row.
            st.width = 0
            st.state = "queued"
            return
        if res.status == "wedged":
            seq = self._intent("quarantine", job.job)
            st.state = "quarantined"
            st.width = 0
            st.why_last = ("a rank reported the backend provably "
                           "wedged (rc 3) — requeueing would burn the "
                           "window against a dead device")
            self._applied(seq, "quarantine", job.job, rcs=rcs,
                          why=st.why_last)
            _log(f"{job.job}: QUARANTINED (rc 3)")
            return
        # exhausted (or any unknown outcome): budgeted retry.
        self._retry_or_fail(
            st, f"gang {res.status} after {res.gang_attempts} "
                f"attempt(s) (rcs {rcs})")

    def _retry_or_fail(self, st: _JobState, why: str) -> None:
        job = st.job
        st.width = 0
        st.retries_used += 1
        st.why_last = why
        if st.retries_used > job.retries:
            seq = self._intent("fail", job.job)
            st.state = "failed"
            self._applied(seq, "fail", job.job, why=why,
                          retries=st.retries_used - 1)
            _log(f"{job.job}: FAILED ({why}); retry budget "
                 f"{job.retries} exhausted")
            return
        delay = self.retry_policy.delay_s(st.retries_used - 1,
                                          self._rng.random())
        st.state = "queued"
        st.not_before = obs_metrics._now() + delay
        seq = self._intent("retry", job.job, retry=st.retries_used)
        self._applied(seq, "retry", job.job, retry=st.retries_used,
                      of=job.retries, backoff_s=round(delay, 3), why=why)
        _log(f"{job.job}: retry {st.retries_used}/{job.retries} in "
             f"{delay:.2f}s ({why})")

    def _observe_running(self) -> None:
        """Width observations: an elastic gang that shrank (rank lost
        mid-placement) or grew back through the fleet's OWN re-probe
        changes the mesh occupancy the packer plans against — and both
        are ledger rows, because 'why is this job half-width' must be
        answerable later."""
        for st in self._running():
            fleet = st.fleet
            if fleet is None:
                continue
            cur = len(fleet.ranks)
            if cur < st.width:
                st.shrinks += 1
                self._observe("sched_shrink", st.job.job, ranks=cur,
                              was=st.width, lost=fleet.lost_ranks)
                _log(f"{st.job.job}: elastic shrink to {cur} rank(s) "
                     f"(lost {fleet.lost_ranks})")
                st.width = cur
            elif cur > st.width and st.width:
                st.grows += 1
                self._observe("sched_grow", st.job.job, ranks=cur,
                              was=st.width, internal=True)
                st.width = cur

    def _drive_grow(self) -> None:
        """Grow-on-recovery as scheduler policy: a running-shrunken
        elastic job whose lost rank answers the recovery probe is
        cleanly stopped (TERM→143→snapshot) and requeued, so its next
        placement relaunches at FULL width — gated on the mesh having
        room for the regrown gang."""
        # Count every job with a PENDING grow-stop at its full relaunch
        # width, not its current width: the reservation must survive
        # across ticks while the stopped gang drains, or a second
        # shrunken job recovering one tick later double-books the same
        # devices — giving up its working gang for capacity that was
        # never there.  (Multi-slice: the relaunch may land on ANY
        # slice, so the gate is "some slice fits the full width once
        # this gang's devices return", with the pending reservations
        # held against it conservatively.)
        frees = self._slice_free()
        reserved = sum(
            s.job.ranks - s.width for s in self._running()
            if s.stop is not None and s.stop[0] == "grow")
        for st in self._running():
            fleet = st.fleet
            if (fleet is None or st.stop is not None
                    or not st.job.elastic or not fleet.lost_ranks):
                continue
            recovered = fleet.probe_lost_ranks(list(st.job.argv))
            if not recovered:
                continue
            roomiest = max(
                frees.get(name, 0)
                + (st.width if name == st.slice_name else 0)
                for name in self.slices)
            if roomiest - reserved < st.job.ranks:
                continue        # no room for the regrown width yet
            reserved += st.job.ranks - st.width
            seq = self._intent("grow", st.job.job, recovered=recovered)
            st.stop = ("grow", seq, recovered)
            fleet.request_stop("grow")

    def _drive_heal(self) -> None:
        """Anomaly-driven eviction policy: each tick, a running job
        whose monitor pass has NAMED a straggler (lag + slowness
        evidence, never lag alone — obs/anomaly.detect_skew's bar)
        feeds the remediation engine; after the flap/cooldown
        guardrails clear, the job is evicted loss-free (TERM→143→
        snapshot→requeue) so its devices go to queued healthy work and
        its own relaunch sheds the transient slowdown.  Detection-only
        when nothing is queued — evicting a straggler with no
        beneficiary buys nothing but churn (the actuator answers
        ``noop`` and no budget is spent)."""
        if self._remediator is None:
            return
        waiting = [s for s in self._jobs.values() if s.state == "queued"]
        for st in self._running():
            fleet = st.fleet
            if fleet is None or st.stop is not None:
                continue
            for r in fleet.stragglers:
                # Keyed per PLACEMENT (launches): a second straggler
                # episode of the same (job, rank) after an eviction +
                # relaunch is a fresh anomaly and gets its own
                # heal_detect row; within one placement, re-observed
                # polls dedup as one detection.  The guardrail key
                # (kind, job) is launch-free, so cooldown still spans
                # relaunches — no evict storm.
                self._remediator.observe(heal_mod.AnomalyEvent(
                    kind="straggler",
                    key=f"{st.job.job}:l{st.launches}:straggler:rank{r}",
                    scope=st.job.job, rank=r, source="fleet",
                    detail={"waiting": [w.job.job for w in waiting]}))

    def _heal_evict(self, ev: heal_mod.AnomalyEvent) -> dict:
        """The straggler-eviction actuator: routed through the normal
        sched WAL (intent → request_stop → the reap's sched_evict row),
        so the eviction story reads identically to an SLO preemption —
        plus the heal_* rows naming the anomaly that caused it."""
        st = self._jobs.get(ev.scope or "")
        if st is None or st.state != "running" or st.fleet is None \
                or st.stop is not None:
            return {"noop": "job not running (or a stop is already "
                            "pending)"}
        waiting = sorted(
            (s for s in self._jobs.values() if s.state == "queued"),
            key=lambda s: (s.priority, s.submit_idx))
        if not waiting:
            return {"noop": "no queued job waiting for capacity"}
        # The eviction must have a beneficiary that can actually PLACE
        # in what it frees (plus what is already free) — evicting a
        # straggler for a head job still too wide to fit is pure
        # evict-relaunch churn, burning the action budget and the
        # victim's wall time with zero queued work served.  Multi-
        # slice: the beneficiary may land on the victim's slice (its
        # free + the victim's width) or any other slice's own free.
        frees = self._slice_free()
        fits = max(frees.get(st.slice_name, 0) + st.width,
                   max(frees.values()))
        head = next((w for w in waiting if w.job.ranks <= fits), None)
        if head is None:
            return {"noop": f"no queued job fits the {fits} device(s) "
                            f"this eviction would make available"}
        stragglers = st.fleet.stragglers
        why = (f"rank(s) {stragglers} named straggler by the anomaly "
               f"monitor — yielding {st.width} device(s) to queued job "
               f"`{head.job.job}` (anomaly-driven heal policy)")
        seq = self._intent("evict", st.job.job, for_job=head.job.job,
                           heal=True)
        st.stop = ("evicted", seq, (head.job.job, why))
        st.fleet.request_stop("heal_evict")
        _log(f"{st.job.job}: requesting clean stop — {why}")
        return {"for_job": head.job.job, "stragglers": stragglers}

    def _evict_plan(self, head: _JobState, slice_name: str,
                    free: int) -> tuple | None:
        """One slice's eviction plan for ``head``: the strictly-less-
        urgent victims (least urgent first, youngest first among
        equals) whose widths cover the shortfall, plus the plan's
        cross-slice migration price (sum of the victims' fitted
        collective-model costs; unpriced victims count separately so a
        zero price is never confused with an unknown one).  None = the
        slice cannot be cleared for ``head`` at all."""
        need = head.job.ranks - free
        victims = sorted(
            (s for s in self._running()
             if s.stop is None and s.priority > head.priority
             and s.slice_name == slice_name),
            key=lambda s: (-s.priority, -s.submit_idx))
        chosen: list[_JobState] = []
        for v in victims:
            if need <= 0:
                break
            chosen.append(v)
            need -= v.width
        if need > 0:
            return None
        prices = [self._migrate_price_s(v) for v in chosen]
        priced = round(sum(p for p in prices if p), 6)
        unpriced = sum(1 for p in prices if p is None)
        return (priced, unpriced, len(chosen), slice_name, chosen)

    def _evict_for(self, head: _JobState,
                   frees: dict[str, int]) -> bool:
        """SLO preemption: free enough devices for ``head`` by cleanly
        stopping strictly-less-urgent running jobs in ONE slice —
        cheapest clearable slice first, priced by the fitted collective
        model (a victim with snapshot state pays its possible
        cross-slice move).  Returns whether enough capacity is (or will
        shortly be) freed."""
        plans = [p for p in (
            self._evict_plan(head, name, frees[name])
            for name in sorted(self.slices)
            if self.slices[name] >= head.job.ranks) if p is not None]
        if not plans:
            return False
        priced, unpriced, nvict, slice_name, chosen = min(
            plans, key=lambda p: p[:4])
        free = frees[slice_name]
        for v in chosen:
            why = (f"evicted for higher-priority job `{head.job.job}` "
                   f"(priority {head.priority} {head.job.kind} vs "
                   f"{v.priority} {v.job.kind}; it needs "
                   f"{head.job.ranks} device(s), {free} free"
                   + (f" in slice {slice_name}" if self._multi else "")
                   + ")")
            extra = {}
            if self._multi:
                extra["slice"] = slice_name
                price = self._migrate_price_s(v)
                if price is not None:
                    extra["price_s"] = price
            seq = self._intent("evict", v.job.job,
                               for_job=head.job.job, **extra)
            v.stop = ("evicted", seq, (head.job.job, why))
            v.fleet.request_stop("evicted")
            _log(f"{v.job.job}: requesting clean stop — {why}")
        return True

    def _tick(self, t0: float) -> None:
        self._reap()
        self._observe_running()
        self._drive_grow()
        self._drive_heal()
        now = obs_metrics._now()
        frees = self._slice_free()
        _DEVICES_BUSY.set(self.devices - sum(frees.values()))
        ready = [s for s in self._jobs.values()
                 if s.state == "queued" and now >= s.not_before
                 and now - t0 >= s.job.start_after_s
                 and (not s.job.after_file
                      or os.path.exists(s.job.after_file))]
        _QUEUE_DEPTH.set(len([s for s in self._jobs.values()
                              if s.state == "queued"]))
        ready.sort(key=lambda s: (s.priority, s.submit_idx))
        evicting = any(s.stop is not None for s in self._running())
        for st in ready:
            if not st.admitted and not self._admit(st):
                continue
            slice_name = self._pick_slice(st.job.ranks, frees)
            if slice_name is not None:
                self._launch(st, frees[slice_name], slice_name)
                frees[slice_name] -= st.job.ranks
            else:
                if not evicting:
                    self._evict_for(st, frees)
                # Head-of-priority capacity blocking: once the most
                # urgent ready job cannot be placed, nothing less
                # urgent may admit this tick.  Backfilling a just-freed
                # device with a lower-priority job is a LIVELOCK when
                # that job is the eviction's own victim: requeued →
                # backfilled → evicted again, forever (observed in the
                # first demo run — victims reap on different ticks, so
                # the waiting job sees partial capacity while its
                # victims relaunch into the rest).
                break

    def _fail_dead_gates(self) -> None:
        """Liveness backstop: when nothing is running, every remaining
        queued job waits on an ``after_file`` that does not exist, and
        no other job is left to produce it, the queue would tick
        forever — fail the gated jobs with a why instead of spinning.
        Time-bound gates (backoff, start_after_s) resolve on their own
        and never trip this."""
        queued = [s for s in self._jobs.values() if s.state == "queued"]
        if not queued or self._running():
            return
        if any(not s.job.after_file or os.path.exists(s.job.after_file)
               for s in queued):
            return
        for st in queued:
            seq = self._intent("fail", st.job.job)
            st.state = "failed"
            st.why_last = (
                f"after_file gate {st.job.after_file!r} can no longer "
                f"be satisfied: nothing is running and every other job "
                f"is terminal — the queue would wait forever")
            self._applied(seq, "fail", st.job.job, why=st.why_last,
                          retries=st.retries_used)
            _log(f"{st.job.job}: FAILED — {st.why_last}")

    # --- the queue loop ----------------------------------------------------
    def run(self) -> dict:
        """Drive the queue to quiescence: every job in a terminal state
        (done / failed / quarantined / refused).  Returns the summary
        dict ``tools.schedule`` renders and records.  SIGTERM stops the
        scheduler cleanly: running gangs are evicted (they save), queued
        jobs stay queued, and a rerun of the same command resumes from
        the journal."""
        t0 = obs_metrics._now()
        self._replay()
        for st in sorted(self._jobs.values(), key=lambda s: s.submit_idx):
            if st.job.job not in self._submitted:
                self._wal("sched_submit", job=st.job.job,
                          kind=st.job.kind, priority=st.priority,
                          ranks=st.job.ranks, argv=list(st.job.argv),
                          retries=st.job.retries)
                self._ledger("sched_submit", job=st.job.job,
                             kind=st.job.kind, priority=st.priority,
                             ranks=st.job.ranks, retries=st.job.retries)
                self._submitted.add(st.job.job)
        status = "ok"
        with sigterm_flag() as term:
            while any(s.state not in TERMINAL
                      for s in self._jobs.values()):
                if term:
                    status = "terminated"
                    self._shutdown()
                    break
                self._tick(t0)
                self._fail_dead_gates()
                _sleep(self.tick_s)
            else:
                self._reap()
        return self._summary(status, obs_metrics._now() - t0)

    def _shutdown(self) -> None:
        for st in self._running():
            if st.fleet is not None:
                st.stop = ("scheduler_terminated", None, None)
                st.fleet.request_stop("scheduler_terminated")
        deadline = obs_metrics._now() + 30.0
        while self._running() and obs_metrics._now() < deadline:
            self._reap()
            _sleep(self.poll_s)
        _log("terminated — running gangs stopped cleanly; rerun the "
             "same command to resume the queue from the journal")

    def _summary(self, status: str, makespan_s: float) -> dict:
        states = {jid: st.state for jid, st in self._jobs.items()}
        counts = {s: sum(1 for v in states.values() if v == s)
                  for s in TERMINAL + ("queued", "running")}
        evictions = sum(st.preemptions for st in self._jobs.values())
        shrinks = sum(st.shrinks for st in self._jobs.values())
        grows = sum(st.grows for st in self._jobs.values())
        retries = sum(st.retries_used for st in self._jobs.values())
        if status == "ok" and (counts["failed"] or counts["quarantined"]):
            status = "degraded"
        summary = {
            "status": status, "jobs": states, "counts": counts,
            "devices": self.devices,
            **({"slices": dict(self.slices)} if self._multi else {}),
            "makespan_s": round(makespan_s, 3),
            "evictions": evictions, "shrinks": shrinks, "grows": grows,
            "retries": retries,
            "why": {jid: st.why_last for jid, st in self._jobs.items()
                    if st.why_last}}
        if status != "terminated":
            self._wal("sched_queue_done", status=status, **{
                k: summary[k] for k in ("counts", "makespan_s",
                                        "evictions", "shrinks", "grows",
                                        "retries")})
            self._ledger("sched_queue_done", job=None, status=status,
                         jobs=states, **{
                             k: summary[k]
                             for k in ("counts", "makespan_s",
                                       "evictions", "shrinks", "grows",
                                       "retries")})
        return summary


def load_queue(path: str) -> list[Job]:
    """Parse a queue file: either ``{"jobs": [...]}`` or a bare JSON
    list of job dicts (see :class:`Job` for the fields)."""
    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, dict):
        payload = payload.get("jobs", [])
    if not isinstance(payload, list):
        raise ValueError(f"queue file {path}: expected a list of jobs "
                         f"(or {{'jobs': [...]}})")
    return [Job.from_dict(rec) for rec in payload]
