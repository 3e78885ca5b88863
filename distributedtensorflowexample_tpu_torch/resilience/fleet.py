# graftlint: stdlib-only
"""Gang supervision: fleet-level fault tolerance for multi-process runs
(the JAX package's ``resilience/fleet.py``; pure Python over the port's
``cluster.tf_config_env``, ``resilience/snapshot.py`` and ``obs/``, with
the same journal records, so a fleet journal reads the same in both
packages).

The single-child supervisor (resilience/supervisor.py) restarts ONE
process; the paper's whole subject is a cluster of them — PS/worker
``ClusterSpec`` processes whose failure TF-Replicator (arXiv:1902.00465)
and TensorFlow (arXiv:1605.08695) both treat as a CLUSTER-level event:
detect, tear down the gang, restart from a mutually consistent
checkpoint.  This module is that layer.

State machine (one "gang attempt" = one co-scheduled launch of all
surviving ranks)::

    launch gang (rank r: own process group; env: TF_CONFIG via
      cluster.tf_config_env, OBS_RANK=r, FLEET_NUM_RANKS,
      SUPERVISE_ATTEMPT=a, SUPERVISE_HEARTBEAT=<per-rank beat file>,
      FLEET_RESUME_STEP=<agreed step, once an agreement pass ran>)
      └─ monitor: per-rank exit | per-rank heartbeat age | wall clock
           ├─ all ranks rc 0            → ok
           ├─ all ranks rc ∈ {0, 143},
           │   some 143                 → clean preemption: gang
           │                              restarts NOW, exempt from the
           │                              retry budget (MAX_PREEMPTIONS
           │                              backstop only)
           ├─ any rank rc 3             → backend wedged → STOP
           ├─ any rank crashes/killed   → TEAR DOWN THE WHOLE GANG
           │                              (TERM-grace-KILL per process
           │                              group), budgeted gang restart
           ├─ a rank's heartbeat stale  → same teardown ("wedged rank")
           ├─ some ranks 143 but others
           │   still running past the
           │   preempt grace            → "preempt divergence": the gang
           │                              lost a member cleanly but NOT
           │                              unanimously — budgeted restart
           └─ spawn fails (OSError)     → rank permanently LOST: named
                                          error (see below), never a
                                          silent shrink

Resume-step agreement (the restart half): each rank snapshots
independently (resilience/snapshot.py), so after an unclean gang death
the per-rank newest steps diverge — the killed rank stopped at k, a
survivor ran to k+m before teardown, a torn final write fails
validation.  Before every relaunch the fleet reads every rank's
manifests, takes the **maximum common valid step**
(``snapshot.newest_common_step``), DISCARDS every newer snapshot on
every rank (``SnapshotStore.discard_newer`` — an abandoned timeline
must not poison the next recovery), and exports the agreed step as
``FLEET_RESUME_STEP`` to every child, so all ranks resume the same
global step and the resumed run is bitwise-identical to an
uninterrupted one.  No common step → ``FLEET_RESUME_STEP=0`` (fresh
start, all snapshots discarded).

Rank-loss taxonomy — a host that cannot be respawned degrades LOUDLY:

- :class:`RankLossStructurallyIllegal` when the run's state is
  worker-tiled (``sync_mode=async``): the state holds one part per
  worker (an async checkpoint is one file per rank), so
  restarting with fewer workers is not a degraded run, it is a
  DIFFERENT program.
- :class:`RankLossRefused` when fewer workers would be legal
  (sync-replicated state) but ``elastic`` was not requested: silently
  shrinking changes the global batch and the data order mid-training.
- with ``elastic=True`` (and replicated state) the fleet drops the
  lost rank, rebuilds TF_CONFIG from the survivors, and restarts the
  gang through the normal budgeted path.

Online health (obs/anomaly.py): each rank's AnomalyHook
writes a per-rank ``health.json`` (this fleet exports ``OBS_HEALTH``
per child); the monitor loop reads them on a ~0.5 s cadence, runs the
cross-rank skew/straggler pass (:func:`obs.anomaly.detect_skew`), and
surfaces detections as gauges (``fleet_rank_step``,
``fleet_step_skew_steps``), journal ``anomaly`` annotations, an
aggregate fleet ``health.json``, and a flight dump on a new straggler.
DETECTION ONLY — nothing it finds feeds the restart state machine.

Everything here is CPU-testable with real OS processes, no card
required; on a card every rank is its own CUDA process.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

from distributedtensorflowexample_tpu_torch.cluster import tf_config_env
from distributedtensorflowexample_tpu_torch.obs import anomaly as obs_anomaly
from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
from distributedtensorflowexample_tpu_torch.obs import metrics as obs_metrics
from distributedtensorflowexample_tpu_torch.obs import recorder as obs_recorder
from distributedtensorflowexample_tpu_torch.obs import trace as obs_trace
from distributedtensorflowexample_tpu_torch.resilience.supervisor import (
    MAX_PREEMPTIONS, RC_PREEMPTED, RC_WEDGED, Journal, RetryPolicy,
    Supervisor, export_prometheus_collector)
from distributedtensorflowexample_tpu_torch.utils.signals import (
    installed_signal_handler)


def _log(msg: str) -> None:
    print(f"fleet: {msg}", file=sys.stderr, flush=True)

# Fleet-level telemetry: the counters the ISSUE names, plus per-rank
# exit/heartbeat detail — what a fleet operator greps OBS_PROM_DIR for.
_GANG_RESTARTS = obs_metrics.counter(
    "fleet_gang_restarts_total",
    "whole-gang teardown+relaunch cycles (crash-budgeted and preempted)")
_RANKS_LOST = obs_metrics.counter(
    "fleet_ranks_lost_total", "ranks whose host could not be respawned")
_RANKS_RECOVERED = obs_metrics.counter(
    "fleet_ranks_recovered_total",
    "previously lost ranks re-added by a recovery re-probe")
_AGREEMENTS = obs_metrics.counter(
    "fleet_resume_step_agreements_total",
    "resume-step agreement passes run before a gang relaunch")
_RANK_EXITS = obs_metrics.counter(
    "fleet_rank_exits_total", "per-rank attempt outcomes, by rank and class")
_KILLS = obs_metrics.counter(
    "fleet_kills_total", "gang teardowns, by reason")
_HB_AGE = obs_metrics.gauge(
    "fleet_rank_heartbeat_age_seconds",
    "age of each live rank's newest heartbeat at the last poll")
_RANK_STEP = obs_metrics.gauge(
    "fleet_rank_step", "each rank's last health-reported step")
_SKEW = obs_metrics.gauge(
    "fleet_step_skew_steps",
    "max step lag between the front rank and the rest (health reports)")
_STRAGGLERS = obs_metrics.counter(
    "fleet_stragglers_detected_total",
    "straggler detections (lagging rank with slowness evidence), by rank")


class RankLostError(RuntimeError):
    """A rank's host is permanently gone (its respawn failed)."""

    def __init__(self, rank: int, attempt: int, cause: str, msg: str):
        self.rank = rank
        self.attempt = attempt
        self.cause = cause
        super().__init__(msg)


class RankLossStructurallyIllegal(RankLostError):
    """Fewer workers would change the STATE LAYOUT, not just the speed:
    async local-SGD state is worker-tiled (leading axis = num_workers —
    the same topology fact trainers/common.py refuses to restore across
    by name), so a shrunken gang cannot load any surviving snapshot."""

    def __init__(self, rank: int, attempt: int, cause: str):
        super().__init__(rank, attempt, cause, (
            f"rank {rank} permanently lost at gang attempt {attempt} "
            f"({cause}) and this run's state is worker-tiled "
            f"(sync_mode=async): the leading worker axis is structural "
            f"— restarting with fewer workers is ILLEGAL, not degraded "
            f"(see trainers/common.py's num_workers restore refusal). "
            f"Re-provision the host, or start fresh on the smaller "
            f"fleet with a new workdir"))


class RankLossRefused(RankLostError):
    """Fewer workers would be legal (sync-replicated state restores
    across mesh sizes) but was not requested: a silent shrink changes
    the global batch and the data order mid-training."""

    def __init__(self, rank: int, attempt: int, cause: str):
        super().__init__(rank, attempt, cause, (
            f"rank {rank} permanently lost at gang attempt {attempt} "
            f"({cause}); sync-replicated state COULD legally continue "
            f"on fewer workers, but that silently changes the global "
            f"batch and the data order mid-training — refused without "
            f"--elastic"))


@dataclasses.dataclass
class GangResult:
    status: str                  # ok | exhausted | wedged | terminated
                                 # | evicted (request_stop — no restart)
    gang_attempts: int           # launches, including the first
    restarts: int                # teardown+relaunch cycles (all causes)
    preemptions: int             # clean unanimous-143 restarts (exempt)
    agreed_steps: list           # agreement outcomes, in relaunch order
    last_rcs: dict               # rank -> rc of the final gang attempt
    ranks: list                  # surviving rank ids
    reasons: list[str] = dataclasses.field(default_factory=list)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _classify(rc: int | None) -> str:
    if rc == 0:
        return "ok"
    if rc == RC_PREEMPTED:
        return "preempted"
    if rc == RC_WEDGED:
        return "wedged"
    if rc is None or rc < 0:
        return "killed"
    return "crash"


def resolve_ledger_dest(configured: str) -> str:
    """The ONE run-ledger destination rule, shared by the fleet's own
    rows, the env each rank inherits (spawn uses ``env.setdefault``),
    and every layer that must watch the same file (the ``--heal``
    remediator): an operator's box-wide ``OBS_LEDGER`` export wins over
    ``configured``, and a PRESENT-but-empty export is "set to disabled"
    (``setdefault`` skips a present key; ``maybe_begin`` treats "" as
    no ledger) — never a fall-through to the default.  One drill must
    land in ONE file; rows split across two files would show half the
    story to either reader."""
    if "OBS_LEDGER" in os.environ:
        return os.environ["OBS_LEDGER"]
    return configured


class FleetSupervisor:
    """Launch and babysit an N-rank gang; see the module docstring for
    the state machine.  ``workdir`` holds per-rank heartbeat files and
    stderr logs; ``worker_tiled``/``elastic`` select the rank-loss
    reaction."""

    # How long a rank's failed /health scrape keeps the monitor off its
    # endpoint (file fallback continues) — see _read_rank_health.
    _HTTP_BACKOFF_S = 5.0

    def __init__(self, num_ranks: int,
                 policy: RetryPolicy | None = None,
                 journal: Journal | None = None,
                 heartbeat_timeout_s: float = 0.0,
                 wall_timeout_s: float = 0.0,
                 kill_grace_s: float = 10.0,
                 poll_s: float = 0.1,
                 preempt_grace_s: float = 30.0,
                 seed: int | None = None,
                 elastic: bool = False,
                 worker_tiled: bool = False,
                 workdir: str = "/tmp/fleet",
                 health_path: str | None = None,
                 skew_lag_steps: int = 3,
                 skew_time_ratio: float = 4.0,
                 ledger_path: str | None = None,
                 http: bool = False,
                 http_timeout_s: float = 0.25,
                 reprobe_on_relaunch: bool = True):
        if num_ranks < 1:
            raise ValueError(f"num_ranks {num_ranks} must be >= 1")
        self.num_ranks = num_ranks
        self.ranks = list(range(num_ranks))     # survivors, original ids
        self.policy = policy or RetryPolicy()
        self.journal = journal or Journal(None)
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.wall_timeout_s = wall_timeout_s
        self.kill_grace_s = kill_grace_s
        self.poll_s = poll_s
        self.preempt_grace_s = preempt_grace_s
        self.elastic = elastic
        self.worker_tiled = worker_tiled
        # A standalone fleet regrows itself before every elastic
        # relaunch; under the scheduler this is False — regrowing
        # consumes mesh devices the scheduler may have backfilled, so
        # only its capacity-gated grow policy may widen the gang.
        self.reprobe_on_relaunch = reprobe_on_relaunch
        self.workdir = os.path.abspath(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        # Fleet-level health.json (obs/anomaly.py contract): None means
        # the workdir default; "" disables the aggregate write (the
        # per-rank reads still feed gauges + journal annotations).
        self.health_path = (os.path.join(self.workdir, "health.json")
                            if health_path is None else health_path)
        self.skew_lag_steps = skew_lag_steps
        self.skew_time_ratio = skew_time_ratio
        # Skew needs step DELTAS between polls, not just positions:
        # reading per-rank health more often than it changes is wasted
        # IO, and the detection-latency bound the drill asserts (<= 3
        # steps of a 0.25 s/step straggler) only needs ~0.5 s cadence.
        self._health_poll_s = max(poll_s, 0.5)
        self._rng = random.Random(seed)
        # Run ledger (obs/ledger.py): exported to every rank (each
        # child writes its own run rows there) and written by the fleet
        # itself (gang rows + the resume_agreement annotation) — one
        # RUNS.jsonl holding the whole drill, queryable with
        # tools.obs_query.  None = the workdir default; "" disables.
        self.ledger_path = (os.path.join(self.workdir, "RUNS.jsonl")
                            if ledger_path is None else ledger_path)
        # Live scrape (obs/serve.py): with http=True each rank gets an
        # OBS_HTTP_PORT export and the monitor pass prefers scraping
        # /health over reading the per-rank file — the file stays as
        # the fallback, so a rank whose server never bound (port taken,
        # child predates the contract) degrades to exactly the old
        # behavior instead of going dark.
        self.http = http
        self.http_timeout_s = http_timeout_s
        self._http_ports: dict[int, int] = (
            {r: _free_port() for r in range(num_ranks)} if http else {})
        self._scrape_logged: set = set()
        self._http_backoff: dict[int, float] = {}
        # This fleet invocation's ledger disambiguator (see _gang_run).
        self._fleet_run_id = (f"{int(obs_metrics._wall() * 1000):x}"
                              f"-{os.getpid()}")
        # Scheduler-driven clean stop (tools/schedule.py SLO preemption):
        # request_stop() sets this and the monitor loop tears the gang
        # down through the same TERM-grace-KILL path a platform
        # preemption takes — every rank saves and exits 143 — but run()
        # returns "evicted" instead of restarting.
        self._stop = threading.Event()
        self._stop_reason = "evicted"
        # Original rank ids whose host is permanently gone (elastic
        # shrink path); the recovery re-probe re-adds them when their
        # host answers again — see probe_lost_ranks/reprobe_lost_ranks.
        self._lost: set[int] = set()
        # Straggler/flag latches — reset per gang attempt in _run_gang,
        # initialized here so the `stragglers` property (read by the
        # scheduler's heal policy from its tick thread) is safe before
        # the first attempt launches.
        self._stragglers: set = set()
        self._flagged: set = set()
        # One port per ORIGINAL rank, chosen once: a gang restart reuses
        # the same coordinator address, like a real re-scheduled job
        # whose hosts keep their endpoints.
        self._ports = [_free_port() for _ in range(num_ranks)]

    def _ledger_dest(self) -> str:
        return resolve_ledger_dest(self.ledger_path)

    def _ledger_event(self, event: str, **fields) -> None:
        dest = self._ledger_dest()
        if dest:
            obs_ledger.log_event(event, path=dest, src="fleet", **fields)

    def _gang_run(self, name: str, attempt: int) -> str:
        """Gang row id, unique ACROSS fleet invocations: the ledger is
        append-only and may hold months of drills against one workdir,
        and two drills both keyed ``gang:train:a0`` would silently fold
        into one run on read (the second drill's outcome replacing the
        first's).  Same wall-ms+pid disambiguation RunLedger ids use."""
        return f"gang:{name}:{self._fleet_run_id}:a{attempt}"

    # --- per-rank plumbing ------------------------------------------------
    @staticmethod
    def _sub(argv: list[str], rank: int, num_ranks: int) -> list[str]:
        """Substitute ``{rank}``/``{num_ranks}`` in child argv tokens —
        how ONE command line fans out to per-rank workdirs/flags
        (plain str.replace, not str.format: a child argv may carry
        braces of its own, e.g. inline JSON)."""
        return [t.replace("{rank}", str(rank))
                 .replace("{num_ranks}", str(num_ranks)) for t in argv]

    def _hb_path(self, rank: int) -> str:
        return os.path.join(self.workdir, f"hb_rank{rank}")

    def _health_path(self, rank: int) -> str:
        return os.path.join(self.workdir, f"health_rank{rank}.json")

    def _spawn_rank(self, rank: int, index: int, hosts: list[str],
                    argv: list[str], name: str, attempt: int,
                    agreed: int | None, stdout_dir: str | None,
                    env_extra: dict | None) -> subprocess.Popen:
        # The host-loss seam: a fresh tombstone for this rank means its
        # host is down, and the spawn fails with the SAME OSError shape
        # a missing/unexecable binary produces — one rank-lost path for
        # the real failure and the drillable one (faults.py host_loss).
        if self.host_down(rank):
            raise OSError(
                f"rank {rank} host is down (tombstone "
                f"{self._host_down_path(rank)})")
        env = dict(os.environ)
        env["TF_CONFIG"] = tf_config_env(hosts, index)
        env["OBS_RANK"] = str(rank)
        env["FLEET_NUM_RANKS"] = str(len(self.ranks))
        env["SUPERVISE_ATTEMPT"] = str(attempt)
        env.setdefault("OBS_PHASE", name)
        if agreed is not None:
            # Only once an agreement pass ran: the FIRST launch has
            # nothing to agree on (fresh stores), and a child seeing no
            # export restores its own newest — which is then provably
            # common, because nothing has diverged yet.
            env["FLEET_RESUME_STEP"] = str(agreed)
        else:
            # Scrubbed, not inherited: a stale export leaking in from
            # the FLEET's environment (a prior drill's shell, an outer
            # harness) would pin every first-attempt child to a step
            # its fresh store cannot prove — a gang-wide crash loop.
            env.pop("FLEET_RESUME_STEP", None)
        hb = self._hb_path(rank)
        try:
            # Same stale-mtime reset as the single-child supervisor: a
            # beat file from the previous attempt would read as an
            # instant wedge.
            os.remove(hb)
        except OSError:
            pass
        env["SUPERVISE_HEARTBEAT"] = hb
        # Per-rank health.json (training/hooks.AnomalyHook writes it,
        # this fleet's monitor reads it) — always per-rank, never an
        # inherited OBS_HEALTH: N ranks sharing one operator-exported
        # path would overwrite each other's reports.  Stale-file reset
        # for the same reason as the beat: a previous attempt's report
        # would read as an instant regression/skew.
        hp = self._health_path(rank)
        try:
            os.remove(hp)
        except OSError:
            pass
        env["OBS_HEALTH"] = hp
        # The faults.py host_loss seam: the child writes THIS tombstone
        # (then SIGKILLs itself), and the next spawn of this rank fails
        # with the spawn-OSError above — a host loss, drillable from a
        # FaultPlan like every other fault.
        env["FLEET_HOST_DOWN_FILE"] = self._host_down_path(rank)
        if self.ledger_path:
            # setdefault: an operator pointing the whole fleet at one
            # box-wide ledger (their own OBS_LEDGER export) wins.
            env.setdefault("OBS_LEDGER", self.ledger_path)
        if self.http:
            env["OBS_HTTP_PORT"] = str(self._http_ports[rank])
            # Say where each rank serves: the whole point is an
            # operator curling it mid-run.
            _log(f"rank {rank} scrape endpoint: "
                 f"http://127.0.0.1:{self._http_ports[rank]} "
                 f"(/metrics /health /flight /ledger/tail)")
        if self.heartbeat_timeout_s:
            env["SUPERVISE_HEARTBEAT_TIMEOUT_S"] = str(
                self.heartbeat_timeout_s)
        if self.journal.path:
            env.setdefault("SUPERVISE_JOURNAL", self.journal.path)
        if env_extra:
            env.update(env_extra)
        # Write-ahead half of the spawn record: a SIGKILL landing
        # between Popen and the pid row below would otherwise leave an
        # orphan no sweep can find; the intent at least makes the gap
        # visible to the sweeper (which warns — it cannot kill a pid it
        # never learned).
        self.journal.write("rank_spawn_intent", task=name,
                           attempt=attempt, rank=rank)
        out = err = None
        try:
            # stderr appends across attempts (one log per rank, like the
            # supervisor's `2>> $LOG`); stdout is per-attempt — a gang
            # drill needs EVERY attempt's JSON tail, not just the last.
            err = open(os.path.join(self.workdir, f"rank{rank}.log"), "ab")
            if stdout_dir:
                os.makedirs(stdout_dir, exist_ok=True)
                out = open(os.path.join(
                    stdout_dir, f"rank{rank}_attempt{attempt}.out"), "wb")
            # {num_ranks} reflects the LIVE gang size (an elastic
            # restart shrank it — or a recovery re-probe grew it back),
            # matching the FLEET_NUM_RANKS and TF_CONFIG this same
            # spawn exports — a child sharding by the substituted value
            # must divide by the ranks that actually exist.
            proc = subprocess.Popen(
                self._sub(argv, rank, len(self.ranks)), env=env,
                stdout=out or err, stderr=err, start_new_session=True)
        finally:
            # Popen dup'd the fds (or raised); ours must not leak.
            for f in (out, err):
                if f is not None:
                    f.close()
        # The pid lands in the journal so an OUTER control plane
        # (tools/schedule.py) that died with this gang still running can
        # sweep the orphaned process groups on restart — a spawned rank
        # with no matching rank_exit is exactly that orphan.
        self.journal.write("rank_spawn", task=name, attempt=attempt,
                           rank=rank, pid=proc.pid)
        return proc

    # --- host-loss seam + recovery re-probe -------------------------------
    def _host_down_path(self, rank: int) -> str:
        return os.path.join(self.workdir, f"host_down_rank{rank}")

    def host_down(self, rank: int) -> bool:
        """Is this rank's host tombstoned?  The tombstone is a JSON file
        the host_loss fault (resilience/faults.py) writes before the
        process SIGKILLs itself: ``down_s`` > 0 means the host comes
        back after that long (the tombstone self-expires and is
        removed); 0 means down until an operator removes the file.
        Unlike the per-spawn heartbeat/health resets, the tombstone
        deliberately SURVIVES across FleetSupervisor incarnations — a
        re-scheduled job must still see a dead host dead."""
        path = self._host_down_path(rank)
        try:
            with open(path) as f:
                rec = json.load(f)
        except OSError:
            return False
        except ValueError:
            # Half-written tombstone: the host died mid-declaring its
            # own death — still a dead host, not a healthy one.
            return True
        down_s = float(rec.get("down_s") or 0.0)
        if down_s > 0 and obs_metrics._wall() - float(rec.get("ts")
                                                     or 0.0) >= down_s:
            try:
                os.remove(path)
            except OSError:
                pass
            return False
        return True

    @property
    def stragglers(self) -> list[int]:
        """Ranks the CURRENT gang attempt's monitor pass has named
        straggler (lag + slowness evidence, obs/anomaly.detect_skew) —
        what the remediation policy layer (resilience/remediate.py,
        the scheduler's heal pass) reads.  Cross-thread like
        ``lost_ranks``: the writer publishes copy-on-write (rebind,
        never in-place mutation), so this read iterates a set that can
        no longer change size under it."""
        return sorted(self._stragglers)

    @property
    def lost_ranks(self) -> list[int]:
        """Original rank ids dropped by the elastic shrink path and not
        yet recovered — what the scheduler's grow policy watches.  Read
        from the scheduler's tick thread while the fleet's run thread
        updates it — copy-on-write on the writer side, like
        ``stragglers``."""
        return sorted(self._lost)

    def probe_lost_ranks(self, argv: list[str]) -> list[int]:
        """Non-mutating recovery probe: which lost ranks could spawn
        again NOW — no fresh tombstone, and the rank's substituted
        program resolves to something executable (the exact precondition
        of the spawn whose OSError lost the rank).  The scheduler polls
        this each tick to drive grow-on-recovery (cross-thread — hence
        the snapshot copy); the fleet's own retry loop calls the
        mutating half before every elastic relaunch."""
        out = []
        for r in self.lost_ranks:
            if self.host_down(r):
                continue
            prog = self._sub(argv, r, self.num_ranks)[0] if argv else ""
            if not prog or shutil.which(prog) is None:
                continue
            out.append(r)
        return out

    def reprobe_lost_ranks(self, argv: list[str],
                           name: str = "") -> list[int]:
        """The recovery re-probe hook (mutating half): re-add every
        lost rank whose host answers again, restoring the gang — and
        the ``{num_ranks}`` substitution — to full width on the next
        relaunch.  Journaled per rank (``rank_recovered``) and counted,
        so a postmortem shows the shrink AND the grow."""
        recovered = self.probe_lost_ranks(argv)
        for r in recovered:
            self._lost = self._lost - {r}
            self.ranks.append(r)
            self.ranks.sort()
            _RANKS_RECOVERED.inc()
            self.journal.write("rank_recovered", task=name, rank=r,
                               ranks=list(self.ranks))
            self._ledger_event("rank_recovered", task=name, rank=r,
                               ranks=list(self.ranks))
            _log(f"{name}: rank {r} host answered the recovery re-probe "
                 f"— gang grows back to ranks {self.ranks}")
        return recovered

    def request_stop(self, reason: str = "evicted") -> None:
        """Scheduler-driven clean preemption: the monitor loop tears the
        gang down through the normal TERM-grace-KILL escalation (every
        rank's SIGTERM handler saves and exits 143) and ``run()``
        returns status ``evicted`` WITHOUT restarting — the caller
        (tools/schedule.py) requeues the job, and its next launch
        resumes from the snapshots this stop produced.  Thread-safe:
        the scheduler calls it from outside the fleet's run thread."""
        self._stop_reason = reason
        self._stop.set()

    # --- gang teardown ----------------------------------------------------
    def _teardown(self, procs: dict, exited: dict, why: str, name: str,
                  attempt: int, rank: int | None = None) -> None:
        """One rank's failure is a GANG event: TERM every live rank's
        process group in parallel, give them one shared grace window
        (cooperative trainers save + exit 143 inside it), then KILL the
        stragglers — the supervisor's TERM-grace-KILL escalation, fanned
        out so N ranks pay one grace, not N."""
        _KILLS.labels(why=why).inc()
        self.journal.write(
            "gang_teardown", task=name, attempt=attempt, why=why,
            **({"rank": rank} if rank is not None else {}))
        live = [(r, p) for r, p in procs.items() if r not in exited]
        for _, p in live:
            try:
                os.killpg(p.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
        deadline = time.monotonic() + self.kill_grace_s
        for r, p in live:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
                p.wait()
            exited[r] = p.returncode
            self.journal.write("rank_exit", task=name, attempt=attempt,
                               rank=r, rc=p.returncode, reason="teardown")
            _RANK_EXITS.labels(rank=r, outcome="torn_down").inc()
        # The fleet is the informed survivor here (a wedged rank can't
        # dump its own flight); non-terminal so atexit still refreshes.
        obs_recorder.dump_global(f"gang_teardown_{why}", final=False)

    # --- online anomaly monitoring (detection ONLY) -----------------------
    def _read_rank_health(self, rank: int, name: str,
                          attempt: int) -> dict | None:
        """One rank's health payload: HTTP scrape of the rank's
        ``/health`` endpoint first (obs/serve.py, when this fleet
        exported a port), the per-rank file as the fallback.  The first
        read per (rank, mode) per gang attempt journals a
        ``health_scrape`` event, so a postmortem can prove which
        transport the monitor actually used — and see a fallback happen.
        Detection-only contract unchanged: every failure degrades to
        the file, and a missing file is still just None.  A rank whose
        scrape just failed is skipped for ``_HTTP_BACKOFF_S``: these
        urlopens are SERIAL inside the monitor loop, and N wedged-but-
        bound endpoints each eating the full timeout would stall
        rank-exit/SIGTERM polling by N x timeout per pass — exactly
        when the fleet is unhealthy."""
        port = self._http_ports.get(rank) if self.http else None
        if port and time.monotonic() >= self._http_backoff.get(rank, 0.0):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health",
                        timeout=self.http_timeout_s) as resp:
                    payload = json.loads(resp.read().decode())
                if isinstance(payload, dict):
                    self._http_backoff.pop(rank, None)
                    if (rank, "http") not in self._scrape_logged:
                        self._scrape_logged.add((rank, "http"))
                        self.journal.write("health_scrape", task=name,
                                           attempt=attempt, rank=rank,
                                           mode="http", port=port)
                    return payload
                # Parseable-but-not-ours (a squatter on the rank's
                # pre-allocated port answering arrays): a failure for
                # backoff purposes too, or every pass re-pays the
                # round-trip the backoff exists to avoid.
                self._http_backoff[rank] = (time.monotonic()
                                            + self._HTTP_BACKOFF_S)
            except Exception:
                # Not bound yet / child gone / wedged: fall back, and
                # give this rank's endpoint a breather before retrying.
                self._http_backoff[rank] = (time.monotonic()
                                            + self._HTTP_BACKOFF_S)
        payload = obs_anomaly.read_health(self._health_path(rank))
        if payload is not None \
                and (rank, "file") not in self._scrape_logged:
            self._scrape_logged.add((rank, "file"))
            self.journal.write("health_scrape", task=name,
                               attempt=attempt, rank=rank, mode="file")
        return payload

    def _stale_beat_span(self, rank: int, now: float) -> float | None:
        """A live rank's no-beat span, reported ONLY when it is stale
        relative to that rank's OWN observed beat cadence (the longest
        mtime-to-mtime gap this monitor has seen, fleet-clocked).  Raw
        heartbeat age is NOT slowness evidence: production trainers beat
        every ~64 steps (trainers/common.py), so a healthy rank's age at
        a random poll is uniform in [0, 64 x step] — far over any
        step-time multiple.  A span > skew_time_ratio x the rank's own
        cadence, while the beat file sits unchanged, is a genuine stall
        (the wedged-but-alive shape).  Needs one observed beat interval
        to calibrate; until then returns None — no evidence, never a
        guess."""
        try:
            mtime = os.path.getmtime(self._hb_path(rank))
        except OSError:
            return None
        prev = self._beat_obs.get(rank)
        if prev is None or mtime != prev[0]:
            interval = prev[2] if prev else None
            if prev is not None:
                seen = now - prev[1]
                interval = max(interval or 0.0, seen)
            self._beat_obs[rank] = (mtime, now, interval)
            return None
        frozen = now - prev[1]
        if prev[2] and frozen > self.skew_time_ratio * prev[2]:
            return round(frozen, 3)
        return None

    def _poll_health(self, name: str, attempt: int, ranks_all: list,
                     exited=()) -> None:
        """Read every live rank's health.json (obs/anomaly.py, written
        by training/hooks.AnomalyHook under the OBS_HEALTH this fleet
        exported), run the cross-rank skew/straggler pass, and surface
        what it finds — gauges, journal ``anomaly`` annotations, an
        aggregate fleet health.json, and a flight dump on a NEW
        straggler.  Detection only, by design: nothing here feeds the
        restart state machine — a false positive must cost a log line,
        never a teardown."""
        now = time.monotonic()
        if now - self._health_polled_t < self._health_poll_s:
            return
        self._health_polled_t = now
        ranks: dict = {}
        payloads: dict = {}
        # ALL ranks of the attempt, not just the live ones: these
        # drills' children don't rendezvous, so a fast rank can finish
        # while the straggler crawls on — its final health report is
        # exactly the "front of the fleet" the skew pass measures
        # against (and a finished rank can never be flagged itself:
        # lagging requires trailing the front).
        for r in ranks_all:
            payload = self._read_rank_health(r, name, attempt)
            if payload is None:
                continue
            payloads[r] = payload
            det = (payload.get("detectors") or {}).get("step_time") or {}
            flags = payload.get("flags") or {}
            if r in exited:
                # A finished rank's beat stops BECAUSE it exited —
                # staleness is not slowness evidence, and a cleanly
                # preempted rank must not be named straggler while the
                # others drain.  Its frozen report still serves as the
                # front/lag datum above.
                hb_age = None
            else:
                hb_age = self._stale_beat_span(r, now)
            ranks[r] = {
                "step": payload.get("step"),
                "step_time_s": det.get("ewma_s"),
                "regression_firing": (flags.get("step_time_regression")
                                      or {}).get("firing"),
                "hb_age_s": hb_age}
            if payload.get("step") is not None:
                _RANK_STEP.labels(rank=r).set(payload["step"])
            # Per-rank detector firings annotate the journal ONCE per
            # (rank, kind) per gang attempt — the postmortem's "rank 1
            # saw nan_loss at step 7" line, next to the lifecycle
            # events it explains.
            for kind, f in flags.items():
                # Latched fired_step, not the live firing flag: a
                # transient firing (z decays in ~0.2 s) between 0.5 s
                # polls must still annotate the journal — the same
                # fired-or-firing read obs_report renders.
                if (f.get("firing") or f.get("fired_step") is not None) \
                        and (r, kind) not in self._flagged:
                    self._flagged.add((r, kind))
                    obs_anomaly.FLAGS_TOTAL.labels(kind=kind,
                                                   rank=r).inc()
                    self.journal.write(
                        "anomaly", task=name, attempt=attempt, rank=r,
                        kind=kind, fired_step=f.get("fired_step"))
                    # Mirrored into the run ledger so the remediation
                    # layer (and obs_query) can consume detections
                    # without the fleet's private journal.
                    self._ledger_event(
                        "anomaly", task=name, attempt=attempt, rank=r,
                        kind=kind, fired_step=f.get("fired_step"))
        skew = obs_anomaly.detect_skew(ranks,
                                       lag_steps=self.skew_lag_steps,
                                       time_ratio=self.skew_time_ratio)
        if skew["lag_steps"]:
            _SKEW.set(max(skew["lag_steps"].values()))
        new = [r for r in skew["stragglers"] if r not in self._stragglers]
        if new:
            # Copy-on-write publish: the scheduler's tick thread reads
            # `stragglers` concurrently — an in-place .add() under its
            # iteration raises "set changed size during iteration";
            # rebinding an already-complete set is atomic.
            self._stragglers = self._stragglers | set(new)
        for r in new:
            _STRAGGLERS.labels(rank=r).inc()
            obs_anomaly.FLAGS_TOTAL.labels(kind="straggler", rank=r).inc()
            self.journal.write(
                "anomaly", task=name, attempt=attempt, rank=r,
                kind="straggler", step=ranks[r].get("step"),
                max_step=skew["max_step"], why=skew["why"].get(r))
            self._ledger_event(
                "anomaly", task=name, attempt=attempt, rank=r,
                kind="straggler", step=ranks[r].get("step"),
                max_step=skew["max_step"], why=skew["why"].get(r))
            _log(f"{name}: rank {r} straggling — {skew['why'].get(r)}")
        if self.health_path and payloads:
            obs_anomaly.write_health(self.health_path, {
                "version": obs_anomaly.HEALTH_VERSION, "kind": "fleet",
                "updated_unix": round(obs_metrics._wall(), 3),
                "attempt": attempt,
                "ranks": {str(r): p for r, p in sorted(payloads.items())},
                "skew": skew,
                "stragglers": sorted(self._stragglers),
                "flags_seen": sorted(f"rank{r}:{k}"
                                     for r, k in self._flagged)})
        if new:
            # The ring should cover the steps AROUND the detection, not
            # whatever the gang later dies on; non-terminal, like every
            # informed-survivor dump.
            obs_recorder.dump_global("straggler_detected", final=False)

    # --- one gang attempt -------------------------------------------------
    def _run_gang(self, argv: list[str], name: str, attempt: int,
                  agreed: int | None, stdout_dir: str | None,
                  env_extra: dict | None) -> tuple[str, str, dict]:
        """Returns (outcome, why, rcs): outcome one of ok | preempted |
        wedged | crash | terminated | rank_lost."""
        hosts = [f"127.0.0.1:{self._ports[r]}" for r in self.ranks]
        procs: dict[int, subprocess.Popen] = {}
        exited: dict[int, int | None] = {}
        if self._stop.is_set():
            # A stop that landed between gang attempts: don't launch a
            # gang just to tear it down one poll later.
            return ("evicted",
                    f"stop requested ({self._stop_reason}) before launch",
                    exited)
        sigterm_seen: list = []
        # Anomaly latches are per gang attempt: a restart is a new run
        # (fresh detectors in every child), so a prior attempt's
        # straggler must not suppress this attempt's journal line.
        self._stragglers: set = set()
        self._flagged: set = set()
        self._scrape_logged = set()     # (rank, transport) per attempt
        self._http_backoff = {}         # fresh children, fresh endpoints
        self._health_polled_t = -float("inf")
        self._beat_obs: dict = {}       # rank -> (mtime, seen_at, interval)
        # Stale-file reset, same reason as the per-rank files at spawn:
        # a previous run's aggregate in a reused workdir would render as
        # THIS run's stragglers (the monitor only rewrites it once some
        # rank reports health).
        if self.health_path:
            try:
                os.remove(self.health_path)
            except OSError:
                pass

        def _on_term(signum, frame):
            sigterm_seen.append(True)

        self.journal.write("gang_start", task=name, attempt=attempt,
                           ranks=list(self.ranks),
                           resume_step=agreed)
        # Gang-level ledger row (each rank writes its own run rows to
        # the same OBS_LEDGER this fleet exported): one row per gang
        # attempt, closed with the outcome in run()'s retry loop.
        self._ledger_event(
            "run_start", run=self._gang_run(name, attempt),
            entrypoint=name, attempt=attempt, ranks=list(self.ranks),
            resume_step=agreed)
        # The handler covers the SPAWN loop too: a SIGTERM landing
        # between two spawns must still reach the children already
        # launched into their own sessions — the default disposition
        # would kill the fleet and orphan them mid-gang.
        with installed_signal_handler(signal.SIGTERM, _on_term):
            for index, rank in enumerate(self.ranks):
                try:
                    procs[rank] = self._spawn_rank(
                        rank, index, hosts, argv, name, attempt, agreed,
                        stdout_dir, env_extra)
                except OSError as e:
                    # Permanently lost host: nothing at this rank's argv
                    # can even exec.  Tear down whatever already
                    # launched, then degrade LOUDLY per the taxonomy.
                    self._teardown(procs, exited, "rank_lost", name,
                                   attempt, rank=rank)
                    _RANKS_LOST.inc()
                    self.journal.write("rank_lost", task=name,
                                       attempt=attempt, rank=rank,
                                       error=str(e))
                    # Ledger mirror: host losses are remediation-layer
                    # input (repeated-offender quarantine policy) and
                    # must be consumable without the fleet journal.
                    self._ledger_event("rank_lost", task=name,
                                       attempt=attempt, rank=rank,
                                       error=str(e))
                    if self.worker_tiled:
                        raise RankLossStructurallyIllegal(rank, attempt,
                                                          str(e)) from e
                    if not self.elastic:
                        raise RankLossRefused(rank, attempt, str(e)) from e
                    self.ranks.remove(rank)
                    self._lost = self._lost | {rank}
                    if not self.ranks:
                        raise RankLossRefused(rank, attempt, str(e)) from e
                    _log(f"{name}: rank {rank} lost ({e}); elastic — "
                         f"continuing with ranks {self.ranks}")
                    return "rank_lost", f"rank {rank} lost: {e}", exited

            start = time.monotonic()
            first_143_t: float | None = None
            while True:
                for r, p in procs.items():
                    if r in exited:
                        continue
                    rc = p.poll()
                    if rc is not None:
                        exited[r] = rc
                        self.journal.write("rank_exit", task=name,
                                           attempt=attempt, rank=r, rc=rc)
                        _RANK_EXITS.labels(rank=r,
                                           outcome=_classify(rc)).inc()
                live = [r for r in procs if r not in exited]
                crashed = [r for r, rc in exited.items()
                           if rc not in (0, RC_PREEMPTED)]
                if not live:
                    rcs = set(exited.values())
                    if rcs == {0}:
                        return "ok", "all ranks done", exited
                    if RC_WEDGED in rcs:
                        return ("wedged",
                                f"rank(s) {sorted(r for r in exited if exited[r] == RC_WEDGED)} "
                                f"reported the backend wedged (rc=3)",
                                exited)
                    if rcs <= {0, RC_PREEMPTED}:
                        # Unanimous-clean: every rank either finished or
                        # preempted-with-save (a finished rank has
                        # nothing left to preempt) — the 143 consensus
                        # path, exempt from the retry budget.
                        return "preempted", "clean preemption", exited
                    return ("crash", f"rank(s) {sorted(crashed)} crashed "
                            f"(rcs {[exited[r] for r in sorted(crashed)]})",
                            exited)
                if sigterm_seen:
                    # The fleet itself is being killed: forward to every
                    # rank group so no child outlives its supervisor.
                    self._teardown(procs, exited, "fleet_sigterm", name,
                                   attempt)
                    return "terminated", "fleet SIGTERM — forwarded", exited
                if self._stop.is_set():
                    # Scheduler-driven clean stop (SLO eviction / grow
                    # relaunch): same TERM-grace-KILL teardown — the
                    # ranks save and exit 143 — but the outcome routes
                    # to run()'s no-restart "evicted" return.
                    self._teardown(procs, exited, self._stop_reason,
                                   name, attempt)
                    return ("evicted",
                            f"stop requested ({self._stop_reason})",
                            exited)
                if crashed:
                    self._teardown(procs, exited, "rank_crash", name,
                                   attempt, rank=crashed[0])
                    if any(exited[r] == RC_WEDGED for r in crashed):
                        return ("wedged", f"rank {crashed[0]} rc=3 — gang "
                                f"torn down", exited)
                    return ("crash", f"rank {crashed[0]} "
                            f"rc={exited[crashed[0]]} — gang torn down",
                            exited)
                preempted_now = [r for r, rc in exited.items()
                                 if rc == RC_PREEMPTED]
                if preempted_now and first_143_t is None:
                    first_143_t = time.monotonic()
                if (first_143_t is not None
                        and time.monotonic() - first_143_t
                        > self.preempt_grace_s):
                    # A real platform preemption TERMs every rank; one
                    # rank exiting 143 while the rest train on is the
                    # gang cleanly losing a member — NOT the unanimous
                    # path, so it goes through the budgeted teardown.
                    self._teardown(procs, exited, "preempt_divergence",
                                   name, attempt, rank=preempted_now[0])
                    return ("crash", f"rank(s) {preempted_now} preempted "
                            f"but rank(s) {live} ran past the "
                            f"{self.preempt_grace_s:.0f}s consensus grace",
                            exited)
                now = time.monotonic()
                if self.wall_timeout_s and now - start > self.wall_timeout_s:
                    self._teardown(procs, exited, "wall_timeout", name,
                                   attempt)
                    return ("crash", f"wall timeout "
                            f"{self.wall_timeout_s:.0f}s", exited)
                if self.heartbeat_timeout_s:
                    for r in live:
                        # Armed per rank once ITS first beat lands —
                        # same opt-in rule as the single-child
                        # supervisor (a beat-less child is the wall
                        # timeout's job).
                        try:
                            hb_age = (time.time() - os.path.getmtime(
                                self._hb_path(r)))
                        except OSError:
                            continue
                        _HB_AGE.labels(rank=r).set(round(hb_age, 3))
                        if hb_age > self.heartbeat_timeout_s:
                            self._teardown(procs, exited, "rank_heartbeat",
                                           name, attempt, rank=r)
                            return ("crash", f"rank {r} heartbeat stale "
                                    f"{hb_age:.1f}s > "
                                    f"{self.heartbeat_timeout_s:.0f}s",
                                    exited)
                self._poll_health(name, attempt, list(procs),
                                  exited=exited)
                time.sleep(self.poll_s)

    # --- resume-step agreement --------------------------------------------
    def _snapshot_dirs(self, snapshot_dir_template: str) -> dict:
        return {r: snapshot_dir_template.replace("{rank}", str(r))
                for r in self.ranks}

    def _discard_all(self, name: str, dirs: dict, agreed: int) -> dict:
        """``discard_newer(agreed)`` on every rank's store — the
        mutation half of the agreement, journaled write-ahead by the
        caller so a supervisor death ANYWHERE in this loop is
        recoverable (:meth:`_replay_agreement` re-applies it; the
        per-store discard is itself idempotent: it only ever removes
        steps > agreed, which a second pass finds already gone).

        ``FLEET_DRILL_DIE_IN_DISCARD=<k>`` is the interrupted-AGREEMENT
        drill seam (ROADMAP fault library): the supervisor "dies"
        (raises) after discarding the k-th rank's store, leaving later
        ranks still holding their divergent newer snapshots — exactly
        the half-discarded state a mid-discard crash leaves, which the
        journal replay must heal before any child resumes."""
        from distributedtensorflowexample_tpu_torch.resilience import (
            snapshot as snap)
        die_after = os.environ.get("FLEET_DRILL_DIE_IN_DISCARD", "")
        discarded = {}
        for i, r in enumerate(sorted(dirs)):
            discarded[r] = snap.SnapshotStore(dirs[r]).discard_newer(
                agreed)
            if die_after and i == int(die_after):
                raise RuntimeError(
                    f"FLEET_DRILL_DIE_IN_DISCARD={die_after}: "
                    f"{name}: supervisor dying mid-discard (rank "
                    f"{r} done, later ranks untouched)")
        return discarded

    def _agree(self, name: str, snapshot_dir_template: str) -> int | None:
        """The agreement pass: max common valid step across every
        surviving rank's store, divergent/torn newer steps discarded
        from disk, result journaled — returns the step to export (0 =
        no common step: fresh start), or None when the run has no
        snapshot surface to agree over.  "Valid" unions both snapshot
        formats (``snapshot.valid_steps``): a row-layout rank's
        quorum-valid shard sets (every 1/D shard digest-intact or
        ring-mirror-recoverable, resilience/shardstore.py) count
        exactly like monolithic payloads — so a rank that lost one
        shard directory within redundancy still votes for that step,
        and the gang does NOT regress past a recoverable save.

        The ``resume_agreement`` record is WRITE-AHEAD: it commits the
        agreed step (and what will be discarded) to the journal BEFORE
        any store is mutated, and ``resume_discard_done`` commits
        completion after.  A supervisor that dies between the two left
        a half-discarded fleet; a restarted supervisor's
        :meth:`_replay_agreement` finds the unmatched intent record and
        re-applies the discard — without the replay, its FIRST launch
        exports no agreed step and every child restores its own newest,
        so the ranks the dead supervisor never reached would silently
        resume the divergent timeline the agreement had already
        condemned."""
        if not snapshot_dir_template:
            return None
        from distributedtensorflowexample_tpu_torch.resilience import (
            snapshot as snap)
        dirs = self._snapshot_dirs(snapshot_dir_template)
        # One validation pass (full payload read + crc32 per snapshot)
        # serves both the journal detail and the intersection — this is
        # newest_common_step's exact rule computed from the per-rank
        # lists already in hand, not a second disk walk.
        per_rank = {r: snap.valid_steps(d) for r, d in dirs.items()}
        common = set.intersection(*(set(v) for v in per_rank.values()))
        agreed = max(common) if common else 0
        # The record's "discarded" is the write-ahead PLAN (valid steps
        # the agreement condemns); the actual sweep — which also drops
        # torn newer payloads per_rank never listed — lands in the
        # resume_discard_done completion record.
        self.journal.write(
            "resume_agreement", task=name, agreed=agreed,
            per_rank={str(r): v for r, v in per_rank.items()},
            discarded={str(r): [s for s in v if s > agreed]
                       for r, v in per_rank.items()})
        discarded = self._discard_all(name, dirs, agreed)
        self.journal.write(
            "resume_discard_done", task=name, agreed=agreed,
            discarded={str(r): v for r, v in discarded.items()})
        _AGREEMENTS.inc()
        # The same agreement lands in the run ledger: obs_query renders
        # it between the attempts it separates, so "what did the gang
        # agree to resume from" is answerable without the journal.
        self._ledger_event(
            "resume_agreement", task=name, agreed=agreed,
            per_rank={str(r): v for r, v in per_rank.items()},
            discarded={str(r): v for r, v in discarded.items()})
        _log(f"{name}: resume-step agreement: "
             + ", ".join(f"rank {r} had {per_rank[r] or 'nothing'}"
                         for r in sorted(per_rank))
             + f" -> agreed step {agreed}"
             + (f" (discarded {discarded})" if any(discarded.values())
                else ""))
        return agreed

    def _replay_agreement(self, name: str,
                          snapshot_dir_template: str) -> int | None:
        """Journal replay of an INTERRUPTED discard: the newest
        ``resume_agreement`` record with no ``resume_discard_done``
        after it means a previous supervisor incarnation died
        mid-:meth:`_discard_all`.  Re-apply the discard (idempotent —
        already-trimmed stores lose nothing) and return the agreed step
        so the first launch exports it; a COMPLETED prior agreement (or
        none at all) returns None and the first launch keeps its normal
        nothing-to-agree-on semantics."""
        if not snapshot_dir_template:
            return None
        pending = None
        for rec in self.journal.events():
            if rec.get("event") == "resume_agreement" \
                    and rec.get("task") == name:
                pending = rec
            elif rec.get("event") == "resume_discard_done" \
                    and rec.get("task") == name:
                pending = None
        if pending is None:
            return None
        agreed = int(pending.get("agreed", 0))
        dirs = self._snapshot_dirs(snapshot_dir_template)
        discarded = self._discard_all(name, dirs, agreed)
        self.journal.write(
            "resume_discard_done", task=name, agreed=agreed, replayed=True,
            discarded={str(r): v for r, v in discarded.items()})
        self._ledger_event(
            "resume_agreement_replayed", task=name, agreed=agreed,
            discarded={str(r): v for r, v in discarded.items()})
        _log(f"{name}: replayed interrupted resume-step agreement "
             f"(agreed step {agreed}; a prior supervisor died "
             f"mid-discard"
             + (f"; discarded {discarded})" if any(discarded.values())
                else ")"))
        return agreed

    # --- the gang retry loop ----------------------------------------------
    def run(self, argv: list[str], name: str = "",
            snapshot_dir_template: str = "",
            stdout_dir: str | None = None,
            env_extra: dict | None = None,
            agree_first: bool = False) -> GangResult:
        """Supervise ``argv`` (with ``{rank}`` substitution) as an
        N-rank gang until it completes, exhausts the crash budget, or
        loses a host.  ``snapshot_dir_template`` names each rank's
        SnapshotStore directory (``{rank}`` substituted) — without it
        no agreement pass runs and restarts are fresh-per-child.
        ``agree_first`` runs the agreement pass BEFORE the first launch
        too: a RESUMED job (the scheduler relaunching an evicted gang)
        starts from stores a previous fleet incarnation wrote, so 'the
        first launch has nothing to agree on' no longer holds — the
        ranks' newest steps may already diverge."""
        name = name or Supervisor._default_name(argv)
        attempt = -1
        failures = 0
        preemptions = 0
        restarts = 0
        # A prior supervisor incarnation that died mid-discard left the
        # fleet half-trimmed; replaying the journaled intent BEFORE the
        # first launch re-applies the discard (idempotent) and pins the
        # first gang to the already-agreed step — otherwise children
        # with no export would restore their own newest, resuming the
        # divergent timeline the dead supervisor had condemned.
        agreed: int | None = self._replay_agreement(
            name, snapshot_dir_template)
        if agreed is None and agree_first and snapshot_dir_template:
            agreed = self._agree(name, snapshot_dir_template)
        agreed_steps: list = []
        reasons: list[str] = []
        last: dict = {}
        try:
            with obs_trace.span("fleet", task=name,
                                ranks=self.num_ranks) as attrs:
                while attempt < self.policy.retries + MAX_PREEMPTIONS:
                    attempt += 1
                    outcome, why, last = self._run_gang(
                        argv, name, attempt, agreed, stdout_dir, env_extra)
                    reasons.append(f"gang attempt {attempt}: {outcome} "
                                   f"({why})")
                    self.journal.write(
                        "gang_end", task=name, attempt=attempt,
                        outcome=outcome, why=why,
                        rcs={str(r): rc for r, rc in sorted(last.items())})
                    self._ledger_event(
                        "run_end", run=self._gang_run(name, attempt),
                        outcome=outcome,
                        rcs={str(r): rc for r, rc in sorted(last.items())})
                    if outcome == "ok":
                        attrs["status"] = "ok"
                        return GangResult("ok", attempt + 1, restarts,
                                          preemptions, agreed_steps, last,
                                          list(self.ranks), reasons)
                    if outcome == "terminated":
                        attrs["status"] = "terminated"
                        return GangResult("terminated", attempt + 1,
                                          restarts, preemptions,
                                          agreed_steps, last,
                                          list(self.ranks), reasons)
                    if outcome == "evicted":
                        # request_stop(): clean preemption on the
                        # scheduler's behalf — no restart; the caller
                        # requeues and relaunches from the snapshots
                        # the teardown's TERM just produced.
                        attrs["status"] = "evicted"
                        return GangResult("evicted", attempt + 1,
                                          restarts, preemptions,
                                          agreed_steps, last,
                                          list(self.ranks), reasons)
                    if outcome == "wedged":
                        # The backend is provably gone under EVERY rank
                        # of this gang; relaunching N processes against
                        # a dead device resolves nothing (supervisor
                        # rc=3 contract).
                        attrs["status"] = "wedged"
                        return GangResult("wedged", attempt + 1, restarts,
                                          preemptions, agreed_steps, last,
                                          list(self.ranks), reasons)
                    if outcome == "preempted":
                        preemptions += 1
                        _log(f"{name}: gang preempted cleanly — "
                             f"restarting (exempt from the retry budget)")
                    else:
                        # crash / rank_lost(elastic): budgeted.
                        failures += 1
                        if failures > self.policy.retries:
                            attrs["status"] = "exhausted"
                            return GangResult(
                                "exhausted", attempt + 1, restarts,
                                preemptions, agreed_steps, last,
                                list(self.ranks), reasons)
                    restarts += 1
                    _GANG_RESTARTS.inc()
                    # Grow-on-recovery: BEFORE the agreement, so a
                    # recovered rank's store participates in (and is
                    # trimmed by) the same pass that pins the resume
                    # step the regrown gang exports.
                    if self.elastic and self._lost \
                            and self.reprobe_on_relaunch:
                        self.reprobe_lost_ranks(argv, name)
                    agreed = self._agree(name, snapshot_dir_template)
                    agreed_steps.append(agreed)
                    if outcome not in ("preempted", "rank_lost"):
                        delay = self.policy.delay_s(max(0, failures - 1),
                                                    self._rng.random())
                        if delay:
                            _log(f"{name}: gang restart "
                                 f"{failures}/{self.policy.retries} in "
                                 f"{delay:.2f}s (resume step {agreed})")
                            time.sleep(delay)
                attrs["status"] = "exhausted"
                return GangResult("exhausted", attempt + 1, restarts,
                                  preemptions, agreed_steps, last,
                                  list(self.ranks), reasons)
        finally:
            self.journal.write("fleet_end", task=name,
                               attempts=attempt + 1, restarts=restarts)
            export_prometheus_collector("fleet")
