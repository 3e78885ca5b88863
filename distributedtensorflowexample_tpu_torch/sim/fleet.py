"""The simulated fleet: gang objects with the ``FleetSupervisor``
surface (``ranks``/``lost_ranks``/``stragglers``/``run``/
``request_stop``/``probe_lost_ranks``) whose lifecycle is an event on
the virtual queue instead of 10,000 subprocesses.

The determinism protocol (docs/DESIGN.md §25):

* **Registration is synchronous.** The scheduler calls the factory
  inside ``_launch`` on its own thread; the factory registers the gang
  with the hub and schedules its completion event THEN — before the
  fleet thread even starts — so event order depends only on virtual
  time + push seq, never on thread scheduling.
* **``run()`` is a rendezvous, not a loop.** The scheduler's per-gang
  thread enters ``run()``, flags ``_entered``, and blocks on ``_done``.
  The hub's completion handler (fired from the virtual sleep on the
  scheduler thread) waits for ``_entered``, deposits the result, sets
  ``_done``, then JOINS the gang thread — so the very next ``_reap``
  sees ``st.thread.is_alive() == False`` deterministically.
* **Completions carry a generation.** ``request_stop`` / a host loss /
  a straggler changes the gang's future, so it bumps ``_gen`` and
  schedules a superseding completion; a stale event checks the
  generation and no-ops.

The work model: a gang at full width retires ``1/est_step_time_s``
steps per virtual second, scaled by ``width/full_width`` when an
elastic gang shrinks and by ``straggle_factor`` while any rank is a
named straggler.  Progress (``steps_done``) lives on the PERSISTENT
job record in the hub, not on the placement — an evicted gang's
relaunch resumes exactly where the snapshot agreement left it, which
is what makes ``*_steps_lost == 0`` an invariant the metrics pass can
assert rather than assume.

The simulated gang writes NOTHING to its fleet journal or the ledger:
the rows under test are the control plane's own (``sched_*`` /
``heal_*``), and an absent ``fleet.jsonl`` short-circuits the
scheduler's orphan sweep exactly like a first launch does live.
"""

from __future__ import annotations

import math
import os
import threading

from distributedtensorflowexample_tpu_torch.resilience.fleet import (
    GangResult, RankLostError)


class SimGang:
    """One placement of one job.  Mimics the ``FleetSupervisor``
    surface the Scheduler reads; all mutation happens on the scheduler
    thread (factory call, scripted events, ``request_stop``) or is a
    plain read from the gang thread."""

    def __init__(self, hub, job_id: str, num_ranks: int, *,
                 elastic: bool, policy, wall_timeout_s: float):
        self.hub = hub
        self.job_id = job_id
        self.full_width = num_ranks
        self.ranks = list(range(num_ranks))
        self.lost_ranks: list[int] = []
        self.stragglers: list[int] = []
        self.elastic = elastic
        self.policy = policy
        self.wall_timeout_s = wall_timeout_s
        # run()/completion rendezvous (see module docstring).
        self._entered = threading.Event()
        self._done = threading.Event()
        self._thread: threading.Thread | None = None
        self._result = None          # GangResult | BaseException
        self._stopped = False
        # Work model state (all virtual-time).
        self._gen = 0                # completion-event generation
        self._rate_t = 0.0           # virtual ts of the last rate change
        self._started = False        # past startup, accruing steps
        self._up_at = 0.0            # virtual ts startup latency ends
        self._restarts = 0
        self._recoverable: list[int] = []

    # --- the FleetSupervisor surface ----------------------------------

    def run(self, argv, name="", snapshot_dir_template="",
            stdout_dir="", env_extra=None, agree_first=False):
        """Block until the hub delivers this placement's outcome.
        The scheduler's _run wrapper catches the raise; everything
        else about the placement already happened synchronously."""
        self._thread = threading.current_thread()
        self._entered.set()
        self._done.wait()
        if isinstance(self._result, BaseException):
            raise self._result
        return self._result

    def request_stop(self, reason: str = "") -> None:
        """Clean TERM→snapshot→143 stop: freeze progress now, retire
        the pending completion, and schedule the unanimous-143 exit
        after the scripted teardown latency."""
        if self._stopped or self._done.is_set():
            return
        self._stopped = True
        self.hub.on_request_stop(self, reason)

    def probe_lost_ranks(self, argv) -> list[int]:
        """Non-mutating recovery probe: which lost ranks would answer
        again (scripted by ``host_recover`` events)."""
        return [r for r in self._recoverable if r in self.lost_ranks]


class SimFleetFactory:
    """The spawn-seam injectable: callable with ``FleetSupervisor``'s
    constructor signature.  Parses the job id from the scheduler's
    per-job workdir (``.../jobs/<job>/fleet``) and hands the gang to
    the hub, which schedules its completion synchronously."""

    def __init__(self, hub):
        self.hub = hub

    def __call__(self, num_ranks, *, policy=None, journal=None,
                 heartbeat_timeout_s=0.0, wall_timeout_s=0.0,
                 kill_grace_s=0.0, poll_s=0.05, seed=0, elastic=False,
                 worker_tiled=False, workdir="", ledger_path="",
                 reprobe_on_relaunch=True):
        job_id = os.path.basename(os.path.dirname(
            os.path.abspath(workdir or "job")))
        gang = SimGang(self.hub, job_id, num_ranks, elastic=elastic,
                       policy=policy, wall_timeout_s=wall_timeout_s)
        self.hub.on_place(gang)
        return gang


class FleetHub:
    """Owns every live gang + per-job persistent progress; translates
    scenario events into gang futures.  Single-threaded by contract:
    every method runs on the scheduler thread (factory calls and
    ``request_stop`` from the tick loop, event callbacks from the
    virtual sleep)."""

    #: request_stop → unanimous-143 latency when the scenario doesn't
    #: script one (also the env override for drills).
    TEARDOWN_S = float(os.environ.get("SIM_TEARDOWN_S", "1.0"))

    def __init__(self, clock, queue, scenario):
        self.clock = clock
        self.queue = queue
        self.scenario = scenario
        self.gangs: dict[str, SimGang] = {}     # job id -> LIVE gang
        self.steps_done: dict[str, float] = {
            j.job: 0.0 for j in scenario.jobs}
        self.jobs = {j.job: j for j in scenario.jobs}
        #: (job, steps credited at done) — the metrics pass proves
        #: credited == job.steps, i.e. zero steps lost to evictions.
        self.done_credits: dict[str, float] = {}
        #: Snapshot world model (``snapshot_loss`` events): which ranks
        #: have lost their shard since the last quorum-valid step, the
        #: step the fleet agreement would fall back to if redundancy
        #: runs out, and the tallies the harness surfaces when a
        #: scenario scripts any loss.  Mirrors resilience/shardstore:
        #: a loss WITHIN redundancy is a reconstruction (no progress
        #: impact); losses at or past ``SNAPSHOT_REDUNDANCY`` roll the
        #: job back to the quorum floor and re-run the gap — time is
        #: lost, steps are re-earned, ``steps_lost()`` stays 0.
        self.shard_losses: dict[str, set] = {}
        self.quorum_floor: dict[str, int] = {}
        self.snap_stats = {"losses": 0, "reconstructs": 0, "rollbacks": 0}
        self.snapshot_redundancy = max(
            1, int(os.environ.get("SNAPSHOT_REDUNDANCY", "") or 2))

    # --- work model ----------------------------------------------------

    def _knobs(self, job_id: str) -> dict:
        return self.scenario.sim_jobs[job_id]

    def _rate(self, gang: SimGang) -> float:
        """Steps per virtual second, given current width/stragglers."""
        job = self.jobs[gang.job_id]
        rate = 1.0 / job.est_step_time_s
        if gang.full_width:
            rate *= len(gang.ranks) / gang.full_width
        if gang.stragglers:
            rate *= self._knobs(gang.job_id)["straggle_factor"]
        return rate

    def _settle(self, gang: SimGang) -> None:
        """Credit progress accrued since the last rate change at the
        OLD rate; call before every rate/width/future change."""
        now = self.clock.now()
        if gang._started and not gang._done.is_set():
            dt = max(0.0, now - gang._rate_t)
            job = self.jobs[gang.job_id]
            self.steps_done[gang.job_id] = min(
                float(job.steps),
                self.steps_done[gang.job_id] + dt * self._rate(gang))
        gang._rate_t = now

    def _reschedule(self, gang: SimGang) -> None:
        """Retire the pending completion (generation bump) and push a
        fresh one from current progress at the current rate."""
        gang._gen += 1
        gen = gang._gen
        job = self.jobs[gang.job_id]
        remaining = float(job.steps) - self.steps_done[gang.job_id]
        rate = self._rate(gang)
        if rate <= 0 or not gang.ranks:
            return          # a widthless gang makes no progress
        lead = (0.0 if gang._started
                else max(0.0, gang._up_at - self.clock.now()))
        eta = self.clock.now() + lead + remaining / rate
        self.queue.push(
            eta, lambda: self._complete(gang, gen, "ok"),
            label=f"done:{gang.job_id}")

    # --- gang lifecycle ------------------------------------------------

    def on_place(self, gang: SimGang) -> None:
        """Factory-call time (synchronous, scheduler thread): register
        the placement, mark startup, schedule its natural completion."""
        self.gangs[gang.job_id] = gang
        gang._rate_t = self.clock.now()
        knobs = self._knobs(gang.job_id)
        gang._up_at = self.clock.now() + knobs["startup_s"]
        self._reschedule(gang)
        # Startup latency ends once; after it the gang accrues steps.
        gen = gang._gen

        def _up():
            if gang._gen == gen and not gang._done.is_set():
                gang._started = True
                gang._rate_t = self.clock.now()
        self.queue.push(gang._up_at, _up, label=f"up:{gang.job_id}")

    def on_request_stop(self, gang: SimGang, reason: str) -> None:
        self._settle(gang)
        # Snapshot agreement floors progress to a whole step — the
        # relaunch resumes from an agreed step, not a fraction — and
        # TERM'd ranks stop stepping, so no progress accrues during
        # teardown.
        self.steps_done[gang.job_id] = math.floor(
            self.steps_done[gang.job_id])
        gang._started = False
        gang._gen += 1
        gen = gang._gen
        teardown = self._knobs(gang.job_id).get(
            "teardown_s", self.TEARDOWN_S)
        self.queue.push(
            self.clock.now() + teardown,
            lambda: self._complete(gang, gen, "evicted"),
            label=f"stop:{gang.job_id}")

    def _complete(self, gang: SimGang, gen: int, status: str,
                  result=None) -> None:
        """Deliver the placement outcome to the blocked gang thread
        and join it (see the determinism protocol)."""
        if gang._gen != gen or gang._done.is_set():
            return                              # superseded
        self._settle(gang)
        job = self.jobs[gang.job_id]
        if result is None:
            if status == "ok":
                self.steps_done[gang.job_id] = float(job.steps)
                self.done_credits[gang.job_id] = float(job.steps)
                rcs = {r: 0 for r in gang.ranks}
            else:                               # evicted (clean 143s)
                rcs = {r: 143 for r in gang.ranks}
            result = GangResult(
                status, 1, gang._restarts, 0,
                [int(self.steps_done[gang.job_id])], rcs,
                list(gang.ranks), [])
        gang._result = result
        if self.gangs.get(gang.job_id) is gang:
            del self.gangs[gang.job_id]
        # The gang thread must have entered run() by now — _launch
        # starts it before the tick loop ever sleeps.  The wait is
        # wall-clock but bounds only delivery latency, never virtual
        # order.
        if not gang._entered.wait(timeout=30.0):
            raise RuntimeError(
                f"sim gang {gang.job_id}: fleet thread never entered "
                f"run() — scheduler wiring broke")
        gang._done.set()
        if gang._thread is not None:
            gang._thread.join(timeout=30.0)
            if gang._thread.is_alive():
                raise RuntimeError(
                    f"sim gang {gang.job_id}: fleet thread failed to "
                    f"exit after result delivery")

    # --- scripted world events ----------------------------------------

    def apply(self, ev) -> None:
        """Fire one scenario event against the current fleet.  Events
        addressing a job with no live gang no-op (the storm outran the
        placement) — the scenario scripts the WORLD, and a dead host
        in an empty rack is weather, not an error."""
        gang = self.gangs.get(ev.job)
        if gang is None or gang._done.is_set():
            return
        if ev.kind == "host_loss":
            rank = ev.rank if ev.rank is not None else gang.ranks[-1]
            if rank not in gang.ranks:
                return
            self._settle(gang)
            if not gang.elastic:
                # Non-elastic: the placement is lost; the scheduler's
                # reap turns this into a budgeted retry.
                gang._gen += 1
                gen = gang._gen
                self.queue.push(
                    self.clock.now(),
                    lambda: self._complete(
                        gang, gen, "lost",
                        result=RankLostError(
                            rank, 1, "host_down",
                            f"rank {rank} lost: scripted host loss")),
                    label=f"lost:{ev.job}")
                return
            gang.ranks = [r for r in gang.ranks if r != rank]
            gang.lost_ranks = gang.lost_ranks + [rank]
            gang._restarts += 1
            self._reschedule(gang)
        elif ev.kind == "host_recover":
            if ev.rank in gang.lost_ranks \
                    and ev.rank not in gang._recoverable:
                gang._recoverable = gang._recoverable + [ev.rank]
        elif ev.kind == "straggler":
            rank = ev.rank if ev.rank is not None else gang.ranks[0]
            if rank in gang.stragglers:
                return
            self._settle(gang)
            gang.stragglers = gang.stragglers + [rank]
            self._reschedule(gang)
        elif ev.kind == "straggler_clear":
            if ev.rank not in gang.stragglers:
                return
            self._settle(gang)
            gang.stragglers = [r for r in gang.stragglers
                               if r != ev.rank]
            self._reschedule(gang)
        elif ev.kind == "gang_crash":
            self._settle(gang)
            retries = gang.policy.retries if gang.policy else 0
            gang._gen += 1
            gen = gang._gen
            rcs = {r: 1 for r in gang.ranks}
            res = GangResult(
                "exhausted", retries + 1, retries, 0,
                [int(self.steps_done[gang.job_id])], rcs,
                list(gang.ranks),
                [f"gang attempt {retries + 1}: crash (scripted)"])
            self.queue.push(
                self.clock.now(),
                lambda: self._complete(gang, gen, "exhausted",
                                       result=res),
                label=f"crash:{ev.job}")
        elif ev.kind == "gang_wedge":
            self._settle(gang)
            gang._gen += 1
            gen = gang._gen
            rcs = {r: (3 if r == gang.ranks[0] else 143)
                   for r in gang.ranks}
            res = GangResult(
                "wedged", 1, gang._restarts, 0,
                [int(self.steps_done[gang.job_id])], rcs,
                list(gang.ranks),
                ["rank reported backend wedged (rc 3, scripted)"])
            self.queue.push(
                self.clock.now(),
                lambda: self._complete(gang, gen, "wedged", result=res),
                label=f"wedge:{ev.job}")
        elif ev.kind == "snapshot_loss":
            rank = ev.rank if ev.rank is not None else gang.ranks[0]
            self._settle(gang)
            lost = self.shard_losses.setdefault(ev.job, set())
            if not lost:
                # First loss since the last intact set: the newest
                # quorum-valid step is frozen HERE — ring mirrors cover
                # further losses until redundancy runs out.
                self.quorum_floor[ev.job] = math.floor(
                    self.steps_done[ev.job])
            lost.add(rank)
            self.snap_stats["losses"] += 1
            if len(lost) >= self.snapshot_redundancy:
                # Past redundancy: the newest shard set is
                # unrecoverable.  Roll the job back to the quorum floor
                # and relaunch through the scheduler — the gap re-runs,
                # so the rollback costs TIME, never credited steps.
                self.snap_stats["rollbacks"] += 1
                self.steps_done[ev.job] = min(
                    self.steps_done[ev.job],
                    float(self.quorum_floor.pop(ev.job, 0)))
                lost.clear()
                gang.request_stop("snapshot_loss")
            else:
                # Within redundancy: the mirror rebuilds the shard
                # out-of-band; training never notices.
                self.snap_stats["reconstructs"] += 1
        else:
            raise ValueError(f"unhandled scenario event {ev.kind!r}")

    def steps_lost(self) -> float:
        """Across every job that finished: steps the job was credited
        minus steps it was asked to run.  The snapshot-resume contract
        says this is EXACTLY zero."""
        return sum(float(self.jobs[j].steps) - credited
                   for j, credited in self.done_credits.items())
