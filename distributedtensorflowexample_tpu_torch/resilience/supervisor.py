# graftlint: stdlib-only
"""Supervised recovery: heartbeat watchdog, bounded retries with jittered
exponential backoff, and a journaled priority task queue (the JAX
package's ``resilience/supervisor.py``; pure Python, so the port's copy
differs only in the modules it reports through).

The supervisor runs any entrypoint as a child in its OWN process group
and watches two liveness signals:

- a **wall deadline** (an outer ``timeout``'s shape, but with SIGTERM +
  grace before SIGKILL, so a trainer's SIGTERM handler can save);
- a **heartbeat file** the child touches at step boundaries
  (training/hooks.HeartbeatHook, which the port's Engine installs when
  ``SUPERVISE_HEARTBEAT`` is exported): a slow-but-alive run keeps
  touching, a wedged step stops — the one failure a wall deadline alone
  either kills too early or notices too late.

Exit-code protocol (the JAX package's, shared with the trainers):

====  ====================================================================
rc    meaning / supervisor reaction
====  ====================================================================
0     done — task complete
143   preempted-with-save (SIGTERM honored, checkpoint written) —
      restart immediately; the child's own ``--resume`` picks up the
      latest snapshot
3     watchdog: backend provably wedged — do NOT retry; surface
      "wedged" so a task queue can stop burning its window on
      device-bound work
else  crash — retry with jittered exponential backoff, bounded
====  ====================================================================

The task queue runs tasks in priority order, journals every state
change (JSON lines, append-only), and a supervisor restarted after its
own death replays the journal and resumes exactly where the previous one
died.  The journal's file format is the JAX package's, so a journal
written by either package replays in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import subprocess
import sys
import time
from typing import Callable

from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
from distributedtensorflowexample_tpu_torch.obs import metrics as obs_metrics
from distributedtensorflowexample_tpu_torch.obs import recorder as obs_recorder
from distributedtensorflowexample_tpu_torch.obs import trace as obs_trace
from distributedtensorflowexample_tpu_torch.utils.signals import (
    installed_signal_handler)

RC_PREEMPTED = 143   # SIGTERM honored, state saved (the trainers)
RC_WEDGED = 3        # a watchdog's verdict: backend provably wedged

# Child-lifecycle telemetry (obs/).  The heartbeat-age
# gauge is the live "how close is this child to the kill line" signal;
# the kill counter is labeled by escalation reason.
_ATTEMPTS = obs_metrics.counter(
    "supervisor_attempts_total", "child attempts spawned")
_EXITS = obs_metrics.counter(
    "supervisor_child_exits_total",
    "child attempt outcomes, by rc classification")
_KILLS = obs_metrics.counter(
    "supervisor_kills_total", "watchdog group-kills, by reason")
_HB_AGE = obs_metrics.gauge(
    "supervisor_heartbeat_age_seconds",
    "age of the child's newest heartbeat at the last poll")

# Clean preemptions don't consume the crash-retry budget (each one saved
# state and resumes further along — dropping the run after N of them
# would abandon progressing work); this absolute ceiling only backstops
# a pathological preempt storm that never lets an attempt finish.
MAX_PREEMPTIONS = 1000


def _log(msg: str) -> None:
    print(f"supervise: {msg}", file=sys.stderr, flush=True)


def kill_process_group(proc: subprocess.Popen, grace_s: float) -> None:
    """SIGTERM the whole group, grace, then SIGKILL — THE one escalation,
    shared by the single-child supervisor and
    the fleet gang teardown (resilience/fleet.py) so the grace
    semantics — the window a trainer's SIGTERM handler has to write its
    final checkpoint — can't drift between the two."""
    for sig in (signal.SIGTERM, signal.SIGKILL):
        try:
            os.killpg(proc.pid, sig)
        except (ProcessLookupError, PermissionError):
            pass
        try:
            proc.wait(timeout=grace_s)
            return
        except subprocess.TimeoutExpired:
            continue
    proc.wait()


def export_prometheus_collector(name: str = "supervise") -> str | None:
    """Write the metrics registry to ``$OBS_PROM_DIR/<name>.prom`` (the
    node-exporter textfile-collector dialect) — the round-7 ROADMAP
    leftover: ``obs.export.write_prometheus_textfile`` was wired and
    golden-tested but nothing periodic called it.  Now every completed
    supervisor task (and every fleet gang attempt) refreshes the
    collector file, so a scraper on the box sees attempt/kill/restart
    counters without any HTTP server to babysit.  No-op without
    OBS_PROM_DIR; never raises — telemetry must not kill the run."""
    directory = os.environ.get("OBS_PROM_DIR", "")
    if not directory:
        return None
    try:
        os.makedirs(directory, exist_ok=True)
        from distributedtensorflowexample_tpu_torch.obs import export as obs_export
        return obs_export.write_prometheus_textfile(
            os.path.join(directory, f"{name}.prom"))
    except Exception:
        return None


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retries with jittered exponential backoff.  Jitter is the
    fleet lesson: synchronized retry storms from N supervisors hitting a
    shared backend at the same instant look exactly like the outage they
    are recovering from."""

    retries: int = 3            # restarts after the first attempt
    backoff_base_s: float = 1.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 60.0
    jitter: float = 0.5         # +/- fraction of the computed delay

    def delay_s(self, attempt: int, rand01: float) -> float:
        base = min(self.backoff_max_s,
                   self.backoff_base_s * self.backoff_factor ** attempt)
        return max(0.0, base * (1.0 + self.jitter * (2.0 * rand01 - 1.0)))


@dataclasses.dataclass
class SupervisedResult:
    status: str                 # ok | wedged | exhausted
    returncode: int | None
    attempts: int
    reasons: list[str] = dataclasses.field(default_factory=list)


class Journal:
    """Append-only JSON-lines journal; replay() folds it back into the
    task-state map a restarted supervisor resumes from."""

    def __init__(self, path: str | None):
        self._path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)

    @property
    def path(self) -> str | None:
        return self._path

    def write(self, event: str, **fields) -> None:
        if not self._path:
            return
        # Through the obs/metrics.py wall seam, not bare time.time():
        # journal rows are the WAL the sim's virtual clock must pin, or
        # two same-seed sim runs differ in every ts field.
        rec = {"ts": round(obs_metrics._wall(), 3), "event": event,
               **fields}
        # Heal a torn tail BEFORE appending: a journal write that died
        # mid-line (or the journal_torn fault) leaves no trailing
        # newline, and appending straight onto the fragment would merge
        # it with THIS record into one unparseable line — replay would
        # then lose a live record, not just skip the dead fragment.
        heal = False
        try:
            with open(self._path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                heal = f.read(1) != b"\n"
        except (OSError, ValueError):
            pass    # missing or empty file: nothing to heal
        with open(self._path, "a") as f:
            if heal:
                f.write("\n")
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def events(self) -> list[dict]:
        """Every parseable record, in write order; torn lines skipped
        (the journal itself can die mid-write) — the shared read for
        :meth:`replay` and the fleet's agreement-replay pass."""
        out: list[dict] = []
        if not self._path or not os.path.exists(self._path):
            return out
        with open(self._path) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        return out

    def replay(self) -> dict:
        """{"done": set[str], "wedged": bool} from prior runs; torn tail
        lines are skipped, not fatal — the cost is re-running the task
        whose completion record tore, which is idempotent-by-design for
        every capture phase."""
        done: set[str] = set()
        wedged = False
        for rec in self.events():
            if rec.get("event") == "task_done":
                done.add(rec.get("task", ""))
            elif rec.get("event") == "chip_wedged":
                wedged = True
        return {"done": done, "wedged": wedged}


class Supervisor:
    def __init__(self, policy: RetryPolicy | None = None,
                 journal: Journal | None = None,
                 heartbeat_timeout_s: float = 0.0,
                 wall_timeout_s: float = 0.0,
                 kill_grace_s: float = 10.0,
                 poll_s: float = 0.2,
                 seed: int | None = None):
        self.policy = policy or RetryPolicy()
        self.journal = journal or Journal(None)
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.wall_timeout_s = wall_timeout_s
        self.kill_grace_s = kill_grace_s
        self.poll_s = poll_s
        self._rng = random.Random(seed)

    # --- one attempt ------------------------------------------------------
    def _escalated(self, why: str) -> None:
        """A watchdog kill is exactly the moment a postmortem matters:
        the CHILD is wedged (it can't dump its own flight), so the
        supervisor — the one process still alive and informed — counts
        the kill and dumps ITS flight (heartbeat-age gauge, attempt
        counters, span ring) if one is installed (tools/supervise.py)."""
        _KILLS.labels(why=why).inc()
        # final=False: the supervisor usually OUTLIVES the escalation
        # (retry loop, next queue task), and the atexit dump must still
        # refresh the flight with the true final state — a flight frozen
        # at attempt 1 of 3 would contradict the journal it cross-checks.
        obs_recorder.dump_global(f"escalation_{why}", final=False)

    def _kill_group(self, proc: subprocess.Popen) -> None:
        kill_process_group(proc, self.kill_grace_s)

    def _run_once(self, argv: list[str], env: dict, stdout_file,
                  stderr_file, heartbeat_path: str | None,
                  wall_timeout_s: float) -> tuple[int | None, str]:
        """Returns (returncode, reason) — returncode None on a watchdog
        kill (the child never exited on its own).  stdout and stderr are
        SEPARATE sinks on purpose: tool children (faultline) speak a
        pure JSON-lines protocol on fd 1 (a caller parses the LAST
        line), and stderr prose merged into that artifact would tear
        it."""
        if heartbeat_path:
            # A heartbeat file left by a PREVIOUS run (or attempt) has a
            # stale mtime; without this reset the first poll would read
            # it as a wedge and kill the fresh child before it can even
            # import torch.  Removing (not touching) routes the no-beat-yet
            # case through the measure-from-spawn fallback below.
            try:
                os.remove(heartbeat_path)
            except OSError:
                pass
        proc = subprocess.Popen(argv, env=env, stdout=stdout_file,
                                stderr=stderr_file,
                                start_new_session=True)
        # The child lives in its OWN session (so the watchdog's killpg
        # can't suicide the supervisor) — which means a SIGTERM aimed at
        # the SUPERVISOR's group (an operator's or a watcher's kill)
        # does not reach it.  Forward: on SIGTERM, kill the child group
        # and report, so a group-kill can never orphan a live
        # device-holding child behind a dead supervisor.
        sigterm_seen = []

        def _on_term(signum, frame):
            sigterm_seen.append(True)

        start = time.monotonic()
        with installed_signal_handler(signal.SIGTERM, _on_term):
            while True:
                rc = proc.poll()
                if rc is not None:
                    return rc, "exit"
                now = time.monotonic()
                if sigterm_seen:
                    _log(f"supervisor SIGTERM — forwarding to child group "
                         f"{proc.pid} and stopping")
                    self._kill_group(proc)
                    self._escalated("supervisor_sigterm")
                    return None, "supervisor_sigterm"
                if wall_timeout_s and now - start > wall_timeout_s:
                    _log(f"wall timeout {wall_timeout_s:.0f}s — killing "
                         f"group {proc.pid}")
                    self._kill_group(proc)
                    self._escalated("wall_timeout")
                    return None, "wall_timeout"
                if self.heartbeat_timeout_s and heartbeat_path:
                    # Armed only once the FIRST beat lands: heartbeat
                    # participation is the child's opt-in (the Engine
                    # and faultline install HeartbeatHook when
                    # SUPERVISE_HEARTBEAT is exported; other children
                    # may not).  Measuring from spawn instead would turn
                    # the heartbeat timeout into a hard wall clock for
                    # every beat-less child, and the start-up of a card
                    # child (torch import, CUDA context, kernel load)
                    # into a race against it.  A child wedged
                    # BEFORE its first beat is the wall timeout's job.
                    try:
                        hb_age = (time.time()
                                  - os.path.getmtime(heartbeat_path))
                    except OSError:
                        hb_age = None       # no first beat: not armed
                    if hb_age is not None:
                        _HB_AGE.set(round(hb_age, 3))
                    if (hb_age is not None
                            and hb_age > self.heartbeat_timeout_s):
                        _log(f"heartbeat stale {hb_age:.1f}s > "
                             f"{self.heartbeat_timeout_s:.0f}s — killing "
                             f"group {proc.pid} (wedged dispatch)")
                        self._kill_group(proc)
                        self._escalated("heartbeat_timeout")
                        return None, "heartbeat_timeout"
                time.sleep(self.poll_s)

    # --- the retry loop ---------------------------------------------------
    @staticmethod
    def _default_name(argv: list[str]) -> str:
        """First operand that names the actual work: skips interpreter
        wrappers, env assignments and flags, and resolves ``-m pkg.mod``
        to the module's last component — so the documented
        ``supervise.py -- python -m ...trainer_sync_mnist`` journals as
        task="trainer_sync_mnist", not task="-m"."""
        toks = list(argv)
        while toks:
            tok = toks.pop(0)
            base = os.path.basename(tok)
            if tok == "-m":
                return toks[0].rsplit(".", 1)[-1] if toks else "-m"
            if (tok.startswith("-") or "=" in tok or base == "env"
                    or base.startswith("python")):
                continue
            return base
        return os.path.basename(argv[0])

    def run(self, argv: list[str], name: str = "",
            stdout_path: str | None = None,
            stderr_path: str | None = None,
            heartbeat_path: str | None = None,
            env_extra: dict | None = None,
            wall_timeout_s: float | None = None) -> SupervisedResult:
        try:
            return self._run(argv, name, stdout_path, stderr_path,
                             heartbeat_path, env_extra, wall_timeout_s)
        finally:
            # Post-task collector refresh (OBS_PROM_DIR): the queue
            # calls run() once per task, so this IS "after every task"
            # — and a single supervised command gets the same export.
            export_prometheus_collector()

    def _run(self, argv: list[str], name: str = "",
             stdout_path: str | None = None,
             stderr_path: str | None = None,
             heartbeat_path: str | None = None,
             env_extra: dict | None = None,
             wall_timeout_s: float | None = None) -> SupervisedResult:
        name = name or self._default_name(argv)
        wall = (self.wall_timeout_s if wall_timeout_s is None
                else wall_timeout_s)
        reasons: list[str] = []
        last_rc: int | None = None
        attempt = -1
        failures = 0    # crash-budget counter; preemptions excluded
        while attempt < self.policy.retries + MAX_PREEMPTIONS:
            attempt += 1
            _ATTEMPTS.inc()
            env = dict(os.environ)
            # The attempt counter lets a child treat injected faults as
            # transient (fire on attempt 0 only) and lets logs attribute
            # output to the retry that produced it.
            env["SUPERVISE_ATTEMPT"] = str(attempt)
            # Telemetry context for the child's obs surface: spans and
            # flight dumps carry the task name as their phase (what
            # makes the capture journal and the telemetry agree), the
            # heartbeat-flap fault reads the exact watchdog edge, and
            # journal_torn finds the journal it tears.
            env.setdefault("OBS_PHASE", name)
            if self.heartbeat_timeout_s and heartbeat_path:
                # Exported only when a beat PATH exists too: the
                # watchdog never arms without one, and advertising an
                # edge no one is watching would let a heartbeat_flap
                # drill stall against nothing and claim success.
                env["SUPERVISE_HEARTBEAT_TIMEOUT_S"] = str(
                    self.heartbeat_timeout_s)
            if self.journal.path:
                env.setdefault("SUPERVISE_JOURNAL", self.journal.path)
            if heartbeat_path:
                env["SUPERVISE_HEARTBEAT"] = heartbeat_path
            if env_extra:
                env.update(env_extra)
            self.journal.write("attempt_start", task=name, attempt=attempt,
                               argv=argv)
            # Per-attempt ledger rows (OBS_LEDGER, inherited by the
            # child which writes its OWN run rows too): the supervisor
            # is the authoritative rc source — a SIGKILLed child never
            # gets to close its own row, this one always closes.
            # wall-ms in the id (the RunLedger/fleet idiom): the ledger
            # is append-only for months and a recycled pid would fold
            # two invocations' attempt rows into one run on read.
            ledger_run = (f"sup:{name}:a{attempt}:"
                          f"{int(obs_metrics._wall() * 1000):x}"
                          f"-{os.getpid()}")
            obs_ledger.log_event(
                "run_start", run=ledger_run, src="supervisor",
                entrypoint=name, attempt=attempt, pid=os.getpid())
            tmp = f"{stdout_path}.tmp" if stdout_path else None
            out = open(tmp, "wb") if tmp else None
            # Append mode: one log accumulates every attempt's prose.
            err = open(stderr_path, "ab") if stderr_path else None
            try:
                # No stdout artifact but a log sink: archive stdout in
                # the log too instead of dropping it.
                rc, reason = self._run_once(argv, env, out or err, err,
                                            heartbeat_path, wall)
            finally:
                if out:
                    out.close()
                if err:
                    err.close()
            if tmp:
                # keep() semantics: every line was
                # flushed as it completed, so a non-empty partial file is
                # a valid partial capture; an empty one must not clobber
                # a previous attempt's output.
                if os.path.getsize(tmp):
                    os.replace(tmp, stdout_path)
                else:
                    os.remove(tmp)
            self.journal.write("attempt_end", task=name, attempt=attempt,
                               rc=rc, reason=reason)
            obs_ledger.log_event("run_end", run=ledger_run,
                                 src="supervisor", rc=rc, reason=reason)
            _EXITS.labels(outcome=(
                "ok" if rc == 0 else
                "terminated" if reason == "supervisor_sigterm" else
                "wedged" if rc == RC_WEDGED else
                "preempted" if rc == RC_PREEMPTED else
                "killed" if rc is None else "crash")).inc()
            last_rc = rc
            reasons.append(f"attempt {attempt}: rc={rc} ({reason})")
            if rc == 0:
                return SupervisedResult("ok", 0, attempt + 1, reasons)
            if reason == "supervisor_sigterm":
                # The supervisor itself is being killed (watcher stale
                # sweep / operator): child group already TERM'd — no
                # retry, report terminated so the queue stops too.
                return SupervisedResult("terminated", rc, attempt + 1,
                                        reasons)
            if rc == RC_WEDGED:
                # The backend is provably gone; a retry burns window
                # wall time against a dead device and resolves nothing.
                _log(f"{name}: watchdog rc={RC_WEDGED} (backend wedged) — "
                     f"not retrying")
                return SupervisedResult("wedged", rc, attempt + 1, reasons)
            if rc == RC_PREEMPTED:
                # Clean preemption already saved and resumes further
                # along: restart now (the backoff exists for crash
                # storms) and do NOT charge the crash budget — N
                # preemptions across a long run must not abandon
                # progressing work as "exhausted".
                _log(f"{name}: rc={RC_PREEMPTED} (preempted, state "
                     f"saved); restarting")
                continue
            failures += 1
            if failures > self.policy.retries:
                break
            delay = self.policy.delay_s(failures - 1, self._rng.random())
            _log(f"{name}: rc={rc} ({reason}); retry "
                 f"{failures}/{self.policy.retries} in {delay:.2f}s")
            if delay:
                time.sleep(delay)
        return SupervisedResult("exhausted", last_rc, attempt + 1, reasons)


@dataclasses.dataclass
class Task:
    """One queue entry.  ``priority``: lower runs first.
    ``needs_chip``: skipped once a wedge verdict lands (the device is
    gone).  ``gate``: zero-arg predicate checked at pop time.  ``pre`` /
    ``post``: callables run before the task and after an ok result."""

    name: str
    argv: list[str]
    priority: int = 0
    stdout_path: str | None = None
    stderr_path: str | None = None
    wall_timeout_s: float = 0.0
    needs_chip: bool = True
    env: dict = dataclasses.field(default_factory=dict)
    heartbeat_path: str | None = None
    gate: Callable[[], bool] | None = None
    pre: Callable[[], None] | None = None
    post: Callable[[], None] | None = None


class TaskQueue:
    """Journaled priority queue over a Supervisor.  Replays the journal
    at start: tasks already recorded done are skipped, and a recorded
    wedge verdict keeps device-bound tasks skipped — resume exactly where
    the previous supervisor died."""

    def __init__(self, tasks: list[Task], supervisor: Supervisor):
        self._tasks = sorted(tasks, key=lambda t: t.priority)
        self._sup = supervisor

    def run(self) -> dict:
        state = self._sup.journal.replay()
        done, chip_dead = state["done"], state["wedged"]
        results: dict[str, str] = {}
        for task in self._tasks:
            if task.name in done:
                _log(f"{task.name}: already done (journal) — skipping")
                results[task.name] = "done_prior"
                continue
            if chip_dead and task.needs_chip:
                self._sup.journal.write("task_skipped", task=task.name,
                                        why="chip wedged")
                results[task.name] = "skipped_wedged"
                continue
            if task.gate is not None and not task.gate():
                self._sup.journal.write("task_skipped", task=task.name,
                                        why="gate")
                results[task.name] = "skipped_gate"
                continue
            if task.pre is not None:
                task.pre()
            with obs_trace.span("task", task=task.name) as attrs:
                res = self._sup.run(task.argv, name=task.name,
                                    stdout_path=task.stdout_path,
                                    stderr_path=task.stderr_path,
                                    heartbeat_path=task.heartbeat_path,
                                    env_extra=task.env,
                                    wall_timeout_s=task.wall_timeout_s)
                attrs["status"] = res.status
                attrs["attempts"] = res.attempts
            if res.status == "ok":
                if task.post is not None:
                    task.post()
                self._sup.journal.write("task_done", task=task.name)
                results[task.name] = "done"
            elif res.status == "terminated":
                # The supervisor is dying (SIGTERM forwarded to the
                # child); no capture_end is journaled, so the NEXT
                # window's supervisor resumes from this exact task.
                results[task.name] = "terminated"
                break
            elif res.status == "wedged":
                chip_dead = True
                self._sup.journal.write("chip_wedged", task=task.name)
                self._sup.journal.write("task_failed", task=task.name,
                                        rc=res.returncode)
                results[task.name] = "wedged"
            else:
                # Keep going: later tasks run after a non-wedge
                # failure (each task's partial output is already
                # kept).
                self._sup.journal.write("task_failed", task=task.name,
                                        rc=res.returncode)
                results[task.name] = "failed"
        return results
