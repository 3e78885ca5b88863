"""Bounded in-memory flight recorder — every dead run leaves a postmortem
(a copy of the JAX package's stdlib-only ``obs/recorder.py``; the port's
Engine, ``training/hooks.MetricsHook`` and ``serving/serve_lm.py`` feed
and dump it, and ``resilience/shardstore.py`` writes through
:func:`atomic_write`).

The recorder rings the last N trace spans, metric-registry deltas, and
the loss-tape tail, and dumps the lot — plus a full registry snapshot —
atomically (tmp, fsync, rename) to ``flight_<pid>.json`` in ``OBS_DIR``
(default: the system temp dir).  Dump triggers, mirroring how runs on
this box actually die:

- **SIGTERM** (``install(sigterm=True)``): chained ONLY when the
  process has no handler of its own (disposition is SIG_DFL) — a
  cooperative trainer's ``sigterm_flag`` takes precedence inside its
  scope, and those paths dump explicitly (``dump_global("preempted")``)
  before exiting 143.
- **NaN-guard / fault trip**: ``NaNGuardHook`` dumps before raising, so
  the poisoned-loss evidence survives the process it kills.
- **Supervisor escalation**: the supervisor dumps its OWN flight when
  it kills a child group (wall/heartbeat) — the one process that still
  can when the child is wedged in a dead dispatch.
- **atexit**: any exit without a prior dump (crash with a traceback,
  clean finish) writes one with reason ``exit``.

The dump is canonical JSON (sorted keys, fixed indent): re-serializing
the parsed content reproduces the exact bytes, and every RING field
(spans, deltas, loss tail, notes, identity) is captured at record time
— so dumps are reproducible up to the one dump-time field, the registry
snapshot's monotonic clock stamp (tests pin full bitwise stability
under a pinned clock).  That is what makes flight files diffable
across attempts: everything that differs is a real difference or a
timestamp, never dict-ordering noise.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import signal
import sys
import tempfile
import threading

from distributedtensorflowexample_tpu_torch.obs import metrics as _metrics
from distributedtensorflowexample_tpu_torch.obs import trace as _trace

FLIGHT_VERSION = 1


def atomic_write(path: str, data: bytes) -> None:
    """tmp/fsync/rename: the file either exists complete or not at all.
    THE one implementation for the obs formats (flight dumps, exporter
    textfiles; resilience snapshots delegate here too) — a torn-write
    fix must not need applying twice.  A FAILED write unlinks its tmp
    before re-raising: the disk-full-survival path retries every
    snapshot interval, and leaking one partial tmp per retry onto the
    already-full filesystem would guarantee it never saves again."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def env_opted_in() -> bool:
    """OBS_FLIGHT truthiness — one parse shared by every entrypoint, so
    the same value can't arm the recorder in one CLI and silently not
    in another."""
    return os.environ.get("OBS_FLIGHT", "").lower() in (
        "1", "true", "t", "yes", "y")


def flight_dir() -> str:
    return os.environ.get("OBS_DIR") or tempfile.gettempdir()


def flight_path(pid: int | None = None) -> str:
    """``flight_<pid>.json`` — or ``flight_<rank>_<pid>.json`` when the
    process has a rank (``OBS_RANK``, exported by the fleet supervisor
    and by distributed trainers from their resolved ``ClusterInfo``):
    N ranks of one gang attempt may recycle pids across restarts, and a
    multi-process postmortem must never have two ranks' flights collide
    on (or be attributed by) pid alone."""
    pid = os.getpid() if pid is None else pid
    rank = os.environ.get("OBS_RANK", "")
    name = f"flight_{rank}_{pid}.json" if rank else f"flight_{pid}.json"
    return os.path.join(flight_dir(), name)


class FlightRecorder:
    def __init__(self, max_spans: int = 256, max_deltas: int = 64,
                 max_loss: int = 256,
                 registry: _metrics.MetricsRegistry | None = None):
        self._spans = collections.deque(maxlen=max_spans)
        self._deltas = collections.deque(maxlen=max_deltas)
        self._loss = collections.deque(maxlen=max_loss)
        self._registry = registry or _metrics.registry()
        self._notes: dict = {}
        # Through the _wall seam (not time.time directly): a test that
        # pins both clocks gets bitwise-stable dumps INCLUDING the
        # wall-stamped span events the satellite fix added.
        self._start_unix = round(_metrics._wall(), 3)
        self._attempt = os.environ.get("SUPERVISE_ATTEMPT")
        self._phase = os.environ.get("OBS_PHASE")
        self._rank = os.environ.get("OBS_RANK")
        self.dumped = False

    # --- record (ring) ----------------------------------------------------
    def record_span(self, event: dict) -> None:
        self._spans.append(event)

    def record_loss(self, step: int, loss: float) -> None:
        self._loss.append([int(step), float(loss)])

    def record_delta(self, delta: dict) -> None:
        self._deltas.append(delta)

    def note(self, **fields) -> None:
        """Attach run facts (model, workdir, ...) to the postmortem."""
        self._notes.update(fields)

    # --- dump -------------------------------------------------------------
    def payload(self, reason: str) -> dict:
        def _as_int(v):
            if v is None:
                return None
            try:
                return int(v)
            except ValueError:
                return v

        return {"version": FLIGHT_VERSION,
                "reason": reason,
                "pid": os.getpid(),
                "argv": list(sys.argv),
                "start_unix": self._start_unix,
                "attempt": _as_int(self._attempt),
                "rank": _as_int(self._rank),
                "phase": self._phase,
                "notes": dict(self._notes),
                "spans": list(self._spans),
                "loss_tail": list(self._loss),
                "metric_deltas": list(self._deltas),
                "metrics": self._registry.snapshot()}

    def dump(self, reason: str = "manual", path: str | None = None,
             final: bool = True) -> str:
        """Atomic: a postmortem format must not have its own torn-write
        failure mode.  ``final=False`` is for MID-RUN dumps (supervisor
        escalations between attempts): the file is written but the
        recorder is not marked terminally dumped, so the atexit dump
        still refreshes it with the process's true final state — a
        flight that stopped at attempt 1 of 3 would contradict the very
        journal it exists to cross-check."""
        path = path or flight_path()
        # The dump dir may not exist yet (a fleet child inherits an
        # OBS_DIR its supervisor named but never had to create): a
        # postmortem silently lost to ENOENT — dump_global swallows the
        # OSError — is the one failure mode this module must not have.
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # default=str: a foreign scalar (numpy/jax) in a span attr or
        # note serializes as its string form — one forgotten cast must
        # not cost the whole postmortem (dump_global would swallow the
        # TypeError and the run would die with no flight at all).
        atomic_write(path,
                     json.dumps(_metrics.json_safe(self.payload(reason)),
                                sort_keys=True, indent=1,
                                allow_nan=False, default=str
                                ).encode() + b"\n")
        if final:
            self.dumped = True
        return path


_GLOBAL: FlightRecorder | None = None


def get() -> FlightRecorder | None:
    return _GLOBAL


def install(sigterm: bool = True) -> FlightRecorder:
    """Create (idempotently) the process-wide recorder: subscribe it to
    trace events, arm the atexit dump, and — when ``sigterm`` and no
    handler is installed — chain a dump onto SIGTERM before dying by
    the signal's default disposition (so the wait-status stays honest)."""
    global _GLOBAL
    if _GLOBAL is not None:
        return _GLOBAL
    rec = _GLOBAL = FlightRecorder()
    _trace.add_sink(rec.record_span)
    atexit.register(_atexit_dump)
    if (sigterm
            and threading.current_thread() is threading.main_thread()
            and signal.getsignal(signal.SIGTERM) == signal.SIG_DFL):
        signal.signal(signal.SIGTERM, _sigterm_dump_and_die)
    return rec


def maybe_install(sigterm: bool = True) -> FlightRecorder | None:
    """Arm the recorder iff this run should leave postmortems: under a
    supervisor (SUPERVISE_ATTEMPT / SUPERVISE_HEARTBEAT exported) or an
    explicit OBS_FLIGHT opt-in.  THE one arming predicate — every CLI
    entrypoint (trainers, bench family, faultline, supervise) consults
    it, so the rule can't drift per entrypoint."""
    if (os.environ.get("SUPERVISE_ATTEMPT")
            or os.environ.get("SUPERVISE_HEARTBEAT")
            or env_opted_in()):
        return install(sigterm=sigterm)
    return None


def dump_global(reason: str, final: bool = True) -> str | None:
    """Dump the installed recorder; None (never a raise) when there is
    none or the write fails — telemetry must not kill the run."""
    if _GLOBAL is None:
        return None
    try:
        return _GLOBAL.dump(reason, final=final)
    except Exception:
        return None


def _atexit_dump() -> None:
    if _GLOBAL is not None and not _GLOBAL.dumped:
        dump_global("exit")


def _sigterm_dump_and_die(signum, frame) -> None:
    dump_global("sigterm")
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)
