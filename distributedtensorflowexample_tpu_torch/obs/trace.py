"""Nestable trace spans with supervisor context, emitted as JSONL events
(a copy of the JAX package's ``obs/trace.py`` over the port's
``obs/metrics.py``).

One event per closed span::

    {"name": "snapshot", "t0_s": 12.345678, "t0_unix": 1753900000.123456,
     "dur_s": 0.004321, "depth": 1, "parent": "steps", "step": 40,
     "attempt": 1, "phase": "full_bench"}

- ``t0_s``/``dur_s`` are monotonic-clock seconds (same clock as the
  metrics registry, so spans and metric snapshots line up);
  ``t0_unix`` is the SAME instant on the wall clock.  Both are
  deliberate: monotonic is the honest duration/ordering axis inside one
  process, but its epoch is per-boot — two ranks' monotonic stamps are
  incomparable, which made cross-process alignment impossible before
  round 10.  The wall stamp is what obs/timeline.py merges N ranks'
  events on (derived once at close from the shared ``_wall`` seam, so a
  pinned-clock test still gets bitwise-stable dumps).
- ``attempt``/``phase`` are propagated from the environment the
  supervisor exports (``SUPERVISE_ATTEMPT``; ``OBS_PHASE`` is set per
  capture-queue task), read at span close — a child never has to thread
  supervisor identity through its own call stack, which is exactly how
  the capture journal and the telemetry stay in agreement.
- Nesting is a thread-local stack: ``depth``/``parent`` come from the
  enclosing ``span`` on the same thread.

Sinks: every event goes to each registered sink (the flight recorder
registers itself on install) and, when ``OBS_TRACE_FILE`` names a path,
is appended there as one JSON line.  Span close is NOT a hot path —
spans wrap phases, snapshot writes, and log-boundary windows, never the
per-step dispatch — so the per-event env lookups and the append-open
are deliberate simplicity, not an oversight.  Sink exceptions are
swallowed: telemetry must never kill the run it observes.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading

from distributedtensorflowexample_tpu_torch.obs import metrics as _metrics

_tls = threading.local()
_sinks: list = []
_SPAN_SECONDS = _metrics.histogram(
    "span_seconds", "wall seconds per closed trace span")


def add_sink(sink) -> None:
    """Register ``sink(event: dict)`` for every future event."""
    if sink not in _sinks:
        _sinks.append(sink)


def remove_sink(sink) -> None:
    if sink in _sinks:
        _sinks.remove(sink)


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _context() -> dict:
    ctx = {}
    attempt = os.environ.get("SUPERVISE_ATTEMPT")
    if attempt:
        try:
            ctx["attempt"] = int(attempt)
        except ValueError:
            ctx["attempt"] = attempt
    phase = os.environ.get("OBS_PHASE")
    if phase:
        ctx["phase"] = phase
    # Rank context (OBS_RANK: fleet supervisor / distributed trainers):
    # spans from N ranks of one gang land in N flight files, and the
    # per-rank timeline obs_report renders needs each event to say
    # whose it is without joining on pid.
    rank = os.environ.get("OBS_RANK")
    if rank:
        try:
            ctx["rank"] = int(rank)
        except ValueError:
            ctx["rank"] = rank
    return ctx


def event(name: str, dur_s: float, t0_s: float | None = None,
          **attrs) -> dict:
    """Emit one span event without the context manager (hooks that
    measure a boundary-to-boundary window synthesize events this way).
    Returns the event dict (tests and callers may inspect it)."""
    stack = _stack()
    now = _metrics._now()
    if t0_s is None:
        t0_s = now - dur_s
    rec = {"name": name,
           "t0_s": round(t0_s, 6),
           # The same open instant on the wall clock: wall-now minus the
           # monotonic elapsed-since-open.  Computed at CLOSE (not open)
           # so the synthesized-event path (hooks that only know a
           # duration) gets the identical stamp semantics for free.
           "t0_unix": round(_metrics._wall() - (now - t0_s), 6),
           "dur_s": round(dur_s, 6),
           "depth": len(stack),
           "parent": stack[-1] if stack else None,
           **_context(), **attrs}
    _SPAN_SECONDS.labels(name=name).observe(dur_s)
    for sink in list(_sinks):
        try:
            sink(rec)
        except Exception:
            pass
    path = os.environ.get("OBS_TRACE_FILE")
    if path:
        try:
            # default=str: a span attr the caller forgot to convert (a
            # numpy/jax scalar in the yielded attrs dict) serializes as
            # its string form instead of raising TypeError out of
            # span.__exit__ — and the broad except keeps the module
            # contract: telemetry must never kill the run it observes.
            with open(path, "a") as f:
                f.write(json.dumps(_metrics.json_safe(rec), sort_keys=True,
                                   allow_nan=False, default=str) + "\n")
        except Exception:
            pass
    return rec


@contextlib.contextmanager
def span(name: str, **attrs):
    """``with span("dispatch", step=7) as a: ...`` — yields the attr
    dict so the body can add results post-hoc (``a["rc"] = 0``)."""
    stack = _stack()
    stack.append(name)
    t0 = _metrics._now()
    try:
        yield attrs
    finally:
        stack.pop()
        event(name, _metrics._now() - t0, t0_s=t0, **attrs)
