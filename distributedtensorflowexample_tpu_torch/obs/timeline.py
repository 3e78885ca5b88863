"""Cross-rank timeline: merge per-rank telemetry into one step-aligned
view, export it as Perfetto/Chrome-trace JSON, decompose step time.

(a copy of the JAX package's stdlib-only ``obs/timeline.py``.)

Inputs (all tolerant of gaps — a fleet postmortem is exactly the moment
some rank's file is missing or torn):

- **flight files** (``flight_<rank>_<pid>.json``, obs/recorder.py):
  the span ring plus run identity and the metrics snapshot;
- **trace JSONL** (``OBS_TRACE_FILE``, obs/trace.py): every span event,
  unbounded — the high-fidelity source when a run exported one;
- **supervisor/fleet journals** (JSON lines with wall ``ts``):
  gang/rank lifecycle + anomaly annotations, rendered as instant
  markers on the merged timeline.

Clock model (the round-10 fix that makes the merge possible): every
span event carries BOTH ``t0_s`` (monotonic — honest durations, but a
per-boot epoch incomparable across processes) and ``t0_unix`` (wall —
shared on a host, NTP-close across one).  The merge places events by
wall time and keeps monotonic durations.  Events from BEFORE the fix
carry only ``t0_s``; :func:`calibrate` recovers their wall stamps from
any sibling event in the same process that has both (one stamped event
calibrates the whole monotonic series — offset = t0_unix - t0_s is a
per-boot constant), and counts the events no sibling could place.

Stdlib-only like the rest of obs/ — tools/obs_report.py renders these
merges on a box mid-outage with nothing but a Python interpreter.
"""

from __future__ import annotations

import glob
import json
import os
import re

_FLIGHT_RANK_RE = re.compile(r"flight_(\d+)_\d+\.json$")
# The collective series-key shape MetricsHook writes (shared: tools/
# obs_report.py renders the same gauges — one parser, no drift).
COLL_SERIES_RE = re.compile(
    r'^collective_(ops|bytes)_per_step\{op="([^"]+)"\}$')

# Span names that are per-step anatomy categories (see step_anatomy):
# checkpoint/snapshot both mean "serialize state" (CheckpointHook vs
# resilience SnapshotStore) — one column.
_SNAPSHOT_SPANS = ("snapshot", "checkpoint")


def _rank_key(rank):
    """Type-stable sort key: OBS_RANK need not be numeric (trace._context
    and the flight writer both keep e.g. "chief" as-is), so ranks of
    mixed int/str must sort without a TypeError mid-outage — ints first
    in numeric order, then strings, None last."""
    if rank is None:
        return (2, "", 0)
    if isinstance(rank, str):
        return (1, rank, 0)
    return (0, "", rank)


# --- loading ---------------------------------------------------------------

def _norm(ev: dict, src: str, rank=None, attempt=None, pid=None) -> dict:
    """Normalize one span event: identity fields resolved (event-level
    context wins over source-level — a trace file may interleave
    attempts), source recorded for provenance."""
    out = dict(ev)
    out["rank"] = ev.get("rank", rank)
    out["attempt"] = ev.get("attempt", attempt)
    out["pid"] = ev.get("pid", pid)
    out["src"] = src
    return out


def events_from_flight(flight: dict, src: str = "") -> list[dict]:
    return [_norm(ev, src or f"flight:{flight.get('pid')}",
                  rank=flight.get("rank"), attempt=flight.get("attempt"),
                  pid=flight.get("pid"))
            for ev in flight.get("spans") or [] if isinstance(ev, dict)]


def events_from_trace_file(path: str) -> tuple[list[dict], int]:
    """(events, torn_lines) — a trace JSONL whose writer died mid-line
    loses that line, not the file."""
    events, torn = [], 0
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return [], 0
    for line in lines:
        if not line.strip():
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            torn += 1
            continue
        if isinstance(ev, dict) and "name" in ev:
            events.append(_norm(ev, f"trace:{os.path.basename(path)}"))
    return events, torn


def journal_records(path: str) -> tuple[list[dict], int]:
    """(records, torn) — same tolerant JSONL read the journal's own
    replay uses."""
    records, torn = [], 0
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return [], 0
    for line in lines:
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            torn += 1
    return records, torn


def per_rank_collectives(flight: dict) -> dict:
    """{op: {"ops": n, "bytes": b}} from the flight's per-step
    collective gauges (OBS_COLLECTIVES=1 runs) — the anatomy table's
    collective column."""
    out: dict = {}
    for key, g in (flight.get("metrics") or {}).get("gauges", {}).items():
        m = COLL_SERIES_RE.match(key)
        if m:
            out.setdefault(m.group(2), {})[
                "ops" if m.group(1) == "ops" else "bytes"] = g.get("value")
    return out


# --- calibration -----------------------------------------------------------

def calibrate(events: list[dict]) -> int:
    """Fill missing ``t0_unix`` in place from per-process monotonic->wall
    offsets (keyed by (src, pid): one boot epoch per process).  Returns
    how many events NO sibling could place — the merge reports them
    instead of silently dropping lanes."""
    offsets: dict = {}
    for ev in events:
        if ev.get("t0_unix") is not None and ev.get("t0_s") is not None:
            offsets.setdefault((ev["src"], ev.get("pid")),
                               ev["t0_unix"] - ev["t0_s"])
    unplaced = 0
    for ev in events:
        if ev.get("t0_unix") is None:
            off = offsets.get((ev["src"], ev.get("pid")))
            if off is not None and ev.get("t0_s") is not None:
                ev["t0_unix"] = round(ev["t0_s"] + off, 6)
            else:
                unplaced += 1
    return unplaced


# --- the merge -------------------------------------------------------------

def merge(flight_paths=(), trace_paths=(), journal_paths=(),
          health_paths=()) -> dict:
    """Merge every readable source into one timeline dict::

        {"events":   [span events, wall-ordered, rank/attempt labeled],
         "markers":  [journal records with wall ts],
         "health":   [health.json payloads],
         "collectives": {rank: {op: {"ops", "bytes"}}},
         "coverage": {"ranks_present", "ranks_expected", "ranks_missing",
                      "unreadable": {path: error}, "torn_lines": n,
                      "uncalibrated_events": n}}

    Tolerant by contract (the ISSUE's torn-flight satellite): an
    unreadable flight costs ITS lane plus a coverage entry, never the
    report."""
    events: list[dict] = []
    markers: list[dict] = []
    health: list[dict] = []
    collectives: dict = {}
    unreadable: dict = {}
    torn_lines = 0
    present: set = set()
    expected: set = set()

    for path in flight_paths:
        m = _FLIGHT_RANK_RE.search(os.path.basename(path))
        if m:
            expected.add(int(m.group(1)))
        try:
            with open(path) as f:
                flight = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            unreadable[path] = str(e)
            continue
        events.extend(events_from_flight(
            flight, src=f"flight:{os.path.basename(path)}"))
        rank = flight.get("rank")
        if rank is not None:
            present.add(rank)
            coll = per_rank_collectives(flight)
            if coll:
                collectives[rank] = coll
    for path in trace_paths:
        evs, torn = events_from_trace_file(path)
        events.extend(evs)
        torn_lines += torn
        present.update(ev["rank"] for ev in evs
                       if ev.get("rank") is not None)
    for path in journal_paths:
        records, torn = journal_records(path)
        torn_lines += torn
        for rec in records:
            if rec.get("ts") is not None:
                markers.append(rec)
            if rec.get("event") == "gang_start":
                expected.update(rec.get("ranks") or [])
    for path in health_paths:
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            unreadable[path] = str(e)
            continue
        if isinstance(payload, dict):
            payload["src"] = os.path.basename(path)
            health.append(payload)

    # Dedup across sources: a run with both OBS_DIR and OBS_TRACE_FILE
    # writes every span close to the flight ring AND the trace JSONL —
    # the same close must land on the timeline once, or anatomy totals
    # double and the tie-out against loop_*_seconds_total breaks.  The
    # identity tuple is everything a close stamps that BOTH writers
    # carry (pid lands only in flight payloads, so it can't be part of
    # identity); at µs monotonic precision two distinct spans of one
    # rank/attempt cannot collide on it.  First occurrence wins —
    # flights load first, so the pid-carrying copy is the one kept.
    seen: set = set()
    unique = []
    for ev in events:
        key = (ev.get("rank"), ev.get("attempt"), ev.get("name"),
               ev.get("t0_s"), ev.get("dur_s"), ev.get("step"))
        if key in seen:
            continue
        seen.add(key)
        unique.append(ev)
    events = unique
    uncalibrated = calibrate(events)
    events.sort(key=lambda ev: (ev.get("t0_unix") is None,
                                ev.get("t0_unix") or 0.0,
                                ev.get("t0_s") or 0.0))
    markers.sort(key=lambda r: r.get("ts") or 0.0)
    return {"events": events, "markers": markers, "health": health,
            "collectives": collectives,
            "coverage": {
                "ranks_present": sorted(present, key=_rank_key),
                "ranks_expected": sorted(expected | present,
                                         key=_rank_key),
                "ranks_missing": sorted(expected - present,
                                        key=_rank_key),
                "unreadable": unreadable,
                "torn_lines": torn_lines,
                "uncalibrated_events": uncalibrated}}


def fleet_dir_sources(flight_dir: str = "", journal: str = "",
                      trace_glob: str = "") -> dict:
    """Discover a fleet run's sources: flights + per-rank/fleet
    health.json next to the flight dir and the journal."""
    flights = (sorted(glob.glob(os.path.join(flight_dir, "flight_*.json")))
               if flight_dir else [])
    health: list[str] = []
    for base in {flight_dir, os.path.dirname(journal)} - {""}:
        health += sorted(glob.glob(os.path.join(base, "health*.json")))
    base_name = os.path.basename(flight_dir.rstrip(os.sep))
    if base_name == "flight" or base_name.endswith("_flight"):
        # ONLY the documented layouts reach one level up: the fleet
        # puts health files in the WORKDIR with flights in
        # <workdir>/flight, and supervise --capture archives flights in
        # <journal>_flight/ next to the journal.  An arbitrary --dir
        # (or the journal's parent) must never widen the glob — a
        # flight dir directly under /tmp would merge some other
        # process's /tmp/health*.json into this report.
        parent = os.path.dirname(flight_dir.rstrip(os.sep))
        if parent:
            health += sorted(glob.glob(os.path.join(parent,
                                                    "health*.json")))
    traces = sorted(glob.glob(trace_glob)) if trace_glob else []
    return {"flight_paths": flights, "trace_paths": traces,
            "journal_paths": [journal] if journal else [],
            "health_paths": sorted(set(health))}


# --- Perfetto / Chrome-trace export ---------------------------------------

_FLEET_LANE = 9999      # pid lane for rank-less events (fleet, bench)
_SLOT_TRACK_BASE = 1000  # tid offset for serving decode-slot tracks


def chrome_trace(merged: dict) -> dict:
    """Chrome-trace JSON (the dialect Perfetto and chrome://tracing both
    load): one process lane per rank, complete events for spans, instant
    events for journal markers.  ``ts`` is microseconds from the
    earliest wall stamp so the numbers stay readable."""
    events = [ev for ev in merged["events"]
              if ev.get("t0_unix") is not None]
    stamps = ([ev["t0_unix"] for ev in events]
              + [r["ts"] for r in merged["markers"]
                 if r.get("ts") is not None])
    base = min(stamps) if stamps else 0.0
    lanes: dict = {}
    out: list = []
    # Non-numeric ranks (OBS_RANK="chief" is legal everywhere upstream)
    # need int pids for Perfetto: deterministic lanes above the fleet
    # lane, in sorted order over every rank this merge carries.
    named = sorted({r for r in
                    ([ev.get("rank") for ev in events]
                     + [m.get("rank") for m in merged["markers"]])
                    if isinstance(r, str)})
    named_pid = {r: _FLEET_LANE + 1 + i for i, r in enumerate(named)}

    def _lane(rank, label: str):
        pid = (_FLEET_LANE if rank is None
               else named_pid[rank] if isinstance(rank, str)
               else int(rank))
        if pid not in lanes:
            lanes[pid] = True
            out.append({"ph": "M", "pid": pid, "name": "process_name",
                        "args": {"name": label}})
            out.append({"ph": "M", "pid": pid, "name": "process_sort_index",
                        "args": {"sort_index": pid}})
        return pid

    slot_tids: set = set()
    for ev in events:
        rank = ev.get("rank")
        pid = _lane(rank, "fleet / unranked" if rank is None
                    else f"rank {rank}")
        attempt = ev.get("attempt") or 0
        args = {k: v for k, v in ev.items()
                if k not in ("name", "t0_s", "t0_unix", "dur_s", "depth",
                             "parent", "pid", "src", "rank")}
        # Serving events carry a decode-slot attr: one Perfetto lane
        # PER SLOT (tid offset past the attempt tracks), so a worker's
        # request lifecycle (queue → prefill → decode) renders as slot
        # occupancy over time instead of interleaving on one row.
        slot = ev.get("slot")
        if isinstance(slot, int) and slot >= 0:
            tid = _SLOT_TRACK_BASE + slot
            if (pid, tid) not in slot_tids:
                slot_tids.add((pid, tid))
                out.append({"ph": "M", "pid": pid, "tid": tid,
                            "name": "thread_name",
                            "args": {"name": f"slot {slot}"}})
                out.append({"ph": "M", "pid": pid, "tid": tid,
                            "name": "thread_sort_index",
                            "args": {"sort_index": tid}})
        else:
            tid = int(attempt) if str(attempt).isdigit() else 0
        out.append({"ph": "X", "pid": pid,
                    # One track per attempt: restarts render as separate
                    # rows instead of interleaving with the run they
                    # replaced.  Same-track nesting comes from span
                    # containment, which the thread-local span stack
                    # guarantees within one attempt.
                    "tid": tid,
                    "name": str(ev.get("name")),
                    "ts": round((ev["t0_unix"] - base) * 1e6, 1),
                    "dur": round((ev.get("dur_s") or 0.0) * 1e6, 1),
                    "args": args})
    for rec in merged["markers"]:
        if rec.get("ts") is None:
            continue
        rank = rec.get("rank")
        pid = _lane(rank, "fleet / unranked" if rank is None
                    else f"rank {rank}")
        out.append({"ph": "i", "pid": pid, "tid": 0, "s": "p",
                    "name": str(rec.get("event")),
                    "ts": round((rec["ts"] - base) * 1e6, 1),
                    "args": {k: v for k, v in rec.items()
                             if k not in ("ts", "event")}})
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"base_unix": base,
                          "coverage": merged["coverage"]}}


# --- step anatomy ----------------------------------------------------------

def step_anatomy(merged: dict) -> list[dict]:
    """Per-window step-time decomposition from the ``steps`` span events
    (training/hooks.MetricsHook emits one per log boundary, carrying the
    TrainLoop category counters' deltas) plus snapshot/checkpoint spans
    contained in each window.

    Row: {rank, attempt, step_from, step_to, n, window_s, input_s,
    compute_s, hook_s, snapshot_s, other_s, collective_ops,
    collective_bytes}.  Category semantics (DESIGN.md §16): ``input`` =
    host batch fetch, ``compute`` = the train-step call (dispatch +
    compute + collective wait — XLA fuses them; the collective columns
    carry the compiled schedule's per-step op/byte counts instead of a
    time this pin cannot separate), ``hook`` = after_step hooks minus
    the snapshot spans broken out, ``other`` = logging + loop
    bookkeeping (the window remainder).  Totals tie out against the
    ``loop_*_seconds_total`` counters — gated in tests."""
    spans = [ev for ev in merged["events"] if ev.get("name") == "steps"
             and ev.get("dur_s") is not None]
    snap_spans = [ev for ev in merged["events"]
                  if ev.get("name") in _SNAPSHOT_SPANS
                  and ev.get("t0_unix") is not None]
    rows = []
    for ev in spans:
        rank, attempt = ev.get("rank"), ev.get("attempt")
        n = ev.get("n") or 0
        window = ev["dur_s"]
        t0, t1 = ev.get("t0_unix"), None
        if t0 is not None:
            t1 = t0 + window
        snapshot_s = sum(
            s.get("dur_s") or 0.0 for s in snap_spans
            if s.get("rank") == rank and s.get("attempt") == attempt
            and t0 is not None
            and t0 - 1e-6 <= s["t0_unix"] <= t1 + 1e-6)
        input_s = ev.get("input_s")
        compute_s = ev.get("compute_s")
        hook_s = ev.get("hook_s")
        other_s = None
        if None not in (input_s, compute_s, hook_s):
            other_s = max(0.0, window - input_s - compute_s - hook_s)
        coll = merged["collectives"].get(rank) or {}
        ops = sum(d.get("ops") or 0 for d in coll.values())
        nbytes = sum(d.get("bytes") or 0 for d in coll.values())
        rows.append({
            "rank": rank, "attempt": attempt,
            "step_from": (ev.get("step") - n if ev.get("step") is not None
                          else None),
            "step_to": ev.get("step"), "n": n,
            "t0_unix": t0,
            "window_s": round(window, 6),
            "input_s": input_s, "compute_s": compute_s,
            "hook_s": (None if hook_s is None
                       else round(max(0.0, hook_s - snapshot_s), 6)),
            "snapshot_s": round(snapshot_s, 6),
            "other_s": None if other_s is None else round(other_s, 6),
            "collective_ops": ops * n if coll else None,
            "collective_bytes": nbytes * n if coll else None})
    rows.sort(key=lambda r: (_rank_key(r["rank"]),
                             r["attempt"] or 0,
                             r["t0_unix"] or 0.0))
    return rows


def anatomy_totals(rows: list[dict]) -> dict:
    """Per-category sums over anatomy rows (the tie-out side: compare
    against the flight's ``loop_*_seconds_total`` counters)."""
    tot = {"window_s": 0.0, "input_s": 0.0, "compute_s": 0.0,
           "hook_s": 0.0, "snapshot_s": 0.0, "other_s": 0.0,
           "collective_ops": 0, "collective_bytes": 0, "n": 0}
    for row in rows:
        for k in tot:
            v = row.get(k)
            if v is not None:
                tot[k] = round(tot[k] + v, 6)
    return tot
