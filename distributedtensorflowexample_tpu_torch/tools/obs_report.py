# graftlint: stdlib-only
"""obs_report — render flight-recorder telemetry as OUTAGE_r*-style markdown
(the JAX package's ``tools/obs_report.py`` on the port's ``obs/``; its
output is byte-identical to the JAX tool's on the same files).

  python -m distributedtensorflowexample_tpu_torch.tools.obs_report \
      /tmp/flight_1234.json
  python -m distributedtensorflowexample_tpu_torch.tools.obs_report \
      --dir /tmp/supervise_flight --journal /tmp/supervise.jsonl
  # cross-rank Perfetto trace (load at ui.perfetto.dev or
  # chrome://tracing): one lane per rank, one track per attempt
  python -m distributedtensorflowexample_tpu_torch.tools.obs_report \
      --dir /tmp/fleet/flight --journal /tmp/fleet/fleet.jsonl \
      --format trace > fleet.trace.json
  # machine-readable merge (events + anatomy + health + coverage)
  python -m distributedtensorflowexample_tpu_torch.tools.obs_report \
      --dir /tmp/fleet/flight --format json

Reads the ``flight_<pid>.json`` dumps the obs recorder leaves behind
(one per dead run; see ``obs/recorder.py``) and prints, per file: run
identity (pid/rank/attempt/phase/reason), the counter table, gauges,
the last spans, and the loss-tape tail.  With ``--journal`` it also
renders the supervisor journal's attempt history — and, for fleet
journals (``resilience/fleet.py``), a per-rank timeline: which rank
died first, what tore the gang down, which step the restart agreed on.

Every invocation also MERGES the sources into one cross-rank
wall-clock-aligned timeline (``obs/timeline.py``) — ``--format trace``
exports it as Perfetto/Chrome-trace JSON, ``--format json`` as the raw
merge, and the default markdown gains a coverage section (which ranks
are present, which flights are missing or torn — a fleet postmortem
renders the ranks it HAS and lists the gaps instead of failing), a
per-step anatomy table (input / compute / hook / snapshot / other +
the collective schedule), and a health section from any
``health*.json`` found next to the sources.

Stdlib-only and read-only (it imports neither torch nor JAX): safe to
run on the box mid-outage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from distributedtensorflowexample_tpu_torch.obs import timeline as obs_timeline


def _table(headers: list[str], rows: list[list]) -> list[str]:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join("---" for _ in headers) + "|"]
    out += ["| " + " | ".join(str(c) for c in row) + " |" for row in rows]
    return out


def _fmt_num(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


# One parser for the collective series-key shape (obs/timeline.py owns
# it — per_rank_collectives parses the same gauges out of flights).
_COLL_SERIES = obs_timeline.COLL_SERIES_RE


def render_collectives(counters: dict, gauges: dict) -> list[str]:
    """Wire-traffic section from the per-step collective inventory the
    trainer armed (OBS_COLLECTIVES=1 — utils/profiling.collective_
    inventory through MetricsHook): the per-op schedule plus cumulative
    totals, so a postmortem answers "what was this run's collective
    schedule" without recompiling anything.  Empty when the run carried
    no collective accounting."""
    per_op: dict[str, dict] = {}
    for key, g in gauges.items():
        m = _COLL_SERIES.match(key)
        if m:
            per_op.setdefault(m.group(2), {})[m.group(1)] = g.get("value")
    out: list[str] = []
    if per_op:
        out += _table(["op", "per step", "bytes/step"],
                      [[f"`{op}`", _fmt_num(d.get("ops", "")),
                        _fmt_num(d.get("bytes", ""))]
                       for op, d in sorted(per_op.items())])
    totals = [(k, counters[k]) for k in
              ("collective_ops_total", "collective_bytes_total")
              if k in counters]
    if totals:
        out += [""] if out else []
        out += [f"- **{k}**: {_fmt_num(v)}" for k, v in totals]
    return out


def render_flight(path: str, flight: dict, max_spans: int = 12,
                  max_loss: int = 8) -> str:
    lines = [f"## Flight — `{os.path.basename(path)}`", ""]
    meta = [("reason", flight.get("reason")),
            ("pid", flight.get("pid")),
            ("rank", flight.get("rank")),
            ("attempt", flight.get("attempt")),
            ("phase", flight.get("phase")),
            ("start_unix", flight.get("start_unix")),
            ("argv", " ".join(flight.get("argv", []) or []) or None)]
    meta += sorted((flight.get("notes") or {}).items())
    lines += [f"- **{k}**: {v}" for k, v in meta if v is not None]

    metrics = flight.get("metrics") or {}
    counters = metrics.get("counters") or {}
    if counters:
        lines += ["", "### Counters", ""]
        lines += _table(["counter", "value"],
                        [[f"`{k}`", _fmt_num(v)]
                         for k, v in sorted(counters.items())])
    gauges = metrics.get("gauges") or {}
    if gauges:
        ts = metrics.get("monotonic_ts")
        lines += ["", "### Gauges", ""]
        rows = []
        for k, g in sorted(gauges.items()):
            age = ("" if ts is None or g.get("monotonic_ts") is None
                   else f"{ts - g['monotonic_ts']:.3f}")
            rows.append([f"`{k}`", _fmt_num(g.get("value")), age])
        lines += _table(["gauge", "value", "age_s"], rows)

    coll = render_collectives(counters, gauges)
    if coll:
        lines += ["", "### Collectives", ""] + coll

    spans = flight.get("spans") or []
    if spans:
        lines += ["", f"### Last spans ({min(len(spans), max_spans)} of "
                      f"{len(spans)} recorded)", ""]
        rows = []
        for ev in spans[-max_spans:]:
            extra = {k: v for k, v in ev.items()
                     if k not in ("name", "t0_s", "dur_s", "depth",
                                  "parent", "attempt", "phase")}
            rows.append([f"`{ev.get('name')}`", ev.get("step", ""),
                         _fmt_num(ev.get("dur_s", "")),
                         ev.get("phase", ""),
                         " ".join(f"{k}={v}" for k, v in sorted(
                             extra.items()) if k != "step")])
        lines += _table(["span", "step", "dur_s", "phase", "attrs"], rows)

    loss = flight.get("loss_tail") or []
    if loss:
        lines += ["", f"### Loss tail (last {min(len(loss), max_loss)} of "
                      f"{len(loss)} recorded)", ""]
        lines += _table(["step", "loss"],
                        [[s, _fmt_num(v)] for s, v in loss[-max_loss:]])
    return "\n".join(lines)


def _journal_records(path: str):
    """(records, torn_count) — torn lines are what replay skips."""
    records, torn = [], 0
    with open(path) as f:
        for line in f:
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                torn += 1
    return records, torn


def render_journal(path: str) -> str:
    lines = [f"## Supervisor journal — `{os.path.basename(path)}`", ""]
    rows = []
    try:
        records, torn = _journal_records(path)
    except OSError as e:
        return "\n".join(lines + [f"- unreadable: {e}"])
    for rec in records:
        rows.append([rec.get("event", ""), rec.get("task", ""),
                     rec.get("rank", ""), rec.get("attempt", ""),
                     rec.get("rc", ""),
                     rec.get("reason", rec.get("why", ""))])
    for _ in range(torn):
        rows.append(["(torn line — skipped on replay)", "", "", "", "", ""])
    lines += _table(["event", "task", "rank", "attempt", "rc", "reason"],
                    rows)
    return "\n".join(lines)


_FLEET_EVENTS = ("gang_start", "rank_exit", "rank_lost", "gang_teardown",
                 "gang_end", "resume_agreement", "fleet_end")


def render_fleet_timeline(path: str) -> str:
    """Per-rank timeline of a fleet run (resilience/fleet.py journal):
    who died first, what tore the gang down, what step the restart
    agreed on — the questions a multi-process postmortem starts with.
    Empty string when the journal has no fleet events (single-child
    supervisor journals skip the section)."""
    try:
        records, _ = _journal_records(path)
    except OSError:
        return ""
    events = [r for r in records if r.get("event") in _FLEET_EVENTS]
    if not events:
        return ""
    t0 = events[0].get("ts") or 0
    rows = []
    for r in events:
        ev = r["event"]
        if ev == "gang_start":
            detail = (f"ranks {r.get('ranks')}, resume_step "
                      f"{r.get('resume_step')}")
        elif ev == "rank_exit":
            detail = f"rc={r.get('rc')}" + (
                f" ({r['reason']})" if r.get("reason") else "")
        elif ev == "rank_lost":
            detail = r.get("error", "")
        elif ev == "gang_teardown":
            detail = r.get("why", "")
        elif ev == "gang_end":
            detail = f"{r.get('outcome')}: {r.get('why')}"
        elif ev == "resume_agreement":
            # journal keys are strings: sort ranks numerically so a
            # 12-rank fleet doesn't render 0, 1, 10, 11, 2, ...
            per = r.get("per_rank") or {}
            detail = ("agreed step " + str(r.get("agreed")) + "; " +
                      ", ".join(f"rank {k}: {v}" for k, v in sorted(
                          per.items(),
                          key=lambda kv: (not str(kv[0]).isdigit(),
                                          int(kv[0])
                                          if str(kv[0]).isdigit()
                                          else str(kv[0])))))
        else:   # fleet_end
            detail = (f"attempts={r.get('attempts')} "
                      f"restarts={r.get('restarts')}")
        ts = r.get("ts")
        rows.append([("" if ts is None else f"{ts - t0:+.3f}"),
                     r.get("rank", ""), r.get("attempt", ""), f"`{ev}`",
                     detail])
    lines = [f"## Per-rank timeline — `{os.path.basename(path)}`", ""]
    lines += _table(["t_s", "rank", "attempt", "event", "detail"], rows)
    return "\n".join(lines)


def render_coverage(merged: dict) -> str:
    """The gap list (the torn-flight satellite): which ranks the merge
    HAS, which it expected but could not read — rendered, never raised."""
    cov = merged["coverage"]
    lines = ["## Merged timeline", "",
             f"- **span events**: {len(merged['events'])} "
             f"(+{len(merged['markers'])} journal markers)",
             f"- **ranks present**: {cov['ranks_present'] or 'none'}"]
    if cov["ranks_missing"]:
        lines.append(f"- **ranks MISSING** (expected from the journal / "
                     f"flight names, nothing readable): "
                     f"{cov['ranks_missing']}")
    for path, err in sorted(cov["unreadable"].items()):
        lines.append(f"- **unreadable**: `{os.path.basename(path)}` — "
                     f"{err}")
    if cov["torn_lines"]:
        lines.append(f"- **torn JSONL lines skipped**: "
                     f"{cov['torn_lines']}")
    if cov["uncalibrated_events"]:
        lines.append(f"- **events without a wall stamp** (pre-round-10 "
                     f"writer, no calibratable sibling): "
                     f"{cov['uncalibrated_events']}")
    return "\n".join(lines)


def render_anatomy(rows: list[dict]) -> str:
    """Per-step anatomy (obs/timeline.step_anatomy): where each logged
    window's wall time went, per rank/attempt."""
    if not rows:
        return ""
    lines = ["## Step anatomy (per logged window)", ""]
    table_rows = []
    for r in rows:
        table_rows.append([
            r.get("rank", ""), r.get("attempt", ""),
            (f"{r['step_from']}..{r['step_to']}"
             if r.get("step_from") is not None else r.get("step_to", "")),
            r.get("n", ""), _fmt_num(r.get("window_s", "")),
            _fmt_num(r.get("input_s") if r.get("input_s") is not None
                     else ""),
            _fmt_num(r.get("compute_s") if r.get("compute_s") is not None
                     else ""),
            _fmt_num(r.get("hook_s") if r.get("hook_s") is not None
                     else ""),
            _fmt_num(r.get("snapshot_s", "")),
            _fmt_num(r.get("other_s") if r.get("other_s") is not None
                     else ""),
            _fmt_num(r.get("collective_ops") or ""),
            _fmt_num(r.get("collective_bytes") or "")])
    lines += _table(["rank", "att", "steps", "n", "window_s", "input_s",
                     "compute_s", "hook_s", "snap_s", "other_s",
                     "coll_ops", "coll_bytes"], table_rows)
    tot = obs_timeline.anatomy_totals(rows)
    lines += ["", "- **totals**: " + ", ".join(
        f"{k}={_fmt_num(v)}" for k, v in sorted(tot.items()))]
    return "\n".join(lines)


def render_ledger(path: str) -> str:
    """Run-ledger section (obs/ledger.py RUNS.jsonl): the run table —
    entrypoint, attempts, outcome, anomalies — next to the flights and
    journal those runs left, plus the fleet's resume agreements.
    Unreadable/missing renders as a note, never a raise (the report
    must come out mid-outage)."""
    from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
    lines = [f"## Run ledger — `{os.path.basename(path)}`", ""]
    if not os.path.exists(path) and not os.path.exists(path + ".1"):
        return "\n".join(lines + [f"- unreadable: {path} does not exist"])
    folded = obs_ledger.runs(path)
    table = obs_ledger.run_table(path, folded=folded)
    rows = [[r["run"], r["entrypoint"], r["rank"], r["attempt"],
             r["outcome"], r["final_step"], r["samples"],
             r["anomalies"] or ""] for r in table]
    lines += _table(["run", "entrypoint", "rank", "att", "outcome",
                     "step", "samples", "anomalies"],
                    [[("" if c is None else c) for c in row]
                     for row in rows])
    agreements = [e for e in folded["events"]
                  if e.get("event") == "resume_agreement"]
    for a in agreements:
        lines.append(f"- **resume agreement**: step {a.get('agreed')} "
                     f"(per-rank {a.get('per_rank')}, discarded "
                     f"{a.get('discarded')})")
    if folded["torn"]:
        lines.append(f"- **torn ledger lines skipped**: {folded['torn']}")
    return "\n".join(lines)


def render_health(payloads: list[dict]) -> str:
    """Health section: fleet aggregates first (stragglers + why), then
    per-rank detector flags that fired."""
    if not payloads:
        return ""
    lines = ["## Health", ""]
    for h in sorted(payloads, key=lambda p: (p.get("kind") != "fleet",
                                             p.get("rank") or 0)):
        src = h.get("src", "")
        if h.get("kind") == "fleet":
            skew = h.get("skew") or {}
            lines.append(f"- **fleet** (`{src}`): stragglers "
                         f"{h.get('stragglers') or 'none'}, max step "
                         f"{skew.get('max_step')}, lag {skew.get('lag_steps')}")
            for r, why in sorted((skew.get("why") or {}).items()):
                lines.append(f"  - rank {r}: {why}")
        else:
            fired = {k: f for k, f in (h.get("flags") or {}).items()
                     if f.get("firing") or f.get("fired_step") is not None}
            lines.append(
                f"- **rank {h.get('rank')}** (`{src}`): step "
                f"{h.get('step')}, "
                + (", ".join(f"{k} fired@{f.get('fired_step')}"
                             for k, f in sorted(fired.items()))
                   or "no flags"))
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("flights", nargs="*",
                   help="flight_<pid>.json files to render")
    p.add_argument("--dir", default="",
                   help="also render every flight_*.json in this "
                        "directory (OBS_DIR of the run)")
    p.add_argument("--journal", default="",
                   help="supervisor JSONL journal to render alongside")
    p.add_argument("--format", default="md",
                   choices=["md", "json", "trace"],
                   help="md: OUTAGE-style markdown (default); trace: "
                        "Perfetto/Chrome-trace JSON of the cross-rank "
                        "merge; json: the raw merge + anatomy rows")
    p.add_argument("--trace_glob", default="",
                   help="glob of OBS_TRACE_FILE JSONLs to merge in "
                        "(higher-fidelity than the flights' bounded "
                        "span rings)")
    p.add_argument("--health", action="append", default=[],
                   help="extra health.json files to merge (those next "
                        "to --dir/--journal are discovered)")
    p.add_argument("--ledger", default="",
                   help="run ledger (RUNS.jsonl, obs/ledger.py) to "
                        "render as a run table alongside the flights "
                        "and journal")
    p.add_argument("--max_spans", type=int, default=12)
    p.add_argument("--max_loss", type=int, default=8)
    args = p.parse_args(argv)

    sources = obs_timeline.fleet_dir_sources(
        flight_dir=args.dir, journal=args.journal,
        trace_glob=args.trace_glob)
    sources["flight_paths"] = sorted(set(sources["flight_paths"])
                                     | set(args.flights))
    sources["health_paths"] = sorted(set(sources["health_paths"])
                                     | set(args.health))
    if not sources["flight_paths"] and not sources["health_paths"] \
            and not args.journal and not args.trace_glob \
            and not args.ledger:
        p.error("nothing to render: pass flight files, --dir, "
                "--trace_glob, --health, --ledger, or --journal")
    merged = obs_timeline.merge(**sources)

    if args.format == "trace":
        json.dump(obs_timeline.chrome_trace(merged), sys.stdout)
        print()
        return 0
    anatomy = obs_timeline.step_anatomy(merged)
    if args.format == "json":
        json.dump({"coverage": merged["coverage"],
                   "events": merged["events"],
                   "markers": merged["markers"],
                   "health": merged["health"],
                   "collectives": {str(k): v for k, v in
                                   merged["collectives"].items()},
                   "anatomy": anatomy,
                   "anatomy_totals": obs_timeline.anatomy_totals(anatomy)},
                  sys.stdout, default=str)
        print()
        return 0

    sections = ["# Telemetry report", ""]
    for path in sorted(sources["flight_paths"]):
        try:
            with open(path) as f:
                flight = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            sections.append(f"## Flight — `{os.path.basename(path)}`\n\n"
                            f"- unreadable: {e} (rendered the rest — "
                            f"see Merged timeline for the gap list)")
            continue
        sections.append(render_flight(path, flight,
                                      max_spans=args.max_spans,
                                      max_loss=args.max_loss))
    sections.append(render_coverage(merged))
    for section in (render_anatomy(anatomy),
                    render_health(merged["health"]),
                    render_ledger(args.ledger) if args.ledger else ""):
        if section:
            sections.append(section)
    if args.journal:
        timeline = render_fleet_timeline(args.journal)
        if timeline:
            sections.append(timeline)
        sections.append(render_journal(args.journal))
    print("\n\n".join(sections))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
