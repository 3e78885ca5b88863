# graftlint: stdlib-only
"""obs_query — cross-run queries over the run ledger: list runs, show
one, diff two, and explain a job's scheduler decisions (the JAX
package's ``tools/obs_query.py`` on the port's ``obs/``; its output is
byte-identical to the JAX tool's on the same ledger).

  # what ran (and how it ended), newest last:
  python -m distributedtensorflowexample_tpu_torch.tools.obs_query \
      list --ledger /tmp/fleet/RUNS.jsonl
  # only trainer runs that crashed:
  python -m distributedtensorflowexample_tpu_torch.tools.obs_query \
      list --ledger RUNS.jsonl --entrypoint trainer --outcome rc
  # everything the ledger knows about one run (start/samples/end):
  python -m distributedtensorflowexample_tpu_torch.tools.obs_query \
      show --ledger RUNS.jsonl 19fc2-1234
  # config + metric deltas between two runs (id prefixes resolve):
  python -m distributedtensorflowexample_tpu_torch.tools.obs_query \
      diff --ledger RUNS.jsonl 19fc2 19fd8
  # why did the scheduler preempt/shrink/quarantine this job
  # (tools.schedule's and tools.sim_run's sched_*/heal_* rows):
  python -m distributedtensorflowexample_tpu_torch.tools.obs_query \
      why bench1 --ledger /tmp/sched/RUNS.jsonl
  # the measurement records, per family per round:
  python -m distributedtensorflowexample_tpu_torch.tools.obs_query \
      trajectory --records_dir /tmp/records --format md

Rows come from ``obs/ledger.py``'s RUNS.jsonl (``OBS_LEDGER``; the
fleet supervisor writes <workdir>/RUNS.jsonl by default): ``run_start``
/ ``sample`` / ``run_end`` per run plus the fleet's gang rows and
``resume_agreement`` annotations.  ``diff`` answers the question the
pile of per-run files never could — "these two runs differ HOW": the
config keys that changed (run_start carries the resolved config), the
final-counter deltas (run_end carries cumulative counters), loss-tail
digests (same trajectory or not), outcome and anomaly flags.

``trajectory`` pivots the records in ``--records_dir`` (``BENCH_*``,
``SCHED_*``, ``SERVE_*``, ``HEAL_*``, ``SIM_*``, ``SCALING_*`` and
``BASELINE_SELF.json``) into one row per family per round, through
``tools.bench_ratchet.build_trajectory``: the rows ``tools.bench_ratchet
--trajectory`` writes.  ``--records_dir`` is required (exit 2 without
it): the repository's root holds the JAX package's records.

Stdlib-only and read-only (it imports neither torch nor JAX): safe
mid-outage, and ``--format json`` makes every view machine-consumable.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from distributedtensorflowexample_tpu_torch.engine import (
    resolve_update_layout)     # torch-free half of engine/ (spec.py)
from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
from distributedtensorflowexample_tpu_torch.tools import bench_ratchet
from distributedtensorflowexample_tpu_torch.tools.obs_report import (
    _table as _table_lines)

#: ``obs_query trajectory`` without ``--records_dir`` (exit 2).
TRAJECTORY_NEEDS_DIR = (
    "obs_query: trajectory needs --records_dir: the repository's root "
    "holds the JAX package's records (its TPU and CPU rates), not the "
    "port's; point it at the directory the port's tools wrote")


def _table(headers: list[str], rows: list[list]) -> str:
    """obs_report's markdown table renderer, joined, with Nones blanked
    — ONE table dialect across the two query/report CLIs."""
    return "\n".join(_table_lines(
        headers, [["" if c is None else c for c in row] for row in rows]))


def _emit(payload, md: str, fmt: str) -> None:
    if fmt == "json":
        json.dump(payload, sys.stdout, indent=1, default=str)
        print()
    else:
        print(md)


# --- list ------------------------------------------------------------------

def cmd_list(args) -> int:
    folded = obs_ledger.runs(args.ledger)
    table = obs_ledger.run_table(args.ledger, folded=folded)
    if args.entrypoint:
        table = [r for r in table
                 if args.entrypoint in str(r.get("entrypoint") or "")]
    if args.outcome:
        table = [r for r in table
                 if args.outcome in str(r.get("outcome") or "")]
    agreements = [e for e in folded["events"]
                  if e.get("event") == "resume_agreement"]
    md_rows = [[r["run"], r["entrypoint"], r["rank"], r["attempt"],
                r["outcome"], r["final_step"], r["samples"],
                r["anomalies"] or "",
                "" if r["duration_s"] is None else f"{r['duration_s']:g}"]
               for r in table]
    md = [f"# Runs — `{os.path.basename(args.ledger)}` "
          f"({len(table)} run(s)"
          + (f", {folded['torn']} torn line(s) skipped"
             if folded["torn"] else "") + ")", "",
          _table(["run", "entrypoint", "rank", "att", "outcome", "step",
                  "samples", "anom", "dur_s"], md_rows)]
    if agreements:
        md += ["", "## Resume agreements", ""]
        md += [f"- agreed step **{a.get('agreed')}** "
               f"(task {a.get('task')}): per-rank "
               f"{a.get('per_rank')}, discarded {a.get('discarded')}"
               for a in agreements]
    _emit({"runs": table, "agreements": agreements,
           "torn": folded["torn"]}, "\n".join(md), args.format)
    return 0


# --- show ------------------------------------------------------------------

def _resolve_run(folded: dict, token: str) -> str:
    """Exact id or unique prefix — eight hex chars beat pasting the
    whole id into a terminal."""
    if token in folded["runs"]:
        return token
    matches = [r for r in folded["order"] if r.startswith(token)]
    if len(matches) == 1:
        return matches[0]
    raise SystemExit(
        f"obs_query: run {token!r} "
        + ("is ambiguous: " + ", ".join(matches) if matches
           else "not found — `obs_query list` shows the ids"))


def cmd_show(args) -> int:
    folded = obs_ledger.runs(args.ledger)
    run_id = _resolve_run(folded, args.run)
    group = folded["runs"][run_id]
    md = [f"# Run `{run_id}`", ""]
    for name, row in (("run_start", group["start"]),
                      ("run_end", group["end"])):
        if row:
            md += [f"## {name}", "", "```json",
                   json.dumps(row, indent=1, sort_keys=True), "```", ""]
    if group["samples"]:
        md += [f"## samples ({len(group['samples'])})", ""]
        rows = [[s.get("step"),
                 (s.get("delta") or {}).get("span_s"),
                 json.dumps((s.get("delta") or {}).get("counters") or {},
                            sort_keys=True)]
                for s in group["samples"]]
        md += [_table(["step", "span_s", "counter deltas"], rows)]
    _emit(group, "\n".join(md), args.format)
    return 0


# --- diff ------------------------------------------------------------------

def diff_runs(folded: dict, id_a: str, id_b: str) -> dict:
    a, b = folded["runs"][id_a], folded["runs"][id_b]

    def cfg(g):
        return ((g["start"] or {}).get("config") or {})

    keys = sorted(set(cfg(a)) | set(cfg(b)))
    config_diff = {k: {"a": cfg(a).get(k), "b": cfg(b).get(k)}
                   for k in keys if cfg(a).get(k) != cfg(b).get(k)}

    def layout(g):
        # The DERIVED working layout (tree / bucket_rows / zero3_rows)
        # — the resume-contract fact the raw knob columns only imply:
        # two runs can differ in bucket_grads/shard_* strings yet land
        # in the same layout, or agree on most knobs and still be
        # checkpoint-incompatible.  Same resolution the Engine runs
        # (engine/spec.py), from the run's resolved config + mesh_size.
        start = g["start"] or {}
        if not start.get("config"):
            return None
        try:
            return resolve_update_layout(start["config"],
                                         int(start.get("mesh_size") or 1))
        except Exception:       # noqa: BLE001 — a foreign config shape
            return None         # must read as "underivable", never die

    def counters(g):
        return ((g["end"] or {}).get("counters") or {})

    ckeys = sorted(set(counters(a)) | set(counters(b)))
    metric_delta = {}
    for k in ckeys:
        va, vb = counters(a).get(k), counters(b).get(k)
        if va != vb:
            metric_delta[k] = {
                "a": va, "b": vb,
                "delta": (None if not isinstance(va, (int, float))
                          or not isinstance(vb, (int, float))
                          else round(vb - va, 6))}

    def end_field(g, f):
        return (g["end"] or {}).get(f)

    tails = {which: end_field(g, "loss_tail")
             for which, g in (("a", a), ("b", b))}
    return {
        "a": {"run": id_a, **{f: (a["start"] or {}).get(f)
                              for f in ("entrypoint", "config_digest",
                                        "rank", "attempt")}},
        "b": {"run": id_b, **{f: (b["start"] or {}).get(f)
                              for f in ("entrypoint", "config_digest",
                                        "rank", "attempt")}},
        "config_diff": config_diff,
        "update_layout": {"a": layout(a), "b": layout(b)},
        "outcome": {"a": {"rc": end_field(a, "rc"),
                          "final_step": end_field(a, "final_step")},
                    "b": {"rc": end_field(b, "rc"),
                          "final_step": end_field(b, "final_step")}},
        "loss_tail": {**tails,
                      "same_trajectory": (
                          None if not tails["a"] or not tails["b"]
                          else tails["a"].get("sha256")
                          == tails["b"].get("sha256"))},
        "anomaly_flags": {"a": end_field(a, "anomaly_flags"),
                          "b": end_field(b, "anomaly_flags")},
        "counter_deltas": metric_delta}


def cmd_diff(args) -> int:
    folded = obs_ledger.runs(args.ledger)
    id_a = _resolve_run(folded, args.run_a)
    id_b = _resolve_run(folded, args.run_b)
    d = diff_runs(folded, id_a, id_b)
    md = [f"# Run diff — `{id_a}` (a) vs `{id_b}` (b)", "",
          f"- **a**: {d['a']['entrypoint']} "
          f"(config {d['a']['config_digest']}, rank {d['a']['rank']}, "
          f"attempt {d['a']['attempt']}) → rc={d['outcome']['a']['rc']} "
          f"@ step {d['outcome']['a']['final_step']}",
          f"- **b**: {d['b']['entrypoint']} "
          f"(config {d['b']['config_digest']}, rank {d['b']['rank']}, "
          f"attempt {d['b']['attempt']}) → rc={d['outcome']['b']['rc']} "
          f"@ step {d['outcome']['b']['final_step']}"]
    same = d["loss_tail"]["same_trajectory"]
    if same is not None:
        md.append(f"- **loss trajectory**: "
                  + ("IDENTICAL (tail digests match)" if same
                     else "differs (tail digests disagree)"))
    md += ["", "## Config diff", ""]
    # The derived working layout leads the table for both runs even
    # when equal: it is the checkpoint-resume contract, and "both
    # zero3_rows" vs "both tree" changes how every knob row below
    # reads.
    lay = d["update_layout"]
    layout_rows = ([["update_layout (derived)", lay["a"], lay["b"]]]
                   if lay["a"] or lay["b"] else [])
    if d["config_diff"] or layout_rows:
        md.append(_table(["key", "a", "b"],
                         layout_rows
                         + [[k, v["a"], v["b"]]
                            for k, v in sorted(d["config_diff"].items())]))
    if not d["config_diff"]:
        md.append(("" if not layout_rows else "\n")
                  + "- identical resolved configs "
                  f"(digest {d['a']['config_digest']})")
    md += ["", "## Counter deltas (b - a)", ""]
    if d["counter_deltas"]:
        md.append(_table(
            ["counter", "a", "b", "delta"],
            [[f"`{k}`", v["a"], v["b"], v["delta"]]
             for k, v in sorted(d["counter_deltas"].items())]))
    else:
        md.append("- no counter differences")
    _emit(d, "\n".join(md), args.format)
    return 0


# --- why (scheduler decisions) ---------------------------------------------

# Renderers for the scheduler's sched_* ledger rows — one entry per
# decision class resilience/scheduler.py can write; unknown sched_*
# rows render generically rather than being dropped, so a reader never
# loses a decision to version skew.
_WHY_RENDER = {
    "sched_submit": lambda r: (
        f"submitted: kind={r.get('kind')}, priority={r.get('priority')}, "
        f"{r.get('ranks')} rank(s), retry budget {r.get('retries')}"),
    "sched_admit": lambda r: (
        "admitted — "
        + (f"predicted cost {r.get('predicted_s')}s "
           f"({r.get('step_time_s')}s/step, source {r.get('source')})"
           if r.get("predicted_s") is not None else
           f"step time {r.get('step_time_s')}s/step (source "
           f"{r.get('source')}), total unknown (no steps declared)"
           if r.get("source") else
           "cost unknown (no trajectory family, no declared estimate)")),
    "sched_refuse": lambda r: f"REFUSED at admission: {r.get('why')}",
    "sched_place": lambda r: (
        f"placed on {r.get('ranks')} of {r.get('devices')} device(s) "
        f"(attempt {r.get('attempt')}"
        + (", resuming from snapshots" if r.get("resumed") else "")
        + (f", wall deadline {r.get('wall_timeout_s')}s"
           if r.get("wall_timeout_s") else "") + ")"),
    "sched_shrink": lambda r: (
        f"elastic SHRINK to {r.get('ranks')} rank(s) (was "
        f"{r.get('was')}; lost rank(s) {r.get('lost')} — host down)"),
    "sched_grow": lambda r: (
        f"GROW back to full width: "
        + (f"rank(s) {r.get('recovered')} answered the recovery "
           f"re-probe — stopped cleanly (rcs {r.get('rcs')}) and "
           f"requeued at full width" if r.get("recovered") is not None
           else f"{r.get('ranks')} rank(s) (was {r.get('was')}, "
                f"fleet-internal re-probe)")),
    "sched_evict": lambda r: (
        f"EVICTED: {r.get('why')} — TERM→143→snapshot "
        f"(rcs {r.get('rcs')}, clean={r.get('clean')}); requeued, "
        f"not charged to the retry budget"),
    "sched_retry": lambda r: (
        f"retry {r.get('retry')}/{r.get('of')} with "
        f"{r.get('backoff_s')}s backoff: {r.get('why')}"),
    "sched_quarantine": lambda r: (
        f"QUARANTINED (rcs {r.get('rcs')}): {r.get('why')}"),
    "sched_fail": lambda r: (
        f"FAILED after {r.get('retries')} retr(ies): {r.get('why')}"),
    "sched_done": lambda r: (
        f"done: rcs {r.get('rcs')} over {r.get('gang_attempts')} gang "
        f"attempt(s), {r.get('restarts')} gang restart(s), "
        f"{r.get('preempt_resumes')} scheduler preemption-resume(s)"),
    "sched_orphan_killed": lambda r: (
        f"restart swept orphaned rank {r.get('rank')} group (pid "
        f"{r.get('pid')}) left by a dead scheduler incarnation"),
    "sched_queue_done": lambda r: (
        f"queue drained: {r.get('status')} {r.get('counts')}"),
}

_TERMINAL_WHY = {"sched_done": "completed", "sched_fail": "failed",
                 "sched_quarantine": "quarantined",
                 "sched_refuse": "refused"}

# Renderers for the remediation engine's heal_* ledger rows — one entry
# per decision class resilience/remediate.py can write; unknown heal_*
# rows render generically (same contract as the sched_* table above).
_HEAL_RENDER = {
    "heal_detect": lambda r: (
        f"anomaly detected: {r.get('kind')}"
        + (f" on rank {r.get('rank')}" if r.get("rank") is not None
           else "")
        + (f" at step {r.get('step')}" if r.get("step") is not None
           else "") + f" (source {r.get('source')})"),
    "heal_evict": lambda r: (
        f"HEALED by eviction ({r.get('kind')}): loss-free gang stop — "
        f"TERM→143→snapshot, resumed bitwise ({r.get('detail')})"),
    "heal_rollback": lambda r: (
        f"HEALED by rollback ({r.get('kind')}): gang rolled back to "
        f"pinned last-good snapshot ({r.get('detail')})"),
    "heal_slo_tighten": lambda r: (
        f"HEALED by admission tightening ({r.get('kind')}): "
        f"{r.get('detail')}"),
    "heal_quarantine": lambda r: (
        f"QUARANTINED rank {r.get('rank')} (repeated offender): "
        f"{r.get('detail')}"),
    "heal_canary_promote": lambda r: (
        f"canary PROMOTED: {r.get('detail')}"),
    "heal_canary_rollback": lambda r: (
        f"canary ROLLED BACK ({r.get('kind')}): {r.get('detail')}"),
    "heal_scale_up": lambda r: (
        f"SCALED UP ({r.get('kind')}): serve fleet grown against the "
        f"measured SLO knee ({r.get('detail')})"),
    "heal_scale_down": lambda r: (
        f"SCALED DOWN ({r.get('kind')}): serve fleet shrunk — "
        f"sustained underload ({r.get('detail')})"),
    "heal_lr_drop": lambda r: (
        f"LR-DROP advisory written ({r.get('kind')}): plateau asks for "
        f"a smaller LR before a rollback — stub behind HEAL_LR_DROP "
        f"({r.get('detail')})"),
    "heal_suppressed": lambda r: (
        f"action {r.get('action')} on {r.get('kind')} SUPPRESSED by "
        f"guardrail: {r.get('reason')}"),
    "heal_dry_run": lambda r: (
        f"DRY RUN: {r.get('action')} on {r.get('kind')} would have "
        f"fired (HEAL_DRY_RUN armed — nothing ran)"),
    "heal_budget_exhausted": lambda r: (
        f"action budget {r.get('budget')} EXHAUSTED — remediation "
        f"degraded to detection-only"),
}

# Renderers for the shard-redundant snapshot store's ckpt_* ledger rows
# (resilience/shardstore.py) — the checkpoint half of a job's timeline:
# saves, elastic restores, mirror reconstructions, digest-caught rot,
# and the loud over-redundancy refusal.  Unknown ckpt_* rows render
# generically, same contract as the tables above.
_CKPT_RENDER = {
    "ckpt_save": lambda r: (
        f"shard set saved at step {r.get('step')}: {r.get('ranks')} "
        f"shard(s) x R={r.get('redundancy')} copies, "
        f"{r.get('nbytes')} payload byte(s)"),
    "ckpt_restore": lambda r: (
        (f"ELASTIC restore at step {r.get('step')}: "
         f"D={r.get('from_ranks')} shard set regrouped onto "
         f"D={r.get('to_ranks')} through the engine layout pass"
         if r.get("elastic") else
         f"restored shard set at step {r.get('step')} "
         f"(D={r.get('to_ranks')})")
        + (f"; reconstructed shard(s) {r.get('reconstructed')} from "
           f"ring mirrors" if r.get("reconstructed") else "")),
    "ckpt_reconstruct": lambda r: (
        f"shard {r.get('shard')} of step {r.get('step')} rebuilt from "
        f"rank {r.get('source_rank')}'s ring mirror"),
    "ckpt_digest_mismatch": lambda r: (
        f"BIT ROT caught: {r.get('file')} (shard {r.get('shard')}, "
        f"step {r.get('step')}) failed its sha256 — copy refused, "
        f"never restored"),
    "ckpt_copy_unreadable": lambda r: (
        f"copy unreadable: {r.get('file')} (shard {r.get('shard')}, "
        f"step {r.get('step')}) — trying the next ring copy"),
    "ckpt_refused": lambda r: (
        f"restore REFUSED at step {r.get('step')}: shard "
        f"{r.get('shard')} has no intact copy (census "
        f"{r.get('census')}, R={r.get('redundancy')}) — loss exceeds "
        f"redundancy"),
}


def why_rows(rows: list[dict], token: str) -> tuple[str, list[dict]]:
    """Resolve ``token`` (exact id or unique prefix) against the
    distinct job ids in the ledger's sched_*, heal_* AND ckpt_* rows;
    return (job_id, that job's rows in ledger order) — one timeline
    holding the scheduler's decisions, the remediation engine's, and
    the shard store's checkpoint events."""
    sched = [r for r in rows
             if str(r.get("event", "")).startswith(("sched_", "heal_",
                                                    "ckpt_"))
             and r.get("job")]
    jobs = []
    for r in sched:
        if r["job"] not in jobs:
            jobs.append(r["job"])
    if token in jobs:
        job = token
    else:
        matches = [j for j in jobs if str(j).startswith(token)]
        if len(matches) != 1:
            raise SystemExit(
                f"obs_query: job {token!r} "
                + ("is ambiguous: " + ", ".join(map(str, matches))
                   if matches else
                   f"not found — jobs with scheduler rows: "
                   f"{', '.join(map(str, jobs)) or '(none)'}"))
        job = matches[0]
    return job, [r for r in sched if r["job"] == job]


def cmd_why(args) -> int:
    rows, torn = obs_ledger.read_rows(args.ledger)
    job, mine = why_rows(rows, args.job)
    lines = []
    for r in mine:
        ev_name = str(r.get("event", ""))
        if ev_name.startswith("heal_") and r.get("error"):
            # An applied row carrying error= balances the remediator's
            # WAL but the actuator CRASHED — rendering it through the
            # HEALED renderer would tell the operator a heal happened.
            text = (f"action {ev_name.removeprefix('heal_')} FAILED "
                    f"({r.get('kind')}): {r.get('error')}")
        else:
            render = _WHY_RENDER.get(r.get("event")) \
                or _HEAL_RENDER.get(r.get("event")) \
                or _CKPT_RENDER.get(r.get("event"))
            text = (render(r) if render else
                    f"{r.get('event')}: " + json.dumps(
                        {k: v for k, v in r.items()
                         if k not in ("v", "ts", "event", "src", "job")},
                        sort_keys=True, default=str))
        lines.append({"ts": r.get("ts"), "event": r.get("event"),
                      "text": text})
    evictions = sum(1 for r in mine if r.get("event") == "sched_evict")
    shrinks = sum(1 for r in mine if r.get("event") == "sched_shrink")
    grows = sum(1 for r in mine if r.get("event") == "sched_grow")
    heals = [r for r in mine
             if str(r.get("event", "")).startswith("heal_")
             and not r.get("error")
             and r.get("event") not in ("heal_detect", "heal_suppressed",
                                        "heal_dry_run",
                                        "heal_budget_exhausted")]
    last_terminal = next(
        (r for r in reversed(mine) if r.get("event") in _TERMINAL_WHY),
        None)
    verdict = []
    if evictions:
        for_jobs = sorted({str(r.get("for_job")) for r in mine
                           if r.get("event") == "sched_evict"})
        verdict.append(f"preempted {evictions}x (for "
                       + ", ".join(f"`{j}`" for j in for_jobs) + ")")
    if shrinks:
        verdict.append(f"shrank {shrinks}x on rank loss")
    if grows:
        verdict.append(f"grew back {grows}x on recovery")
    if heals:
        kinds = sorted({str(r["event"]).removeprefix("heal_")
                        for r in heals})
        verdict.append(f"self-healed {len(heals)}x "
                       f"({', '.join(kinds)})")
    verdict.append(
        f"finally {_TERMINAL_WHY[last_terminal['event']]}"
        if last_terminal else "no terminal decision on record "
                              "(still queued/running, or the ledger "
                              "predates the end)")
    md = [f"# Why — job `{job}`", ""]
    md += [f"- [{l['ts']}] {l['text']}" for l in lines]
    md += ["", f"**Verdict**: {'; '.join(verdict)}."]
    _emit({"job": job, "timeline": lines,
           "verdict": "; ".join(verdict), "torn": torn},
          "\n".join(md), args.format)
    return 0


# --- trajectory ------------------------------------------------------------

def cmd_trajectory(args) -> int:
    if not args.records_dir:
        print(TRAJECTORY_NEEDS_DIR, file=sys.stderr, flush=True)
        return 2
    rows = bench_ratchet.build_trajectory(args.records_dir)
    if args.family:
        rows = [r for r in rows if args.family in r["family"]]
    md = [f"# Bench trajectory — {len(rows)} family-round row(s)", ""]
    for row in rows:
        rnd = "—" if row["round"] is None else f"r{row['round']:02d}"
        md += [f"## {row['family']} {rnd} (`{row['file']}`, "
               f"{'/'.join(row['platforms'])})", "",
               _table(["metric", "value"],
                      [[f"`{k}`", v]
                       for k, v in sorted(row["metrics"].items())]), ""]
    _emit(rows, "\n".join(md), args.format)
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_common(sp, ledger: bool = True):
        sp.add_argument("--format", default="md", choices=["md", "json"])
        if ledger:
            # `or`: a present-but-EMPTY export means "ledger disabled"
            # everywhere else (fleet, maybe_begin) — fall through to
            # the ./RUNS.jsonl default the help text promises.
            sp.add_argument("--ledger", default=os.environ.get(
                "OBS_LEDGER") or "RUNS.jsonl",
                help="RUNS.jsonl path (default: $OBS_LEDGER, else "
                     "./RUNS.jsonl)")

    sp = sub.add_parser("list", help="run table + agreements")
    add_common(sp)
    sp.add_argument("--entrypoint", default="",
                    help="substring filter on the entrypoint")
    sp.add_argument("--outcome", default="",
                    help="substring filter on the outcome "
                         "(ok/preempted/rc=.../running)")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("show", help="one run's rows in full")
    add_common(sp)
    sp.add_argument("run", help="run id (or unique prefix)")
    sp.set_defaults(fn=cmd_show)

    sp = sub.add_parser("diff", help="config + metric deltas between "
                                     "two runs")
    add_common(sp)
    sp.add_argument("run_a")
    sp.add_argument("run_b")
    sp.set_defaults(fn=cmd_diff)

    sp = sub.add_parser("why", help="one job's scheduler decision "
                                    "timeline: why was it preempted / "
                                    "shrunk / quarantined")
    add_common(sp)
    sp.add_argument("job", help="job id (or unique prefix) from "
                                "tools.schedule's queue")
    sp.set_defaults(fn=cmd_why)

    sp = sub.add_parser("trajectory", help="per-family per-round bench "
                                           "metric trajectories")
    add_common(sp, ledger=False)
    sp.add_argument("--records_dir", default="",
                    help="the records' directory (required: the "
                         "repository's root holds the JAX package's)")
    sp.add_argument("--family", default="",
                    help="substring filter on the family")
    sp.set_defaults(fn=cmd_trajectory)

    args = p.parse_args(argv)
    if getattr(args, "ledger", None) is not None \
            and args.cmd != "trajectory" \
            and not os.path.exists(args.ledger) \
            and not os.path.exists(args.ledger + ".1"):
        p.error(f"ledger {args.ledger} does not exist (pass --ledger or "
                f"export OBS_LEDGER)")
    return args.fn(args)


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:
        # `obs_query list | head` closing the pipe early is a normal
        # way to read a long table, not an error worth a traceback.
        os._exit(0)
