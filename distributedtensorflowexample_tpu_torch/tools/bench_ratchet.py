# graftlint: stdlib-only
"""bench_ratchet — guard the port's measurement records: newest records
against prior records, self-baselines, armed predictions, an optional
tier-1 floor, and the cross-round trajectory (the JAX package's
``tools/bench_ratchet.py``, with the device named by card).

  python -m distributedtensorflowexample_tpu_torch.tools.bench_ratchet \\
      --records_dir /tmp/records                       # scan + verdict
  python -m distributedtensorflowexample_tpu_torch.tools.bench_ratchet \\
      --records_dir /tmp/records --trajectory /tmp/records/traj.json
  python -m distributedtensorflowexample_tpu_torch.tools.bench_ratchet \\
      --records_dir /tmp/records --floor_file floor.json --dots 224

The records are JSON lines (``BENCH_*``, ``SERVE_*``, ``HEAL_*``,
``SIM_*``, ``SCHED_*``; a pretty-printed single document is read too),
round ``N`` taken from ``_r<N>`` in the file name:

- **prior-record ratchet** — per (metric, platform), the newest
  non-provisional record against the best prior one.  A drop beyond
  ``--tolerance`` is UNEXPLAINED (exit 1) unless the window-normalized
  ``vs_roofline`` held, either measurement is self-noisy
  (``spread_frac``, or the spread of ``detail.repeats``, over
  ``--noise``; ``obs/anomaly.spread_fraction``), or the round has an
  ``OUTAGE_r<N>.md`` in the records directory.  ``*_ms`` metrics
  regress upward.
- **the platform is the card.**  A record whose ``detail.device`` names
  a card (:func:`describe_device`: ``{"platform": "gpu", "name": ...,
  "power_limit": ...}``) is on platform ``gpu:<name>``, so records of
  two different cards never compare, nor card records with CPU ones;
  any other record keeps the JAX tool's platform (``platform``, then
  ``detail.platform``, else ``chip``).
- **must-be-zero invariants** (``*_lost``, ``*_mismatch``,
  ``*_violations``, ``*_restore_failures``, ``*_unrecovered``): a
  nonzero newest value is unexplained.
- **self-baseline check** — newest ``chip`` records against the
  ``BASELINE_SELF.json`` in the records directory (or ``--baseline``);
  warn-only unless ``--strict``.  **armed predictions** — that file's
  ``armed_predictions_*`` blocks, with any newer records.
- **tier-1 floor** — only with ``--floor_file``: ``--dots N`` must not
  drop below the file's ``dots_passed_floor``, and ``--raise_floor``
  only raises it.
- **trajectory** — ``--trajectory [PATH]`` writes one JSON line per
  record family per round (:func:`build_trajectory`), which
  ``tools.obs_query trajectory`` prints and ``tools.schedule
  --trajectory`` prices jobs from.

``--records_dir`` has no default: the repository's root holds the JAX
package's TPU and CPU records, not the port's.  The port's measurement
tools (``bench_collectives``, ``bench_input``, ``ab_augment``) write
their records where ``--json``/``--out`` say, each naming its device
through :func:`describe_device`.

Exit codes: 0 ok / explained-only, 1 unexplained regression or floor
violation, 2 usage.  Stdlib-only (plus ``obs/``, itself stdlib-only).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import platform as _host_platform
import re
import subprocess
import sys

from distributedtensorflowexample_tpu_torch.obs.anomaly import (
    spread_fraction)

_ROUND_RE = re.compile(r"_r(\d+)")


def _round_of(path: str) -> int:
    m = _ROUND_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else -1


def load_records(paths: list[str]) -> list[dict]:
    """All non-provisional record lines, oldest round first.  Torn or
    non-JSON lines are skipped (a SIGKILLed bench leaves them; the
    ratchet reads what survived, like every other postmortem reader).
    A file that yields NO per-line records is retried as one
    pretty-printed JSON document — bench_collectives writes its record
    with ``indent=1``, and a per-line-only parser silently dropped that
    whole family from both the ratchet and the trajectory."""
    records = []

    def _keep(rec, path) -> bool:
        if not isinstance(rec, dict) or "metric" not in rec:
            return False
        detail = rec.get("detail") or {}
        if rec.get("unit") == "unavailable" or detail.get("provisional"):
            return False        # sentinel, not a measurement
        rec["_file"] = os.path.basename(path)
        rec["_round"] = _round_of(path)
        records.append(rec)
        return True

    for path in sorted(paths, key=lambda p: (_round_of(p),
                                             os.path.basename(p))):
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            continue
        kept = 0
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            kept += _keep(rec, path)
        if not kept:
            try:
                _keep(json.loads(text), path)
            except json.JSONDecodeError:
                pass
    return records


def card_name_and_power_limit() -> str | None:
    """``nvidia-smi``'s ``name, power.limit`` of the first card, or None
    where it cannot be read (no card, no tool).  A subprocess: this
    process never initialises CUDA."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    proc = _host_platform.processor()
    return proc if proc not in ("", "unknown") else _host_platform.machine()


def describe_device(device: str) -> dict:
    """``detail.device`` of a record measured on ``device``: on ``cuda``
    the platform ``gpu`` with the card's name and power limit as
    ``nvidia-smi`` gives them (``"not measured"`` where it cannot be
    read); on ``cpu`` the platform ``cpu`` with the host's CPU model (as
    the host reports it) and its core count."""
    if device == "cuda":
        line = card_name_and_power_limit()
        if line is None:
            return {"platform": "gpu", "name": "not measured",
                    "power_limit": "not measured"}
        name, _, limit = line.rpartition(", ")
        return {"platform": "gpu", "name": name or line,
                "power_limit": limit if name else "not measured"}
    return {"platform": "cpu", "cpu": _cpu_model(),
            "cores": os.cpu_count()}


def _platform(rec: dict) -> str:
    """``gpu:<name>`` for a record whose ``detail.device`` names a card;
    else the JAX tool's platform."""
    detail = rec.get("detail") or {}
    dev = detail.get("device")
    if isinstance(dev, dict) and dev.get("platform") == "gpu" \
            and dev.get("name") not in (None, "", "not measured"):
        return f"gpu:{dev['name']}"
    return str(rec.get("platform") or detail.get("platform") or "chip")


def _spread(rec: dict) -> float:
    detail = rec.get("detail") or {}
    if detail.get("spread_frac") is not None:
        return float(detail["spread_frac"])
    return spread_fraction(detail.get("repeats") or [])


def _vs_roofline(rec: dict) -> float | None:
    v = (rec.get("detail") or {}).get("vs_roofline")
    return float(v) if v is not None else None


def outage_rounds(records_dir: str) -> set:
    """Rounds with a checked-in OUTAGE_r<N>.md postmortem — windows the
    repo has already adjudicated as degraded."""
    return {_round_of(p) for p in
            glob.glob(os.path.join(records_dir, "OUTAGE_r*.md"))} - {-1}


def _lower_is_better(metric: str) -> bool:
    """Latency-family metrics (the serving p50/p99 ``*_ms`` lines, the
    heal family's mttd/mttr) regress UPWARD — the throughput rule
    inverted, or a 26% latency improvement would gate as an
    'unexplained drop' while a real regression sailed through."""
    return metric.endswith("_ms")


def check_zero_invariants(records: list[dict],
                          outages: set = frozenset()) -> list[dict]:
    """Must-be-zero metrics: the heal family's ``*_lost`` lines
    (steps_lost, requests_lost), the serving family's
    ``*_mismatch`` lines (speculative-decode tokens diverging from
    plain greedy), and the checkpoint family's ``*_restore_failures`` /
    ``*_unrecovered`` lines (a shard restore that failed, or rot the
    digest caught but the mirror could not repair).  A nonzero value
    is an UNEXPLAINED finding
    regardless of tolerance or noise — a remediation drill that lost a
    step is a broken resume protocol, and a spec-decode mismatch is a
    broken acceptance rule, not a slow one.  Gated on the NEWEST
    record per (metric, platform) only, with the same OUTAGE_r<N>.md
    adjudication the throughput ratchet honors: a historical nonzero
    that a later round fixed (or a documented degraded window) must
    not stay red forever."""
    series: dict = {}
    for rec in records:
        metric = rec.get("metric", "")
        if metric.endswith(("_lost", "_mismatch", "_violations",
                            "_restore_failures", "_unrecovered")):
            series.setdefault((metric, _platform(rec)), []).append(rec)
    findings = []
    for (metric, platform), recs in sorted(series.items()):
        rec = recs[-1]
        v = rec.get("value")
        if v in (0, 0.0):
            continue
        base = {"metric": metric, "platform": platform,
                "newest": v, "newest_file": rec["_file"],
                "prior": 0, "prior_file": "(invariant)",
                "drop_frac": None}
        if rec["_round"] in outages:
            findings.append({**base, "severity": "explained",
                             "why": f"round {rec['_round']} window is a "
                                    f"documented outage (see OUTAGE_r"
                                    f"{rec['_round']:02d}.md)"})
            continue
        findings.append({**base, "severity": "regression",
                         "why": "must-be-zero invariant: a heal drill "
                                "losing work means the resume protocol "
                                "broke, not that the window was slow"})
    return findings


def compare_records(records: list[dict], tolerance: float,
                    noise: float, outages: set = frozenset()) -> list[dict]:
    """Per (metric, platform): newest record vs the best prior (best =
    highest value, or LOWEST for ``*_ms`` latency metrics).  Returns
    finding dicts with ``severity`` 'regression' (unexplained) or
    'explained' (window variance / noisy measurement) — see module
    docstring for the rule.  ``drop_frac`` is always the worsening
    magnitude, whichever direction that metric worsens in."""
    series: dict = {}
    for rec in records:
        if rec.get("metric", "").endswith(
                ("_lost", "_mismatch", "_violations",
                 "_restore_failures", "_unrecovered")):
            # check_zero_invariants owns the must-be-zero family: here
            # a fixed loss (1 -> 0) would read as a 100% "drop".
            continue
        series.setdefault((rec["metric"], _platform(rec)), []).append(rec)
    findings = []
    for (metric, platform), recs in sorted(series.items()):
        if len(recs) < 2:
            continue
        newest = recs[-1]
        if _lower_is_better(metric):
            prior = min(recs[:-1],
                        key=lambda r: r.get("value") or float("inf"))
            new_v = newest.get("value") or 0.0
            old_v = prior.get("value") or 0.0
            if old_v <= 0 or new_v <= (1.0 + tolerance) * old_v:
                continue
            drop = new_v / old_v - 1.0
        else:
            prior = max(recs[:-1], key=lambda r: r.get("value") or 0.0)
            new_v = newest.get("value") or 0.0
            old_v = prior.get("value") or 0.0
            if old_v <= 0 or new_v >= (1.0 - tolerance) * old_v:
                continue
            drop = 1.0 - new_v / old_v
        base = {"metric": metric, "platform": platform,
                "newest": new_v, "newest_file": newest["_file"],
                "prior": old_v, "prior_file": prior["_file"],
                "drop_frac": round(drop, 4)}
        noisy = [which for which, rec in (("newest", newest),
                                          ("prior", prior))
                 if _spread(rec) > noise]
        vr_new, vr_old = _vs_roofline(newest), _vs_roofline(prior)
        if newest["_round"] in outages:
            findings.append({**base, "severity": "explained",
                             "why": f"round {newest['_round']} window is "
                                    f"a documented outage (see OUTAGE_r"
                                    f"{newest['_round']:02d}.md)"})
        elif noisy:
            findings.append({**base, "severity": "explained",
                             "why": f"{'/'.join(noisy)} measurement "
                                    f"self-noisy (spread > {noise:g}) — "
                                    f"not comparable"})
        elif (vr_new is not None and vr_old is not None
                and vr_new >= (1.0 - tolerance) * vr_old):
            findings.append({**base, "severity": "explained",
                             "why": f"vs_roofline held ({vr_old:g} -> "
                                    f"{vr_new:g}): the raw drop is "
                                    f"cross-window chip variance, not a "
                                    f"code regression"})
        else:
            findings.append({**base, "severity": "regression",
                             "why": ("vs_roofline also regressed "
                                     f"({vr_old:g} -> {vr_new:g})"
                                     if vr_new is not None
                                     and vr_old is not None else
                                     "no same-window roofline on record "
                                     "to explain it")})
    return findings


def compare_baseline(records: list[dict], baselines: dict,
                     tolerance: float,
                     outages: set = frozenset()) -> list[dict]:
    """Newest chip record per metric vs its BASELINE_SELF denominator."""
    newest: dict = {}
    for rec in records:
        if _platform(rec) == "chip":
            newest[rec["metric"]] = rec
    findings = []
    for metric, base in sorted(baselines.items()):
        if not isinstance(base, (int, float)) or metric not in newest:
            continue
        rec = newest[metric]
        if rec["_round"] in outages:
            continue            # adjudicated window; nothing to re-judge
        v = rec.get("value") or 0.0
        if v < (1.0 - tolerance) * base:
            findings.append({
                "metric": metric, "platform": "chip", "severity": "baseline",
                "newest": v, "newest_file": rec["_file"], "prior": base,
                "prior_file": "BASELINE_SELF.json",
                "drop_frac": round(1.0 - v / base, 4),
                "why": "below the ratcheted self-baseline (vs_baseline "
                       "carries window luck — gate with --strict only "
                       "when the window is known-comparable)"})
    return findings


def armed_predictions(baselines: dict, records: list[dict]) -> list[dict]:
    """Report armed_predictions_* blocks with any newer matching record
    — armed expectations stay visible until a window confirms them."""
    by_metric: dict = {}
    for rec in records:
        by_metric[rec["metric"]] = rec             # newest wins
    out = []
    for key, block in sorted(baselines.items()):
        if not key.startswith("armed_predictions"):
            continue
        m = re.search(r"round(\d+)", key)
        armed_round = int(m.group(1)) if m else -1
        confirmations = {
            metric: {"value": rec.get("value"), "file": rec["_file"]}
            for metric, rec in by_metric.items()
            if rec["_round"] > armed_round}
        out.append({"key": key, "armed_round": armed_round,
                    "note": (block or {}).get("note", "")
                    if isinstance(block, dict) else str(block)[:200],
                    "newer_records": confirmations})
    return out


_TRAJECTORY_NAME = "BENCH_trajectory.json"


def _family_of(path: str) -> str:
    """Family = the record filename with round and extension stripped:
    BENCH_lm_cpu_r08.json -> BENCH_lm_cpu, SCALING_r05_sync.json ->
    SCALING_sync, BENCH_r01.json -> BENCH — the stable axis the
    trajectory pivots on."""
    base = os.path.basename(path)
    if base.endswith(".json"):
        base = base[:-5]
    return _ROUND_RE.sub("", base)


def _scaling_metrics(path: str) -> dict:
    """SCALING_* files are per-devices rows, not "metric" records:
    flatten each to ``<n>dev_steps_per_sec`` (plus any real metric
    lines, e.g. the weak-scaling efficiency tail)."""
    metrics: dict = {}
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return metrics
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if not isinstance(rec, dict):
            continue
        if (rec.get("detail") or {}).get("provisional"):
            continue        # same sentinel rejection as load_records
        if rec.get("metric") and rec.get("unit") != "unavailable":
            metrics[rec["metric"]] = rec.get("value")
        elif rec.get("devices") is not None \
                and rec.get("steps_per_sec") is not None:
            metrics[f"{rec['devices']}dev_steps_per_sec"] = \
                rec["steps_per_sec"]
    return metrics


def build_trajectory(records_dir: str) -> list[dict]:
    """One row per bench family per round — the canonical cross-round
    view of the whole perf trajectory, pivoted out of the 20+ record
    files external tooling otherwise sees as an unreadable pile.
    Deterministic (sorted rows, sorted metric keys, no timestamps): a
    regeneration with unchanged records is byte-identical, so the
    checked-in artifact diffs like code."""
    rows: list[dict] = []
    # The families: BENCH_* (the measurement tools), SCHED_* (the
    # scheduler's queue-completion record, tools.schedule --record),
    # SERVE_* (serving curves), HEAL_* (tools.heal_drill's mttd/mttr/
    # steps lost) and SIM_* (tools.sim_run --battery), all in the one
    # metric-row dialect; then SCALING_* per-devices rows and the
    # BASELINE_SELF denominators.
    for pattern in ("BENCH_*.json", "SCHED_*.json", "SERVE_*.json",
                    "HEAL_*.json", "SIM_*.json"):
        for path in sorted(glob.glob(os.path.join(records_dir,
                                                  pattern))):
            if os.path.basename(path) == _TRAJECTORY_NAME:
                continue        # never its own source
            recs = load_records([path])
            if not recs:
                continue
            metrics: dict = {}
            platforms: set = set()
            for rec in recs:
                metrics[rec["metric"]] = rec.get("value")
                platforms.add(_platform(rec))
            rows.append({"family": _family_of(path),
                         "round": _round_of(path),
                         "file": os.path.basename(path),
                         "platforms": sorted(platforms),
                         "n_records": len(recs),
                         "metrics": {k: metrics[k]
                                     for k in sorted(metrics)}})
    for path in sorted(glob.glob(os.path.join(records_dir,
                                              "SCALING_*.json"))):
        metrics = _scaling_metrics(path)
        if not metrics:
            continue
        rows.append({"family": _family_of(path),
                     "round": _round_of(path),
                     "file": os.path.basename(path),
                     "platforms": ["cpu"],      # every SCALING record
                     "n_records": len(metrics),
                     "metrics": {k: metrics[k] for k in sorted(metrics)}})
    base_path = os.path.join(records_dir, "BASELINE_SELF.json")
    try:
        with open(base_path) as f:
            baselines = json.load(f)
    except (OSError, json.JSONDecodeError):
        baselines = {}
    numeric = {k: v for k, v in baselines.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
    if numeric:
        rows.append({"family": "BASELINE_SELF", "round": None,
                     "file": "BASELINE_SELF.json", "platforms": ["chip"],
                     "n_records": len(numeric),
                     "metrics": {k: numeric[k] for k in sorted(numeric)}})
    rows.sort(key=lambda r: (r["family"],
                             -1 if r["round"] is None else r["round"],
                             r["file"]))
    return rows


def write_trajectory(records_dir: str, out_path: str) -> int:
    rows = build_trajectory(records_dir)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        for row in rows:
            f.write(json.dumps(row, sort_keys=True) + "\n")
    os.replace(tmp, out_path)
    return len(rows)


def check_floor(floor_path: str, dots: int | None,
                raise_to: int | None) -> tuple[list[str], list[str]]:
    """(errors, info).  The floor file is the ratchet's only writable
    artifact, and only UPWARD."""
    errors, info = [], []
    try:
        with open(floor_path) as f:
            payload = json.load(f)
        floor = int(payload["dots_passed_floor"])
    except (OSError, json.JSONDecodeError, KeyError, ValueError) as e:
        return [f"floor file {floor_path} unreadable: {e}"], []
    info.append(f"tier-1 floor: DOTS_PASSED >= {floor} ({floor_path})")
    if dots is not None:
        if dots < floor:
            errors.append(f"tier-1 DOTS_PASSED {dots} dropped below the "
                          f"checked-in floor {floor} — the suite lost "
                          f"tests (or the run lost time); neither is a "
                          f"legal ratchet direction")
        else:
            info.append(f"tier-1 DOTS_PASSED {dots} >= floor {floor}: ok")
    if raise_to is not None:
        if raise_to < floor:
            errors.append(f"--raise_floor {raise_to} < current floor "
                          f"{floor}: the floor only ratchets UP")
        else:
            payload["dots_passed_floor"] = raise_to
            tmp = floor_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1)
                f.write("\n")
            os.replace(tmp, floor_path)
            info.append(f"floor raised {floor} -> {raise_to}")
    return errors, info


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--records_dir", required=True,
                   help="where the records live (no default: the "
                        "repository's root holds the JAX package's TPU "
                        "and CPU records)")
    p.add_argument("--glob", default="BENCH_*.json,SERVE_*.json,"
                                     "HEAL_*.json,SIM_*.json",
                   help="comma-separated record patterns the prior-"
                        "record ratchet scans (the serving and heal "
                        "families regress like any bench family; heal "
                        "*_ms metrics gate lower-is-better and *_lost / "
                        "*_mismatch / *_violations / *_restore_failures "
                        "/ *_unrecovered must stay zero)")
    p.add_argument("--baseline", default="",
                   help="BASELINE_SELF.json (default: in records_dir)")
    p.add_argument("--tolerance", type=float, default=0.10,
                   help="fractional drop below which nothing is flagged")
    p.add_argument("--noise", type=float, default=0.25,
                   help="spread_frac above which a measurement is too "
                        "self-noisy to call a regression from")
    p.add_argument("--dots", type=int, default=None,
                   help="this run's tier-1 DOTS_PASSED, gated against "
                        "the floor file")
    p.add_argument("--floor_file", default="",
                   help="a JSON file with dots_passed_floor; default '' = "
                        "no floor check")
    p.add_argument("--raise_floor", type=int, default=None,
                   help="ratchet the floor UP to this value (refuses to "
                        "lower)")
    p.add_argument("--strict", action="store_true",
                   help="self-baseline drops gate too (same-window-"
                        "comparable runs only)")
    p.add_argument("--trajectory", nargs="?", const="", default=None,
                   metavar="PATH",
                   help="also (re)generate the canonical cross-round "
                        "trajectory artifact — one JSON line per bench "
                        "family per round, pivoted from the BENCH_*/"
                        "SCALING_*/BASELINE_SELF records (default PATH: "
                        f"<records_dir>/{_TRAJECTORY_NAME})")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable verdict on stdout")
    args = p.parse_args(argv)
    if not args.floor_file and (args.dots is not None
                                or args.raise_floor is not None):
        p.error("--dots and --raise_floor gate a floor file: pass "
                "--floor_file")

    paths = sorted(p for pat in args.glob.split(",") if pat
                   for p in glob.glob(os.path.join(args.records_dir,
                                                   pat.strip()))
                   if os.path.basename(p) != _TRAJECTORY_NAME)
    records = load_records(paths)
    baseline_path = args.baseline or os.path.join(args.records_dir,
                                                  "BASELINE_SELF.json")
    try:
        with open(baseline_path) as f:
            baselines = json.load(f)
    except (OSError, json.JSONDecodeError):
        baselines = {}

    trajectory_rows = None
    if args.trajectory is not None:
        out_path = args.trajectory or os.path.join(args.records_dir,
                                                   _TRAJECTORY_NAME)
        trajectory_rows = write_trajectory(args.records_dir, out_path)

    outages = outage_rounds(args.records_dir)
    findings = compare_records(records, args.tolerance, args.noise,
                               outages)
    findings += check_zero_invariants(records, outages)
    findings += compare_baseline(records, baselines, args.tolerance,
                                 outages)
    armed = armed_predictions(baselines, records)
    floor_errors, floor_info = (
        check_floor(args.floor_file, args.dots, args.raise_floor)
        if args.floor_file else ([], []))

    gate = [f for f in findings if f["severity"] == "regression"
            or (args.strict and f["severity"] == "baseline")]
    verdict = {"records": len(records), "files": len(paths),
               "findings": findings, "armed_predictions": armed,
               "floor": {"errors": floor_errors, "info": floor_info},
               "unexplained": len(gate) + len(floor_errors)}
    if trajectory_rows is not None:
        verdict["trajectory_rows"] = trajectory_rows
    if args.as_json:
        json.dump(verdict, sys.stdout, indent=1, default=str)
        print()
    else:
        print(f"bench_ratchet: {len(records)} records in {len(paths)} "
              f"files")
        if trajectory_rows is not None:
            print(f"  [trajectory] {trajectory_rows} family-round rows "
                  f"written")
        for f_ in findings:
            worse = ("invariant violated"
                     if f_["drop_frac"] is None
                     else f"worse by {f_['drop_frac']:.1%}")
            print(f"  [{f_['severity']}] {f_['metric']} ({f_['platform']}):"
                  f" {f_['prior']:g} ({f_['prior_file']}) -> "
                  f"{f_['newest']:g} ({f_['newest_file']}), "
                  f"{worse} — {f_['why']}")
        if not findings:
            print("  no drops beyond tolerance")
        for a in armed:
            newer = (f"{len(a['newer_records'])} newer record(s)"
                     if a["newer_records"] else
                     "NO newer records yet — prediction still open")
            print(f"  [armed] {a['key']} (round {a['armed_round']}): "
                  f"{newer}")
        for line in floor_info:
            print(f"  [floor] {line}")
        for line in floor_errors:
            print(f"  [FLOOR VIOLATION] {line}")
        print(f"bench_ratchet: "
              + ("OK" if not gate and not floor_errors else
                 f"{len(gate) + len(floor_errors)} UNEXPLAINED"))
    return 1 if gate or floor_errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
