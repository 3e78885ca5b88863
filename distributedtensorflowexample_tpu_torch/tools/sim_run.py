# graftlint: stdlib-only
"""sim_run — scenario in, evidence out: run the deterministic fleet
simulator (``sim/``) against the port's REAL scheduler + remediator and
land the full record kit (the JAX package's ``tools/sim_run.py`` on the
port; the same scenario and seed write the same ledger and WAL bytes
as the JAX tool).

  # one scenario file -> record rows on stdout, artifacts in --workdir:
  python -m distributedtensorflowexample_tpu_torch.tools.sim_run \
      scenario.json --workdir /tmp/sim
  # the built-in 10,000-rank battery, record rows also to a file:
  python -m distributedtensorflowexample_tpu_torch.tools.sim_run \
      --battery --workdir /tmp/sim --out /tmp/sim/record.jsonl

Outputs per run:

- **record rows** (bench-record dialect, one JSON line per metric) —
  queue-wait percentiles, preemption-storm peak, MTTR tails,
  suppression counts, and the must-be-zero invariants
  (``*_steps_lost``, ``*_violations``): any nonzero one exits 1.
- **the ledger + WAL the real code wrote** (``RUNS.jsonl``,
  ``sched/sched.jsonl``) — query them with ``tools.obs_query why
  <job>`` exactly like a live run's.
- **a Perfetto/chrome-trace timeline** (``--perfetto``) — one track
  per job from the ledger's own rows, plus the serve replica/load
  staircase.

Every battery scenario runs TWICE with the same seed; a single byte of
drift between the two ledgers or WALs is a determinism violation and
lands as ``sim_<scenario>_determinism_violations`` (must-be-zero).
Stdout is the JSON-lines record; prose on stderr.  The simulator runs
on the host: it imports neither torch nor JAX and launches no kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
from distributedtensorflowexample_tpu_torch.resilience import (
    remediate as heal_mod)
from distributedtensorflowexample_tpu_torch.sim import (
    SimWorld, load_scenario, sim_metrics)

#: The scenario DSL's event kinds, for ``--help`` (the reader half: the
#: writer table is ``sim/scenario.SCENARIO_EVENTS``, and
#: tests/test_torch_sim.py holds the two equal, and equal to the JAX
#: package's tables).
SCENARIO_EVENT_HELP = '''
  host_loss         rank's host dies (elastic: shrink; else lost)
  host_recover      lost host answers the recovery probe again
  straggler         rank named straggler; gang slows by factor
  straggler_clear   straggler recovers; gang speed restored
  gang_crash        whole gang crashes (rcs 1 -> budgeted retry)
  gang_wedge        gang reports backend wedged (rc 3 quarantine)
  serve_load        offered serve traffic steps to a new level
  snapshot_loss     rank's snapshot shard lost (mirror or rollback)
'''

#: The serve SLO knee the battery's world model prices capacity with:
#: the JAX package's measured best in-SLO per-replica goodput on the CPU
#: (SERVE_lm_cpu_r15.json, serve_lm_tiny_throughput_vs_slo), kept so the
#: battery is the JAX battery byte for byte.  It is a scenario
#: parameter, not a reading of the port.
SERVE_KNEE_TOK_S = 3779.67

#: The fitted psum collective knee at 8 devices that prices cross-slice
#: snapshot migration in eviction plans: the JAX package's CPU fit
#: (BENCH_collectives_cpu_r06.json detail.knees.psum["8"]), kept for
#: the same reason.
COLLECTIVE_FIT = {"alpha_s": 0.00035273878968362894,
                  "beta_bytes_per_s": 692186226.9354594}


def _log(msg: str) -> None:
    print(f"sim_run: {msg}", file=sys.stderr, flush=True)


# --- the built-in battery ----------------------------------------------------

def battery_scenarios(heal_record: str = "") -> list[dict]:
    """Four storms against 10,000 simulated ranks on a 4-slice mesh:
    a host-loss wave, a straggler epidemic, a serve-traffic spike, and
    a quarantine cascade.  Deterministic by construction — everything
    below is literal except the serve cooldown, which seeds from the
    CHECKED-IN measured-MTTR record (same bytes every run):
    ``heal_record``, else the newest root ``HEAL_*.json``."""
    slices = {"podA": 2600, "podB": 2600, "podC": 2600, "podD": 2600}
    # Post-action quiet period anchored on the worst measured recovery
    # tail (HEAL_* record) instead of a hardcoded constant — see
    # remediate.mttr_seeded_cooldown_s.
    cooldown_s = heal_mod.mttr_seeded_cooldown_s(heal_record)

    def fleet_jobs(tag, *, n=24, steps=1200, elastic=True):
        return [
            {"job": f"{tag}{i:02d}", "kind": "train",
             "ranks": 417 if i < 16 else 416,
             "steps": steps + 10 * i, "est_step_time_s": 0.5,
             "elastic": elastic, "retries": 3,
             "state_bytes": 1 << 26,
             "priority": 0 if i % 6 == 0 else 10,
             "sim": {"startup_s": 3.0}}
            for i in range(n)]

    hostloss = {
        "name": "fleet10k", "seed": 0, "tick_s": 0.5,
        "horizon_s": 3600, "slices": slices,
        "collective_fit": COLLECTIVE_FIT,
        "jobs": fleet_jobs("t"),
        "events":
            # three loss waves rolling across the fleet while it runs,
            # recoveries trailing each wave (grow-on-recovery load)
            [{"at": 60 + 5 * i, "kind": "host_loss",
              "job": f"t{i:02d}", "rank": 7} for i in range(12)]
            + [{"at": 200 + 5 * i, "kind": "host_recover",
                "job": f"t{i:02d}", "rank": 7} for i in range(12)]
            + [{"at": 300 + 3 * i, "kind": "host_loss",
                "job": f"t{i:02d}", "rank": 11} for i in range(12, 24)],
    }
    epidemic = {
        "name": "epidemic10k", "seed": 0, "tick_s": 0.5,
        "horizon_s": 3600, "slices": slices,
        "collective_fit": COLLECTIVE_FIT,
        # the fleet fills the mesh; six late waiters queue behind it,
        # so straggler evictions have a beneficiary (the heal policy
        # is detection-only with nothing queued) and MTTR is a real
        # detect -> relaunch tail
        "jobs": fleet_jobs("e")
        + [{"job": f"w{i}", "kind": "train", "ranks": 416,
            "steps": 400, "est_step_time_s": 0.5, "retries": 3,
            "state_bytes": 1 << 26, "start_after_s": 60.0,
            "sim": {"startup_s": 3.0}} for i in range(6)],
        "events":
            # half the fleet straggles within two minutes — the heal
            # policy's flap/cooldown/budget guardrails must BIND, not
            # evict everything at once
            [{"at": 90 + 10 * i, "kind": "straggler",
              "job": f"e{i:02d}", "rank": 3} for i in range(12)]
            + [{"at": 600 + 10 * i, "kind": "straggler_clear",
                "job": f"e{i:02d}", "rank": 3} for i in range(12)],
    }
    spike = {
        "name": "servespike", "seed": 0, "tick_s": 0.5,
        "horizon_s": 2400, "slices": slices,
        "collective_fit": COLLECTIVE_FIT,
        # the serve anchor spans the horizon; background training
        # fills the other slices
        "jobs": [{"job": "lm_serve", "kind": "serve", "ranks": 416,
                  "steps": 4700, "est_step_time_s": 0.5,
                  "priority": 0, "sim": {"startup_s": 3.0}}]
                + fleet_jobs("s", n=23, steps=2000),
        "serve": {"replicas": 2, "knee_per_replica": SERVE_KNEE_TOK_S,
                  "min_replicas": 1, "max_replicas": 8, "poll_s": 5.0,
                  "flap_n": 2, "flap_window_s": 120,
                  "cooldown_s": cooldown_s, "budget": 12},
        "events": [
            {"at": 300, "kind": "serve_load",
             "offered_per_s": 4 * SERVE_KNEE_TOK_S},     # spike: 4 knees
            {"at": 900, "kind": "serve_load",
             "offered_per_s": 12 * SERVE_KNEE_TOK_S},    # past max=8
            {"at": 1500, "kind": "serve_load",
             "offered_per_s": 0.2 * SERVE_KNEE_TOK_S},   # collapse
        ],
    }
    cascade = {
        "name": "cascade10k", "seed": 0, "tick_s": 0.5,
        "horizon_s": 3600, "slices": slices,
        "collective_fit": COLLECTIVE_FIT,
        "jobs": fleet_jobs("q"),
        "events":
            # a wedge cascade: six gangs report the backend wedged in
            # quick succession (quarantine, never requeue), two more
            # crash outright (budgeted retries)
            [{"at": 120 + 8 * i, "kind": "gang_wedge",
              "job": f"q{i:02d}", "rank": 0} for i in range(6)]
            + [{"at": 260, "kind": "gang_crash", "job": "q06"},
               {"at": 268, "kind": "gang_crash", "job": "q07"}],
    }
    return [hostloss, epidemic, spike, cascade]


# --- perfetto ---------------------------------------------------------------

def write_perfetto(ledger_path: str, out_path: str,
                   traffic_timeline=None) -> int:
    """Chrome-trace JSON from the ledger the real code wrote: one tid
    per job (placement spans between sched_place and the next terminal
    row, instants for everything else), plus serve replica counters."""
    rows, _ = obs_ledger.read_rows(ledger_path)
    if not rows:
        return 0
    t0 = min(r["ts"] for r in rows if r.get("ts") is not None)
    us = lambda ts: round((ts - t0) * 1e6)  # noqa: E731
    events = []
    open_place: dict[str, tuple] = {}
    closers = ("sched_done", "sched_evict", "sched_retry",
               "sched_quarantine", "sched_fail", "sched_grow")
    for r in rows:
        ev, job, ts = r.get("event"), r.get("job"), r.get("ts")
        if ts is None or not isinstance(ev, str):
            continue
        tid = job or r.get("src") or "fleet"
        if ev == "sched_place":
            open_place[job] = (ts, r.get("slice") or "")
            continue
        if ev in closers and job in open_place:
            ts0, slice_name = open_place.pop(job)
            events.append({
                "name": (f"run[{slice_name}]" if slice_name
                         else "run"),
                "ph": "X", "ts": us(ts0), "dur": max(1, us(ts) - us(ts0)),
                "pid": "sim", "tid": tid,
                "args": {"ended_by": ev}})
        events.append({"name": ev, "ph": "i", "s": "t",
                       "ts": us(ts), "pid": "sim", "tid": tid,
                       "args": {k: v for k, v in r.items()
                                if k not in ("v", "ts", "event")}})
    for job, (ts0, slice_name) in sorted(open_place.items()):
        events.append({"name": "run(unfinished)", "ph": "i", "s": "t",
                       "ts": us(ts0), "pid": "sim", "tid": job})
    for ts, offered, replicas in (traffic_timeline or []):
        events.append({"name": "serve", "ph": "C", "ts": round(ts * 1e6),
                       "pid": "sim", "tid": "serve",
                       "args": {"offered_per_s": round(offered, 3),
                                "replicas": replicas}})
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    return len(events)


# --- running ----------------------------------------------------------------

def _run_once(scenario: dict, workdir: str) -> tuple:
    """(world, ledger bytes, WAL bytes) for one fresh run."""
    if os.path.exists(workdir):
        shutil.rmtree(workdir)
    world = SimWorld(load_scenario(dict(scenario)), workdir)
    world.run()
    with open(world.ledger_path, "rb") as f:
        ledger = f.read()
    wal_path = os.path.join(workdir, "sched", "sched.jsonl")
    with open(wal_path, "rb") as f:
        wal = f.read()
    return world, ledger, wal


def run_scenario(scenario: dict, workdir: str, *,
                 check_determinism: bool) -> list[dict]:
    name = scenario.get("name", "scenario")
    world, ledger, wal = _run_once(
        scenario, os.path.join(workdir, name))
    rows = sim_metrics.distill(world, prefix=f"sim_{name}")
    if check_determinism:
        _, ledger2, wal2 = _run_once(
            scenario, os.path.join(workdir, name + ".rerun"))
        drift = int(ledger != ledger2) + int(wal != wal2)
        rows.append({
            "metric": f"sim_{name}_determinism_violations",
            "value": drift, "unit": "runs", "platform": "cpu",
            "detail": {"ledger_bytes": len(ledger),
                       "wal_bytes": len(wal),
                       "ledger_match": ledger == ledger2,
                       "wal_match": wal == wal2}})
        if drift:
            _log(f"{name}: DETERMINISM VIOLATION — same seed, "
                 f"different bytes")
        shutil.rmtree(os.path.join(workdir, name + ".rerun"))
    s = (world.summary or {}).get("summary") or {}
    _log(f"{name}: {s.get('counts')} evictions={s.get('evictions')} "
         f"virtual={world.summary.get('virtual_s')}s")
    return rows


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="The scenario DSL's event kinds:\n" + SCENARIO_EVENT_HELP)
    p.add_argument("scenario", nargs="?", default="",
                   help="scenario JSON file (omit with --battery)")
    p.add_argument("--battery", action="store_true",
                   help="run the built-in 10,000-rank storm battery")
    p.add_argument("--workdir", default="/tmp/sim_run",
                   help="artifact root (ledger/WAL per scenario)")
    p.add_argument("--out", default="",
                   help="also write the record (JSON lines) here")
    p.add_argument("--perfetto", default="",
                   help="write a chrome-trace timeline of the FIRST "
                        "scenario here")
    p.add_argument("--no-determinism-check", action="store_true",
                   help="skip the same-seed rerun comparison")
    args = p.parse_args(argv)
    if bool(args.scenario) == bool(args.battery):
        p.error("exactly one of <scenario> or --battery")
    if args.battery:
        scenarios = battery_scenarios()
    else:
        with open(args.scenario) as f:
            scenarios = [json.load(f)]
    all_rows: list[dict] = []
    first_world_dir = ""
    for scenario in scenarios:
        if isinstance(args.scenario, str) and args.scenario \
                and not scenario.get("name"):
            scenario["name"] = os.path.splitext(
                os.path.basename(args.scenario))[0]
        all_rows.extend(run_scenario(
            scenario, args.workdir,
            check_determinism=not args.no_determinism_check))
        if not first_world_dir:
            first_world_dir = os.path.join(
                args.workdir, scenario.get("name", "scenario"))
    if args.perfetto:
        n = write_perfetto(
            os.path.join(first_world_dir, "RUNS.jsonl"),
            args.perfetto)
        _log(f"perfetto timeline ({n} events) -> {args.perfetto}")
    for row in all_rows:
        print(json.dumps(row, sort_keys=True))
    if args.out:
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            for row in all_rows:
                f.write(json.dumps(row, sort_keys=True) + "\n")
        os.replace(tmp, args.out)
        _log(f"record -> {args.out}")
    bad = [r for r in all_rows
           if r["metric"].endswith(("_lost", "_violations"))
           and r["value"]]
    if bad:
        _log("MUST-BE-ZERO metrics nonzero: "
             + ", ".join(f"{r['metric']}={r['value']}" for r in bad))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
