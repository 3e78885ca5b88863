"""The port's fleet simulator (``sim/``) and its ``tools.sim_run`` entry point,
held against the JAX package's on the CPU.

The simulator drives the REAL control plane (the port's ``Scheduler``
and ``Remediator``) on a virtual clock.  Claims, in order:

1. **parity** — the JAX and the port simulator, on the same scenario
   and seed, write byte-identical ``RUNS.jsonl`` and
   ``sched/sched.jsonl`` and distill the same record rows: the four
   10,000-rank battery storms and the scenarios of the JAX package's
   ``tests/test_sim.py``.  One field is masked, by name:
   ``sched_quarantine``'s ``why`` names a dead device where the JAX
   package's names its TPU tunnel (the port's scheduler rewords it on
   purpose; ``tests/test_torch_scheduler.py`` masks the same words);
2. **identity** — ``type(world.scheduler)`` is the port's
   ``Scheduler`` and the remediators are the port's ``Remediator``;
3. **determinism** — two same-seed port runs are byte-identical;
4. **fidelity** — a tiny queue run live (the port's ``FleetSupervisor``
   over stdlib children) and simulated makes the same per-job decisions;
5. **scale** — ``fleet10k`` through ``tools.sim_run`` in seconds, and
   ``--battery`` as a process: 0 violations, 0 steps lost;
6. the scenario tables and the clock-seam rule.
"""

import io
import json
import os
import subprocess
import sys
import textwrap
import time
from contextlib import redirect_stdout

import pytest

from distributedtensorflowexample_tpu.analysis import src_lint
from distributedtensorflowexample_tpu.resilience import (
    remediate as jremediate)
from distributedtensorflowexample_tpu.sim import SimWorld as JaxWorld
from distributedtensorflowexample_tpu.sim import load_scenario as jax_load
from distributedtensorflowexample_tpu.sim import scenario as jscenario
from distributedtensorflowexample_tpu.sim import sim_metrics as jmetrics
from distributedtensorflowexample_tpu_torch.obs import metrics as obs_metrics
from distributedtensorflowexample_tpu_torch.resilience import (
    remediate as premediate)
from distributedtensorflowexample_tpu_torch.resilience import (
    scheduler as psched)
from distributedtensorflowexample_tpu_torch.resilience import (
    supervisor as psup)
from distributedtensorflowexample_tpu_torch.sim import (
    SCENARIO_EVENTS, SimFleetFactory, SimWorld, load_scenario, sim_metrics)
from distributedtensorflowexample_tpu_torch.sim import scenario as pscenario
from distributedtensorflowexample_tpu_torch.tools import obs_query
from distributedtensorflowexample_tpu_torch.tools import sim_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "distributedtensorflowexample_tpu_torch"

pytestmark = pytest.mark.sim


def _jax_tool(name):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


jax_sim_run = _jax_tool("sim_run")


def _rows(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _kinds(rows, job, prefix="sched_") -> list[str]:
    return [r["event"] for r in rows if r.get("job") == job
            and str(r.get("event", "")).startswith(prefix)]


def _world(cls, load, scenario, workdir):
    world = cls(load(dict(scenario)), str(workdir))
    world.run()
    return world


def _bytes(world) -> dict:
    out = {}
    for name in ("RUNS.jsonl", os.path.join("sched", "sched.jsonl"),
                 "serve_heal.jsonl"):
        path = os.path.join(world.workdir, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                out[name] = f.read()
    return out


# ---- the scenarios: the battery and those of the JAX tests/test_sim.py ---

def _heal():
    return {"name": "heal", "seed": 0, "tick_s": 0.25, "horizon_s": 400,
            "devices": 2,
            "jobs": [{"job": "bench1", "kind": "bench", "ranks": 2,
                      "steps": 60, "est_step_time_s": 0.5, "retries": 2},
                     {"job": "train1", "kind": "train", "ranks": 2,
                      "steps": 4, "est_step_time_s": 0.5, "priority": 20,
                      "start_after_s": 6.0}],
            "events": [{"at": 8.0, "kind": "straggler", "job": "bench1",
                        "rank": 1}]}


def _slices():
    return {"name": "slices", "seed": 0, "tick_s": 0.25, "horizon_s": 600,
            "slices": {"podA": 4, "podB": 4},
            "collective_fit": {"alpha_s": 0.00035273878968362894,
                               "beta_bytes_per_s": 692186226.9354594},
            "jobs": [{"job": "t1", "kind": "train", "ranks": 4,
                      "steps": 60, "est_step_time_s": 0.5,
                      "state_bytes": 1 << 26, "retries": 2},
                     {"job": "t2", "kind": "train", "ranks": 4,
                      "steps": 60, "est_step_time_s": 0.5,
                      "state_bytes": 1 << 26, "retries": 2},
                     {"job": "wide", "kind": "train", "ranks": 6,
                      "steps": 4, "est_step_time_s": 0.5},
                     {"job": "s1", "kind": "serve", "ranks": 4, "steps": 4,
                      "est_step_time_s": 0.5, "start_after_s": 6.0}]}


def _spike():
    return {"name": "spike", "seed": 0, "tick_s": 0.25, "horizon_s": 420,
            "devices": 2,
            "jobs": [{"job": "anchor", "kind": "serve", "ranks": 2,
                      "steps": 800, "est_step_time_s": 0.5}],
            "serve": {"replicas": 1, "knee_per_replica": 100.0,
                      "min_replicas": 1, "max_replicas": 3, "poll_s": 5.0,
                      "flap_n": 2, "flap_window_s": 120, "cooldown_s": 20,
                      "budget": 10},
            "events": [{"at": 30.0, "kind": "serve_load",
                        "offered_per_s": 1000.0},
                       {"at": 240.0, "kind": "serve_load",
                        "offered_per_s": 10.0}]}


def _snaploss():
    return {"name": "snaploss", "seed": 5, "tick_s": 0.25,
            "horizon_s": 300, "devices": 2,
            "jobs": [{"job": "t", "kind": "train", "ranks": 2, "steps": 30,
                      "est_step_time_s": 0.5, "retries": 3}],
            "events": [{"at": 4.0, "kind": "snapshot_loss", "job": "t",
                        "rank": 0},
                       {"at": 8.0, "kind": "snapshot_loss", "job": "t",
                        "rank": 1}]}


def _storm():
    """Every decision family at once: elastic shrink + grow, heal
    eviction with a queued beneficiary, SLO preemption, autoscaling."""
    return {"name": "storm", "seed": 3, "tick_s": 0.25, "horizon_s": 400,
            "devices": 4,
            "jobs": [{"job": "t1", "kind": "train", "ranks": 2, "steps": 60,
                      "est_step_time_s": 0.5, "retries": 3,
                      "elastic": True},
                     {"job": "t2", "kind": "bench", "ranks": 2, "steps": 60,
                      "est_step_time_s": 0.5, "retries": 3},
                     {"job": "w1", "kind": "train", "ranks": 2, "steps": 6,
                      "est_step_time_s": 0.5, "start_after_s": 6.0},
                     {"job": "s1", "kind": "serve", "ranks": 2, "steps": 6,
                      "est_step_time_s": 0.5, "start_after_s": 8.0}],
            "serve": {"replicas": 1, "knee_per_replica": 100.0,
                      "max_replicas": 4, "poll_s": 5.0, "flap_n": 2,
                      "flap_window_s": 60, "cooldown_s": 15, "budget": 8},
            "events": [{"at": 5.0, "kind": "host_loss", "job": "t1",
                        "rank": 1},
                       {"at": 12.0, "kind": "host_recover", "job": "t1",
                        "rank": 1},
                       {"at": 10.0, "kind": "straggler", "job": "t2",
                        "rank": 0},
                       {"at": 30.0, "kind": "serve_load",
                        "offered_per_s": 350.0},
                       {"at": 60.0, "kind": "serve_load",
                        "offered_per_s": 20.0}]}


def _mirror():
    return {"name": "mirror", "seed": 0, "tick_s": 0.25, "horizon_s": 400,
            "devices": 2,
            "jobs": [{"job": "a", "kind": "bench", "steps": 40,
                      "est_step_time_s": 0.5},
                     {"job": "b", "kind": "serve", "ranks": 2, "steps": 4,
                      "est_step_time_s": 0.5, "start_after_s": 5.0}]}


BATTERY = ("fleet10k", "epidemic10k", "servespike", "cascade10k")
SMALL = {f.__name__.lstrip("_"): f for f in (
    _heal, _slices, _spike, _snaploss, _storm, _mirror)}


def _scenario(name: str) -> dict:
    if name in SMALL:
        return SMALL[name]()
    # The battery's serve cooldown seeds from a HEAL_* record: both
    # packages get the same record, by path.
    record = jremediate.newest_heal_record()
    port = {s["name"]: s for s in sim_run.battery_scenarios(record)}
    jax = {s["name"]: s for s in jax_sim_run.battery_scenarios()}
    assert port[name] == jax[name]
    return port[name]


#: The one masked field, in the JAX bytes: sched_quarantine's ``why``
#: (and the summary's per-job ``why``, which repeats it).
_JAX_WHY = b"against a dead tunnel"
_PORT_WHY = b"against a dead device"


@pytest.mark.parametrize("name", BATTERY + tuple(SMALL))
def test_sim_writes_the_jax_simulators_bytes(tmp_path, name):
    scenario = _scenario(name)
    jw = _world(JaxWorld, jax_load, scenario, tmp_path / "jax")
    pw = _world(SimWorld, load_scenario, scenario, tmp_path / "port")
    # identity: the port's own control plane made every decision
    assert type(pw.scheduler) is psched.Scheduler
    assert type(pw.scheduler._remediator) is premediate.Remediator
    assert isinstance(pw.scheduler.fleet_factory, SimFleetFactory)
    if scenario.get("serve"):
        assert type(pw.serve_remediator) is premediate.Remediator
    jax_bytes, port_bytes = _bytes(jw), _bytes(pw)
    assert set(jax_bytes) == set(port_bytes)
    assert {"RUNS.jsonl", os.path.join("sched", "sched.jsonl")} \
        <= set(port_bytes)
    quarantines = sum(1 for r in _rows(pw.ledger_path)
                      if r["event"] == "sched_quarantine")
    for name_, data in jax_bytes.items():
        assert data.count(_JAX_WHY) == (quarantines if "serve" not in name_
                                        else 0)
        assert data.replace(_JAX_WHY, _PORT_WHY) == port_bytes[name_], name_
    # the summary's per-job ``why`` carries the same quarantine reason
    assert pw.summary == json.loads(json.dumps(jw.summary).replace(
        _JAX_WHY.decode(), _PORT_WHY.decode()))
    assert sim_metrics.distill(pw, prefix=f"sim_{name}") == \
        jmetrics.distill(jw, prefix=f"sim_{name}")
    assert pw.hub.steps_lost() == 0.0


def test_same_seed_is_bitwise_identical(tmp_path):
    scenario = _storm()
    w1 = _world(SimWorld, load_scenario, scenario, tmp_path / "r1")
    w2 = _world(SimWorld, load_scenario, scenario, tmp_path / "r2")
    b1, b2 = _bytes(w1), _bytes(w2)
    assert b1["RUNS.jsonl"] and b1 == b2
    assert w1.summary == w2.summary
    rows = sim_metrics.distill(w1, prefix="sim_storm")
    assert rows == sim_metrics.distill(w2, prefix="sim_storm")
    by_name = {r["metric"]: r["value"] for r in rows}
    assert by_name["sim_storm_fleet_steps_lost"] == 0.0
    assert by_name["sim_storm_wal_unbalanced_violations"] == 0
    assert by_name["sim_storm_evictions"] >= 1
    assert by_name["sim_storm_jobs_done"] == 4


def test_heal_scenario_reads_like_live_through_obs_query(tmp_path):
    """The straggler is detected, flap-guarded and evicted for the queued
    job through the port's WAL; ``tools.obs_query why`` tells it."""
    world = _world(SimWorld, load_scenario, _heal(), tmp_path / "heal")
    assert world.summary["summary"]["jobs"] == {"bench1": "done",
                                                "train1": "done"}
    places = [r for r in _rows(world.ledger_path)
              if r["event"] == "sched_place" and r["job"] == "bench1"]
    assert [p["resumed"] for p in places] == [False, True]
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert obs_query.main(["why", "bench1", "--ledger",
                               world.ledger_path]) == 0
    out = buf.getvalue()
    for text in ("anomaly detected: straggler", "HEALED by eviction",
                 "self-healed 1x (evict)", "finally completed"):
        assert text in out


# ---- the scenario DSL and the virtual-time ceiling -----------------------

_BASE = {"name": "x", "jobs": [{"job": "a", "steps": 4,
                                "est_step_time_s": 0.5}]}


@pytest.mark.parametrize("payload", [
    dict(_BASE, events=[{"at": 1, "kind": "meteor", "job": "a"}]),
    dict(_BASE, events=[{"at": 1, "kind": "host_loss", "job": "nope"}]),
    dict(_BASE, horizon_s=10,
         events=[{"at": 99, "kind": "host_loss", "job": "a"}]),
    {"name": "x", "jobs": [{"job": "a"}]},
    {"name": "x", "jobs": []},
    dict(_BASE, serve={"replicas": 2}),
], ids=["unknown_kind", "unknown_job", "outside_horizon", "needs_steps",
        "no_jobs", "knee"])
def test_scenario_validation_is_loud_as_in_jax(payload):
    msgs = []
    for load in (jax_load, load_scenario):
        with pytest.raises(ValueError) as e:
            load(dict(payload))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_sim_max_virtual_s_ceiling_dies_loudly(tmp_path, monkeypatch):
    monkeypatch.setenv("SIM_MAX_VIRTUAL_S", "5")
    scenario = {"name": "livelock", "horizon_s": 50, "devices": 2,
                "jobs": [{"job": "a", "ranks": 1, "steps": 1000,
                          "est_step_time_s": 1.0}]}
    world = SimWorld(load_scenario(scenario), str(tmp_path / "lv"))
    assert world.max_virtual_s == 5.0
    with pytest.raises(RuntimeError, match="SIM_MAX_VIRTUAL_S"):
        world.run()
    # the seams are the real ones again after the raise
    assert psched._sleep is time.sleep
    assert obs_metrics._now is time.monotonic
    assert obs_metrics._wall is time.time


def test_scenario_tables_equal_each_other_and_jax():
    """The writer table (``sim/scenario.SCENARIO_EVENTS``) and the reader
    table (``tools.sim_run.SCENARIO_EVENT_HELP``) name the same kinds,
    and both are the JAX package's (its help block lives in
    ``tools/sim_run.py``'s docstring)."""
    assert SCENARIO_EVENTS == jscenario.SCENARIO_EVENTS
    assert pscenario.SIM_JOB_DEFAULTS == jscenario.SIM_JOB_DEFAULTS
    helped = tuple(line.split()[0] for line in
                   sim_run.SCENARIO_EVENT_HELP.strip("\n").splitlines())
    assert helped == SCENARIO_EVENTS
    doc = jax_sim_run.__doc__
    start = doc.index("SCENARIO_EVENT_HELP = '''") + len(
        "SCENARIO_EVENT_HELP = '''")
    assert doc[start:doc.index("'''", start)] == sim_run.SCENARIO_EVENT_HELP
    assert sim_run.SERVE_KNEE_TOK_S == jax_sim_run.SERVE_KNEE_TOK_S
    assert sim_run.COLLECTIVE_FIT == jax_sim_run.COLLECTIVE_FIT


def test_clock_seam_rule_finds_no_bare_clock_read_in_the_port():
    """The JAX package's clock-seam rule over the port: no bare
    ``time``/``datetime`` read in ``obs/`` or the scheduler and the
    remediator, the code the virtual clock must fully own."""
    mods = src_lint._load_package(REPO, PORT)
    assert len(mods) >= 97
    assert {"obs.metrics", "resilience.scheduler",
            "resilience.remediate"} <= set(mods)
    assert src_lint.check_clock_seam(REPO, PORT, mods) == []


# ---- live against sim ----------------------------------------------------

def test_live_and_sim_make_the_same_decisions(tmp_path):
    """One tiny queue run LIVE (the port's Scheduler and FleetSupervisor,
    stdlib children, wall clock) and SIMULATED (the port's Scheduler on
    SimGangs, virtual clock): the same per-job sched_* sequences, the
    same eviction fields, the same resumed placement."""
    py = sys.executable
    prog = str(tmp_path / "progress")
    victim = tmp_path / "victim.py"
    victim.write_text(textwrap.dedent("""
        import os, signal, sys, time
        prog = os.environ["PROG"]
        signal.signal(signal.SIGTERM, lambda s, f: sys.exit(143))
        while True:
            n = sum(1 for _ in open(prog)) if os.path.exists(prog) else 0
            if n >= 10:
                sys.exit(0)
            with open(prog, "a") as f:
                f.write(f"i{n}\\n")
            time.sleep(0.15)
    """))
    live = psched.Scheduler(
        [psched.Job(job="a", argv=[py, str(victim)], kind="bench",
                    env={"PROG": prog}),
         psched.Job(job="b", argv=[py, "-c", "pass"], kind="serve",
                    ranks=2, start_after_s=0.6)],
        devices=2, workdir=str(tmp_path / "live"), tick_s=0.05,
        poll_s=0.02, seed=0,
        retry_policy=psup.RetryPolicy(retries=3, backoff_base_s=0.05,
                                      backoff_max_s=0.1))
    assert live.run()["jobs"] == {"a": "done", "b": "done"}
    live_rows = _rows(tmp_path / "live" / "RUNS.jsonl")
    world = _world(SimWorld, load_scenario, _mirror(), tmp_path / "sim")
    assert world.summary["summary"]["jobs"] == {"a": "done", "b": "done"}
    sim_rows = _rows(world.ledger_path)
    for job in ("a", "b"):
        assert _kinds(live_rows, job) == _kinds(sim_rows, job), job
    (ev_live,) = [r for r in live_rows if r["event"] == "sched_evict"]
    (ev_sim,) = [r for r in sim_rows if r["event"] == "sched_evict"]
    for field in ("job", "for_job", "clean", "rcs"):
        assert ev_live[field] == ev_sim[field], field
    for rows in (live_rows, sim_rows):
        assert [r["resumed"] for r in rows if r["event"] == "sched_place"
                and r["job"] == "a"] == [False, True]
    with open(prog) as f:
        assert f.read().split() == [f"i{i}" for i in range(10)]
    assert world.hub.steps_lost() == 0.0


# ---- 10,000 ranks through tools.sim_run ----------------------------------

def test_fleet10k_through_sim_run_in_seconds(tmp_path, capsys):
    """``tools.sim_run`` on the battery's host-loss wave as a scenario
    file: 24 jobs over four 2,600-device slices, run twice for the
    byte comparison, under 60 s of wall time (about a second here)."""
    scenario = sim_run.battery_scenarios()[0]
    assert scenario["name"] == "fleet10k"
    path = tmp_path / "fleet10k.json"
    path.write_text(json.dumps(scenario))
    out = tmp_path / "record.jsonl"
    t0 = time.monotonic()
    rc = sim_run.main([str(path), "--workdir", str(tmp_path / "w"),
                       "--out", str(out), "--perfetto",
                       str(tmp_path / "trace.json")])
    elapsed = time.monotonic() - t0
    assert rc == 0
    assert elapsed < 60.0, f"10k-rank sim took {elapsed:.1f}s wall"
    by_name = {r["metric"]: r for r in map(json.loads, open(out))}
    assert by_name["sim_fleet10k_ranks"]["value"] == 10_000
    assert by_name["sim_fleet10k_jobs_done"]["value"] == 24
    for metric in ("determinism_violations", "fleet_steps_lost",
                   "wal_unbalanced_violations"):
        assert by_name[f"sim_fleet10k_{metric}"]["value"] == 0
    assert by_name["sim_fleet10k_determinism_violations"]["detail"][
        "ledger_match"] is True
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    assert printed == list(by_name.values())
    rows = _rows(tmp_path / "w" / "fleet10k" / "RUNS.jsonl")
    assert {r.get("slice") for r in rows if r["event"] == "sched_place"} \
        == {"podA", "podB", "podC", "podD"}
    assert sum(1 for r in rows if r["event"] == "sched_shrink") >= 1
    trace = json.load(open(tmp_path / "trace.json"))
    assert {e["tid"] for e in trace["traceEvents"]
            if e.get("ph") == "X"} >= {f"t{i:02d}" for i in range(24)}


def test_battery_cli_reports_zero_violations(tmp_path):
    """``python -m ...tools.sim_run --battery``: the four storms, each
    twice, as a process of its own (the torch-free entry point): exit 0
    and every must-be-zero row 0."""
    out = tmp_path / "battery.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT}.tools.sim_run", "--battery",
         "--workdir", str(tmp_path / "b"), "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    by_name = {r["metric"]: r["value"] for r in map(json.loads, open(out))}
    for name in BATTERY:
        for metric in ("determinism_violations", "fleet_steps_lost",
                       "wal_unbalanced_violations"):
            assert by_name[f"sim_{name}_{metric}"] == 0, (name, metric)
    assert by_name["sim_fleet10k_ranks"] == 10_000
    assert by_name["sim_epidemic10k_evictions"] >= 1
    assert by_name["sim_servespike_autoscale_actions"] >= 2
