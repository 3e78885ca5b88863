"""The port's remediation engine (``resilience/remediate.py``) held against
the JAX package's on the CPU: the same scripted ``AnomalyEvent`` streams
through both ``Remediator``s with fake actuators and one injected clock
give the same dispositions and the same ``heal_*`` journal and ledger
rows (without their ``ts``); both replay the same hand-written journal
alike; the watchers read the same health files, ledger and stats into
the same events; ``mttr_seeded_cooldown_s`` reads the committed
``HEAL_lm_cpu_r16.json`` alike; and the rollback actuator, each package
on its own snapshot stores with the same steps and the same damage,
pins the same step and discards the same steps.  Everything here is
stdlib and file IO, except the rollback stores (the softmax state).
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributedtensorflowexample_tpu.models import build_model as jax_build
from distributedtensorflowexample_tpu.resilience import remediate as jrem
from distributedtensorflowexample_tpu.resilience import (
    snapshot as jsnap)
from distributedtensorflowexample_tpu.resilience import (
    supervisor as jsup)
from distributedtensorflowexample_tpu.training.state import (
    TrainState as JaxTrainState)
from distributedtensorflowexample_tpu_torch.resilience import remediate as prem
from distributedtensorflowexample_tpu_torch.resilience import (
    snapshot as psnap)
from distributedtensorflowexample_tpu_torch.resilience import (
    supervisor as psup)
from distributedtensorflowexample_tpu_torch.tools import faultline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jrem, jsup), "port": (prem, psup)}

pytestmark = pytest.mark.heal


def _rows(path) -> list:
    """Every whole row of a JSON-lines file without its wall time (a torn
    line, as the journals' own reader does, skipped)."""
    if not os.path.exists(path):
        return []
    out = []
    for line in open(path):
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            continue
        row.pop("ts", None)
        out.append(row)
    return out


def _remediator(pkg, wd, actuators, clock, **kw):
    rem, sup = PACKAGES[pkg]
    guard = {k: kw.pop(k) for k in ("flap_n", "flap_window_s",
                                    "cooldown_s", "budget") if k in kw}
    guard.setdefault("flap_n", 2)
    guard.setdefault("flap_window_s", 30.0)
    guard.setdefault("cooldown_s", 10.0)
    guard.setdefault("budget", 4)
    return rem.Remediator(
        sup.Journal(str(wd / "heal.jsonl")), str(wd / "RUNS.jsonl"),
        actuators=actuators, scope="job1",
        guardrails=rem.Guardrails(clock=lambda: clock[0], **guard), **kw)


def _fake_actuators(calls: list) -> dict:
    def evict(ev):
        calls.append(("evict", ev.key))
        return {"stopped": ev.key}

    def rollback(ev):
        calls.append(("rollback", ev.key))
        return {"noop": "nothing newer than the last good step"}

    def quarantine(ev):
        calls.append(("quarantine", ev.key))
        raise OSError("tombstone directory is read-only")

    return {"evict": evict, "rollback": rollback, "quarantine": quarantine}


# Each scenario: remediator options, then (clock advance s, event kwargs).
_STRAGGLER = {"kind": "straggler", "key": "straggler:rank1", "rank": 1}
_NAN = {"kind": "nan_loss", "key": "rank0:nan_loss:5", "rank": 0, "step": 5}
_LOST = {"kind": "rank_lost", "key": "ledger:rank_lost:rank1:0", "rank": 1}
SCENARIOS = {
    "flap": ({}, [(0, _STRAGGLER), (60, _STRAGGLER), (1, _STRAGGLER),
                  (1, _STRAGGLER)]),
    "cooldown": ({"flap_n": 1}, [(0, _STRAGGLER)] + [(1, _STRAGGLER)] * 5
                 + [(10, _STRAGGLER)]),
    "budget": ({"flap_n": 1, "cooldown_s": 0.0, "budget": 2},
               [(1, dict(_STRAGGLER, key=f"s{i}")) for i in range(5)]),
    "dry_run": ({"flap_n": 1, "dry_run": True},
                [(0, _STRAGGLER), (1, _STRAGGLER), (1, _NAN)]),
    "noop_error_unknown": (
        {"flap_n": 1},
        [(0, _NAN), (1, _NAN), (0, dict(_LOST, key="l0")),
         (0, dict(_LOST, key="l1")), (0, dict(_LOST, key="l2")),
         (1, dict(_LOST, key="l3")), (11, dict(_LOST, key="l4")),
         (0, {"kind": "mystery", "key": "m"}),
         (0, {"kind": "serve_p99_breach", "key": "p", "episode": "e0"})]),
}


def _drive(pkg, wd, opts, stream) -> tuple:
    rem_mod = PACKAGES[pkg][0]
    opts = dict(opts)
    clock, calls = [1000.0], []
    rem = _remediator(pkg, wd, _fake_actuators(calls), clock, **opts)
    out = []
    for dt, kw in stream:
        clock[0] += dt
        out.append(rem.observe(rem_mod.AnomalyEvent(scope="job1", **kw)))
    return (out, calls, rem.guardrails.actions_used,
            _rows(wd / "heal.jsonl"), _rows(wd / "RUNS.jsonl"))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_event_streams_decide_as_in_jax(tmp_path, name):
    opts, stream = SCENARIOS[name]
    got = {}
    for pkg in PACKAGES:
        (tmp_path / pkg).mkdir()
        got[pkg] = _drive(pkg, tmp_path / pkg, opts, stream)
    assert got["port"] == got["jax"]
    dispositions = got["port"][0]
    assert any(d not in ("flap", "detected") for d in dispositions)


def test_scenarios_cover_every_guardrail(tmp_path):
    """The scripted streams reach each disposition the engine has (so
    the comparison above is not vacuous)."""
    seen = set()
    for name, (opts, stream) in SCENARIOS.items():
        (tmp_path / name).mkdir()
        # A noop actuator's disposition is "noop: <its reason>".
        seen.update(d.split(":")[0]
                    for d in _drive("port", tmp_path / name, opts, stream)[0])
    assert seen >= {"flap", "cooldown", "budget", "dry_run", "acted",
                    "noop", "error", "detected", "no_actuator"}


def _hand_journal(path) -> None:
    """A journal a remediator left when it died: one applied evict, one
    errored quarantine, a detect, and an unmatched rollback intent."""
    rows = [
        {"ts": 100.0, "event": "heal_detect", "key": "straggler:rank1",
         "kind": "straggler", "job": "job1"},
        {"ts": 100.5, "event": "heal_intent", "seq": 1, "action": "evict",
         "key": "straggler:rank1", "kind": "straggler", "job": "job1"},
        {"ts": 100.6, "event": "heal_evict", "seq": 1,
         "key": "straggler:rank1", "kind": "straggler", "job": "job1"},
        {"ts": 101.0, "event": "heal_intent", "seq": 2,
         "action": "quarantine", "key": "l0", "kind": "rank_lost",
         "job": "job1", "rank": 1},
        {"ts": 101.1, "event": "heal_quarantine", "seq": 2, "key": "l0",
         "kind": "rank_lost", "job": "job1", "error": "read-only"},
        {"ts": 102.0, "event": "heal_detect", "key": "rank0:nan_loss:5",
         "kind": "nan_loss", "job": "job1"},
        {"ts": 102.5, "event": "heal_intent", "seq": 3,
         "action": "rollback", "key": "rank0:nan_loss:5",
         "kind": "nan_loss", "job": "job1", "rank": 0, "step": 5},
        {"ts": 103.0, "event": "sched_intent", "seq": 9, "action": "place"},
    ]
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
        f.write('{"ts": 104.0, "event": "heal_inte')       # torn tail


def test_replay_of_a_hand_written_journal_matches_jax(tmp_path):
    got = {}
    for pkg in PACKAGES:
        wd = tmp_path / pkg
        wd.mkdir()
        _hand_journal(wd / "heal.jsonl")
        calls = []
        acts = {"rollback": lambda ev: calls.append(
            (ev.kind, ev.key, ev.rank, ev.step, ev.source)) or {"ok": 1}}
        clock = [1000.0]
        rem = _remediator(pkg, wd, acts, clock, budget=4)
        again = rem.observe(PACKAGES[pkg][0].AnomalyEvent(
            kind="straggler", key="straggler:rank1", scope="job1"))
        got[pkg] = (calls, rem.guardrails.actions_used, again,
                    _rows(wd / "heal.jsonl"), _rows(wd / "RUNS.jsonl"))
    assert got["port"] == got["jax"]
    calls, used = got["port"][:2]
    assert calls == [("nan_loss", "rank0:nan_loss:5", 0, 5, "replay")]
    assert used == 2                # the evict and the replayed rollback


def _health(path, rank, flags, step=7, kind="rank"):
    payload = {"version": 1, "kind": kind, "rank": rank, "step": step,
               "updated_unix": 1700000000.0 + rank,
               "flags": {k: {"firing": firing, "fired_step": fired}
                         for k, (firing, fired) in flags.items()}}
    with open(path, "w") as f:
        json.dump(payload, f)


def _watch_world(wd) -> None:
    _health(wd / "health_rank0.json", 0,
            {"nan_loss": (False, 4), "step_time_regression": (True, 6),
             "loss_plateau": (False, None)})
    _health(wd / "health_rank1.json", 1,
            {"nan_loss": (False, None), "step_time_regression": (False, 3),
             "loss_plateau": (True, 5)})
    with open(wd / "health.json", "w") as f:
        json.dump({"version": 1, "kind": "fleet", "stragglers": [1],
                   "skew": {"why": {"1": "lag 4 steps"}},
                   "updated_unix": 1700000002.0}, f)
    with open(wd / "RUNS.jsonl", "w") as f:
        for row in ({"event": "run_start", "ts": 1.0},
                    {"event": "anomaly", "kind": "straggler", "rank": 1,
                     "fired_step": 6, "ts": 2.0, "task": "t"},
                    {"event": "rank_lost", "rank": 1, "ts": 3.0,
                     "error": "host down"},
                    {"event": "rank_lost", "rank": 1, "step": 9, "ts": 4.0}):
            f.write(json.dumps(row) + "\n")


def _events(evs) -> list:
    return [(e.kind, e.key, e.scope, e.rank, e.step, e.source, e.episode,
             e.detail) for e in evs]


def test_watchers_read_the_same_world_as_in_jax(tmp_path):
    serve = [{"p99_ms": 10.0, "completed": 4}, {"p99_ms": 300.0,
                                                "completed": 9},
             {"p99_ms": 320.0, "completed": 12}, {"p99_ms": 50.0,
                                                  "completed": 20},
             {"p99_ms": 400.0, "completed": 30}, {}]
    load = [{"offered_per_s": 50.0, "replicas": 1},
            {"offered_per_s": 5.0, "replicas": 3},
            {"offered_per_s": 20.0, "replicas": 2},
            {"offered_per_s": 90.0, "replicas": 2},
            {"replicas": 2}]
    got = {}
    for pkg in PACKAGES:
        rem = PACKAGES[pkg][0]
        wd = tmp_path / pkg
        wd.mkdir()
        _watch_world(wd)
        health = rem.HealthWatcher(str(wd / "health_rank*.json"),
                                   fleet_health=str(wd / "health.json"),
                                   scope="drill")
        ledger = rem.LedgerWatcher(str(wd / "RUNS.jsonl"), scope="drill")
        polls = [_events(health.poll()), _events(ledger.poll()),
                 _events(ledger.poll())]
        with open(wd / "RUNS.jsonl", "a") as f:
            f.write(json.dumps({"event": "rank_lost", "rank": 0,
                                "ts": 5.0}) + "\n")
        polls.append(_events(ledger.poll()))
        it = iter(serve)
        sw = rem.ServeWatcher(lambda: next(it), breach_ms=250.0)
        polls.append([_events(sw.poll()) for _ in serve])
        it2 = iter(load)
        aw = rem.AutoscaleWatcher(lambda: next(it2), knee_per_replica=20.0,
                                  min_replicas=1)
        polls.append([_events(aw.poll()) for _ in load])
        got[pkg] = polls
    assert got["port"] == got["jax"]
    health, ledger, again, appended = got["port"][:4]
    assert {k for k, *_ in health} == {"nan_loss", "step_time_regression",
                                       "loss_plateau", "straggler"}
    assert [k for k, *_ in ledger] == ["straggler", "rank_lost",
                                       "rank_lost"]
    assert again == [] and [k for k, *_ in appended] == ["rank_lost"]


def test_mttr_seeded_cooldown_reads_the_heal_record_as_in_jax(tmp_path,
                                                              monkeypatch):
    record = os.path.join(REPO, "HEAL_lm_cpu_r16.json")
    monkeypatch.delenv("HEAL_COOLDOWN_S", raising=False)
    got = {pkg: (rem.mttr_seeded_cooldown_s(record),
                 rem.mttr_seeded_cooldown_s(record, margin=1.5,
                                            floor_s=60.0),
                 rem.mttr_seeded_cooldown_s(str(tmp_path / "missing.json")),
                 os.path.basename(rem.newest_heal_record(REPO)))
           for pkg, (rem, _) in PACKAGES.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0] > 5.0 and got["port"][2] == 30.0


def _port_store_steps(directory, steps) -> None:
    state = faultline.init_state("softmax", 0, torch.device("cpu"))
    store = psnap.SnapshotStore(directory, keep=10)
    for s in steps:
        state.step = s
        store.save(state, force=True)


def _jax_store_steps(directory, steps) -> None:
    state = JaxTrainState.create(jax_build("softmax"),
                                 optax.sgd(0.1, momentum=0.9),
                                 jnp.zeros((2, 28, 28, 1), jnp.float32))
    store = jsnap.SnapshotStore(directory, keep=10)
    for s in steps:
        store.save(state.replace(step=jnp.asarray(s)), force=True)


def test_rollback_pins_and_discards_as_in_jax(tmp_path):
    """Rank 0 holds steps 3-7, rank 1 steps 3-6 with step 6 torn and
    step 4's payload deleted: the common valid steps are {3, 5}, the
    last good below the NaN at step 6 is 5, and everything newer goes
    on each rank — in each package over its own stores."""
    got = {}
    for pkg, write in (("jax", _jax_store_steps), ("port", _port_store_steps)):
        rem, _ = PACKAGES[pkg]
        template = str(tmp_path / pkg / "rank{rank}" / "snaps")
        write(template.replace("{rank}", "0"), (3, 4, 5, 6, 7))
        r1 = template.replace("{rank}", "1")
        write(r1, (3, 4, 5, 6))
        snap = jsnap if pkg == "jax" else psnap
        snap.SnapshotStore(r1).tear_latest()
        os.remove(os.path.join(r1, "snap_00000004.npz"))
        act = rem.make_rollback_actuator(template, ranks=(0, 1))
        ev = rem.AnomalyEvent(kind="nan_loss", key="n", step=6)
        got[pkg] = (act(ev), act(ev),
                    [snap.valid_steps(template.replace("{rank}", str(r)))
                     for r in (0, 1)])
    assert got["port"] == got["jax"]
    first, again, valid = got["port"]
    assert first["last_good"] == 5
    assert first["discarded"] == {"0": [6, 7], "1": [6]}
    assert again["discarded"] == {"0": [], "1": []}
    assert valid == [[3, 4, 5], [3, 5]]


def test_the_closed_schemas_and_defaults_equal_jax():
    assert prem.HEAL_EVENTS == jrem.HEAL_EVENTS
    assert prem.HEAL_ACTIONS == jrem.HEAL_ACTIONS
    assert {k: (r.action, r.flap_n) for k, r in prem.DEFAULT_POLICY.items()} \
        == {k: (r.action, r.flap_n) for k, r in jrem.DEFAULT_POLICY.items()}


@pytest.mark.parametrize("kind,offered,current", [
    ("serve_overload", 95.0, 2), ("serve_overload", 500.0, 8),
    ("serve_underload", 3.0, 4), ("serve_underload", 3.0, 1),
    ("serve_overload", 30.0, 2)])
def test_slo_and_autoscale_actuators_act_as_in_jax(kind, offered, current):
    got = {}
    for pkg, (rem, _) in PACKAGES.items():
        box = {"replicas": current, "slo": 400.0}
        scale = rem.make_autoscale_actuator(
            lambda: box["replicas"],
            lambda n: box.__setitem__("replicas", n),
            knee_per_replica=20.0, min_replicas=1, max_replicas=8)
        tighten = rem.make_slo_actuator(
            lambda: box["slo"], lambda v: box.__setitem__("slo", v), 150.0)
        ev = rem.AnomalyEvent(kind=kind, key="k",
                              detail={"offered_per_s": offered,
                                      "p99_ms": 410.0})
        got[pkg] = (scale(ev), tighten(ev), tighten(ev), dict(box))
    assert got["port"] == got["jax"]
    assert np.isfinite(got["port"][3]["slo"])


_STALE_CHILD = """
import json, os, signal, sys, time
signal.signal(signal.SIGTERM, lambda s, f: sys.exit(143))
if int(os.environ.get("SUPERVISE_ATTEMPT", "0")) == 0:
    # the fleet's aggregate health: rank 0 straggles
    with open(sys.argv[1], "w") as f:
        json.dump({"version": 1, "kind": "fleet", "stragglers": [0],
                   "skew": {"why": {"0": "lag 10 steps"}},
                   "updated_unix": time.time()}, f)
    time.sleep(60)
time.sleep(1.5)      # a relaunch slower than the cooldown to start
"""


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_a_relaunch_is_not_evicted_for_its_predecessors_health(tmp_path,
                                                              pkg):
    """The first launch's fleet health names rank 0 a straggler, and the
    gang is evicted for it; the relaunch runs clean but takes longer
    than the cooldown and has not rewritten the fleet's health file (on
    the card a relaunch's agreement pass and start-up took ~29 s against
    a 30 s cooldown).  The port's ``run_remediated`` does not observe a
    file written before the running launch started: one heal, status
    ok.  The JAX package's observes it once the cooldown has run out and
    evicts the relaunch too, up to ``max_heals``."""
    rem_mod, sup_mod = PACKAGES[pkg]
    fleet_mod = __import__(rem_mod.__name__.rsplit(".", 1)[0] + ".fleet",
                           fromlist=["FleetSupervisor"])
    child = tmp_path / "child.py"
    child.write_text(_STALE_CHILD)
    workdir = str(tmp_path / "fleet")
    journal = sup_mod.Journal(os.path.join(workdir, "fleet.jsonl"))
    ledger = os.path.join(workdir, "RUNS.jsonl")

    def make_fleet():
        return fleet_mod.FleetSupervisor(
            1, policy=sup_mod.RetryPolicy(retries=0, backoff_base_s=0.01),
            journal=journal, kill_grace_s=5.0, poll_s=0.02, seed=0,
            workdir=workdir, ledger_path=ledger)

    target = rem_mod.FleetTarget()
    rem = rem_mod.Remediator(
        journal=journal, ledger_path=ledger, scope="drill",
        actuators={"evict": rem_mod.make_evict_actuator(target)},
        guardrails=rem_mod.Guardrails(flap_n=2, cooldown_s=0.5, budget=4,
                                      flap_window_s=30.0))
    aggregate = str(tmp_path / "fleet_health.json")
    watchers = [rem_mod.HealthWatcher(
        os.path.join(workdir, "health_rank*.json"), fleet_health=aggregate,
        scope="drill")]
    out = rem_mod.run_remediated(
        make_fleet, [sys.executable, str(child), aggregate], rem, watchers,
        target=target, name="drill", poll_s=0.1, max_heals=2)
    evicts = [r for r in _rows(ledger) if r.get("event") == "heal_evict"]
    if pkg == "port":
        assert (out["status"], out["healed"], len(evicts)) == ("ok", 1, 1)
        assert [r.status for r in out["results"]] == ["evicted", "ok"]
    else:
        assert (out["status"], out["healed"], len(evicts)) == (
            "evicted", 2, 3)
