"""The port's shard-damage drills and self-healing gang on the CPU, held
against the JAX package:

- ``faultline --layout zero3 --mesh 2`` (two gloo mesh ranks started by
  the faultline itself, ``parallel/launch.spawn``) against the JAX
  faultline's ZeRO-3 drill over two of this process's virtual CPU
  devices: the same model, plan, steps and seed, the port started from
  the JAX initial parameters (``convert.py``), a preempted attempt and
  its resume; the loss tapes within rtol 1e-5 (PR 8's bound for the
  modes: the step sums its 1/D shares where JAX means the global
  batch);
- ``tools.heal_drill.drill_ckpt`` at ``--mesh 2``: ``shard_loss`` and
  ``bitflip`` after the final save, each reconstructed from its ring
  mirror, bitwise the uninterrupted run, 0 steps lost, 0 restore
  failures, 0 unrecovered mismatches;
- the JAX ``_ckpt_rows``, ``_fleet_rows`` and ``steps_lost`` called on
  the port's own drill reports give the rows the port's functions give;
- ``supervise_fleet --heal`` over two port faultline ranks with a slow
  rank: the remediator evicts loss-free, the relaunch resumes from the
  agreed step, and both ranks end bitwise the uninterrupted run.

The two drills run in the background, one after the other (a module
fixture), while the tape test runs; every torch process uses one
intra-op thread.
"""

import concurrent.futures
import contextlib
import io
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributedtensorflowexample_tpu import compat as jax_compat
from distributedtensorflowexample_tpu.models import build_model as jax_build
from distributedtensorflowexample_tpu.training.state import (
    TrainState as JaxTrainState)
from distributedtensorflowexample_tpu_torch import convert
from distributedtensorflowexample_tpu_torch.models import build_model
from distributedtensorflowexample_tpu_torch.parallel import launch
from distributedtensorflowexample_tpu_torch.resilience.faults import FaultPlan
from distributedtensorflowexample_tpu_torch.tools import (
    faultline, heal_drill, supervise_fleet)
from distributedtensorflowexample_tpu_torch.training.optimizers import (
    MomentumSGD)
from distributedtensorflowexample_tpu_torch.training.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import faultline as jax_faultline  # noqa: E402
import heal_drill as jax_heal_drill  # noqa: E402
sys.path.pop(0)

pytestmark = [pytest.mark.heal, pytest.mark.faults]

MESH = 2
CKPT_STEPS = 6
SLOW_STEPS = 12
FL = [sys.executable, "-m",
      "distributedtensorflowexample_tpu_torch.tools.faultline",
      "--device", "cpu", "--model", "softmax", "--seed", "0",
      "--keep", "50"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as every drill child gets: the CPU kernels'
    summation order follows the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ckpt_drill(base: str) -> dict:
    """``drill_ckpt`` at D=2, with the reports and the straight run it
    reads kept for the row-function comparison."""
    reports, straight = {}, {}
    fleet_drill, straight_zero3 = heal_drill._fleet_drill, \
        heal_drill._straight_zero3

    def keep_report(workdir, plan, *a, **kw):
        reports[plan] = fleet_drill(workdir, plan, *a, **kw)
        return reports[plan]

    def keep_straight(*a, **kw):
        straight.update(straight_zero3(*a, **kw))
        return straight

    heal_drill._fleet_drill = keep_report
    heal_drill._straight_zero3 = keep_straight
    try:
        rows = heal_drill.drill_ckpt(base, model="softmax",
                                     steps=CKPT_STEPS, mesh=MESH,
                                     device="cpu")
    finally:
        heal_drill._fleet_drill = fleet_drill
        heal_drill._straight_zero3 = straight_zero3
    return {"rows": rows, "reports": reports, "straight": straight}


def _healed_gang(base: str) -> dict:
    """``supervise_fleet --heal`` over two faultline ranks, rank 1 slowed
    1 s a step from step 5."""
    os.makedirs(base)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = supervise_fleet.main([
            "--num_ranks", "2", "--heal", "--kill_grace_s", "30",
            "--backoff_base_s", "0.01", "--heal_poll_s", "0.1",
            "--workdir", base, "--seed", "0", "--",
            *FL, "--plan", "slow_rank@5:1.0%1", "--steps", str(SLOW_STEPS),
            "--workdir", os.path.join(base, "rank{rank}")])
    return {"rc": rc, "stderr": err.getvalue()}


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The two drills in the background, one after the other (each
    starts several processes at once; together they would load a shared
    test host more than either alone)."""
    base = tmp_path_factory.mktemp("heal")
    env = {"OBS_ANOMALY_WARMUP": "3", "OBS_ANOMALY_Z": "8",
           "OMP_NUM_THREADS": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    futures = {"ckpt": pool.submit(_ckpt_drill, str(base / "ckpt")),
               "gang": pool.submit(_healed_gang, str(base / "gang")),
               "base": base}
    yield futures
    pool.shutdown(wait=True)
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


# ---- the zero3 tape against the JAX zero3 faultline ----------------------

def _port_zero3_rank(attempts: list, params: dict) -> list:
    """``faultline._zero3_rank`` started from the JAX initial parameters,
    once for each attempt's options, in one group (``launch.spawn``'s
    child)."""
    def init_state(name, seed, device, mesh):
        lr = np.float32(faultline.LEARNING_RATE)
        state = TrainState.create(
            build_model(name),
            lambda m: MomentumSGD(m, lambda c: lr, faultline.MOMENTUM,
                                  fused=False), seed, device, mesh=mesh)
        convert.load_into_state(state, params)
        return state

    faultline.init_state = init_state
    return [faultline._zero3_rank(opts) for opts in attempts]


def test_zero3_tape_tracks_the_jax_zero3_faultline(tmp_path, monkeypatch,
                                                   background):
    # The JAX drill lays its rows over the first two of this process's
    # virtual CPU devices (the count is pinned once, by the conftest).
    monkeypatch.setattr(jax_compat, "set_num_cpu_devices", lambda n: None)
    monkeypatch.setattr(jax_compat, "cpu_collective_flags", lambda: None)
    params = _jax_params()
    steps = 6
    args = ["--plan", "preempt", "--steps", str(steps), "--seed", "0",
            "--model", "softmax", "--keep", "50", "--layout", "zero3",
            "--mesh", str(MESH)]
    jax_recs, attempts = [], []
    for attempt in (0, 1):
        monkeypatch.setenv("SUPERVISE_ATTEMPT", str(attempt))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            jrc = jax_faultline.main(args + ["--workdir",
                                             str(tmp_path / "jax")])
        jax_recs.append((jrc, json.loads(
            out.getvalue().strip().splitlines()[-1])))
        plan = FaultPlan.parse("preempt", steps, 0)
        if attempt:
            plan = FaultPlan([], seed=0, name="preempt (cleared)")
        attempts.append({
            "model": "softmax", "seed": 0, "batch": 8, "steps": steps,
            "workdir": str(tmp_path / "port"), "keep": 50,
            "snapshot_every": 1, "resume": True, "agreed": "",
            "device": "cpu", "plan": plan, "rank": 0, "health": "",
            "heartbeat": ""})
    ranks = launch.spawn(_port_zero3_rank, MESH, "gloo", (attempts, params),
                         timeout_s=120)
    tapes = []
    for i, (jrc, jrec) in enumerate(jax_recs):
        parts = [r[i] for r in ranks]
        assert [p["step"] for p in parts] == [parts[0]["step"]] * MESH
        rec = parts[0]
        assert jrc == {"preempted": 143, "ok": 0}[rec["status"]]
        assert rec["start_step"] == jrec["start_step"]
        assert [s for s, _ in rec["losses"]] == \
            [s for s, _ in jrec["losses"]]
        tapes.append((rec["losses"], jrec["losses"]))
    assert tapes[0][0] and tapes[1][0]
    assert tapes[1][0][-1][0] == steps
    for got, want in tapes:
        np.testing.assert_allclose([l for _, l in got],
                                   [l for _, l in want], rtol=1e-5)


def _jax_params() -> dict:
    import jax
    state = JaxTrainState.create(jax_build("softmax"),
                                 optax.sgd(0.1, momentum=0.9),
                                 jnp.zeros((8, 28, 28, 1)), seed=0)
    return jax.tree.map(np.array, state.params)


# ---- the ckpt drill ------------------------------------------------------

def test_drill_ckpt_reconstructs_bitwise_with_no_step_lost(background):
    out = background["ckpt"].result(timeout=600)
    rows = {}
    for row in out["rows"]:
        rows.setdefault(row["metric"], []).append(row)
    for plan, event in (("shard_loss", "ckpt_reconstruct"),
                        ("bitflip", "ckpt_digest_mismatch")):
        (lost,) = rows[f"heal_ckpt_{plan}_steps_lost"]
        assert lost["value"] == 0 and lost["platform"] == "cpu"
        assert lost["detail"]["bitwise_resume"] is True
        assert lost["detail"]["reconstructs"] >= 1
        assert lost["detail"]["detect_event"] == event
        assert rows[f"heal_ckpt_{plan}_mttr_ms"][0]["value"] is not None
    assert [r["value"] for r in rows["ckpt_shard_restore_failures"]] \
        == [0, 0]
    assert [r["value"] for r in rows["ckpt_digest_mismatch_unrecovered"]] \
        == [0, 0]
    for report in out["reports"].values():
        final = [r for r in report["outs"] if r["status"] == "ok"]
        assert final and final[-1]["params_digest"] \
            == out["straight"]["params_digest"]


def test_jax_row_functions_agree_on_the_port_reports(background):
    out = background["ckpt"].result(timeout=600)
    straight = out["straight"]
    for plan, event in (("shard_loss", "ckpt_reconstruct"),
                        ("bitflip", "ckpt_digest_mismatch")):
        report = out["reports"][plan]
        name = f"ckpt_{plan}"
        assert heal_drill._ckpt_rows(name, report, straight,
                                     detect_event=event, model="softmax",
                                     platform="cpu") \
            == jax_heal_drill._ckpt_rows(name, report, straight,
                                         detect_event=event,
                                         model="softmax")
        for kinds, actions in ((("straggler",), ("heal_evict",)),
                               (("nan_loss",), ("heal_rollback",))):
            assert heal_drill._fleet_rows(
                name, report, straight, kinds=kinds, action_events=actions,
                model="softmax", platform="cpu") \
                == jax_heal_drill._fleet_rows(
                    name, report, straight, kinds=kinds,
                    action_events=actions, model="softmax")
    tape = [(1, 2.5), (2, float("nan")), (3, 1.25), (4, 1.0)]
    healed = [[(1, 2.5)], [(2, 0.5), (3, 1.25)]]
    assert heal_drill.steps_lost(tape, healed) \
        == jax_heal_drill.steps_lost(tape, healed) == 2


# ---- supervise_fleet --heal ----------------------------------------------

def test_supervise_fleet_heal_evicts_a_slow_rank_bitwise(background):
    gang = background["gang"].result(timeout=600)
    base = background["base"] / "gang"
    assert gang["rc"] == 0, gang["stderr"][-3000:]
    events = [json.loads(l) for l in open(base / "RUNS.jsonl")]
    evict = [e for e in events if e["event"] == "heal_evict"]
    assert evict and evict[0]["rank"] == 1
    assert sorted(p.name for p in base.glob("launch*")) == ["launch0",
                                                             "launch1"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert faultline.main(FL[3:] + [
            "--plan", "none", "--steps", str(SLOW_STEPS), "--workdir",
            str(background["base"] / "straight")]) == 0
    straight = json.loads(out.getvalue().strip().splitlines()[-1])
    finals = [json.loads((base / "launch1" / f"rank{r}_attempt0.out")
                         .read_text().strip().splitlines()[-1])
              for r in (0, 1)]
    agreed = finals[0]["start_step"]
    assert 5 <= agreed < SLOW_STEPS
    for f in finals:
        assert f["status"] == "ok" and f["step"] == SLOW_STEPS
        assert f["start_step"] == agreed
        assert f["digest"] == straight["digest"]
        assert f["losses"] == straight["losses"][agreed:]
