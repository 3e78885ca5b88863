"""The port's fault injection (``resilience/faults.py``) and its
``faultline`` driver, held against the JAX package on the CPU.

- ``FaultPlan``: the same ``(kind, step, arg, rank)`` lists, and the same
  per-rank filtering, for every named plan and the explicit grammar over
  three seeds.
- ``FaultyBatches``: the same window poisoned with bitwise-equal bytes
  (uint8, float and int32 token batches); ``nan_loss`` on uint8 refused
  in both packages.
- The loop hooks: a resumed ``FaultInjectionHook`` marks passed faults
  fired and re-arms ``slow_rank`` exactly as the JAX hook does;
  ``heartbeat_flap`` beats on the edge; ``host_loss`` refuses to drill
  without its tombstone seam; ``NaNGuardHook`` raises before
  ``SnapshotHook`` saves the poisoned step.
- ``faultline --device cpu`` in-process: preempt and resume bitwise the
  uninterrupted run, the torn-snapshot fallback, the NaN guard, rank
  targeting, ``FLEET_RESUME_STEP``, a torn journal, and the three
  refusals by name (``--layout zero3``, ``shard_loss``, ``bitflip``).
- The loss tape against the JAX ``faultline``'s, from the JAX initial
  state converted (``convert.py``), dropout off on both sides (hold the
  math, not the RNG): softmax in float32 within rtol 1e-5 per step;
  mnist_cnn, whose forward runs in bfloat16, within rtol 1e-2 per step,
  the JAX step compiled with ``xla_allow_excess_precision=False`` (the
  default jit keeps bf16 temporaries in float32).  Measured here: 1.9e-7
  and 5.6e-3 over 8 steps (bf16 keeps 8 bits; the two libraries round
  at different places in conv, bias add and dense).
"""

import contextlib
import io
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributedtensorflowexample_tpu import models as jax_models
from distributedtensorflowexample_tpu.parallel import sync as jax_sync
from distributedtensorflowexample_tpu.resilience import faults as jf
from distributedtensorflowexample_tpu.training.state import (
    TrainState as JaxTrainState)
from distributedtensorflowexample_tpu_torch import convert
from distributedtensorflowexample_tpu_torch.models import build_model
from distributedtensorflowexample_tpu_torch.parallel.sync import (
    make_train_step)
from distributedtensorflowexample_tpu_torch.resilience import faults as pf
from distributedtensorflowexample_tpu_torch.resilience.fleet import (
    FleetSupervisor)
from distributedtensorflowexample_tpu_torch.resilience.snapshot import (
    SnapshotHook, SnapshotStore)
from distributedtensorflowexample_tpu_torch.tools import faultline
from distributedtensorflowexample_tpu_torch.training.loop import TrainLoop
from distributedtensorflowexample_tpu_torch.training.optimizers import (
    MomentumSGD)
from distributedtensorflowexample_tpu_torch.training.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import faultline as jax_faultline  # noqa: E402
sys.path.pop(0)

pytestmark = pytest.mark.faults

SEEDS = (0, 1, 7)
EXPLICIT = ["kill@37%1", "wedge@2:5.0", "slow_rank@5:0.5%1",
            "preemption@3,wedge@5:0.25", "kill@4%1,preemption@2",
            "kill%1,nan_loss", "heartbeat_flap@6:1.5,journal_torn",
            "host_loss@5:30%1,corrupt_batch%0"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _specs(plan) -> list:
    return [(s.kind, s.step, s.arg, s.rank) for s in plan.specs]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("text", sorted(jf.NAMED_PLANS) + EXPLICIT)
def test_plan_parses_and_filters_as_in_jax(text, seed):
    want = jf.FaultPlan.parse(text, 50, seed)
    got = pf.FaultPlan.parse(text, 50, seed)
    assert _specs(got) == _specs(want)
    for attr in ("batch_specs", "loop_specs", "post_exit_specs"):
        assert [(s.kind, s.step) for s in getattr(got, attr)] == \
            [(s.kind, s.step) for s in getattr(want, attr)]
    for rank in (0, 1, 2):
        assert _specs(got.for_rank(rank)) == _specs(want.for_rank(rank))


def test_plan_refuses_what_jax_refuses():
    assert pf.FAULT_KINDS == jf.FAULT_KINDS
    assert pf.NAMED_PLANS == jf.NAMED_PLANS
    for bad in ("meteor@3", "preemption@0", "kill@3%-1"):
        with pytest.raises(ValueError) as jerr:
            jf.FaultPlan.parse(bad, 10, 0)
        with pytest.raises(ValueError) as perr:
            pf.FaultPlan.parse(bad, 10, 0)
        assert str(perr.value) == str(jerr.value)


def _image_batches(dtype, n: int = 4) -> list:
    rng = np.random.default_rng(3)
    if dtype == "uint8":
        img = rng.integers(0, 256, (n, 4, 6, 6, 1), dtype=np.uint8)
    elif dtype == "int32":
        img = rng.integers(0, 60, (n, 4, 9), dtype=np.int32)
    else:
        img = rng.random((n, 4, 6, 6, 1), dtype=np.float32)
    return [{"image": img[i], "label": np.arange(4, dtype=np.int32)}
            for i in range(n)]


@pytest.mark.parametrize("spn", [1, 2])
@pytest.mark.parametrize("kind,dtype", [
    ("corrupt_batch", "uint8"), ("corrupt_batch", "float32"),
    ("corrupt_batch", "int32"), ("nan_loss", "float32")])
def test_faulty_batches_poison_the_same_window_bitwise(kind, dtype, spn):
    """Same window, same bytes: the garbage comes from the same seeded
    numpy draw; the port hands it back as a tensor."""
    plan = f"{kind}@3,{kind}@6"
    batches = _image_batches(dtype)
    want = list(jf.FaultyBatches(iter(batches),
                                 jf.FaultPlan.parse(plan, 8, 5),
                                 steps_per_next=spn))
    got = list(pf.FaultyBatches(
        iter([{k: torch.from_numpy(v) for k, v in b.items()}
              for b in batches]),
        pf.FaultPlan.parse(plan, 8, 5), steps_per_next=spn))
    assert len(got) == len(want) == len(batches)
    poisoned = 0
    for b, w, g in zip(batches, want, got):
        assert isinstance(g["image"], torch.Tensor)
        w_img, g_img = np.asarray(w["image"]), g["image"].numpy()
        assert g_img.dtype == w_img.dtype == b["image"].dtype
        np.testing.assert_array_equal(g_img.view(np.uint8),
                                      w_img.view(np.uint8))
        poisoned += not np.array_equal(g_img, b["image"])
    assert poisoned == (1 if spn == 1 else 2)


def test_faulty_batches_resume_skips_passed_faults_as_in_jax():
    batches = _image_batches("uint8")
    for start in (0, 2, 3):
        want = list(jf.FaultyBatches(
            iter(batches), jf.FaultPlan.parse("corrupt_batch@3", 8, 0),
            start_step=start))
        got = list(pf.FaultyBatches(
            iter(batches), pf.FaultPlan.parse("corrupt_batch@3", 8, 0),
            start_step=start))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(g["image"]),
                                          np.asarray(w["image"]))


def test_nan_loss_on_uint8_is_refused_in_both():
    batch = {"image": np.zeros((4, 2, 2, 1), np.uint8)}
    for mod, img in ((jf, batch["image"]),
                     (pf, torch.from_numpy(batch["image"]))):
        fb = mod.FaultyBatches(iter([{"image": img}]),
                               mod.FaultPlan.parse("nan_loss@1", 4, 0))
        with pytest.raises(ValueError, match="uint8"):
            next(fb)


class _Loop:
    def __init__(self, start_step: int):
        self.start_step = start_step


def test_resumed_injection_hook_marks_passed_faults_and_rearms_slow_rank(
        monkeypatch):
    """A loop resumed past a fault step has lived through it (marked
    fired, never re-fired); a straggler is a condition, re-armed."""
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    plan = "slow_rank@2:0.25,wedge@3:7.0,slow_rank@9:0.5"
    hooks = {}
    for name, mod in (("jax", jf), ("port", pf)):
        hook = mod.FaultInjectionHook(mod.FaultPlan.parse(plan, 12, 0))
        hook.begin(_Loop(start_step=5))
        slept.clear()
        for step in (6, 9, 10):
            hook.after_step(step, None, {})
        hooks[name] = (sorted(hook._fired), hook._slow_s, list(slept))
    assert hooks["port"] == hooks["jax"]
    fired, slow, sleeps = hooks["port"]
    assert fired == [0, 1, 2] and slow == 0.75
    assert sleeps == [0.25, 0.75, 0.75]     # no 7-s wedge re-fired


def test_wedge_blocks_its_boundary_without_a_beat(tmp_path, monkeypatch):
    """A wedge sleeps its arg once, at its step, and the boundary's beat
    (HeartbeatHook, after the injection) waits behind it: the staleness
    the supervisor's watchdog reads."""
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    hook = pf.FaultInjectionHook(pf.FaultPlan.parse("wedge@3:7.5", 6, 0))
    hook.begin(_Loop(0))
    for step in range(1, 6):
        assert hook.after_step(step, None, {}) is False
        if step == 3:
            assert slept == [7.5]
    assert slept == [7.5]
    assert pf.FaultPlan.parse("wedge@3", 6, 0).specs[0].arg == 2.0


def test_heartbeat_flap_beats_on_the_edge(tmp_path, monkeypatch):
    """The near-miss: the boundary blocks until the beat's age reaches
    the supervisor's edge (minus the margin), then beats."""
    hb = tmp_path / "beat"
    hb.write_text("")
    monkeypatch.setenv("SUPERVISE_HEARTBEAT", str(hb))
    monkeypatch.setenv("SUPERVISE_HEARTBEAT_TIMEOUT_S", "0.4")
    hook = pf.FaultInjectionHook(pf.FaultPlan.parse("heartbeat_flap@2",
                                                    4, 0))
    hook.begin(_Loop(0))
    old = time.time() - 0.1
    os.utime(hb, (old, old))
    t0 = time.monotonic()
    hook.after_step(2, None, {})
    waited = time.monotonic() - t0
    # Up to the edge less the margin, not past it (plus a scheduler's
    # overshoot of the sleep).
    assert 0.4 - 0.1 - pf.FLAP_EDGE_MARGIN_S - 0.05 <= waited < 0.4 + 0.1
    assert time.time() - os.path.getmtime(hb) < 0.1     # beaten
    monkeypatch.delenv("SUPERVISE_HEARTBEAT")
    hook = pf.FaultInjectionHook(pf.FaultPlan.parse("heartbeat_flap@2",
                                                    4, 0))
    hook.begin(_Loop(0))
    with pytest.raises(pf.ModeRefusal, match="SUPERVISE_HEARTBEAT"):
        hook.after_step(2, None, {})


def test_host_loss_needs_its_seam_and_writes_the_fleet_tombstone(
        tmp_path, monkeypatch):
    """Without FLEET_HOST_DOWN_FILE the drill refuses (a host loss whose
    respawn would succeed drills nothing); the tombstone it writes is
    the one the port's fleet reads as a down host, until it expires."""
    monkeypatch.delenv("FLEET_HOST_DOWN_FILE", raising=False)
    hook = pf.FaultInjectionHook(pf.FaultPlan.parse("host_loss@2:5", 4, 0))
    hook.begin(_Loop(0))
    with pytest.raises(ValueError, match="FLEET_HOST_DOWN_FILE"):
        hook.after_step(2, None, {})
    fleet = FleetSupervisor(2, workdir=str(tmp_path / "fleet"))
    pf.mark_host_down(fleet._host_down_path(1), down_s=0.3, rank=1)
    assert fleet.host_down(1) and not fleet.host_down(0)
    time.sleep(0.35)
    assert not fleet.host_down(1)           # self-expired, removed
    assert not os.path.exists(fleet._host_down_path(1))


def test_tear_journal_cuts_the_last_line_as_in_jax(tmp_path):
    for mod in (jf, pf):
        p = tmp_path / f"{mod.__name__}.jsonl"
        p.write_text('{"event": "a"}\n{"event": "task_done", "x": 1}\n')
        assert mod.tear_journal(str(p))
    a, b = (tmp_path / f"{m.__name__}.jsonl" for m in (jf, pf))
    assert a.read_bytes() == b.read_bytes()
    assert not pf.tear_journal(str(tmp_path / "absent.jsonl"))


def _softmax_state():
    lr = np.float32(0.1)
    return TrainState.create(
        build_model("softmax"),
        lambda m: MomentumSGD(m, lambda c: lr, 0.9, fused=False), 0,
        torch.device("cpu"))


def test_nan_guard_raises_before_the_snapshot_of_the_poisoned_step(
        tmp_path):
    x = torch.rand(4, 28, 28, 1, generator=torch.Generator().manual_seed(0))
    batch = {"image": x, "label": torch.arange(4, dtype=torch.int32)}
    store = SnapshotStore(str(tmp_path / "s"), keep=10)
    batches = pf.FaultyBatches(iter([batch] * 6),
                               pf.FaultPlan.parse("nan_loss@3", 6, 0))
    loop = TrainLoop(make_train_step(), batches, 6,
                     hooks=[pf.NaNGuardHook(), SnapshotHook(store)])
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        loop.run(_softmax_state())
    assert store.steps() == [1, 2]


# ---- the faultline driver, in-process on the CPU -------------------------

def _run(capsys, *args) -> tuple[int, dict]:
    rc = faultline.main(["--device", "cpu", *args])
    captured = capsys.readouterr()
    out = [l for l in captured.out.splitlines() if l.strip()]
    rec = json.loads(out[-1]) if out else {}
    rec["_stderr"] = captured.err
    return rc, rec


def test_faultline_preempt_resume_is_bitwise_the_uninterrupted_run(
        tmp_path, capsys, monkeypatch):
    wd = str(tmp_path / "faulted")
    rc, first = _run(capsys, "--plan", "preempt", "--steps", "6",
                     "--workdir", wd, "--model", "mnist_cnn")
    assert rc == 143 and first["status"] == "preempted"
    k = first["step"]
    assert 1 <= k < 6
    monkeypatch.setenv("SUPERVISE_ATTEMPT", "1")   # transient: spent
    rc, resumed = _run(capsys, "--plan", "preempt", "--steps", "6",
                       "--workdir", wd, "--model", "mnist_cnn")
    assert rc == 0 and resumed["start_step"] == k and resumed["step"] == 6
    monkeypatch.delenv("SUPERVISE_ATTEMPT")
    rc, straight = _run(capsys, "--plan", "none", "--steps", "6",
                        "--workdir", str(tmp_path / "straight"),
                        "--model", "mnist_cnn")
    assert rc == 0
    assert resumed["digest"] == straight["digest"]
    assert first["losses"] == straight["losses"][:k]
    assert resumed["losses"] == straight["losses"][k:]


def test_faultline_torn_snapshot_falls_back_to_the_previous_one(
        tmp_path, capsys, monkeypatch):
    wd = str(tmp_path / "torn")
    rc, first = _run(capsys, "--plan", "torn_snapshot", "--steps", "6",
                     "--workdir", wd)
    assert rc == 143
    k = first["step"]
    monkeypatch.setenv("SUPERVISE_ATTEMPT", "1")
    rc, resumed = _run(capsys, "--plan", "torn_snapshot", "--steps", "6",
                       "--workdir", wd)
    monkeypatch.delenv("SUPERVISE_ATTEMPT")
    assert rc == 0 and resumed["start_step"] == k - 1
    assert f"discarding snapshot {k}" in resumed["_stderr"]
    rc, straight = _run(capsys, "--plan", "none", "--steps", "6",
                        "--workdir", str(tmp_path / "s"))
    assert resumed["digest"] == straight["digest"]


@pytest.mark.parametrize("model,plan", [("softmax", "nan_loss@2"),
                                        ("lm_tiny", "corrupt_batch@2")])
def test_faultline_non_finite_loss_exits_and_keeps_the_healthy_snapshot(
        tmp_path, capsys, monkeypatch, model, plan):
    """A NaN batch (softmax) and garbage token ids (the LM's OOV poison)
    both end in the guard: exit 1, and the resume starts from step 1."""
    wd = str(tmp_path / "nan")
    rc, rec = _run(capsys, "--plan", plan, "--steps", "4", "--workdir", wd,
                   "--model", model)
    assert rc == 1 and rec["status"] == "fault" and rec["step"] == 1
    assert "non-finite loss" in rec["error"]
    monkeypatch.setenv("SUPERVISE_ATTEMPT", "1")
    rc, resumed = _run(capsys, "--plan", plan, "--steps", "4",
                       "--workdir", wd, "--model", model)
    assert rc == 0 and resumed["start_step"] == 1 and resumed["step"] == 4


def test_faultline_rank_targeting_and_fleet_resume_step(tmp_path, capsys,
                                                        monkeypatch):
    rc, rec = _run(capsys, "--plan", "preemption@2%1", "--steps", "4",
                   "--workdir", str(tmp_path / "r0"), "--rank", "0")
    assert (rc, rec["status"], rec["step"], rec["rank"]) == (0, "ok", 4, 0)
    monkeypatch.setenv("OBS_RANK", "1")
    rc, rec = _run(capsys, "--plan", "preemption@2%1", "--steps", "4",
                   "--workdir", str(tmp_path / "r1"))
    assert (rc, rec["status"], rec["step"], rec["rank"]) == \
        (143, "preempted", 2, 1)
    # FLEET_RESUME_STEP pins the restore (never this rank's newest), and
    # an agreed step the store cannot prove is refused.
    wd = str(tmp_path / "fl")
    rc, _ = _run(capsys, "--plan", "none", "--steps", "4", "--workdir", wd)
    assert rc == 0
    monkeypatch.setenv("FLEET_RESUME_STEP", "2")
    rc, rec = _run(capsys, "--plan", "none", "--steps", "4", "--workdir",
                   wd)
    assert rc == 0 and rec["start_step"] == 2
    monkeypatch.setenv("FLEET_RESUME_STEP", "9")
    rc, rec = _run(capsys, "--plan", "none", "--steps", "9", "--workdir",
                   wd)
    assert rc == 1 and "not valid in this rank's store" in rec["_stderr"]


def test_faultline_tears_the_supervisor_journal(tmp_path, capsys,
                                                monkeypatch):
    journal = tmp_path / "j.jsonl"
    journal.write_text('{"event": "attempt_start", "attempt": 0}\n')
    monkeypatch.setenv("SUPERVISE_JOURNAL", str(journal))
    rc, rec = _run(capsys, "--plan", "journal_torn", "--steps", "5",
                   "--workdir", str(tmp_path / "w"))
    assert rc == 143                        # paired with a preemption
    assert "tore journal" in rec["_stderr"]
    assert not journal.read_bytes().endswith(b"\n")


@pytest.mark.parametrize("argv,name", [
    (["--layout", "zero3"], "--layout zero3"),
    (["--plan", "shard_loss"], "shard_loss"),
    (["--plan", "bitflip@3%0"], "bitflip")])
def test_faultline_refuses_the_zero3_drills_by_name(tmp_path, capsys, argv,
                                                    name):
    """Once refused by name, now run: ``--layout zero3`` trains as two
    gloo mesh ranks under the default plan (a preemption), which both
    ranks agree on, save and report as one 143; on the tree layout the
    shard plans run their other specs and name their no-op (no shard
    store to damage), as the JAX driver does.  (The zero3 drills
    themselves: tests/test_torch_heal.py.)"""
    rc, rec = _run(capsys, "--workdir", str(tmp_path / "w"), "--mesh", "2",
                   "--steps", "4", *argv)
    if name == "--layout zero3":
        assert rc == 143 and rec["status"] == "preempted"
        assert 1 <= rec["step"] < 4 and len(rec["losses"]) == rec["step"]
        assert rec["digest"] and rec["params_digest"]
        assert os.listdir(tmp_path / "w" / "snapshots")    # shard sets
        return
    assert f"{name} needs the shard store (--layout zero3) — no-op" \
        in rec["_stderr"]
    # shard_loss pairs its damage with a preemption; bitflip@3%0 alone
    assert rc == {"shard_loss": 143, "bitflip": 0}[name]
    assert rec["status"] == {"shard_loss": "preempted", "bitflip": "ok"}[name]


# ---- the loss tape against the JAX faultline -----------------------------

def _no_excess_precision(make_step):
    """The JAX step, compiled with xla_allow_excess_precision=False."""
    def build(**kw):
        jitted, compiled = make_step(**kw), []

        def step(state, batch):
            if not compiled:
                compiled.append(jitted.lower(state, batch).compile(
                    {"xla_allow_excess_precision": False}))
            return compiled[0](state, batch)
        return step
    return build


@pytest.mark.parametrize("model,rtol", [("softmax", 1e-5),
                                        ("mnist_cnn", 1e-2)])
def test_faultline_tape_tracks_the_jax_faultline(tmp_path, monkeypatch,
                                                 capsys, model, rtol):
    """The same plan, steps and seed through both drivers, the port
    starting from the JAX initial state; the preempted run and its
    resume, tape by tape."""
    build = jax_models.build_model
    monkeypatch.setattr(jax_models, "build_model",
                        lambda name, **kw: build(name, dropout=0.0, **kw))
    monkeypatch.setattr(jax_sync, "make_train_step",
                        _no_excess_precision(jax_sync.make_train_step))
    params = jax.tree.map(np.array, JaxTrainState.create(
        build(model, dropout=0.0), optax.sgd(0.1, momentum=0.9),
        jnp.zeros((8, 28, 28, 1)), seed=0).params)

    def init_state(name, seed, device):
        lr = np.float32(faultline.LEARNING_RATE)
        state = TrainState.create(
            build_model(name, dropout=0.0),
            lambda m: MomentumSGD(m, lambda c: lr, faultline.MOMENTUM,
                                  fused=False), seed, device)
        convert.load_into_state(state, params)
        return state

    monkeypatch.setattr(faultline, "init_state", init_state)
    args = ["--plan", "preempt", "--steps", "6", "--seed", "0", "--model",
            model]
    tapes = {}
    for attempt in ("0", "1"):
        monkeypatch.setenv("SUPERVISE_ATTEMPT", attempt)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            jrc = jax_faultline.main(args + ["--workdir",
                                             str(tmp_path / "jax")])
        jrec = json.loads(out.getvalue().strip().splitlines()[-1])
        rc, rec = _run(capsys, *args, "--workdir", str(tmp_path / "port"))
        assert rc == jrc and rec["start_step"] == jrec["start_step"]
        assert [s for s, _ in rec["losses"]] == \
            [s for s, _ in jrec["losses"]]
        tapes[attempt] = (rec["losses"], jrec["losses"])
    assert tapes["0"][0] and tapes["1"][0]
    for got, want in tapes.values():
        np.testing.assert_allclose([l for _, l in got],
                                   [l for _, l in want], rtol=rtol)
