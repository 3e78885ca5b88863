"""Checkpoints, resume and preemption on the CPU: the port's
``training/checkpoint.py`` (the torch-native format, keep-N rotation,
the run metadata and the restore refusals), the checkpoint and
interrupt paths of the loop, and the engine's resume and SIGTERM exit,
against the JAX package where it defines the behaviour.

One group of 2 gloo ranks starts once for the module; the SIGTERM drills
(one trainer process, and one that starts 2 ranks) run beside it, and
the JAX side here meanwhile.  The rank worker imports no JAX.

Tolerances: a resumed run against the uninterrupted one, bitwise (the
parameters, momentum, optimizer count and every rank's dropout generator
of the final checkpoint, and the loss at the last step), dropout on.
The resumed tape against the JAX package's resumed tape: config 3's
bfloat16 bound (``tests/test_torch_slice.py``), within 1e-2 relative.
The refusal texts: equal to the JAX Engine's.
"""

import os
import re
import signal
import struct
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from distributedtensorflowexample_tpu_torch import convert
from distributedtensorflowexample_tpu_torch.config import parse_flags
from distributedtensorflowexample_tpu_torch.data.synthetic import (
    make_synthetic)
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
from distributedtensorflowexample_tpu_torch.engine import engine as port_engine
from distributedtensorflowexample_tpu_torch.parallel import launch
from distributedtensorflowexample_tpu_torch.parallel.mesh import Mesh
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
from distributedtensorflowexample_tpu_torch.training import checkpoint
from distributedtensorflowexample_tpu_torch.training.checkpoint import (
    CheckpointManager)
from distributedtensorflowexample_tpu_torch.training.hooks import (
    CheckpointHook, Hook)
from distributedtensorflowexample_tpu_torch.training.loop import TrainLoop

B, ROWS, LR, MU = 8, 256, 0.05, 0.9
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINER = "distributedtensorflowexample_tpu_torch.trainers.trainer_sync_mnist"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread here, and so in every spawned rank."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _split():
    return make_synthetic(ROWS, (28, 28, 1), 10, seed=0, sample_seed=1)


def _write_idx(data_dir, split, images, labels):
    names = {"train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
             "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}
    img, lbl = names[split]
    u8 = np.round(images[..., 0] * 255).astype(np.uint8)
    (data_dir / img).write_bytes(struct.pack(">IIII", 2051, *u8.shape)
                                 + u8.tobytes())
    (data_dir / lbl).write_bytes(struct.pack(">II", 2049, len(labels))
                                 + labels.astype(np.uint8).tobytes())


def _tiny_mnist(data_dir):
    """512 train and 128 test rows as IDX files, so a trainer process
    loads a small split through --data_dir."""
    for split, (num, sample_seed) in {"train": (512, 1),
                                      "test": (128, 2)}.items():
        _write_idx(data_dir, split, *make_synthetic(
            num, (28, 28, 1), 10, seed=0, sample_seed=sample_seed))


def _argv(data_dir, log_dir, *extra) -> list[str]:
    """config 3's trainer on the tiny split, dropout on (its default)."""
    return ["--device", "cpu", "--dataset", "mnist", "--data_dir",
            str(data_dir), "--batch_size", str(B), "--log_every", "3",
            "--log_dir", str(log_dir), *extra]


def _numpy(obj):
    """Tensors to numpy arrays, through dicts: a tensor sent back from a
    rank would be shared through a file descriptor that dies with it."""
    if isinstance(obj, dict):
        return {k: _numpy(v) for k, v in obj.items()}
    return obj.numpy() if isinstance(obj, torch.Tensor) else obj


def _final_part(log_dir, step, rank=0):
    return _numpy(torch.load(os.path.join(log_dir, "checkpoints", str(step),
                                          f"rank-{rank}.pt"),
                             weights_only=True))


def _stop_and_resume(data_dir, dirs, *extra) -> dict:
    """config 3 for 6 steps with --checkpoint_every 3, and the same
    stopped at 3 and resumed to 6 in another log dir: both summaries and
    their final checkpoints."""
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_sync_mnist)
    out = {}
    for name, stops in (("straight", (6,)), ("resumed", (3, 6))):
        for steps in stops:
            summary = trainer_sync_mnist.main(_argv(
                data_dir, dirs[name], "--checkpoint_every", "3",
                "--train_steps", str(steps), *extra))
        out[name] = {"summary": summary,
                     "part": _final_part(dirs[name], 6)}
    return out


# --- the rank worker (runs in the spawned ranks; no JAX) ------------------

def _group_runs(data_dir, dirs) -> dict:
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_ps_mnist)
    out = {"sync": _stop_and_resume(data_dir, dirs)}
    # An async checkpoint of 2 workers, for the refusals here.
    trainer_ps_mnist.main(_argv(data_dir, dirs["async"], "--train_steps",
                                "2", "--async_period", "2"))
    return out


# --- the drills -----------------------------------------------------------

def _drill(data_dir, log_dir, ranks: int) -> dict:
    """The preemption drill (the JAX package's
    ``test_demo_sigterm_preemption_saves_and_resumes``): the trainer in a
    process of its own (signal handlers need its main thread), SIGTERM
    after its first log line, then a restart in the same --log_dir."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    args = [sys.executable, "-u", "-m", TRAINER, *_argv(
        data_dir, log_dir, "--steps_per_loop", "1", "--num_devices",
        str(ranks))]
    p = subprocess.Popen(args + ["--train_steps", "100000"], cwd=REPO,
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    lines, first = [], threading.Event()

    def drain():
        for line in p.stdout:
            lines.append(line)
            if line.startswith("step ") and "loss" in line:
                first.set()
        first.set()                 # EOF: unblock the waiter either way

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    try:
        first.wait(timeout=240)
        alive = p.poll() is None
        p.send_signal(signal.SIGTERM)
        p.wait(timeout=240)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        reader.join(timeout=30)
    out = {"alive_at_signal": alive, "rc": p.returncode,
           "text": "".join(lines)}
    m = re.search(r"SIGTERM at step (\d+): checkpoint saved", out["text"])
    if m:
        out["saved"] = int(m.group(1))
        r = subprocess.run(args + ["--train_steps", str(out["saved"] + 4)],
                           cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=240)
        out["restart"] = (r.returncode, r.stdout + r.stderr)
    return out


# --- the JAX side ---------------------------------------------------------

def _jax_resumed_tape(tmp):
    """config 3 in the JAX package (dropout off, ``optax.sgd`` with
    momentum): 3 steps, its CheckpointManager's save, a restore into a
    state of another seed and a dataset started at the restored step, 3
    more steps.  Returns (tape, initial params, index tape)."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    from distributedtensorflowexample_tpu.models.mnist_cnn import (
        MnistCNN as JaxMnistCNN)
    from distributedtensorflowexample_tpu.parallel.sync import (
        make_indexed_train_step as jax_make_indexed_train_step)
    from distributedtensorflowexample_tpu.training.checkpoint import (
        CheckpointManager as JaxCheckpointManager)
    from distributedtensorflowexample_tpu.training.state import (
        TrainState as JaxTrainState)
    x, y = _split()
    make = lambda seed: JaxTrainState.create(
        JaxMnistCNN(dropout_rate=0.0), optax.sgd(LR, momentum=MU),
        jnp.zeros((B, 28, 28, 1)), seed=seed)
    dataset = lambda start: JaxDeviceDataset(x, y, B, seed=0,
                                             start_step=start,
                                             dequant_impl="pallas")
    jds = dataset(0)
    perms = [np.asarray(jds._make_perm(jnp.asarray(e, jnp.int32)))
             for e in range(2)]
    jstate = make(0)
    params0 = jax.tree.map(lambda a: np.array(a, copy=True), jstate.params)
    jstep = jax_make_indexed_train_step(
        B, jds.steps_per_epoch, ce_impl="pallas", dequant_impl="pallas",
        num_slots=jds.num_slots)
    tape = []
    for _ in range(3):
        jstate, m = jstep(jstate, next(jds))
        tape.append(float(m["loss"]))
    mgr = JaxCheckpointManager(str(tmp), async_save=False)
    mgr.save(3, jstate)
    mgr.wait()
    jstate = mgr.restore(make(9))
    mgr.close()
    jds = dataset(int(jstate.step))
    for _ in range(3):
        jstate, m = jstep(jstate, next(jds))
        tape.append(float(m["loss"]))
    return tape, params0, perms


def _port_resumed_tape(params0, perms, tmp):
    """The same in the port, from the converted JAX init over the JAX
    index tape, through the port's manager."""
    cfg = parse_flags(["--device", "cpu", "--momentum", str(MU),
                       "--learning_rate", str(LR), "--dropout", "0",
                       "--pallas_ce", "true", "--dequant_impl", "pallas",
                       "--batch_size", str(B)])
    engine, mesh = Engine(RunSpec("mnist_cnn", "mnist", cfg)), Mesh(CPU)
    built = engine.build(mesh, data=_split(), perm_fn=perms.__getitem__)
    convert.load_into_state(built.state, params0)
    tape = [float(built.step(built.state, next(built.ds))[1]["loss"])
            for _ in range(3)]
    mgr = CheckpointManager(str(tmp))
    mgr.save(3, built.state)
    mgr.wait()
    fresh = engine.create_state(mesh)
    CheckpointManager(str(tmp)).restore(fresh)
    built = engine.build(mesh, data=_split(), perm_fn=perms.__getitem__,
                         state=fresh)
    tape += [float(built.step(built.state, next(built.ds))[1]["loss"])
             for _ in range(3)]
    return tape


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data_dir = tmp_path_factory.mktemp("mnist")
    _tiny_mnist(data_dir)
    new = lambda name: str(tmp_path_factory.mktemp(name))
    group_dirs = {k: new(f"group_{k}") for k in ("straight", "resumed",
                                                  "async")}
    with ThreadPoolExecutor(3) as pool:
        group = pool.submit(launch.spawn, _group_runs, 2, "gloo",
                            (data_dir, group_dirs), 300)
        drills = {n: pool.submit(_drill, data_dir, new(f"drill{n}"), n)
                  for n in (1, 2)}
        jtape, params0, perms = _jax_resumed_tape(new("jax_ckpt"))
        port_tape = _port_resumed_tape(params0, perms, new("port_ckpt"))
        one_rank = _stop_and_resume(data_dir, {k: new(f"one_{k}") for k in
                                               ("straight", "resumed")})
        ranks = group.result()
        drills = {n: d.result() for n, d in drills.items()}
    return {"data_dir": data_dir, "group": ranks, "group_dirs": group_dirs,
            "one_rank": one_rank, "drills": drills, "jax_tape": jtape,
            "port_tape": port_tape}


# --- the manager ----------------------------------------------------------

def _built(model="mnist_cnn", seed=0, steps=2):
    """A small state after ``steps`` train steps (dropout on for the CNN;
    batch-norm buffers for ResNet-20)."""
    flags = ["--device", "cpu", "--momentum", str(MU), "--learning_rate",
             str(LR), "--batch_size", str(B), "--seed", str(seed)]
    if model == "resnet20":
        from distributedtensorflowexample_tpu_torch.data.cifar10 import (
            load_cifar10)
        data = load_cifar10("", "train", synthetic_size=64,
                            source="synthetic")
        spec = RunSpec(model, "cifar10", parse_flags(flags), augment=True)
    else:
        data = _split()
        spec = RunSpec(model, "mnist", parse_flags(flags))
    built = Engine(spec).build(Mesh(CPU), data=data)
    for _ in range(steps):
        built.step(built.state, next(built.ds))
    return built.state


def _content(state) -> dict:
    opt = state.optimizer
    return {"step": state.step, "count": opt.count,
            "params": opt.params_flat.clone(),
            "momentum": opt.momentum_flat.clone(),
            "buffers": {n: b.clone() for n, b in
                        state.model.named_buffers()},
            "generator": state.generator.get_state()}


def _assert_same(a: dict, b: dict) -> None:
    assert (a["step"], a["count"]) == (b["step"], b["count"])
    for key in ("params", "momentum", "generator"):
        assert torch.equal(a[key], b[key]), key
    assert a["buffers"].keys() == b["buffers"].keys()
    for name, buf in a["buffers"].items():
        assert torch.equal(buf, b["buffers"][name]), name


@pytest.mark.parametrize("model,async_save", [
    ("mnist_cnn", True), ("mnist_cnn", False), ("resnet20", True)])
def test_state_round_trips(tmp_path, model, async_save):
    state = _built(model)
    mgr = CheckpointManager(str(tmp_path), async_save=async_save)
    assert mgr.save(state.step, state)
    mgr.wait()
    assert mgr.latest_step() == 2
    assert os.listdir(tmp_path / "2") == ["rank-0.pt"]
    fresh = _built(model, seed=5, steps=0)
    assert not torch.equal(fresh.optimizer.params_flat,
                           state.optimizer.params_flat)
    CheckpointManager(str(tmp_path)).restore(fresh)
    _assert_same(_content(fresh), _content(state))
    if model == "resnet20":
        assert len(_content(state)["buffers"]) == 42   # 21 batch norms


def test_restore_on_an_empty_directory_is_the_identity(tmp_path):
    state = _built(steps=1)
    before = _content(state)
    mgr = CheckpointManager(str(tmp_path / "none"))
    assert mgr.latest_step() is None and mgr.all_steps() == []
    assert mgr.restore(state) is state
    _assert_same(_content(state), before)
    assert not os.path.exists(tmp_path / "none")       # nothing written


def test_keep_n_rotation(tmp_path):
    state = _built(steps=0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 4):
        state.step = step
        mgr.save(step, state)
    mgr.close()
    assert mgr.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["3", "4"]
    assert CheckpointManager(str(tmp_path)).all_steps() == [3, 4]


def test_a_duplicate_step_save_is_a_no_op(tmp_path):
    state = _built(steps=1)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(1, state) is True
    assert mgr.save(1, state) is False      # the pending one counts
    assert mgr.all_steps() == [1]
    part = tmp_path / "1" / "rank-0.pt"
    stamp = os.stat(part).st_mtime_ns
    state.step = 2
    assert CheckpointManager(str(tmp_path)).save(1, state) is False
    assert os.stat(part).st_mtime_ns == stamp


def test_a_failed_write_is_raised_and_never_named(tmp_path, monkeypatch):
    state = _built(steps=1)

    def fail(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", fail)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    with pytest.raises(RuntimeError, match="failed on rank") as err:
        mgr.wait()
    assert isinstance(err.value.__cause__, OSError)
    assert mgr.latest_step() is None
    assert CheckpointManager(str(tmp_path)).latest_step() is None
    assert os.listdir(tmp_path) == [".tmp-1"]       # never renamed


def _loop(state, hooks, steps):
    built = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(
        ["--device", "cpu", "--batch_size", str(B)]))).build(
        Mesh(CPU), data=_split(), state=state)
    return TrainLoop(built.step, built.ds, steps, hooks)


def test_checkpoint_hook_saves_periodically_and_at_the_end(tmp_path):
    state = _built(steps=0)
    mgr = CheckpointManager(str(tmp_path))
    _loop(state, [CheckpointHook(mgr, every=2)], 5).run(state)
    assert mgr.all_steps() == [2, 4, 5]
    assert sorted(os.listdir(tmp_path)) == ["2", "4", "5"]


def test_an_interrupt_still_checkpoints_the_final_state(tmp_path):
    """Ctrl-C mid-run: the end hooks save the last completed step before
    the KeyboardInterrupt propagates (the JAX package's
    ``test_interrupt_still_checkpoints_final_state``)."""

    class InterruptAt(Hook):
        def after_step(self, step, state, metrics):
            if step == 3:
                raise KeyboardInterrupt
            return False

    state = _built(steps=0)
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(KeyboardInterrupt):
        _loop(state, [InterruptAt(), CheckpointHook(mgr, every=0)],
              6).run(state)
    assert mgr.latest_step() == 3


def test_a_second_interrupt_during_the_exit_hooks_still_saves(tmp_path):
    """The JAX package's
    ``test_second_interrupt_during_exit_hooks_still_saves``."""

    class InterruptOnEnd(Hook):
        def end(self, state):
            raise KeyboardInterrupt

    state = _built(steps=0)
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(KeyboardInterrupt):
        _loop(state, [InterruptOnEnd(), CheckpointHook(mgr, every=0)],
              2).run(state)
    assert mgr.latest_step() == 2


def test_run_metadata_round_trips(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, run_metadata={"sync_mode": "sync"})
    assert mgr.saved_run_metadata() is None      # nothing saved yet
    mgr.save(1, _built(steps=1))
    mgr.wait()
    assert mgr.saved_run_metadata() == {"sync_mode": "sync"}
    # A second manager over the same dir reads the original writer's mode.
    again = CheckpointManager(d, run_metadata={"sync_mode": "async"})
    assert again.saved_run_metadata() == {"sync_mode": "sync"}


_META = {"sync2": {"sync_mode": "sync", "mesh_size": 2, "num_workers": None,
                   "update_layout": "tree"},
         "async2": {"sync_mode": "async", "mesh_size": 2, "num_workers": 2,
                    "update_layout": "tree"},
         "async4": {"sync_mode": "async", "mesh_size": 4, "num_workers": 4,
                    "update_layout": "tree"},
         "sync4": {"sync_mode": "sync", "mesh_size": 4, "num_workers": None,
                   "update_layout": "tree"}}


@pytest.mark.parametrize("saved,current", [
    ("sync2", "async2"), ("async2", "sync2"), ("async2", "async4"),
    ("sync2", "sync4"), ("sync2", "sync2")])
def test_restore_refusals_equal_the_jax_engines(capsys, saved, current):
    from distributedtensorflowexample_tpu.engine.engine import (
        _refuse_incompatible_restore as jax_refuse)
    outcomes = []
    for refuse in (jax_refuse, port_engine._refuse_incompatible_restore):
        try:
            refuse(_META[saved], _META[current], "/logs", True)
            outcomes.append(("ok", capsys.readouterr().out))
        except ValueError as err:
            outcomes.append((type(err).__name__, str(err)))
    assert outcomes[0] == outcomes[1]
    if saved[:-1] != current[:-1]:
        assert "sync_mode=" in outcomes[0][1]
    elif saved != current and saved.startswith("async"):
        assert "num_workers=2; this run has num_workers=4" in outcomes[0][1]
    elif saved != current:
        assert "note: resuming a mesh_size=2 checkpoint" in outcomes[0][1]


# --- the engine: resume, refusals and preemption --------------------------

def _assert_resume_is_bitwise(out, ranks=1):
    straight, resumed = out["straight"], out["resumed"]
    assert resumed["summary"]["start_step"] == 3
    assert straight["summary"]["start_step"] == 0
    # the resumed run trained steps 4-6 only, logging at 6
    assert [s for s, _ in straight["summary"]["loss_tape"]] == [3, 6]
    assert [s for s, _ in resumed["summary"]["loss_tape"]] == [6]
    assert straight["summary"]["steps"] == resumed["summary"]["steps"] == 6
    assert straight["summary"]["loss_tape"][-1] == \
        resumed["summary"]["loss_tape"][-1]
    assert straight["summary"]["params_digest"] == \
        resumed["summary"]["params_digest"]
    a, b = straight["part"], resumed["part"]
    assert (a["step"], a["count"]) == (b["step"], b["count"]) == (6, 6)
    assert sorted(a["generators"]) == list(range(ranks))
    for key in ("params", "momentum"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for r in range(ranks):
        np.testing.assert_array_equal(a["generators"][r],
                                      b["generators"][r])


def test_a_resumed_run_is_bitwise_the_uninterrupted_one(runs):
    _assert_resume_is_bitwise(runs["one_rank"])


def test_a_resumed_two_rank_run_is_bitwise_the_uninterrupted_one(runs):
    for rank in runs["group"]:
        _assert_resume_is_bitwise(rank["sync"], ranks=2)
    a, b = (r["sync"]["resumed"]["summary"] for r in runs["group"])
    assert a["params_digest"] == b["params_digest"]
    # two ranks: two dropout generators, both in rank 0's part, distinct
    gens = runs["group"][0]["sync"]["resumed"]["part"]["generators"]
    assert not np.array_equal(gens[0], gens[1])


def test_the_resumed_tape_tracks_the_jax_packages(runs):
    tape, jtape = runs["port_tape"], runs["jax_tape"]
    assert all(np.isfinite(tape))
    np.testing.assert_allclose(tape, jtape, rtol=1e-2)


def _trainer(module, *argv):
    import importlib
    return importlib.import_module(
        f"distributedtensorflowexample_tpu_torch.trainers.{module}").main(
        list(argv))


def test_cross_layout_restores_are_refused_by_name(runs):
    data_dir, dirs = runs["data_dir"], runs["group_dirs"]
    with pytest.raises(ModeRefusal, match="num_workers=2.*num_workers=1"):
        _trainer("trainer_ps_mnist", *_argv(data_dir, dirs["async"],
                                            "--train_steps", "4"))
    with pytest.raises(ModeRefusal, match="sync_mode='async'"):
        _trainer("trainer_sync_mnist", *_argv(data_dir, dirs["async"],
                                              "--train_steps", "4"))
    with pytest.raises(ModeRefusal, match="sync_mode='sync'"):
        _trainer("trainer_ps_mnist", *_argv(data_dir, dirs["straight"],
                                            "--train_steps", "8"))


def test_a_sync_restore_on_another_mesh_size_notes_and_proceeds(
        runs, capsys, tmp_path):
    import shutil
    log_dir = tmp_path / "copy"
    shutil.copytree(runs["group_dirs"]["straight"], log_dir)
    summary = _trainer("trainer_sync_mnist", *_argv(
        runs["data_dir"], log_dir, "--train_steps", "8"))
    out = capsys.readouterr().out
    assert "note: resuming a mesh_size=2 checkpoint on mesh_size=1" in out
    assert "resumed from checkpoint at step 6" in out
    assert summary["start_step"] == 6 and summary["steps"] == 8
    # the final save rewrote the metadata for this writer
    assert CheckpointManager(str(log_dir / "checkpoints")) \
        .saved_run_metadata()["mesh_size"] == 1


def test_checkpoint_every_needs_a_log_dir():
    with pytest.raises(ModeRefusal, match="--checkpoint_every > 0 writes "
                                          "checkpoints under --log_dir"):
        _trainer("trainer_sync_mnist", "--device", "cpu", "--dataset",
                 "synthetic", "--checkpoint_every", "5", "--log_dir", "")


@pytest.mark.parametrize("ranks", [1, 2])
def test_sigterm_saves_exits_143_and_the_restart_resumes(runs, ranks):
    d = runs["drills"][ranks]
    text = d["text"]
    assert d["alive_at_signal"], text[-2000:]
    assert d["rc"] == 143, (d["rc"], text[-3000:])
    assert text.count("SIGTERM at step") == 1, text[-2000:]
    assert "checkpoint saved, restart auto-resumes; exiting 143" in text
    assert "Traceback" not in text and "ProcessException" not in text
    assert d["saved"] >= 3
    rc, out = d["restart"]
    assert rc == 0, out[-3000:]
    assert f"resumed from checkpoint at step {d['saved']}" in out
    assert f"step {d['saved'] + 4}: final_accuracy=" in out


def test_a_supervised_run_touches_its_heartbeat(runs, tmp_path, monkeypatch):
    beat = tmp_path / "beat"
    monkeypatch.setenv("SUPERVISE_HEARTBEAT", str(beat))
    _trainer("trainer_sync_mnist", *_argv(runs["data_dir"], "",
                                          "--train_steps", "2"))
    assert beat.exists()
