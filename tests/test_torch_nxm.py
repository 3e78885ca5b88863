"""The N-process x M-local-rank layout on the CPU: two real processes,
joined by ``TF_CONFIG`` on loopback, each a launcher of two gloo ranks
(``--num_devices 4``: the global rank count, as in JAX), against the
port's ``--num_devices 4`` in one process and the JAX package's
4-device mesh.

Two pairs of processes run side by side.  In one, a script per process
starts its two ranks of the global group once (``parallel/launch.spawn``
with its rank offset and TCP rendezvous, as the Engine's launcher does)
and runs every case through the trainers' ``main`` inside the group, as
the JAX package's ``_NXM_TRAIN_SCRIPT`` does (``tests/test_multihost.py``):
sync resident (two steps a call), host-fed, async, ``--data_sharding
sharded``, zero1, a config digest that differs on one process, and the
config-3 tape.  The other runs the preemption drill through the
trainer's command line, each process a launcher of its two ranks:
SIGTERM to one launcher, every process exits 143, and a resume.
Meanwhile this process runs the same cases as four ranks of one group
(the ``--num_devices 4`` path) and the JAX tape.

Claims: each case's parameters bitwise the one-process run's, the four
replicas bitwise equal across both processes, the loss tape equal; the
resume bitwise the uninterrupted run; the config-3 tape (bf16, the
kernels' plain versions, from the converted JAX init over the JAX index
tape, through ``spawn``'s rank offset and TCP rendezvous) against the
JAX step on a 4-device mesh of the conftest's virtual CPU devices, whose
process-grouped device order is the global rank order, at
``tests/test_torch_multirank.py``'s tolerances: the tape within 1e-2
relative, the first update within 8e-2 of its largest element.  The
functions the processes run import no JAX (the script imports this
module to find them).
"""

import dataclasses
import json
import os
import pickle
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from distributedtensorflowexample_tpu_torch import cluster, convert
from distributedtensorflowexample_tpu_torch.config import parse_flags
from distributedtensorflowexample_tpu_torch.data.synthetic import (
    make_synthetic)
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
from distributedtensorflowexample_tpu_torch.engine import engine as engine_mod
from distributedtensorflowexample_tpu_torch.parallel import launch
from distributedtensorflowexample_tpu_torch.parallel.mesh import (
    make_mesh, ranks_per_process)
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal

B, ROWS, STEPS, LR, MU = 8, 256, 5, 0.05, 0.9
N, M = 2, 2
WORLD = N * M
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
#: The drill's trainer: config 1 (softmax), whose steps are quick.
DRILL_TRAINER = ("distributedtensorflowexample_tpu_torch.trainers."
                 "trainer_local_mnist")

#: The cases of the two script pairs: (trainer, extra flags).
CASES = {
    "sync": ("sync", ["--steps_per_loop", "2"]),
    "hostfed": ("sync", ["--device_data", "off"]),
    "async": ("ps", ["--steps_per_loop", "2", "--async_period", "2"]),
    "sharded": ("sync", ["--steps_per_loop", "2", "--data_sharding",
                         "sharded"]),
    "zero1": ("sync", ["--bucket_grads", "65536", "--shard_update",
                       "true"]),
}

#: The drill's stop lands on the first stop-consensus poll after the
#: signal (the polls come every 64 steps); the resume trains this many
#: more.
DRILL_POLL, DRILL_MORE = 64, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_idx(data_dir):
    """512 train and 128 test rows of the synthetic split as IDX files."""
    names = {"train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
             "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}
    for split, (num, sample_seed) in {"train": (512, 1),
                                      "test": (128, 2)}.items():
        images, labels = make_synthetic(num, (28, 28, 1), 10, seed=0,
                                        sample_seed=sample_seed)
        img, lbl = names[split]
        u8 = np.round(images[..., 0] * 255).astype(np.uint8)
        (data_dir / img).write_bytes(struct.pack(">IIII", 2051, *u8.shape)
                                     + u8.tobytes())
        (data_dir / lbl).write_bytes(struct.pack(">II", 2049, len(labels))
                                     + labels.astype(np.uint8).tobytes())


def _common(data_dir: str) -> list[str]:
    return ["--device", "cpu", "--dataset", "mnist", "--data_dir", data_dir,
            "--train_steps", "4", "--batch_size", str(B), "--log_every", "2",
            "--log_dir", "", "--resume", "false", "--learning_rate",
            str(LR), "--num_devices", str(WORLD)]


def _drill_flags(data_dir: str, log_dir: str, steps: int) -> list[str]:
    return ["--device", "cpu", "--dataset", "mnist", "--data_dir", data_dir,
            "--train_steps", str(steps), "--batch_size", str(B),
            "--learning_rate", str(LR), "--steps_per_loop", "1",
            "--log_every", "5", "--log_dir", log_dir, "--num_devices",
            str(WORLD)]


def _trainer(name: str):
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_local_mnist, trainer_ps_mnist, trainer_sync_mnist)
    return {"sync": trainer_sync_mnist, "ps": trainer_ps_mnist,
            "local": trainer_local_mnist}[name]


def _summary(s: dict) -> dict:
    return {"rank": s["rank"], "digest": s["params_digest"],
            "tape": s["loss_tape"], "steps": s["steps"],
            "num_replicas": s["num_replicas"],
            "global_batch": s["global_batch"],
            "ranks": [(r["rank"], r["params_digest"])
                      for r in s.get("ranks", [])]}


# --- what the N x M processes run (no JAX) --------------------------------

def _split():
    return make_synthetic(ROWS, (28, 28, 1), 10, seed=0, sample_seed=1)


def _tape_rank(inputs_path: str) -> dict:
    """Config 3 (bf16, the kernels' plain versions) from the converted JAX
    init over the JAX index tape, on this rank of the global group."""
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    mesh = make_mesh("cpu")
    built = Engine(RunSpec("mnist_cnn", "mnist", parse_flags([
        "--device", "cpu", "--fused_optimizer", "true", "--momentum",
        str(MU), "--learning_rate", str(LR), "--dropout", "0",
        "--pallas_ce", "true", "--dequant_impl", "pallas",
        "--batch_size", str(B)]))).build(
        mesh, data=_split(), perm_fn=inp["perms"].__getitem__)
    convert.load_into_state(built.state, inp["params0"])
    tape, params1 = [], None
    for i in range(STEPS):
        _, m = built.step(built.state, next(built.ds))
        tape.append(float(mesh.sum_metrics(m)["loss"]))
        if i == 0 and mesh.rank == 0:
            params1 = convert.state_to_flax(built.state)[0]
    return {"rank": mesh.rank, "tape": tape, "params1": params1,
            "digest": engine_mod._params_digest(built.state)}


def _group_rank(cfg: dict) -> dict:
    """One rank of the global group: the group's cases through the
    trainers' ``main`` (each an ``Engine.run`` inside the group), a
    learning rate that differs on the second process's ranks, then the
    config-3 tape."""
    out = {case: _summary(_trainer(CASES[case][0]).main(
        _common(cfg["data_dir"]) + CASES[case][1])) for case in CASES}
    extra = ["--learning_rate", "0.06"] if cfg["pid"] == 1 else []
    try:
        _trainer("sync").main(_common(cfg["data_dir"]) + extra)
        out["mismatch"] = None
    except ModeRefusal as e:
        out["mismatch"] = str(e)
    out["tape"] = _tape_rank(cfg["inputs"])
    return out


def run_case(case: str, cfg: dict):
    """One case in this process (``cfg``: the process's id, the data
    directory, the tape's inputs and the coordinator)."""
    if case == "group":
        return launch.spawn(
            _group_rank, WORLD, "gloo", args=(cfg,), local=M,
            offset=cfg["pid"] * M,
            init_method=f"tcp://{cfg['coordinator']}")
    trainer, extra = CASES[case]
    return _summary(_trainer(trainer).main(_common(cfg["data_dir"]) + extra))


_RESUME = """
import json, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
import test_torch_nxm
s = test_torch_nxm._trainer("local").main(sys.argv[2:])
print("SUMMARY " + json.dumps(test_torch_nxm._summary(s)), flush=True)
"""

_SCRIPT = """
import json, pickle, sys
import torch
torch.set_num_threads(1)
cfg = json.loads(sys.argv[1])
sys.path.insert(0, cfg["tests"])
import test_torch_nxm
out = {case: test_torch_nxm.run_case(case, cfg) for case in cfg["cases"]}
with open(cfg["out"], "wb") as f:
    pickle.dump(out, f)
print("DONE", flush=True)
"""


def _env(pid: int, port: int) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               TF_CONFIG=cluster.tf_config_env(
                   [f"127.0.0.1:{port}", f"127.0.0.1:{port + 1}"], pid))
    env.pop("OBS_RANK", None)
    return env


def _start_pair(cases, tmp, data_dir, inputs) -> list:
    port = _free_port()
    procs = []
    for pid in range(N):
        cfg = {"cases": list(cases), "pid": pid, "data_dir": data_dir,
               "inputs": inputs, "coordinator": f"127.0.0.1:{port}",
               "tests": TESTS, "out": str(tmp / f"{cases[0]}_{pid}.pkl")}
        procs.append((cfg, subprocess.Popen(
            [sys.executable, "-c", _SCRIPT, json.dumps(cfg)], cwd=REPO,
            env=_env(pid, port), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return procs


def _finish_pair(procs) -> list:
    out = []
    for cfg, p in procs:
        text, _ = p.communicate(timeout=300)
        assert p.returncode == 0, text[-4000:]
        with open(cfg["out"], "rb") as f:
            out.append(pickle.load(f))
    return out


def _drill(tmp, data_dir) -> dict:
    """The preemption drill through the trainer's command line: SIGTERM
    to launcher 1 once rank 0 (launcher 0's) logged step 5; the stop
    step goes to ``drill_stop`` (the reference run reads it), then both
    resume to ``DRILL_MORE`` steps past it."""
    log_dir = str(tmp / "drill")

    def start(head, steps):
        port = _free_port()
        return [subprocess.Popen(
            [sys.executable] + head + _drill_flags(data_dir, log_dir, steps),
            cwd=REPO, env=_env(pid, port), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for pid in range(N)]

    first = start(["-m", DRILL_TRAINER], 100000)
    second: list = []
    lines: list = []
    seen = threading.Event()

    def read():
        for line in first[0].stdout:
            lines.append(line)
            if line.startswith("step 5:"):
                seen.set()
        seen.set()
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    stop = 0
    try:
        seen.wait(timeout=240)
        first[1].send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=240) for p in first]
        reader.join(timeout=60)
        other = first[1].stdout.read()
        text = "".join(lines)
        if "SIGTERM at step " in text:
            stop = int(text.split("SIGTERM at step ", 1)[1].split(":")[0])
        second = start(["-c", _RESUME, TESTS], stop + DRILL_MORE)
        outs = [p.communicate(timeout=240)[0] for p in second]
    finally:
        (tmp / "drill_stop").write_text(str(stop))
        for p in first + second:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {"rcs": rcs, "text": text, "other": other, "stop": stop,
            "resumed": outs, "resumed_rcs": [p.returncode for p in second]}


def _reference_rank(data_dir: str, tmp: str) -> dict:
    """Every case on four ranks of one group in this process (the
    ``--num_devices 4`` path), then the drill's uninterrupted run, to the
    step the drill's resume reaches (read from ``drill_stop``)."""
    out = {case: _summary(_trainer(trainer).main(_common(data_dir) + extra))
           for case, (trainer, extra) in CASES.items()}
    stop_file = os.path.join(tmp, "drill_stop")
    deadline = time.monotonic() + 240
    while not os.path.exists(stop_file) and time.monotonic() < deadline:
        time.sleep(0.1)
    with open(stop_file) as f:
        steps = int(f.read()) + DRILL_MORE
    out["drill"] = _summary(_trainer("local").main(
        _drill_flags(data_dir, os.path.join(tmp, "drill_reference"), steps)
        + ["--resume", "false"]))
    return out


# --- the JAX side ----------------------------------------------------------

def _jax_inputs():
    """Config 3's JAX init (seed 0) and the 4-device mesh's index tape."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    from distributedtensorflowexample_tpu.models.mnist_cnn import (
        MnistCNN as JaxMnistCNN)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)
    from distributedtensorflowexample_tpu.training.state import (
        TrainState as JaxTrainState)
    jstate = JaxTrainState.create(JaxMnistCNN(dropout_rate=0.0),
                                  optax.sgd(LR, momentum=MU),
                                  jnp.zeros((B, 28, 28, 1)), seed=0)
    params0 = jax.tree.map(lambda a: np.array(a, copy=True), jstate.params)
    jds = JaxDeviceDataset(*_split(), B * WORLD, mesh=jax_make_mesh(WORLD),
                           seed=0, dequant_impl="pallas")
    perms = [np.asarray(jds._make_perm(jnp.asarray(e, jnp.int32)))
             for e in range(4)]
    return {"params0": params0, "perms": perms}


def _jax_tape(params0):
    """The JAX config-3 step on a 4-device mesh (its devices are the two
    processes' devices in process order): the tape, the first update."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    from distributedtensorflowexample_tpu.models.mnist_cnn import (
        MnistCNN as JaxMnistCNN)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh, replicated_sharding)
    from distributedtensorflowexample_tpu.parallel.sync import (
        make_indexed_train_step as jax_make_indexed_train_step)
    from distributedtensorflowexample_tpu.training.state import (
        TrainState as JaxTrainState)
    mesh = jax_make_mesh(WORLD)
    jds = JaxDeviceDataset(*_split(), B * WORLD, mesh=mesh, seed=0,
                           dequant_impl="pallas")
    tx = optax.sgd(LR, momentum=MU)
    params = jax.tree.map(jnp.asarray, params0)
    jstate = jax.device_put(JaxTrainState(
        step=jnp.asarray(0, jnp.int32), params=params,
        opt_state=tx.init(params), batch_stats={},
        rng=jax.random.PRNGKey(1), tx=tx,
        apply_fn=JaxMnistCNN(dropout_rate=0.0).apply),
        replicated_sharding(mesh))
    jstep = jax_make_indexed_train_step(
        B * WORLD, jds.steps_per_epoch, ce_impl="pallas",
        dequant_impl="pallas", mesh=mesh, num_replicas=WORLD,
        num_slots=jds.num_slots)
    tape, params1 = [], None
    for i in range(STEPS):
        jstate, m = jstep(jstate, next(jds))
        tape.append(float(m["loss"]))
        if i == 0:
            params1 = jax.tree.map(lambda a: np.array(a, copy=True),
                                   jstate.params)
    return tape, params1


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nxm")
    data_dir = tmp / "mnist"
    data_dir.mkdir()
    _write_idx(data_dir)
    inputs_path = str(tmp / "inputs.pkl")
    pair = []
    try:
        with ThreadPoolExecutor(2) as pool:
            # The drill needs no JAX input: it starts first, and the
            # group once the inputs are written.
            drill = pool.submit(_drill, tmp, str(data_dir))
            reference = pool.submit(
                launch.spawn, _reference_rank, WORLD, "gloo",
                (str(data_dir), str(tmp)), 300)
            inputs = _jax_inputs()
            with open(inputs_path, "wb") as f:
                pickle.dump(inputs, f)
            pair = _start_pair(("group",), tmp, str(data_dir), inputs_path)
            jax_tape = _jax_tape(inputs["params0"])
            done = _finish_pair(pair)
            drill, reference = drill.result(), reference.result()
    finally:
        for _, p in pair:
            if p.poll() is None:
                p.kill()
                p.wait()
    # {case: [(global rank, digest, its summary)]}
    cases: dict = {"mismatch": [], "tape": []}
    for pid in range(N):
        for local in done[pid]["group"]:
            for case in CASES:
                summary = local[case]
                cases.setdefault(case, []).append(
                    (summary["rank"], summary["digest"], summary))
            cases["tape"].append(local["tape"])
            cases["mismatch"].append(local["mismatch"])
    return {"cases": cases, "reference": reference,
            "drill": drill, "jax_tape": jax_tape, "inputs": inputs}


# --- the checks -----------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_nxm_case_is_bitwise_the_one_process_run(runs, case):
    """The four global ranks' parameters equal each other and the
    one-process ``--num_devices 4`` run's, and rank 0's loss tape is the
    one-process run's."""
    got = sorted(runs["cases"][case])
    want = runs["reference"][0][case]
    assert [r for r, _, _ in got] == list(range(WORLD))
    assert {d for _, d, _ in got} == {want["digest"]}
    assert {r[case]["digest"] for r in runs["reference"]} == \
        {want["digest"]}
    for _, _, summary in got:
        assert summary["num_replicas"] == WORLD and summary["steps"] == 4
        assert summary["global_batch"] == B * WORLD
    assert got[0][2]["tape"] == want["tape"]
    assert all(np.isfinite(loss) for _, loss in want["tape"])


def test_nxm_config3_tape_tracks_the_jax_mesh(runs):
    ranks = runs["cases"]["tape"]
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    assert len({r["digest"] for r in ranks}) == 1
    tape = ranks[0]["tape"]
    assert all(r["tape"] == tape for r in ranks)
    assert all(np.isfinite(tape)) and tape[-1] < tape[0]
    jtape, jparams1 = runs["jax_tape"]
    np.testing.assert_allclose(tape, jtape, rtol=1e-2)
    params0 = runs["inputs"]["params0"]
    for k0, leaves in jparams1.items():
        for k1, want in leaves.items():
            want = want - params0[k0][k1]
            moved = ranks[0]["params1"][k0][k1] - params0[k0][k1]
            rel = np.abs(moved - want).max() / np.abs(want).max()
            assert rel < 8e-2, (k0, k1, rel)


def test_nxm_mismatched_config_is_refused_on_every_rank(runs):
    assert len(runs["cases"]["mismatch"]) == WORLD
    for message in runs["cases"]["mismatch"]:
        assert "run configuration differs across the 4 processes" in \
            message


def test_sigterm_to_one_launcher_stops_every_rank_and_resumes_bitwise(runs):
    """Config 1 on 2 x 2 ranks: a SIGTERM to launcher 1 alone stops all
    four ranks at one consensus poll (every ``DRILL_POLL`` steps), after
    the signal, where every rank saves; both launchers exit 143; both
    resume, and the resumed run ends bitwise the uninterrupted one."""
    d = runs["drill"]
    stop = d["stop"]
    assert d["rcs"] == [143, 143], d["text"][-3000:] + d["other"][-3000:]
    assert stop > 5 and stop % DRILL_POLL == 0, d["text"][-3000:]
    assert (f"SIGTERM at step {stop}: checkpoint saved, restart "
            f"auto-resumes; exiting 143") in d["text"]
    assert d["resumed_rcs"] == [0, 0], d["resumed"][0][-3000:]
    assert f"resumed from checkpoint at step {stop}" in d["resumed"][0]
    got = [json.loads(out.split("SUMMARY ", 1)[1].splitlines()[0])
           for out in d["resumed"]]
    want = runs["reference"][0]["drill"]
    assert want["steps"] == stop + DRILL_MORE
    assert [g["steps"] for g in got] == [want["steps"]] * N
    # Each launcher returns its first rank's summary (global ranks 0 and
    # 2) with both of its ranks' digests.
    assert [g["rank"] for g in got] == [0, M]
    assert [r for g in got for r, _ in g["ranks"]] == list(range(WORLD))
    assert {dg for g in got for _, dg in g["ranks"]} == {want["digest"]}
    tail = [[s, loss] for s, loss in want["tape"] if s > stop]
    assert got[0]["tape"] == tail


# --- no processes needed --------------------------------------------------

def test_num_devices_is_the_global_rank_count(monkeypatch):
    monkeypatch.setenv("TF_CONFIG", cluster.tf_config_env(
        ["127.0.0.1:1", "127.0.0.1:2"], 1))
    spec = lambda *a: RunSpec("mnist_cnn", "mnist", parse_flags(
        ["--device", "cpu", *a]))
    assert Engine(spec("--num_devices", "4")).describe()["mesh_size"] == 4
    assert Engine(spec()).describe()["mesh_size"] == 2     # M = 1 on cpu
    assert Engine(spec("--num_devices", "4", "--bucket_grads", "65536",
                       "--shard_params", "true")).describe()["mode"] == \
        "zero3"
    assert ranks_per_process(6, 2, "cpu") == 3
    assert ranks_per_process(0, 3, "cpu") == 1


@pytest.mark.parametrize("num_devices", [3, 5])
def test_a_count_the_processes_do_not_divide_is_refused(monkeypatch,
                                                        num_devices):
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_sync_mnist)
    monkeypatch.setenv("TF_CONFIG", cluster.tf_config_env(
        ["127.0.0.1:1", "127.0.0.1:2"], 0))
    with pytest.raises(ModeRefusal, match=f"--num_devices {num_devices} "
                                          f"across 2 processes"):
        trainer_sync_mnist.main(["--device", "cpu", "--num_devices",
                                 str(num_devices), "--dataset", "synthetic"])


def test_more_local_ranks_than_cards_raise_the_jax_error(monkeypatch):
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_sync_mnist)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("TF_CONFIG", cluster.tf_config_env(
        ["127.0.0.1:1", "127.0.0.1:2"], 0))
    with pytest.raises(ValueError, match="requested 2 devices, only 1 "
                                         "visible"):
        trainer_sync_mnist.main(["--device", "cuda", "--num_devices", "4",
                                 "--dataset", "synthetic"])
    # 0 is every visible card: one rank a process here.
    assert ranks_per_process(0, 2, "cuda") == 1


def test_each_rank_stamps_its_global_rank_and_one_beats(monkeypatch):
    """A launcher's rank sets ``OBS_RANK`` to its global rank (the
    launcher's own, inherited, would give its ranks one id), and only the
    launcher's first rank keeps ``SUPERVISE_HEARTBEAT``."""
    seen = {}
    monkeypatch.setattr(engine_mod.Engine, "run", lambda self: {
        "env": (os.environ.get("OBS_RANK"),
                os.environ.get("SUPERVISE_HEARTBEAT"))})
    monkeypatch.setattr(engine_mod, "launch_counts", lambda: {})
    spec = RunSpec("mnist_cnn", "mnist", parse_flags(["--device", "cpu"]))
    for rank in (2, 3):
        monkeypatch.setenv("OBS_RANK", "1")
        monkeypatch.setenv("SUPERVISE_HEARTBEAT", "/beat")
        monkeypatch.setattr(engine_mod.dist, "get_rank", lambda r=rank: r)
        seen[rank] = engine_mod._local_rank_run(spec, offset=2)["env"]
    assert seen == {2: ("2", "/beat"), 3: ("3", None)}


def test_spawn_refuses_ranks_outside_the_group():
    with pytest.raises(ValueError, match="do not fit a group of 4"):
        launch.spawn(_tape_rank, WORLD, "gloo", local=2, offset=3)


def test_cluster_resolution_is_unchanged(monkeypatch):
    """The resolver still gives one identity a process; M comes from
    ``--num_devices``."""
    monkeypatch.setenv("TF_CONFIG", cluster.tf_config_env(
        ["a:1", "b:2"], 1))
    info = cluster.resolve(parse_flags(["--num_devices", "4"]))
    assert dataclasses.asdict(info) == {
        "num_processes": 2, "process_id": 1, "coordinator_address": "a:1",
        "is_chief": False, "role": "worker"}
