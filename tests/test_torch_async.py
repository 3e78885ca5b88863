"""Config 2 on the CPU: the port's async local SGD (one worker per gloo
rank, ``parallel/async_ps.py``) against the JAX package's
``make_indexed_async_train_step`` on a W-device mesh of the conftest's
virtual CPU devices (its shard_map path), from the same per-worker
parameters and momentum (``convert.worker_slice`` of the JAX
worker-tiled state) over the JAX dataset's index tape.

Two groups (2 and 4 ranks) start once for the module and run every check
that needs a group, while the JAX side runs here.  The rank workers
import no JAX (a spawned rank imports this module to find them).

Both sides run config 3's CNN (dropout off, B=8 per worker, lr 0.05,
momentum 0.9) with the dequant and cross-entropy kernels (the JAX side
in interpret mode, the port through their plain versions) for
``2 * PERIOD + 1`` steps at period 2: two averagings and one step after
the last one.  Tolerances: float32, every worker's final parameters and
momentum and the loss tape within rtol 1e-5 (atol 1e-6; the two sides'
convolutions sum in other orders); bfloat16 (the default dtype), config
3's bound (``tests/test_torch_slice.py``): the tape within 1e-2
relative, and each worker's first update and first momentum within 8e-2
of their largest element, or within the JAX package's own bfloat16 to
float32 difference on that leaf, whichever is larger (the conv biases'
gradients sum 6,272 bf16 terms a channel: JAX's own two dtypes differ
by up to 0.12 there, and by 0.29 on fc1's bias).  Between the port's own
paths
(W=1 async against the sync step, a resume against the run it
interrupts, workers after an averaging): bitwise.
"""

import hashlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from distributedtensorflowexample_tpu_torch import convert
from distributedtensorflowexample_tpu_torch.config import parse_flags
from distributedtensorflowexample_tpu_torch.data.synthetic import (
    make_synthetic)
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
from distributedtensorflowexample_tpu_torch.parallel import launch
from distributedtensorflowexample_tpu_torch.parallel.mesh import make_mesh

B, ROWS, LR, MU, PERIOD = 8, 256, 0.05, 0.9, 2
STEPS = 2 * PERIOD + 1
# The step after which each dtype's workers are compared (see above).
CHECKED = {"float32": STEPS, "bfloat16": 1}
DTYPES = tuple(CHECKED)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread here, and so in every spawned rank."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flags(*extra) -> list[str]:
    return ["--device", "cpu", "--sync_mode", "async", "--momentum",
            str(MU), "--learning_rate", str(LR), "--dropout", "0",
            "--pallas_ce", "true", "--dequant_impl", "pallas",
            "--batch_size", str(B), "--async_period", str(PERIOD), *extra]


def _split():
    return make_synthetic(ROWS, (28, 28, 1), 10, seed=0, sample_seed=1)


def _flat(state) -> bytes:
    opt = state.optimizer
    return opt.params_flat.numpy().tobytes() + (
        opt.momentum_flat.numpy().tobytes())


def _small_mnist() -> None:
    from distributedtensorflowexample_tpu_torch.data import mnist
    mnist._SYNTH_SIZES = {"train": 512, "test": 128}


def _trainer_argv(log_dir, *extra) -> list[str]:
    return ["--device", "cpu", "--dataset", "synthetic", "--batch_size",
            str(B), "--log_every", "3", "--learning_rate", "0.02",
            "--log_dir", str(log_dir), *extra]


# --- rank workers (run in the spawned ranks; no JAX) ----------------------

def _tapes(mesh, inp) -> dict:
    """STEPS async steps per dtype from the JAX workers' state over the
    JAX index tape: the global loss tape, this worker's parameters and
    momentum (flax trees) after ``CHECKED[dtype]`` steps, and the
    averaging all-reduces."""
    out = {}
    for dtype, checked in CHECKED.items():
        built = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(_flags(
            "--dtype", dtype)))).build(
            mesh, data=_split(), perm_fn=inp["perms"].__getitem__)
        convert.load_into_state(
            built.state, convert.worker_slice(inp["params0"], mesh.rank),
            convert.worker_slice(inp["momentum0"], mesh.rank))
        before, tape = mesh.all_reduces, []
        for i in range(STEPS):
            _, m = built.step(built.state, next(built.ds))
            tape.append(float(mesh.sum_metrics(m)["loss"]))
            if i + 1 == checked:
                params, momentum = convert.state_to_flax(built.state)
        out[dtype] = {"tape": tape, "params": params, "momentum": momentum,
                      "all_reduces": mesh.all_reduces - before}
    return out


def _period_one(mesh) -> list[str]:
    """Digests of this worker's parameters after each of 3 steps at
    period 1, from the port's own init (dropout on: the workers' masks
    differ, the averaged parameters must not)."""
    built = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(
        _flags("--async_period", "1", "--dropout", "0.5",
               "--dtype", "float32")))).build(mesh, data=_split())
    digests = []
    for _ in range(3):
        built.step(built.state, next(built.ds))
        digests.append(hashlib.sha256(
            built.state.optimizer.params_flat.numpy().tobytes()).hexdigest())
    return digests


def _resume_across_an_averaging(mesh, dirs) -> dict:
    """Config 2 through the trainer at period 3 with dropout on: 6 steps,
    and 3 steps then a resume to 6 in another log dir (the averaging at
    step 6 falls in the resumed half).  Each worker's final checkpoint
    part, read back."""
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_ps_mnist)
    _small_mnist()
    flags = ("--async_period", "3", "--checkpoint_every", "3")
    out = {}
    for name, stops in (("straight", (6,)), ("resumed", (3, 6))):
        for steps in stops:
            summary = trainer_ps_mnist.main(_trainer_argv(
                dirs[name], *flags, "--train_steps", str(steps)))
        out[name] = {"summary": summary, "part": _numpy(torch.load(
            f"{dirs[name]}/checkpoints/6/rank-{mesh.rank}.pt",
            weights_only=True))}
    return out


def _numpy(obj):
    """Tensors to numpy arrays, through dicts: a tensor sent back from a
    rank would be shared through a file descriptor that dies with it."""
    if isinstance(obj, dict):
        return {k: _numpy(v) for k, v in obj.items()}
    return obj.numpy() if isinstance(obj, torch.Tensor) else obj


def _rank_checks(inp, dirs) -> dict:
    mesh = make_mesh("cpu")
    out = {"rank": mesh.rank, "tapes": _tapes(mesh, inp),
           "period_one": _period_one(mesh)}
    if mesh.size == 2:
        out["resume"] = _resume_across_an_averaging(mesh, dirs)
    return out


# --- the JAX side and the groups ------------------------------------------

def _jax_workers(n):
    """The JAX package's config-3 state tiled over n workers (its
    ``make_worker_state``), as numpy trees: params, momentum."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributedtensorflowexample_tpu.models.mnist_cnn import (
        MnistCNN as JaxMnistCNN)
    from distributedtensorflowexample_tpu.parallel.async_ps import (
        make_worker_state)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh, replicated_sharding)
    from distributedtensorflowexample_tpu.training.state import (
        TrainState as JaxTrainState)
    mesh = jax_make_mesh(n)
    state = JaxTrainState.create(JaxMnistCNN(dropout_rate=0.0),
                                 optax.sgd(LR, momentum=MU),
                                 jnp.zeros((B, 28, 28, 1)), seed=0)
    state = make_worker_state(jax.device_put(state,
                                             replicated_sharding(mesh)),
                              n, mesh)
    host = lambda t: jax.tree.map(lambda a: np.array(a, copy=True), t)
    return host(state.params), host(state.opt_state[0].trace)


def _jax_perms(n):
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)
    x, y = _split()
    jds = JaxDeviceDataset(x, y, B * n, mesh=jax_make_mesh(n), seed=0,
                           dequant_impl="pallas")
    return [np.asarray(jds._make_perm(jnp.asarray(e, jnp.int32)))
            for e in range(4)]


def _jax_tapes(n, params0, momentum0):
    """{dtype: (tape, {step: (tiled params, tiled momentum)})} of
    ``make_indexed_async_train_step`` on an n-device mesh, after the
    first and the last step."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    from distributedtensorflowexample_tpu.models.mnist_cnn import (
        MnistCNN as JaxMnistCNN)
    from distributedtensorflowexample_tpu.parallel.async_ps import (
        make_indexed_async_train_step as jax_async_step)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        DATA_AXIS, make_mesh as jax_make_mesh)
    from distributedtensorflowexample_tpu.training.state import (
        TrainState as JaxTrainState)
    mesh = jax_make_mesh(n)
    tiled = jax.sharding.NamedSharding(mesh,
                                       jax.sharding.PartitionSpec(DATA_AXIS))
    x, y = _split()
    out = {}
    for dtype in DTYPES:
        model = JaxMnistCNN(dropout_rate=0.0, dtype=getattr(jnp, dtype))
        tx = optax.sgd(LR, momentum=MU)
        params = jax.device_put(jax.tree.map(jnp.asarray, params0), tiled)
        trace = jax.device_put(jax.tree.map(jnp.asarray, momentum0), tiled)
        state = JaxTrainState(
            step=jnp.asarray(0, jnp.int32), params=params,
            opt_state=(optax.TraceState(trace=trace), optax.EmptyState()),
            batch_stats={}, rng=jax.random.PRNGKey(1), tx=tx,
            apply_fn=model.apply)
        jds = JaxDeviceDataset(x, y, B * n, mesh=mesh, seed=0,
                               dequant_impl="pallas")
        step = jax_async_step(n, PERIOD, B * n, jds.steps_per_epoch,
                              ce_impl="pallas", mesh=mesh,
                              num_slots=jds.num_slots,
                              dequant_impl="pallas")
        host = lambda t: jax.tree.map(lambda a: np.array(a, copy=True), t)
        tape, kept = [], {}
        with mesh:
            for i in range(STEPS):
                state, m = step(state, next(jds))
                tape.append(float(m["loss"]))
                if i + 1 in (1, STEPS):
                    kept[i + 1] = (host(state.params),
                                   host(state.opt_state[0].trace))
        out[dtype] = (tape, kept)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    sizes = (2, 4)
    inputs = {}
    for n in sizes:
        params0, momentum0 = _jax_workers(n)
        inputs[n] = {"params0": params0, "momentum0": momentum0,
                     "perms": _jax_perms(n)}
    dirs = {k: str(tmp_path_factory.mktemp(f"async_{k}"))
            for k in ("straight", "resumed")}
    with ThreadPoolExecutor(len(sizes)) as pool:
        groups = {n: pool.submit(launch.spawn, _rank_checks, n, "gloo",
                                 (inputs[n], dirs), 300) for n in sizes}
        jax_side = {n: _jax_tapes(n, inputs[n]["params0"],
                                  inputs[n]["momentum0"]) for n in sizes}
        ranks = {n: g.result() for n, g in groups.items()}
    return {"inputs": inputs, "ranks": ranks, "jax": jax_side}


# --- the checks -----------------------------------------------------------

def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_async_steps_track_the_jax_mesh_per_worker(runs, n, dtype):
    jtape, kept = runs["jax"][n][dtype]
    checked = CHECKED[dtype]
    ranks = runs["ranks"][n]
    tape = ranks[0]["tapes"][dtype]["tape"]
    assert all(r["tapes"][dtype]["tape"] == tape for r in ranks)
    assert all(np.isfinite(tape))
    np.testing.assert_allclose(tape, jtape,
                               rtol=1e-5 if dtype == "float32" else 1e-2)
    params0 = dict(_leaves(runs["inputs"][n]["params0"]))
    for w, rank in enumerate(ranks):
        got = rank["tapes"][dtype]
        # two averagings (after steps 2 and 4), no gradient all-reduce
        assert got["all_reduces"] == STEPS // PERIOD
        for k, name in enumerate(("params", "momentum")):
            mine = dict(_leaves(got[name]))
            f32 = dict(_leaves(runs["jax"][n]["float32"][1][checked][k]))
            for path, want in _leaves(kept[checked][k]):
                g, wv, ref = mine[path], want[w], f32[path][w]
                if dtype == "float32":
                    np.testing.assert_allclose(g, wv, rtol=1e-5, atol=1e-6,
                                               err_msg=f"{name} {path} {w}")
                    continue
                if name == "params":     # the first update, as config 3
                    g, wv, ref = (a - params0[path][w] for a in (g, wv, ref))
                err = np.abs(g - wv).max()
                bound = max(8e-2 * np.abs(wv).max(), np.abs(ref - wv).max())
                assert err <= bound, (name, path, w, err, bound)


@pytest.mark.parametrize("n", [2, 4])
def test_workers_diverge_between_averagings_and_agree_at_them(runs, n):
    """After 2 * PERIOD + 1 steps the workers have stepped once since the
    last averaging (different rows): they differ.  At period 1 every
    step averages: they agree bitwise after each one."""
    ranks = runs["ranks"][n]
    w0 = dict(_leaves(ranks[0]["tapes"]["float32"]["params"]))
    w1 = dict(_leaves(ranks[1]["tapes"]["float32"]["params"]))
    assert not np.array_equal(w0["fc1/kernel"], w1["fc1/kernel"])
    digests = [r["period_one"] for r in ranks]
    assert all(d == digests[0] for d in digests)
    assert len(set(digests[0])) == 3            # and they moved


def test_async_resume_across_an_averaging_is_bitwise(runs):
    for rank in runs["ranks"][2]:
        straight, resumed = (rank["resume"][k] for k in ("straight",
                                                         "resumed"))
        assert resumed["summary"]["start_step"] == 3
        assert [s for s, _ in resumed["summary"]["loss_tape"]] == [6]
        assert straight["summary"]["steps"] == resumed["summary"]["steps"] == 6
        assert straight["summary"]["loss_tape"][-1] == \
            resumed["summary"]["loss_tape"][-1]
        a, b = straight["part"], resumed["part"]
        assert a["step"] == b["step"] == 6 and a["count"] == b["count"] == 6
        assert set(a["generators"]) == {rank["rank"]}
        for key in ("params", "momentum"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        np.testing.assert_array_equal(a["generators"][rank["rank"]],
                                      b["generators"][rank["rank"]])
        # one averaging per 3 steps; the resumed run's second half has one
        assert straight["summary"]["all_reduces"] == 2
    # 6 is a multiple of the period: the two workers end equal
    parts = [r["resume"]["straight"]["part"] for r in runs["ranks"][2]]
    np.testing.assert_array_equal(parts[0]["params"], parts[1]["params"])
    assert not np.array_equal(parts[0]["momentum"], parts[1]["momentum"])


def test_one_worker_async_is_the_sync_step_bitwise():
    """W=1: no averaging can change anything and the loss has no 1/W, so
    async local SGD is the sync step, bit for bit, dropout included."""
    out = {}
    for mode in ("sync", "async"):
        built = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(_flags(
            "--sync_mode", mode, "--dropout", "0.5")))).build(
            make_mesh("cpu"), data=_split())
        tape = [float(built.step(built.state, next(built.ds))[1]["loss"])
                for _ in range(STEPS)]
        out[mode] = (tape, _flat(built.state))
    assert out["sync"] == out["async"]


def test_trainer_ps_mnist_end_to_end(tmp_path, capsys, monkeypatch):
    """config 2 out of the box on the CPU (the JAX package's
    ``test_async_trainer_end_to_end``), its defaults, and the ps role."""
    from distributedtensorflowexample_tpu_torch import cluster
    from distributedtensorflowexample_tpu_torch.data import mnist
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_ps_mnist)
    cfg = trainer_ps_mnist.build_config([])
    assert (cfg.batch_size, cfg.train_steps, cfg.learning_rate,
            cfg.momentum, cfg.sync_mode) == (64, 2000, 0.05, 0.9, "async")
    monkeypatch.setattr(mnist, "_SYNTH_SIZES", {"train": 512, "test": 128})
    summary = trainer_ps_mnist.main(_trainer_argv(
        tmp_path, "--async_period", "4", "--train_steps", "30",
        "--log_every", "10", "--resume", "false"))
    out = capsys.readouterr().out
    assert "step 30: loss=" in out and "final_accuracy=" in out
    assert summary["steps"] == 30 and np.isfinite(summary["final_accuracy"])
    tape = [loss for _, loss in summary["loss_tape"]]
    assert len(tape) == 3 and all(np.isfinite(tape))
    monkeypatch.delenv("TF_CONFIG", raising=False)
    assert trainer_ps_mnist.main(["--job_name", "ps"]) == {
        "role": "ps", "exited": True}
    assert cluster.PS_NOTICE in capsys.readouterr().out
