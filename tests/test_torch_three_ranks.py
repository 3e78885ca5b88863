"""zero1, zero3 and async on three gloo ranks (a world whose 1/N is not a
power of two) against the JAX package on a 3-device mesh of the
conftest's virtual CPU devices.

One 3-rank group starts once for the module and runs every check while
the JAX side runs here.  Both sides run config 3's CNN in float32
(dropout off, B=8 a rank, lr 0.05, momentum 0.9) with the dequant and
cross-entropy kernels (the JAX side in interpret mode, the port through
their plain versions), from the converted JAX init over the JAX
dataset's index tape:

* zero1 and zero3 at 16 KiB buckets for 3 steps: the tape, the final
  parameters and every rank's momentum rows against the JAX package's
  bucketed step builders (``make_indexed_train_step`` with
  ``bucket_shard_update`` / ``zero3_layout``), and under zero3 the
  parameter rows at init bitwise the converted ``init_rows``; each
  rank's collectives a step the mode's budget;
* async at period 2 for 5 steps (two averagings and one step after):
  the tape and every worker's parameters and momentum against the JAX
  package's ``make_indexed_async_train_step``, from its
  ``make_worker_state`` workers.

Tolerance: rtol 1e-5, atol 1e-6 (the float32 bound of
``tests/test_torch_multirank.py``'s partial aggregation and of the
modes' and async files); the replicas against each other: bitwise.  The
rank workers import no JAX (a spawned rank imports this module to find
them).
"""

import hashlib

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
from distributedtensorflowexample_tpu_torch.parallel.zero3 import materialized

N, B, ROWS, LR, MU = 3, 8, 256, 0.05, 0.9
BUCKET_BYTES = 16 << 10
MODE_STEPS, PERIOD, ASYNC_STEPS = 3, 2, 5
MODES = ("zero1", "zero3")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _split():
    return make_synthetic(ROWS, (28, 28, 1), 10, seed=0, sample_seed=1)


def _flags(*extra) -> list[str]:
    return ["--device", "cpu", "--momentum", str(MU), "--learning_rate",
            str(LR), "--dropout", "0", "--dtype", "float32", "--pallas_ce",
            "true", "--dequant_impl", "pallas", "--batch_size", str(B),
            *extra]


_MODE_FLAGS = {
    "zero1": ("--bucket_grads", str(BUCKET_BYTES), "--shard_update", "true"),
    "zero3": ("--bucket_grads", str(BUCKET_BYTES), "--shard_params", "true"),
    "async": ("--sync_mode", "async", "--async_period", str(PERIOD)),
}


def _bits(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


# --- the rank worker (no JAX) ---------------------------------------------

def _numpy(rows):
    return None if rows is None else [r.detach().numpy().copy()
                                      for r in rows]


def _mode_run(mesh, inp, mode: str) -> dict:
    engine = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(_flags(
        *_MODE_FLAGS[mode]))))
    state = engine.create_state(mesh)
    convert.load_into_state(state, inp["params0"])
    state, layout = engine.laid_out_state(mesh, state)
    opt = state.optimizer
    rows0 = _numpy(opt.params_rows)
    built = engine.build(mesh, data=_split(), state=state,
                         zero3_layout=layout, perm_fn=inp["perms"].__getitem__)
    before, tape = dict(mesh.collectives), []
    for _ in range(MODE_STEPS):
        _, m = built.step(built.state, next(built.ds))
        tape.append(float(mesh.sum_metrics(m)["loss"]))
    if opt.params_rows is not None:
        with materialized(state, mesh) as flat:
            flat = flat.numpy().copy()
    else:
        flat = opt.params_flat.detach().numpy().copy()
    views = {n: flat[off:off + shape.numel()].reshape(tuple(shape))
             for n, (off, shape) in opt.slices.items()}
    return {"tape": tape, "flat": flat, "rows0": rows0,
            "rows": _numpy(opt.params_rows),
            "momentum_rows": _numpy(opt.momentum_rows),
            "params": convert.port_to_flax(views, convert.embedding_modules(
                state.model)) if mesh.rank == 0 else None,
            "num_buckets": built.plan.num_buckets,
            "collectives": {k: (mesh.collectives[k] - before[k]) / MODE_STEPS
                            for k in before}}


def _async_run(mesh, inp) -> dict:
    built = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(_flags(
        *_MODE_FLAGS["async"])))).build(
        mesh, data=_split(), perm_fn=inp["perms"].__getitem__)
    convert.load_into_state(
        built.state, convert.worker_slice(inp["workers"][0], mesh.rank),
        convert.worker_slice(inp["workers"][1], mesh.rank))
    before, tape = mesh.all_reduces, []
    for _ in range(ASYNC_STEPS):
        _, m = built.step(built.state, next(built.ds))
        tape.append(float(mesh.sum_metrics(m)["loss"]))
    params, momentum = convert.state_to_flax(built.state)
    return {"tape": tape, "params": params, "momentum": momentum,
            "all_reduces": mesh.all_reduces - before}


def _rank_checks(inp) -> dict:
    mesh = make_mesh("cpu")
    out = {mode: _mode_run(mesh, inp, mode) for mode in MODES}
    out["async"] = _async_run(mesh, inp)
    return out


# --- the JAX side ----------------------------------------------------------

def _jax_model():
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.models.mnist_cnn import (
        MnistCNN as JaxMnistCNN)
    return JaxMnistCNN(dropout_rate=0.0, dtype=jnp.float32)


def _jax_dataset(mesh):
    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    return JaxDeviceDataset(*_split(), B * N, mesh=mesh, seed=0,
                            dequant_impl="pallas")


def _host(tree):
    import jax
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _jax_inputs() -> dict:
    """Config 3's float32 init from seed 0, its 3-worker tiling and the
    3-device mesh's index tape."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributedtensorflowexample_tpu.parallel.async_ps import (
        make_worker_state)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh, replicated_sharding)
    from distributedtensorflowexample_tpu.training.state import (
        TrainState as JaxTrainState)
    mesh = jax_make_mesh(N)
    state = JaxTrainState.create(_jax_model(), optax.sgd(LR, momentum=MU),
                                 jnp.zeros((B, 28, 28, 1)), seed=0)
    tiled = make_worker_state(jax.device_put(state,
                                             replicated_sharding(mesh)),
                              N, mesh)
    jds = _jax_dataset(mesh)
    return {"params0": _host(state.params),
            "workers": (_host(tiled.params), _host(tiled.opt_state[0].trace)),
            "perms": [np.asarray(jds._make_perm(jnp.asarray(e, jnp.int32)))
                      for e in range(4)]}


def _jax_mode(mode: str, params0: dict) -> dict:
    import jax
    import jax.numpy as jnp
    import optax

    from distributedtensorflowexample_tpu.parallel.bucketing import (
        init_bucketed_opt_state)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh, replicated_sharding)
    from distributedtensorflowexample_tpu.parallel.sync import (
        make_indexed_train_step as jax_make_indexed_train_step)
    from distributedtensorflowexample_tpu.parallel.zero3 import Zero3Layout
    from distributedtensorflowexample_tpu.training.state import (
        TrainState as JaxTrainState)
    mesh = jax_make_mesh(N)
    tx = optax.sgd(LR, momentum=MU)
    params = jax.tree.map(jnp.asarray, params0)
    state = jax.device_put(JaxTrainState(
        step=jnp.asarray(0, jnp.int32), params=params,
        opt_state=tx.init(params), batch_stats={},
        rng=jax.random.PRNGKey(1), tx=tx, apply_fn=_jax_model().apply),
        replicated_sharding(mesh))
    state = state.replace(opt_state=init_bucketed_opt_state(
        optax.sgd(LR, momentum=MU), state.params, BUCKET_BYTES, mesh))
    layout, out = None, {}
    if mode == "zero3":
        layout = Zero3Layout(state.params, BUCKET_BYTES, mesh)
        state = state.replace(params=layout.init_rows(state.params))
        out["rows0"] = _host(state.params)
    jds = _jax_dataset(mesh)
    step = jax_make_indexed_train_step(
        B * N, jds.steps_per_epoch, ce_impl="pallas", dequant_impl="pallas",
        mesh=mesh, num_replicas=N, num_slots=jds.num_slots,
        bucket_bytes=BUCKET_BYTES if mode == "zero1" else None,
        bucket_shard_update=mode == "zero1", zero3_layout=layout)
    tape = []
    with mesh:
        for _ in range(MODE_STEPS):
            state, m = step(state, next(jds))
            tape.append(float(m["loss"]))
    out["tape"] = tape
    out["params"] = _host(layout.materialize(state.params)
                          if layout is not None else state.params)
    out["momentum_rows"] = [np.asarray(s[0].trace) for s in state.opt_state]
    if mode == "zero3":
        out["rows"] = _host(state.params)
    return out


def _jax_async(workers) -> dict:
    import jax
    import jax.numpy as jnp
    import optax

    from distributedtensorflowexample_tpu.parallel.async_ps import (
        make_indexed_async_train_step as jax_async_step)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        DATA_AXIS, make_mesh as jax_make_mesh)
    from distributedtensorflowexample_tpu.training.state import (
        TrainState as JaxTrainState)
    mesh = jax_make_mesh(N)
    tiled = jax.sharding.NamedSharding(mesh,
                                       jax.sharding.PartitionSpec(DATA_AXIS))
    put = lambda t: jax.device_put(jax.tree.map(jnp.asarray, t), tiled)
    state = JaxTrainState(
        step=jnp.asarray(0, jnp.int32), params=put(workers[0]),
        opt_state=(optax.TraceState(trace=put(workers[1])),
                   optax.EmptyState()),
        batch_stats={}, rng=jax.random.PRNGKey(1),
        tx=optax.sgd(LR, momentum=MU), apply_fn=_jax_model().apply)
    jds = _jax_dataset(mesh)
    step = jax_async_step(N, PERIOD, B * N, jds.steps_per_epoch,
                          ce_impl="pallas", mesh=mesh,
                          num_slots=jds.num_slots, dequant_impl="pallas")
    tape = []
    with mesh:
        for _ in range(ASYNC_STEPS):
            state, m = step(state, next(jds))
            tape.append(float(m["loss"]))
    return {"tape": tape, "params": _host(state.params),
            "momentum": _host(state.opt_state[0].trace)}


@pytest.fixture(scope="module")
def runs():
    from concurrent.futures import ThreadPoolExecutor
    inputs = _jax_inputs()
    with ThreadPoolExecutor(1) as pool:
        group = pool.submit(launch.spawn, _rank_checks, N, "gloo",
                            (inputs,), 300)
        jax_side = {mode: _jax_mode(mode, inputs["params0"])
                    for mode in MODES}
        jax_side["async"] = _jax_async(inputs["workers"])
        ranks = group.result()
    return {"inputs": inputs, "ranks": ranks, "jax": jax_side}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               err_msg=what)


@pytest.mark.parametrize("mode", MODES)
def test_three_rank_zero_modes_track_the_jax_mesh(runs, mode):
    ranks = [r[mode] for r in runs["ranks"]]
    want = runs["jax"][mode]
    tape = ranks[0]["tape"]
    assert all(r["tape"] == tape for r in ranks)
    assert all(np.isfinite(tape)) and tape[-1] < tape[0]
    _close(tape, want["tape"], "tape")
    mine = dict(_leaves(ranks[0]["params"]))
    for path, w in _leaves(want["params"]):
        _close(mine[path], w, path)
    assert len({_bits(r["flat"]) for r in ranks}) == 1
    params0 = runs["inputs"]["params0"]
    for key in ("momentum_rows", "rows0", "rows"):
        if key not in want:
            continue
        conv = convert.jax_rows_to_port(want[key], params0, BUCKET_BYTES, N)
        for d, r in enumerate(ranks):
            assert len(r[key]) == len(conv[d])
            for b, (g, w) in enumerate(zip(r[key], conv[d])):
                if key == "rows0":
                    np.testing.assert_array_equal(g, w, err_msg=f"{d} {b}")
                else:
                    _close(g, w, f"{key} rank {d} bucket {b}")


@pytest.mark.parametrize("mode", MODES)
def test_three_rank_zero_modes_keep_their_budget(runs, mode):
    from distributedtensorflowexample_tpu_torch.engine.spec import (
        collective_budget)
    for r in runs["ranks"]:
        got = r[mode]
        assert got["num_buckets"] >= 3          # a real ladder
        budget = collective_budget(parse_flags(_flags(*_MODE_FLAGS[mode])),
                                   N, got["num_buckets"])
        assert {k: v for k, v in got["collectives"].items() if v} == budget


def test_three_rank_async_tracks_the_jax_workers(runs):
    want = runs["jax"]["async"]
    ranks = [r["async"] for r in runs["ranks"]]
    tape = ranks[0]["tape"]
    assert all(r["tape"] == tape for r in ranks)
    _close(tape, want["tape"], "tape")
    for w, rank in enumerate(ranks):
        # two averagings (after steps 2 and 4), no gradient all-reduce
        assert rank["all_reduces"] == ASYNC_STEPS // PERIOD
        for name in ("params", "momentum"):
            mine = dict(_leaves(rank[name]))
            for path, tiled in _leaves(want[name]):
                _close(mine[path], tiled[w], f"{name} {path} worker {w}")
    # One step after the last averaging: the workers differ again.
    first, second = (dict(_leaves(r["params"])) for r in ranks[:2])
    assert any(not np.array_equal(first[p], second[p]) for p in first)
