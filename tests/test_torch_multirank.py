"""Multi-rank sync SGD on the CPU: the port's N gloo ranks, one process
each (``parallel/launch.spawn``), against the JAX package on an N-device
mesh of the conftest's virtual CPU devices, from the same global batch.

Three groups (1, 2 and 4 ranks) start once for the module and run every
check that needs a group (the 2-rank one also ``--data_sharding
sharded``), and a fourth of 3 ranks runs the trainer surface at a rank
count that does not divide 1000 (plain and bucketed); the JAX side runs
meanwhile in this process.
The rank workers below import no JAX (a spawned rank imports this module
to find them), so the JAX package is imported inside the functions that
use it.

JAX side: ``make_indexed_train_step`` on ``make_mesh(N)`` with the Pallas
cross-entropy and dequant kernels in interpret mode (its own CPU route).
Config 3's update there is ``optax.sgd`` with momentum, the recurrence
of its fused Pallas SGD: that kernel in interpret mode costs ~10 s a step
over 3.27M parameters on a 4-device mesh here, and
``tests/test_torch_kernels.py`` holds the port's SGD against it; the
lm_tiny tape runs the fused Pallas SGD itself.  Port side: CPU tensors,
so every kernel wrapper runs its plain version.

Tolerances: config 3 (bfloat16) as ``tests/test_torch_slice.py``: the
tape within 1e-2 relative, the first update within 8e-2 of its largest
element; lm_tiny in float32 as ``tests/test_torch_lm.py``: the tape
within 1e-4 relative, parameters and momentum within 1e-4 of the largest
value.  N ranks at B against one rank at N*B in float32: rtol 2e-5, atol
2e-6 after 3 steps (``tests/test_sync_dp.py``'s bound: the sums run in
another order).  Partial aggregation (float32, one step at R of 4 and
step s) against the JAX mesh's step with the same R, and against one
rank's plain step on the selected replicas' rows: rtol 1e-5, atol 1e-6
(``test_sync_dp.py``'s).  The sharded split on 2 ranks (float32, plain
cross-entropy) against the JAX sharded step: rtol 1e-5, atol 1e-6 (the
replication modes' bound).  Replicas against each other, and the eval
count: exact.
"""

import dataclasses
import hashlib
import os
import socket
import struct
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from distributedtensorflowexample_tpu_torch import cluster, convert
from distributedtensorflowexample_tpu_torch.config import parse_flags
from distributedtensorflowexample_tpu_torch.data.lm import load_lm
from distributedtensorflowexample_tpu_torch.data.synthetic import (
    make_synthetic)
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
from distributedtensorflowexample_tpu_torch.engine.engine import (
    eval_batch_size)
from distributedtensorflowexample_tpu_torch.models import build_model
from distributedtensorflowexample_tpu_torch.parallel import launch
from distributedtensorflowexample_tpu_torch.parallel.mesh import (
    ONE_RANK, Mesh, card_of, local_world_size, make_mesh)
from distributedtensorflowexample_tpu_torch.parallel.sync import (
    _build_step_fn, make_device_gather, make_resident_eval)
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
from distributedtensorflowexample_tpu_torch.training.optimizers import (
    build_optimizer)
from distributedtensorflowexample_tpu_torch.training.state import TrainState

B, ROWS, STEPS, LR, MU = 8, 256, 5, 0.05, 0.9
LM_B, SEQ = 4, 32           # lm_tiny: 4 rows per replica, short sequences
PARTIAL_R, PARTIAL_S = (0, 1, 3, 4), (0, 1, 5)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread here, and so in every spawned rank
    (``launch.spawn`` splits the caller's threads among its ranks)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flags(*extra) -> list[str]:
    return ["--device", "cpu", "--fused_optimizer", "true", "--momentum",
            str(MU), "--learning_rate", str(LR), "--dropout", "0",
            "--pallas_ce", "true", "--dequant_impl", "pallas",
            "--batch_size", str(B), *extra]


def _split():
    return make_synthetic(ROWS, (28, 28, 1), 10, seed=0, sample_seed=1)


def _close(got, want, rtol, atol) -> str | None:
    try:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    except AssertionError as err:
        return str(err)
    return None


def _digest(state) -> str:
    return hashlib.sha256(
        state.optimizer.params_flat.numpy().tobytes()).hexdigest()


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
    """512 train and 128 test rows of the synthetic split as IDX files,
    so a trainer process loads a small split through --data_dir."""
    for split, (num, sample_seed) in {"train": (512, 1),
                                      "test": (128, 2)}.items():
        _write_idx(data_dir, split, *make_synthetic(
            num, (28, 28, 1), 10, seed=0, sample_seed=sample_seed))


def _cluster_flag_ranks(data_dir):
    """Two trainer processes joined by the cluster flags alone (the
    ``tcp://`` store at the coordinator), as a user starts them."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-m",
         "distributedtensorflowexample_tpu_torch.trainers.trainer_sync_mnist",
         "--device", "cpu", "--dataset", "mnist", "--data_dir", str(data_dir),
         "--coordinator_address", f"127.0.0.1:{port}", "--num_processes",
         "2", "--process_id", str(rank), "--train_steps", "10",
         "--batch_size", str(B), "--log_every", "5", "--log_dir", ""],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]


# --- rank workers (run in the spawned ranks; no JAX) ----------------------

def _cnn_tape(mesh, inp) -> dict:
    """Config 3 from the converted JAX init over the JAX index tape."""
    built = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(_flags()))).build(
        mesh, data=_split(), perm_fn=inp["cnn_perms"].__getitem__)
    convert.load_into_state(built.state, inp["cnn_params0"])
    tape, params1 = [], None
    for i in range(STEPS):
        _, m = built.step(built.state, next(built.ds))
        tape.append(float(mesh.sum_metrics(m)["loss"]))
        if i == 0 and mesh.rank == 0:
            params1 = convert.state_to_flax(built.state)[0]
    return {"tape": tape, "params1": params1, "digest": _digest(built.state),
            "state": built.state}


def _lm_tape(mesh, inp) -> dict:
    cfg = parse_flags(_flags("--dtype", "float32", "--learning_rate", "0.1",
                             "--batch_size", str(LM_B)))
    x, y = load_lm("", "train", num=64, seq_len=SEQ)
    built = Engine(RunSpec("lm_tiny", "lm", cfg)).build(
        mesh, data=(x, y), perm_fn=inp["lm_perms"].__getitem__)
    convert.load_into_state(built.state, inp["lm_params0"])
    tape = []
    for _ in range(STEPS):
        _, m = built.step(built.state, next(built.ds))
        tape.append(float(mesh.sum_metrics(m)["loss"]))
    params, momentum = convert.state_to_flax(built.state)
    return {"tape": tape, "params": params if mesh.rank == 0 else None,
            "momentum": momentum if mesh.rank == 0 else None}


def _n_ranks_equal_one_rank(mesh, inp) -> dict:
    """3 float32 steps at B per rank; rank 0 also runs one rank at N*B
    (no group) from the same seed and index tape and compares."""
    def run(m, batch):
        cfg = parse_flags(_flags("--dtype", "float32", "--batch_size",
                                 str(batch)))
        built = Engine(RunSpec("mnist_cnn", "mnist", cfg)).build(
            m, data=_split(), perm_fn=inp["cnn_perms"].__getitem__)
        for _ in range(3):
            built.step(built.state, next(built.ds))
        return built.state

    before = mesh.all_reduces
    state = run(mesh, B)
    out = {"digest": _digest(state), "all_reduces": mesh.all_reduces - before}
    if mesh.rank == 0:
        one = run(Mesh(CPU), B * mesh.size)
        out["vs_one_rank"] = _close(state.optimizer.params_flat.numpy(),
                                    one.optimizer.params_flat.numpy(),
                                    rtol=2e-5, atol=2e-6)
    return out


def _partial_aggregation(mesh, inp) -> dict:
    """One float32 step of config 3 at each R and s, from the converted
    JAX init over the JAX index tape.  Rank 0 keeps the parameters for
    the JAX mesh's step, and compares them with one rank's plain step on
    the selected replicas' rows of the same global batch."""
    n = mesh.size
    flags = lambda *extra: _flags("--dtype", "float32", *extra)
    out, plain = {}, {}
    for r in PARTIAL_R:
        for s in PARTIAL_S:
            built = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(flags(
                "--replicas_to_aggregate", str(r))))).build(
                mesh, data=_split(), perm_fn=inp["cnn_perms"].__getitem__)
            convert.load_into_state(built.state, inp["cnn_params0"])
            built.state.step = s
            data = next(built.ds)
            built.step(built.state, data)
            got = built.state.optimizer.params_flat.numpy()
            if r in (0, n):
                plain.setdefault(s, []).append(got.copy())
            if mesh.rank != 0 or r in (0, n):
                continue
            out[("jax", r, s)] = convert.state_to_flax(built.state)[0]
            sel = [i for i in range(n) if (i - s) % n < r]
            gathered = [make_device_gather(
                B * n, built.ds.steps_per_epoch, num_slots=built.ds.num_slots,
                dequant_impl="pallas", mesh=Mesh(CPU, rank=i, size=n))(s, data)
                for i in sel]
            ref = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(
                flags()))).build(Mesh(CPU), data=_split())
            convert.load_into_state(ref.state, inp["cnn_params0"])
            _build_step_fn(ce_impl="pallas")(ref.state, {
                k: torch.cat([g[k] for g in gathered]) for k in gathered[0]})
            out[(r, s)] = _close(got, ref.state.optimizer.params_flat.numpy(),
                                 rtol=1e-5, atol=1e-6)
    out["full_r_is_plain"] = all(np.array_equal(a.view(np.int32),
                                                b.view(np.int32))
                                 for a, b in plain.values())
    return out


def _sharded_tape(mesh, inp) -> dict:
    """``--data_sharding sharded``: 3 float32 steps of config 3 over this
    rank's block of the split from the converted JAX init over the JAX
    sharded order (plain cross-entropy and dequant: the fused dequant is
    refused on this path), then the trainer surface on the IDX files."""
    built = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(_flags(
        "--dtype", "float32", "--dequant_impl", "auto", "--pallas_ce",
        "false", "--data_sharding", "sharded")))).build(
        mesh, data=_split(), perm_fn=inp["sharded_perms"].__getitem__)
    convert.load_into_state(built.state, inp["cnn_params0"])
    tape = []
    for _ in range(STEPS):
        _, m = built.step(built.state, next(built.ds))
        tape.append(float(mesh.sum_metrics(m)["loss"]))
    run = Engine(RunSpec("mnist_cnn", "mnist", parse_flags([
        "--device", "cpu", "--dataset", "mnist", "--data_dir",
        inp["data_dir"], "--data_sharding", "sharded", "--train_steps", "4",
        "--batch_size", str(B), "--log_dir", ""]))).run()
    return {"tape": tape, "rows": built.ds.images.shape[0],
            "params": (convert.state_to_flax(built.state)[0]
                       if mesh.rank == 0 else None),
            "run": {k: run[k] for k in ("resident_rows", "params_digest",
                                        "steps")}}


def _rank_state(mesh, inp) -> dict:
    """Each rank seeds its init with its own rank: the broadcast makes
    the replicas equal anyway.  The dropout generators, seeded from one
    seed, still differ across ranks."""
    cfg = parse_flags(["--momentum", "0.9"])
    make = lambda seed: TrainState.create(
        build_model("mnist_cnn", dropout=0.5),
        lambda mod: build_optimizer(cfg, mod), seed, CPU, mesh=mesh)
    seeded = make(mesh.rank)
    mask = torch.rand(64, generator=make(0).generator) < 0.5
    return {"init_digest": _digest(seeded), "mask": mask.numpy()}


def _eval(mesh, inp, state) -> dict:
    tx, ty = make_synthetic(200, (28, 28, 1), 10, seed=0, sample_seed=2)
    return {n: make_resident_eval(tx, ty, CPU, batch_size=64,
                                  dequant_impl="pallas", mesh=m)(state)
            for n, m in (("mesh", mesh), ("one", ONE_RANK))}


def _config_digest(mesh, inp) -> str | None:
    steps = "3" if mesh.rank == 1 else "4"
    cfg = parse_flags(_flags("--train_steps", steps, "--dataset",
                             "synthetic", "--log_dir", ""))
    try:
        Engine(RunSpec("mnist_cnn", "mnist", cfg)).run()
    except ModeRefusal as err:
        return str(err)
    return None


def _rank_checks(inp) -> dict:
    mesh = make_mesh("cpu")
    out = {"rank": mesh.rank, "cnn": _cnn_tape(mesh, inp)}
    if "lm_perms" in inp:
        out["lm"] = _lm_tape(mesh, inp)
    out["eval"] = _eval(mesh, inp, out["cnn"].pop("state"))
    out["n_vs_1"] = _n_ranks_equal_one_rank(mesh, inp)
    if mesh.size == 4:
        out["partial"] = _partial_aggregation(mesh, inp)
    if mesh.size == 2:
        out["state"] = _rank_state(mesh, inp)
        out["digest_refusal"] = _config_digest(mesh, inp)
        out["sharded"] = _sharded_tape(mesh, inp)
    return out


def _three_ranks(data_dir: str, log_dir: str) -> dict:
    """3 ranks through ``Engine.run``: config 3 for 2 steps (its final
    checkpoint in ``log_dir``), then the same under ``--bucket_grads``."""
    flags = ["--device", "cpu", "--dataset", "mnist", "--data_dir", data_dir,
             "--train_steps", "2", "--batch_size", str(B)]
    plain = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(
        flags + ["--log_dir", log_dir]))).run()
    bucketed = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(
        flags + ["--log_dir", "", "--bucket_grads", "65536"]))).run()
    keys = ("final_accuracy", "eval_batches", "global_batch", "mode",
            "collectives", "collective_budget", "params_digest", "steps")
    return {"plain": {k: plain[k] for k in keys},
            "bucketed": {k: bucketed[k] for k in keys}}


def _fail_on_rank_1():
    """Rank 1 raises while rank 0 waits for it in a collective."""
    mesh = make_mesh("cpu")
    if mesh.rank == 1:
        raise ModeRefusal("--flag refused on rank 1")
    mesh.all_gather_int(0)


# --- the JAX side and the groups ------------------------------------------

def _jax_cnn_params0():
    """Config 3's converted init (the JAX init from seed 0)."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributedtensorflowexample_tpu.models.mnist_cnn import (
        MnistCNN as JaxMnistCNN)
    from distributedtensorflowexample_tpu.training.state import (
        TrainState as JaxTrainState)
    jstate = JaxTrainState.create(JaxMnistCNN(dropout_rate=0.0),
                                  optax.sgd(LR, momentum=MU),
                                  jnp.zeros((B, 28, 28, 1)), seed=0)
    return jax.tree.map(lambda a: np.array(a, copy=True), jstate.params)


def _jax_perms(n, token_data=False):
    """The JAX dataset's first epoch permutations at the global batch of
    an n-device mesh (the index tape both sides read)."""
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)
    x, y = (load_lm("", "train", num=64, seq_len=SEQ) if token_data
            else _split())
    jds = JaxDeviceDataset(x, y, (LM_B if token_data else B) * n,
                           mesh=jax_make_mesh(n), seed=0,
                           token_data=token_data,
                           dequant_impl="auto" if token_data else "pallas")
    return [np.asarray(jds._make_perm(jnp.asarray(e, jnp.int32)))
            for e in range(4)]


def _jax_cnn_tape(n, params0):
    import jax
    import optax

    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    from distributedtensorflowexample_tpu.models.mnist_cnn import (
        MnistCNN as JaxMnistCNN)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)
    from distributedtensorflowexample_tpu.parallel.sync import (
        make_indexed_train_step as jax_make_indexed_train_step)
    mesh = jax_make_mesh(n)
    x, y = _split()
    jds = JaxDeviceDataset(x, y, B * n, mesh=mesh, seed=0,
                           dequant_impl="pallas")
    jstate = _jax_state(JaxMnistCNN(dropout_rate=0.0), params0,
                        optax.sgd(LR, momentum=MU), mesh)
    jstep = jax_make_indexed_train_step(
        B * n, jds.steps_per_epoch, ce_impl="pallas", dequant_impl="pallas",
        mesh=mesh, num_replicas=n, num_slots=jds.num_slots)
    tape, params1 = [], None
    for i in range(STEPS):
        jstate, m = jstep(jstate, next(jds))
        tape.append(float(m["loss"]))
        if i == 0:
            params1 = jax.tree.map(lambda a: np.array(a, copy=True),
                                   jstate.params)
    return tape, params1


def _jax_state(model, params, tx, mesh, step=0):
    import jax
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.parallel.mesh import (
        replicated_sharding)
    from distributedtensorflowexample_tpu.training.state import (
        TrainState as JaxTrainState)
    params = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.asarray(step, jnp.int32), params=params,
                          opt_state=tx.init(params), batch_stats={},
                          rng=jax.random.PRNGKey(1), tx=tx,
                          apply_fn=model.apply)
    return jax.device_put(state, replicated_sharding(mesh))


def _jax_partial(params0):
    """{(R, s): parameters after one float32 step at step s} of config 3
    on a 4-device mesh with ``replicas_to_aggregate`` R, from
    ``params0`` over the JAX dataset's own index tape."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    from distributedtensorflowexample_tpu.models.mnist_cnn import (
        MnistCNN as JaxMnistCNN)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)
    from distributedtensorflowexample_tpu.parallel.sync import (
        make_indexed_train_step as jax_make_indexed_train_step)
    n, mesh = 4, jax_make_mesh(4)
    x, y = _split()
    jds = JaxDeviceDataset(x, y, B * n, mesh=mesh, seed=0,
                           dequant_impl="pallas")
    data = next(jds)
    model = JaxMnistCNN(dropout_rate=0.0, dtype=jnp.float32)
    out = {}
    for r in (1, 3):
        jstep = jax_make_indexed_train_step(
            B * n, jds.steps_per_epoch, ce_impl="pallas",
            dequant_impl="pallas", mesh=mesh, num_replicas=n,
            replicas_to_aggregate=r, num_slots=jds.num_slots)
        for s in PARTIAL_S:
            jstate, _ = jstep(_jax_state(model, params0,
                                         optax.sgd(LR, momentum=MU), mesh,
                                         step=s), data)
            out[(r, s)] = jax.tree.map(lambda a: np.array(a, copy=True),
                                       jstate.params)
    return out


def _jax_sharded_dataset(n):
    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)
    mesh = jax_make_mesh(n)
    return mesh, JaxDeviceDataset(*_split(), B * n, mesh=mesh, seed=0,
                                  data_sharding="sharded")


def _jax_sharded_order(n) -> list:
    """The JAX sharded order of an n-device mesh, epochs 0-3: each
    device's block shuffled on its own, interleaved."""
    import jax.numpy as jnp
    jds = _jax_sharded_dataset(n)[1]
    return [np.asarray(jds._make_perm(jnp.asarray(e, jnp.int32)))
            for e in range(4)]


def _jax_sharded(n, params0):
    """3 float32 steps of the JAX sharded step on an n-device mesh from
    ``params0``: (tape, params)."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributedtensorflowexample_tpu.models.mnist_cnn import (
        MnistCNN as JaxMnistCNN)
    from distributedtensorflowexample_tpu.parallel.sync import (
        make_indexed_train_step as jax_make_indexed_train_step)
    mesh, jds = _jax_sharded_dataset(n)
    state = _jax_state(JaxMnistCNN(dropout_rate=0.0, dtype=jnp.float32),
                       params0, optax.sgd(LR, momentum=MU), mesh)
    step = jax_make_indexed_train_step(
        B * n, jds.steps_per_epoch, mesh=mesh, num_replicas=n,
        num_slots=jds.num_slots, data_sharding="sharded")
    tape = []
    for _ in range(STEPS):
        state, m = step(state, next(jds))
        tape.append(float(m["loss"]))
    return tape, jax.tree.map(lambda a: np.array(a, copy=True),
                              state.params)


def _jax_eval_batches(counts=(1, 2, 3, 4, 7)) -> dict:
    """{N: the eval batch the JAX Engine hands its resident eval on an
    N-device mesh}, read off ``make_resident_eval``'s argument in a
    0-step run of the tiny MLP (the eval itself is stubbed out)."""
    from unittest import mock

    from distributedtensorflowexample_tpu.config import (
        parse_flags as jax_parse_flags)
    from distributedtensorflowexample_tpu.engine import engine as jax_engine
    from distributedtensorflowexample_tpu.trainers import (
        trainer_tiny_mlp as jax_tiny)
    seen = {}

    def capture(*args, batch_size, **kw):
        seen[n] = batch_size
        return lambda state: 0.0

    with mock.patch.object(jax_engine, "make_resident_eval", capture):
        for n in counts:
            cfg = jax_parse_flags(["--num_devices", str(n), "--train_steps",
                                   "0", "--log_dir", "", "--resume",
                                   "false", "--batch_size", "8"],
                                  dataset="tiny_blobs", dropout=0.0)
            jax_engine.Engine(jax_engine.RunSpec(
                model="tiny_mlp", dataset="tiny_blobs", config=cfg,
                model_fn=lambda c: jax_tiny.TinyMLP(),
                input_fn=jax_tiny.blobs)).run()
    return seen


def _jax_lm_params0():
    """lm_tiny's float32 init from seed 0."""
    import jax
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.models import (
        build_model as jax_build_model)
    model = jax_build_model("lm_tiny", dtype=jnp.float32)
    return jax.tree.map(
        lambda a: np.array(a, copy=True),
        jax.jit(model.init)(jax.random.PRNGKey(0),
                            jnp.zeros((2, SEQ), jnp.int32))["params"])


def _jax_lm_tape(n, params0):
    """lm_tiny (float32) on an n-device mesh: (tape, final params, final
    momentum tree)."""
    import jax
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    from distributedtensorflowexample_tpu.models import (
        build_model as jax_build_model)
    from distributedtensorflowexample_tpu.ops.pallas import fused_momentum_sgd
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)
    from distributedtensorflowexample_tpu.parallel.sync import (
        make_indexed_train_step as jax_make_indexed_train_step)
    mesh = jax_make_mesh(n)
    model = jax_build_model("lm_tiny", dtype=jnp.float32)
    x, y = load_lm("", "train", num=64, seq_len=SEQ)
    jds = JaxDeviceDataset(x, y, LM_B * n, mesh=mesh, seed=0,
                           token_data=True)
    jstate = _jax_state(model, params0, fused_momentum_sgd(0.1, MU), mesh)
    jstep = jax_make_indexed_train_step(
        LM_B * n, jds.steps_per_epoch, ce_impl="pallas", mesh=mesh,
        num_replicas=n, num_slots=jds.num_slots)
    tape = []
    for _ in range(STEPS):
        jstate, m = jstep(jstate, next(jds))
        tape.append(float(m["loss"]))
    jmom = convert.flat_trace_to_tree(np.asarray(jstate.opt_state.trace),
                                      params0)
    return tape, jax.device_get(jstate.params), jmom


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group's results and the JAX side, computed once: the three
    groups (and two processes joined by the cluster flags) start first
    and run while the JAX tapes compile here."""
    data_dir = tmp_path_factory.mktemp("mnist")
    _tiny_mnist(data_dir)
    three_dir = tmp_path_factory.mktemp("three_ranks")
    cluster_procs = _cluster_flag_ranks(data_dir)
    try:
        sizes = (1, 2, 4)
        params0 = _jax_cnn_params0()
        inputs = {n: {"cnn_params0": params0, "cnn_perms": _jax_perms(n)}
                  for n in sizes}
        lm_params0 = _jax_lm_params0()
        inputs[2].update(lm_params0=lm_params0,
                         lm_perms=_jax_perms(2, token_data=True))
        # The sharded order first (the 2-rank group reads it); its JAX
        # tape is computed again below while the groups run.
        inputs[2].update(sharded_perms=_jax_sharded_order(2),
                         data_dir=str(data_dir))
        with ThreadPoolExecutor(len(sizes) + 1) as pool:
            groups = {n: pool.submit(launch.spawn, _rank_checks, n, "gloo",
                                     (inputs[n],), 300) for n in sizes}
            failing = pool.submit(launch.spawn, _fail_on_rank_1, 2, "gloo",
                                  (), 300)
            three = pool.submit(launch.spawn, _three_ranks, 3, "gloo",
                                (str(data_dir), str(three_dir)), 300)
            jax_eval_batches = _jax_eval_batches()
            jax_cnn = {n: _jax_cnn_tape(n, inputs[n]["cnn_params0"])
                       for n in sizes}
            jax_lm = _jax_lm_tape(2, lm_params0)
            jax_partial = _jax_partial(params0)
            jax_sharded = _jax_sharded(2, params0)
            ranks = {n: g.result() for n, g in groups.items()}
            failed = failing.exception()
            three = three.result()
        cluster_out = [(*p.communicate(timeout=300), p.returncode)
                       for p in cluster_procs]
    finally:
        for proc in cluster_procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return {"inputs": inputs, "ranks": ranks, "jax_cnn": jax_cnn,
            "jax_lm": jax_lm, "jax_partial": jax_partial,
            "failed": failed, "data_dir": data_dir, "three": three,
            "three_dir": three_dir, "jax_eval_batches": jax_eval_batches,
            "jax_sharded": jax_sharded,
            "cluster_flags": cluster_out}


# --- the checks -----------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4])
def test_config3_tape_tracks_the_jax_mesh(runs, n):
    jtape, jparams1 = runs["jax_cnn"][n]
    ranks = runs["ranks"][n]
    tape = ranks[0]["cnn"]["tape"]
    assert all(r["cnn"]["tape"] == tape for r in ranks)
    assert all(np.isfinite(tape)) and tape[-1] < tape[0]
    np.testing.assert_allclose(tape, jtape, rtol=1e-2)
    params0 = runs["inputs"][n]["cnn_params0"]
    params1 = ranks[0]["cnn"]["params1"]
    for k0, leaves in jparams1.items():
        for k1, want in leaves.items():
            want = want - params0[k0][k1]
            moved = params1[k0][k1] - params0[k0][k1]
            rel = np.abs(moved - want).max() / np.abs(want).max()
            assert rel < 8e-2, (n, k0, k1, rel)


def test_lm_tiny_tape_tracks_the_jax_mesh(runs):
    import jax
    jtape, jparams, jmom = runs["jax_lm"]
    ranks = runs["ranks"][2]
    tape = ranks[0]["lm"]["tape"]
    assert ranks[1]["lm"]["tape"] == tape
    assert all(np.isfinite(tape)) and tape[-1] < tape[0]
    np.testing.assert_allclose(tape, jtape, rtol=1e-4)
    for got_tree, want_tree in ((ranks[0]["lm"]["params"], jparams),
                                (ranks[0]["lm"]["momentum"], jmom)):
        got = dict(jax.tree.leaves_with_path(got_tree))
        for path, want in jax.tree.leaves_with_path(want_tree):
            want = np.asarray(want)
            np.testing.assert_allclose(got[path], want, rtol=0,
                                       atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("n", [1, 2, 4])
def test_replicas_stay_bitwise_equal(runs, n):
    ranks = runs["ranks"][n]
    for key in ("cnn", "n_vs_1"):
        assert len({r[key]["digest"] for r in ranks}) == 1, key
    # One gradient all-reduce per step, on every rank (a 1-rank group
    # still runs its collective).
    assert [r["n_vs_1"]["all_reduces"] for r in ranks] == [3] * n


@pytest.mark.parametrize("n", [2, 4])
def test_n_ranks_at_b_equal_one_rank_at_n_b(runs, n):
    assert runs["ranks"][n][0]["n_vs_1"]["vs_one_rank"] is None


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("s", PARTIAL_S)
def test_partial_aggregation_tracks_the_jax_mesh(runs, r, s):
    got = runs["ranks"][4][0]["partial"][("jax", r, s)]
    for k0, leaves in runs["jax_partial"][(r, s)].items():
        for k1, want in leaves.items():
            np.testing.assert_allclose(got[k0][k1], want, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k0}/{k1}")


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("s", PARTIAL_S)
def test_partial_aggregation_is_a_step_on_the_selected_rows(runs, r, s):
    assert runs["ranks"][4][0]["partial"][(r, s)] is None


def test_partial_aggregation_bounds(runs):
    assert runs["ranks"][4][0]["partial"]["full_r_is_plain"]
    for r in (-1, 5):
        with pytest.raises(ValueError, match=r"must be in \[0, 4\]"):
            _build_step_fn(replicas_to_aggregate=r,
                           mesh=Mesh(CPU, rank=0, size=4))


def test_resident_eval_counts_equal_one_rank(runs):
    for rank in runs["ranks"][2]:
        assert rank["eval"]["mesh"] == rank["eval"]["one"]
        assert 0.0 < rank["eval"]["mesh"] <= 1.0
    x, y = make_synthetic(64, (28, 28, 1), 10, seed=0)
    with pytest.raises(ValueError, match="eval batch 63 must divide across "
                                         "2 devices"):
        make_resident_eval(x, y, CPU, batch_size=63,
                           mesh=Mesh(CPU, rank=0, size=2))


def test_rank_dependent_state(runs):
    a, b = (r["state"] for r in runs["ranks"][2])
    assert a["init_digest"] == b["init_digest"]
    assert not np.array_equal(a["mask"], b["mask"])


def test_mismatched_config_is_refused_on_every_rank(runs):
    for rank in runs["ranks"][2]:
        assert rank["digest_refusal"] is not None
        assert "run configuration differs across the 2 processes" in \
            rank["digest_refusal"]


def test_a_rank_that_raises_raises_in_the_caller(runs):
    err = runs["failed"]
    assert isinstance(err, ModeRefusal) and "--flag" in str(err)
    assert any("raised on rank 1" in note for note in err.__notes__)


# --- no group needed ------------------------------------------------------

_TF_CONFIGS = {
    "none": None,
    "chief": {"cluster": {"chief": ["c:1"], "worker": ["w:1", "w:2"]},
              "task": {"type": "worker", "index": 1}},
    "chief_task": {"cluster": {"chief": ["c:1"], "worker": ["w:1"]},
                   "task": {"type": "chief", "index": 0}},
    "no_chief": {"cluster": {"worker": ["w:1", "w:2", "w:3"]},
                 "task": {"type": "worker", "index": 2}},
    "evaluator": {"cluster": {"worker": ["w:1"]},
                  "task": {"type": "evaluator", "index": 0}},
    "ps_task": {"cluster": {"worker": ["w:1"], "ps": ["p:1"]},
                "task": {"type": "ps", "index": 0}},
    "no_workers": {"cluster": {"ps": ["p:1"]},
                   "task": {"type": "worker", "index": 0}},
    "garbled": "{not json",
}


@pytest.mark.parametrize("tf_config", sorted(_TF_CONFIGS))
@pytest.mark.parametrize("argv", [
    [],
    ["--job_name", "ps"],
    ["--coordinator_address", "h:9", "--num_processes", "4",
     "--process_id", "2"],
    ["--coordinator_address", "h:9", "--num_processes", "2",
     "--task_index", "1"],
    ["--job_name", "worker", "--worker_hosts", "a:1,b:2,c:3",
     "--task_index", "2"],
    ["--worker_hosts", "a:1,b:2"],
], ids=["none", "ps", "coord_pid", "coord_task", "worker_hosts",
        "hosts_no_job"])
def test_cluster_resolution_equals_the_jax_resolver(monkeypatch, tf_config,
                                                     argv):
    import json

    from distributedtensorflowexample_tpu import cluster as jax_cluster
    from distributedtensorflowexample_tpu.config import (
        parse_flags as jax_parse_flags)
    raw = _TF_CONFIGS[tf_config]
    if raw is None:
        monkeypatch.delenv("TF_CONFIG", raising=False)
    else:
        monkeypatch.setenv("TF_CONFIG",
                           raw if isinstance(raw, str) else json.dumps(raw))
    got = cluster.resolve(parse_flags(argv))
    want = jax_cluster.resolve(jax_parse_flags(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.is_distributed == want.is_distributed
    assert cluster.tf_config_env(["a:1", "b:2"], 1) == \
        jax_cluster.tf_config_env(["a:1", "b:2"], 1)


def test_nccl_placement_refusals(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="requested 3 devices, only 2 "
                                         "visible"):
        local_world_size(3, "cuda")
    assert local_world_size(0, "cuda") == 2
    assert local_world_size(1, "cuda") == 1
    assert local_world_size(0, "cpu") == 1 and \
        local_world_size(4, "cpu") == 4
    assert [card_of(r, ["h", "h"], "nccl") for r in range(2)] == [0, 1]
    with pytest.raises(ModeRefusal, match="one card") as err:
        card_of(2, ["h"] * 3, "nccl")
    assert "gloo" in str(err.value)
    assert card_of(2, ["h"] * 3, "gloo") == 0  # gloo may share a card
    # The trainer refuses before it starts a rank.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_sync_mnist)
    with pytest.raises(ValueError, match="requested 3 devices, only 2 "
                                         "visible"):
        trainer_sync_mnist.main(["--device", "cuda", "--num_devices", "3",
                                 "--dataset", "synthetic"])


def test_cluster_flags_join_two_processes(runs):
    (out0, err0, rc0), (out1, err1, rc1) = runs["cluster_flags"]
    assert rc0 == 0 and rc1 == 0, (err0[-2000:], err1[-2000:])
    assert out0.count("step 10: loss=") == 1 and "final accuracy:" in out0
    assert "step" not in out1 and "final accuracy" not in out1


def test_ps_role_prints_the_notice_and_exits(monkeypatch, capsys):
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_sync_mnist)
    monkeypatch.delenv("TF_CONFIG", raising=False)
    assert trainer_sync_mnist.main(["--job_name", "ps"]) == {
        "role": "ps", "exited": True}
    assert cluster.PS_NOTICE in capsys.readouterr().out


def test_cli_two_cpu_ranks_print_once_from_rank_0(runs, tmp_path, capfd):
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_sync_mnist)
    log_dir = tmp_path / "logs"
    summary = trainer_sync_mnist.main(
        ["--device", "cpu", "--num_devices", "2", "--dataset", "mnist",
         "--data_dir", str(runs["data_dir"]), "--train_steps", "20",
         "--batch_size", str(B), "--log_every", "10", "--dequant_impl",
         "pallas", "--pallas_ce", "true", "--fused_optimizer", "true",
         "--log_dir", str(log_dir)])
    out = capfd.readouterr().out
    assert out.count("step 20: loss=") == 1 and out.count("step 10:") == 1
    assert out.count("final_accuracy=") == 1
    assert summary["global_batch"] == 2 * B and summary["num_replicas"] == 2
    assert summary["steps"] == 20 and summary["rank"] == 0
    # Each CPU rank is a device of its own, as the JAX package counts
    # the virtual CPU devices.
    assert summary["num_chips"] == 2
    assert summary["steps_per_sec_per_chip"] == \
        summary["steps_per_sec"] / 2
    ranks = summary["ranks"]
    assert len(ranks) == 2 and ranks[0]["params_digest"] == \
        ranks[1]["params_digest"]
    for r in ranks:
        assert r["all_reduces"] == 20
        # Each rank's own counters, sent back: on the CPU every wrapper
        # takes its plain version, which launches (and counts) nothing.
        assert r["launches"] == {"dequant": 0, "ce_fwd": 0, "ce_bwd": 0,
                                 "sgd": 0}
    lines = (log_dir / "scalars.jsonl").read_text().splitlines()
    assert sum('"final_accuracy"' in line for line in lines) == 1
    tape = [loss for _, loss in summary["loss_tape"]]
    assert len(tape) == 2 and tape[-1] < tape[0]


# --- 3 ranks: a rank count that does not divide 1000 ----------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
def test_eval_batch_equals_the_jax_engine(runs, n):
    """The eval batch at N ranks is the JAX Engine's (999 at N = 3), for
    config 3's global batch and the tiny MLP's the JAX run used."""
    assert eval_batch_size(8 * n, n) == runs["jax_eval_batches"][n]
    assert eval_batch_size(B * n, n) == max(B * n, (1000 // n) * n)
    if n == 3:
        assert eval_batch_size(B * n, n) == 999


def test_three_ranks_evaluate_as_one_rank(runs):
    """Config 3 on 3 ranks trains and evaluates; its final accuracy is the
    one a single rank computes from the same (checkpointed) parameters."""
    three = runs["three"]
    plain = [r["plain"] for r in three]
    assert all(p["steps"] == 2 and p["global_batch"] == 3 * B
               for p in plain)
    assert len({p["params_digest"] for p in plain}) == 1
    assert len({p["final_accuracy"] for p in plain}) == 1
    content = torch.load(runs["three_dir"] / "checkpoints" / "2"
                         / "rank-0.pt", weights_only=True)
    built = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(
        ["--device", "cpu"]))).build(Mesh(CPU), data=_split())
    built.state.optimizer.params_flat.copy_(content["params"])
    tx, ty = make_synthetic(128, (28, 28, 1), 10, seed=0, sample_seed=2)
    one = make_resident_eval(tx, ty, CPU, batch_size=1000)(built.state)
    assert plain[0]["final_accuracy"] == one


def test_three_ranks_bucketed_keep_their_budget(runs):
    """``--bucket_grads`` on 3 ranks: the bucketed mode, the replicas
    bitwise equal, B all-reduces a step."""
    bucketed = [r["bucketed"] for r in runs["three"]]
    assert all(b["mode"] == "bucketed" for b in bucketed)
    assert len({b["params_digest"] for b in bucketed}) == 1
    budget = bucketed[0]["collective_budget"]
    assert budget["all-reduce"] > 1
    assert bucketed[0]["collectives"]["all-reduce"] == 2 * budget[
        "all-reduce"]


# --- --data_sharding sharded on 2 ranks ------------------------------------

def test_sharded_two_ranks_track_the_jax_sharded_step(runs):
    """Each rank holds its half of the split; the tape and parameters
    track the JAX sharded step (float32, rtol 1e-5, atol 1e-6)."""
    jtape, jparams = runs["jax_sharded"]
    sharded = [r["sharded"] for r in runs["ranks"][2]]
    assert [s["rows"] for s in sharded] == [ROWS // 2] * 2
    assert sharded[0]["tape"] == sharded[1]["tape"]
    np.testing.assert_allclose(sharded[0]["tape"], jtape, rtol=1e-5,
                               atol=1e-6)
    got = sharded[0]["params"]
    for k0, leaves in jparams.items():
        for k1, want in leaves.items():
            assert _close(got[k0][k1], want, rtol=1e-5, atol=1e-6) is None


def test_sharded_trainer_surface_on_two_ranks(runs):
    """``--data_sharding sharded`` through ``Engine.run`` on the 512-row
    IDX split: 256 rows resident a rank, the replicas equal."""
    runs_ = [r["sharded"]["run"] for r in runs["ranks"][2]]
    assert [r["resident_rows"] for r in runs_] == [256, 256]
    assert runs_[0]["params_digest"] == runs_[1]["params_digest"]
    assert runs_[0]["steps"] == 4
