"""Configs 1, 4 and 5 on the CPU: the port's softmax regression, weight
decay, CIFAR-10 loader, on-device augment, ResNet with global-batch batch
norm, and the CIFAR trainers, each held against the JAX package on the
same inputs, made from a seed with numpy.

The parity runs feed the port three things from the reference: its
converted parameters and batch statistics (``convert.py``), its index
tape (``perm_fn``) and its augment draws (``draws_fn``: the crop
offsets and flips that ``_crop_flip_selectors`` draws from
``fold_in(fold_in(rng, 0x5EED), step)``).  The ResNet is a cut-down
``ResNetCIFAR(blocks_per_stage=1, widths=(8, 16, 32))``, also with each
block checkpointed (``--remat block``, held bitwise to the plain one);
the all-reduce count is read on ResNet-20 itself, with and without
remat.

Three gloo groups (1, 2 and 4 ranks) and two processes joined by the
cluster flags start once for the module, beside the JAX side; the rank
workers import no JAX (a spawned rank imports this module to find them).

Tolerances:
- softmax forward (float32): within 1e-6 of the largest logit; config
  1 (B=100, lr 0.5): the free-running tape rtol 1e-5 for 5 steps, then
  each of 20 steps from the reference's parameters at that step (loss
  and parameters rtol 1e-5): at lr 0.5 the loss overshoots and one
  float32 rounding grows ~2x a step;
- weight decay, ``load_cifar10``, the augment and its fused dequant:
  bitwise;
- the stride-2 ``SAME`` convolution (float32): within 1e-6 of the
  largest output;
- the small ResNet in float32: logits within 1e-5 of the largest, the
  running statistics rtol 1e-5 with an absolute floor of 1e-5 of each
  tensor's largest value (a mean near zero has no relative digits to
  spare); in bfloat16: logits within 2e-2 of the largest and the
  statistics within 2e-2 (bf16 keeps 8 bits; a reduction order that
  flips one rounding moves every later layer); eval-mode logits in
  bfloat16 agree bitwise here;
- 3 steps of config 4's update (float32, weight decay, momentum, the
  crop and flip) on 1, 2 and 4 ranks: against the JAX step on one
  device, parameters and statistics rtol 1e-5 with the same floor;
  against the JAX step on a 4-device mesh, each leaf within 1.5x the
  JAX package's own 1-vs-4-device gap (up to 2.4e-2 of a leaf's largest
  value in the layers before the first batch norms); the loss tapes
  rtol 1e-5 against both; replicas, their statistics and the eval
  count: exact.
"""

import hashlib
import os
import pickle
import socket
import subprocess
import sys
import tarfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from distributedtensorflowexample_tpu_torch import convert
from distributedtensorflowexample_tpu_torch.config import parse_flags
from distributedtensorflowexample_tpu_torch.data import augment_device as aug
from distributedtensorflowexample_tpu_torch.data.cifar10 import load_cifar10
from distributedtensorflowexample_tpu_torch.data.device_dataset import (
    DeviceDataset)
from distributedtensorflowexample_tpu_torch.data.synthetic import (
    make_synthetic)
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
from distributedtensorflowexample_tpu_torch.models.resnet import (
    BatchNorm, ResNetCIFAR, conv_same)
from distributedtensorflowexample_tpu_torch.parallel import launch
from distributedtensorflowexample_tpu_torch.parallel import mesh as mesh_mod
from distributedtensorflowexample_tpu_torch.parallel.mesh import (
    ONE_RANK, Mesh, make_mesh)
from distributedtensorflowexample_tpu_torch.parallel.sync import (
    make_device_gather, make_indexed_train_step, make_resident_eval)
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
from distributedtensorflowexample_tpu_torch.training.optimizers import (
    build_optimizer)
from distributedtensorflowexample_tpu_torch.training.state import TrainState

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(blocks_per_stage=1, widths=(8, 16, 32))
SMALL_BN = 1 + 3 * 2 + 2    # stem, two per block, two projections
ROWS, G, STEPS = 64, 16, 3  # split rows, global batch, tape steps
CIFAR_FLAGS = ["--learning_rate", "0.1", "--momentum", "0.9",
               "--weight_decay", "1e-4", "--dtype", "float32",
               "--dropout", "0"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cifar_split(num=ROWS, split="train"):
    return load_cifar10("", split, synthetic_size=num, source="synthetic")


def _close(got, want, rtol=1e-5, floor=1e-5) -> str | None:
    """None, or the assertion text: ``got`` within rtol of ``want`` with
    an absolute floor of ``floor`` times the largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    try:
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=floor * np.abs(want).max())
    except AssertionError as err:
        return str(err)
    return None


def _tree_close(got: dict, want: dict, rtol=1e-5, floor=1e-5) -> list:
    import jax
    flat = dict(jax.tree.leaves_with_path(got))
    out = []
    for path, leaf in jax.tree.leaves_with_path(want):
        err = _close(flat[path], leaf, rtol, floor)
        if err:
            out.append((jax.tree_util.keystr(path), err[:300]))
    return out


def _sha(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# --- rank workers (run in the spawned ranks; no JAX) ----------------------

def _small_state(mesh, inp, remat="none"):
    cfg = parse_flags(CIFAR_FLAGS)
    model = ResNetCIFAR(**SMALL, dtype=torch.float32, mesh=mesh,
                        remat=remat)
    state = TrainState.create(model, lambda m: build_optimizer(cfg, m), 0,
                              CPU, mesh=mesh)
    convert.load_into_state(state, inp["params0"],
                            batch_stats=inp["stats0"])
    return state


def _small_tape(mesh, inp, remat="none") -> dict:
    """Config 4's update on the small ResNet from the converted JAX init,
    over the JAX index tape and augment draws, at the global batch G
    (``remat="block"``: each residual block checkpointed)."""
    state = _small_state(mesh, inp, remat)
    ds = DeviceDataset(*_cifar_split(), G, perm_fn=inp["perms"].__getitem__)
    step = make_indexed_train_step(
        G, ds.steps_per_epoch, num_slots=ds.num_slots, augment="cifar",
        draws_fn=inp["draws"].__getitem__, mesh=mesh)
    before = mesh.all_reduces
    tape = []
    for _ in range(STEPS):
        _, m = step(state, next(ds))
        tape.append(float(mesh.sum_metrics(m)["loss"]))
    params, _ = convert.state_to_flax(state)
    stats = convert.state_batch_stats(state)
    tx, ty = _cifar_split(40, "test")
    return {"tape": tape, "params": params if mesh.rank == 0 else None,
            "stats": stats if mesh.rank == 0 else None,
            "digests": (_sha([state.optimizer.params_flat.numpy()]),
                        _sha(b.numpy() for b in state.model.buffers())),
            "all_reduces": mesh.all_reduces - before,
            "eval": {n: make_resident_eval(tx, ty, CPU, batch_size=8,
                                           mesh=m)(state)
                     for n, m in (("mesh", mesh), ("one", ONE_RANK))}}


def _resnet20_all_reduces(mesh, remat="none") -> dict:
    """Two float32 steps of ResNet-20 itself through ``Engine.build`` at
    B=2 per rank: the all-reduces each rank issued."""
    cfg = parse_flags(CIFAR_FLAGS + ["--batch_size", "2", "--remat", remat])
    built = Engine(RunSpec("resnet20", "cifar10", cfg, augment=True)).build(
        mesh, data=_cifar_split())
    before = mesh.all_reduces
    for _ in range(2):
        built.step(built.state, next(built.ds))
    return {"all_reduces": mesh.all_reduces - before,
            "digest": _sha([built.state.optimizer.params_flat.numpy(),
                            *(b.numpy() for b in
                              built.state.model.buffers())])}


def _rank_checks(inp) -> dict:
    mesh = make_mesh("cpu")
    out = {"rank": mesh.rank, "small": _small_tape(mesh, inp),
           "resnet20": _resnet20_all_reduces(mesh)}
    if mesh.size <= 2:
        out["small_remat"] = _small_tape(mesh, inp, "block")
    if mesh.size == 2:
        out["resnet20_remat"] = _resnet20_all_reduces(mesh, "block")
    if mesh.size == 2:
        # The exchange an NCCL group makes over a gloo side group.
        out["hosts"] = mesh_mod.host_names("nccl")
    return out


# --- the JAX side ---------------------------------------------------------

def _jax_small_init(dtype="float32"):
    import jax
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.models.resnet import (
        ResNetCIFAR as JaxResNetCIFAR)
    model = JaxResNetCIFAR(**SMALL, dtype=jnp.dtype(dtype))
    v = jax.jit(model.init)(jax.random.PRNGKey(0),
                            jnp.zeros((2, 32, 32, 3)))
    copy = lambda t: jax.tree.map(lambda a: np.array(a, copy=True), t)
    return model, copy(v["params"]), copy(v["batch_stats"])


def _jax_draws(rng, batch, steps):
    """The crop/flip draws the JAX gather makes at each step."""
    import jax
    out = []
    for s in range(steps):
        key = jax.random.fold_in(jax.random.fold_in(rng, 0x5EED), s)
        ky, kx, kf = jax.random.split(key, 3)
        out.append(tuple(np.asarray(a) for a in (
            jax.random.randint(ky, (batch,), 0, 9),
            jax.random.randint(kx, (batch,), 0, 9),
            jax.random.bernoulli(kf, 0.5, (batch,)))))
    return out


def _jax_state(model, params, stats, tx, mesh):
    import jax
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.parallel.mesh import (
        replicated_sharding)
    from distributedtensorflowexample_tpu.training.state import (
        TrainState as JaxTrainState)
    params = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                          opt_state=tx.init(params),
                          batch_stats=jax.tree.map(jnp.asarray, stats),
                          rng=jax.random.PRNGKey(1), tx=tx,
                          apply_fn=model.apply)
    return jax.device_put(state, replicated_sharding(mesh))


def _jax_small_tape(model, params0, stats0, n):
    """The JAX step of config 4's update on an n-device mesh: (perms,
    draws, tape, params, batch_stats)."""
    import jax
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.config import (
        parse_flags as jax_flags)
    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)
    from distributedtensorflowexample_tpu.parallel.sync import (
        make_indexed_train_step as jax_make_indexed_train_step)
    from distributedtensorflowexample_tpu.training.optimizers import (
        build_optimizer as jax_build_optimizer)
    mesh = jax_make_mesh(n)
    jds = JaxDeviceDataset(*_cifar_split(), G, mesh=mesh, seed=0)
    perms = [np.asarray(jds._make_perm(jnp.asarray(e, jnp.int32)))
             for e in range(3)]
    state = _jax_state(model, params0, stats0,
                       jax_build_optimizer(jax_flags(CIFAR_FLAGS)), mesh)
    step = jax_make_indexed_train_step(
        G, jds.steps_per_epoch, mesh=mesh, num_replicas=n,
        augment="cifar", num_slots=jds.num_slots)
    tape = []
    for _ in range(STEPS):
        state, m = step(state, next(jds))
        tape.append(float(m["loss"]))
    get = lambda t: jax.tree.map(lambda a: np.array(a, copy=True), t)
    return (perms, _jax_draws(jax.random.PRNGKey(1), G, STEPS), tape,
            get(state.params), get(state.batch_stats))


# --- the tiny CIFAR directory and the cluster-flag processes --------------

def _cifar_rows(num, seed):
    """``num`` CIFAR-layout rows: uint8 [num, 3072] CHW and labels."""
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (num, 3072)).astype(np.uint8),
            rs.randint(0, 10, num).tolist())


def _write_pickle(path, data, labels):
    with open(path, "wb") as f:
        pickle.dump({b"data": data, b"labels": labels}, f)


def _write_bin(path, data, labels):
    rows = np.concatenate([np.asarray(labels, np.uint8)[:, None], data], 1)
    path.write_bytes(rows.tobytes())


def _tiny_cifar(data_dir, per_batch=32, test=64):
    """Five train batches and a test batch in the pickle layout."""
    for i in range(1, 6):
        _write_pickle(data_dir / f"data_batch_{i}", *_cifar_rows(per_batch,
                                                                  i))
    _write_pickle(data_dir / "test_batch", *_cifar_rows(test, 9))


def _cluster_flag_ranks(data_dir):
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    module = ("distributedtensorflowexample_tpu_torch.trainers."
              "trainer_multiworker_cifar")
    return [subprocess.Popen(
        [sys.executable, "-m", module, "--device", "cpu", "--dataset",
         "cifar10", "--data_dir", str(data_dir), "--coordinator_address",
         f"127.0.0.1:{port}", "--num_processes", "2", "--process_id",
         str(rank), "--train_steps", "4", "--batch_size", "8",
         "--log_every", "2", "--log_dir", ""],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The groups, the cluster-flag processes and the JAX tape, once."""
    data_dir = tmp_path_factory.mktemp("cifar")
    _tiny_cifar(data_dir)
    procs = _cluster_flag_ranks(data_dir)
    try:
        model, params0, stats0 = _jax_small_init()
        with ThreadPoolExecutor(3) as pool:
            # A JAX tape first: it fixes the index tape and draws the
            # groups read.
            jax4 = _jax_small_tape(model, params0, stats0, 4)
            inp = {"params0": params0, "stats0": stats0, "perms": jax4[0],
                   "draws": jax4[1]}
            groups = {n: pool.submit(launch.spawn, _rank_checks, n, "gloo",
                                     (inp,), 300) for n in (1, 2, 4)}
            jax1 = _jax_small_tape(model, params0, stats0, 1)
            ranks = {n: g.result() for n, g in groups.items()}
        cluster = [(*p.communicate(timeout=300), p.returncode)
                   for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return {"ranks": ranks, "jax": {1: jax1[2:], 4: jax4[2:]},
            "cluster": cluster, "data_dir": data_dir}


# --- config 4 and 5 across ranks ------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4])
def test_config4_steps_track_the_jax_step(runs, n):
    """N ranks at G/N rows each against the JAX step on one device."""
    jtape, jparams, jstats = runs["jax"][1]
    small = runs["ranks"][n][0]["small"]
    np.testing.assert_allclose(small["tape"], jtape, rtol=1e-5)
    assert _tree_close(small["params"], jparams) == []
    assert _tree_close(small["stats"], jstats) == []


def _leaf_gaps(got: dict, want: dict) -> dict:
    """Per leaf: the largest |got - want| over the largest |want|."""
    import jax
    flat = dict(jax.tree.leaves_with_path(got))
    return {jax.tree_util.keystr(p): float(
        np.abs(np.asarray(flat[p]) - np.asarray(w)).max()
        / np.abs(np.asarray(w)).max())
        for p, w in jax.tree.leaves_with_path(want)}


@pytest.mark.parametrize("n", [1, 2, 4])
def test_config4_steps_track_the_jax_mesh(runs, n):
    """Against the JAX step on a 4-device mesh, each leaf no further than
    the JAX package's own one-device step is from it (times 1.5, or
    within 1e-5 of its largest value).  The 4-device reference moves the
    layers before the first batch norms by up to ~2e-2 of their values
    from the 1-device one, which the port at 1, 2 and 4 ranks tracks to
    ~1e-5 (``test_config4_steps_track_the_jax_step``)."""
    jtape, jparams, jstats = runs["jax"][4]
    small = runs["ranks"][n][0]["small"]
    np.testing.assert_allclose(small["tape"], jtape, rtol=1e-5)
    for got, ref, want in ((small["params"], runs["jax"][1][1], jparams),
                           (small["stats"], runs["jax"][1][2], jstats)):
        spread = _leaf_gaps(ref, want)
        for leaf, gap in _leaf_gaps(got, want).items():
            assert gap <= max(1.5 * spread[leaf], 1e-5), (leaf, gap,
                                                          spread[leaf])


@pytest.mark.parametrize("n", [1, 2, 4])
def test_replicas_and_batch_stats_stay_bitwise_equal(runs, n):
    ranks = runs["ranks"][n]
    assert len({r["small"]["digests"] for r in ranks}) == 1
    assert len({r["resnet20"]["digest"] for r in ranks}) == 1
    assert all(r["small"]["tape"] == ranks[0]["small"]["tape"]
               for r in ranks)
    for r in ranks:
        assert r["small"]["eval"]["mesh"] == r["small"]["eval"]["one"]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_batch_norm_all_reduces_per_step(runs, n):
    # ResNet-20: 21 batch-norm layers, each one all-reduce forward and one
    # backward, plus the flat gradient; a single rank reduces only the
    # gradient (its one-rank group still runs that collective).
    per_step = 2 * 21 + 1 if n > 1 else 1
    small = 2 * SMALL_BN + 1 if n > 1 else 1
    for r in runs["ranks"][n]:
        assert r["resnet20"]["all_reduces"] == 2 * per_step
        assert r["small"]["all_reduces"] == STEPS * small


@pytest.mark.parametrize("n", [1, 2])
def test_remat_block_tracks_the_jax_step_and_equals_no_remat(runs, n):
    """``--remat block`` on the small ResNet: the tape, parameters and
    running statistics bitwise those of ``--remat none`` (each buffer
    updated once a step), so within the tolerance of the JAX step on one
    device; on ResNet-20 itself at 2 ranks the same 43 all-reduces a step
    (the recompute reuses the first forward's statistics), and the same
    parameters and statistics bit for bit."""
    jtape, jparams, jstats = runs["jax"][1]
    for r in runs["ranks"][n]:
        remat, plain = r["small_remat"], r["small"]
        assert remat["tape"] == plain["tape"]
        assert remat["digests"] == plain["digests"]
        assert remat["all_reduces"] == plain["all_reduces"]
        if n == 2:
            assert r["resnet20_remat"] == r["resnet20"]
    remat = runs["ranks"][n][0]["small_remat"]
    np.testing.assert_allclose(remat["tape"], jtape, rtol=1e-5)
    assert _tree_close(remat["params"], jparams) == []
    assert _tree_close(remat["stats"], jstats) == []


def test_nccl_host_exchange_over_a_gloo_side_group(runs):
    for r in runs["ranks"][2]:
        assert r["hosts"] == [socket.gethostname()] * 2


def test_cluster_flags_run_config5(runs):
    (out0, err0, rc0), (out1, err1, rc1) = runs["cluster"]
    assert rc0 == 0 and rc1 == 0, (err0[-2000:], err1[-2000:])
    assert out0.count("step 4: loss=") == 1 and "final accuracy:" in out0
    assert "step" not in out1 and "final accuracy" not in out1


def test_card_of_takes_the_host_local_index(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    hosts = ["a", "b", "a", "b"]
    assert [mesh_mod.card_of(r, hosts, "nccl") for r in range(4)] == \
        [0, 0, 1, 1]
    # Two one-card hosts (config 5's layout): each rank on its cuda:0.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert [mesh_mod.card_of(r, ["a", "b"], "nccl") for r in range(2)] == \
        [0, 0]
    with pytest.raises(ModeRefusal, match="2 NCCL ranks on host 'a'"):
        mesh_mod.card_of(1, ["a", "a", "b"], "nccl")
    assert mesh_mod.card_of(1, ["a", "a", "b"], "gloo") == 0


# --- config 1 -------------------------------------------------------------

def _jax_softmax(params, x):
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.models.softmax import (
        SoftmaxRegression as JaxSoftmax)
    return np.asarray(JaxSoftmax().apply({"params": params},
                                         jnp.asarray(x)))


def test_softmax_forward_matches_flax():
    import jax
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.models.softmax import (
        SoftmaxRegression as JaxSoftmax)
    from distributedtensorflowexample_tpu_torch.models import build_model
    x = np.random.RandomState(0).rand(16, 28, 28, 1).astype(np.float32)
    params = jax.tree.map(np.asarray, JaxSoftmax().init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    model = build_model("softmax")
    with torch.no_grad():
        for name, a in convert.flax_to_port(params).items():
            dict(model.named_parameters())[name].copy_(torch.from_numpy(a))
    got = model(torch.from_numpy(x)).detach().numpy()
    want = _jax_softmax(params, x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert convert.port_to_flax(convert.flax_to_port(params))["logits"][
        "kernel"].tobytes() == params["logits"]["kernel"].tobytes()


def test_config1_tape_tracks_the_jax_trainer():
    """20 steps of config 1 (B=100, lr 0.5) from the converted JAX init on
    the JAX index tape.  At lr 0.5 the loss overshoots to ~20-30 nats
    before it settles, and there one float32 rounding grows ~2x a step,
    so the free-running tapes agree to rtol 1e-5 for the first 5 steps;
    every one of the 20 steps is then held from the reference's own
    parameters at that step (loss and update, rtol 1e-5)."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    from distributedtensorflowexample_tpu.models.softmax import (
        SoftmaxRegression as JaxSoftmax)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)
    from distributedtensorflowexample_tpu.parallel.sync import (
        make_indexed_train_step as jax_make_indexed_train_step)
    b, steps = 100, 20
    x, y = make_synthetic(400, (28, 28, 1), 10, seed=0, sample_seed=1)
    mesh = jax_make_mesh(1)
    jds = JaxDeviceDataset(x, y, b, mesh=mesh, seed=0)
    perms = [np.asarray(jds._make_perm(jnp.asarray(e, jnp.int32)))
             for e in range(8)]
    model = JaxSoftmax()
    get = lambda t: jax.tree.map(lambda a: np.array(a, copy=True), t)
    params0 = get(model.init(jax.random.PRNGKey(0),
                             jnp.zeros((2, 28, 28, 1)))["params"])
    state = _jax_state(model, params0, {}, optax.sgd(0.5), mesh)
    jstep = jax_make_indexed_train_step(b, jds.steps_per_epoch, mesh=mesh,
                                        num_slots=jds.num_slots)
    jtape, jparams = [], [params0]
    for _ in range(steps):
        state, m = jstep(state, next(jds))
        jtape.append(float(m["loss"]))
        jparams.append(get(state.params))

    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_local_mnist)
    cfg = trainer_local_mnist.build_config([])
    assert (cfg.batch_size, cfg.learning_rate, cfg.momentum,
            cfg.num_devices) == (b, 0.5, 0.0, 1)

    def port(forced: bool):
        built = Engine(RunSpec("softmax", "mnist", cfg)).build(
            Mesh(CPU), data=(x, y), perm_fn=perms.__getitem__)
        convert.load_into_state(built.state, params0)
        tape, gaps = [], []
        for i in range(steps):
            if forced:
                convert.load_into_state(built.state, jparams[i])
            tape.append(float(built.step(built.state, next(built.ds))[1]
                              ["loss"]))
            if forced:
                gaps += _tree_close(convert.state_to_flax(built.state)[0],
                                    jparams[i + 1])
        return tape, gaps

    free, _ = port(False)
    np.testing.assert_allclose(free[:5], jtape[:5], rtol=1e-5)
    forced, gaps = port(True)
    np.testing.assert_allclose(forced, jtape, rtol=1e-5)
    assert gaps == []
    assert jtape[-1] < jtape[0] and free[-1] < free[0]


@pytest.mark.parametrize("trainer", ["trainer_local_mnist",
                                     "trainer_mirrored_cifar",
                                     "trainer_multiworker_cifar"])
def test_trainers_raise_without_a_card(monkeypatch, trainer):
    import importlib

    from distributedtensorflowexample_tpu_torch.device import (
        DeviceUnavailable)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.delenv("TF_CONFIG", raising=False)
    module = importlib.import_module(
        f"distributedtensorflowexample_tpu_torch.trainers.{trainer}")
    with pytest.raises(DeviceUnavailable):
        module.main(["--dataset", "synthetic", "--train_steps", "2"])


def test_trainer_local_mnist_drives_on_the_cpu(tmp_path, capsys):
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_local_mnist)
    summary = trainer_local_mnist.main(
        ["--device", "cpu", "--dataset", "synthetic", "--train_steps", "60",
         "--log_every", "20", "--log_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step 60: loss=" in out and "final_accuracy=" in out
    assert summary["global_batch"] == 100 and summary["num_replicas"] == 1
    assert summary["final_accuracy"] > 0.9
    with pytest.raises(ModeRefusal, match="--fused_optimizer"):
        trainer_local_mnist.main(["--device", "cpu", "--dataset",
                                  "synthetic", "--fused_optimizer", "true"])


# --- weight decay ---------------------------------------------------------

@pytest.mark.parametrize("momentum", ["0.9", "0"])
def test_weight_decay_step_is_bitwise_optax(momentum):
    import jax
    import jax.numpy as jnp
    import optax

    from distributedtensorflowexample_tpu.config import (
        parse_flags as jax_flags)
    from distributedtensorflowexample_tpu.training.optimizers import (
        build_optimizer as jax_build_optimizer)
    flags = ["--learning_rate", "0.1", "--momentum", momentum,
             "--weight_decay", "1e-4"]
    rs = np.random.RandomState(0)
    n = 4096
    p, g, m = (rs.randn(n).astype(np.float32) * s for s in (1, 1e-2, 1e-1))
    tx = jax_build_optimizer(jax_flags(flags))
    st = tx.init(jnp.asarray(p))
    if momentum != "0":
        trace = st[1][0]._replace(trace=jnp.asarray(m))
        st = (st[0], (trace,) + tuple(st[1][1:]))

    @jax.jit
    def update(p, st, g):
        u, st = tx.update(g, st, p)
        return optax.apply_updates(p, u), st

    jp, jst = update(jnp.asarray(p), st, jnp.asarray(g))
    opt = build_optimizer(parse_flags(flags),
                          torch.nn.Linear(n, 1, bias=False))
    with torch.no_grad():
        opt.params_flat.copy_(torch.from_numpy(p))
        opt.grads_flat.copy_(torch.from_numpy(g))
        if opt.momentum_flat is not None:
            opt.momentum_flat.copy_(torch.from_numpy(m))
    opt.step()
    assert opt.params_flat.numpy().tobytes() == np.asarray(jp).tobytes()
    if momentum != "0":
        assert opt.momentum_flat.numpy().tobytes() == \
            np.asarray(jst[1][0].trace).tobytes()
    with pytest.raises(ModeRefusal, match="weight_decay == 0"):
        build_optimizer(parse_flags(flags + ["--fused_optimizer", "true"]),
                        torch.nn.Linear(4, 1))


# --- the CIFAR loader -----------------------------------------------------

def _jax_load(*args, **kw):
    from distributedtensorflowexample_tpu.data.cifar10 import (
        load_cifar10 as jax_load_cifar10)
    return jax_load_cifar10(*args, **kw)


def _bitwise(got, want) -> bool:
    return all(a.dtype == b.dtype and a.shape == b.shape
               and a.tobytes() == b.tobytes() for a, b in zip(got, want))


@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_cifar_is_the_jax_split(split):
    got = load_cifar10("", split, synthetic_size=48, seed=3,
                       source="synthetic")
    assert _bitwise(got, _jax_load("", split, synthetic_size=48, seed=3,
                                   source="synthetic"))
    assert got[0].shape == (48, 32, 32, 3) and got[1].dtype == np.int32


@pytest.mark.parametrize("layout", ["pickle", "bin", "tar", "nested"])
def test_cifar_files_load_as_the_jax_package_loads_them(tmp_path, layout):
    base = tmp_path / ("cifar-10-batches-py" if layout == "nested"
                       else "raw")
    base.mkdir()
    for i, name in enumerate([f"data_batch_{i}" for i in range(1, 6)]
                             + ["test_batch"]):
        data, labels = _cifar_rows(7, i)
        if layout == "bin":
            _write_bin(base / (name + ".bin"), data, labels)
        else:
            _write_pickle(base / name, data, labels)
    data_dir = tmp_path if layout == "nested" else base
    if layout == "tar":
        data_dir = tmp_path / "tarred"
        data_dir.mkdir()
        with tarfile.open(data_dir / "cifar-10-python.tar.gz", "w:gz") as t:
            t.add(base, arcname="cifar-10-batches-py")
    for split in ("train", "test"):
        for normalize in (True, False):
            got = load_cifar10(str(data_dir), split, normalize=normalize)
            assert _bitwise(got, _jax_load(str(data_dir), split,
                                           normalize=normalize))
    assert len(load_cifar10(str(data_dir), "train")[1]) == 35
    with pytest.raises(FileNotFoundError, match="--dataset synthetic"):
        load_cifar10(str(tmp_path / "empty"), "train")


def test_normalized_cifar_quantizes_to_the_cifar_affine():
    from distributedtensorflowexample_tpu_torch.data.dequant import (
        affine_numpy, try_quantize)
    x, _ = _cifar_split(16)
    u8, spec = try_quantize(x)
    assert spec == "cifar" and affine_numpy(u8, spec).tobytes() == \
        x.tobytes()


# --- the augment ----------------------------------------------------------

def _jax_augment(images, key):
    import jax
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.data.augment_device import (
        cifar_augment_device)
    return np.asarray(jax.jit(cifar_augment_device)(jnp.asarray(images),
                                                    key))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_augment_with_the_jax_draws_is_bitwise(dtype):
    import jax
    rs = np.random.RandomState(1)
    u8 = rs.randint(0, 256, (32, 32, 32, 3)).astype(np.uint8)
    images = u8 if dtype == "uint8" else rs.randn(*u8.shape).astype(
        np.float32)
    rng = jax.random.PRNGKey(7)
    for step in range(3):
        key = jax.random.fold_in(jax.random.fold_in(rng, 0x5EED), step)
        ys, xs, flips = _jax_draws(rng, 32, step + 1)[step]
        got = aug.crop_flip(torch.from_numpy(images), *(
            torch.from_numpy(a) for a in (ys, xs, flips))).numpy()
        assert got.dtype == images.dtype
        assert got.tobytes() == _jax_augment(images, key).tobytes()
    assert flips.any() and not flips.all() and len(set(ys)) > 3


def test_fused_augment_dequant_is_bitwise_augment_then_dequant():
    """The port's fused variant against its augment-then-dequant and
    against the JAX augment followed by the reference's 256-entry
    dequant table.  (The JAX package's own fused variant is bitwise only
    where XLA contracts its multiply-add, which XLA:CPU does for some
    elements and not others; on the CPU the JAX gather takes the table
    route instead.)"""
    import jax

    from distributedtensorflowexample_tpu.data.dequant import (
        make_dequant_lut)
    from distributedtensorflowexample_tpu_torch.data.dequant import (
        make_dequant_affine)
    from distributedtensorflowexample_tpu_torch.data.device_dataset import (
        apply_dequant_affine)
    u8 = np.random.RandomState(2).randint(0, 256, (16, 32, 32, 3)).astype(
        np.uint8)
    rng = jax.random.PRNGKey(3)
    key = jax.random.fold_in(jax.random.fold_in(rng, 0x5EED), 0)
    cut = [torch.from_numpy(a) for a in _jax_draws(rng, 16, 1)[0]]
    s, b = (torch.from_numpy(a) for a in make_dequant_affine("cifar"))
    fused = aug.crop_flip_dequant(torch.from_numpy(u8), *cut, s, b)
    plain = apply_dequant_affine(aug.crop_flip(torch.from_numpy(u8), *cut),
                                 s, b)
    assert fused.numpy().tobytes() == plain.numpy().tobytes()
    lut = make_dequant_lut("cifar")                    # [256, 3]
    routed = _jax_augment(u8, key).astype(np.int64)
    want = lut[routed, np.arange(3)]
    assert fused.numpy().tobytes() == want.tobytes()
    with pytest.raises(TypeError, match="uint8"):
        aug.crop_flip_dequant(fused, *cut, s, b)


@pytest.mark.parametrize("dequant_impl", ["pallas", "auto"])
def test_augmented_gather_matches_the_jax_gather(dequant_impl):
    """One step's batch, this rank's rows of it, against the JAX gather
    on the same index tape and draws (Pallas dequant in interpret mode
    on the JAX side, the kernel's plain version on the port's)."""
    import jax
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    from distributedtensorflowexample_tpu.parallel.sync import (
        make_device_gather as jax_make_device_gather)
    x, y = _cifar_split()
    jds = JaxDeviceDataset(x, y, G, seed=0, dequant_impl=dequant_impl)
    rng = jax.random.PRNGKey(5)
    step = 1
    jgather = jax_make_device_gather(G, jds.steps_per_epoch, "cifar",
                                     num_slots=jds.num_slots,
                                     dequant_impl=dequant_impl)
    want = jgather(jnp.asarray(step), rng, next(jds))
    perms = [np.asarray(jds._make_perm(jnp.asarray(e, jnp.int32)))
             for e in range(3)]
    draws = _jax_draws(rng, G, step + 1)
    ds = DeviceDataset(x, y, G, perm_fn=perms.__getitem__,
                       dequant_impl=dequant_impl)
    for rank, n in ((0, 1), (1, 2), (3, 4)):
        got = make_device_gather(
            G, ds.steps_per_epoch, num_slots=ds.num_slots,
            dequant_impl=dequant_impl, augment="cifar",
            draws_fn=draws.__getitem__,
            mesh=Mesh(CPU, rank=rank, size=n))(step, ds.peek())
        rows = slice(rank * G // n, (rank + 1) * G // n)
        for k in ("image", "label"):
            assert got[k].numpy().tobytes() == \
                np.asarray(want[k])[rows].tobytes(), (k, rank, n)


def test_own_draws_are_the_global_batchs_and_seeded_by_step():
    x, y = _cifar_split()
    ds = DeviceDataset(x, y, G)
    make = lambda rank, n: make_device_gather(
        G, ds.steps_per_epoch, num_slots=ds.num_slots, augment="cifar",
        seed=4, mesh=Mesh(CPU, rank=rank, size=n))
    whole = make(0, 1)(2, ds.peek())["image"]
    halves = torch.cat([make(r, 2)(2, ds.peek())["image"] for r in (0, 1)])
    assert torch.equal(whole, halves)
    assert not torch.equal(whole, make(0, 1)(3, ds.peek())["image"])


# --- the ResNet -----------------------------------------------------------

@pytest.mark.parametrize("size,kernel", [(8, 3), (7, 3), (8, 1), (16, 3)])
def test_stride2_same_conv_matches_flax(size, kernel):
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    x = np.random.RandomState(0).randn(2, size, size, 4).astype(np.float32)
    conv = nn.Conv(5, (kernel, kernel), strides=(2, 2), padding="SAME",
                   use_bias=False)
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
    w = torch.from_numpy(np.ascontiguousarray(
        np.asarray(params["kernel"]).transpose(3, 2, 0, 1)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = conv_same(xt, w, 2).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    if kernel == 3 and size % 2 == 0:
        # padding=1 gives the same shape and other values.
        naive = torch.nn.functional.conv2d(xt, w, stride=2, padding=1)
        assert naive.shape == torch.Size([2, 5, size // 2, size // 2])
        assert np.abs(naive.permute(0, 2, 3, 1).numpy() - want).max() > 0.1


def _port_small(params, stats, dtype):
    model = ResNetCIFAR(**SMALL, dtype=dtype)
    named, bufs = dict(model.named_parameters()), dict(model.named_buffers())
    with torch.no_grad():
        for name, a in convert.flax_to_port(params).items():
            named[name].copy_(torch.from_numpy(a))
        for name, a in convert.batch_stats_to_port(stats).items():
            bufs[name].copy_(torch.from_numpy(a))
    return model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_forward_and_running_stats_match_flax(dtype):
    """Train- and eval-mode logits and the running statistics one train
    forward leaves, against flax compiled without XLA's excess
    precision (which would keep bf16 temporaries in float32)."""
    import jax
    import jax.numpy as jnp
    model, params, stats = _jax_small_init(dtype)
    x = np.random.RandomState(0).randn(8, 32, 32, 3).astype(np.float32)
    # Running statistics away from their init, so eval reads real ones.
    stats = jax.tree.map(lambda a: a + 0.25 * np.random.RandomState(
        a.size).rand(*a.shape).astype(np.float32), stats)

    def fwd(p, s, x, train):
        out = model.apply({"params": p, "batch_stats": s}, x, train=train,
                          mutable=["batch_stats"] if train else False)
        return out if train else (out, {"batch_stats": s})

    bound = 1e-5 if dtype == "float32" else 2e-2
    for train in (True, False):
        compiled = jax.jit(fwd, static_argnums=3).lower(
            params, stats, jnp.asarray(x), train).compile(
            {"xla_allow_excess_precision": False})
        want, upd = compiled(params, stats, jnp.asarray(x))
        port = _port_small(params, stats, getattr(torch, dtype))
        got = port(torch.from_numpy(x), train=train).detach().numpy()
        want = np.asarray(want)
        if dtype == "bfloat16" and not train:
            assert got.tobytes() == want.tobytes()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=bound * np.abs(want).max())
        got_stats = convert.port_to_batch_stats(
            {n: b.numpy() for n, b in port.named_buffers()})
        assert _tree_close(got_stats, jax.device_get(upd["batch_stats"]),
                           rtol=bound, floor=bound) == []


def test_batch_norm_updates_with_the_biased_variance():
    bn = BatchNorm(3, torch.float32)
    x = torch.randn(5, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    bn(x, train=True)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.var, 0.9 + 0.1 * biased, rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(bn.mean, 0.1 * x.mean(dim=(0, 2, 3)),
                               rtol=1e-6, atol=1e-7)


def test_resnet_tree_converts_both_ways_bitwise():
    import jax
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.models.resnet import (
        ResNet20 as JaxResNet20)
    from distributedtensorflowexample_tpu_torch.models import build_model
    v = jax.eval_shape(JaxResNet20().init, jax.random.PRNGKey(0),
                       jnp.zeros((2, 32, 32, 3)))
    rs = np.random.RandomState(0)
    params = jax.tree.map(lambda s: rs.randn(*s.shape).astype(np.float32),
                          v["params"])
    stats = jax.tree.map(lambda s: rs.rand(*s.shape).astype(np.float32),
                         v["batch_stats"])
    with torch.device("meta"):
        model = build_model("resnet20")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    ported = convert.flax_to_port(params)
    assert {n: a.shape for n, a in ported.items()} == shapes
    assert sum(a.size for a in ported.values()) == 272_474
    assert set(convert.batch_stats_to_port(stats)) == {
        n for n, _ in model.named_buffers()}
    back = convert.port_to_flax(ported)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(
        jax.tree.leaves(back), jax.tree.leaves(params)))
    assert jax.tree.leaves(convert.port_to_batch_stats(
        convert.batch_stats_to_port(stats))) == jax.tree.leaves(stats)


def test_resnet_init_follows_flax_defaults():
    from distributedtensorflowexample_tpu_torch.models import build_model
    model = build_model("resnet20").reset_parameters(
        torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        if name.endswith(".weight") and p.dim() == 4:
            fan_in = p[0].numel()
            assert abs(p.std().item() * fan_in ** 0.5 - 1.0) < 0.25, name
    for name, b in model.named_buffers():
        assert torch.all(b == (1.0 if name.endswith("var") else 0.0))
    bn = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert len(bn) == 21
    assert all(torch.all(m.weight == 1) and torch.all(m.bias == 0)
               for m in bn)
    assert torch.all(model.logits.bias == 0)


def test_remat_block_is_refused_for_resnet20():
    """Once refused (a block's recompute updated its batch-norm running
    statistics a second time); the recompute now reuses the first
    forward's statistics, so config 4's Engine builds ResNet-20 with
    ``--remat block`` (``tests/test_torch_input.py`` trains it), and only
    an unknown policy is refused."""
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_mirrored_cifar)
    make = lambda remat: Engine(RunSpec(
        "resnet20", "cifar10", trainer_mirrored_cifar.build_config(
            ["--device", "cpu", "--remat", remat]),
        augment=True)).create_state(Mesh(CPU))
    assert make("block").model.remat == "block"
    with pytest.raises(ValueError, match="unknown remat policy"):
        make("layer")


def test_trainer_mirrored_cifar_drives_on_the_cpu(runs, tmp_path, capsys):
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_mirrored_cifar)
    cfg = trainer_mirrored_cifar.build_config([])
    assert (cfg.batch_size, cfg.train_steps, cfg.learning_rate,
            cfg.momentum, cfg.weight_decay, cfg.lr_schedule,
            cfg.warmup_steps) == (128, 5000, 0.1, 0.9, 1e-4, "step", 200)
    summary = trainer_mirrored_cifar.main(
        ["--device", "cpu", "--dataset", "cifar10", "--data_dir",
         str(runs["data_dir"]), "--train_steps", "6", "--batch_size", "8",
         "--log_every", "3", "--dequant_impl", "pallas", "--pallas_ce",
         "true", "--log_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step 6: loss=" in out and "final_accuracy=" in out
    tape = [loss for _, loss in summary["loss_tape"]]
    assert len(tape) == 2 and all(np.isfinite(tape))
    assert summary["steps"] == 6 and summary["eval_batches"] == 1
    assert 0.0 <= summary["final_accuracy"] <= 1.0


def test_profiled_resnet20_is_config4s_step():
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_mirrored_cifar)
    from distributedtensorflowexample_tpu_torch.utils import profiling
    spec, batches = profiling.workload("resnet20", ["--steps_per_loop", "1"])
    want = trainer_mirrored_cifar.build_config(
        ["--dequant_impl", "pallas", "--pallas_ce", "true", "--dataset",
         "synthetic", "--steps_per_loop", "1"])
    assert (spec.model, spec.dataset, spec.augment, batches) == (
        "resnet20", "cifar10", True, [128])
    assert spec.config == want and not spec.config.fused_optimizer
    assert spec.config.weight_decay == 1e-4
