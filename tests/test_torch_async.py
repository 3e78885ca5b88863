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

Batch-norm models in async mode normalize each worker over its own rows
and keep its own running statistics, as each of the JAX package's
``make_worker_state`` workers does with its tiled ``batch_stats``
(float32, B=8 per worker, no augment or weight decay, the same 5 steps at
period 2 from the JAX workers' parameters, momentum and statistics).
Against the JAX shard_map step: the cut-down ResNet of
``tests/test_torch_cifar.py`` (``ResNetCIFAR(blocks_per_stage=1,
widths=(8, 16, 32))``), the tape within rtol 1e-5, and every worker's
parameters, momentum and statistics, and the eval's average
(``consolidated``: parameters and statistics, against the JAX package's
``consolidate``), each leaf within 1e-5 of its largest value of the JAX
step's, or no further from the same JAX step run in float64
(``jax.enable_x64``, the arbiter) than the JAX float32 step is.  At B=8 a
worker the JAX float32 step's leaves sit up to ~9e-2 of their largest
value from the float64 step's (the momentum of the stem's batch norm and
of the first convolutions), the port's up to ~3e-2 and never further.
A plain float64 loop of the port's model (batch norm in float64, the
rest of the port's code) is held within 2e-6 of the JAX float64 step.
ResNet-20 against the JAX step is ``tests/test_torch_async_resnet20.py``;
here it is held by the port's own invariants from the port's init: each
worker's statistics its own, the parameters bitwise equal at each
averaging, the averaging the only all-reduce, and each worker's state
back bit for bit after the eval's average.  Through
``trainer_mirrored_cifar`` (a tiny pickle split), a resume across an
averaging is bitwise, statistics included.
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
from distributedtensorflowexample_tpu_torch.parallel.async_ps import (
    consolidated)
from distributedtensorflowexample_tpu_torch.parallel.mesh import make_mesh

B, ROWS, LR, MU, PERIOD = 8, 256, 0.05, 0.9, 2
SMALL = dict(blocks_per_stage=1, widths=(8, 16, 32))
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


def _bucketed_average(mesh) -> dict:
    """Config 3 in float32 for 2 periods, the average in one all-reduce
    and in 16 KiB buckets: the parameters and the all-reduces of each."""
    out = {}
    for name, extra in (("one", ()), ("bucketed", ("--bucket_grads",
                                                   str(16 << 10)))):
        built = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(_flags(
            "--dtype", "float32", *extra)))).build(mesh, data=_split())
        before = mesh.all_reduces
        for _ in range(2 * PERIOD):
            built.step(built.state, next(built.ds))
        out[name] = {"params": built.state.optimizer.params_flat.numpy()
                     .copy(), "all_reduces": mesh.all_reduces - before}
    from distributedtensorflowexample_tpu_torch.parallel.bucketing import (
        BucketPlan)
    out["buckets"] = BucketPlan(built.state.optimizer.slices, 16 << 10,
                                mesh.size).num_buckets
    return out


def _cifar_split():
    return make_synthetic(ROWS, (32, 32, 3), 10, seed=0, sample_seed=1)


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _resnet_tapes(mesh, inp, model: str) -> dict:
    """``model`` (``small``: the cut-down ResNet from the JAX workers'
    state; ``resnet20``: from the port's own init; ``resnet20_jax``:
    ResNet-20 from the JAX workers' state) in async mode, STEPS
    steps over the JAX index tape: the tape, this worker's parameters,
    momentum and statistics, digests of its parameters and statistics
    after each step, and the eval's average (and this worker's state
    after it)."""
    engine = Engine(RunSpec("resnet20", "cifar10", parse_flags(_flags(
        "--dtype", "float32"))))
    state = None
    if model in ("small", "resnet20_jax"):
        from distributedtensorflowexample_tpu_torch.models.resnet import (
            ResNetCIFAR)
        from distributedtensorflowexample_tpu_torch.training.optimizers \
            import build_optimizer
        from distributedtensorflowexample_tpu_torch.training.state import (
            TrainState)
        state = TrainState.create(
            ResNetCIFAR(**(SMALL if model == "small" else {}),
                        dtype=torch.float32),
            lambda m: build_optimizer(engine.spec.config, m), 0, CPU,
            mesh=mesh)
        convert.load_into_state(
            state, convert.worker_slice(inp["resnet_params0"], mesh.rank),
            convert.worker_slice(inp["resnet_momentum0"], mesh.rank),
            convert.worker_slice(inp["resnet_stats0"], mesh.rank))
    built = engine.build(mesh, data=_cifar_split(), state=state,
                         perm_fn=inp["resnet_perms"].__getitem__)
    state = built.state
    before, tape, digests = mesh.all_reduces, [], []
    buffers = lambda: [b.numpy().copy() for _, b in
                       state.model.named_buffers()]
    for _ in range(STEPS):
        _, m = built.step(state, next(built.ds))
        tape.append(float(mesh.sum_metrics(m)["loss"]))
        digests.append((_digest(state.optimizer.params_flat.numpy()),
                        _digest(*buffers())))
    own = (_digest(state.optimizer.params_flat.numpy()), _digest(*buffers()))
    params, momentum = convert.state_to_flax(state)
    with consolidated(state, mesh):
        avg = (convert.state_to_flax(state)[0],
               convert.state_batch_stats(state))
    return {"tape": tape, "params": params, "momentum": momentum,
            "stats": convert.state_batch_stats(state), "digests": digests,
            "average": avg, "after_average": own == (
                _digest(state.optimizer.params_flat.numpy()),
                _digest(*buffers())),
            "all_reduces": mesh.all_reduces - before}


def _batch_norm_f64(self, x, train, mesh=None):
    """``models/resnet.BatchNorm.forward`` in float64 throughout (the
    port's computes its statistics in float32)."""
    from distributedtensorflowexample_tpu_torch.models.resnet import (
        BN_EPSILON, BN_MOMENTUM)
    xd = x.double()
    if train:
        mean = xd.mean(dim=(0, 2, 3))
        var = ((xd * xd).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
            self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
    else:
        mean, var = self.mean, self.var
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(var + BN_EPSILON) * self.weight
    return (xd - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


def _float64_small(mesh, inp) -> dict:
    """The same async steps of the cut-down ResNet as a plain float64
    loop: this worker's mean loss, momentum SGD, the parameters averaged
    over the workers every PERIOD steps.  This worker's parameters,
    momentum and statistics after STEPS steps, as flax trees."""
    from unittest import mock

    from distributedtensorflowexample_tpu_torch.models.resnet import (
        BatchNorm, ResNetCIFAR)
    from distributedtensorflowexample_tpu_torch.parallel.sync import (
        make_device_gather)
    model = ResNetCIFAR(**SMALL, dtype=torch.float64).double()
    convert.load_into_state(
        type("S", (), {"model": model, "optimizer": None})(),
        convert.worker_slice(inp["resnet_params0"], mesh.rank),
        batch_stats=convert.worker_slice(inp["resnet_stats0"], mesh.rank))
    for buf in model.buffers():
        buf.data = buf.data.double()
    params = dict(model.named_parameters())
    moms = {n: torch.from_numpy(v).double() for n, v in convert.flax_to_port(
        convert.worker_slice(inp["resnet_momentum0"], mesh.rank)).items()}
    ds = Engine(RunSpec("resnet20", "cifar10", parse_flags(_flags(
        "--dtype", "float32")))).build(
        mesh, data=_cifar_split(), perm_fn=inp["resnet_perms"].__getitem__).ds
    gather = make_device_gather(B * mesh.size, ds.steps_per_epoch,
                                num_slots=ds.num_slots,
                                dequant_impl="pallas", mesh=mesh)
    with mock.patch.object(BatchNorm, "forward", _batch_norm_f64):
        for step in range(STEPS):
            batch = gather(step, next(ds))
            logits = model(batch["image"].double(), train=True)
            loss = torch.nn.functional.cross_entropy(
                logits, batch["label"].long())
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                for (name, p), g in zip(params.items(), grads):
                    moms[name].mul_(MU).add_(g)
                    p.sub_(LR * moms[name])
                    if (step + 1) % PERIOD == 0:
                        p.copy_(mesh.all_reduce(p.clone(), counted=False)
                                / mesh.size)
    emb = convert.embedding_modules(model)
    host = lambda d: {n: t.detach().numpy().copy() for n, t in d.items()}
    return {"params": convert.port_to_flax(host(params), emb),
            "momentum": convert.port_to_flax(host(moms), emb),
            "stats": convert.port_to_batch_stats(host(dict(
                model.named_buffers())))}


def _write_tiny_cifar(data_dir) -> None:
    """Five 32-row train batches and a 64-row test batch of random bytes
    in the CIFAR-10 pickle layout."""
    import pickle
    for i, num in enumerate([32] * 5 + [64], start=1):
        rs = np.random.RandomState(i)
        name = f"data_batch_{i}" if i <= 5 else "test_batch"
        with open(f"{data_dir}/{name}", "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (num, 3072))
                         .astype(np.uint8),
                         b"labels": rs.randint(0, 10, num).tolist()}, f)


def _resnet_resume(mesh, dirs) -> dict:
    """Config 4 in async mode through the trainer, period 3: 6 steps, and
    3 then a resume to 6 (the averaging at step 6 falls in the resumed
    half); each worker's final checkpoint part."""
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_mirrored_cifar)
    out = {}
    for name, stops in (("straight", (6,)), ("resumed", (3, 6))):
        for steps in stops:
            summary = trainer_mirrored_cifar.main([
                "--device", "cpu", "--dataset", "cifar10", "--data_dir",
                dirs["cifar"], "--sync_mode", "async", "--async_period",
                "3", "--batch_size", str(B), "--checkpoint_every", "3",
                "--log_every", "3", "--train_steps", str(steps),
                "--log_dir", dirs[f"resnet_{name}"]])
        out[name] = {"summary": summary, "part": _numpy(torch.load(
            f"{dirs[f'resnet_{name}']}/checkpoints/6/rank-{mesh.rank}.pt",
            weights_only=True))}
    return out


def _rank_checks(inp, dirs) -> dict:
    mesh = make_mesh("cpu")
    out = {"rank": mesh.rank, "tapes": _tapes(mesh, inp),
           "period_one": _period_one(mesh),
           "bucketed_average": _bucketed_average(mesh),
           "small": _resnet_tapes(mesh, inp, "small"),
           "small_f64": _float64_small(mesh, inp),
           "resnet20": _resnet_tapes(mesh, inp, "resnet20")}
    if mesh.size == 2:
        out["resume"] = _resume_across_an_averaging(mesh, dirs)
        out["resnet_resume"] = _resnet_resume(mesh, dirs)
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


def _jax_resnet_workers(n, **model):
    """The JAX ResNet (float32; ``model``: its widths, ``SMALL`` for the
    cut-down one, none for ResNet-20) tiled over n workers by
    ``make_worker_state``: the state, and its params, momentum,
    batch_stats and dropout key as numpy trees."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributedtensorflowexample_tpu.models.resnet import (
        ResNetCIFAR as JaxResNetCIFAR)
    from distributedtensorflowexample_tpu.parallel.async_ps import (
        make_worker_state)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh, replicated_sharding)
    from distributedtensorflowexample_tpu.training.state import (
        TrainState as JaxTrainState)
    mesh = jax_make_mesh(n)
    state = JaxTrainState.create(JaxResNetCIFAR(**model,
                                                dtype=jnp.float32),
                                 optax.sgd(LR, momentum=MU),
                                 jnp.zeros((B, 32, 32, 3)), seed=0)
    state = make_worker_state(jax.device_put(state,
                                             replicated_sharding(mesh)),
                              n, mesh)
    host = lambda t: jax.tree.map(lambda a: np.array(a, copy=True), t)
    return state, (host(state.params), host(state.opt_state[0].trace),
                   host(state.batch_stats), np.array(state.rng, copy=True))


def _jax_resnet_tape(n, state):
    """STEPS steps of the JAX async shard_map step on ``state``'s ResNet
    at period PERIOD: the tape, the params, momentum and batch_stats, and
    the consolidated params and batch_stats."""
    import jax
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    from distributedtensorflowexample_tpu.parallel.async_ps import (
        consolidate, make_indexed_async_train_step as jax_async_step)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)
    mesh = jax_make_mesh(n)
    jds = JaxDeviceDataset(*_cifar_split(), B * n, mesh=mesh, seed=0,
                           dequant_impl="pallas")
    step = jax_async_step(n, PERIOD, B * n, jds.steps_per_epoch,
                          ce_impl="pallas", mesh=mesh,
                          num_slots=jds.num_slots, dequant_impl="pallas")
    host = lambda t: jax.tree.map(lambda a: np.array(a, copy=True), t)
    tape = []
    with mesh:
        for _ in range(STEPS):
            state, m = step(state, next(jds))
            tape.append(float(m["loss"]))
        avg = consolidate(state)
    return {"tape": tape, "params": host(state.params),
            "momentum": host(state.opt_state[0].trace),
            "stats": host(state.batch_stats),
            "average": (host(avg.params), host(avg.batch_stats))}


def _jax_resnet_tape_f64(n, host0, rng, **model):
    """:func:`_jax_resnet_tape` in float64: the same steps of the JAX
    async shard_map step under ``jax.enable_x64``, on the JAX ResNet at
    float64 from ``host0`` (the float32 workers' params, momentum and
    batch_stats, cast), with the plain cross-entropy (the Pallas one is
    float32).  The batches are drawn first, outside x64 (the JAX
    dataset's ring update mixes index widths under it).  The JAX step
    itself still casts the logits, and the workers' sums, to float32."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    from distributedtensorflowexample_tpu.models.resnet import (
        ResNetCIFAR as JaxResNetCIFAR)
    from distributedtensorflowexample_tpu.parallel.async_ps import (
        consolidate, make_indexed_async_train_step as jax_async_step)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        DATA_AXIS, make_mesh as jax_make_mesh)
    from distributedtensorflowexample_tpu.training.state import (
        TrainState as JaxTrainState)
    mesh = jax_make_mesh(n)
    jds = JaxDeviceDataset(*_cifar_split(), B * n, mesh=mesh, seed=0,
                           dequant_impl="pallas")
    batches = [next(jds) for _ in range(STEPS)]
    tiled = jax.sharding.NamedSharding(mesh,
                                       jax.sharding.PartitionSpec(DATA_AXIS))
    host = lambda t: jax.tree.map(lambda a: np.array(a, copy=True), t)
    with jax.enable_x64(True):
        put = lambda t: jax.device_put(jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64), t), tiled)
        params, trace, stats = (put(t) for t in host0)
        tx = optax.sgd(LR, momentum=MU)
        state = JaxTrainState(
            step=jnp.asarray(0, jnp.int32), params=params,
            opt_state=(optax.TraceState(trace=trace), optax.EmptyState()),
            batch_stats=stats, rng=jnp.asarray(rng), tx=tx,
            apply_fn=JaxResNetCIFAR(**model, dtype=jnp.float64).apply)
        step = jax_async_step(n, PERIOD, B * n, jds.steps_per_epoch,
                              ce_impl="xla", mesh=mesh,
                              num_slots=jds.num_slots, dequant_impl="pallas")
        tape = []
        with mesh:
            for batch in batches:
                state, m = step(state, batch)
                tape.append(float(m["loss"]))
            avg = consolidate(state)
        assert jax.tree.leaves(state.params)[0].dtype == jnp.float64
        return {"tape": tape, "params": host(state.params),
                "momentum": host(state.opt_state[0].trace),
                "stats": host(state.batch_stats),
                "average": (host(avg.params), host(avg.batch_stats))}


def _jax_resnet_perms(n):
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)
    jds = JaxDeviceDataset(*_cifar_split(), B * n, mesh=jax_make_mesh(n),
                           seed=0, dequant_impl="pallas")
    return [np.asarray(jds._make_perm(jnp.asarray(e, jnp.int32)))
            for e in range(4)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    sizes = (2, 4)
    inputs, resnet_states, resnet64 = {}, {}, {}
    for n in sizes:
        params0, momentum0 = _jax_workers(n)
        resnet_states[n], (rp, rm, rs, rng) = _jax_resnet_workers(n, **SMALL)
        resnet64[n] = ((rp, rm, rs), rng)
        inputs[n] = {"params0": params0, "momentum0": momentum0,
                     "perms": _jax_perms(n), "resnet_params0": rp,
                     "resnet_momentum0": rm, "resnet_stats0": rs,
                     "resnet_perms": _jax_resnet_perms(n)}
    dirs = {k: str(tmp_path_factory.mktemp(f"async_{k}"))
            for k in ("straight", "resumed", "resnet_straight",
                      "resnet_resumed", "cifar")}
    _write_tiny_cifar(dirs["cifar"])
    with ThreadPoolExecutor(len(sizes)) as pool:
        groups = {n: pool.submit(launch.spawn, _rank_checks, n, "gloo",
                                 (inputs[n], dirs), 300) for n in sizes}
        jax_side = {n: _jax_tapes(n, inputs[n]["params0"],
                                  inputs[n]["momentum0"]) for n in sizes}
        jax_resnet = {n: _jax_resnet_tape(n, resnet_states[n])
                      for n in sizes}
        jax_resnet64 = {n: _jax_resnet_tape_f64(n, *resnet64[n], **SMALL)
                        for n in sizes}
        ranks = {n: g.result() for n, g in groups.items()}
    return {"inputs": inputs, "ranks": ranks, "jax": jax_side,
            "jax_resnet": jax_resnet, "jax_resnet64": jax_resnet64}


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


@pytest.mark.parametrize("n", [2, 4])
def test_bucketed_average_is_b_all_reduces_of_the_same_sums(runs, n):
    """``--bucket_grads`` in async mode: each averaging goes out as one
    all-reduce per bucket (JAX ``bucketed_tree_psum``), of the same sums:
    bitwise the one-buffer average at 2 ranks, within 1e-6 at 4 (gloo's
    ring orders a sum by its chunk, which the buckets move)."""
    for r in runs["ranks"][n]:
        got = r["bucketed_average"]
        b = got["buckets"]
        assert b >= 3
        assert got["one"]["all_reduces"] == 2
        assert got["bucketed"]["all_reduces"] == 2 * b
        if n == 2:
            np.testing.assert_array_equal(got["bucketed"]["params"],
                                          got["one"]["params"])
        else:
            np.testing.assert_allclose(got["bucketed"]["params"],
                                       got["one"]["params"], rtol=1e-6,
                                       atol=1e-7)


# --- async with batch norm ----------------------------------------------

def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(),
                                                        1e-30))


def _against_jax(mine: dict, want: dict, want64: dict, w: int | None,
                 what: str) -> None:
    """Each leaf of ``mine`` (the port in float32) within 1e-5 of its
    largest value of ``want`` (the JAX step in float32), or no further
    from ``want64`` (the same JAX step in float64) than ``want`` is: where
    the two float32 sides part, the JAX package's float64 step decides.
    ``w`` picks a worker of the tiled trees."""
    got, exact = dict(_leaves(mine)), dict(_leaves(want64))
    for path, v in _leaves(want):
        ref, f64 = (v, exact[path]) if w is None else (v[w], exact[path][w])
        gap = _gap(got[path], ref)
        assert gap <= 1e-5 or _gap(got[path], f64) <= _gap(ref, f64), \
            (what, path, w, gap, _gap(got[path], f64), _gap(ref, f64))


def _tracks_jax_float64(mine: dict, want64: dict, w: int, what: str) -> None:
    """The port's float64 loop against the JAX step in float64: each leaf
    within 2e-6 of its largest value (the JAX step rounds its logits and
    the workers' sums to float32)."""
    got = dict(_leaves(mine))
    for path, v in _leaves(want64):
        assert _gap(got[path], v[w]) <= 2e-6, (what, path, w,
                                              _gap(got[path], v[w]))


@pytest.mark.parametrize("n", [2, 4])
def test_async_batch_norm_tracks_the_jax_workers(runs, n):
    """Each worker's parameters, momentum and batch-norm statistics after
    two averagings and a step, against the JAX shard_map step's tiled
    state, with the JAX step in float64 as the arbiter; the port's
    float64 loop against the JAX float64 step; the averaging is the only
    all-reduce (batch norm over the worker's own rows adds none)."""
    want, want64 = runs["jax_resnet"][n], runs["jax_resnet64"][n]
    ranks = runs["ranks"][n]
    tape = ranks[0]["small"]["tape"]
    assert all(r["small"]["tape"] == tape for r in ranks)
    np.testing.assert_allclose(tape, want["tape"], rtol=1e-5)
    for w, r in enumerate(ranks):
        got = r["small"]
        assert got["all_reduces"] == STEPS // PERIOD
        for key in ("params", "momentum", "stats"):
            _against_jax(got[key], want[key], want64[key], w, key)
            _tracks_jax_float64(r["small_f64"][key], want64[key], w, key)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("model", ["small", "resnet20"])
def test_async_batch_norm_workers_keep_their_own_statistics(runs, n, model):
    """The parameters agree bitwise at each averaging (steps 2 and 4) and
    differ between; the statistics, never averaged, differ throughout;
    the averaging is the only all-reduce."""
    digests = [r[model]["digests"] for r in runs["ranks"][n]]
    for s in range(STEPS):
        params = {d[s][0] for d in digests}
        stats = {d[s][1] for d in digests}
        assert len(params) == (1 if (s + 1) % PERIOD == 0 else n), s
        assert len(stats) == n, s
    for r in runs["ranks"][n]:
        assert r[model]["all_reduces"] == STEPS // PERIOD
        assert np.all(np.isfinite(r[model]["tape"]))


@pytest.mark.parametrize("n", [2, 4])
def test_async_batch_norm_eval_runs_on_the_average(runs, n):
    """``consolidated``: the parameters and the statistics averaged over
    the workers (JAX ``consolidate``, with its float64 step as the
    arbiter), and each worker's own back bit for bit after (ResNet-20
    too)."""
    want = runs["jax_resnet"][n]["average"]
    want64 = runs["jax_resnet64"][n]["average"]
    for r in runs["ranks"][n]:
        for k, got in enumerate(r["small"]["average"]):
            _against_jax(got, want[k], want64[k], None,
                         ("params", "stats")[k])
        assert r["small"]["after_average"] and r["resnet20"]["after_average"]
    # ResNet-20's average is the workers' mean, by the port's own values
    ranks = runs["ranks"][n]
    for path, v in _leaves(ranks[0]["resnet20"]["average"][1]):
        mean = np.mean([dict(_leaves(r["resnet20"]["stats"]))[path]
                        for r in ranks], axis=0)
        np.testing.assert_allclose(v, mean, rtol=1e-6, atol=1e-7,
                                   err_msg=path)


def test_async_resnet20_resume_across_an_averaging_is_bitwise(runs):
    parts = []
    for rank in runs["ranks"][2]:
        straight, resumed = (rank["resnet_resume"][k]
                             for k in ("straight", "resumed"))
        assert resumed["summary"]["start_step"] == 3
        assert straight["summary"]["final_accuracy"] == \
            resumed["summary"]["final_accuracy"]
        a, b = straight["part"], resumed["part"]
        assert a["step"] == b["step"] == 6
        for key in ("params", "momentum"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a["buffers"].keys() == b["buffers"].keys()
        for name in a["buffers"]:
            np.testing.assert_array_equal(a["buffers"][name],
                                          b["buffers"][name], err_msg=name)
        parts.append(a)
    # 6 is a multiple of the period: the parameters end equal, the
    # statistics stay each worker's own
    np.testing.assert_array_equal(parts[0]["params"], parts[1]["params"])
    assert any(not np.array_equal(parts[0]["buffers"][k],
                                  parts[1]["buffers"][k])
               for k in parts[0]["buffers"])
