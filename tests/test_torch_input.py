"""The input-side slice on the CPU, held against the JAX package on the
same numpy-seeded inputs: the native host loader (``native/``), the
host-fed path of ``--device_data off`` (``data/pipeline.py`` and the
host-fed steps of ``parallel/sync.py``), the LUT-family dequants
(``--dequant_impl onehot`` and ``lut``), ``--data_sharding sharded``,
and ResNet-20's ``--remat block``.

Tolerances: the native loader, the Batcher's tape and batches, the
dequant resolution and values, the sharded positions and rows, and remat
against no remat: bitwise (or equal).  The host-fed config 3 steps
against the JAX host-fed step (float32, plain cross-entropy and momentum
SGD, 3 steps from the converted JAX init): the loss tape and the
parameters within rtol 1e-5, atol 1e-6 (the replication modes' bound,
``tests/test_torch_modes.py``: the matrix products sum in other orders).

The sharded split on two gloo ranks against the JAX sharded step, and
its trainer surface, run in ``tests/test_torch_multirank.py``'s 2-rank
group (one group for both files' checks), and the refusals' words
beside the hook stack in ``tests/test_torch_telemetry.py`` (which pays
the JAX Engine's import for both).
"""

import functools
import os
import struct

import numpy as np
import pytest
import torch

from distributedtensorflowexample_tpu_torch import convert, native
from distributedtensorflowexample_tpu_torch.config import parse_flags
from distributedtensorflowexample_tpu_torch.data import cifar10, mnist
from distributedtensorflowexample_tpu_torch.data.cifar10 import load_cifar10
from distributedtensorflowexample_tpu_torch.data.dequant import U8_UNIT_SCALE
from distributedtensorflowexample_tpu_torch.data.device_dataset import (
    DEQUANT_IMPLS, DeviceDataset, dequantize_images, resolve_dequant_impl)
from distributedtensorflowexample_tpu_torch.data.pipeline import (
    Batcher, DevicePrefetcher)
from distributedtensorflowexample_tpu_torch.data.synthetic import (
    make_synthetic)
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
from distributedtensorflowexample_tpu_torch.native import loader
from distributedtensorflowexample_tpu_torch.parallel.mesh import Mesh
from distributedtensorflowexample_tpu_torch.parallel.sync import (
    dequant_host_batch, make_device_gather, make_resident_eval)
from distributedtensorflowexample_tpu_torch.trainers import (
    trainer_ps_mnist, trainer_sync_mnist)

CPU = torch.device("cpu")
B, ROWS, STEPS, LR, MU = 8, 256, 3, 0.05, 0.9
SPECS = (None, "unit", "cifar")
QUANTIZE = ("auto", "off", "exact", "scale")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _split():
    return make_synthetic(ROWS, (28, 28, 1), 10, seed=0, sample_seed=1)


def _flags(*extra) -> list:
    return ["--device", "cpu", "--dtype", "float32", "--dropout", "0",
            "--learning_rate", str(LR), "--momentum", str(MU),
            "--batch_size", str(B), *extra]


def _bitwise(a, b) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def _close(got, want) -> str | None:
    try:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    except AssertionError as err:
        return str(err)[:300]
    return None


# --- the JAX side -----------------------------------------------------------

def _jax_params0() -> dict:
    import jax
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.models import (
        build_model as jax_build_model)
    model = jax_build_model("mnist_cnn", dropout=0.0, dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((2, 28, 28, 1)))["params"]
    return jax.tree.map(lambda a: np.array(a, copy=True), params)


def _jax_state(params):
    import jax
    import jax.numpy as jnp
    import optax

    from distributedtensorflowexample_tpu.models import (
        build_model as jax_build_model)
    from distributedtensorflowexample_tpu.training.state import (
        TrainState as JaxTrainState)
    tx = optax.sgd(LR, momentum=MU)
    params = jax.tree.map(jnp.asarray, params)
    return JaxTrainState(
        step=jnp.asarray(0, jnp.int32), params=params,
        opt_state=tx.init(params), batch_stats={},
        rng=jax.random.PRNGKey(1), tx=tx,
        apply_fn=jax_build_model("mnist_cnn", dropout=0.0,
                                 dtype=jnp.float32).apply)


def _jax_sharded_dataset(shards: int, batch: int):
    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)
    mesh = jax_make_mesh(shards)
    return mesh, JaxDeviceDataset(*_split(), batch, mesh=mesh, seed=0,
                                  data_sharding="sharded")


def _jax_perms(jds, epochs: int = 2) -> list:
    import jax.numpy as jnp
    return [np.asarray(jds._make_perm(jnp.asarray(e, jnp.int32)))
            for e in range(epochs)]


def _write_idx(data_dir, split, images, labels):
    names = {"train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
             "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}
    img, lbl = names[split]
    u8 = np.round(images[..., 0] * 255).astype(np.uint8)
    (data_dir / img).write_bytes(struct.pack(">IIII", 2051, *u8.shape)
                                 + u8.tobytes())
    (data_dir / lbl).write_bytes(struct.pack(">II", 2049, len(labels))
                                 + labels.astype(np.uint8).tobytes())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The converted JAX init and a small IDX split, once."""
    data_dir = tmp_path_factory.mktemp("mnist")
    for split, (num, seed) in {"train": (256, 1), "test": (64, 2)}.items():
        _write_idx(data_dir, split, *make_synthetic(
            num, (28, 28, 1), 10, seed=0, sample_seed=seed))
    return {"params0": _jax_params0(), "data_dir": data_dir}


# --- the native loader ------------------------------------------------------

def test_native_builds_into_build_native_by_digest():
    from distributedtensorflowexample_tpu import native as jax_native
    assert native.available() and jax_native.available()
    so = loader._so_path()
    assert os.path.dirname(so) == loader.BUILD_DIR
    assert os.path.basename(so).startswith("dataio-")
    assert os.path.exists(so)


def test_native_matches_the_jax_loader_and_numpy():
    """Parsing, gathers and the crop and flip: the port's library, the JAX
    package's and numpy's routes, bit for bit."""
    from distributedtensorflowexample_tpu import native as jax_native
    rng = np.random.RandomState(0)
    pixels = rng.randint(0, 256, size=(5, 28, 28), dtype=np.uint8)
    idx_images = struct.pack(">IIII", 2051, 5, 28, 28) + pixels.tobytes()
    idx_labels = struct.pack(">II", 2049, 5) + bytes(range(5))
    cifar_raw = rng.randint(0, 256, size=3 * 3073, dtype=np.uint8).tobytes()
    f32 = rng.rand(16, 32, 32, 3).astype(np.float32)
    u8 = rng.randint(0, 256, size=(16, 32, 32, 3), dtype=np.uint8)
    labels = rng.randint(0, 10, size=16).astype(np.int32)
    idx = rng.randint(0, 16, size=12)
    draws = cifar10._draw(rng, 12)
    ref = jax_native
    pairs = [
        (native.parse_idx_images(idx_images),
         ref.parse_idx_images(idx_images)),
        (native.parse_idx_labels(idx_labels),
         ref.parse_idx_labels(idx_labels)),
        *zip(native.parse_cifar(cifar_raw), ref.parse_cifar(cifar_raw)),
        (native.gather(f32, idx), ref.gather(f32, idx)),
        (native.gather(u8, idx), ref.gather(u8, idx)),
        (native.gather(labels, idx), ref.gather(labels, idx)),
        (native.gather_augment(f32, idx, *draws),
         ref.gather_augment(f32, idx, *draws)),
        (native.gather_augment(u8, idx, *draws),
         ref.gather_augment(u8, idx, *draws)),
        (native.augment_crop_flip(u8[idx], *draws),
         ref.augment_crop_flip(u8[idx], *draws))]
    assert all(_bitwise(a, b) for a, b in pairs)
    assert _bitwise(native.gather(u8, idx), u8[idx])
    assert _bitwise(native.gather_augment(u8, idx, *draws),
                    cifar10._augment_numpy(u8[idx], *draws))
    assert _bitwise(native.parse_idx_images(idx_images),
                    pixels[..., None].astype(np.float32) * U8_UNIT_SCALE)


def test_mnist_files_parse_alike_native_or_numpy(tmp_path, monkeypatch):
    x, y = make_synthetic(32, (28, 28, 1), 10, seed=0, sample_seed=1)
    _write_idx(tmp_path, "train", x, y)
    fast = mnist.load_mnist(str(tmp_path), "train")
    monkeypatch.setattr(native, "available", lambda: False)
    slow = mnist.load_mnist(str(tmp_path), "train")
    assert all(_bitwise(a, b) for a, b in zip(fast, slow))
    assert _bitwise(fast[0], x) and _bitwise(fast[1], y)


# --- the Batcher and the prefetcher -----------------------------------------

@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("processes", [1, 2])
def test_batcher_tape_is_the_jax_batchers(processes, augment):
    """Six global batches of 16 over 64 rows (across an epoch), each
    process's rows: the same index order, bytes and labels as the JAX
    Batcher, uint8 with the same dequant spec."""
    from distributedtensorflowexample_tpu.data import cifar10 as jax_cifar10
    from distributedtensorflowexample_tpu.data.pipeline import (
        Batcher as JaxBatcher)
    if augment:
        x, y = load_cifar10("", "train", synthetic_size=64,
                            source="synthetic")
    else:
        x, y = make_synthetic(64, (28, 28, 1), 10, seed=0, sample_seed=1)
    for p in range(processes):
        kw = dict(seed=3, process_index=p, process_count=processes)
        ours = Batcher(x, y, 16, augment_fn=cifar10.augment if augment
                       else None, **kw)
        ref = JaxBatcher(x, y, 16, augment_fn=jax_cifar10.augment
                         if augment else None, **kw)
        assert ours.dequant == ref.dequant == ("cifar" if augment
                                               else "unit")
        for _ in range(6):
            a, b = next(ours), next(ref)
            assert a["image"].dtype == np.uint8
            assert _bitwise(a["image"], b["image"])
            assert _bitwise(a["label"], b["label"])


def test_prefetcher_on_the_cpu_uploads_each_batch():
    x, y = _split()
    batches = [next(Batcher(x, y, 16, seed=1)) for _ in range(1)]
    feed = DevicePrefetcher(Batcher(x, y, 16, seed=1), CPU, depth=3)
    got = next(feed)
    assert _bitwise(got["image"].numpy(), batches[0]["image"])
    assert _bitwise(got["label"].numpy(), batches[0]["label"])
    assert feed.bytes_per_batch == 16 * 784 + 16 * 4


def test_resumed_host_fed_tape_restarts_as_in_jax():
    """The JAX Engine builds its Batcher afresh from --seed (no cursor),
    so a host-fed run resumed at step 5 reads the tape from its start;
    the port does the same."""
    from distributedtensorflowexample_tpu.data.pipeline import (
        Batcher as JaxBatcher)
    engine = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(_flags(
        "--device_data", "off"))))
    state, _ = engine.laid_out_state(Mesh(CPU))
    state.step = 5
    built = engine.build_host_fed(Mesh(CPU), data=_split(), state=state)
    ref = JaxBatcher(*_split(), B, seed=0)
    for _ in range(3):
        got, want = next(built.ds), next(ref)
        assert _bitwise(got["image"].numpy(), want["image"])


# --- the dequant rule and the LUT family ------------------------------------

def test_resolve_dequant_impl_equals_jax_over_the_grid(monkeypatch):
    """The rule over spec x impl x quantize, given the same verdict on
    the backend's affine.  That verdict is the one place the two differ:
    the port's affine rounds once on every device (float64, then one
    cast), while XLA:CPU rounds the JAX affine twice on the "cifar" spec,
    where the JAX rule falls back to ``onehot`` on the CPU."""
    from distributedtensorflowexample_tpu.data import (
        device_dataset as jax_dd)
    from distributedtensorflowexample_tpu_torch.data.device_dataset import (
        dequant_affine_is_bitwise)
    assert dequant_affine_is_bitwise("unit") and \
        dequant_affine_is_bitwise("cifar")
    monkeypatch.setattr(jax_dd, "dequant_affine_is_bitwise",
                        lambda spec: dequant_affine_is_bitwise(spec))
    for spec in SPECS:
        for impl in DEQUANT_IMPLS:
            for quantize in QUANTIZE:
                assert resolve_dequant_impl(spec, impl, quantize) == \
                    jax_dd.resolve_dequant_impl(spec, impl, quantize), (
                        spec, impl, quantize)


def test_a_spec_affine_cannot_hold_resolves_as_in_jax(monkeypatch):
    """A spec whose table the affine misses: ``onehot``, or ``affine``
    under ``quantize="scale"`` (speed over bits)."""
    from distributedtensorflowexample_tpu.data import (
        device_dataset as jax_dd)
    from distributedtensorflowexample_tpu_torch.data import (
        device_dataset as dd)
    monkeypatch.setattr(dd, "affine_matches_lut", lambda spec: False)
    monkeypatch.setattr(jax_dd, "affine_matches_lut", lambda spec: False)
    for quantize in QUANTIZE:
        assert resolve_dequant_impl("unit", "auto", quantize) == \
            jax_dd.resolve_dequant_impl("unit", "auto", quantize)
    assert resolve_dequant_impl("unit", "auto", "scale") == "affine"
    assert resolve_dequant_impl("unit", "auto", "auto") == "onehot"


@functools.lru_cache
def _jax_table(spec: str) -> tuple:
    """Bytes covering every value, and the JAX package's table values for
    them (its ``lut`` and ``onehot`` forms, which agree)."""
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.data.device_dataset import (
        dequantize_images as jax_dequantize)
    shape = (4, 8, 8, 1) if spec == "unit" else (4, 8, 8, 3)
    u8 = np.random.RandomState(0).randint(0, 256, size=shape,
                                          dtype=np.uint8)
    u8.reshape(-1)[:256] = np.arange(256)        # every byte value
    want = np.asarray(jax_dequantize(jnp.asarray(u8), spec, "lut"))
    assert _bitwise(np.asarray(jax_dequantize(jnp.asarray(u8), spec,
                                              "onehot")), want)
    return u8, want


@pytest.mark.parametrize("impl", ["affine", "onehot", "lut"])
@pytest.mark.parametrize("spec", ["unit", "cifar"])
def test_dequantize_images_is_bitwise_the_jax_table(spec, impl):
    """Every port impl gives the JAX package's table values, bit for
    bit, on every byte."""
    u8, want = _jax_table(spec)
    got = dequantize_images(torch.from_numpy(u8), spec, impl).numpy()
    assert _bitwise(got, want)


def test_dequant_host_batch_as_in_jax():
    """A uint8 batch with no spec raises TypeError; a float batch passes;
    ``pallas`` dequantizes by the affine (no gather to fuse)."""
    u8 = torch.randint(0, 256, (2, 28, 28, 1), dtype=torch.uint8)
    with pytest.raises(TypeError, match="dequant=batcher.dequant"):
        dequant_host_batch({"image": u8}, None)
    flt = {"image": torch.zeros(2, 3)}
    assert dequant_host_batch(flt, None) is flt
    pallas = dequant_host_batch({"image": u8}, "unit", "pallas")["image"]
    assert torch.equal(pallas, dequantize_images(u8, "unit", "affine"))


@pytest.mark.parametrize("impl", ["onehot", "lut"])
def test_lut_family_on_the_resident_path(impl):
    """The resident gather and eval under onehot and lut: bitwise the
    affine's batches and the same accuracy; a factory asking for the
    other family than the dataset's raises, as in JAX."""
    x, y = _split()
    model = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(
        _flags()))).build(Mesh(CPU), data=(x, y))
    batches = {}
    for which in ("affine", impl):
        ds = DeviceDataset(x, y, 16, dequant_impl=which)
        assert ds.dequant_impl == which
        gather = make_device_gather(16, ds.steps_per_epoch,
                                    num_slots=ds.num_slots,
                                    dequant_impl=which)
        batches[which] = gather(3, next(ds))["image"]
        ev = make_resident_eval(x[:40], y[:40], CPU, batch_size=16,
                                dequant_impl=which)
        batches[which + "_eval"] = ev(model.state)
    assert torch.equal(batches["affine"], batches[impl])
    assert batches["affine_eval"] == batches[impl + "_eval"]
    with pytest.raises(ValueError, match="LUT family"):
        make_device_gather(16, ds.steps_per_epoch, num_slots=ds.num_slots,
                           dequant_impl="affine")(3, next(ds))


# --- --data_sharding sharded ------------------------------------------------

@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_positions_and_rows_are_the_jax_gathers(shards):
    """Fed the JAX interleaved order, each rank holds its block only and
    gathers at every step the rows the JAX shard_map gather gives its
    device, bitwise; the positions a rank reads all lie in its block."""
    import jax
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.parallel.sync import (
        make_device_gather as jax_make_device_gather)
    batch = 2 * shards
    mesh, jds = _jax_sharded_dataset(shards, batch)
    perms = _jax_perms(jds)
    jgather = jax.jit(jax_make_device_gather(
        batch, jds.steps_per_epoch, mesh=mesh, num_slots=jds.num_slots,
        data_sharding="sharded"))
    jdata = next(jds)
    steps = (0, 5, jds.steps_per_epoch + 2)
    want = {s: jax.device_get(jgather(jnp.asarray(s, jnp.int32),
                                      jax.random.PRNGKey(0), jdata))
            for s in steps}
    rows = ROWS // shards
    for d in range(shards):
        m = Mesh(CPU, rank=d, size=shards)
        ds = DeviceDataset(*_split(), batch, data_sharding="sharded",
                           mesh=m, perm_fn=perms.__getitem__)
        assert ds.images.shape[0] == rows
        assert ds.steps_per_epoch == jds.steps_per_epoch
        gather = make_device_gather(batch, ds.steps_per_epoch,
                                    num_slots=ds.num_slots, mesh=m,
                                    data_sharding="sharded")
        data = next(ds)
        for s in steps:
            got = gather(s, data)
            lo = d * (batch // shards)
            block = slice(lo, lo + batch // shards)
            assert _bitwise(got["image"].numpy(), want[s]["image"][block])
            assert _bitwise(got["label"].numpy(), want[s]["label"][block])
        epoch0 = perms[0].reshape(-1, shards, batch // shards)[:, d]
        assert ((epoch0 >= d * rows) & (epoch0 < (d + 1) * rows)).all()


def test_own_sharded_order_keeps_each_rank_in_its_block():
    shards, batch = 4, 8
    orders = []
    for d in range(shards):
        ds = DeviceDataset(*_split(), batch, data_sharding="sharded",
                           mesh=Mesh(CPU, rank=d, size=shards), seed=5)
        orders.append(next(ds)["perm"][0].numpy())
    assert all(np.array_equal(o, orders[0]) for o in orders)
    per = orders[0].reshape(-1, shards, batch // shards)
    rows = ROWS // shards
    for d in range(shards):
        mine = per[:, d].reshape(-1)
        assert ((mine >= d * rows) & (mine < (d + 1) * rows)).all()
        assert len(set(mine.tolist())) == mine.size


def test_a_sharded_batch_that_does_not_divide_is_refused():
    with pytest.raises(ValueError, match="must divide across 3"):
        DeviceDataset(*_split(), 8, data_sharding="sharded",
                      mesh=Mesh(CPU, rank=0, size=3))


# --- host-fed and sharded steps against the JAX steps ------------------------

def test_host_fed_config3_tracks_the_jax_host_step(runs):
    """``Engine.build_host_fed`` (the Batcher's uploaded uint8 rows,
    dequantized in the step) against the JAX host-fed ``make_train_step``
    fed the JAX Batcher's batches, from the converted init."""
    import jax
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.data.pipeline import (
        Batcher as JaxBatcher)
    from distributedtensorflowexample_tpu.parallel.sync import (
        make_train_step as jax_make_train_step)
    params0 = runs["params0"]
    built = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(_flags(
        "--device_data", "off")))).build_host_fed(Mesh(CPU), data=_split())
    convert.load_into_state(built.state, params0)
    ref = JaxBatcher(*_split(), B, seed=0)
    jstep = jax_make_train_step(dequant=ref.dequant)
    jstate = _jax_state(params0)
    tape, jtape = [], []
    for _ in range(STEPS):
        tape.append(float(built.step(built.state, next(built.ds))[1]["loss"]))
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, next(ref)))
        jtape.append(float(m["loss"]))
    assert _close(tape, jtape) is None
    got = convert.state_to_flax(built.state)[0]
    want = jax.tree.map(np.asarray, jstate.params)
    for k0, leaves in want.items():
        for k1, w in leaves.items():
            assert _close(got[k0][k1], w) is None, (k0, k1)


@pytest.mark.parametrize("trainer,extra", [
    (trainer_sync_mnist, ["--dequant_impl", "lut"]),
    (trainer_ps_mnist, ["--async_period", "2"])])
def test_host_fed_trainers_run(runs, trainer, extra, capsys):
    """The host-fed branches of ``Engine.run``, sync and async: host
    uploads and a final accuracy."""
    argv = ["--device", "cpu", "--dataset", "mnist", "--data_dir",
            str(runs["data_dir"]), "--device_data", "off", "--train_steps",
            "6", "--batch_size", str(B), "--log_every", "3", "--log_dir", "",
            *extra]
    summary = trainer.main(argv)
    assert summary["input"] == "host" and summary["steps"] == 6
    assert summary["h2d_bytes_per_step"] == B * 784 + B * 4
    assert "final_accuracy=" in capsys.readouterr().out


# --- ResNet-20 --remat block -------------------------------------------------

def test_resnet20_remat_block_is_bitwise_no_remat():
    """3 float32 steps of config 4's update on ResNet-20 (crop and flip,
    weight decay): the loss, the parameters and every batch-norm buffer
    bitwise those of ``--remat none``, so each buffer is updated once a
    step."""
    x, y = load_cifar10("", "train", synthetic_size=32, source="synthetic")
    out = {}
    for remat in ("none", "block"):
        cfg = parse_flags(["--device", "cpu", "--dtype", "float32",
                           "--batch_size", "2", "--weight_decay", "1e-4",
                           "--remat", remat])
        built = Engine(RunSpec("resnet20", "cifar10", cfg,
                               augment=True)).build(Mesh(CPU), data=(x, y))
        assert built.state.model.remat == remat
        tape = [float(built.step(built.state, next(built.ds))[1]["loss"])
                for _ in range(STEPS)]
        out[remat] = (tape, built.state.optimizer.params_flat.clone(),
                      [b.clone() for b in built.state.model.buffers()])
    (tape, params, bufs), (rtape, rparams, rbufs) = out["none"], out["block"]
    assert tape == rtape
    assert torch.equal(params, rparams)
    assert all(torch.equal(a, b) for a, b in zip(bufs, rbufs))
