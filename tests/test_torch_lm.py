"""The transformer-LM slice of the port against the JAX package: data,
model, weight bridge, loss head, token gather, eval, a 5-step train tape
and the trainer CLI, on numpy-seeded inputs.

JAX side: the JAX package's own functions on the CPU, the Pallas
cross-entropy and SGD kernels in interpret mode (as its tests run them).
Port side: CPU tensors, so every kernel wrapper runs its plain version.
Shapes are lm_tiny's (2 blocks, d_model 64) at short sequences; lm_base
is only counted, never allocated (``meta`` tensors, ``jax.eval_shape``).

Tolerances: float32 within 1e-4 relative to the largest reference value
(summation order); bfloat16 logits within 3e-2 absolute; the loss head
within 1e-6; the bfloat16 5-step loss tape within 1e-2 relative.  The
reference forward is compiled without XLA's excess precision, which
equals flax's op-by-op definition (measured here: the port's bfloat16
logits are then bitwise the reference's).  With it, XLA:CPU keeps bf16
intermediates in float32 inside the jit and moves lm_tiny's logits by up
to 0.047 from its own eager forward; the jitted train step keeps it,
hence the looser tape tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflowexample_tpu.data.device_dataset import (
    DeviceDataset as JaxDeviceDataset)
from distributedtensorflowexample_tpu.data.lm import load_lm as jax_load_lm
from distributedtensorflowexample_tpu.models import (
    build_model as jax_build_model)
from distributedtensorflowexample_tpu.ops.pallas import fused_momentum_sgd
from distributedtensorflowexample_tpu.parallel.sync import (
    make_device_gather as jax_make_device_gather,
    make_indexed_train_step as jax_make_indexed_train_step,
    make_loss_rows as jax_make_loss_rows,
    make_resident_eval as jax_make_resident_eval)
from distributedtensorflowexample_tpu.training.state import (
    TrainState as JaxTrainState)
from distributedtensorflowexample_tpu_torch import convert, device
from distributedtensorflowexample_tpu_torch.config import parse_flags
from distributedtensorflowexample_tpu_torch.data.device_dataset import (
    DeviceDataset)
from distributedtensorflowexample_tpu_torch.data.lm import load_lm
from distributedtensorflowexample_tpu_torch.models import (
    LM_SIZES, LM_VOCAB, build_model)
from distributedtensorflowexample_tpu_torch.parallel.sync import (
    make_device_gather, make_indexed_train_step, make_loss_rows,
    make_resident_eval)
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
from distributedtensorflowexample_tpu_torch.training.optimizers import (
    build_optimizer)
from distributedtensorflowexample_tpu_torch.training.state import TrainState

SEQ = 32            # short sequences; the shipped split's T is 128
EMBEDDINGS = {"embed", "pos"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: one intra-op thread runs them as fast, and
    keeps this file's idle OpenMP threads from spinning on the cores the
    suite's other workers use."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_model(dtype=jnp.float32):
    """(flax lm_tiny, its jitted init, its jitted apply) per dtype, built
    once per process: eager flax runs compile every operation."""
    model = jax_build_model("lm_tiny", dtype=dtype)
    return model, jax.jit(model.init), jax.jit(model.apply)


def _jax_params(dtype=jnp.float32, seed=0):
    model, init, _ = _jax_model(dtype)
    params = init(jax.random.PRNGKey(seed),
                  jnp.zeros((2, SEQ), jnp.int32))["params"]
    return model, jax.tree.map(lambda a: np.array(a, copy=True), params)


def _jax_logits(dtype, params, tokens):
    variables, tokens = {"params": params}, jnp.asarray(tokens)
    compiled = _jax_model(dtype)[2].lower(variables, tokens).compile(
        {"xla_allow_excess_precision": False})
    return np.asarray(compiled(variables, tokens))


def _jax_state(model, params, tx):
    """The JAX TrainState around given params, without its eager init."""
    params = jax.tree.map(jnp.asarray, params)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         opt_state=tx.init(params), batch_stats={},
                         rng=jax.random.PRNGKey(1), tx=tx,
                         apply_fn=model.apply)


def _port_model(params, dtype=torch.float32, **kw):
    model = build_model("lm_tiny", dtype=dtype, **kw)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           convert.flax_to_port(params).items()})
    return model


def _tokens(b=4, t=SEQ, seed=1):
    return np.random.RandomState(seed).randint(0, LM_VOCAB, (b, t))


@pytest.mark.parametrize("split", ["train", "test"])
def test_load_lm_splits_are_bitwise_the_jax_packages(split):
    x, y = load_lm("", split)
    jx, jy = jax_load_lm("", split)
    assert x.dtype == jx.dtype == np.uint8 and y.dtype == jy.dtype == np.int32
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("size", sorted(LM_SIZES))
def test_param_tree_and_count_match_without_allocating(size):
    with torch.device("meta"):
        model = build_model(size)
    shapes = dict((n, tuple(p.shape)) for n, p in model.named_parameters())
    jmodel = jax_build_model(size)
    tree = jax.eval_shape(
        lambda r: jmodel.init(r, jnp.zeros((2, 8), jnp.int32)),
        jax.random.PRNGKey(0))["params"]
    want = {}
    for path, leaf in jax.tree.leaves_with_path(tree):
        keys = [p.key for p in path]
        name = ".".join(keys[:-1] + ["bias" if keys[-1] == "bias"
                                     else "weight"])
        want[name] = (tuple(reversed(leaf.shape)) if keys[-1] == "kernel"
                      else tuple(leaf.shape))
    assert shapes == want
    n = sum(int(np.prod(s)) for s in shapes.values())
    assert n == sum(int(np.prod(s)) for s in want.values())
    if size == "lm_base":
        assert n == 57_289_728


def test_bridge_round_trips_an_lm_tree_bitwise():
    _, params = _jax_params(seed=3)
    back = convert.port_to_flax(convert.flax_to_port(params), EMBEDDINGS)
    flat = dict(jax.tree.leaves_with_path(back))
    for path, want in jax.tree.leaves_with_path(params):
        np.testing.assert_array_equal(flat[path].view(np.int32),
                                      want.view(np.int32))
    assert len(flat) == len(jax.tree.leaves(params))
    cfg = parse_flags(["--fused_optimizer", "true", "--momentum", "0.9"])
    state = TrainState.create(build_model("lm_tiny"),
                              lambda m: build_optimizer(cfg, m), 0,
                              torch.device("cpu"))
    momentum = jax.tree.map(lambda a: a + 1.0, params)
    convert.load_into_state(state, params, momentum)
    got_p, got_m = convert.state_to_flax(state)
    for want_tree, got in ((params, got_p), (momentum, got_m)):
        flat = dict(jax.tree.leaves_with_path(got))
        for path, want in jax.tree.leaves_with_path(want_tree):
            np.testing.assert_array_equal(flat[path], want)
    trace = convert.tree_to_flat_trace(params)
    again = convert.flat_trace_to_tree(trace, params)
    assert sorted(again) == ["block0", "block1", "embed", "ln_f", "pos"]
    np.testing.assert_array_equal(again["block1"]["ln2"]["scale"],
                                  params["block1"]["ln2"]["scale"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_tiny_forward_matches_flax(dtype):
    _, params = _jax_params(getattr(jnp, dtype))
    tokens = _tokens().astype(np.uint8)
    want = _jax_logits(getattr(jnp, dtype), params, tokens)
    model = _port_model(params, getattr(torch, dtype))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, SEQ, LM_VOCAB)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)


def test_attention_divides_by_the_rounded_head_scale():
    with torch.device("meta"):
        assert build_model("lm_tiny").block0.scale == 5.65625    # Dh = 32
        assert build_model("lm_base").block0.scale == 8.0
        assert build_model("lm_tiny", dtype=torch.float32).block0.scale \
            == float(np.float32(32 ** 0.5))


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_block_is_bitwise_the_plain_backward(dropout):
    _, params = _jax_params(seed=2)
    tokens = torch.from_numpy(_tokens(seed=4).astype(np.uint8))
    labels = torch.from_numpy(_tokens(seed=5).astype(np.int32))
    loss_rows = make_loss_rows(ce_impl="pallas")
    out = []
    for remat in ("none", "block"):
        model = _port_model(params, torch.bfloat16, remat=remat,
                            dropout=dropout)
        gen = torch.Generator().manual_seed(7)
        loss = loss_rows(model(tokens, train=True, generator=gen),
                         labels).mean()
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in
                                    model.named_parameters()}))
    assert torch.equal(out[0][0], out[1][0])
    for name, grad in out[0][1].items():
        assert torch.equal(grad, out[1][1][name]), name
    assert torch.count_nonzero(out[0][1]["embed.weight"]) > 0


def test_out_of_vocab_ids_poison_every_logit():
    _, params = _jax_params()
    model = _port_model(params)
    good = _tokens(b=2, t=8)
    with torch.no_grad():
        assert torch.isfinite(model(torch.from_numpy(good))).all()
        for bad_id, dt in ((LM_VOCAB, np.uint8), (255, np.uint8),
                           (-1, np.int32)):
            bad = good.astype(dt)
            bad[1, 3] = bad_id
            got = model(torch.from_numpy(bad))
            assert torch.isnan(got).all(), bad_id
            assert np.isnan(_jax_logits(jnp.float32, params, bad)).all()


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_per_example_loss_head_and_gradient_match_jax(smoothing):
    rng = np.random.RandomState(6)
    logits = (3 * rng.randn(4, 16, LM_VOCAB)).astype(np.float32)
    labels = rng.randint(0, LM_VOCAB, (4, 16)).astype(np.int32)
    labels[2, 5] = -1
    jrows = jax_make_loss_rows(smoothing, ce_impl="pallas")
    want, want_g = jax.value_and_grad(
        lambda l: jnp.mean(jrows(l, jnp.asarray(labels))))(
            jnp.asarray(logits))
    want_rows = np.asarray(jrows(jnp.asarray(logits), jnp.asarray(labels)))
    x = torch.from_numpy(logits).requires_grad_()
    rows = make_loss_rows(smoothing, ce_impl="pallas")(
        x, torch.from_numpy(labels))
    assert rows.shape == (4,)
    rows.mean().backward()
    np.testing.assert_allclose(rows.detach().numpy(), want_rows, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-6)
    assert abs(float(rows.detach().mean()) - float(want)) <= 1e-6


def _jax_perm_fn(jds):
    return lambda epoch: np.asarray(
        jds._make_perm(jnp.asarray(epoch, jnp.int32)))


def test_token_gather_matches_jax_on_one_index_tape():
    x, y = load_lm("", "train", num=48, seq_len=SEQ)
    jds = JaxDeviceDataset(x, y, 8, seed=0, token_data=True,
                           dequant_impl="pallas")
    ds = DeviceDataset(x, y, 8, seed=0, token_data=True, dequant_impl="pallas",
                       perm_fn=_jax_perm_fn(jds))
    assert ds.images.dtype == torch.uint8 and ds.dequant_impl is None
    assert (ds.steps_per_epoch, ds.num_slots) == (jds.steps_per_epoch,
                                                  jds.num_slots)
    jgather = jax.jit(jax_make_device_gather(
        8, jds.steps_per_epoch, num_slots=jds.num_slots,
        dequant_impl="pallas"))
    gather = make_device_gather(8, ds.steps_per_epoch,
                                num_slots=ds.num_slots, dequant_impl="pallas",
                                token_data=True)
    jdata, data = jds.peek(), ds.peek()
    assert "dq_scale" not in data
    for step in (0, 2, ds.steps_per_epoch - 1, ds.steps_per_epoch + 1):
        want = jgather(jnp.asarray(step), None, jdata)
        got = gather(step, data)
        assert got["image"].dtype == torch.uint8
        np.testing.assert_array_equal(got["image"].numpy(),
                                      np.asarray(want["image"]))
        np.testing.assert_array_equal(got["label"].numpy(),
                                      np.asarray(want["label"]))


def test_token_storage_rules_match_jax():
    x, y = load_lm("", "train", num=16, seq_len=8)
    for quantize in ("auto", "off"):
        ds = DeviceDataset(x.astype(np.int64), y, 4, token_data=True,
                           quantize=quantize)
        jds = JaxDeviceDataset(x.astype(np.int64), y, 4, token_data=True,
                               quantize=quantize)
        assert str(ds.images.dtype).split(".")[-1] == str(jds.images.dtype)
    wide = x.astype(np.int32)
    wide[0, 0] = 300
    with pytest.raises(ValueError, match="exceed uint8"):
        DeviceDataset(wide, y, 4, token_data=True)
    assert DeviceDataset(wide, y, 4, token_data=True,
                         quantize="off").images.dtype == torch.int32
    with pytest.raises(ValueError, match="integer token split"):
        DeviceDataset(x.astype(np.float32), y, 4, token_data=True)


def test_per_token_eval_accuracy_equals_jax():
    jmodel, params = _jax_params(seed=5)
    x, y = load_lm("", "test", num=40, seq_len=SEQ)
    jeval = jax_make_resident_eval(x, y, batch_size=16, token_data=True)
    want = jeval(_jax_state(jmodel, params, fused_momentum_sgd(0.1, 0.9)))
    cfg = parse_flags(["--dtype", "float32"])
    state = TrainState.create(build_model("lm_tiny", dtype=torch.float32),
                              lambda m: build_optimizer(cfg, m), 0,
                              torch.device("cpu"))
    convert.load_into_state(state, params)
    got = make_resident_eval(x, y, torch.device("cpu"), batch_size=16,
                             token_data=True)(state)
    assert got == want and 0.0 < got < 1.0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_five_step_tape_matches_the_jax_package(dtype):
    steps, batch, lr, mu = 5, 8, 0.1, 0.9
    x, y = load_lm("", "train", num=64, seq_len=SEQ)
    jmodel, params0 = _jax_params(getattr(jnp, dtype), seed=0)
    jds = JaxDeviceDataset(x, y, batch, seed=0, token_data=True)
    jstate = _jax_state(jmodel, params0, fused_momentum_sgd(lr, mu))
    jstep = jax_make_indexed_train_step(batch, jds.steps_per_epoch,
                                        ce_impl="pallas",
                                        num_slots=jds.num_slots)
    jtape = []
    for _ in range(steps):
        jstate, m = jstep(jstate, next(jds))
        jtape.append(float(m["loss"]))

    cfg = parse_flags(["--fused_optimizer", "true", "--momentum", str(mu),
                       "--learning_rate", str(lr), "--dropout", "0",
                       "--pallas_ce", "true"])
    state = TrainState.create(
        build_model("lm_tiny", dtype=getattr(torch, dtype)),
        lambda m: build_optimizer(cfg, m), 0, torch.device("cpu"))
    convert.load_into_state(state, params0)
    ds = DeviceDataset(x, y, batch, seed=0, token_data=True,
                       perm_fn=_jax_perm_fn(
                           JaxDeviceDataset(x, y, batch, seed=0,
                                            token_data=True)))
    step = make_indexed_train_step(batch, ds.steps_per_epoch,
                                   ce_impl="pallas", num_slots=ds.num_slots,
                                   token_data=True)
    tape = []
    for _ in range(steps):
        state, m = step(state, next(ds))
        tape.append(float(m["loss"]))
    assert all(np.isfinite(tape)) and tape[-1] < tape[0]
    if dtype == "bfloat16":
        np.testing.assert_allclose(tape, jtape, rtol=1e-2)
        return
    np.testing.assert_allclose(tape, jtape, rtol=1e-4)
    params, momentum = convert.state_to_flax(state)
    jmom = convert.flat_trace_to_tree(np.asarray(jstate.opt_state.trace),
                                      params0)
    for got_tree, want_tree in ((params, jstate.params), (momentum, jmom)):
        got = dict(jax.tree.leaves_with_path(got_tree))
        for path, want in jax.tree.leaves_with_path(want_tree):
            want = np.asarray(want)
            np.testing.assert_allclose(got[path], want, rtol=0,
                                       atol=1e-4 * np.abs(want).max())


def _trainer(argv):
    from distributedtensorflowexample_tpu_torch.trainers import trainer_lm
    return trainer_lm.main(argv)


def test_trainer_lm_drives_on_the_cpu(tmp_path, capsys, monkeypatch):
    summary = _trainer([
        "--device", "cpu", "--size", "lm_tiny", "--train_steps", "20",
        "--log_every", "10", "--pallas_ce", "true",
        "--fused_optimizer", "true", "--log_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step 20: loss=" in out and "final_accuracy=" in out
    assert summary["steps"] == 20 and summary["eval_batches"] == 1
    tape = [l for _, l in summary["loss_tape"]]
    assert len(tape) == 2 and all(np.isfinite(tape)) and tape[-1] < tape[0]
    assert 0.0 < summary["final_accuracy"] < 1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device.DeviceUnavailable):
        _trainer(["--size", "lm_tiny", "--train_steps", "2"])


@pytest.mark.parametrize("flags,message", [
    (["--device_data", "off"], "--device_data off"),
    # bucketing is ported (one rank falls through to the plain step);
    # the fused apply is refused with it, as in JAX, and lm_base takes
    # --bucket_grads auto by default
    (["--bucket_grads", "auto", "--fused_optimizer", "true"],
     "--bucket_grads"),
    (["--size", "lm_base", "--fused_optimizer", "true"], "--bucket_grads"),
    (["--remat", "layer"], "remat"),
])
def test_trainer_lm_refuses_by_name(flags, message):
    with pytest.raises(ValueError, match=message) as err:
        _trainer(["--device", "cpu", "--train_steps", "2", "--log_dir", ""]
                 + flags)
    assert flags[0] == "--remat" or err.type is ModeRefusal


def test_image_gather_refuses_uint8_without_dequant_constants():
    """Only a gather built with ``token_data=True`` passes uint8 rows
    through; an image gather refuses them rather than train on raw
    bytes."""
    x, y = load_lm("", "train", num=16, seq_len=8)
    ds = DeviceDataset(x, y, 4, token_data=True)
    data = ds.peek()
    gather = make_device_gather(4, ds.steps_per_epoch, num_slots=ds.num_slots)
    with pytest.raises(TypeError, match="no dequant constants"):
        gather(0, data)
    got = make_device_gather(4, ds.steps_per_epoch, num_slots=ds.num_slots,
                             token_data=True)(0, data)
    assert got["image"].dtype == torch.uint8


@pytest.mark.parametrize("model", ["mnist_cnn", "lm_base"])
def test_profiled_config_is_the_trainers(model):
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_lm, trainer_sync_mnist)
    from distributedtensorflowexample_tpu_torch.utils import profiling
    spec, batches = profiling.workload(model, ["--steps_per_loop", "1"])
    if model == "lm_base":
        size, want = trainer_lm.build_config(
            ["--size", "lm_base", "--pallas_ce", "true",
             "--fused_optimizer", "true", "--bucket_grads", "",
             "--steps_per_loop", "1"])
        assert (spec.model, spec.dataset, batches) == (size, "lm", [16])
        assert (want.remat, want.learning_rate, want.bucket_grads) == (
            "block", 0.1, "")
    else:
        want = trainer_sync_mnist.build_config(
            profiling.KERNEL_FLAGS + ["--dataset", "synthetic",
                                      "--steps_per_loop", "1"])
        assert (spec.dataset, batches) == ("mnist", [64, 256])
    assert spec.config == want
    assert spec.config.pallas_ce and spec.config.fused_optimizer
