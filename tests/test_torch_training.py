"""The port's training modules held against the JAX package on the CPU:
schedules, the MnistCNN forward and gradients from converted params, the
weight bridge, the device resolution, the CLI and its refusals.

Tolerances:
- schedules: equal float32 values, step by step, for constant, step and
  linear warmup; the cosine within 2e-7 of the peak lr, about two float32
  ulps (XLA's float32 cos is not correctly rounded, so no host formula
  reproduces its bits);
- MnistCNN in float32 on both sides: logits 2e-5 and gradients 1e-4
  relative to each tensor's largest magnitude (the two libraries' CPU
  convolutions sum in different orders);
- MnistCNN in bfloat16 as shipped: logits within 4e-2 and gradients
  within 4e-2 relative to the largest magnitude (bf16 keeps 8 bits; the
  two frameworks round at different places in conv, bias add and dense);
- the converter: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributedtensorflowexample_tpu.config import parse_flags as jax_flags
from distributedtensorflowexample_tpu.models.mnist_cnn import (
    MnistCNN as JaxMnistCNN)
from distributedtensorflowexample_tpu.training.optimizers import (
    build_schedule as jax_build_schedule)
from distributedtensorflowexample_tpu_torch import convert, device
from distributedtensorflowexample_tpu_torch.config import parse_flags
from distributedtensorflowexample_tpu_torch.models.mnist_cnn import MnistCNN
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
from distributedtensorflowexample_tpu_torch.training.optimizers import (
    build_optimizer, build_schedule)
from distributedtensorflowexample_tpu_torch.training.state import TrainState


@pytest.mark.parametrize("flags", [
    ["--lr_schedule", "constant"],
    ["--lr_schedule", "cosine"],
    ["--lr_schedule", "step"],
    ["--lr_schedule", "cosine", "--warmup_steps", "7"],
    ["--lr_schedule", "step", "--warmup_steps", "5"],
    ["--lr_schedule", "constant", "--warmup_steps", "9"],
])
@pytest.mark.parametrize("train_steps", [40, 2000])
def test_schedule_equals_optax_per_step(flags, train_steps):
    argv = ["--train_steps", str(train_steps), "--learning_rate",
            "0.07"] + flags
    jsched = jax.jit(jax_build_schedule(jax_flags(argv)))
    psched = build_schedule(parse_flags(argv))
    counts = np.arange(train_steps + 5, dtype=np.int32)
    want = np.asarray(jax.vmap(jsched)(jnp.asarray(counts)))
    got = np.array([psched(int(c)) for c in counts], np.float32)
    if "cosine" in flags:
        # XLA's float32 cos is not correctly rounded; 1 + cos cancels
        # near the end of the decay, so compare against the peak lr.
        np.testing.assert_allclose(got, want, rtol=0, atol=0.07 * 2e-7)
    else:
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_config_keeps_the_jax_flags_and_defaults():
    import dataclasses
    from distributedtensorflowexample_tpu.config import RunConfig as JaxCfg
    from distributedtensorflowexample_tpu_torch.config import RunConfig
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxCfg)}
    port_fields = {f.name: f.default for f in dataclasses.fields(RunConfig)}
    assert port_fields.pop("device") == "cuda"
    assert port_fields == jax_fields


def _jax_params(dtype, seed=0):
    model = JaxMnistCNN(dropout_rate=0.0, dtype=dtype)
    x = jnp.zeros((2, 28, 28, 1), jnp.float32)
    params = model.init(jax.random.PRNGKey(seed), x)["params"]
    return model, jax.tree.map(lambda a: np.array(a, copy=True), params)


@pytest.mark.parametrize("dtype,tol", [("float32", (2e-5, 1e-4)),
                                       ("bfloat16", (4e-2, 4e-2))])
def test_mnist_cnn_forward_and_grads_match_flax(dtype, tol):
    jmodel, params = _jax_params(getattr(jnp, dtype))
    rng = np.random.RandomState(1)
    x = rng.rand(4, 28, 28, 1).astype(np.float32)
    w = rng.randn(4, 10).astype(np.float32)

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(logits * w), logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = MnistCNN(dropout_rate=0.0, dtype=getattr(torch, dtype))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           convert.flax_to_port(params).items()})
    logits = model(torch.from_numpy(x))
    (logits * torch.from_numpy(w)).sum().backward()
    assert logits.dtype == torch.float32 and logits.shape == (4, 10)
    rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()
    assert rel(logits.detach().numpy(), np.asarray(jlogits)) < tol[0]
    pgrads = convert.port_to_flax({n: p.grad.numpy() for n, p in
                                   model.named_parameters()})
    for path, want in jax.tree.leaves_with_path(jgrads):
        got = pgrads[path[0].key][path[1].key]
        assert rel(got, np.asarray(want)) < tol[1], path


def test_mnist_cnn_flattens_in_nhwc_order():
    # fc1's input feature k is (h, w, c) in row-major NHWC order, as in
    # flax: a one-hot on fc1's column k must light the same activation.
    model = MnistCNN(dropout_rate=0.0, dtype=torch.float32)
    captured = {}
    model.fc1.register_forward_hook(lambda *a: None)
    x = torch.rand(1, 28, 28, 1)
    orig = torch.nn.functional.linear

    def spy(inp, weight, bias=None):
        captured.setdefault("fc1_in", inp)
        return orig(inp, weight, bias)

    torch.nn.functional.linear = spy
    try:
        model(x)
    finally:
        torch.nn.functional.linear = orig
    with torch.no_grad():
        h = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                       model.conv1.weight, model.conv1.bias,
                                       padding=2)
        h = torch.nn.functional.max_pool2d(torch.relu(h), 2, 2)
        h = torch.nn.functional.conv2d(h, model.conv2.weight,
                                       model.conv2.bias, padding=2)
        h = torch.nn.functional.max_pool2d(torch.relu(h), 2, 2)
    nhwc = h.permute(0, 2, 3, 1).reshape(1, -1)
    assert torch.equal(captured["fc1_in"], nhwc)


def test_mnist_cnn_has_the_reference_parameter_count():
    model = MnistCNN()
    assert sum(p.numel() for p in model.parameters()) == 3_274_634
    _, params = _jax_params(jnp.bfloat16)
    assert sum(a.size for a in jax.tree.leaves(params)) == 3_274_634


def test_converter_round_trips_bitwise():
    _, params = _jax_params(jnp.float32, seed=3)
    back = convert.port_to_flax(convert.flax_to_port(params))
    for path, want in jax.tree.leaves_with_path(params):
        got = back[path[0].key][path[1].key]
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    trace = convert.tree_to_flat_trace(params)
    assert trace.shape == (convert.flat_trace_rows(3_274_634), 128)
    again = convert.flat_trace_to_tree(trace, params)
    for path, want in jax.tree.leaves_with_path(params):
        np.testing.assert_array_equal(again[path[0].key][path[1].key], want)


def test_converter_reads_the_fused_optimizer_flat_trace():
    from distributedtensorflowexample_tpu.ops.pallas import (
        fused_momentum_sgd)
    from distributedtensorflowexample_tpu.ops.pallas.sgd import (
        _flatten_leaves)
    _, params = _jax_params(jnp.float32, seed=4)
    state = fused_momentum_sgd(0.1, 0.9).init(params)
    leaves = jax.tree.leaves(params)
    flat = np.asarray(_flatten_leaves(leaves, state.trace.shape[0]))
    assert flat.shape == convert.tree_to_flat_trace(params).shape
    np.testing.assert_array_equal(flat, convert.tree_to_flat_trace(params))


def test_state_load_and_read_back():
    cfg = parse_flags(["--fused_optimizer", "true", "--momentum", "0.9"])
    state = TrainState.create(MnistCNN(), lambda m: build_optimizer(cfg, m),
                              0, torch.device("cpu"))
    _, params = _jax_params(jnp.float32, seed=5)
    mom = jax.tree.map(lambda a: a * np.float32(0.5), params)
    convert.load_into_state(state, params, mom)
    got_p, got_m = convert.state_to_flax(state)
    for path, want in jax.tree.leaves_with_path(params):
        k = (path[0].key, path[1].key)
        np.testing.assert_array_equal(got_p[k[0]][k[1]], want)
        np.testing.assert_array_equal(got_m[k[0]][k[1]],
                                      want * np.float32(0.5))
    # The model's parameters and grads are views into the flat buffers.
    opt = state.optimizer
    for p in state.model.parameters():
        assert p.untyped_storage().data_ptr() == \
            opt.params_flat.untyped_storage().data_ptr()
        assert p.grad.untyped_storage().data_ptr() == \
            opt.grads_flat.untyped_storage().data_ptr()


def test_plain_and_fused_optimizer_paths_agree_on_cpu():
    outs = []
    for fused in ("false", "true"):
        torch.manual_seed(0)
        cfg = parse_flags(["--fused_optimizer", fused, "--momentum", "0.9",
                           "--learning_rate", "0.05"])
        model = torch.nn.Linear(5, 3)
        opt = build_optimizer(cfg, model)
        for _ in range(3):
            opt.zero_grad()
            model(torch.ones(2, 5)).square().sum().backward()
            opt.step()
        outs.append(opt.params_flat.clone())
    assert opt.count == 3
    assert torch.equal(outs[0], outs[1])


def test_cuda_device_without_a_card_raises_by_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device.DeviceUnavailable, match="--device cuda"):
        device.resolve_device("cuda")
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_sync_mnist)
    with pytest.raises(device.DeviceUnavailable):
        trainer_sync_mnist.main(["--dataset", "synthetic"])
    assert device.resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.fixture()
def small_torch_mnist(monkeypatch):
    from distributedtensorflowexample_tpu_torch.data import mnist
    monkeypatch.setattr(mnist, "_SYNTH_SIZES", {"train": 2048, "test": 512})


def test_cli_converges_on_cpu(small_torch_mnist, tmp_path, capsys):
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_sync_mnist)
    log_dir = tmp_path / "logs"
    summary = trainer_sync_mnist.main([
        "--device", "cpu", "--dataset", "synthetic", "--train_steps", "60",
        "--batch_size", "32", "--log_every", "20", "--eval_every", "30",
        "--dequant_impl", "pallas", "--pallas_ce", "true",
        "--fused_optimizer", "true", "--log_dir", str(log_dir)])
    out = capsys.readouterr().out
    assert "step 60: loss=" in out and "steps_per_sec=" in out
    assert "final_accuracy=" in out and "eval_accuracy=" in out
    assert summary["steps"] == 60 and summary["final_accuracy"] > 0.9
    tape = [l for _, l in summary["loss_tape"]]
    assert len(tape) == 3 and all(np.isfinite(tape)) and tape[-1] < tape[0]
    lines = (log_dir / "scalars.jsonl").read_text().splitlines()
    assert any('"final_accuracy"' in l for l in lines)


@pytest.mark.parametrize("flags", [
    # async is ported; the fused apply is refused in it, as in JAX
    ["--sync_mode", "async", "--fused_optimizer", "true"],
    # the replication modes are ported; the fused apply is refused with
    # each of them, as in JAX
    ["--bucket_grads", "auto", "--fused_optimizer", "true"],
    ["--shard_update", "true", "--fused_optimizer", "true"],
    ["--shard_params", "true"],
    # the sharded split and the host-fed path are ported; JAX refuses
    # them together, and --steps_per_loop > 1 host-fed
    ["--data_sharding", "sharded", "--device_data", "off"],
    ["--device_data", "off", "--steps_per_loop", "2"],
    # checkpoints are ported; they need a --log_dir (the test's is "")
    ["--checkpoint_every", "10"],
    # ZeRO-3 lays its rows out by --bucket_grads, as in JAX
    ["--shard_params", "true", "--num_devices", "2"],
    # onehot and lut are ported; the fused dequant kernel gathers over
    # the whole resident split, so JAX refuses it host-fed and sharded
    ["--dequant_impl", "pallas", "--device_data", "off"],
    ["--dequant_impl", "pallas", "--data_sharding", "sharded"],
    ["--fused_optimizer", "true", "--momentum", "0"],
    # weight decay is ported; the fused apply still has no decay term
    ["--fused_optimizer", "true", "--weight_decay", "0.1"],
    # 2 processes x M local ranks runs (tests/test_torch_nxm.py); a
    # global --num_devices the 2 processes do not divide is refused
    # before any group is joined
    ["--coordinator_address", "localhost:1", "--num_processes", "2",
     "--process_id", "0", "--num_devices", "3"],
    # refused before any rank is started
    ["--data_sharding", "sharded", "--num_devices", "2", "--dequant_impl",
     "pallas"],
])
def test_unported_modes_are_refused_by_name(small_torch_mnist, flags):
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_sync_mnist)
    with pytest.raises(ModeRefusal, match="--"):
        trainer_sync_mnist.main(["--device", "cpu", "--dataset", "synthetic",
                                 "--train_steps", "2", "--log_dir", ""]
                                + flags)


def test_bucketed_resnet20_is_refused_by_name():
    """Batch norm over each rank's rows would be another model: the JAX
    package refuses --bucket_grads for it in sync mode, by name."""
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_mirrored_cifar)
    with pytest.raises(ModeRefusal,
                       match="--bucket_grads cannot run 'resnet20'"):
        trainer_mirrored_cifar.main(["--device", "cpu", "--dataset",
                                     "synthetic", "--bucket_grads", "auto",
                                     "--num_devices", "2", "--log_dir", ""])


def test_snapshot_dir_with_a_row_layout_is_refused_by_name(
        small_torch_mnist, monkeypatch, tmp_path):
    """SNAPSHOT_DIR with a row layout writes shard sets; resuming one into
    another row layout is refused by name."""
    from distributedtensorflowexample_tpu_torch.resilience.shardstore import (
        ShardStore)
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_sync_mnist)
    snap = str(tmp_path / "shards")
    monkeypatch.setenv("SNAPSHOT_DIR", snap)
    argv = ["--device", "cpu", "--dataset", "synthetic", "--bucket_grads",
            "65536", "--num_devices", "2", "--log_dir", "",
            "--train_steps", "2", "--log_every", "1"]
    trainer_sync_mnist.main(argv + ["--shard_params", "true"])
    # --checkpoint_every 0: a set every step, as in the JAX Engine.
    assert ShardStore(snap).quorum_steps() == [1, 2]
    with pytest.raises(ModeRefusal, match="SNAPSHOT_DIR holds 'zero3_rows'"):
        trainer_sync_mnist.main(argv + ["--shard_update", "true",
                                        "--train_steps", "4"])


def test_auto_steps_per_loop_matches_the_jax_engine():
    from distributedtensorflowexample_tpu.engine.engine import (
        auto_steps_per_loop as jax_auto)
    from distributedtensorflowexample_tpu_torch.engine import (
        auto_steps_per_loop)
    for remaining in (1, 7, 60, 300, 2000):
        for spe in (8, 937):
            for iv in ((100, 0), (20, 30), (7, 0)):
                assert auto_steps_per_loop(remaining, spe, intervals=iv) == \
                    jax_auto(remaining, spe, intervals=iv)
            # a resumed run: the checkpoint interval and the start step
            for iv, start in (((100, 0, 50), 150), ((20, 30, 40), 12),
                              ((7, 0, 3), 3)):
                assert auto_steps_per_loop(remaining, spe, intervals=iv,
                                           start=start) == \
                    jax_auto(remaining, spe, intervals=iv, start=start)


def test_loop_hooks_stop_and_sample_at_their_marks():
    from distributedtensorflowexample_tpu_torch.training.hooks import (
        EvalHook, MetricsHook, StopAtStepHook)
    from distributedtensorflowexample_tpu_torch.training.loop import TrainLoop
    from distributedtensorflowexample_tpu_torch.training.metrics import (
        MetricsLogger)

    class State:
        step = 0

    def step(state, batch):
        state.step += 2
        return state, {"loss": torch.tensor(1.0 / state.step)}

    evals, metrics = [], MetricsHook(every=4)
    logger = MetricsLogger(log_every=100)
    hooks = [EvalHook(lambda s: evals.append(s.step) or 0.5, 4, logger),
             metrics, StopAtStepHook(10)]
    state = TrainLoop(step, iter(lambda: {}, None), 100, hooks, logger,
                      steps_per_call=2).run(State())
    assert state.step == 10
    assert evals == [4, 8]
    assert [s for s, _ in metrics.loss_tape] == [4, 8]
