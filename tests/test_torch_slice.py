"""The slice as a whole: config 3's indexed train step with all three
kernel flags, the port against the JAX package, from the same converted
init over the reference's injected index tape.

JAX side: ``make_indexed_train_step(ce_impl="pallas",
dequant_impl="pallas")`` with ``fused_momentum_sgd``,
``MnistCNN(dropout_rate=0.0)`` in bfloat16, no mesh, the Pallas kernels
in interpret mode (the JAX package's own CPU route).  Port side: the same
step through the kernels' plain versions (CPU tensors), fed the JAX
dataset's epoch permutations through ``perm_fn``.  256-row split, B=8.

Tolerance: the first loss equal, the 5-step loss tape within 1e-2
relative, and the first update within 8e-2 of its largest element, leaf
by leaf.  Both run the model in bfloat16, whose 8-bit mantissa the two
frameworks round at different places (conv, bias add, dense): measured on
the CPU the tapes agree to 4e-3 and the first update to 6e-2 on the
biases and 3e-3 on the kernels.  The batches themselves are bitwise
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from distributedtensorflowexample_tpu.data.device_dataset import (
    DeviceDataset as JaxDeviceDataset)
from distributedtensorflowexample_tpu.data.synthetic import (
    make_synthetic as jax_make_synthetic)
from distributedtensorflowexample_tpu.models.mnist_cnn import (
    MnistCNN as JaxMnistCNN)
from distributedtensorflowexample_tpu.ops.pallas import fused_momentum_sgd
from distributedtensorflowexample_tpu.parallel.sync import (
    make_device_gather as jax_make_device_gather,
    make_indexed_train_step as jax_make_indexed_train_step)
from distributedtensorflowexample_tpu.training.state import (
    TrainState as JaxTrainState)
from distributedtensorflowexample_tpu_torch import convert
from distributedtensorflowexample_tpu_torch.config import parse_flags
from distributedtensorflowexample_tpu_torch.data.device_dataset import (
    DeviceDataset)
from distributedtensorflowexample_tpu_torch.data.synthetic import (
    make_synthetic)
from distributedtensorflowexample_tpu_torch.models.mnist_cnn import MnistCNN
from distributedtensorflowexample_tpu_torch.parallel.sync import (
    make_device_gather, make_indexed_train_step)
from distributedtensorflowexample_tpu_torch.training.optimizers import (
    build_optimizer)
from distributedtensorflowexample_tpu_torch.training.state import TrainState

B, N, STEPS, LR, MU = 8, 256, 5, 0.05, 0.9


def _split():
    x, y = make_synthetic(N, (28, 28, 1), 10, seed=0, sample_seed=1)
    jx, jy = jax_make_synthetic(N, (28, 28, 1), 10, seed=0, sample_seed=1)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    return x, y


def _jax_perm_fn(jds):
    return lambda epoch: np.asarray(
        jds._make_perm(jnp.asarray(epoch, jnp.int32)))


def test_device_gather_batches_match_bitwise():
    x, y = _split()
    jds = JaxDeviceDataset(x, y, B, seed=0, dequant_impl="pallas")
    ds = DeviceDataset(x, y, B, seed=0, dequant_impl="pallas",
                       perm_fn=_jax_perm_fn(jds))
    assert (ds.steps_per_epoch, ds.num_slots, ds.dequant_impl) == \
        (jds.steps_per_epoch, jds.num_slots, jds.dequant_impl)
    jgather = jax.jit(jax_make_device_gather(
        B, jds.steps_per_epoch, num_slots=jds.num_slots,
        dequant_impl="pallas"), static_argnums=())
    gather = make_device_gather(B, ds.steps_per_epoch, num_slots=ds.num_slots,
                                dequant_impl="pallas")
    jdata, data = jds.peek(), ds.peek()
    for step in (0, 3, ds.steps_per_epoch - 1, ds.steps_per_epoch + 2):
        want = jgather(jnp.asarray(step), None, jdata)
        got = gather(step, data)
        np.testing.assert_array_equal(
            got["image"].numpy().view(np.int32),
            np.asarray(want["image"]).view(np.int32))
        np.testing.assert_array_equal(got["label"].numpy(),
                                      np.asarray(want["label"]))


def test_five_step_loss_tape_matches_the_jax_package():
    x, y = _split()
    jds = JaxDeviceDataset(x, y, B, seed=0, dequant_impl="pallas")
    jstate = JaxTrainState.create(JaxMnistCNN(dropout_rate=0.0),
                                  fused_momentum_sgd(LR, MU),
                                  jnp.zeros((B, 28, 28, 1)), seed=0)
    params0 = jax.tree.map(lambda a: np.array(a, copy=True), jstate.params)
    jstep = jax_make_indexed_train_step(
        B, jds.steps_per_epoch, ce_impl="pallas", dequant_impl="pallas",
        num_slots=jds.num_slots)
    jtape = []
    for i in range(STEPS):
        jstate, m = jstep(jstate, next(jds))
        jtape.append(float(m["loss"]))
        if i == 0:
            jparams1 = jax.tree.map(lambda a: np.array(a, copy=True),
                                    jstate.params)

    cfg = parse_flags(["--fused_optimizer", "true", "--momentum", str(MU),
                       "--learning_rate", str(LR), "--dropout", "0"])
    state = TrainState.create(MnistCNN(dropout_rate=0.0),
                              lambda m: build_optimizer(cfg, m), 0,
                              torch.device("cpu"))
    convert.load_into_state(state, params0)
    jds0 = JaxDeviceDataset(x, y, B, seed=0, dequant_impl="pallas")
    ds = DeviceDataset(x, y, B, seed=0, dequant_impl="pallas",
                       perm_fn=_jax_perm_fn(jds0))
    step = make_indexed_train_step(B, ds.steps_per_epoch, ce_impl="pallas",
                                   dequant_impl="pallas",
                                   num_slots=ds.num_slots)
    tape = []
    for i in range(STEPS):
        state, m = step(state, next(ds))
        tape.append(float(m["loss"]))
        if i == 0:
            params1, _ = convert.state_to_flax(state)
    assert state.step == STEPS and state.optimizer.count == STEPS
    assert all(np.isfinite(tape)) and tape[-1] < tape[0]
    assert tape[0] == jtape[0]
    np.testing.assert_allclose(tape, jtape, rtol=1e-2)
    # The first update, leaf by leaf: the bf16 gradient budget of
    # tests/test_torch_training.py (later steps compound it).
    for path, want in jax.tree.leaves_with_path(jparams1):
        k0, k1 = path[0].key, path[1].key
        want = want - params0[k0][k1]
        moved = params1[k0][k1] - params0[k0][k1]
        rel = np.abs(moved - want).max() / np.abs(want).max()
        assert rel < 8e-2, (k0, k1, rel)


def test_unrolled_step_equals_single_steps():
    x, y = _split()
    tapes = []
    for unroll in (1, 4):
        cfg = parse_flags(["--fused_optimizer", "true", "--momentum", "0.9",
                           "--learning_rate", "0.05"])
        torch.manual_seed(0)
        state = TrainState.create(MnistCNN(dropout_rate=0.0),
                                  lambda m: build_optimizer(cfg, m), 7,
                                  torch.device("cpu"))
        ds = DeviceDataset(x, y, B, seed=3, steps_per_next=unroll)
        step = make_indexed_train_step(B, ds.steps_per_epoch, ce_impl="pallas",
                                       unroll_steps=unroll,
                                       num_slots=ds.num_slots)
        losses = []
        for _ in range(8 // unroll):
            state, m = step(state, next(ds))
            losses.append(float(m["loss"]))
        tapes.append((np.mean(np.reshape(losses, (-1,))),
                      state.optimizer.params_flat.clone()))
    assert torch.equal(tapes[0][1], tapes[1][1])
