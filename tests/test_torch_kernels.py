"""The port's kernel wrappers on CPU tensors (their plain versions) held
against the JAX package's Pallas kernels in interpret mode, on the same
numpy-seeded inputs.

Tolerances:
- dequant: bitwise (both round once; compared as int32 bit patterns);
- cross-entropy forward and backward: 1e-6 absolute at logits of unit
  scale (2e-6 for the x5-scaled rows), the float32 summation-order
  difference of a row's log-sum-exp;
- SGD: bitwise against the Pallas kernel and jitted optax.sgd (both
  round each line once on the CPU, as the plain version's float64 route
  does), allowing at most 1 ulp on a vanishing share of elements where
  float64 double rounding can differ from a true fma.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributedtensorflowexample_tpu.ops.pallas import (
    fused_gather_dequant as jax_fused_gather_dequant,
    fused_sgd_apply as jax_fused_sgd_apply,
    fused_softmax_cross_entropy_rows as jax_ce_rows)
from distributedtensorflowexample_tpu_torch.data import dequant as port_dq
from distributedtensorflowexample_tpu_torch.ops import kernels
from distributedtensorflowexample_tpu_torch.ops.kernels import (
    cross_entropy as port_ce, dequant as port_dequant, sgd as port_sgd)


@pytest.mark.parametrize("spec,shape", [("unit", (28, 28, 1)),
                                        ("cifar", (32, 32, 3))])
def test_dequant_plain_matches_pallas_bitwise(spec, shape):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, size=(97,) + shape).astype(np.uint8)
    idx = rng.randint(0, 97, size=16).astype(np.int32)
    s, b = port_dq.make_dequant_affine(spec)
    want = np.asarray(jax_fused_gather_dequant(
        jnp.asarray(images), jnp.asarray(idx), jnp.asarray(s),
        jnp.asarray(b), interpret=True))
    got = kernels.fused_gather_dequant(
        torch.from_numpy(images), torch.from_numpy(idx),
        torch.from_numpy(s), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (16,) + shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        got.view(np.int32),
        port_dq.affine_numpy(images[idx], spec).view(np.int32))


def test_dequant_plain_clamps_out_of_range_rows():
    images = torch.arange(4 * 3, dtype=torch.uint8).reshape(4, 3, 1)
    s, b = (torch.from_numpy(a) for a in port_dq.make_dequant_affine("unit"))
    idx = torch.tensor([-5, 0, 3, 9], dtype=torch.int32)
    got = port_dequant.gather_dequant_plain(images, idx, s, b)
    want = port_dequant.gather_dequant_plain(
        images, torch.tensor([0, 0, 3, 3], dtype=torch.int32), s, b)
    assert torch.equal(got, want)


def test_dequant_constants_match_the_jax_package():
    from distributedtensorflowexample_tpu.data import dequant as jax_dq
    for spec in ("unit", "cifar"):
        for a, b in zip(port_dq.make_dequant_affine(spec),
                        jax_dq.make_dequant_affine(spec)):
            np.testing.assert_array_equal(a.view(np.int32),
                                          b.view(np.int32))
        assert port_dq.affine_matches_lut(spec)
        np.testing.assert_array_equal(port_dq.make_dequant_lut(spec),
                                      jax_dq.make_dequant_lut(spec))


def _ce_inputs(batch, classes, scale, seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(batch, classes) * scale).astype(np.float32)
    labels = rng.randint(0, classes, size=batch).astype(np.int32)
    labels[1] = -1                                  # a padding row
    g = rng.uniform(0.1, 2.0, size=batch).astype(np.float32)
    return logits, labels, g


@pytest.mark.parametrize("classes", [10, 250])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_ce_forward_and_backward_match_pallas(classes, smoothing):
    logits, labels, g = _ce_inputs(24, classes, 1.0, seed=classes)
    j_rows, j_vjp = jax.vjp(
        lambda l: jax_ce_rows(l, jnp.asarray(labels), smoothing,
                              interpret=True), jnp.asarray(logits))
    (j_grad,) = j_vjp(jnp.asarray(g))
    x = torch.from_numpy(logits).requires_grad_(True)
    rows = kernels.fused_softmax_cross_entropy_rows(
        x, torch.from_numpy(labels), smoothing)
    rows.backward(torch.from_numpy(g))
    np.testing.assert_allclose(rows.detach().numpy(), np.asarray(j_rows),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad),
                               rtol=0, atol=1e-6)
    assert rows[1].item() == 0.0 and not x.grad[1].any()


def test_ce_large_logits_and_label_outside_columns():
    logits, labels, g = _ce_inputs(16, 10, 5.0, seed=3)
    labels[2] = 10                                  # no column matches
    want = np.asarray(jax_ce_rows(jnp.asarray(logits), jnp.asarray(labels),
                                  0.0, interpret=True))
    got = port_ce.ce_fwd(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_ce_plain_matches_the_xla_head():
    from distributedtensorflowexample_tpu_torch.ops.losses import (
        softmax_cross_entropy_rows)
    logits, labels, _ = _ce_inputs(32, 10, 1.0, seed=4)
    labels[1] = 7
    x = torch.from_numpy(logits)
    y = torch.from_numpy(labels)
    for s in (0.0, 0.1):
        np.testing.assert_allclose(port_ce.ce_fwd(x, y, s).numpy(),
                                   softmax_cross_entropy_rows(x, y, s).numpy(),
                                   rtol=0, atol=1e-6)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_sgd_plain_matches_pallas_and_optax():
    rng = np.random.RandomState(5)
    shapes = {"conv": {"kernel": (5, 5, 1, 32), "bias": (32,)},
              "dense": {"kernel": (300, 7), "bias": (7,)}}
    mk = lambda: jax.tree.map(
        lambda s: rng.randn(*s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    p, m, g = mk(), mk(), mk()
    lr, mu = np.float32(0.05), 0.9
    j_p, j_m = jax_fused_sgd_apply(p, m, g, lr, mu, interpret=True)

    tx = optax.sgd(0.05, momentum=mu)
    st = (optax.TraceState(trace=m),) + tuple(tx.init(p)[1:])

    @jax.jit
    def optax_step(p, st, g):
        u, st = tx.update(g, st, p)
        return optax.apply_updates(p, u), st[0].trace

    o_p, o_m = optax_step(p, st, g)
    leaves = lambda t: [np.asarray(x).reshape(-1)
                        for x in jax.tree.leaves(t)]
    flat = lambda t: torch.from_numpy(np.concatenate(leaves(t)))
    tp, tm, tg = flat(p), flat(m), flat(g)
    kernels.fused_sgd_apply(tp, tm, tg, float(lr), mu)
    for want_p, want_m in ((j_p, j_m), (o_p, o_m)):
        wp, wm = np.concatenate(leaves(want_p)), np.concatenate(leaves(want_m))
        assert _ulps(tm.numpy(), wm).max() <= 1
        assert _ulps(tp.numpy(), wp).max() <= 1
        assert (_ulps(tp.numpy(), wp) > 0).mean() < 1e-3


def test_cpu_wrappers_never_count_launches():
    kernels.reset_launch_counts()
    x = torch.zeros(4, 10)
    y = torch.zeros(4, dtype=torch.int32)
    port_ce.ce_fwd(x, y)
    port_ce.ce_bwd(x, y, torch.ones(4))
    buf = torch.zeros(8)
    port_sgd.fused_sgd_apply(buf, buf.clone(), buf.clone(), 0.1, 0.9)
    assert kernels.launch_counts() == {"dequant": 0, "ce_fwd": 0,
                                       "ce_bwd": 0, "sgd": 0}


def test_wrappers_reject_bad_inputs():
    with pytest.raises(TypeError):
        port_ce.ce_fwd(torch.zeros(4, 10, dtype=torch.float64),
                       torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError):
        kernels.fused_gather_dequant(torch.zeros(4, 3, 1),
                                     torch.zeros(2, dtype=torch.int32),
                                     torch.ones(1), torch.zeros(1))
    with pytest.raises(ValueError):
        port_sgd.fused_sgd_apply(torch.zeros(8), torch.zeros(8),
                                 torch.zeros(4), 0.1, 0.9)
    with pytest.raises(ValueError):
        kernels.fused_gather_dequant(torch.zeros(4, 3, 1, dtype=torch.uint8),
                                     torch.zeros(2, dtype=torch.int32),
                                     torch.ones(1), torch.zeros(1,
                                                                device="meta"))
