"""``tools.ab_quantize`` (the headline config over each resident storage
of its split) held against the JAX package's ``tools/ab_quantize.py`` on
the CPU:

- every bitwise arm's first gathered batch (``off``, ``auto``,
  ``u8_onehot``, ``u8_lut``, ``u8_kernel``), built through
  ``tools.bench._make`` with the arm's ``quantize`` and ``dequant_impl``
  over the JAX index tape, equals the JAX ``DeviceDataset`` batch of the
  same quantize mode (``off`` or ``auto``) gathered by the JAX
  ``make_device_gather`` from the same split;
- ``u8_mul`` (quantize ``scale``, the affine ``f32(u) * f32(1/255)``)
  equals the jitted JAX ``apply_dequant_multiply`` (``u8 / 255.0``, which
  XLA compiles to a multiply by the float32 reciprocal) on the same
  bytes, and on all 256 byte values; an eager float32 division differs
  on 126 of them, by one ulp;
- the lines follow the JAX order (the JAX four, then the port's two),
  after one ``roofline_probe`` line with the JAX keys; ``--tiny`` (as
  ``AB_SMOKE=1``) takes a 16-step unroll and no probe; a failing variant
  is a line of unit ``error`` and the rest still run (exit 1).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflowexample_tpu.data.device_dataset import (
    DeviceDataset as JDeviceDataset)
from distributedtensorflowexample_tpu.parallel.sync import (
    make_device_gather as jmake_device_gather)
from distributedtensorflowexample_tpu_torch.data.mnist import load_mnist
from distributedtensorflowexample_tpu_torch.parallel import mesh as pmesh
from distributedtensorflowexample_tpu_torch.tools import ab_quantize
from distributedtensorflowexample_tpu_torch.tools import bench as pbench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, B = 32, 4
JAX_ORDER = ["off", "auto", "u8_mul", "u8_onehot"]
HELD = [v for v in ab_quantize.VARIANTS if v not in ab_quantize.NOT_HELD]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def small(monkeypatch):
    monkeypatch.setattr(pbench, "TRAIN_N", {"mnist": ROWS, "cifar10": ROWS})
    monkeypatch.setattr(pbench, "BATCH", dict(pbench.BATCH, cnn=B))
    monkeypatch.setattr(pbench, "REPEATS", 1)
    monkeypatch.setattr(pbench, "ROOFLINE_LEN",
                        dict(pbench.ROOFLINE_LEN, headline=2))


@pytest.fixture(scope="module")
def jab():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import ab_quantize as jax_ab_quantize
    finally:
        sys.path.pop(0)
    return jax_ab_quantize


@pytest.fixture(scope="module")
def split():
    return load_mnist("", "train", synthetic_size=ROWS, source="synthetic")


def _jax_batch(split, quantize: str) -> tuple:
    """(the JAX dataset, its step-0 batch) of ``quantize`` over ``split``."""
    x, y = split
    jds = JDeviceDataset(x, y, B, quantize=quantize)
    gather = jmake_device_gather(B, jds.steps_per_epoch,
                                 num_slots=jds.num_slots)
    batch = jax.jit(gather)(jnp.int32(0), jax.random.PRNGKey(0), jds.peek())
    return jds, {k: np.asarray(v) for k, v in batch.items()}


def _port_batch(jds, variant: str) -> dict:
    quantize, impl = ab_quantize.VARIANTS[variant]
    perm = lambda epoch: np.asarray(jds._make_perm(jnp.int32(epoch)))
    mesh = pmesh.Mesh(torch.device("cpu"))
    _, ds, _, _ = pbench._make("mnist_cnn", "mnist", B, 1, mesh,
                               quantize=quantize, dequant_impl=impl,
                               perm_fn=perm)
    return ds, ab_quantize.first_batch(ds, mesh)


def test_the_port_split_is_the_jax_split(split):
    from distributedtensorflowexample_tpu.data.mnist import (
        load_mnist as jload_mnist)
    jx, jy = jload_mnist("", "train", synthetic_size=ROWS,
                         source="synthetic")
    assert np.array_equal(split[0], jx) and np.array_equal(split[1], jy)


@pytest.mark.parametrize("variant", HELD)
def test_bitwise_arms_equal_the_jax_batch(split, variant):
    quantize = "off" if variant == "off" else "auto"
    jds, want = _jax_batch(split, quantize)
    ds, got = _port_batch(jds, variant)
    assert ds.dequant_impl == (None if variant == "off" else
                               {"auto": "affine", "u8_onehot": "onehot",
                                "u8_lut": "lut", "u8_kernel": "pallas"}
                               [variant])
    assert str(ds.images.dtype) == ("torch.float32" if variant == "off"
                                    else "torch.uint8")
    image = got["image"].numpy()
    assert image.dtype == want["image"].dtype == np.float32
    assert np.array_equal(image.view(np.int32),
                          want["image"].view(np.int32))
    assert np.array_equal(got["label"].numpy(), want["label"])


@pytest.mark.parametrize("variant", ["auto", "u8_kernel"])
def test_an_audit_leaves_the_first_batch_bitwise(split, variant):
    """A bytes audit (``utils/profiling.audit_step``) of a build of its own
    before the arm leaves nothing behind that moves its first batch."""
    from distributedtensorflowexample_tpu_torch.utils import profiling
    quantize, impl = ab_quantize.VARIANTS[variant]
    mesh = pmesh.Mesh(torch.device("cpu"))
    step, ds, state, _ = pbench._make("mnist_cnn", "mnist", B, 1, mesh,
                                      quantize=quantize, dequant_impl=impl)
    profiling.audit_step(step, ds, state)
    jds, want = _jax_batch(split, "auto")
    _, got = _port_batch(jds, variant)
    assert np.array_equal(got["image"].numpy().view(np.int32),
                          want["image"].view(np.int32))
    assert np.array_equal(got["label"].numpy(), want["label"])


def test_u8_mul_is_the_jitted_jax_multiply(jab, split):
    jds, _ = _jax_batch(split, "auto")
    ds, got = _port_batch(jds, "u8_mul")
    assert ds.dequant_impl == "affine" and str(ds.images.dtype) == \
        "torch.uint8"
    idx = np.asarray(jds._make_perm(jnp.int32(0)))[:B]
    u8 = np.asarray(jds.peek()["images"])[idx]
    want = np.asarray(jax.jit(jab.apply_dequant_multiply)(
        jnp.asarray(u8), None))
    assert np.array_equal(got["image"].numpy().view(np.int32),
                          want.view(np.int32))
    # All 256 bytes: the jitted division is the one-rounding multiply by
    # the float32 reciprocal; an eager float32 division is not.
    from distributedtensorflowexample_tpu_torch.data.device_dataset import (
        dequantize_images)
    u = np.arange(256, dtype=np.uint8)
    port = dequantize_images(torch.from_numpy(u), "unit", "affine").numpy()
    jitted = np.asarray(jax.jit(jab.apply_dequant_multiply)(
        jnp.asarray(u), None))
    eager = u.astype(np.float32) / np.float32(255.0)
    assert np.array_equal(port.view(np.int32), jitted.view(np.int32))
    diff = port.view(np.int32) != eager.view(np.int32)
    assert int(diff.sum()) == 126
    assert np.abs(port.view(np.int32) - eager.view(np.int32)).max() == 1


def _fake_measure(step, ds, state, steps, unroll, warmup_calls=2):
    return 100.0, [100.0], state


def _run(capsys, *argv) -> tuple:
    rc = ab_quantize.main(["--device", "cpu", *argv])
    return rc, [json.loads(l) for l in capsys.readouterr().out.splitlines()
                if l.startswith("{")]


def test_lines_follow_the_jax_order(monkeypatch, capsys):
    rows = 2 * B        # two steps an epoch: a real, short window
    monkeypatch.setattr(pbench, "TRAIN_N", {"mnist": rows, "cifar10": rows})
    monkeypatch.setenv("AB_UNROLL_EPOCHS", "1")
    monkeypatch.setenv("AB_CALLS", "1")
    monkeypatch.delenv("AB_SMOKE", raising=False)
    rc, lines = _run(capsys)
    assert rc == 0
    probe, *variants = lines
    assert probe["metric"] == "roofline_probe" and probe["repeats"]
    assert probe["cost_per_step"]["flops"] > 0
    names = [l["metric"] for l in variants]
    assert names == [f"headline_{v}_steps_per_sec_per_chip"
                     for v in JAX_ORDER + ["u8_lut", "u8_kernel"]]
    spe = rows // B
    for v, l in zip(ab_quantize.VARIANTS, variants):
        d = l["detail"]
        assert l["unit"] == "steps/sec/chip" and l["value"] > 0
        assert d["unroll"] == spe and d["batch_per_chip"] == B
        assert (d["quantize"], d["dequant"]) == (
            ab_quantize.VARIANTS[v][0],
            "none" if v == "off" else ab_quantize.VARIANTS[v][1]
            if v != "auto" else "affine")
        assert d["bitwise_vs_off"] is True
        assert d["launches"] == d["kernel_steps"] == dict.fromkeys(
            d["launches"], 0)


@pytest.mark.parametrize("how", ["flag", "env"])
def test_smoke_is_a_16_step_unroll_and_no_probe(monkeypatch, capsys, how):
    monkeypatch.setattr(pbench, "_measure", _fake_measure)
    monkeypatch.delenv("AB_SMOKE", raising=False)
    if how == "env":
        monkeypatch.setenv("AB_SMOKE", "1")
    rc, lines = _run(capsys, *(["--tiny"] if how == "flag" else []))
    assert rc == 0 and len(lines) == len(ab_quantize.VARIANTS)
    assert all(l["detail"]["unroll"] == 16 for l in lines)


def test_a_failing_variant_is_an_error_line(monkeypatch, capsys):
    monkeypatch.setattr(pbench, "_measure", _fake_measure)
    make = pbench._make

    def failing(*a, **kw):
        if kw.get("dequant_impl") == "lut":
            raise RuntimeError("lut build failed")
        return make(*a, **kw)

    monkeypatch.setattr(pbench, "_make", failing)
    rc, lines = _run(capsys, "--tiny")
    assert rc == 1
    by = {l["metric"]: l for l in lines}
    bad = by["headline_u8_lut_steps_per_sec_per_chip"]
    assert bad["unit"] == "error" and bad["value"] == 0.0
    assert "lut build failed" in bad["detail"]["error"]
    assert by["headline_u8_kernel_steps_per_sec_per_chip"]["value"] == 100.0


def test_bitwise_compares_bit_patterns():
    x = torch.tensor([0.0, 1.0])
    lab = torch.tensor([1, 2])
    assert ab_quantize.bitwise({"image": x, "label": lab},
                               {"image": x.clone(), "label": lab})
    assert not ab_quantize.bitwise({"image": torch.tensor([-0.0, 1.0]),
                                    "label": lab}, {"image": x, "label": lab})
    assert not ab_quantize.bitwise({"image": x, "label": lab + 1},
                                   {"image": x, "label": lab})


def test_a_missing_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ab_quantize.main([]) == 1
    assert "cuda" in capsys.readouterr().err
