"""The port's measurement tools held against the JAX package's on the
CPU:

- ``tools.bench_collectives``: ``fit_latency_bandwidth`` and
  ``suggest_bucket_bytes`` equal the JAX ``bench_collectives.py``
  functions on seeded points and on the degenerate cases of its own
  test; one tiny sweep (2 gloo ranks, 2 sizes, every kind) writes a
  record that both packages' ``load_collective_fit`` read alike; no
  card is refused by name;
- ``tools.bench_input``: its four stages (each bit-identical to numpy
  before it times) at the sizes of the JAX package's smoke test;
- ``tools.ab_augment``: every variant's batch is bitwise base's, and
  base (with the selector forms) is bitwise the JAX ``augment_device``
  crop and flip followed by the reference's dequant table, on the JAX
  draws (the math, not the RNG).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from distributedtensorflowexample_tpu.resilience import scheduler as jsched
from distributedtensorflowexample_tpu_torch.resilience import (
    scheduler as psched)
from distributedtensorflowexample_tpu_torch.tools import ab_augment
from distributedtensorflowexample_tpu_torch.tools import bench_collectives
from distributedtensorflowexample_tpu_torch.tools import bench_input
from distributedtensorflowexample_tpu_torch.tools import bench_ratchet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jbc():
    sys.path.insert(0, REPO)
    try:
        import bench_collectives as jax_bench_collectives
    finally:
        sys.path.pop(0)
    return jax_bench_collectives


# --- bench_collectives ------------------------------------------------------

def _fit_cases():
    rng = np.random.default_rng(16)
    sizes = [4096.0 * 4 ** k for k in range(6)]
    alpha, beta = 2e-4, 5e8
    exact = [alpha + s / beta for s in sizes]
    cases = [(sizes, exact),
             (sizes, [t * (1 + 0.05 * (-1) ** i)
                      for i, t in enumerate(exact)]),
             ([1], [1]), (sizes, list(reversed(exact))),
             ([4096.0, 4096.0], [1e-3, 2e-3]),          # zero variance
             (sizes, [1e-3] * len(sizes))]              # flat: slope 0
    for _ in range(8):
        s = sorted(rng.uniform(1e3, 1e7, size=int(rng.integers(2, 9))))
        a, b = rng.uniform(1e-6, 1e-3), rng.uniform(1e8, 1e11)
        cases.append((list(s), [a + x / b + rng.normal(0, a / 10)
                                for x in s]))
    return cases


def test_fit_and_bucket_suggestion_equal_jax(jbc):
    for sizes, times in _fit_cases():
        assert bench_collectives.fit_latency_bandwidth(sizes, times) == \
            jbc.fit_latency_bandwidth(sizes, times)
    fit = bench_collectives.fit_latency_bandwidth(*_fit_cases()[0])
    assert abs(fit["alpha_s"] - 2e-4) < 1e-9 and fit["r2"] > 0.9999
    for degenerate in _fit_cases()[2:6]:
        assert bench_collectives.fit_latency_bandwidth(
            *degenerate)["knee_bytes"] is None
    for knee in (None, 0, -5, 1, 250_000, 1 << 20, 1 << 30):
        assert bench_collectives.suggest_bucket_bytes(knee) == \
            jbc.suggest_bucket_bytes(knee)
    assert bench_collectives.suggest_bucket_bytes(250_000) == 1_000_000
    assert bench_collectives._BUS_FACTOR.keys() == jbc._BUS_FACTOR.keys()
    assert bench_collectives._COLLECTIVES == jbc._COLLECTIVES
    assert all(bench_collectives._BUS_FACTOR[k](n) == jbc._BUS_FACTOR[k](n)
               for k in jbc._COLLECTIVES for n in (2, 4, 8))


def test_tiny_cpu_sweep_reads_back_in_both_packages(tmp_path, capsys):
    """Two gloo ranks on the host, every kind at 2 sizes: one point per
    (kind, size), a fit per kind, and the record both packages'
    ``load_collective_fit`` read the same."""
    out = tmp_path / "BENCH_collectives_cpu_r16.json"
    assert bench_collectives.main([
        "--device", "cpu", "--submeshes", "2", "--sizes", "4096,4194304",
        "--repeats", "2", "--json", str(out)]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    points, summary = lines[:-1], lines[-1]
    assert [(p["collective"], p["bytes"]) for p in points] == [
        (c, b) for c in bench_collectives._COLLECTIVES
        for b in (4096, 4194304)]
    assert all(p["backend"] == "gloo" and p["platform"] == "cpu"
               and not p["host_staged"] and p["latency_s"] > 0
               and len(p["repeats_s"]) == 2 for p in points)
    rec = json.loads(out.read_text())
    detail = rec["detail"]
    assert summary == {**rec, "detail": {k: v for k, v in detail.items()
                                         if k != "points"}}
    assert detail["backends"] == {"2": "gloo"} and detail["unmeasured"] == {}
    assert detail["device"] == bench_ratchet.describe_device("cpu")
    assert set(detail["knees"]) == set(bench_collectives._COLLECTIVES)
    psum = detail["knees"]["psum"]["2"]
    assert psum["alpha_s"] > 0 and psum["beta_bytes_per_s"] > 0
    assert rec["value"] == psum["knee_bytes"] and rec["unit"] == "bytes"
    assert detail["suggested_bucket_bytes"] == \
        bench_collectives.suggest_bucket_bytes(psum["knee_bytes"])
    assert len(detail["repeats"]) == 2 and detail["n_repeats"] == 2
    for devices in (1, 2, 4):
        fit = psched.load_collective_fit(str(out), devices)
        assert fit == jsched.load_collective_fit(str(out), devices)
        assert fit == {"alpha_s": psum["alpha_s"],
                       "beta_bytes_per_s": psum["beta_bytes_per_s"],
                       "fit_devices": 2, "file": out.name}
    recs = bench_ratchet.load_records([str(out)])
    assert len(recs) == 1 and bench_ratchet._platform(recs[0]) == "cpu"


def test_collectives_refuse_a_missing_card_and_bad_groups(capsys):
    assert bench_collectives.main(["--submeshes", "2"]) == 1
    assert "--device cuda" in capsys.readouterr().err
    for argv in (["--device", "cpu", "--submeshes", "1"],
                 ["--device", "cpu", "--backend", "nccl"],
                 ["--device", "cpu", "--collectives", "psum,bcast"]):
        with pytest.raises(SystemExit) as exc:
            bench_collectives.main(argv)
        assert exc.value.code == 2
    assert bench_collectives.choose_backend("auto", "cpu", 4) == "gloo"
    assert bench_collectives.payload_elems(4096, 4) == 1024
    assert bench_collectives.payload_elems(4100, 3) == 1026


# --- bench_input ------------------------------------------------------------

def test_bench_input_stages_are_bit_identical_and_rated(capsys):
    from distributedtensorflowexample_tpu_torch import native
    assert native.available(), "the native loader must build here"
    lines = bench_input.run_stages({
        "bench_cifar_parse": {"n_records": 50},
        "bench_idx_parse": {"n": 200},
        "bench_gather_augment": {"n_src": 300, "batch": 16},
        "bench_gather_augment_u8": {"n_src": 300, "batch": 16}})
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert printed == lines
    assert [l["metric"] for l in lines] == [
        "cifar_parse_native_mb_per_sec", "idx_parse_native_mb_per_sec",
        "gather_augment_native_images_per_sec",
        "gather_augment_native_u8_images_per_sec"]
    host = bench_ratchet.describe_device("cpu")
    for l in lines:
        assert l["value"] > 0 and l["vs_baseline"] > 0
        assert l["detail"]["device"] == host
        assert len(l["detail"]["repeats"]) == bench_input.REPEATS
        assert max(l["detail"]["repeats"]) == l["value"]
    assert bench_ratchet.spread_fraction(lines[0]["detail"]["repeats"]) < 1


# --- ab_augment -------------------------------------------------------------

ROWS, B = 256, 16


@pytest.fixture(scope="module")
def cifar_ds():
    return ab_augment.build_dataset(ROWS, B, 4, torch.device("cpu"))


def _jax_draws(rng, batch, step):
    import jax
    key = jax.random.fold_in(jax.random.fold_in(rng, 0x5EED), step)
    ky, kx, kf = jax.random.split(key, 3)
    return key, tuple(np.asarray(a) for a in (
        jax.random.randint(ky, (batch,), 0, 9),
        jax.random.randint(kx, (batch,), 0, 9),
        jax.random.bernoulli(kf, 0.5, (batch,))))


def test_ab_augment_variants_are_bitwise_base(cifar_ds):
    assert cifar_ds.dequant == "cifar" and cifar_ds.dequant_impl == "affine"
    assert cifar_ds.images.dtype == torch.uint8
    data = next(cifar_ds)
    gathers = ab_augment.make_gathers(cifar_ds, B)
    ab_augment.check_bitwise(gathers, data, ab_augment.VARIANTS, steps=4)
    base = gathers["base"](1, data)["image"]
    assert base.shape == (B, 32, 32, 3) and base.dtype == torch.float32
    # The draws move pixels: noaug differs from base, and is base's batch
    # under the identity draws only.
    assert not torch.equal(gathers["noaug"](1, data)["image"], base)
    with pytest.raises(AssertionError, match="'noaug' differs from base"):
        broken = dict(gathers, base_identity=gathers["base"])
        ab_augment.check_bitwise(broken, data, ("noaug",))
    with pytest.raises(TypeError, match="uint8"):
        ab_augment.selector_crop_flip(base, *(torch.zeros(B, dtype=t)
                                              for t in (torch.int64,
                                                        torch.int64,
                                                        torch.bool)))


def test_ab_augment_base_is_the_jax_augment_on_the_jax_draws(cifar_ds):
    import jax
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.data.augment_device import (
        cifar_augment_device)
    from distributedtensorflowexample_tpu.data.dequant import (
        make_dequant_lut)
    rng = jax.random.PRNGKey(16)
    draws = {s: _jax_draws(rng, B, s) for s in range(3)}
    data = next(cifar_ds)
    gathers = ab_augment.make_gathers(cifar_ds, B,
                                      draws_fn=lambda s: draws[s][1])
    lut = make_dequant_lut("cifar")                        # [256, 3]
    spe = cifar_ds.steps_per_epoch
    for step, (key, (ys, xs, flips)) in draws.items():
        pos = (step % spe) * B
        idx = data["perm"][(step // spe) % cifar_ds.num_slots,
                           pos:pos + B].numpy()
        u8 = cifar_ds.images.numpy()[idx]
        routed = np.asarray(jax.jit(cifar_augment_device)(jnp.asarray(u8),
                                                          key))
        want = lut[routed.astype(np.int64), np.arange(3)]
        for v in ("base", "selmm", "selmm_oh", "kernel"):
            got = gathers[v](step, data)
            assert got["image"].numpy().tobytes() == want.tobytes(), v
            assert got["label"].numpy().tolist() == \
                cifar_ds.labels.numpy()[idx].tolist()
    assert flips.any() and not flips.all()


def test_ab_augment_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "BENCH_augment_cpu_r16.json"
    assert ab_augment.main(["--device", "cpu", "--rows", str(ROWS),
                            "--batch", str(B), "--steps", "3", "--out",
                            str(out)]) == 0
    lines = [json.loads(l) for l in out.read_text().splitlines()]
    assert [json.loads(l) for l in
            capsys.readouterr().out.splitlines()] == lines
    assert [l["metric"] for l in lines] == [
        f"input_path_{v}_steps_per_sec" for v in ab_augment.VARIANTS]
    for l in lines:
        d = l["detail"]
        assert l["value"] > 0 and len(d["repeats"]) == ab_augment.REPEATS
        assert l["value"] == pytest.approx(np.median(d["repeats"]), abs=0.01)
        assert d["bitwise_equal_to_base"] and d["platform"] == "cpu"
        # On the CPU the dequant wrapper runs its plain version: no launch.
        assert d["launches"]["dequant"] == 0
    assert lines[-1]["detail"]["dequant_impl"] == "pallas"
    assert ab_augment.main(["--rows", str(ROWS)]) == 1
    assert "--device cuda" in capsys.readouterr().err
