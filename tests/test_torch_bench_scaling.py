"""``tools.bench_scaling`` (weak scaling over 1 -> N ranks) held against
the JAX package's root ``bench_scaling.py`` on the CPU, at 1 and 2 gloo
ranks, B=8 a rank:

- the per-count lines and the efficiency summary carry the JAX keys
  (``bench_scaling.py:183-222``), the summary's metric and unit as JAX
  names them;
- per step, the port's counted gradient all-reduce bytes (``Mesh.order``)
  equal the JAX ``collective_traffic`` of the one-step compiled HLO on a
  2-device CPU mesh for the same model, outside the scalar metrics'
  all-reduce that XLA:CPU fuses into it (the port's metrics sum is not a
  counted collective);
- ``--mode async`` amortizes the worker average's bytes by the period;
- a missing card exits 1 naming ``--device cuda``.
"""

import json
import os
import sys

import optax
import pytest
import torch

from distributedtensorflowexample_tpu.config import RunConfig
from distributedtensorflowexample_tpu.data.synthetic import make_synthetic
from distributedtensorflowexample_tpu.engine import Engine, RunSpec
from distributedtensorflowexample_tpu.parallel import make_mesh
from distributedtensorflowexample_tpu_torch.tools import bench_ratchet
from distributedtensorflowexample_tpu_torch.tools import bench_scaling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, UNROLL = 8, 2
CNN_PARAMS = 3_274_634
# The JAX harness's keys: its per-count line and its summary's detail.
JAX_LINE = {"devices", "backend", "mode", "global_batch", "steps_per_sec",
            "repeats", "collectives_per_step"}
JAX_SUMMARY = {"backend", "mode", "efficiency", "batch_per_chip", "note"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jbs():
    sys.path.insert(0, REPO)
    try:
        import bench_scaling as jax_bench_scaling
    finally:
        sys.path.pop(0)
    return jax_bench_scaling


def _run(capsys, *argv) -> list[dict]:
    capsys.readouterr()
    assert bench_scaling.main([
        "--device", "cpu", "--max_devices", "2", "--batch_per_chip", str(B),
        "--unroll", str(UNROLL), "--steps", "4", *argv]) == 0
    return [json.loads(l) for l in capsys.readouterr().out.splitlines()]


def _jax_one_step_traffic(jbs, devices: int) -> dict:
    """The JAX harness's accounting: ``collective_traffic`` of a one-step
    build's compiled program on a ``devices``-device CPU mesh."""
    mesh = make_mesh(devices)
    gb = B * devices
    spec = RunSpec(
        model="mnist_cnn", dataset="mnist",
        config=RunConfig(batch_size=B, seed=0, sync_mode="sync"),
        input_fn=lambda cfg, split: make_synthetic(gb * UNROLL * 2,
                                                   (28, 28, 1), 10, seed=0),
        optimizer_fn=lambda cfg, _mesh, wrap: optax.sgd(0.05, momentum=0.9))
    built = Engine(spec).build(mesh=mesh, unroll=1)
    with mesh:
        return jbs.collective_traffic(
            built.step.lower(built.state, built.ds.peek()).compile()
            .as_text())


def test_sync_lines_and_traffic_match_the_jax_harness(jbs, capsys):
    lines = _run(capsys)
    per_count, summary = lines[:-1], lines[-1]
    assert [l["devices"] for l in per_count] == [1, 2]
    for l in per_count:
        assert JAX_LINE <= set(l) and l["mode"] == "sync"
        assert l["global_batch"] == B * l["devices"]
        assert l["steps_per_sec"] > 0 and len(l["repeats"]) == 3
        assert l["host_staged"] is False and l["num_chips"] == l["devices"]
        assert l["device"] == bench_ratchet.describe_device("cpu")
        assert l["launches"] == [dict.fromkeys(
            ("dequant", "ce_fwd", "ce_bwd", "sgd"), 0)] * l["devices"]
    one, two = per_count
    assert one["backend"] is None and one["collectives_per_step"] == {}
    assert two["backend"] == "gloo"
    assert two["collectives_per_step"] == {
        "all-reduce": {"count": 1, "bytes": 4 * CNN_PARAMS}}

    assert summary["metric"] == "sync_sgd_weak_scaling"
    assert summary["unit"] == "efficiency_1_to_2"
    assert summary["vs_baseline"] == 1.0
    detail = summary["detail"]
    assert JAX_SUMMARY <= set(detail)
    assert list(detail["efficiency"]) == ["1", "2"]
    assert detail["efficiency"]["1"] == 1.0
    assert detail["efficiency"]["2"] == pytest.approx(
        two["steps_per_sec"] / one["steps_per_sec"], rel=1e-2)
    assert summary["value"] == detail["efficiency"]["2"] > 0
    assert detail["backend"] == "gloo" and detail["host_staged"] is False
    assert detail["batch_per_chip"] == B and detail["mode"] == "sync"

    jax_traffic = _jax_one_step_traffic(jbs, 2)
    assert set(jax_traffic) == {"all-reduce"}
    port_bytes = two["collectives_per_step"]["all-reduce"]["bytes"]
    # XLA:CPU fuses the loss/accuracy psum (two f32 scalars) into the
    # gradient all-reduce; nothing else may differ.
    assert jax_traffic["all-reduce"]["bytes"] - port_bytes in (0, 8)


def test_async_amortizes_by_the_period(capsys):
    lines = _run(capsys, "--mode", "async", "--async_period", "2")
    per_count, summary = lines[:-1], lines[-1]
    assert summary["metric"] == "async_sgd_weak_scaling"
    assert summary["detail"]["mode"] == "async"
    one, two = per_count
    assert one["amortized_bytes_per_step"] == {}
    assert two["collectives_per_step"] == {
        "all-reduce": {"count": 1, "bytes": 4 * CNN_PARAMS}}
    assert two["amortized_bytes_per_step"] == {
        "all-reduce": round(4 * CNN_PARAMS / 2)}


def test_a_missing_card_exits_1_naming_the_flag(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_scaling.main(["--max_devices", "2"]) == 1
    out, err = capsys.readouterr()
    assert out == "" and "--device cuda" in err
