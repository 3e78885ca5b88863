"""``tools.bench`` (the port's headline harness) held against the JAX
package's root ``bench.py`` on the CPU, calling the JAX functions
directly:

- every ``_make`` call of a whole run, workload by workload (model,
  dataset, batch, unroll, lr, momentum, CE impl, fused optimizer, sync
  or async with its period, dequant impl, augment), is the JAX run's,
  both runs driven through recording Engines and one fake rate;
- config 3's first steps through ``_make``, from the converted JAX init
  over the JAX index tape, track the JAX ``_make`` step within the
  config 3 parity tolerance (``tests/test_torch_slice.py``: tape within
  1e-2 relative, first update within 8e-2 of its largest element);
  dropout is off on both sides (the math, not the RNG);
- ``_emit`` and the sentinel give the JAX lines' keys, units and
  rounding, plus ``detail.baseline`` and ``detail.device`` (and the
  sentinel less the probe's keys);
- the headline is the last line when a side workload raises;
- the FLOP count equals one written out here from the layer shapes;
- a missing card exits 1 naming ``--device cuda``; ``--baselines`` is
  read by platform; ``BASELINE_SELF.json`` is never read;
- one real run of ``main`` at tiny sizes: six lines, headline last, no
  kernel launched on the CPU.
"""

import dataclasses
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributedtensorflowexample_tpu.config as jconfig
import distributedtensorflowexample_tpu.engine as jengine
import distributedtensorflowexample_tpu.parallel as jparallel
from distributedtensorflowexample_tpu.data import mnist as jmnist
from distributedtensorflowexample_tpu_torch import config as pconfig
from distributedtensorflowexample_tpu_torch import convert
from distributedtensorflowexample_tpu_torch.engine import engine as pengine
from distributedtensorflowexample_tpu_torch.ops import kernels
from distributedtensorflowexample_tpu_torch.parallel import mesh as pmesh
from distributedtensorflowexample_tpu_torch.tools import bench as pbench
from distributedtensorflowexample_tpu_torch.tools import bench_ratchet
from distributedtensorflowexample_tpu_torch.utils import flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADLINE = "mnist_cnn_sync_steps_per_sec_per_chip"
METRICS = ["cifar_resnet20_steps_per_sec_per_chip",
           "mnist_cnn_async_steps_per_sec_per_chip",
           "mnist_softmax_steps_per_sec_per_chip",
           "mnist_cnn_sync_pallas_ce_steps_per_sec_per_chip",
           "mnist_cnn_sync_fused_sgd_steps_per_sec_per_chip", HEADLINE]
# Tiny sizing, the same in both packages: spe = 2 (mnist, cifar10) and 8
# (softmax); every sweep thinned to its first point plus one.
SIZES = {"REPEATS": 1,
         "TRAIN_N": {"mnist": 16, "cifar10": 16},
         "BATCH": {"cnn": 8, "softmax": 2, "resnet": 8},
         "MIN_STEPS": {"headline": 2, "resnet": 2},
         "ROOFLINE_LEN": {"headline": 2, "softmax": 2, "resnet": 2},
         "HEADLINE_REST_UNROLLS": lambda spe: {spe},
         "RESNET_UNROLLS": lambda spe: {spe}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jbench():
    sys.path.insert(0, REPO)
    try:
        import bench as jax_bench
    finally:
        sys.path.pop(0)
    return jax_bench


def _lines(text: str) -> list[dict]:
    return [json.loads(l) for l in text.splitlines() if l.startswith("{")]


# --- the recording Engines --------------------------------------------------

class _Recorder:
    """Both packages' ``Engine`` stand-in: ``build`` records the spec's
    knobs and returns a stub build whose dataset resolves ``auto`` to
    ``affine``; ``fail`` (a model name) raises in its build."""

    def __init__(self, fail: str | None = None):
        self.calls: list = []
        self.fail = fail

    def engine(self, spec):
        rec = self

        class _Engine:
            def build(self, mesh, unroll=1, perm_fn=None, **kw):
                cfg = spec.config
                rec.calls.append((
                    spec.model, spec.dataset, cfg.batch_size, unroll,
                    cfg.learning_rate, cfg.momentum, cfg.pallas_ce,
                    cfg.fused_optimizer, cfg.sync_mode, cfg.async_period,
                    cfg.dequant_impl, bool(spec.augment)))
                if spec.model == rec.fail:
                    raise RuntimeError(f"{spec.model} build failed")
                impl = ("affine" if cfg.dequant_impl == "auto"
                        else cfg.dequant_impl)
                ds = types.SimpleNamespace(dequant_impl=impl,
                                           peek=lambda: {})
                return types.SimpleNamespace(
                    step=None, ds=ds, unroll=unroll,
                    state=types.SimpleNamespace(step=0))
        return _Engine()


def _fake_measure(step, ds, state, steps, unroll, warmup_calls=2):
    """One rate per (unroll, dequant impl): deeper windows faster, and
    the ``lut`` arm fastest, so the A/B promotes it in both runs."""
    rate = 100.0 + unroll + (50.0 if ds.dequant_impl == "lut" else 0.0)
    return rate, [rate], state


def _run_jax(jbench, monkeypatch, capsys, recorder) -> list[dict]:
    for name, value in SIZES.items():
        monkeypatch.setattr(jbench, name, value)
    monkeypatch.setattr(jbench, "DEQUANT", "auto")
    monkeypatch.setattr(jbench, "DEQUANT_AB_IMPLS", ("onehot", "lut",
                                                     "pallas"))
    monkeypatch.setattr(jbench, "HEADLINE_ONLY", False)
    monkeypatch.setattr(jbench, "_wait_for_backend",
                        lambda into=None: (True, []))
    monkeypatch.setattr(jbench, "_load_baselines", lambda: {})
    monkeypatch.setattr(jbench, "_measure", _fake_measure)
    monkeypatch.setattr(jbench, "_roofline_probe", lambda *a, **k: [100.0])
    monkeypatch.setattr(jbench, "_cost_per_step",
                        lambda *a, **k: {"flops": 1.0})
    monkeypatch.setattr(jbench, "_flops_per_step", lambda *a, **k: 1.0)
    real_mesh = jparallel.make_mesh
    monkeypatch.setattr(jparallel, "make_mesh", lambda: real_mesh(1))
    monkeypatch.setattr(jengine, "Engine", recorder.engine)
    capsys.readouterr()
    jbench.main()
    return _lines(capsys.readouterr().out)


def _run_port(monkeypatch, capsys, recorder, *argv) -> tuple:
    for name, value in SIZES.items():
        monkeypatch.setattr(pbench, name, value)
    monkeypatch.setattr(pbench, "DEQUANT_AB_IMPLS", ("onehot", "lut",
                                                     "pallas"))
    monkeypatch.setattr(pbench, "_measure", _fake_measure)
    monkeypatch.setattr(pbench, "_roofline_probe", lambda *a, **k: [100.0])
    monkeypatch.setattr(pengine, "Engine", recorder.engine)
    capsys.readouterr()
    rc = pbench.main(["--device", "cpu", *argv])
    return rc, _lines(capsys.readouterr().out)


def test_every_workload_resolves_the_jax_knobs(jbench, monkeypatch, capsys):
    jrec, prec = _Recorder(), _Recorder()
    jlines = _run_jax(jbench, monkeypatch, capsys, jrec)
    rc, plines = _run_port(monkeypatch, capsys, prec)
    assert rc == 0
    assert prec.calls == jrec.calls
    # Every workload, its A/B arms and sweep points: 2 headline points, 3
    # A/B arms, 1 resnet point, async, softmax and the two variants.
    assert len(prec.calls) == 10
    assert {c[0] for c in prec.calls} == {"mnist_cnn", "resnet20",
                                          "softmax"}
    assert [l["metric"] for l in plines[1:]] == \
        [l["metric"] for l in jlines[1:]] == METRICS
    jhead, phead = jlines[-1]["detail"], plines[-1]["detail"]
    assert phead["dequant"] == jhead["dequant"] == "lut"
    assert phead["dequant_ab"] == jhead["dequant_ab"]
    assert phead["unroll_sweep"] == jhead["unroll_sweep"]
    for jl, pl in zip(jlines[1:], plines[1:]):
        assert (pl["value"], pl["unit"], pl["vs_baseline"]) == \
            (jl["value"], jl["unit"], jl["vs_baseline"])
        assert pl["detail"]["launches"] == pl["detail"]["kernel_steps"] == \
            dict.fromkeys(kernels.WRAPPERS, 0)


def test_the_headline_is_last_when_a_side_workload_raises(jbench,
                                                         monkeypatch,
                                                         capsys):
    jlines = _run_jax(jbench, monkeypatch, capsys, _Recorder("resnet20"))
    rc, plines = _run_port(monkeypatch, capsys, _Recorder("resnet20"))
    assert rc == 1            # a failed workload fails the run (port)
    want = [m for m in METRICS if not m.startswith("cifar")]
    assert [l["metric"] for l in plines[1:]] == \
        [l["metric"] for l in jlines[1:]] == want
    assert plines[-1]["unit"] == "steps/sec/chip"
    assert set(plines[-1]["detail"]["errors"]) == \
        set(jlines[-1]["detail"]["errors"]) == {"resnet_sweep_2"}


# --- config 3's first steps against the JAX _make ---------------------------

def _no_dropout(module):
    """``module.RunConfig`` with dropout 0 by default (still a
    ``RunConfig``): both ``_make``s build their models from it."""
    return dataclasses.make_dataclass(
        "RunConfig", [("dropout", float, dataclasses.field(default=0.0))],
        bases=(module.RunConfig,))


def _jax_perm_fn(jds):
    return lambda epoch: np.asarray(
        jds._make_perm(jnp.asarray(epoch, jnp.int32)))


def test_headline_first_steps_track_the_jax_make(jbench, monkeypatch,
                                                 tmp_path):
    steps, rows = 3, 256
    monkeypatch.setattr(jmnist, "_SYNTH_SIZES", {"train": rows, "test": 64})
    monkeypatch.setattr(jconfig, "RunConfig", _no_dropout(jconfig))
    monkeypatch.setattr(pconfig, "RunConfig", _no_dropout(pconfig))
    monkeypatch.setattr(pbench, "TRAIN_N", {"mnist": rows, "cifar10": rows})
    mesh = jparallel.make_mesh(1)
    jstep, jds, jstate, _ = jbench._make("mnist_cnn", "mnist", 8, 1, mesh,
                                         data_dir=str(tmp_path))
    params0 = jax.tree.map(lambda a: np.array(a, copy=True), jstate.params)
    jtape = []
    with mesh:
        for i in range(steps):
            jstate, m = jstep(jstate, next(jds))
            jtape.append(float(m["loss"]))
            if i == 0:
                jparams1 = jax.tree.map(lambda a: np.array(a, copy=True),
                                        jstate.params)

    step, ds, state, u = pbench._make(
        "mnist_cnn", "mnist", 8, 1, pmesh.Mesh(torch.device("cpu")),
        data_dir="", perm_fn=_jax_perm_fn(jds))
    assert u == 1 and ds.dequant_impl == jds.dequant_impl
    assert state.model.dropout_rate == 0.0
    convert.load_into_state(state, params0)
    tape = []
    for i in range(steps):
        state, m = step(state, next(ds))
        tape.append(float(m["loss"]))
        if i == 0:
            params1, momentum1 = convert.state_to_flax(state)
    assert state.step == steps and momentum1 is not None
    np.testing.assert_allclose(tape, jtape, rtol=1e-2)
    for path, want in jax.tree.leaves_with_path(jparams1):
        k0, k1 = path[0].key, path[1].key
        want = want - params0[k0][k1]
        moved = params1[k0][k1] - params0[k0][k1]
        rel = np.abs(moved - want).max() / np.abs(want).max()
        assert rel < 8e-2, (k0, k1, rel)


# --- the record's lines -----------------------------------------------------

@pytest.mark.parametrize("baselines", [{"m": 100.0}, {}])
def test_emit_has_the_jax_shape(jbench, capsys, baselines):
    jbench._emit("m", 123.456, baselines, {"repeats": [1.0, 2.0]})
    want = json.loads(capsys.readouterr().out)
    dev = bench_ratchet.describe_device("cpu")
    pbench._emit("m", 123.456, baselines, {"repeats": [1.0, 2.0]}, dev)
    got = json.loads(capsys.readouterr().out)
    assert list(got) == list(want)
    assert {k: got[k] for k in got if k != "detail"} == \
        {k: want[k] for k in want if k != "detail"}
    assert got["value"] == 123.46 and got["unit"] == "steps/sec/chip"
    assert got["detail"] == {**want["detail"],
                             "baseline": baselines.get("m"), "device": dev}


def test_sentinels_have_the_jax_shape(jbench, monkeypatch, capsys):
    def no_device(*a, **k):
        raise RuntimeError("no device")

    monkeypatch.setattr(jbench, "_wait_for_backend",
                        lambda into=None: (True, []))
    monkeypatch.setattr(jparallel, "make_mesh", no_device)
    jbench.main()
    jlines = _lines(capsys.readouterr().out)
    monkeypatch.setattr(pmesh, "make_mesh", no_device)
    assert pbench.main(["--device", "cpu"]) == 1
    plines = _lines(capsys.readouterr().out)
    assert len(plines) == len(jlines) == 2
    for jl, pl in zip(jlines, plines):
        assert list(pl) == list(jl)
        assert (pl["metric"], pl["value"], pl["unit"], pl["vs_baseline"]) \
            == (jl["metric"], jl["value"], jl["unit"], jl["vs_baseline"]) \
            == (HEADLINE, 0.0, "unavailable", 0.0)
    assert set(plines[0]["detail"]) == \
        set(jlines[0]["detail"]) - {"probe_attempts", "see"}
    assert plines[0]["detail"]["provisional"] is True
    assert set(plines[1]["detail"]) == \
        set(jlines[1]["detail"]) - {"probe_attempts", "see"} | {"device"}
    assert "no device" in plines[1]["detail"]["error"]


def test_a_missing_card_exits_1_naming_the_flag(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pbench.main([]) == 1
    out, err = capsys.readouterr()
    assert out == "" and "--device cuda" in err


def test_baselines_are_read_by_platform(monkeypatch, capsys, tmp_path):
    cpu = bench_ratchet.describe_device("cpu")
    card = {"platform": "gpu", "name": "NVIDIA H100 80GB HBM3",
            "power_limit": "700.00 W"}
    records = tmp_path / "BENCH_gpu_r19.json"
    records.write_text("\n".join(json.dumps(r) for r in [
        {"metric": HEADLINE, "value": 40.0, "unit": "steps/sec/chip",
         "detail": {"platform": "cpu", "device": cpu}},
        {"metric": HEADLINE, "value": 50.0, "unit": "steps/sec/chip",
         "detail": {"platform": "cpu", "device": cpu}},
        {"metric": HEADLINE, "value": 5000.0, "unit": "steps/sec/chip",
         "detail": {"platform": "gpu", "device": card}},
        {"metric": METRICS[2], "value": 9000.0, "unit": "steps/sec/chip",
         "detail": {"platform": "gpu", "device": card}}]) + "\n")
    rc, lines = _run_port(monkeypatch, capsys, _Recorder(),
                          "--baselines", str(records))
    assert rc == 0
    by = {l["metric"]: l for l in lines[1:]}
    head = by[HEADLINE]
    assert head["detail"]["baseline"] == 50.0          # the newest, cpu's
    assert head["vs_baseline"] == round(head["value"] / 50.0, 4)
    assert by[METRICS[2]]["detail"]["baseline"] is None
    assert by[METRICS[2]]["vs_baseline"] == 1.0
    assert pbench._load_baselines(str(records), "gpu:" + card["name"]) == {
        HEADLINE: 5000.0, METRICS[2]: 9000.0}


def test_baseline_self_json_is_never_read(monkeypatch, capsys, tmp_path):
    (tmp_path / "BASELINE_SELF.json").write_text(json.dumps(
        {m: 1e-6 for m in METRICS}))
    monkeypatch.chdir(tmp_path)
    rc, lines = _run_port(monkeypatch, capsys, _Recorder())
    assert rc == 0 and len(lines) == 7
    for l in lines[1:]:
        assert l["vs_baseline"] == 1.0 and l["detail"]["baseline"] is None
        assert l["detail"]["device"] == bench_ratchet.describe_device("cpu")


# --- FLOPs, launches, the watchdog ------------------------------------------

def test_flops_equal_a_count_from_the_layer_shapes():
    # (layer, output positions, weight elements = MACs a position)
    cnn = [("conv1", 28 * 28, 5 * 5 * 1 * 32),
           ("conv2", 14 * 14, 5 * 5 * 32 * 64),
           ("fc1", 1, 7 * 7 * 64 * 1024), ("logits", 1, 1024 * 10)]
    resnet = [("conv_init", 32 * 32, 3 * 3 * 3 * 16)]
    cin = 16
    for stage, (width, hw) in enumerate([(16, 32), (32, 16), (64, 8)]):
        for block in range(3):
            name = f"stage{stage}_block{block}"
            resnet += [(f"{name}.conv1", hw * hw, 9 * cin * width),
                       (f"{name}.conv2", hw * hw, 9 * width * width)]
            if cin != width:
                resnet.append((f"{name}.proj", hw * hw, cin * width))
            cin = width
    resnet.append(("logits", 1, 64 * 10))
    from distributedtensorflowexample_tpu_torch.models import build_model
    for model, layers in (("softmax", [("logits", 1, 784 * 10)]),
                          ("mnist_cnn", cnn), ("resnet20", resnet)):
        got = flops.layer_macs(model)
        assert got == [(n, pos * w) for n, pos, w in layers]
        weights = dict(build_model(model).named_parameters())
        for n, _, w in layers:
            assert weights[f"{n}.weight"].numel() == w, (model, n)
        macs = sum(pos * w for _, pos, w in layers)
        first = layers[0][1] * layers[0][2]
        assert flops.forward_macs(model) == macs
        assert flops.train_flops_per_row(model) == 6 * macs - 2 * first
        assert flops.train_flops_per_step(model, 8) == \
            8 * (6 * macs - 2 * first)
    assert flops.forward_macs("mnist_cnn") == 13_883_904 == \
        627_200 + 10_035_200 + 3_211_264 + 10_240
    # The LM sizes are counted since the LM harness (test_torch_bench_lm);
    # a model with no known shapes is refused.
    with pytest.raises(ValueError):
        flops.layer_macs("lm_huge")


def test_a_line_checks_one_launch_a_step(monkeypatch):
    """On the card a line's launches must be one a step of the builds
    that requested each kernel (warm-up included); on the CPU none."""
    def fake_make(*a, dequant_impl="auto", **kw):
        ds = types.SimpleNamespace(dequant_impl=dequant_impl)
        return None, ds, types.SimpleNamespace(step=12), 4

    monkeypatch.setattr(pbench, "_make", fake_make)
    for w in kernels.WRAPPERS.values():
        monkeypatch.setattr(w, "launches", 0)
    line = pbench._Line(on_card=True)
    line.make("mnist_cnn", "mnist", 8, 4, None, ce_impl="pallas")
    line.make("mnist_cnn", "mnist", 8, 4, None, dequant_impl="pallas")
    line.make("mnist_cnn", "mnist", 8, 4, None)
    kernels.WRAPPERS["ce_fwd"].launches = 12
    kernels.WRAPPERS["ce_bwd"].launches = 12
    kernels.WRAPPERS["dequant"].launches = 12
    detail: dict = {}
    line.attach(detail)
    assert detail["launches"] == detail["kernel_steps"] == {
        "dequant": 12, "ce_fwd": 12, "ce_bwd": 12, "sgd": 0}
    kernels.WRAPPERS["ce_bwd"].launches = 0        # a variant that fell back
    with pytest.raises(RuntimeError, match="not one a step"):
        line.attach({})
    cpu = pbench._Line(on_card=False)
    cpu.make("mnist_cnn", "mnist", 8, 4, None, fused_opt=True)
    cpu.attach(detail)
    assert detail["kernel_steps"] == dict.fromkeys(kernels.WRAPPERS, 0)


def test_watchdog_fires_and_exits_3():
    fired, exits = [], []
    done = pbench._arm_watchdog(0.05, lambda: fired.append(1),
                                _exit=exits.append)
    for _ in range(200):
        if exits:
            break
        done.wait(0.01)
    assert fired == [1] and exits == [3]
    quiet = pbench._arm_watchdog(5.0, lambda: fired.append(2),
                                 _exit=exits.append)
    quiet.set()
    assert fired == [1]


# --- one real run -----------------------------------------------------------

def test_a_tiny_cpu_run_emits_six_lines_headline_last(monkeypatch, capsys):
    for name, value in SIZES.items():
        monkeypatch.setattr(pbench, name, value)
    monkeypatch.setattr(pbench, "TRAIN_N", {"mnist": 8, "cifar10": 8})
    monkeypatch.setattr(pbench, "BATCH", {"cnn": 8, "softmax": 8,
                                          "resnet": 8})
    monkeypatch.setattr(pbench, "DEQUANT_AB_IMPLS", ("pallas",))
    rc = pbench.main(["--device", "cpu"])
    lines = _lines(capsys.readouterr().out)
    assert rc == 0
    assert lines[0]["unit"] == "unavailable" and \
        lines[0]["detail"]["provisional"] is True
    assert [l["metric"] for l in lines[1:]] == METRICS
    for l in lines[1:]:
        d = l["detail"]
        assert l["unit"] == "steps/sec/chip" and l["value"] > 0, l
        assert d["device"] == bench_ratchet.describe_device("cpu")
        assert d["platform"] == "cpu" and d["baseline"] is None
        assert d["launches"] == d["kernel_steps"] == \
            dict.fromkeys(kernels.WRAPPERS, 0)
        assert len(d["repeats"]) == 1 and d["spread_frac"] == 0.0
    by = {l["metric"]: l["detail"] for l in lines[1:]}
    head = by[HEADLINE]
    assert head["vs_roofline"] > 0 and list(head["dequant_ab"]) == \
        ["pallas"]
    assert head["roofline_cost_per_step"] == {
        "flops": flops.train_flops_per_step("mnist_cnn", 8)}
    assert "errors" not in head
    rn = by[METRICS[0]]
    assert rn["mfu"] is None and rn["vs_roofline"] > 0
    assert rn["flops_per_step"] == flops.train_flops_per_step("resnet20", 8)
    assert by[METRICS[2]]["cost_per_step"] == {
        "flops": flops.train_flops_per_step("softmax", 8)}
