"""The telemetry slice on the CPU, held against the JAX package: the
tfevents writer (``utils/tfevents.py``), the timing and logging helpers,
the anomaly detectors and ``AnomalyHook`` (``obs/anomaly.py``,
``training/hooks.py``), the exporters (``obs/export.py``), the
cross-rank timeline (``obs/timeline.py``), ``--profile_dir``
(``utils/profiling.ProfilerHook``), the hook stack ``describe()``
reports and the input paths' refusals, and the tiny-MLP workload
(``trainers/trainer_tiny_mlp.py``).

Tolerances: tfevents bytes, detector flags and payloads, exporter text,
timeline merges, the hook stacks and the refusals' words: equal.  A tfevents value against
its ``scalars.jsonl`` value: equal after the float32 cast TensorBoard's
``simple_value`` makes.  The tiny MLP (float32) against the JAX one from
its converted parameters over its index tape: the loss tape within rtol
1e-5 (the products sum in other orders).
"""

import json
import os

import numpy as np
import pytest
import torch

from distributedtensorflowexample_tpu_torch import convert
from distributedtensorflowexample_tpu_torch.config import parse_flags
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
from distributedtensorflowexample_tpu_torch.obs import anomaly, export
from distributedtensorflowexample_tpu_torch.obs import metrics as obs_metrics
from distributedtensorflowexample_tpu_torch.obs import timeline
from distributedtensorflowexample_tpu_torch.obs import trace as obs_trace
from distributedtensorflowexample_tpu_torch.parallel.mesh import Mesh
from distributedtensorflowexample_tpu_torch.trainers import (
    common, trainer_tiny_mlp)
from distributedtensorflowexample_tpu_torch.training import hooks
from distributedtensorflowexample_tpu_torch.utils import (
    ProfilerHook, RateMeter, Timer, chief_print, tfevents, timed_block)

CPU = torch.device("cpu")
TINY_STEPS = 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """One tiny-MLP run through its trainer on the CPU, per step, with
    ``--log_dir``, ``--profile_dir`` (steps 11-13), ``OBS_HEALTH`` and a
    trace file."""
    root = tmp_path_factory.mktemp("tiny")
    env = {"OBS_HEALTH": str(root / "health.json"),
           "OBS_TRACE_FILE": str(root / "trace.jsonl")}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        summary = trainer_tiny_mlp.main([
            "--device", "cpu", "--train_steps", str(TINY_STEPS),
            "--steps_per_loop", "1", "--log_every", "5",
            "--log_dir", str(root / "log"), "--resume", "false",
            "--profile_dir", str(root / "prof"), "--profile_start_step",
            "10", "--profile_num_steps", "3"])
    return {"root": root, "summary": summary}


# --- tfevents ---------------------------------------------------------------

def test_tfevents_bytes_equal_the_jax_encoder():
    from distributedtensorflowexample_tpu.utils import tfevents as jax_tfe
    rng = np.random.RandomState(0)
    for _ in range(20):
        data = rng.bytes(rng.randint(0, 300))
        assert tfevents.crc32c(data) == jax_tfe.crc32c(data)
        assert tfevents.masked_crc32c(data) == jax_tfe.masked_crc32c(data)
    records = [(1.5e9 + i, int(s), tag, float(v)) for i, (s, tag, v) in
               enumerate([(0, "loss", 2.3), (2 ** 40, "accuracy", 0.5),
                          (7, "a/b c", -1e-30), (8, "steps_per_sec",
                                                 float("inf"))])]
    for rec in records:
        assert tfevents.frame_record(tfevents.encode_scalar_event(*rec)) \
            == jax_tfe.frame_record(jax_tfe.encode_scalar_event(*rec))
    assert tfevents.encode_file_version_event(1.5e9) == \
        jax_tfe.encode_file_version_event(1.5e9)


def test_every_log_dir_run_writes_tfevents_the_jax_reader_parses(tiny):
    """The run's tfevents file, read by the JAX package's ``read_events``,
    holds each ``scalars.jsonl`` value at its step (as float32)."""
    from distributedtensorflowexample_tpu.utils.tfevents import (
        read_events as jax_read_events)
    log = tiny["root"] / "log"
    (path,) = log.glob("events.out.tfevents.*")
    events = jax_read_events(str(path))
    assert events[0]["file_version"] == "brain.Event:2"
    got = {(e["step"], e["tag"]): e["value"] for e in events if "tag" in e}
    rows = [json.loads(line) for line in
            (log / "scalars.jsonl").read_text().splitlines()]
    want = {(row["step"], k): float(np.float32(v)) for row in rows
            for k, v in row.items() if k != "step"}
    assert got == want
    assert (TINY_STEPS, "final_accuracy") in got
    assert tfevents.read_events(str(path)) == events


# --- timing and logging -----------------------------------------------------

def test_timing_and_chief_print(capsys):
    timer = Timer()
    for _ in range(3):
        with timer.measure() as out:
            out["result"] = {"x": [torch.ones(4) * 2]}
    assert timer.count == 3 and timer.mean >= 0.0
    sink = []
    with timed_block("b", sink=sink) as out:
        out["result"] = torch.zeros(2)
    assert sink[0][0] == "b" and sink[0][1] >= 0.0
    meter = RateMeter(window=4)
    assert meter.rate == 0.0
    for _ in range(5):
        meter.tick()
    assert meter.rate > 0.0
    chief_print("from the chief")
    assert capsys.readouterr().out == "from the chief\n"


# --- anomaly detection ------------------------------------------------------

def _strip(payload: dict) -> dict:
    return {k: v for k, v in payload.items()
            if k not in ("pid", "updated_unix")}


def test_detectors_fire_as_the_jax_detectors():
    """One seeded stream (a warm-up, a step-time regression, a loss that
    improves, plateaus, improves again, then goes NaN) through both
    packages' RunHealth: the same firings at the same steps and the same
    payloads."""
    from distributedtensorflowexample_tpu.obs import anomaly as jax_anomaly
    rng = np.random.RandomState(0)
    ours = anomaly.RunHealth(rank=0, step_time=anomaly.EwmaRegression(
        warmup=8, z_thresh=6.0, skip_first=1),
        plateau=anomaly.PlateauSentinel(window=5))
    ref = jax_anomaly.RunHealth(rank=0, step_time=jax_anomaly.EwmaRegression(
        warmup=8, z_thresh=6.0, skip_first=1),
        plateau=jax_anomaly.PlateauSentinel(window=5))
    loss = 3.0
    fired = []
    for step in range(1, 61):
        dt = 0.01 * (1 + 0.02 * rng.randn()) * (3.0 if step > 40 else 1.0)
        a = ours.observe_window(step, 1, dt)
        b = ref.observe_window(step, 1, dt)
        assert a == b
        loss = (loss * 0.9 if step < 15 or 25 <= step < 30
                else loss + 1e-6 * rng.rand())
        if step == 55:
            loss = float("nan")
        a += ours.observe_loss(step, loss)
        b += ref.observe_loss(step, loss)
        assert a == b
        fired += [(step, kind) for kind in a]
        assert _strip(ours.payload()) == _strip(ref.payload())
    kinds = {kind for _, kind in fired}
    assert kinds == {"step_time_regression", "loss_plateau", "nan_loss"}


def test_skew_and_spread_match_jax():
    from distributedtensorflowexample_tpu.obs import anomaly as jax_anomaly
    cases = [
        {0: {"step": 100, "step_time_s": 0.01},
         1: {"step": 90, "step_time_s": 0.05},
         2: {"step": 99, "step_time_s": 0.011}},
        {0: {"step": 10, "step_time_s": 0.01},
         1: {"step": 2, "step_time_s": 0.01, "regression_firing": True}},
        {0: {"step": 10}, 1: {"step": 3, "hb_age_s": 4.0},
         2: {"step": 10, "step_time_s": None}},
        {0: {"step": 5}}]
    for ranks in cases:
        assert anomaly.detect_skew(ranks) == jax_anomaly.detect_skew(ranks)
    for samples in ([1.0, 2.0, 4.0], [3.0], [0.0, -1.0, 2.0, 2.5]):
        assert anomaly.spread_fraction(samples) == \
            jax_anomaly.spread_fraction(samples)


class _Loop:
    start_step = 0


def test_anomaly_hook_fires_as_the_jax_hook(tmp_path, monkeypatch):
    """Both packages' hooks on one fake clock: steady steps, eval spans
    (excluded from the step-time window), then a regression, with the
    loss gauge set as MetricsHook sets it.  Detection only (never a
    stop); the same flags, ``health.json`` payloads and counters."""
    import time

    from distributedtensorflowexample_tpu.obs import anomaly as jax_anomaly
    from distributedtensorflowexample_tpu.obs import metrics as jax_metrics
    from distributedtensorflowexample_tpu.obs import trace as jax_trace
    from distributedtensorflowexample_tpu.training import hooks as jax_hooks
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    monkeypatch.setenv("OBS_ANOMALY_WARMUP", "6")
    paths = {"ours": tmp_path / "ours.json", "ref": tmp_path / "ref.json"}
    pairs = [(hooks.AnomalyHook(every=2, health_path=str(paths["ours"])),
              obs_metrics, obs_trace, anomaly),
             (jax_hooks.AnomalyHook(every=2, health_path=str(paths["ref"])),
              jax_metrics, jax_trace, jax_anomaly)]
    before = [a.FLAGS_TOTAL.labels(kind="step_time_regression").value
              for _, _, _, a in pairs]
    for hook, *_ in pairs:
        hook.begin(_Loop())
    for step in range(1, 41):
        clock[0] += 0.01 if step <= 30 else 0.05
        if step % 10 == 0:
            clock[0] += 2.0                      # an eval of 2 s
        for hook, met, trc, _ in pairs:
            if step % 10 == 0:
                trc.event("eval", 2.0)
            met.gauge("train_loss").set(1.0 / step)
            assert hook.after_step(step, None, {}) is False
    for hook, *_ in pairs:
        hook.end(type("S", (), {"step": 40})())
    ours, ref = (json.loads(p.read_text()) for p in paths.values())
    assert _strip(ours) == _strip(ref)
    assert ours["flags"]["step_time_regression"]["fired_step"] == 31
    after = [a.FLAGS_TOTAL.labels(kind="step_time_regression").value
             for _, _, _, a in pairs]
    assert [x - y for x, y in zip(after, before)] == [1, 1]


# --- exporters --------------------------------------------------------------

def _fill(metrics_mod):
    reg = metrics_mod.MetricsRegistry()
    c = reg.counter("req_total", "requests")
    c.inc(3)
    c.labels(code="500").inc()
    reg.gauge("temp", "a gauge").set(0.25)
    h = reg.histogram("lat_seconds", "latency")
    for v in (0.001, 0.2, 3.0):
        h.observe(v)
        h.labels(route="/x").observe(v / 2)
    return reg


def test_exporters_write_the_jax_text(tmp_path, monkeypatch):
    from distributedtensorflowexample_tpu.obs import export as jax_export
    from distributedtensorflowexample_tpu.obs import metrics as jax_metrics
    for mod in (obs_metrics, jax_metrics):
        monkeypatch.setattr(mod, "_wall", lambda: 1234.5)
        monkeypatch.setattr(mod, "_now", lambda: 10.0)
    ours, ref = _fill(obs_metrics), _fill(jax_metrics)
    assert export.prometheus_text(ours) == jax_export.prometheus_text(ref)
    export.write_prometheus_textfile(str(tmp_path / "a.prom"), ours)
    jax_export.write_prometheus_textfile(str(tmp_path / "b.prom"), ref)
    assert (tmp_path / "a.prom").read_bytes() == \
        (tmp_path / "b.prom").read_bytes()
    a = export.JsonlExporter(str(tmp_path / "a.jsonl"))
    b = jax_export.JsonlExporter(str(tmp_path / "b.jsonl"))
    for _ in range(2):
        a.export(ours)
        b.export(ref)
        ours.counter("req_total").inc()
        ref.counter("req_total").inc()
    assert (tmp_path / "a.jsonl").read_text() == \
        (tmp_path / "b.jsonl").read_text()


def test_serve_reads_through_export_and_anomaly():
    """``obs/serve.py`` keeps no private copy of the exporter or the
    health reader."""
    from distributedtensorflowexample_tpu_torch.obs import serve
    src = open(serve.__file__).read()
    assert "def prometheus_text" not in src and "def read_health" not in src
    assert "export as _export" in src and "anomaly as _anomaly" in src


# --- the timeline -----------------------------------------------------------

def test_timeline_equals_the_jax_timeline(tiny, tmp_path):
    """Flights for two ranks built from the run's trace (rank 1's events
    without wall stamps, for the calibration), the trace file itself, a
    journal and health files: the same merge, Chrome trace, step anatomy
    and totals."""
    from distributedtensorflowexample_tpu.obs import timeline as jax_tl
    events = [json.loads(line) for line in
              (tiny["root"] / "trace.jsonl").read_text().splitlines()]
    assert any(e["name"] == "steps" and "compute_s" in e for e in events)
    fdir = tmp_path / "flight"
    fdir.mkdir()
    gauges = {'collective_ops_per_step{op="all-reduce"}': {"value": 1},
              'collective_bytes_per_step{op="all-reduce"}': {"value": 4096}}
    for rank in (0, 1):
        spans = [dict(e, rank=rank) for e in events]
        if rank == 1:
            for e in spans[1:]:
                e.pop("t0_unix", None)
        (fdir / f"flight_{rank}_{100 + rank}.json").write_text(json.dumps(
            {"pid": 100 + rank, "rank": rank, "attempt": 1, "spans": spans,
             "metrics": {"gauges": gauges}}))
    (fdir / "flight_9_1.json").write_text("{torn")
    journal = tmp_path / "journal.jsonl"
    journal.write_text(json.dumps({"ts": events[0]["t0_unix"],
                                   "event": "gang_start",
                                   "ranks": [0, 1, 2]}) + "\n{torn\n")
    (fdir / "health_rank0.json").write_text(
        (tiny["root"] / "health.json").read_text())
    srcs = timeline.fleet_dir_sources(str(fdir), str(journal))
    assert srcs == jax_tl.fleet_dir_sources(str(fdir), str(journal))
    srcs["trace_paths"] = [str(tiny["root"] / "trace.jsonl")]
    merged = timeline.merge(**srcs)
    ref = jax_tl.merge(**srcs)
    assert merged == ref
    # Rank 2 started (the journal) and rank 9 left only a torn flight.
    assert merged["coverage"]["ranks_missing"] == [2, 9]
    assert timeline.chrome_trace(merged) == jax_tl.chrome_trace(ref)
    rows = timeline.step_anatomy(merged)
    assert rows == jax_tl.step_anatomy(ref) and rows
    assert timeline.anatomy_totals(rows) == jax_tl.anatomy_totals(rows)


# --- the profiler hook ------------------------------------------------------

def test_profile_dir_writes_one_trace_of_the_window(tiny):
    prof = tiny["root"] / "prof"
    assert sorted(os.listdir(prof)) == ["rank0"]
    assert os.listdir(prof / "rank0") == ["trace_11_13.json"]
    assert tiny["summary"]["profile_trace"] == str(
        prof / "rank0" / "trace_11_13.json")
    trace = json.loads((prof / "rank0" / "trace_11_13.json").read_text())
    marks = sorted(e["name"] for e in trace["traceEvents"]
                   if e.get("cat") == "user_annotation")
    assert marks == ["ProfilerStep#11", "ProfilerStep#12",
                     "ProfilerStep#13"]
    assert any(e.get("name") == "aten::addmm" for e in trace["traceEvents"])


def test_profiler_window_slides_on_resume_and_captures_once(tmp_path):
    """A run resumed at step 12, inside the window (10, 13]: the window
    slides to (12, 15]; no second capture after it."""
    hook = ProfilerHook(str(tmp_path), start_step=10, num_steps=3, rank=2)
    loop = type("L", (), {"start_step": 12})()
    hook.begin(loop)
    assert hook.needs_sync(12)
    for step in range(12, 30):
        hook.after_step(step, None, {})
    assert hook.path == str(tmp_path / "rank2" / "trace_13_15.json")
    assert os.listdir(tmp_path / "rank2") == ["trace_13_15.json"]
    assert not hook.needs_sync(40)


# --- the hook stack and the tiny MLP ----------------------------------------

@pytest.mark.parametrize("extra,env", [
    ([], {}),
    (["--checkpoint_every", "5", "--eval_every", "5", "--profile_dir", "p"],
     {}),
    (["--profile_dir", "p"], {"SUPERVISE_HEARTBEAT": "hb"})])
def test_describe_lists_the_jax_hook_stack(extra, env, monkeypatch):
    from distributedtensorflowexample_tpu.config import (
        parse_flags as jax_parse_flags)
    from distributedtensorflowexample_tpu.engine.engine import (
        Engine as JaxEngine)
    from distributedtensorflowexample_tpu.engine.spec import (
        RunSpec as JaxRunSpec)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = ["--num_devices", "1", *extra]
    ours = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(
        ["--device", "cpu", *argv]))).describe()["hooks"]
    ref = JaxEngine(JaxRunSpec("mnist_cnn", "mnist", jax_parse_flags(
        argv))).describe()["hooks"]
    assert ours == ref
    assert ours[-2:] == ["MetricsHook", "AnomalyHook"]


def test_input_refusals_keep_the_jax_words():
    """The JAX Engine's refusals on the host-fed and sharded paths, word
    for word, and the flags once refused by the port now resolved."""
    from distributedtensorflowexample_tpu.config import (
        parse_flags as jax_parse_flags)
    from distributedtensorflowexample_tpu.engine.engine import (
        Engine as JaxEngine)
    from distributedtensorflowexample_tpu.engine.spec import (
        RunSpec as JaxRunSpec)
    from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
    cases = [["--dequant_impl", "pallas", "--device_data", "off"],
             ["--dequant_impl", "pallas", "--data_sharding", "sharded"],
             ["--data_sharding", "sharded", "--device_data", "off"]]
    for extra in cases:
        argv = ["--num_devices", "1", *extra]
        with pytest.raises(ModeRefusal) as ours:
            Engine(RunSpec("mnist_cnn", "mnist", parse_flags(
                ["--device", "cpu", *argv]))).describe()
        with pytest.raises(Exception) as ref:
            JaxEngine(JaxRunSpec("mnist_cnn", "mnist",
                                 jax_parse_flags(argv))).describe()
        assert str(ours.value) == str(ref.value)
    for extra in (["--device_data", "off"], ["--data_sharding", "sharded"],
                  ["--dequant_impl", "onehot"], ["--dequant_impl", "lut"],
                  ["--profile_dir", "p"], ["--remat", "block"]):
        Engine(RunSpec("resnet20", "cifar10", parse_flags(
            ["--device", "cpu", "--num_devices", "1", *extra]))).describe()


def test_tiny_run_arms_the_anomaly_hook(tiny):
    health = anomaly.read_health(str(tiny["root"] / "health.json"))
    assert health["step"] == TINY_STEPS and health["anomalies_total"] == 0
    assert tiny["summary"]["anomalies"] == 0
    assert 0.0 <= tiny["summary"]["final_accuracy"] <= 1.0


def test_tiny_mlp_tracks_the_jax_tiny_mlp():
    """20 steps of the tiny MLP from the JAX build's parameters over its
    index tape: the loss tape within rtol 1e-5."""
    import jax

    from distributedtensorflowexample_tpu.config import (
        parse_flags as jax_parse_flags)
    from distributedtensorflowexample_tpu.engine.engine import (
        Engine as JaxEngine)
    from distributedtensorflowexample_tpu.engine.spec import (
        RunSpec as JaxRunSpec)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)
    from distributedtensorflowexample_tpu.trainers import (
        trainer_tiny_mlp as jax_tiny)
    defaults = dict(batch_size=32, learning_rate=0.1, momentum=0.9,
                    dataset="tiny_blobs", dropout=0.0)
    jcfg = jax_parse_flags(["--num_devices", "1"], **defaults)
    jbuilt = JaxEngine(JaxRunSpec(
        model="tiny_mlp", dataset="tiny_blobs", config=jcfg,
        model_fn=lambda c: jax_tiny.TinyMLP(),
        input_fn=jax_tiny.blobs)).build(jax_make_mesh(1))
    perm = np.asarray(jbuilt.ds._make_perm(np.int32(0)))
    params0 = jax.tree.map(np.asarray, jbuilt.state.params)
    jstate, jtape = jbuilt.state, []
    for _ in range(20):
        jstate, m = jbuilt.step(jstate, next(jbuilt.ds))
        jtape.append(float(m["loss"]))
    cfg = parse_flags(["--device", "cpu"], **defaults)
    built = Engine(RunSpec(
        model="tiny_mlp", dataset="tiny_blobs", config=cfg,
        model_fn=lambda c: trainer_tiny_mlp.TinyMLP(),
        input_fn=trainer_tiny_mlp.blobs)).build(
        Mesh(CPU), perm_fn=lambda epoch: perm)
    convert.load_into_state(built.state, params0)
    tape = [float(built.step(built.state, next(built.ds))[1]["loss"])
            for _ in range(20)]
    np.testing.assert_allclose(tape, jtape, rtol=1e-5)
    assert tape[-1] < tape[0]


def test_run_training_is_the_engine_declaration(monkeypatch):
    seen = {}
    monkeypatch.setattr(common.Engine, "run",
                        lambda self: seen.setdefault("spec", self.spec))
    cfg = parse_flags(["--device", "cpu"])
    spec = common.run_training(cfg, "resnet20", "cifar10", augment=True)
    assert spec == RunSpec("resnet20", "cifar10", cfg, augment=True)
