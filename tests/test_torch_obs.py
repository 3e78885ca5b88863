"""The port's copies of the JAX package's stdlib-only telemetry modules
(``obs/ledger.py``, ``obs/recorder.py``, ``obs/serve.py``), held to the
JAX package's own checks (``tests/test_ledger.py``, ``tests/test_obs.py``)
and to the JAX modules themselves: for the same inputs under pinned
clocks the port writes the same ledger rows and the same flight payload,
apart from the process's identity (pid, argv) and the run id that embeds
it.  The copies stay stdlib-only.
"""

import ast
import json
import os
import pathlib
import signal
import subprocess
import sys
import textwrap
import urllib.error
import urllib.request

import pytest

from distributedtensorflowexample_tpu.obs import ledger as jax_ledger
from distributedtensorflowexample_tpu.obs import metrics as jax_metrics
from distributedtensorflowexample_tpu.obs import recorder as jax_recorder
from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
from distributedtensorflowexample_tpu_torch.obs import metrics as obs_metrics
from distributedtensorflowexample_tpu_torch.obs import recorder as obs_recorder
from distributedtensorflowexample_tpu_torch.obs import serve as obs_serve

REPO = pathlib.Path(__file__).resolve().parents[1]
OBS_DIR = REPO / "distributedtensorflowexample_tpu_torch" / "obs"
#: Row fields that name the writing process (and the run id built from
#: its pid), not the inputs.
_IDENTITY = {"pid", "argv", "run"}


def _fetch(url: str, timeout: float = 5.0) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _pin_clocks(monkeypatch) -> None:
    for metrics in (obs_metrics, jax_metrics):
        monkeypatch.setattr(metrics, "_wall", lambda: 1700000000.0)
        monkeypatch.setattr(metrics, "_now", lambda: 50.0)


def _write_run(ledger, metrics, path: str) -> list[dict]:
    """One run through ``ledger``: start, a counter, a sample, the end."""
    reg = metrics.MetricsRegistry()
    led = ledger.RunLedger(path, sample_min_s=0, registry=reg)
    led.start("trainer:softmax", config={"seed": 0, "train_steps": 8},
              platform="cpu", mesh_size=4)
    reg.counter("train_steps_total").inc(5)
    assert led.sample(step=5)
    led.end(rc=0, final_step=8)
    led.end(rc=1)                   # idempotent: the atexit safety
    rows, torn = ledger.read_rows(path)
    assert torn == 0
    return rows


def test_ledger_row_schema_golden_and_equal_to_the_jax_rows(tmp_path,
                                                           monkeypatch):
    _pin_clocks(monkeypatch)
    monkeypatch.setenv("OBS_RANK", "1")
    monkeypatch.setenv("SUPERVISE_ATTEMPT", "2")
    monkeypatch.setattr(obs_recorder, "_GLOBAL", None)
    monkeypatch.setattr(jax_recorder, "_GLOBAL", None)
    rows = _write_run(obs_ledger, obs_metrics, str(tmp_path / "port.jsonl"))
    want = _write_run(jax_ledger, jax_metrics, str(tmp_path / "jax.jsonl"))
    start, sample, end = rows
    assert start["run"].endswith("-r1-a2")
    assert set(start) == {"v", "ts", "event", "run", "entrypoint",
                          "config", "config_digest", "pid", "argv",
                          "rank", "attempt", "phase", "platform",
                          "mesh_size"}
    assert start["rank"] == 1 and start["attempt"] == 2
    assert start["config_digest"] == obs_ledger.config_digest(
        {"seed": 0, "train_steps": 8})
    assert set(sample) == {"v", "ts", "event", "run", "step", "delta"}
    assert sample["delta"]["counters"] == {"train_steps_total": 5}
    assert set(end) == {"v", "ts", "event", "run", "rc", "final_step",
                        "loss_tail", "anomaly_flags", "flight",
                        "counters", "samples"}
    assert end["rc"] == 0 and end["final_step"] == 8
    assert len({r["run"] for r in rows}) == 1
    strip = lambda rs: [{k: v for k, v in r.items() if k not in _IDENTITY}
                        for r in rs]
    assert strip(rows) == strip(want)


def test_ledger_heals_torn_tail_and_reader_skips(tmp_path):
    path = str(tmp_path / "RUNS.jsonl")
    led = obs_ledger.RunLedger(path, sample_min_s=0,
                               registry=obs_metrics.MetricsRegistry())
    led.start("a")
    with open(path, "a") as f:       # a row that died mid-write
        f.write('{"event": "run_end", "run": "torn-vic')
    led.sample(step=1, force=True)
    rows, torn = obs_ledger.read_rows(path)
    assert torn == 1
    assert [r["event"] for r in rows] == ["run_start", "sample"]


def test_ledger_rotation_and_cross_file_read(tmp_path, monkeypatch):
    monkeypatch.setenv("OBS_LEDGER_MAX_BYTES", "2000")
    path = str(tmp_path / "RUNS.jsonl")
    led = obs_ledger.RunLedger(path, sample_min_s=0,
                               registry=obs_metrics.MetricsRegistry())
    led.start("rotates")
    n = 0
    while not os.path.exists(path + ".1"):
        led.sample(step=n, force=True)
        n += 1
        assert n < 200, "rotation never triggered"
    for _ in range(3):
        led.sample(step=n, force=True)
        n += 1
    led.end(rc=0, final_step=n)
    folded = obs_ledger.runs(path)
    assert folded["order"] == [led.run_id]
    group = folded["runs"][led.run_id]
    assert group["start"] is not None and group["end"] is not None
    assert len(group["samples"]) == n
    live_rows, _ = obs_ledger.read_rows(path, include_rotated=False)
    assert 0 < len(live_rows) < n + 2


def test_maybe_begin_env_gate_and_log_event(tmp_path, monkeypatch):
    monkeypatch.delenv("OBS_LEDGER", raising=False)
    monkeypatch.setattr(obs_ledger, "_GLOBAL", None)
    assert obs_ledger.maybe_begin("gated") is None
    obs_ledger.log_event("ckpt_save", step=4)              # no-op
    path = str(tmp_path / "RUNS.jsonl")
    monkeypatch.setenv("OBS_LEDGER", path)
    led = obs_ledger.maybe_begin("gated", config={"x": 1})
    assert led is not None
    assert obs_ledger.maybe_begin("other") is led          # idempotent
    obs_ledger.log_event("ckpt_save", step=4, src="shardstore")
    obs_ledger.end_global(rc=0)
    monkeypatch.setattr(obs_ledger, "_GLOBAL", None)
    folded = obs_ledger.runs(path)
    assert [e["event"] for e in folded["events"]] == ["ckpt_save"]
    table = obs_ledger.run_table(path)
    assert len(table) == 1 and table[0]["outcome"] == "ok"


def test_serve_endpoints_and_health_fallback(tmp_path, monkeypatch):
    path = str(tmp_path / "RUNS.jsonl")
    obs_ledger.log_event("run_start", path=path, run="r1",
                         entrypoint="serve-smoke")
    monkeypatch.setenv("OBS_LEDGER", path)
    monkeypatch.setattr(obs_serve, "_health_source",
                        lambda: {"version": 1, "kind": "rank", "step": 7})
    rec = obs_recorder.FlightRecorder()
    rec.record_loss(3, 0.5)
    monkeypatch.setattr(obs_recorder, "_GLOBAL", rec)
    obs_metrics.counter("ckpt_shard_saves_total")
    server = obs_serve.ObsServer(0).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        code, body = _fetch(f"{base}/metrics")
        assert code == 200
        assert "# TYPE ckpt_shard_saves_total counter" in body.decode()
        code, body = _fetch(f"{base}/health")
        assert code == 200 and json.loads(body)["step"] == 7
        code, body = _fetch(f"{base}/flight")
        assert code == 200
        flight = json.loads(body)
        assert flight["reason"] == "http"
        assert flight["loss_tail"] == [[3, 0.5]]
        code, body = _fetch(f"{base}/ledger/tail?n=5")
        assert code == 200
        assert [r["event"] for r in json.loads(body)["rows"]] == [
            "run_start"]
        code, body = _fetch(f"{base}/nope")
        assert code == 404 and "/metrics" in json.loads(body)["paths"]
        # Health: the file when no in-process source, then 503.
        monkeypatch.setattr(obs_serve, "_health_source", None)
        hp = tmp_path / "health.json"
        hp.write_text(json.dumps({"version": 1, "step": 3}))
        monkeypatch.setenv("OBS_HEALTH", str(hp))
        code, body = _fetch(f"{base}/health")
        assert code == 200 and json.loads(body)["step"] == 3
        monkeypatch.delenv("OBS_HEALTH")
        code, body = _fetch(f"{base}/health")
        assert code == 503 and "no health source" in json.loads(
            body)["error"]
    finally:
        server.stop()


def test_serve_maybe_start_env_gate(monkeypatch, capsys):
    monkeypatch.setattr(obs_serve, "_GLOBAL", None)
    monkeypatch.delenv("OBS_HTTP_PORT", raising=False)
    assert obs_serve.maybe_start() is None
    monkeypatch.setenv("OBS_HTTP_PORT", "notaport")
    assert obs_serve.maybe_start() is None
    assert "not a port" in capsys.readouterr().err
    monkeypatch.setenv("OBS_HTTP_PORT", "0")
    assert obs_serve.maybe_start() is None
    monkeypatch.setenv("OBS_HTTP_PORT", "70000")
    assert obs_serve.maybe_start() is None
    assert "out of range" in capsys.readouterr().err
    monkeypatch.setattr(obs_serve, "_GLOBAL", None)


def _flight(recorder, metrics, path: str) -> bytes:
    reg = metrics.MetricsRegistry()
    reg.counter("train_steps_total").inc(6)
    reg.gauge("train_step").set(6)
    rec = recorder.FlightRecorder(registry=reg)
    rec.note(model="softmax")
    rec.record_span({"name": "snapshot", "dur_s": 0.004, "step": 6})
    rec.record_loss(6, 1.25)
    rec.record_delta({"counters": {"train_steps_total": 6}})
    p1 = rec.dump("sigterm", path=path)
    p2 = rec.dump("sigterm", path=path + ".again")
    raw = open(p1, "rb").read()
    assert raw == open(p2, "rb").read()          # bitwise stable
    return raw


def test_flight_dump_bitwise_stable_and_equal_to_the_jax_dump(
        tmp_path, monkeypatch):
    _pin_clocks(monkeypatch)
    raw = _flight(obs_recorder, obs_metrics, str(tmp_path / "port.json"))
    flight = json.loads(raw)
    assert raw == (json.dumps(flight, sort_keys=True, indent=1)
                   + "\n").encode()                 # canonical
    assert flight["reason"] == "sigterm"
    assert flight["notes"] == {"model": "softmax"}
    assert flight["loss_tail"] == [[6, 1.25]]
    assert flight["metrics"]["counters"]["train_steps_total"] == 6
    assert flight["spans"][-1]["name"] == "snapshot"
    want = json.loads(_flight(jax_recorder, jax_metrics,
                              str(tmp_path / "jax.json")))
    strip = lambda f: {k: v for k, v in f.items() if k not in _IDENTITY}
    assert strip(flight) == strip(want)


def test_flight_dump_on_sigterm_subprocess(tmp_path):
    script = textwrap.dedent("""
        import os, signal, sys
        sys.path.insert(0, %r)
        from distributedtensorflowexample_tpu_torch.obs import (
            metrics, recorder, trace)
        rec = recorder.install(sigterm=True)
        rec.note(drill="sigterm")
        metrics.counter("child_steps_total").inc(5)
        with trace.span("phase_a", step=7):
            pass
        os.kill(os.getpid(), signal.SIGTERM)
    """) % str(REPO)
    env = {**os.environ, "OBS_DIR": str(tmp_path),
           "SUPERVISE_ATTEMPT": "1", "OBS_PHASE": "drill"}
    env.pop("OBS_TRACE_FILE", None)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, timeout=60)
    assert proc.returncode == -signal.SIGTERM
    dumps = [n for n in os.listdir(tmp_path)
             if n.startswith("flight_") and n.endswith(".json")]
    assert len(dumps) == 1
    flight = json.loads((tmp_path / dumps[0]).read_text())
    assert flight["reason"] == "sigterm"
    assert flight["attempt"] == 1 and flight["phase"] == "drill"
    assert flight["notes"] == {"drill": "sigterm"}
    assert flight["metrics"]["counters"]["child_steps_total"] == 5
    assert flight["spans"][-1]["name"] == "phase_a"
    assert flight["spans"][-1]["step"] == 7


@pytest.mark.parametrize("name", ["ledger.py", "recorder.py", "serve.py",
                                  "metrics.py", "trace.py"])
def test_obs_modules_stay_stdlib_only(name):
    """Each module imports the standard library and its own package's
    ``obs`` modules, nothing else."""
    tree = ast.parse((OBS_DIR / name).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top in sys.stdlib_module_names or mod.startswith(
                "distributedtensorflowexample_tpu_torch.obs"), (name, mod)
