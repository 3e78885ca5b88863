"""The port's records comparator (``tools.bench_ratchet``) and
``obs_query trajectory`` held against the JAX package's
``tools/bench_ratchet.py`` and ``tools/obs_query.py`` on the CPU:

- the JAX fixtures (the variance/roofline/noise/outage sequence, the
  floor ratchet, the scheduler's queue record) give the same verdicts,
  JSON and exit codes in both;
- ``build_trajectory`` over the repository's root, given explicitly, is
  the JAX rows row for row, and ``obs_query trajectory`` prints the JAX
  tool's md and json bytes; without ``--records_dir`` both port tools
  refuse by name;
- records of two different cards (``detail.device``) never compare, nor
  card records with CPU ones;
- a trajectory the port's ``--trajectory`` writes prices a
  ``tools.schedule`` job (``source: trajectory:<file>``).
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

from distributedtensorflowexample_tpu.resilience import scheduler as jsched
from distributedtensorflowexample_tpu_torch.resilience import (
    scheduler as psched)
from distributedtensorflowexample_tpu_torch.tools import bench_ratchet as prt
from distributedtensorflowexample_tpu_torch.tools import obs_query
from distributedtensorflowexample_tpu_torch.tools import schedule as pschedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = {"platform": "gpu", "name": "NVIDIA H100 80GB HBM3",
        "power_limit": "700.00 W"}
A100 = {"platform": "gpu", "name": "NVIDIA A100-SXM4-80GB",
        "power_limit": "400.00 W"}


def _jax_tool(name):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


@pytest.fixture(scope="module")
def jrt():
    return _jax_tool("bench_ratchet")


def _write_record(path, value, metric="steps_per_sec_per_chip", **detail):
    rec = {"metric": metric, "value": value, "unit": "steps/s/chip",
           "detail": detail}
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def _run(main, argv):
    """(exit code, stdout) of a tool's ``main`` in this process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _both(jrt, argv):
    """Both ratchets on the same argv: the same exit code and the same
    verdict, returned once."""
    rc_j, out_j = _run(jrt.main, argv)
    rc_p, out_p = _run(prt.main, argv)
    assert (rc_p, out_p) == (rc_j, out_j)
    return rc_p, (json.loads(out_p) if "--json" in argv else out_p)


def test_ratchet_verdicts_equal_jax_on_the_variance_fixture(tmp_path, jrt):
    """The JAX sequence: roofline held (explained), roofline regressed
    (exit 1), the same drop measured noisily (explained), a documented
    outage round (explained); then the text verdict."""
    d = str(tmp_path)
    floor = str(tmp_path / "floor.json")
    json.dump({"dots_passed_floor": 220}, open(floor, "w"))
    _write_record(os.path.join(d, "BENCH_x_r01.json"), 100.0,
                  vs_roofline=0.50, platform="chip")
    with open(os.path.join(d, "BENCH_x_r01.json"), "a") as f:
        f.write(json.dumps({"metric": "steps_per_sec_per_chip",
                            "unit": "unavailable"}) + "\n")
    _write_record(os.path.join(d, "BENCH_x_r02.json"), 50.0,
                  vs_roofline=0.55, platform="chip")
    common = ["--records_dir", d, "--floor_file", floor]
    rc, verdict = _both(jrt, common + ["--json"])
    assert rc == 0 and verdict["findings"][0]["severity"] == "explained"
    assert "vs_roofline held" in verdict["findings"][0]["why"]

    _write_record(os.path.join(d, "BENCH_x_r03.json"), 40.0,
                  vs_roofline=0.20, platform="chip")
    rc, verdict = _both(jrt, common + ["--json"])
    assert rc == 1
    worst = [f for f in verdict["findings"] if f["severity"] == "regression"]
    assert worst and "vs_roofline also regressed" in worst[0]["why"]

    _write_record(os.path.join(d, "BENCH_x_r04.json"), 40.0,
                  vs_roofline=0.20, platform="chip", repeats=[10.0, 40.0])
    rc, verdict = _both(jrt, common + ["--json"])
    assert rc == 0
    assert all(f["severity"] != "regression" for f in verdict["findings"])

    _write_record(os.path.join(d, "BENCH_x_r05.json"), 30.0,
                  platform="chip")
    open(os.path.join(d, "OUTAGE_r05.md"), "w").write("degraded window")
    rc, verdict = _both(jrt, common + ["--json"])
    assert rc == 0 and any("documented outage" in f["why"]
                           for f in verdict["findings"])
    rc, text = _both(jrt, common + ["--trajectory", str(tmp_path / "t")])
    assert rc == 0 and "[trajectory] 5 family-round rows written" in text
    assert (tmp_path / "t").read_text().count("\n") == 5


def test_ratchet_floor_equals_jax_and_needs_a_file(tmp_path, jrt, capsys):
    floors = {}
    for name, main in (("jax", jrt.main), ("port", prt.main)):
        floor = tmp_path / f"floor_{name}.json"
        json.dump({"dots_passed_floor": 220}, open(floor, "w"))
        common = ["--records_dir", str(tmp_path), "--floor_file",
                  str(floor)]
        rcs = [main(common + extra) for extra in (
            ["--dots", "220"], ["--dots", "219"], ["--raise_floor", "219"],
            ["--raise_floor", "224"])]
        floors[name] = (rcs, json.load(open(floor)))
    assert floors["port"] == floors["jax"]
    assert floors["port"] == ([0, 1, 1, 0], {"dots_passed_floor": 224})
    assert "FLOOR VIOLATION" in capsys.readouterr().out
    # No floor file by default: --records_dir alone checks no floor, and
    # --dots without a file is a usage error (2), like a missing dir.
    assert prt.main(["--records_dir", str(tmp_path)]) == 0
    for argv in (["--records_dir", str(tmp_path), "--dots", "1"], []):
        with pytest.raises(SystemExit) as exc:
            prt.main(argv)
        assert exc.value.code == 2


def test_sched_queue_record_rides_both_trajectories(tmp_path, jrt):
    """The JAX scheduler fixture: its queue record and the port's, in the
    one metric-row dialect; the port's names its device."""
    jschedule = _jax_tool("schedule")
    summary = {"status": "ok", "counts": {"done": 8},
               "makespan_s": 120.0, "evictions": 1, "shrinks": 1,
               "grows": 1, "retries": 1, "jobs": {"a": "done"}}
    jschedule.write_record(str(tmp_path / "SCHED_queue_cpu_r14.json"),
                           summary, devices=4)
    pschedule.write_record(str(tmp_path / "SCHED_queue_cpu_r16.json"),
                           summary, devices=4)
    paths = sorted(str(p) for p in tmp_path.glob("SCHED_*.json"))
    recs = prt.load_records(paths)
    assert [r["_round"] for r in recs] == [14, 14, 16, 16]
    assert {prt._platform(r) for r in recs} == {"cpu"}
    assert recs[2]["detail"]["device"]["platform"] == "cpu"
    rows = prt.build_trajectory(str(tmp_path))
    assert rows == jrt.build_trajectory(str(tmp_path))
    assert [(r["family"], r["round"]) for r in rows] == [
        ("SCHED_queue_cpu", 14), ("SCHED_queue_cpu", 16)]
    assert all(r["metrics"] == {"sched_queue_jobs_done": 8,
                                "sched_queue_jobs_per_min": 4.0}
               for r in rows)


def test_trajectory_over_the_repo_root_is_the_jax_rows(jrt):
    rows = prt.build_trajectory(REPO)
    assert rows == jrt.build_trajectory(REPO)
    assert {r["family"] for r in rows} >= {
        "BENCH_headline", "BENCH_collectives_cpu", "BENCH_input",
        "SCALING_sync", "SCHED_queue_cpu", "SIM_fleet_cpu",
        "BASELINE_SELF"}


@pytest.mark.parametrize("fmt", ["md", "json"])
def test_obs_query_trajectory_prints_the_jax_bytes(fmt):
    argv = ["trajectory", "--records_dir", REPO, "--format", fmt]
    jax_out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "obs_query.py"), *argv],
        capture_output=True, text=True, timeout=120)
    assert jax_out.returncode == 0, jax_out.stderr
    for family in ("", "BENCH_input"):
        extra = ["--family", family] if family else []
        rc, out = _run(obs_query.main, argv + extra)
        assert rc == 0
        if not family:
            assert out == jax_out.stdout
    assert "BENCH_input" in out and "BENCH_lm_cpu" not in out


def test_obs_query_trajectory_needs_a_records_dir(capsys):
    assert obs_query.main(["trajectory"]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "trajectory needs --records_dir" in captured.err
    assert "JAX package's records" in captured.err


def test_records_of_two_cards_never_compare(tmp_path, jrt):
    """A tenfold drop between two different cards, or between the card
    and the host, is no finding; on the same card it is a regression.
    The JAX tool, which reads no card, calls the first one a regression."""
    d = str(tmp_path)
    _write_record(os.path.join(d, "BENCH_y_gpu_r15.json"), 100.0,
                  platform="gpu", device=H100)
    _write_record(os.path.join(d, "BENCH_y_gpu_r16.json"), 10.0,
                  platform="gpu", device=A100)
    _write_record(os.path.join(d, "BENCH_y_cpu_r17.json"), 1.0,
                  platform="cpu", device=prt.describe_device("cpu"))
    recs = prt.load_records(sorted(str(p) for p in tmp_path.iterdir()))
    assert [prt._platform(r) for r in recs] == [
        "gpu:NVIDIA H100 80GB HBM3", "gpu:NVIDIA A100-SXM4-80GB", "cpu"]
    assert prt.compare_records(recs, 0.10, 0.25) == []
    assert jrt.compare_records(recs, 0.10, 0.25)[0]["severity"] == \
        "regression"
    assert prt.main(["--records_dir", d]) == 0
    assert jrt.main(["--records_dir", d, "--floor_file",
                     str(tmp_path / "none.json")]) == 1
    _write_record(os.path.join(d, "BENCH_y_gpu_r18.json"), 10.0,
                  platform="gpu", device=H100)
    found = prt.compare_records(prt.load_records(
        sorted(str(p) for p in tmp_path.glob("BENCH_*"))), 0.10, 0.25)
    assert [(f["platform"], f["severity"], f["prior_file"])
            for f in found] == [("gpu:NVIDIA H100 80GB HBM3", "regression",
                                 "BENCH_y_gpu_r15.json")]
    assert prt.main(["--records_dir", d]) == 1
    # An unreadable card name is no card: the JAX platform stands.
    rec = {"detail": {"platform": "gpu", "device": {
        "platform": "gpu", "name": "not measured"}}}
    assert prt._platform(rec) == "gpu"


def test_describe_device_names_the_host_and_the_card(monkeypatch):
    host = prt.describe_device("cpu")
    assert host["platform"] == "cpu" and host["cpu"]
    monkeypatch.setattr(prt, "card_name_and_power_limit",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    assert prt.describe_device("cuda") == H100
    monkeypatch.setattr(prt, "card_name_and_power_limit", lambda: None)
    assert prt.describe_device("cuda")["name"] == "not measured"


def test_a_port_trajectory_prices_a_schedule_job(tmp_path):
    """A measured steps/s family in the records, the port's
    ``--trajectory`` over them, and ``tools.schedule --trajectory`` on a
    queue whose job names that family: the job is admitted at the
    measured price, and both packages' ``predict_cost`` agree."""
    records = tmp_path / "records"
    records.mkdir()
    fam = records / "BENCH_augment_gpu_r16.json"
    for variant, rate in (("base", 2500.0), ("noaug", 4000.0)):
        _write_record(str(fam), rate,
                      metric=f"input_path_{variant}_steps_per_sec",
                      platform="gpu", device=H100, repeats=[rate] * 3)
    traj = str(tmp_path / "trajectory.jsonl")
    assert prt.main(["--records_dir", str(records), "--trajectory",
                     traj]) == 0
    job = dict(job="aug", argv=[sys.executable, "-c", "pass"],
               family="BENCH_augment", steps=500)
    want = {"step_time_s": round(1 / 2500.0, 6), "predicted_s": 0.2,
            "source": "trajectory:BENCH_augment_gpu_r16.json"}
    for mod in (psched, jsched):
        assert mod.predict_cost(mod.Job(**job), traj) == want
    queue = tmp_path / "queue.json"
    queue.write_text(json.dumps([job]))
    work = tmp_path / "work"
    out = subprocess.run(
        [sys.executable, "-m",
         "distributedtensorflowexample_tpu_torch.tools.schedule",
         "--queue", str(queue), "--devices", "1", "--device", "cpu",
         "--workdir", str(work), "--trajectory", traj, "--tick_s", "0.05"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OBS_LEDGER=""))
    assert out.returncode == 0, out.stderr[-3000:]
    admits = [json.loads(l) for l in (work / "RUNS.jsonl").read_text()
              .splitlines() if '"sched_admit"' in l]
    assert len(admits) == 1
    assert admits[0]["source"] == "trajectory:BENCH_augment_gpu_r16.json"
    assert admits[0]["predicted_s"] == 0.2
