"""The port's supervisor (``resilience/supervisor.py``) and its
``supervise`` driver, held against the JAX package's on the CPU.

The scripted children are stdlib-only ``python`` scripts (milliseconds
each, no torch, no JAX), run under the JAX and the port ``Supervisor``
with the same policy and seed: the ``SupervisedResult`` fields and the
journal projections ``(event, task, attempt, rc, reason)`` must be equal
(times, pids and paths differ between the two runs and are left out).
``RetryPolicy`` gives equal floats from the same seed.  Journals cross
between the packages in both directions, a torn tail included.  (The
port's ``faultline`` under the port's supervisor, a wedge killed by the
watchdog and retried, is ``chip_smoke.py`` phase U (b) on the card; the
wedge fault itself is held in ``tests/test_torch_faults.py``.)
"""

import concurrent.futures
import json
import os
import random
import signal
import subprocess
import sys
import time

import pytest

from distributedtensorflowexample_tpu.resilience import supervisor as js
from distributedtensorflowexample_tpu_torch.resilience import supervisor as ps
from distributedtensorflowexample_tpu_torch.tools import supervise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.faults

FAST = dict(backoff_base_s=0.01, backoff_max_s=0.02)

# name -> (child body, Supervisor kwargs, retries, stale beat file,
#          expected (status, attempts))
SCENARIOS = {
    "retries_until_success": ("""
import os, sys
sys.exit(0 if int(os.environ["SUPERVISE_ATTEMPT"]) >= 2 else 1)
""", {}, 3, False, ("ok", 3)),
    "retries_exhausted": ("raise SystemExit(1)", {}, 2, False,
                          ("exhausted", 3)),
    "wedge_verdict_not_retried": ("raise SystemExit(3)", {}, 5, False,
                                  ("wedged", 1)),
    "stops_beating_killed_by_watchdog": ("""
import os, sys, time
open(os.environ["SUPERVISE_HEARTBEAT"], "a").close()   # first beat
if os.environ["SUPERVISE_ATTEMPT"] == "0":
    time.sleep(60)      # wedged mid-run: beats stop
sys.exit(0)
""", dict(heartbeat_timeout_s=0.6), 1, False, ("ok", 2)),
    "beatless_child_not_armed": ("import time; time.sleep(1.0)",
                                 dict(heartbeat_timeout_s=0.4), 0, False,
                                 ("ok", 1)),
    "preemptions_exempt_from_budget": ("""
import os, sys
sys.exit(143 if int(os.environ["SUPERVISE_ATTEMPT"]) < 3 else 0)
""", {}, 1, False, ("ok", 4)),
    "stale_heartbeat_file_reset": ("""
import os, time
time.sleep(0.4)     # longer than poll_s: a stale-mtime bug kills here
open(os.environ["SUPERVISE_HEARTBEAT"], "a").close()
""", dict(heartbeat_timeout_s=1.5), 0, True, ("ok", 1)),
}


def _projection(path) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [(r["event"], r.get("task"), r.get("attempt"), r.get("rc"),
             r.get("reason")) for r in recs]


def _supervise(mod, tmp, body, kw, retries, stale):
    tmp.mkdir()
    script = tmp / "child.py"
    script.write_text(body)
    hb = tmp / "beat"
    if stale:
        hb.write_text("")
        old = time.time() - 3600
        os.utime(hb, (old, old))
    sup = mod.Supervisor(policy=mod.RetryPolicy(retries=retries, **FAST),
                         journal=mod.Journal(str(tmp / "j.jsonl")),
                         kill_grace_s=0.2, poll_s=0.05, seed=0, **kw)
    res = sup.run([sys.executable, str(script)], name="child",
                  heartbeat_path=str(hb))
    return res, _projection(tmp / "j.jsonl")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scripted_children_supervise_as_in_jax(tmp_path, name):
    """The two packages side by side, each on its own copy of the child
    (a supervisor installs its SIGTERM forwarding only on the main
    thread, which neither needs here)."""
    body, kw, retries, stale, expect = SCENARIOS[name]
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        runs = [ex.submit(_supervise, mod, tmp_path / pkg, body, kw,
                          retries, stale)
                for mod, pkg in ((js, "jax"), (ps, "port"))]
        (want, jj), (got, pj) = (f.result() for f in runs)
    assert (got.status, got.returncode, got.attempts, got.reasons) == \
        (want.status, want.returncode, want.attempts, want.reasons)
    assert (got.status, got.attempts) == expect
    assert pj == jj and pj


def test_exit_code_protocol_is_the_jax_packages():
    assert ps.RC_PREEMPTED == js.RC_PREEMPTED == 143
    assert ps.RC_WEDGED == js.RC_WEDGED == 3
    assert ps.MAX_PREEMPTIONS == js.MAX_PREEMPTIONS


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("policy", [
    {}, dict(backoff_base_s=0.5, backoff_factor=3.0, backoff_max_s=5.0),
    dict(jitter=0.0), dict(backoff_base_s=2.0, jitter=0.9)])
def test_retry_policy_backoff_equals_jax(seed, policy):
    want_rng, got_rng = random.Random(seed), random.Random(seed)
    jp, pp = js.RetryPolicy(**policy), ps.RetryPolicy(**policy)
    want = [jp.delay_s(a, want_rng.random()) for a in range(12)]
    got = [pp.delay_s(a, got_rng.random()) for a in range(12)]
    assert got == want


def test_default_task_name_resolves_as_in_jax():
    for argv in (["python", "-m", "distributedtensorflowexample_tpu_torch."
                  "tools.faultline", "--steps", "5"],
                 ["env", "OMP_NUM_THREADS=1", "python", "train.py"],
                 ["/usr/bin/python3", "tools/faultline.py"]):
        assert ps.Supervisor._default_name(argv) == \
            js.Supervisor._default_name(argv)
    assert ps.Supervisor._default_name(
        ["python", "-m", "x.y.faultline"]) == "faultline"


@pytest.mark.parametrize("writer,reader", [(js, ps), (ps, js)])
def test_torn_journal_replays_across_packages(tmp_path, writer, reader):
    """A journal with a torn tail, written by one package, replays the
    same in the other; the reader's next append heals the tail first."""
    path = str(tmp_path / "j.jsonl")
    w = writer.Journal(path)
    w.write("task_done", task="a")
    w.write("chip_wedged", task="b")
    w.write("task_done", task="c")
    from distributedtensorflowexample_tpu_torch.resilience.faults import (
        tear_journal)
    assert tear_journal(path)
    want = writer.Journal(path).replay()
    got = reader.Journal(path).replay()
    assert got == want == {"done": {"a"}, "wedged": True}
    reader.Journal(path).write("task_done", task="d")
    assert writer.Journal(path).replay()["done"] == {"a", "d"}
    assert [e["event"] for e in reader.Journal(path).events()] == \
        [e["event"] for e in writer.Journal(path).events()]


def _script(tmp_path, name: str, body: str) -> list[str]:
    path = tmp_path / name
    path.write_text(body)
    return [sys.executable, str(path)]


def test_task_queue_priority_wedge_and_journal_resume(tmp_path):
    """Priority order; a wedge verdict skips later device-bound tasks but
    not the CPU-only one; a second queue over the same journal resumes
    with done/wedged state intact."""
    jpath = str(tmp_path / "q.jsonl")
    mark = lambda n: _script(
        tmp_path, f"{n}.py",
        f"open({str(tmp_path / (n + '.ran'))!r}, 'w').write('x')")
    tasks = [
        ps.Task("first", mark("first"), priority=10),
        ps.Task("wedger", _script(tmp_path, "wedger.py",
                                  "raise SystemExit(3)"), priority=20),
        ps.Task("chip_bound", mark("chip"), priority=30),
        ps.Task("cpu_only", mark("cpu"), priority=25, needs_chip=False),
        ps.Task("gated", mark("gated"), priority=15, gate=lambda: False),
    ]
    sup = ps.Supervisor(policy=ps.RetryPolicy(retries=0),
                        journal=ps.Journal(jpath), seed=0)
    results = ps.TaskQueue(tasks, sup).run()
    assert list(results.items()) == [
        ("first", "done"), ("gated", "skipped_gate"), ("wedger", "wedged"),
        ("cpu_only", "done"), ("chip_bound", "skipped_wedged")]
    assert (tmp_path / "first.ran").exists()
    assert (tmp_path / "cpu.ran").exists()
    assert not (tmp_path / "chip.ran").exists()
    (tmp_path / "first.ran").unlink()
    sup2 = ps.Supervisor(policy=ps.RetryPolicy(retries=0),
                         journal=ps.Journal(jpath), seed=0)
    results2 = ps.TaskQueue(tasks, sup2).run()
    assert results2["first"] == "done_prior"
    assert results2["chip_bound"] == "skipped_wedged"
    assert not (tmp_path / "first.ran").exists()
    # The JAX queue reads the port's journal the same way.
    assert js.Journal(jpath).replay() == ps.Journal(jpath).replay()


def test_task_queue_stops_on_terminated_supervisor(tmp_path, monkeypatch):
    sup = ps.Supervisor(policy=ps.RetryPolicy(retries=0),
                        journal=ps.Journal(str(tmp_path / "j.jsonl")),
                        seed=0)
    monkeypatch.setattr(
        sup, "run",
        lambda *a, **k: ps.SupervisedResult("terminated", None, 1))
    tasks = [ps.Task("a", ["true"], priority=1),
             ps.Task("b", ["true"], priority=2)]
    assert ps.TaskQueue(tasks, sup).run() == {"a": "terminated"}
    assert sup.journal.replay()["done"] == set()


def test_supervisor_sigterm_reaches_the_child_group(tmp_path):
    """A SIGTERM to the supervisor is forwarded to the child's own
    process group: a dead supervisor never leaves its child behind."""
    child_pid_file = tmp_path / "child.pid"
    runner = tmp_path / "runner.py"
    runner.write_text(f"""
import sys
sys.path.insert(0, {REPO!r})
from distributedtensorflowexample_tpu_torch.resilience.supervisor import (
    RetryPolicy, Supervisor)
sup = Supervisor(policy=RetryPolicy(retries=0), poll_s=0.05,
                 kill_grace_s=0.2, seed=0)
res = sup.run([sys.executable, "-c",
               "import os, time;"
               "open({str(child_pid_file)!r}, 'w').write(str(os.getpid()));"
               "time.sleep(60)"], name="holder")
print(res.status)
""")
    proc = subprocess.Popen([sys.executable, str(runner)],
                            stdout=subprocess.PIPE, text=True)
    deadline = time.time() + 60
    while time.time() < deadline and not child_pid_file.exists():
        time.sleep(0.05)
    time.sleep(0.1)
    child_pid = int(child_pid_file.read_text())
    proc.terminate()
    out, _ = proc.communicate(timeout=60)
    assert "terminated" in out
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            os.kill(child_pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.05)
    else:
        os.kill(child_pid, signal.SIGKILL)
        pytest.fail(f"child {child_pid} survived the supervisor's death")


def _cli(*args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m",
         "distributedtensorflowexample_tpu_torch.tools.supervise", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout)


def test_supervise_cli_generic_mode_and_derived_heartbeat(tmp_path):
    script = tmp_path / "child.py"
    script.write_text("""
import os, sys
if not os.environ.get("SUPERVISE_HEARTBEAT"):
    sys.exit(9)
sys.exit(0 if int(os.environ["SUPERVISE_ATTEMPT"]) >= 1 else 7)
""")
    jpath = tmp_path / "j.jsonl"
    proc = _cli("--retries", "2", "--backoff_base_s", "0.01", "--seed",
                "0", "--heartbeat_timeout_s", "30", "--journal",
                str(jpath), "--", sys.executable, str(script))
    assert proc.returncode == 0, proc.stderr
    assert "heartbeat file defaulted" in proc.stderr
    assert [e[:3] for e in _projection(jpath)] == [
        ("attempt_start", "child.py", 0), ("attempt_end", "child.py", 0),
        ("attempt_start", "child.py", 1), ("attempt_end", "child.py", 1)]


def test_supervise_capture_queue_shape(monkeypatch, tmp_path):
    """The port's capture queue is the JAX queue's (names and priorities,
    ``bytes_audit_cpu`` included, with no card needed) over the port's
    harnesses, every artifact under ``--records_dir``, with the JAX
    ``fresh_measured`` gate and the journal rotation predicate."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import supervise as jsupervise
    finally:
        sys.path.pop(0)
    for name in ("OUT", "OUT_HEADLINE", "PROFILE_OUT", "BYTES_OUT",
                 "BYTES_ARGS", "COLLECTIVES_OUT", "LM_OUT", "TRACE_TGZ",
                 "CLI_OUT", "TRACE_DIR", "LOG"):
        monkeypatch.delenv(name, raising=False)
    start = time.time() - 5
    tasks = supervise._capture_tasks(start, records_dir=str(tmp_path))
    order = lambda ts: [(t.name, t.priority)
                        for t in sorted(ts, key=lambda t: t.priority)]
    jax_order = order(jsupervise._capture_tasks(start))
    assert order(tasks) == jax_order
    assert [n for n, _ in order(tasks)] == [
        "headline_bench", "profile", "bytes_audit_cpu", "collectives", "lm",
        "full_bench", "cli_trainer"]
    by_name = {t.name: t for t in tasks}
    tool = lambda t: t.argv[t.argv.index("-m") + 1]
    pkg = "distributedtensorflowexample_tpu_torch"
    assert {n: tool(t) for n, t in by_name.items()} == {
        "headline_bench": f"{pkg}.tools.bench",
        "profile": f"{pkg}.tools.bench_profile",
        "bytes_audit_cpu": f"{pkg}.tools.bytes_audit",
        "collectives": f"{pkg}.tools.bench_collectives",
        "lm": f"{pkg}.tools.bench_lm", "full_bench": f"{pkg}.tools.bench",
        "cli_trainer": f"{pkg}.trainers.trainer_sync_mnist"}
    assert "--headline_only" in by_name["headline_bench"].argv
    assert all("--tiny" not in t.argv for t in tasks)
    # The JAX task's flags, --backend cpu read as --device cpu.
    jbytes = {t.name: t for t in jsupervise._capture_tasks(start)}[
        "bytes_audit_cpu"]
    argv = by_name["bytes_audit_cpu"].argv
    assert argv[argv.index("-m") + 2:argv.index("--json")] == [
        "--device" if a == "--backend" else a for a in
        jbytes.argv[jbytes.argv.index("--backend"):
                    jbytes.argv.index("--json")]]
    assert [t.needs_chip for t in tasks] == [
        t.name != "bytes_audit_cpu" for t in tasks]
    # Every path the queue writes lies under the records dir.
    for t in tasks:
        for path in (t.stdout_path, t.stderr_path):
            assert path is None or path.startswith(str(tmp_path) + os.sep)
        for flag in ("--json", "--trace_dir", "--log_dir"):
            if flag in t.argv:
                assert t.argv[t.argv.index(flag) + 1].startswith(
                    str(tmp_path) + os.sep)
    assert by_name["profile"].pre is not None
    assert by_name["profile"].post is not None
    assert by_name["bytes_audit_cpu"].post is not None
    assert by_name["collectives"].post is not None
    assert by_name["lm"].post is not None
    assert by_name["cli_trainer"].wall_timeout_s == 1800.0
    # The gate: no fresh measured OUT -> the trainer must not run.
    out = tmp_path / "BENCH_capture.json"
    assert by_name["full_bench"].stdout_path == str(out)
    assert by_name["cli_trainer"].gate() is False
    out.write_text('{"unit": "steps/sec/chip"}')
    assert by_name["cli_trainer"].gate() is True
    old = time.time() - 3600
    os.utime(out, (old, old))
    resumed = supervise._capture_tasks(time.time() - 5, True,
                                       records_dir=str(tmp_path))
    assert {t.name: t for t in resumed}["cli_trainer"].gate() is True
    stale = supervise._capture_tasks(time.time() - 5,
                                     records_dir=str(tmp_path))
    assert {t.name: t for t in stale}["cli_trainer"].gate() is False
    # The env names are read relative to the records dir.
    monkeypatch.setenv("OUT", "mine.json")
    renamed = supervise._capture_tasks(start, records_dir=str(tmp_path))
    assert {t.name: t for t in renamed}["full_bench"].stdout_path == \
        str(tmp_path / "mine.json")
    # The rotation predicate, as in JAX.
    ended = tmp_path / "ended.jsonl"
    ended.write_text('{"event": "task_done", "task": "headline_bench"}\n'
                     '{"event": "capture_end", "results": {}}\n')
    midrun = tmp_path / "midrun.jsonl"
    midrun.write_text('{"event": "task_done", "task": "headline_bench"}\n')
    for path in (ended, midrun, tmp_path / "absent.jsonl"):
        assert supervise._capture_ended(str(path)) == \
            jsupervise._capture_ended(str(path)) == (path == ended)


def test_supervise_capture_tiny_shrinks_every_task(tmp_path):
    tasks = {t.name: t for t in supervise._capture_tasks(
        time.time(), records_dir=str(tmp_path), tiny=True)}
    for name in ("headline_bench", "profile", "lm", "full_bench"):
        assert "--tiny" in tasks[name].argv
    argv = tasks["bytes_audit_cpu"].argv
    assert argv[argv.index("--batch_per_chip") + 1] == "64"
    argv = tasks["collectives"].argv
    assert argv[-len(supervise.TINY_COLLECTIVES):] == \
        supervise.TINY_COLLECTIVES
    argv = tasks["cli_trainer"].argv
    assert argv[argv.index("--train_steps") + 1] == "200"


def test_capture_bytes_audit_cpu_writes_into_the_records_dir(monkeypatch,
                                                           tmp_path):
    """The queue's ``bytes_audit_cpu`` task runs ``tools.bytes_audit`` on
    the CPU and its record lands in ``--records_dir`` (promoted from its
    ``.tmp``).  BYTES_ARGS (the JAX knob for its flags) shrinks it to a
    softmax step here."""
    monkeypatch.setenv("BYTES_ARGS", "--workload softmax --batch_per_chip 8")
    monkeypatch.delenv("BYTES_OUT", raising=False)
    monkeypatch.chdir(REPO)
    task = {t.name: t for t in supervise._capture_tasks(
        time.time(), records_dir=str(tmp_path))}["bytes_audit_cpu"]
    sup = ps.Supervisor(policy=ps.RetryPolicy(retries=0),
                        journal=ps.Journal(str(tmp_path / "j.jsonl")))
    assert ps.TaskQueue([task], sup).run() == {"bytes_audit_cpu": "done"}
    out = tmp_path / "BYTES_AUDIT_capture.json"
    rec = json.loads(out.read_text())
    assert rec["workload"] == "softmax" and rec["batch_per_chip"] == 8
    assert rec["device"]["platform"] == "cpu"
    assert rec["bw_roofline_effective_steps_per_sec"] is None
    assert rec["audit"]["bytes_per_step"] > 0
    assert not (tmp_path / "BYTES_AUDIT_capture.json.tmp").exists()


def test_supervise_capture_needs_a_records_dir(capsys):
    with pytest.raises(SystemExit) as e:
        supervise.main(["--capture"])
    assert e.value.code == 2
    assert "--records_dir" in capsys.readouterr().err


# A capture over three stub tasks: ``second`` hangs (writing its pid) on
# its first attempt unless the ``release`` file exists.
_STUB_DRIVER = """
import os, sys
from distributedtensorflowexample_tpu_torch.resilience.supervisor import Task
from distributedtensorflowexample_tpu_torch.tools import supervise

def tasks(start_ts, full_bench_done_prior=False, *, records_dir, tiny=False):
    at = lambda name: os.path.join(records_dir, name)
    body = lambda name: (
        "import os, time\\n"
        f"open({at(name + '.ran')!r}, 'a').write('x')\\n"
        f"open({at(name + '.pid')!r}, 'w').write(str(os.getpid()))\\n"
        f"while {name == 'second'} and not os.path.exists("
        f"{at('release')!r}):\\n"
        "    time.sleep(0.05)\\n"
        f"print({name!r})\\n")
    return [Task(n, [sys.executable, "-c", body(n)], priority=p,
                 stdout_path=at(n + ".out"), stderr_path=at("capture.log"))
            for n, p in (("first", 10), ("second", 20), ("third", 30))]

supervise._capture_tasks = tasks
raise SystemExit(supervise.main(sys.argv[1:]))
"""


def test_run_capture_resumes_after_a_death_and_rotates_an_ended_one(
        tmp_path):
    records = tmp_path / "records"
    home = tmp_path / "home"
    home.mkdir()
    driver = tmp_path / "driver.py"
    driver.write_text(_STUB_DRIVER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("OBS_DIR", "SUPERVISE_JOURNAL", "CAPTURE_PIDFILE")}
    env.update(HOME=str(home), TMPDIR=str(home),
               PYTHONPATH=os.pathsep.join(
                   [REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    argv = [sys.executable, str(driver), "--capture", "--records_dir",
            str(records), "--seed", "0"]
    before = set(os.listdir(REPO))
    journal = records / "supervise_capture.jsonl"
    events = lambda: [json.loads(l)["event"]
                      for l in journal.read_text().splitlines()]

    # 1: the supervisor dies (SIGKILL) while ``second`` runs.
    proc = subprocess.Popen(argv, env=env, cwd=tmp_path,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    deadline = time.time() + 60
    while not (records / "second.pid").exists():
        assert time.time() < deadline and proc.poll() is None
        time.sleep(0.05)
    proc.kill()
    proc.communicate(timeout=30)
    os.killpg(int((records / "second.pid").read_text()), signal.SIGKILL)
    assert "capture_end" not in events()
    assert (records / "first.ran").read_text() == "x"

    # 2: the relaunch skips ``first`` and ends the capture.
    (records / "release").write_text("")
    done = subprocess.run(argv, env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert "first: already done (journal)" in done.stderr
    assert (records / "first.ran").read_text() == "x"
    assert (records / "second.ran").read_text() == "xx"
    assert (records / "third.ran").read_text() == "x"
    end = json.loads(journal.read_text().splitlines()[-1])
    assert end["event"] == "capture_end" and end["results"] == {
        "first": "done_prior", "second": "done", "third": "done"}
    assert (records / "supervise_capture_flight").is_dir()
    assert not (records / "capture.pid").exists()

    # 3: an ended capture is rotated, flight dir alongside: all run again.
    again = subprocess.run(argv, env=env, cwd=tmp_path, capture_output=True,
                           text=True, timeout=120)
    assert again.returncode == 0, again.stderr
    assert "journal rotated" in again.stderr
    assert (records / "supervise_capture.jsonl.prev").is_file()
    assert (records / "supervise_capture_flight.prev").is_dir()
    assert events()[-1] == "capture_end"
    assert [json.loads(l).get("task") for l in journal.read_text()
            .splitlines() if json.loads(l)["event"] == "task_done"] == [
        "first", "second", "third"]
    assert (records / "first.ran").read_text() == "xx"
    # Nothing written outside the records dir.
    assert set(os.listdir(REPO)) == before
    assert list(home.iterdir()) == []
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "driver.py", "home", "records"]
