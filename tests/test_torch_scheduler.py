"""The port's journaled scheduler (``resilience/scheduler.py``) and its
``tools.schedule`` driver, held against the JAX package's on the CPU.

Pure functions first: the closed ``sched_*`` schema, ``Job``'s loud
refusals, ``load_queue``, the env knobs, ``predict_cost`` on the
committed ``BENCH_trajectory.json`` and ``load_collective_fit`` on
``BENCH_collectives_cpu_r06.json``.  Then one mixed queue of scripted
stdlib children (exit 0, exit 3, fail once then succeed, run until TERM
then 143), ordered by ``after_file`` gates and one slot, never by wall
clock, under the JAX and the port ``Scheduler`` (each over its own
package's ``FleetSupervisor``): the same ordered decision rows.  The
write-ahead replay of a hand-written ``sched.jsonl`` and the orphan
sweep of a fleet journal naming a live ``sleep`` (its process group is
killed, in both packages).  Last, a port-only queue of two port
``faultline`` jobs on the CPU: the victim is evicted for an urgent job
and resumes loss-free, its final digest the uninterrupted run's.
"""

import concurrent.futures
import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from distributedtensorflowexample_tpu.resilience import scheduler as jsched
from distributedtensorflowexample_tpu.resilience import (
    supervisor as jsup)
from distributedtensorflowexample_tpu_torch.resilience import (
    scheduler as psched)
from distributedtensorflowexample_tpu_torch.resilience import (
    supervisor as psup)
from distributedtensorflowexample_tpu_torch.tools import faultline, schedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jsched, jsup), "port": (psched, psup)}

pytestmark = pytest.mark.sched


def test_sched_events_schema_equals_jax():
    assert psched.SCHED_EVENTS == jsched.SCHED_EVENTS
    assert psched.TERMINAL == jsched.TERMINAL
    assert psched.DEFAULT_SLO_PRIORITIES == jsched.DEFAULT_SLO_PRIORITIES


def _refusal(mod, build, tmp):
    try:
        build(mod, tmp)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("build", [
    lambda m, t: m.Job.from_dict({"job": "a", "argv": ["x"],
                                  "prioritee": 1}),
    lambda m, t: m.Job(job="a", argv=["x"], ranks=0),
    lambda m, t: m.Job(job="a/b", argv=["x"]),
    lambda m, t: m.Job(job="..", argv=["x"]),
    lambda m, t: m.Job(job=" a", argv=["x"]),
    lambda m, t: m.Job(job="a", argv=[]),
    lambda m, t: m.Job(job="a", argv=["x", "--steps", 12]),
    lambda m, t: m.Scheduler([m.Job(job="a", argv=["x"])] * 2,
                             workdir=str(t), heal=False),
    lambda m, t: m.Scheduler([], devices=0, heal=False),
    lambda m, t: m.Scheduler([], slices={"s": 0}, heal=False),
], ids=["unknown_field", "ranks", "slash", "dotdot", "space", "argv",
        "int_token", "duplicate", "devices", "slice_capacity"])
def test_job_and_scheduler_refusals_equal_jax(tmp_path, build):
    jax_msg = _refusal(jsched, build, tmp_path)
    assert jax_msg is not None
    assert _refusal(psched, build, tmp_path) == jax_msg


def test_load_queue_and_env_knobs_equal_jax(tmp_path, monkeypatch):
    jobs = [{"job": "a", "argv": ["x"], "kind": "serve"},
            {"job": "b", "argv": ["y"], "ranks": 2, "priority": 3,
             "env": {"K": "v"}, "after_file": "/f"}]
    (tmp_path / "dict.json").write_text(json.dumps({"jobs": jobs}))
    (tmp_path / "list.json").write_text(json.dumps(jobs))
    (tmp_path / "bad.json").write_text(json.dumps({"jobs": {"a": 1}}))
    monkeypatch.setenv("SCHED_SLO_PRIORITIES", "serve=5,bench=x,new=7")
    monkeypatch.setenv("SCHED_TICK_S", "0.125")
    monkeypatch.setenv("SCHED_QUEUE", "/q.json")
    got = {}
    for pkg, (mod, _) in PACKAGES.items():
        loaded = [[j.__dict__ for j in mod.load_queue(str(tmp_path / n))]
                  for n in ("dict.json", "list.json")]
        with pytest.raises(ValueError) as bad:
            mod.load_queue(str(tmp_path / "bad.json"))
        slo = mod.slo_priorities()
        got[pkg] = (loaded, str(bad.value).replace(str(tmp_path), ""),
                    slo, mod.tick_default(), mod.queue_path_default(),
                    [j.resolved_priority(slo) for j in
                     mod.load_queue(str(tmp_path / "list.json"))])
    assert got["port"] == got["jax"]
    assert got["port"][2]["serve"] == 5 and got["port"][3] == 0.125
    monkeypatch.setenv("SCHED_TICK_S", "fast")
    assert psched.tick_default() == jsched.tick_default() \
        == psched.DEFAULT_TICK_S


@pytest.mark.parametrize("family,steps,est", [
    ("BENCH_headline", 100, None), ("SCALING_sync", 50, 0.5),
    ("BENCH_input", 10, 0.5), ("no_such_family", 10, 0.25),
    ("", 10, None), ("BASELINE_SELF", 7, None)])
def test_predict_cost_on_the_committed_trajectory_equals_jax(family,
                                                             steps, est):
    path = os.path.join(REPO, "BENCH_trajectory.json")
    got = {pkg: mod.predict_cost(mod.Job(job="j", argv=["x"], family=family,
                                         steps=steps, est_step_time_s=est),
                                 path)
           for pkg, (mod, _) in PACKAGES.items()}
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("devices", [1, 2, 3, 4, 8, 16])
def test_load_collective_fit_equals_jax(tmp_path, devices):
    path = os.path.join(REPO, "BENCH_collectives_cpu_r06.json")
    (tmp_path / "torn.json").write_text('{"detail": {"knees": ')
    for p in (path, str(tmp_path / "torn.json"), str(tmp_path / "no.json")):
        assert psched.load_collective_fit(p, devices) \
            == jsched.load_collective_fit(p, devices)
    assert psched.load_collective_fit(path, devices) is not None


# ---- the mixed queue of scripted children --------------------------------

def _script(tmp_path, name, body) -> str:
    path = tmp_path / name
    path.write_text(textwrap.dedent(body))
    return str(path)


def _mixed_queue(mod, tmp_path) -> list:
    """One slot, so placements follow priority; the victim is gated on
    the flaky job's success and the urgent job on the victim's start
    file, so the retry's backoff and the eviction have fixed places in
    the order too."""
    py = sys.executable
    started = str(tmp_path / "victim_started")
    flaky = _script(tmp_path, "flaky.py", """
        import os, sys
        m = os.environ["MARKER"]
        if not os.path.exists(m):
            open(m, "w").close()
            sys.exit(1)
        open(m + ".done", "w").close()
        sys.exit(0)
    """)
    victim = _script(tmp_path, "victim.py", """
        import os, signal, sys, time
        if os.path.exists(os.environ["DONE"]):
            sys.exit(0)
        def term(s, f):
            open(os.environ["DONE"], "w").close()
            sys.exit(143)
        signal.signal(signal.SIGTERM, term)
        open(os.environ["STARTED"], "w").close()
        time.sleep(120)
        sys.exit(5)
    """)
    return [
        mod.Job(job="ok", argv=[py, "-c", "pass"], priority=10),
        mod.Job(job="wedge", argv=[py, "-c", "import sys; sys.exit(3)"],
                priority=20, retries=3),
        mod.Job(job="flaky", argv=[py, flaky], priority=30, retries=1,
                fleet_retries=0, env={"MARKER": str(tmp_path / "m")}),
        # Gated on flaky's success: not placed inside flaky's backoff.
        mod.Job(job="victim", argv=[py, victim], priority=40,
                env={"STARTED": started,
                     "DONE": str(tmp_path / "victim_done")},
                after_file=str(tmp_path / "m.done")),
        mod.Job(job="urgent", argv=[py, "-c", "pass"], priority=0,
                after_file=started),
        mod.Job(job="wide", argv=[py, "-c", "pass"], ranks=2, priority=50),
    ]


_FIELDS = ("job", "action", "attempt", "resumed", "for_job", "rcs", "retry",
           "of", "backoff_s", "clean", "status", "counts", "why", "ranks",
           "devices", "free_before", "priority", "source", "dropped")


def _decisions(path) -> list:
    out = []
    for line in open(path):
        row = json.loads(line)
        if str(row.get("event", "")).startswith("sched_"):
            out.append((row["event"],) + tuple(row.get(k) for k in _FIELDS))
    return out


def _run_queue(pkg, tmp_path):
    mod, sup = PACKAGES[pkg]
    wd = tmp_path / pkg
    wd.mkdir()
    s = mod.Scheduler(
        _mixed_queue(mod, wd), devices=1, workdir=str(wd / "sched"),
        tick_s=0.02, poll_s=0.02, seed=0,
        retry_policy=sup.RetryPolicy(retries=10**6, backoff_base_s=0.05,
                                     backoff_max_s=0.1))
    summary = s.run()
    summary.pop("makespan_s")
    # The one wording the port changed: a quarantine's reason names a
    # dead device where the JAX package's names its TPU tunnel.
    text = json.dumps([summary, _decisions(wd / "sched" / "RUNS.jsonl")])
    return json.loads(text.replace("dead tunnel", "dead device"))


def test_mixed_queue_decides_as_in_jax(tmp_path):
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = {pkg: pool.submit(_run_queue, pkg, tmp_path)
                for pkg in PACKAGES}
        got = {pkg: f.result() for pkg, f in runs.items()}
    assert got["port"] == got["jax"]
    summary, rows = got["port"]
    assert summary["jobs"] == {"ok": "done", "wedge": "quarantined",
                               "flaky": "done", "victim": "done",
                               "urgent": "done", "wide": "refused"}
    events = [(r[0], r[1]) for r in rows]
    evict = events.index(("sched_evict", "victim"))
    assert events[evict + 1] == ("sched_place", "urgent")
    assert ("sched_retry", "flaky") in events
    assert ("sched_quarantine", "wedge") in events
    resumed = [r for r in rows if r[:2] == ["sched_place", "victim"]]
    assert [r[4] for r in resumed] == [False, True]


# ---- replay and the orphan sweep -----------------------------------------

def _hand_sched_journal(path, pid: int, jdir) -> None:
    rows = [
        {"event": "sched_submit", "job": "a"},
        {"event": "sched_submit", "job": "b"},
        {"event": "sched_submit", "job": "c"},
        {"event": "sched_intent", "action": "place", "job": "a", "seq": 1,
         "attempt": 1},
        {"event": "sched_place", "job": "a", "seq": 1, "attempt": 1},
        {"event": "sched_intent", "action": "done", "job": "b", "seq": 2},
        {"event": "sched_intent", "action": "retry", "job": "c", "seq": 3,
         "retry": 1},
        {"event": "sched_intent", "action": "evict", "job": "a", "seq": 4,
         "for_job": "b"},
        {"event": "heal_intent", "seq": 7, "action": "evict", "job": "a",
         "key": "a:l1:straggler:rank0", "kind": "straggler"},
    ]
    with open(path, "w") as f:
        for i, row in enumerate(rows):
            f.write(json.dumps({"ts": 100.0 + i, **row}) + "\n")
    os.makedirs(jdir)
    with open(os.path.join(jdir, "fleet.jsonl"), "w") as f:
        for row in ({"event": "rank_spawn_intent", "task": "a",
                     "attempt": 0, "rank": 0},
                    {"event": "rank_spawn", "task": "a", "attempt": 0,
                     "rank": 0, "pid": pid},
                    {"event": "rank_spawn_intent", "task": "a",
                     "attempt": 0, "rank": 1}):
            f.write(json.dumps(row) + "\n")


def test_replay_and_orphan_sweep_equal_jax(tmp_path):
    """Each package replays the same hand-written journal over its own
    live orphan (a ``sleep`` in its own process group, as a fleet rank
    is): terminal intents finish, the retry count restores, the
    dangling evict is dropped, the orphan's group is killed."""
    got = {}
    for pkg, (mod, sup) in PACKAGES.items():
        wd = tmp_path / pkg / "sched"
        wd.mkdir(parents=True)
        orphan = subprocess.Popen(["sleep", "60"], start_new_session=True)
        try:
            _hand_sched_journal(wd / "sched.jsonl", orphan.pid,
                                str(wd / "jobs" / "a"))
            jobs = [mod.Job(job=j, argv=["x"]) for j in "abc"]
            s = mod.Scheduler(jobs, devices=1, workdir=str(wd), seed=0)
            s._replay()
            rc = orphan.wait(timeout=30)
        finally:
            if orphan.poll() is None:
                orphan.kill()
                orphan.wait()
        rows = [(r["event"], r.get("job"), r.get("seq"), r.get("dropped"),
                 r.get("retry"), r.get("replayed"), r.get("rank"))
                for r in sup.Journal(str(wd / "sched.jsonl")).events()]
        got[pkg] = ({j: (st.state, st.retries_used, st.ran, st.launches)
                     for j, st in s._jobs.items()}, rows[9:], rc, s._seq)
    assert got["port"] == got["jax"]
    states, rows, rc, seq = got["port"]
    assert states["b"][0] == "done" and states["c"][1] == 1
    assert rc == -15 and seq == 4
    assert ("sched_orphan_killed", "a", None, None, None, None, 0) in rows


# ---- port faultline jobs: a loss-free, bitwise eviction ------------------

def test_faultline_queue_evicts_loss_free_and_bitwise(tmp_path, capsys):
    """Two port faultline jobs on one slot (the CPU): the slow victim
    (softmax, a snapshot every step, 0.3 s a step from step 1) is
    evicted once its step-3 snapshot lands, by a priority-0 job gated on
    that file; it resumes from its agreed step and ends with the tape and
    digest of an uninterrupted run.  The queue goes through the port's
    ``tools.schedule``, whose children use one intra-op thread."""
    py = sys.executable
    wd = tmp_path / "sched"
    steps = 8
    fl = [py, "-m", "distributedtensorflowexample_tpu_torch.tools.faultline",
          "--device", "cpu", "--model", "softmax", "--steps", str(steps),
          "--seed", "0", "--keep", "50"]
    snaps = str(wd / "jobs" / "victim" / "rank{rank}" / "snapshots")
    queue = tmp_path / "q.json"
    queue.write_text(json.dumps({"jobs": [
        {"job": "victim", "kind": "bench", "steps": steps,
         "est_step_time_s": 0.3,
         "argv": fl + ["--plan", "slow_rank@1:0.3", "--workdir",
                       str(wd / "jobs" / "victim" / "rank{rank}")],
         "snapshots": snaps, "env": {"OMP_NUM_THREADS": "1"}},
        {"job": "urgent", "kind": "serve",
         "argv": fl + ["--plan", "none", "--steps", "2", "--workdir",
                       str(wd / "jobs" / "urgent" / "rank{rank}")],
         "env": {"OMP_NUM_THREADS": "1"},
         "after_file": snaps.replace("{rank}", "0")
         + "/snap_00000003.npz"}]}))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            queued = pool.submit(schedule.main, [
                "--queue", str(queue), "--workdir", str(wd), "--devices",
                "1", "--tick_s", "0.05", "--device", "cpu", "--record",
                str(tmp_path / "rec.jsonl")])
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = faultline.main(fl[3:] + ["--plan", "none", "--workdir",
                                              str(tmp_path / "straight")])
            assert queued.result() == 0 and rc == 0
    finally:
        torch.set_num_threads(threads)
    straight = json.loads(out.getvalue().strip().splitlines()[-1])
    rows = [json.loads(l) for l in open(wd / "RUNS.jsonl")]
    sched = [(r["event"], r.get("job")) for r in rows
             if r["event"].startswith("sched_")]
    assert ("sched_evict", "victim") in sched
    evict = next(r for r in rows if r["event"] == "sched_evict")
    assert evict["rcs"] == {"0": 143} and evict["clean"] is True
    places = [r for r in rows if r["event"] == "sched_place"
              and r["job"] == "victim"]
    assert [p["resumed"] for p in places] == [False, True]
    tails = []
    for place in (1, 2):
        path = wd / "jobs" / "victim" / "out" / f"place{place}" \
            / "rank0_attempt0.out"
        tails.append(json.loads(path.read_text().strip().splitlines()[-1]))
    assert tails[0]["status"] == "preempted"
    assert tails[1]["start_step"] == tails[0]["step"] >= 3
    assert tails[1]["digest"] == straight["digest"]
    tape = tails[0]["losses"] + tails[1]["losses"]
    assert tape == straight["losses"]              # no step lost or redone
    rec = [json.loads(l) for l in open(tmp_path / "rec.jsonl")]
    assert rec[0]["platform"] == "cpu" and rec[0]["value"] == 2
    assert "gpu" not in rec[0]["detail"]
