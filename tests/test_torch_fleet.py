"""The port's gang supervision (``resilience/fleet.py``) and its
``supervise_fleet`` driver, held against the JAX package on the CPU.

The scripted gangs are stdlib-only ``python`` scripts (milliseconds
each, no torch, no JAX) run under the JAX and the port
``FleetSupervisor`` with the same policy and seed; every child sleeps a
little before it exits where a teardown must find it alive, so each
scenario's verdicts are deterministic.  Compared: the ``GangResult``
fields, what each rank was told (its per-attempt stdout), and the journal
projections (every record without its times, pids and paths; as a
multiset, since two ranks that exit together may be polled in either
order).  The agreement pass runs over rank stores written by the port's
``SnapshotStore`` and picks the same step and discards in both packages.
One drill runs two port ``faultline`` ranks (torch children, on the CPU)
under the port's fleet with ``kill@4%1``: both ranks end bitwise equal to
the uninterrupted run, tape and digest.
"""

import concurrent.futures
import json
import os
import re
import shutil
import stat
import sys
import time
import zlib

import pytest
import torch

from distributedtensorflowexample_tpu.resilience import fleet as jfleet
from distributedtensorflowexample_tpu.resilience import (
    supervisor as jsup)
from distributedtensorflowexample_tpu_torch.models import build_model
from distributedtensorflowexample_tpu_torch.resilience import fleet as pfleet
from distributedtensorflowexample_tpu_torch.resilience import (
    supervisor as psup)
from distributedtensorflowexample_tpu_torch.resilience.snapshot import (
    SnapshotStore, valid_steps)
from distributedtensorflowexample_tpu_torch.tools import (
    faultline, supervise_fleet)
from distributedtensorflowexample_tpu_torch.training.optimizers import (
    MomentumSGD)
from distributedtensorflowexample_tpu_torch.training.state import TrainState

pytestmark = pytest.mark.fleet

PACKAGES = {"jax": (jfleet, jsup), "port": (pfleet, psup)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the faultline ranks get (OMP_NUM_THREADS):
    the CPU kernels' summation order follows the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
# Keys of a journal record that are the same in both packages' runs.
_KEYS = ("event", "task", "attempt", "rank", "rc", "reason", "why",
         "outcome", "rcs", "ranks", "resume_step", "agreed", "per_rank",
         "discarded", "replayed", "kind", "attempts", "restarts")


def _fleet(pkg, tmp, **kw):
    fleet, sup = PACKAGES[pkg]
    kw.setdefault("policy", sup.RetryPolicy(retries=2, backoff_base_s=0.01,
                                            backoff_max_s=0.02))
    kw.setdefault("journal", sup.Journal(str(tmp / "fleet.jsonl")))
    kw.setdefault("kill_grace_s", 1.0)
    kw.setdefault("poll_s", 0.05)
    kw.setdefault("seed", 0)
    kw.setdefault("workdir", str(tmp / "fleet"))
    return fleet.FleetSupervisor(2, **kw)


def _child(tmp, body: str) -> list[str]:
    path = tmp / "child.py"
    path.write_text(body)
    return [sys.executable, str(path)]


def _journal(tmp) -> list:
    path = tmp / "fleet.jsonl"
    if not path.exists():
        return []
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return sorted(json.dumps({k: r[k] for k in _KEYS if k in r},
                             sort_keys=True) for r in recs)


def _outs(tmp) -> dict:
    """Each rank attempt's stdout, but for the attempts a teardown ended
    (how far such a child got before its TERM is a race)."""
    out = tmp / "out"
    if not out.exists():
        return {}
    with open(tmp / "fleet.jsonl") as f:
        torn = {f"rank{r['rank']}_attempt{r['attempt']}.out"
                for r in map(json.loads, f)
                if r["event"] == "rank_exit" and r.get("reason") == "teardown"}
    return {n: (out / n).read_text() for n in sorted(os.listdir(out))
            if n not in torn}


def _result(res) -> tuple:
    return (res.status, res.gang_attempts, res.restarts, res.preemptions,
            res.agreed_steps, res.last_rcs, res.ranks, res.reasons)


def _write_snap(directory, step, payload=b"snapshot-payload-bytes",
                torn=False):
    """A committed snapshot the manifest surface accepts, without a
    state: the agreement reads manifests and payload bytes only."""
    os.makedirs(directory, exist_ok=True)
    pp = os.path.join(directory, f"snap_{step:08d}.npz")
    with open(pp, "wb") as f:
        f.write(payload)
    man = {"version": 1, "step": step, "nbytes": len(payload),
           "crc32": zlib.crc32(payload), "leaves": 1, "cursor": None,
           "meta": None}
    with open(os.path.join(directory, f"snap_{step:08d}.json"), "w") as f:
        json.dump(man, f)
    if torn:
        with open(pp, "r+b") as f:
            f.truncate(len(payload) // 2)


# ---- the scenarios: pkg, tmp -> (GangResult or exception, extras) -------

def _clean(pkg, tmp):
    """Every rank gets the documented env surface, {rank} substituted,
    and a stale FLEET_RESUME_STEP from the fleet's own env (the test
    exports one) scrubbed."""
    argv = _child(tmp, """
import json, os, sys
cfg = json.loads(os.environ["TF_CONFIG"])
print(json.dumps({"rank": os.environ["OBS_RANK"], "tag": sys.argv[1],
                  "idx": cfg["task"]["index"],
                  "workers": len(cfg["cluster"]["worker"]),
                  "n": os.environ["FLEET_NUM_RANKS"],
                  "attempt": os.environ["SUPERVISE_ATTEMPT"],
                  "resume": os.environ.get("FLEET_RESUME_STEP"),
                  "hb": os.path.basename(os.environ["SUPERVISE_HEARTBEAT"]),
                  "health": os.path.basename(os.environ["OBS_HEALTH"]),
                  "down": os.path.basename(
                      os.environ["FLEET_HOST_DOWN_FILE"])}))
""") + ["tag{rank}"]
    return _fleet(pkg, tmp).run(argv, name="envs",
                                stdout_dir=str(tmp / "out"))


def _rank_crash(pkg, tmp):
    argv = _child(tmp, """
import os, sys, time
r, a = int(os.environ["OBS_RANK"]), int(os.environ["SUPERVISE_ATTEMPT"])
if a == 0 and r == 1:
    sys.exit(7)
if a == 0:
    time.sleep(60)      # must be torn down, never waited out
sys.exit(0)
""")
    return _fleet(pkg, tmp).run(argv, name="crash")


def _budget(pkg, tmp):
    fleet, sup = PACKAGES[pkg]
    argv = _child(tmp, """
import os, sys, time
time.sleep(30 * int(os.environ["OBS_RANK"]))    # rank 1: torn down
sys.exit(1)
""")
    return _fleet(pkg, tmp, policy=sup.RetryPolicy(
        retries=1, backoff_base_s=0.01, backoff_max_s=0.02)).run(
            argv, name="dead")


def _unanimous_preemption(pkg, tmp):
    fleet, sup = PACKAGES[pkg]
    argv = _child(tmp, """
import os, sys
sys.exit(143 if int(os.environ["SUPERVISE_ATTEMPT"]) < 3 else 0)
""")
    return _fleet(pkg, tmp, policy=sup.RetryPolicy(retries=0)).run(
        argv, name="preempt_storm")


def _divergent_preemption(pkg, tmp):
    argv = _child(tmp, """
import os, sys, time
r, a = int(os.environ["OBS_RANK"]), int(os.environ["SUPERVISE_ATTEMPT"])
if a == 0 and r == 0:
    sys.exit(143)
if a == 0:
    time.sleep(60)
sys.exit(0)
""")
    return _fleet(pkg, tmp, preempt_grace_s=0.3).run(argv, name="diverge")


def _lost_heartbeat(pkg, tmp):
    argv = _child(tmp, """
import os, sys, time
r, a = int(os.environ["OBS_RANK"]), int(os.environ["SUPERVISE_ATTEMPT"])
open(os.environ["SUPERVISE_HEARTBEAT"], "a").close()    # first beat: arms
if a == 0 and r == 0:
    time.sleep(60)      # wedged: beats stop, process lives
sys.exit(0)
""")
    return _fleet(pkg, tmp, heartbeat_timeout_s=0.7).run(argv, name="wedge")


def _rank_lost_taxonomy(pkg, tmp):
    """A host that cannot even exec: worker-tiled state makes the shrink
    illegal; replicated state refuses it without elastic; elastic goes
    on with the survivors."""
    exe0 = tmp / "exe0"
    exe0.write_text("#!/bin/sh\nsleep 0.3\nexit 0\n")
    exe0.chmod(exe0.stat().st_mode | stat.S_IXUSR)
    argv = [str(tmp / "exe{rank}")]        # exe1 does not exist
    out = []
    for kw, sub in ((dict(worker_tiled=True), "f1"), ({}, "f2"),
                    (dict(elastic=True), "f3")):
        try:
            res = _fleet(pkg, tmp, workdir=str(tmp / sub), **kw).run(
                argv, name="lost")
            out.append(_result(res))
        except PACKAGES[pkg][0].RankLostError as e:
            out.append((type(e).__name__, e.rank, e.attempt))
    return out


def _shrink_then_grow(pkg, tmp):
    """Rank 1's host dies (tombstone + SIGKILL, the host_loss shape):
    the next spawn fails, the elastic gang shrinks to rank 0, then the
    tombstone expires and the re-probe grows the gang back."""
    argv = _child(tmp, """
import json, os, sys, time
rank = int(os.environ["OBS_RANK"])
n = int(os.environ["FLEET_NUM_RANKS"])
attempt = int(os.environ["SUPERVISE_ATTEMPT"])
print(json.dumps({"rank": rank, "n": n, "attempt": attempt,
                  "tag": sys.argv[1]}), flush=True)
if attempt == 0 and rank == 1:
    with open(os.environ["FLEET_HOST_DOWN_FILE"], "w") as f:
        json.dump({"ts": time.time(), "down_s": 1.0}, f)
    os.kill(os.getpid(), 9)
if n == 1:
    time.sleep(1.2)     # outlive the tombstone so the re-probe can grow
    sys.exit(1)         # force one more budgeted restart
time.sleep(0.3 if attempt else 60)
sys.exit(0)
""") + ["w{num_ranks}"]
    fleet, sup = PACKAGES[pkg]
    f = _fleet(pkg, tmp, elastic=True, policy=sup.RetryPolicy(
        retries=4, backoff_base_s=0.01, backoff_max_s=0.02))
    res = f.run(argv, name="grow", stdout_dir=str(tmp / "out"))
    return res, f.lost_ranks


def _agreement(pkg, tmp):
    """Rank 0 ran ahead (3,4,5), rank 1 holds (3,4) + a torn 5: the
    fleet agrees on 4, discards every newer snapshot on every rank, and
    exports FLEET_RESUME_STEP=4."""
    snaps = {r: str(tmp / f"rank{r}" / "snapshots") for r in (0, 1)}
    for s in (3, 4, 5):
        _write_snap(snaps[0], s)
    for s in (3, 4):
        _write_snap(snaps[1], s)
    _write_snap(snaps[1], 5, torn=True)
    argv = _child(tmp, """
import os, sys, time
r, a = int(os.environ["OBS_RANK"]), int(os.environ["SUPERVISE_ATTEMPT"])
if a == 0:
    time.sleep(30 * r)      # rank 1: torn down when rank 0 crashes
    sys.exit(1)
print(os.environ["FLEET_RESUME_STEP"])
""")
    res = _fleet(pkg, tmp).run(
        argv, name="agree",
        snapshot_dir_template=str(tmp / "rank{rank}" / "snapshots"),
        stdout_dir=str(tmp / "out"))
    return res, {r: valid_steps(d) for r, d in snaps.items()}


def _interrupted_discard(pkg, tmp):
    """The supervisor dies mid-discard (FLEET_DRILL_DIE_IN_DISCARD): a
    restarted fleet replays the write-ahead agreement before its first
    launch, idempotently, and a third replays nothing."""
    snaps = {r: str(tmp / f"rank{r}" / "snapshots") for r in (0, 1)}
    for s in (3, 4, 5):
        _write_snap(snaps[0], s)
    for s in (3, 4, 6):
        _write_snap(snaps[1], s)
    tmpl = str(tmp / "rank{rank}" / "snapshots")
    os.environ["FLEET_DRILL_DIE_IN_DISCARD"] = "0"
    try:
        with pytest.raises(RuntimeError, match="mid-discard"):
            _fleet(pkg, tmp)._agree("agree", tmpl)
    finally:
        del os.environ["FLEET_DRILL_DIE_IN_DISCARD"]
    half = {r: valid_steps(d) for r, d in snaps.items()}
    argv = _child(tmp, 'import os\nprint(os.environ["FLEET_RESUME_STEP"])\n')
    res = _fleet(pkg, tmp).run(argv, name="agree",
                               snapshot_dir_template=tmpl,
                               stdout_dir=str(tmp / "out"))
    third = _fleet(pkg, tmp, workdir=str(tmp / "f2"))._replay_agreement(
        "agree", tmpl)
    return res, half, {r: valid_steps(d) for r, d in snaps.items()}, third


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _clean, _rank_crash, _budget, _unanimous_preemption,
    _divergent_preemption, _lost_heartbeat, _rank_lost_taxonomy,
    _shrink_then_grow, _agreement, _interrupted_discard)}
# Scenarios that toggle the process's environment mid-run: the two
# packages take turns; the others run side by side.
SERIAL = {"interrupted_discard"}

# What the JAX package's own tests pin for each scenario: (status,
# gang_attempts, restarts, preemptions) of the final GangResult.
EXPECT = {"clean": ("ok", 1, 0, 0), "rank_crash": ("ok", 2, 1, 0),
          "budget": ("exhausted", 2, 1, 0),
          "unanimous_preemption": ("ok", 4, 3, 3),
          "divergent_preemption": ("ok", 2, 1, 0),
          "lost_heartbeat": ("ok", 2, 1, 0),
          "shrink_then_grow": ("ok", 4, 3, 0),
          "agreement": ("ok", 2, 1, 0),
          "interrupted_discard": ("ok", 1, 0, 0)}


def _flatten(out):
    """GangResults inside a scenario's return, as comparable tuples."""
    if isinstance(out, (jfleet.GangResult, pfleet.GangResult)):
        return _result(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_flatten(o) for o in out)
    if isinstance(out, dict):
        return {k: _flatten(v) for k, v in out.items()}
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scripted_gangs_supervise_as_in_jax(tmp_path, monkeypatch, name):
    # A stale export in the fleet's own environment (scrubbed per rank).
    monkeypatch.setenv("FLEET_RESUME_STEP", "99")

    def run(pkg):
        tmp = tmp_path / pkg
        tmp.mkdir()
        out = SCENARIOS[name](pkg, tmp)
        # Paths (in a lost rank's error) name each run's own directory,
        # and a stale beat's age is a clock reading.
        text = json.dumps([_flatten(out), _journal(tmp), _outs(tmp)],
                          sort_keys=True, default=str)
        return re.sub(r"stale [0-9.]+s", "stale AGEs",
                      text.replace(str(tmp), "TMP"))

    if name in SERIAL:
        runs = {pkg: run(pkg) for pkg in PACKAGES}
    else:
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            futures = {pkg: ex.submit(run, pkg) for pkg in PACKAGES}
            runs = {pkg: f.result() for pkg, f in futures.items()}
    assert runs["port"] == runs["jax"]
    result, journal, _ = json.loads(runs["port"])
    assert journal
    first = result[0] if isinstance(result[0], list) else result
    if name in EXPECT:
        assert tuple(first[:4]) == EXPECT[name], first
    if name == "rank_lost_taxonomy":
        assert [r[0] for r in result] == [
            "RankLossStructurallyIllegal", "RankLossRefused", "ok"]
    if name == "agreement":
        assert result[1] == {"0": [3, 4], "1": [3, 4]}
        assert first[4] == [4]
    if name == "interrupted_discard":
        _, half, after, third = result
        assert half == {"0": [3, 4], "1": [3, 4, 6]}
        assert after == {"0": [3, 4], "1": [3, 4]} and third is None
    if name == "shrink_then_grow":
        assert first[6] == [0, 1] and result[1] == []


def _port_snapshots(directory, steps, tear_last=False):
    """Rank snapshots written by the port's SnapshotStore (softmax state,
    a step apart)."""
    state = TrainState.create(
        build_model("softmax"),
        lambda m: MomentumSGD(m, lambda c: 0.1, 0.9, fused=False), 0,
        torch.device("cpu"))
    store = SnapshotStore(directory, keep=10)
    for s in steps:
        state.step = s
        store.save(state, cursor={"seed": 0, "step": s})
    if tear_last:
        store.tear_latest()


def test_agreement_over_port_snapshots_matches_jax(tmp_path):
    """The same agreed step and the same discards, from rank stores the
    port wrote: the JAX reader validates the port's manifests."""
    src = tmp_path / "src"
    _port_snapshots(str(src / "rank0" / "snapshots"), (2, 3, 4, 5, 6))
    _port_snapshots(str(src / "rank1" / "snapshots"), (2, 3, 4, 5),
                    tear_last=True)
    _port_snapshots(str(src / "rank2" / "snapshots"), (1, 2, 3, 4))
    seen = {}
    for pkg in ("jax", "port"):
        tmp = tmp_path / pkg
        shutil.copytree(src, tmp)
        fleet, _ = PACKAGES[pkg]
        f = fleet.FleetSupervisor(
            3, journal=PACKAGES[pkg][1].Journal(str(tmp / "fleet.jsonl")),
            workdir=str(tmp / "fleet"))
        agreed = f._agree("agree", str(tmp / "rank{rank}" / "snapshots"))
        seen[pkg] = (agreed, _journal(tmp),
                     [valid_steps(str(tmp / f"rank{r}" / "snapshots"))
                      for r in range(3)])
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == 4
    assert seen["port"][2] == [[2, 3, 4], [2, 3, 4], [1, 2, 3, 4]]


def test_faultline_gang_kill_resumes_bitwise(tmp_path, capsys):
    """Two port faultline ranks, rank 1 SIGKILLed at step 4: the gang is
    torn down, restarted from the agreed step, and both ranks end with
    the uninterrupted run's digest and tape.  Rank 0 turns slow from
    step 5 (1 s a boundary; the straggler fault, which changes no
    number), so it is still running when rank 1 dies, whichever rank
    started first: the teardown has a live rank to stop."""
    steps = 8
    # A snapshot every 2 steps (26 MB of state each, fsynced): step 4,
    # rank 1's last, is one of them.
    fl = ["--device", "cpu", "--model", "mnist_cnn", "--steps", str(steps),
          "--seed", "0", "--keep", "20", "--snapshot_every", "2"]
    fleet = pfleet.FleetSupervisor(
        2, policy=psup.RetryPolicy(retries=1, backoff_base_s=0.01,
                                   backoff_max_s=0.02),
        journal=psup.Journal(str(tmp_path / "fleet.jsonl")),
        kill_grace_s=5.0, poll_s=0.05, seed=0,
        workdir=str(tmp_path / "fleet"))
    argv = [sys.executable, "-m",
            "distributedtensorflowexample_tpu_torch.tools.faultline", *fl,
            "--plan", "kill@4%1,slow_rank@5:1.0%0", "--workdir",
            str(tmp_path / "rank{rank}")]
    # The gang in a thread, the uninterrupted run here meanwhile.
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        gang = ex.submit(fleet.run, argv, name="drill",
                         snapshot_dir_template=str(tmp_path / "rank{rank}"
                                                   / "snapshots"),
                         stdout_dir=str(tmp_path / "out"),
                         env_extra={"OMP_NUM_THREADS": "1"})
        rc = faultline.main(fl + ["--plan", "none", "--workdir",
                                  str(tmp_path / "straight")])
        res = gang.result()
    straight = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert res.status == "ok" and res.gang_attempts == 2, res.reasons
    agreed = res.agreed_steps[0]
    assert agreed == 4
    events = [json.loads(l) for l in open(tmp_path / "fleet.jsonl")]
    assert any(e["event"] == "rank_exit" and e["rank"] == 1
               and e["rc"] == -9 for e in events)
    tear = next(e for e in events if e["event"] == "gang_teardown")
    assert tear["why"] == "rank_crash" and tear["rank"] == 1
    for r in (0, 1):
        final = json.loads((tmp_path / "out" / f"rank{r}_attempt1.out")
                           .read_text().strip().splitlines()[-1])
        assert final["start_step"] == agreed and final["step"] == steps
        assert final["digest"] == straight["digest"]
        assert final["losses"] == straight["losses"][agreed:]


def test_poll_health_straggler_evidence_is_cadence_gated(tmp_path):
    """The port's online health pass (the JAX test's scenario): an
    exited rank's stopped beat is never slowness evidence; a live rank's
    frozen beat counts once it exceeds skew_time_ratio x that rank's own
    beat cadence, and is journaled as a straggler, as is a transient
    detector firing (fired_step latched)."""
    from distributedtensorflowexample_tpu_torch.obs import (
        anomaly as obs_anomaly)
    fleet = pfleet.FleetSupervisor(
        2, journal=psup.Journal(str(tmp_path / "fleet.jsonl")),
        workdir=str(tmp_path / "fleet"), health_path="", skew_lag_steps=3,
        skew_time_ratio=4.0)
    fleet._stragglers, fleet._flagged, fleet._beat_obs = set(), set(), {}

    def poll(**kw):
        fleet._health_polled_t = -float("inf")
        fleet._poll_health("t", 0, [0, 1], **kw)

    for rank, last in ((0, 12), (1, 5)):       # rank 1 frozen at step 5
        h = obs_anomaly.RunHealth(rank=rank)
        for s in range(1, last + 1):
            h.observe_window(s, 1, 0.01)
        h.write(fleet._health_path(rank))
        open(fleet._hb_path(rank), "w").close()
    poll()                                     # learn mtimes
    time.sleep(0.05)
    now = time.time()
    for rank in (0, 1):
        os.utime(fleet._hb_path(rank), (now, now))
    poll()                                     # cadence ~0.05 s learned
    assert fleet.stragglers == []
    time.sleep(0.6)                            # rank 1's beat freezes
    now = time.time()
    os.utime(fleet._hb_path(0), (now, now))
    poll(exited={1: 143})                      # exited: never evidence
    assert fleet.stragglers == []
    poll(exited={})                            # live and frozen: named
    assert fleet.stragglers == [1]
    events = [json.loads(l) for l in open(tmp_path / "fleet.jsonl")]
    strag = [e for e in events if e.get("kind") == "straggler"]
    assert [e["rank"] for e in strag] == [1] and "stale" in strag[0]["why"]
    h = obs_anomaly.read_health(fleet._health_path(1))
    h["flags"]["step_time_regression"] = {"firing": False, "fired_step": 4}
    obs_anomaly.write_health(fleet._health_path(1), h)
    poll(exited={})
    assert any(json.loads(l).get("kind") == "step_time_regression"
               for l in open(tmp_path / "fleet.jsonl"))


def test_supervise_fleet_exhausted_never_exits_143(tmp_path, monkeypatch):
    """An exhausted fleet whose last attempt holds a preempted rank must
    not exit 143 (an outer supervisor would restart it budget-free
    forever): the crashing rank's own rc wins."""
    monkeypatch.setenv("OBS_DIR", str(tmp_path / "flight"))
    script = tmp_path / "mixed.py"
    script.write_text("""
import os, sys, time
if os.environ["OBS_RANK"] == "0":
    sys.exit(143)
time.sleep(0.3)
sys.exit(7)
""")
    rc = supervise_fleet.main([
        "--num_ranks", "2", "--retries", "0", "--backoff_base_s", "0.01",
        "--workdir", str(tmp_path / "wd"), "--snapshots", "none",
        "--seed", "0", "--", sys.executable, str(script)])
    assert rc == 7


def test_supervise_fleet_heal_is_refused_by_name(tmp_path, capsys):
    """Once refused by name, now run: ``--heal`` over one scripted rank
    whose first launch writes a firing step-time regression and waits;
    the remediator evicts it (TERM -> 143), and the relaunch, with the
    bumped SUPERVISE_ATTEMPT, exits 0.  The faultline gang with a slow
    rank: tests/test_torch_heal.py."""
    child = tmp_path / "child.py"
    child.write_text("""
import json, os, signal, sys, time
if os.environ.get("SUPERVISE_ATTEMPT", "0") == "0":
    signal.signal(signal.SIGTERM, lambda s, f: sys.exit(143))
    flags = {"step_time_regression": {"firing": True, "fired_step": 4},
             "nan_loss": {"firing": False, "fired_step": None}}
    with open(os.environ["OBS_HEALTH"], "w") as f:
        json.dump({"version": 1, "kind": "rank", "rank": 0, "step": 5,
                   "updated_unix": time.time(), "flags": flags}, f)
    time.sleep(60)
    sys.exit(5)
""")
    wd = tmp_path / "wd"
    rc = supervise_fleet.main(["--heal", "--num_ranks", "1", "--workdir",
                               str(wd), "--snapshots", "none",
                               "--heal_poll_s", "0.05", "--kill_grace_s",
                               "5", "--seed", "0", "--", sys.executable,
                               str(child)])
    assert rc == 0
    assert "heal: 1 relaunch(es), 1 action(s), final status ok" \
        in capsys.readouterr().err
    rows = [json.loads(l) for l in open(wd / "RUNS.jsonl")]
    evict = [r for r in rows if r["event"] == "heal_evict"]
    assert len(evict) == 1 and evict[0]["kind"] == "step_time_regression"
    assert (wd / "launch1" / "rank0_attempt0.out").exists()
