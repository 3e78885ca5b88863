"""The port's ledger readers (``tools.obs_query`` and ``tools.obs_report``)
held against the JAX package's ``tools/obs_query.py`` and
``tools/obs_report.py`` on the CPU: on the same files, the same bytes.

The files come from both packages' writers:

- a scripted two-rank gang (stdlib children: each rank writes its run
  rows, spans, counters and loss tape through one package's ``obs/``,
  and snapshot manifests the agreement reads) under that package's
  ``FleetSupervisor``: rank 1 crashes at step 2 of attempt 0, the gang
  is torn down and restarts from the agreed step 2.  So a JAX-written
  and a port-written ledger, fleet journal and set of flight dumps;
- a port simulator run and a JAX simulator run (``sched_*``/``heal_*``
  rows of a healed straggler);
- a live port ``Scheduler`` queue over stdlib children (an SLO
  eviction and its resumed placement).

``obs_query`` ``list``/``show``/``diff``/``why`` in ``md`` and ``json``
and ``obs_report`` markdown/``json``/``trace`` must print what the JAX
tools print.  ``trajectory`` without ``--records_dir`` is refused by
name, and the readers, the simulator and ``engine.spec`` import neither
torch nor JAX.
"""

import contextlib
import io
import json
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest

from distributedtensorflowexample_tpu.resilience import fleet as jfleet
from distributedtensorflowexample_tpu.resilience import (
    supervisor as jsup)
from distributedtensorflowexample_tpu.sim import SimWorld as JaxWorld
from distributedtensorflowexample_tpu.sim import load_scenario as jax_load
import distributedtensorflowexample_tpu_torch as port_pkg
from distributedtensorflowexample_tpu_torch.obs import ledger as pledger
from distributedtensorflowexample_tpu_torch.resilience import fleet as pfleet
from distributedtensorflowexample_tpu_torch.resilience import (
    scheduler as psched)
from distributedtensorflowexample_tpu_torch.resilience import (
    supervisor as psup)
from distributedtensorflowexample_tpu_torch.sim import (
    SimWorld, load_scenario)
from distributedtensorflowexample_tpu_torch.tools import obs_query
from distributedtensorflowexample_tpu_torch.tools import obs_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "distributedtensorflowexample_tpu_torch"
JAX = "distributedtensorflowexample_tpu"

pytestmark = pytest.mark.ledger


def _jax_tool(name):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


jax_obs_query = _jax_tool("obs_query")
jax_obs_report = _jax_tool("obs_report")


def _call(main, argv) -> tuple:
    """(rc or SystemExit text, stdout) of one in-process CLI call."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = str(e.code)
    return rc, out.getvalue()


# ---- the files: a scripted gang per package ------------------------------

# One rank of the scripted gang.  argv[1] names the package whose obs/
# writes the rows; the snapshot manifests are the shape the fleet's
# agreement pass reads (tests/test_torch_fleet.py writes the same).
_RANK = textwrap.dedent("""
    import importlib, json, os, sys, time, zlib
    pkg = sys.argv[1]
    ledger = importlib.import_module(pkg + ".obs.ledger")
    metrics = importlib.import_module(pkg + ".obs.metrics")
    recorder = importlib.import_module(pkg + ".obs.recorder")
    trace = importlib.import_module(pkg + ".obs.trace")
    rank = int(os.environ["OBS_RANK"])
    attempt = int(os.environ["SUPERVISE_ATTEMPT"])
    snaps = os.path.join(sys.argv[2], f"rank{rank}", "snapshots")
    rec = recorder.maybe_install()
    rec.note(model="scripted", rank_role="front" if rank == 0 else "back")
    led = ledger.maybe_begin(
        "scripted_rank", config={"model": "mnist_cnn", "num_devices": 2,
                                 "bucket_grads": "4096" if rank else "",
                                 "shard_update": rank == 1},
        mesh_size=2)
    steps = metrics.counter("scripted_steps_total", "steps taken")
    start = int(os.environ.get("FLEET_RESUME_STEP") or 0)
    for step in range(start + 1, start + 4):
        with trace.span("train_step", step=step):
            steps.inc()
            rec.record_loss(step, 2.0 / step + 0.25 * rank)
        os.makedirs(snaps, exist_ok=True)
        payload = f"rank{rank}-step{step}".encode()
        with open(os.path.join(snaps, f"snap_{step:08d}.npz"), "wb") as f:
            f.write(payload)
        with open(os.path.join(snaps, f"snap_{step:08d}.json"), "w") as f:
            json.dump({"version": 1, "step": step, "nbytes": len(payload),
                       "crc32": zlib.crc32(payload), "leaves": 1,
                       "cursor": None, "meta": None}, f)
        led.sample(step, force=True)
        if attempt == 0 and rank == 1 and step == 2:
            sys.exit(7)                 # the crash the gang restarts from
    if attempt == 0:
        time.sleep(60)                  # torn down, never waited out
    led.end(rc=0, final_step=start + 3)
""")


def _gang(pkg: str, root) -> str:
    """Run the scripted gang under ``pkg``'s FleetSupervisor, its ranks
    writing through ``pkg``'s obs/; returns the work directory."""
    fleet, sup = {"jax": (jfleet, jsup), "port": (pfleet, psup)}[pkg]
    root.mkdir(parents=True)
    script = root / "rank.py"
    script.write_text(_RANK)
    writer = {"jax": JAX, "port": PORT}[pkg]
    f = fleet.FleetSupervisor(
        2, policy=sup.RetryPolicy(retries=2, backoff_base_s=0.01,
                                  backoff_max_s=0.02),
        journal=sup.Journal(str(root / "fleet.jsonl")), kill_grace_s=5.0,
        poll_s=0.05, seed=0, workdir=str(root / "fleet"),
        ledger_path=str(root / "RUNS.jsonl"))
    res = f.run([sys.executable, str(script), writer, str(root)],
                name="scripted",
                snapshot_dir_template=str(root / "rank{rank}" / "snapshots"),
                stdout_dir=str(root / "out"),
                env_extra={"OBS_DIR": str(root / "flight"),
                           "PYTHONPATH": REPO})
    assert res.status == "ok" and res.gang_attempts == 2, res
    return str(root)


def _heal_scenario() -> dict:
    return {"name": "heal", "seed": 0, "tick_s": 0.25, "horizon_s": 400,
            "devices": 2,
            "jobs": [{"job": "bench1", "kind": "bench", "ranks": 2,
                      "steps": 60, "est_step_time_s": 0.5, "retries": 2},
                     {"job": "train1", "kind": "train", "ranks": 2,
                      "steps": 4, "est_step_time_s": 0.5, "priority": 20,
                      "start_after_s": 6.0}],
            "events": [{"at": 8.0, "kind": "straggler", "job": "bench1",
                        "rank": 1}]}


def _live_queue(root) -> str:
    """A live port Scheduler over stdlib children: the bench job is
    evicted for the serve job and resumes (``tests/test_torch_sim.py``'s
    live queue)."""
    prog = str(root / "progress")
    victim = root / "victim.py"
    victim.write_text(textwrap.dedent("""
        import os, signal, sys, time
        prog = os.environ["PROG"]
        signal.signal(signal.SIGTERM, lambda s, f: sys.exit(143))
        while True:
            n = sum(1 for _ in open(prog)) if os.path.exists(prog) else 0
            if n >= 10:
                sys.exit(0)
            with open(prog, "a") as f:
                f.write(f"i{n}\\n")
            time.sleep(0.1)
    """))
    sched = psched.Scheduler(
        [psched.Job(job="a", argv=[sys.executable, str(victim)],
                    kind="bench", env={"PROG": prog}),
         psched.Job(job="b", argv=[sys.executable, "-c", "pass"],
                    kind="serve", ranks=2, start_after_s=0.4)],
        devices=2, workdir=str(root / "sched"), tick_s=0.05, poll_s=0.02,
        seed=0, retry_policy=psup.RetryPolicy(retries=3,
                                              backoff_base_s=0.05,
                                              backoff_max_s=0.1))
    assert sched.run()["jobs"] == {"a": "done", "b": "done"}
    return str(root / "sched" / "RUNS.jsonl")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs_tools")
    out = {f"{pkg}_gang": _gang(pkg, root / pkg) for pkg in ("jax", "port")}
    for pkg, (cls, load) in {"jax": (JaxWorld, jax_load),
                             "port": (SimWorld, load_scenario)}.items():
        world = cls(load(_heal_scenario()), str(root / f"{pkg}_sim"))
        world.run()
        out[f"{pkg}_sim"] = world.ledger_path
    out["port_sched"] = _live_queue(root)
    return out


def _ledger(files, name: str) -> str:
    return (os.path.join(files[name], "RUNS.jsonl") if name.endswith("_gang")
            else files[name])


def _run_id(path: str, rank: int, attempt: int) -> str:
    """The run of one rank attempt (two ranks start in either order)."""
    folded = pledger.runs(path)
    (run,) = [r for r in folded["order"]
              if (folded["runs"][r]["start"] or {}).get("rank") == rank
              and folded["runs"][r]["start"].get("attempt") == attempt]
    return run


# ---- obs_report ----------------------------------------------------------

@pytest.mark.parametrize("fmt", ["md", "json", "trace"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_obs_report_prints_the_jax_tools_bytes(files, writer, fmt):
    root = files[f"{writer}_gang"]
    argv = ["--dir", os.path.join(root, "flight"),
            "--journal", os.path.join(root, "fleet.jsonl"),
            "--ledger", os.path.join(root, "RUNS.jsonl"), "--format", fmt]
    jax_rc, jax_out = _call(jax_obs_report.main, argv)
    rc, out = _call(obs_report.main, argv)
    assert (rc, out) == (jax_rc, jax_out)
    assert rc == 0 and out
    if fmt == "md":
        # the lost rank, its crash and the agreed restart step are named
        assert "## Per-rank timeline — `fleet.jsonl`" in out
        assert "| 1 | 0 | `rank_exit` | rc=7 |" in out
        assert "| 1 | 0 | `gang_teardown` | rank_crash |" in out
        assert "agreed step 2; rank 0: [1, 2, 3], rank 1: [1, 2]" in out
        assert "## Flight — `flight_1_" in out
    elif fmt == "trace":
        trace = json.loads(out)
        lanes = {e["pid"] for e in trace["traceEvents"]
                 if e.get("ph") == "X"}
        assert {0, 1} <= lanes


def test_obs_report_on_flights_alone_and_refusal(files):
    """Flight files given by path (no journal), and the nothing-to-render
    refusal, as in the JAX tool."""
    flight_dir = os.path.join(files["port_gang"], "flight")
    flights = sorted(os.path.join(flight_dir, n)
                     for n in os.listdir(flight_dir))
    assert len(flights) >= 4          # both ranks, both attempts
    for argv in (flights, []):
        assert _call(obs_report.main, argv) == \
            _call(jax_obs_report.main, argv)


# ---- obs_query -----------------------------------------------------------

def _argv(files, ledger: str, verb: str) -> list[str]:
    path = _ledger(files, ledger)
    run = (lambda rank, attempt: _run_id(path, rank, attempt)
           if ledger.endswith("_gang") else "x")
    args = {"list": ["list"],
            "list_filtered": ["list", "--entrypoint", "scripted",
                              "--outcome", "ok"],
            "show": ["show", run(0, 1)],
            "show_prefix": ["show", run(1, 1)[:-1]],
            "diff": ["diff", run(0, 0), run(1, 1)],
            "why_bench1": ["why", "bench1"], "why_train1": ["why", "train1"],
            "why_a": ["why", "a"], "why_b": ["why", "b"],
            "why_unknown": ["why", "nope"],
            "show_unknown": ["show", "zzzz"]}[verb]
    return args + ["--ledger", path]


_QUERIES = [(ledger, verb)
            for ledger in ("jax_gang", "port_gang")
            for verb in ("list", "list_filtered", "show", "show_prefix",
                         "diff", "show_unknown")] + [
    (ledger, verb) for ledger in ("jax_sim", "port_sim")
    for verb in ("list", "why_bench1", "why_train1", "why_unknown")] + [
    ("port_sched", verb) for verb in ("list", "why_a", "why_b")]


@pytest.mark.parametrize("fmt", ["md", "json"])
@pytest.mark.parametrize("ledger,verb", _QUERIES,
                         ids=[f"{l}-{v}" for l, v in _QUERIES])
def test_obs_query_prints_the_jax_tools_bytes(files, ledger, verb, fmt):
    argv = _argv(files, ledger, verb) + ["--format", fmt]
    jax_rc, jax_out = _call(jax_obs_query.main, argv)
    rc, out = _call(obs_query.main, argv)
    assert (rc, out) == (jax_rc, jax_out)
    if verb.endswith("_unknown"):
        assert "not found" in rc
    else:
        assert rc == 0 and out


def test_obs_query_renders_the_gang_and_the_scheduler(files):
    """What the byte comparison cannot see by itself: the rows say what
    happened.  The port-written gang has a run per gang attempt and per
    rank attempt, the restart agreement, and a layout per run; the live
    queue's ``why`` names the eviction and the resumed placement."""
    rc, out = _call(obs_query.main, _argv(files, "port_gang", "list")
                    + ["--format", "json"])
    listed = json.loads(out)
    outcomes = sorted((r["entrypoint"], r["attempt"], r["rank"],
                       r["outcome"]) for r in listed["runs"])
    assert outcomes == [
        ("scripted", 0, None, "crash"), ("scripted", 1, None, "ok"),
        ("scripted_rank", 0, 0, "running/lost"),    # torn down by TERM
        ("scripted_rank", 0, 1, "unreported"),      # the crash, rc 7
        ("scripted_rank", 1, 0, "ok"), ("scripted_rank", 1, 1, "ok")]
    assert [a["agreed"] for a in listed["agreements"]] == [2]
    rc, out = _call(obs_query.main, _argv(files, "port_gang", "diff")
                    + ["--format", "json"])
    diff = json.loads(out)
    assert diff["update_layout"] == {"a": "tree", "b": "bucket_rows"}
    assert diff["config_diff"]["bucket_grads"] == {"a": "", "b": "4096"}
    rc, out = _call(obs_query.main, _argv(files, "port_sched", "why_a"))
    assert "EVICTED:" in out and "resuming from snapshots" in out
    assert "preempted 1x (for `b`)" in out and "finally completed" in out


def test_trajectory_is_refused_by_name(capsys):
    """Without ``--records_dir``: the repository's root holds the JAX
    package's records (``tests/test_torch_bench_ratchet.py`` holds the
    verb with one against the JAX tool)."""
    assert obs_query.main(["trajectory"]) == 2
    assert obs_query.main(["trajectory", "--format", "json",
                           "--family", "BENCH"]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert captured.err.count(
        "obs_query: trajectory needs --records_dir") == 2


# ---- torch-free, and walked by the import guard --------------------------

_PROBE = textwrap.dedent("""
    import importlib, runpy, sys
    for name in sys.argv[2].split(","):
        importlib.import_module(name)
    code = 0
    if sys.argv[1]:
        sys.argv = [sys.argv[1]] + sys.argv[3:]
        try:
            runpy.run_module(sys.argv[0], run_name="__main__",
                             alter_sys=True)
        except SystemExit as e:
            code = e.code
    banned = sorted(m for m in sys.modules if m.split(".")[0] in (
        "torch", "jax", "jaxlib", "distributedtensorflowexample_tpu"))
    print("BANNED", banned, file=sys.stderr)
    sys.exit(code)
""")


def _probe(module: str, imports: str, *args) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", _PROBE, module, imports,
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)


def test_readers_sim_and_spec_import_neither_torch_nor_jax(files, tmp_path):
    """In fresh interpreters: importing ``engine.spec``, ``engine``,
    ``sim`` and the three tools, and running each tool's ``-m`` entry
    point on real files, loads neither torch nor JAX."""
    imports = ",".join(f"{PORT}.{m}" for m in (
        "engine.spec", "engine", "sim", "tools.sim_run", "tools.obs_query",
        "tools.obs_report"))
    scenario = tmp_path / "heal.json"
    scenario.write_text(json.dumps(_heal_scenario()))
    runs = [
        ("", ()),
        (f"{PORT}.tools.obs_query", ("why", "bench1", "--ledger",
                                     files["port_sim"])),
        (f"{PORT}.tools.obs_report", (
            "--dir", os.path.join(files["port_gang"], "flight"),
            "--journal", os.path.join(files["port_gang"], "fleet.jsonl"),
            "--format", "trace")),
        (f"{PORT}.tools.sim_run", (str(scenario), "--workdir",
                                   str(tmp_path / "w"))),
    ]
    for module, args in runs:
        proc = _probe(module, imports, *args)
        assert proc.returncode == 0, (module, proc.stderr[-3000:])
        assert "BANNED []" in proc.stderr, (module, proc.stderr[-3000:])
    # the lazy exports still resolve, in this process
    from distributedtensorflowexample_tpu_torch import engine, resilience
    from distributedtensorflowexample_tpu_torch.engine import (
        engine as engine_mod)
    assert engine.Engine is engine_mod.Engine
    assert engine.RunSpec is engine_mod.RunSpec
    assert resilience.Scheduler is psched.Scheduler
    with pytest.raises(AttributeError):
        engine.NotAName


def test_import_guard_walks_the_new_modules():
    """``tests/test_torch_import_guard.py`` imports every module that
    ``pkgutil.walk_packages`` finds under the port: the simulator and the
    readers are among them."""
    names = {m.name for m in pkgutil.walk_packages(port_pkg.__path__,
                                                   PORT + ".")}
    for mod in ("sim", "sim.clock", "sim.events", "sim.fleet",
                "sim.harness", "sim.metrics", "sim.scenario",
                "sim.traffic", "tools.sim_run", "tools.obs_query",
                "tools.obs_report"):
        assert f"{PORT}.{mod}" in names
