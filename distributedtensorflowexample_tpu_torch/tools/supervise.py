# graftlint: stdlib-only
"""Run any entrypoint — or the whole capture sequence of the port's
harnesses — under the resilience supervisor (heartbeat watchdog,
jittered backoff, bounded retries, journaled resume): the JAX package's
``tools/supervise.py``.

Two modes:

  # one supervised command (trainer, bench, anything):
  python -m distributedtensorflowexample_tpu_torch.tools.supervise \\
      --retries 5 --heartbeat_timeout_s 600 -- \\
      python -m distributedtensorflowexample_tpu_torch.trainers.trainer_sync_mnist \\
         --dataset synthetic --train_steps 5000 --log_dir /tmp/run
  # exit code mirrors the child's final verdict (0 ok, 3 wedged, else rc)

  # the journaled capture queue over the port's harnesses, every artifact
  # under --records_dir (required); --tiny passes --tiny to each harness:
  python -m distributedtensorflowexample_tpu_torch.tools.supervise \\
      --capture --records_dir records/

The child runs in its own process group; ``SUPERVISE_ATTEMPT``,
``SUPERVISE_HEARTBEAT`` (and the timeout edge), ``SUPERVISE_JOURNAL``
and ``OBS_PHASE`` are exported to it.  The port's trainers beat at step
boundaries when ``SUPERVISE_HEARTBEAT`` is set, save and exit 143 on
SIGTERM, and resume from their checkpoint on the restart.
``--heartbeat_timeout_s`` without ``--heartbeat`` derives a beat file in
the temporary directory.

Capture mode runs, by priority (:func:`_capture_tasks`, the JAX queue's
phases over the port's ``tools``):

  headline_bench  tools.bench --headline_only      -> OUT_HEADLINE
  profile         tools.bench_profile --trace_dir  -> PROFILE_OUT; the
                  stale trace removed first, the trace tarred to
                  TRACE_TGZ after when it is <= 25 MB
  collectives     tools.bench_collectives --json   -> COLLECTIVES_OUT
  lm              tools.bench_lm --json            -> LM_OUT
  full_bench      tools.bench                      -> OUT
  cli_trainer     trainers.trainer_sync_mnist      -> CLI_OUT; a 1800 s
                  wall timeout, and only once OUT holds a measured line
                  of THIS capture (``fresh_measured``)

The ``--json`` artifacts are written to ``<name>.tmp`` and promoted after
a clean exit (an empty one is dropped), so a killed attempt never
clobbers an earlier record.  The JAX queue's ``bytes_audit_cpu`` task is
left out: ``tools/bytes_audit.py`` decomposes XLA's ``cost_analysis``,
which has no PyTorch counterpart (the FLOPs come from the shapes,
``utils/flops.py``).  The env names OUT, OUT_HEADLINE, PROFILE_OUT,
COLLECTIVES_OUT, LM_OUT, TRACE_TGZ, CLI_OUT, TRACE_DIR and LOG (the
children's stderr) are the JAX surface, read relative to
``--records_dir``; their defaults are the port's own names there, never
the JAX defaults (files that stand at the repo root).  The journal
(SUPERVISE_JOURNAL, default ``<records_dir>/supervise_capture.jsonl``)
makes a relaunch skip the tasks already done; a capture that ran to its
end (``capture_end``) is rotated to ``.prev`` with its flight directory
(OBS_DIR, default beside the journal) so the next one starts fresh.  The
pidfile is CAPTURE_PIDFILE (default ``<records_dir>/capture.pid``).
``--tiny`` passes ``--tiny`` to every harness, gives the collectives
task its smallest sweep (2 ranks, 4 KiB and 4 MiB, 3 repeats) and the
trainer 200 steps.  Exit 3 when a task left a wedge verdict, else 0 (the
journal has each task's result).

Either mode: exporting OBS_PROM_DIR makes every completed task refresh
<OBS_PROM_DIR>/supervise.prom (node-exporter textfile-collector
dialect) with the live attempt/kill/heartbeat counters.  For N-process
gangs, see ``supervise_fleet``.
"""

from __future__ import annotations

import argparse
import atexit
import glob
import os
import shutil
import subprocess
import sys
import tempfile
import time

from distributedtensorflowexample_tpu_torch.obs import recorder as obs_recorder
from distributedtensorflowexample_tpu_torch.resilience.supervisor import (
    Journal, RetryPolicy, Supervisor, Task, TaskQueue)

_PKG = "distributedtensorflowexample_tpu_torch"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: The collectives task's sweep under ``--tiny``.
TINY_COLLECTIVES = ["--submeshes", "2", "--sizes", "4096,4194304",
                    "--repeats", "3"]
#: The trainer task's steps (``--tiny``: 200).
CLI_STEPS, TINY_CLI_STEPS = 5000, 200


def _write_pidfile(path: str) -> None:
    """The pidfile contract: a watcher reads it for liveness, and the exit
    cleanup removes it only if it is still this process's."""
    with open(path, "w") as f:
        f.write(str(os.getpid()))

    def _cleanup():
        try:
            with open(path) as f:
                mine = f.read().strip() == str(os.getpid())
        except OSError:
            return
        if mine:
            os.remove(path)

    atexit.register(_cleanup)


def _capture_tasks(start_ts: float, full_bench_done_prior: bool = False, *,
                   records_dir: str, tiny: bool = False) -> list[Task]:
    """The capture queue (module docstring), every artifact under
    ``records_dir``."""
    env = os.environ
    py = sys.executable
    at = lambda name, default: os.path.join(records_dir,
                                            env.get(name, default))
    log = at("LOG", "capture.log")
    out = at("OUT", "BENCH_capture.json")
    out_headline = at("OUT_HEADLINE", "BENCH_headline_capture.json")
    profile_out = at("PROFILE_OUT", "PROFILE_capture.json")
    collectives_out = at("COLLECTIVES_OUT", "BENCH_collectives_capture.json")
    lm_out = at("LM_OUT", "BENCH_lm_capture.json")
    trace_tgz = at("TRACE_TGZ", "resnet_trace_capture.tgz")
    cli_out = at("CLI_OUT", "CLI_capture.log")
    trace_dir = at("TRACE_DIR", "resnet_trace")
    small = ["--tiny"] if tiny else []
    tool = lambda name: [py, "-m", f"{_PKG}.tools.{name}"]

    def tar_trace() -> None:
        if not os.path.isdir(trace_dir):
            return
        size_mb = sum(
            os.path.getsize(os.path.join(r, f))
            for r, _, fs in os.walk(trace_dir) for f in fs) // 2**20
        if size_mb <= 25:
            subprocess.run(["tar", "czf", trace_tgz,
                            "-C", os.path.dirname(trace_dir),
                            os.path.basename(trace_dir)], check=False)

    def keep_json(tmp: str, final: str):
        """Promote a non-empty tmp, drop an empty one (a killed attempt
        never clobbers an earlier artifact)."""
        def _keep() -> None:
            if os.path.exists(tmp):
                if os.path.getsize(tmp):
                    os.replace(tmp, final)
                else:
                    os.remove(tmp)
        return _keep

    def fresh_measured() -> bool:
        """The trainer runs only once a full bench of THIS capture wrote a
        measured line to OUT (not a leftover file, not a sentinel).
        "This capture" is the journal's notion: on a resumed capture
        full_bench is done_prior and OUT predates start_ts, yet it is
        this capture's artifact."""
        try:
            if (os.path.getmtime(out) < start_ts
                    and not full_bench_done_prior):
                return False
            with open(out) as f:
                return '"unit": "steps/sec/chip"' in f.read()
        except OSError:
            return False

    def rm_trace_dir() -> None:
        # A stale trace must not be tarred as this capture's.
        shutil.rmtree(trace_dir, ignore_errors=True)

    return [
        # The headline first: the contract metric before anything else.
        Task("headline_bench", [*tool("bench"), "--headline_only", *small],
             priority=10, stdout_path=out_headline, stderr_path=log),
        Task("profile", [*tool("bench_profile"), "--trace_dir", trace_dir,
                         *small],
             priority=20, stdout_path=profile_out, stderr_path=log,
             pre=rm_trace_dir, post=tar_trace),
        Task("collectives",
             [*tool("bench_collectives"), "--json", collectives_out + ".tmp",
              *(TINY_COLLECTIVES if tiny else [])],
             priority=27, stderr_path=log,
             post=keep_json(collectives_out + ".tmp", collectives_out)),
        Task("lm", [*tool("bench_lm"), "--json", lm_out + ".tmp", *small],
             priority=28, stderr_path=log,
             post=keep_json(lm_out + ".tmp", lm_out)),
        Task("full_bench", [*tool("bench"), *small], priority=30,
             stdout_path=out, stderr_path=log),
        # Bounded: SIGTERM and grace first (the trainer saves and exits
        # 143), KILL only as the last resort.
        Task("cli_trainer",
             [py, "-m", f"{_PKG}.trainers.trainer_sync_mnist",
              "--dataset", "synthetic",
              "--train_steps", str(TINY_CLI_STEPS if tiny else CLI_STEPS),
              "--batch_size", "64",
              "--log_every", "100" if tiny else "1000",
              "--log_dir", os.path.join(records_dir, "cli_run"),
              "--resume", "false"],
             priority=40, stdout_path=cli_out, stderr_path=log,
             wall_timeout_s=1800.0, gate=fresh_measured),
    ]


def _capture_ended(journal_path: str) -> bool:
    """True if the journal's capture already ran to its end
    (``capture_end`` journaled): the resume exists for a supervisor that
    died mid-run, not to suppress the next capture."""
    try:
        with open(journal_path) as f:
            return any('"event": "capture_end"' in line for line in f)
    except OSError:
        return False


def run_capture(args) -> int:
    records_dir = os.path.abspath(args.records_dir)
    os.makedirs(records_dir, exist_ok=True)
    # The harnesses run as ``python -m`` from the package's checkout.
    os.chdir(_REPO)
    _write_pidfile(os.path.join(records_dir, os.environ.get(
        "CAPTURE_PIDFILE", "capture.pid")))
    journal_path = os.path.join(records_dir, os.environ.get(
        "SUPERVISE_JOURNAL", "supervise_capture.jsonl"))
    # Flight files (the supervisor's own and every task child's) land
    # beside the journal; children inherit OBS_DIR; an operator's OBS_DIR
    # wins.
    obs_dir_preset = "OBS_DIR" in os.environ
    flight_dir = os.environ.setdefault(
        "OBS_DIR", os.path.splitext(journal_path)[0] + "_flight")
    if _capture_ended(journal_path):
        # The previous capture ran to its end: rotate it (and the default
        # flight dir with it) so this one captures afresh.
        os.replace(journal_path, journal_path + ".prev")
        if not obs_dir_preset and os.path.isdir(flight_dir):
            shutil.rmtree(flight_dir + ".prev", ignore_errors=True)
            os.replace(flight_dir, flight_dir + ".prev")
        print(f"supervise: previous capture ended — journal rotated to "
              f"{journal_path}.prev (flight dir alongside)",
              file=sys.stderr, flush=True)
    os.makedirs(flight_dir, exist_ok=True)
    obs_recorder.install(sigterm=False)
    start_ts = time.time()
    journal = Journal(journal_path)
    sup = Supervisor(policy=RetryPolicy(retries=0),
                     journal=journal, kill_grace_s=30.0, seed=args.seed)
    prior_done = journal.replay()["done"]
    queue = TaskQueue(_capture_tasks(
        start_ts, full_bench_done_prior="full_bench" in prior_done,
        records_dir=records_dir, tiny=args.tiny), sup)
    results = queue.run()
    if "terminated" not in results.values():
        # A terminated run journals no end: the next one resumes from the
        # first unfinished task.
        journal.write("capture_end", results=results)
    print(f"supervise: capture done: {results}", file=sys.stderr, flush=True)
    obs_recorder.dump_global("capture_end")
    flights = sorted(glob.glob(os.path.join(flight_dir, "flight_*.json")))
    print(f"supervise: {len(flights)} flight file(s) in {flight_dir} — "
          f"render with: python -m {_PKG}.tools.obs_report --dir "
          f"{flight_dir} --journal {journal_path}", file=sys.stderr,
          flush=True)
    return 3 if "wedged" in results.values() else 0


def run_command(args, argv: list[str]) -> int:
    # The supervisor's own flight (attempt counters, heartbeat-age
    # gauge, escalation reason) — written on watchdog kills and exit.
    obs_recorder.install(sigterm=False)
    sup = Supervisor(
        policy=RetryPolicy(retries=args.retries,
                           backoff_base_s=args.backoff_base_s,
                           backoff_max_s=args.backoff_max_s),
        journal=Journal(args.journal),
        heartbeat_timeout_s=args.heartbeat_timeout_s,
        wall_timeout_s=args.timeout_s,
        kill_grace_s=args.kill_grace_s,
        seed=args.seed)
    res = sup.run(argv, name=args.name, stdout_path=args.stdout,
                  heartbeat_path=args.heartbeat)
    if res.status == "ok":
        return 0
    if res.status == "terminated":
        # We were SIGTERM'd and forwarded it (child group killed with
        # grace): report 143 so a wrapper honoring the 0/143/3 protocol
        # sees a clean termination, not a crash to backoff-retry.
        return 143
    return res.returncode if res.returncode is not None else 1


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    child: list[str] = []
    if "--" in argv:
        split = argv.index("--")
        argv, child = argv[:split], argv[split + 1:]
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--capture", action="store_true",
                   help="run the journaled capture queue over the port's "
                        "harnesses (needs --records_dir)")
    p.add_argument("--records_dir", default="",
                   help="--capture: where every artifact, the journal and "
                        "the pidfile go")
    p.add_argument("--tiny", action="store_true",
                   help="--capture: each harness at its --tiny sizes")
    p.add_argument("--retries", type=int, default=3)
    p.add_argument("--backoff_base_s", type=float, default=1.0)
    p.add_argument("--backoff_max_s", type=float, default=60.0)
    p.add_argument("--timeout_s", type=float, default=0.0,
                   help="wall deadline per attempt (0 = none)")
    p.add_argument("--heartbeat_timeout_s", type=float, default=0.0,
                   help="kill when the heartbeat file goes stale this "
                        "long (0 = no heartbeat watchdog)")
    p.add_argument("--heartbeat", default="",
                   help="heartbeat file path (exported to the child as "
                        "SUPERVISE_HEARTBEAT; trainers touch it at step "
                        "boundaries)")
    p.add_argument("--kill_grace_s", type=float, default=10.0,
                   help="SIGTERM-to-SIGKILL grace (covers the child's "
                        "save-on-exit)")
    p.add_argument("--journal", default="", help="JSON-lines journal path")
    p.add_argument("--stdout", default="",
                   help="child stdout file (keep() semantics: an empty "
                        "attempt never clobbers a previous one)")
    p.add_argument("--name", default="", help="task name for the journal")
    p.add_argument("--seed", type=int, default=None,
                   help="backoff-jitter seed (tests)")
    args = p.parse_args(argv)
    if args.capture:
        if not args.records_dir:
            p.error("--capture needs --records_dir (the artifacts never go "
                    "to the repo root)")
        return run_capture(args)
    args.journal = args.journal or None
    args.stdout = args.stdout or None
    args.heartbeat = args.heartbeat or None
    if args.heartbeat_timeout_s and not args.heartbeat:
        # The advertised one-liner passes only the timeout; without a
        # derived path the watchdog would silently arm against NOTHING
        # (no SUPERVISE_HEARTBEAT exported, no beats, no kills).
        args.heartbeat = os.path.join(
            tempfile.gettempdir(), f"supervise_hb_{os.getpid()}")
        print(f"supervise: heartbeat file defaulted to {args.heartbeat}",
              file=sys.stderr, flush=True)
    if not child:
        p.error("nothing to run: pass --capture, or -- CMD ARGS...")
    return run_command(args, child)


if __name__ == "__main__":
    raise SystemExit(main())
