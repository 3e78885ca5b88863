# graftlint: stdlib-only
"""schedule — the ledger-driven control plane: run a queue of
heterogeneous jobs (train / bench / faultline drill / serving load
tests) on gang slots with elastic autoscaling and loss-free SLO
preemption (``resilience/scheduler.py``; the JAX package's
``tools/schedule.py`` on the port).

  # run a queue file (JSON list of job dicts; see resilience/scheduler.Job):
  python -m distributedtensorflowexample_tpu_torch.tools.schedule \\
      --queue jobs.json --workdir /tmp/sched --devices 4
  # the canned acceptance drill: an 8-job mixed queue over 4 slots —
  # one injected rank loss (host_loss), one SLO eviction, zero manual
  # intervention (add --device cpu on a host without a card):
  python -m distributedtensorflowexample_tpu_torch.tools.schedule \\
      --demo --workdir /tmp/sched

``--devices`` counts gang slots.  The scheduler process itself never
touches a device; each placed rank takes its card by the port's rule
(``rank % device_count``, ``parallel/mesh.py``), so one card holds every
slot.

A job dict names what to run (`argv`, with ``{rank}``/``{num_ranks}``
substituted per rank), how wide (`ranks`), how urgent (`priority`, or
an SLO class via `kind` — serve=0 < train=10 < bench=20 < drill=30,
overridable with SCHED_SLO_PRIORITIES), and what it costs: the job's
declared `est_step_time_s` (or, with ``--trajectory PATH``, the
measured steps/sec of the trajectory row whose family contains the
job's `family`), which prices admission and derives the per-attempt
wall deadline.  ``--trajectory`` defaults to no file: the repository's
``BENCH_trajectory.json`` holds the JAX package's rates on another
chip, which would set an H100 job's deadline from the wrong device.
Each placement runs under the gang supervisor (resilience/fleet.py)
with the job's `snapshots` template, so preemption is the
TERM→143→snapshot protocol and a relaunch resumes bitwise from the
agreed step.

The scheduler is crash-tolerant: decisions are write-ahead journaled
(<workdir>/sched.jsonl) and a SIGKILLed scheduler resumes by rerunning
the SAME command — terminal decisions replay idempotently, orphaned
rank groups are swept, and unfinished jobs requeue.  Every decision is
also a ``sched_*`` row in <workdir>/RUNS.jsonl (obs/ledger.py).

``--record PATH`` writes a queue-completion record (JSON lines, the
bench-record dialect), naming the device the jobs ran on, and the
card's name and power limit (``nvidia-smi``) when that is the card.

Exit codes: 0 every job done (refusals are operator errors, reported
but not fatal), 3 some job quarantined (backend wedged), 1 failures,
143 terminated (SIGTERM — rerun to resume).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from distributedtensorflowexample_tpu_torch.obs import recorder as obs_recorder
from distributedtensorflowexample_tpu_torch.resilience import scheduler as sched
from distributedtensorflowexample_tpu_torch.resilience.supervisor import (
    Journal)
from distributedtensorflowexample_tpu_torch.tools.bench_ratchet import (
    card_name_and_power_limit, describe_device)

TOOLS = "distributedtensorflowexample_tpu_torch.tools."
SERVE_LM = "distributedtensorflowexample_tpu_torch.serving.serve_lm"


def demo_queue(workdir: str, steps: int = 12, slow_s: float = 0.4,
               device: str = "cuda") -> list[dict]:
    """The acceptance drill's 8-job mixed queue, all on the port's own
    entry points (``-m ...tools.faultline``, ``-m ...serving.serve_lm``),
    each given ``--device``:

    - 4 quick ``train`` jobs (t1..t4) filling the slots in priority
      order;
    - ``elastic2`` — a 2-rank train job whose rank 1 HOST dies mid-run
      (``host_loss``): the gang tears down, the respawn fails like a
      dead host, the survivors continue elastically, and the recovery
      re-probe grows the gang back when the tombstone expires;
    - ``wedge1`` — exits rc 3 (backend wedged): quarantined, never
      requeued;
    - ``bench1`` — a slow bench job (persistent ``slow_rank`` delay =
      a real bench's pace) that a late-arriving
    - ``serve1`` — a serving fleet: 4 ranks of ``serve_lm``, each
      promoting a snapshot and driving its closed loop (priority 0,
      ready once bench1 proves mid-run progress via its step-6
      snapshot) EVICTS bench1: TERM→143→snapshot, then bench1 resumes
      with zero lost steps.  An evicted serving rank drains its
      in-flight requests before its own 143.
    """
    py = sys.executable
    faultline = [py, "-m", TOOLS + "faultline", "--device", device]
    serve_dir = os.path.join(workdir, "jobs", "serve1", "rank{rank}")

    def fl(job, plan, job_steps=steps, ranks=1, **kw):
        base = {"job": job, "ranks": ranks,
                "argv": [*faultline, "--plan", plan,
                         "--steps", str(job_steps),
                         "--workdir", os.path.join(workdir, "jobs", job,
                                                   "rank{rank}"),
                         "--keep", "20", "--seed", "0"],
                "snapshots": os.path.join(workdir, "jobs", job,
                                          "rank{rank}", "snapshots"),
                "steps": job_steps, "est_step_time_s": 0.5}
        base.update(kw)
        return base

    return [
        fl("t1", "none", 4, kind="train"),
        fl("t2", "none", 4, kind="train"),
        fl("t3", "none", 4, kind="train"),
        fl("t4", "none", 4, kind="train"),
        # rank 1's host dies at step 2 and answers again 2 s later —
        # the elastic shrink + grow-on-recovery path, end to end.  The
        # unpinned slow_rank paces BOTH ranks so the survivor is still
        # mid-run when the tombstone expires.
        fl("elastic2", f"host_loss@2:2.0%1,slow_rank@1:{slow_s}", steps,
           ranks=2, kind="train", fleet_retries=4, elastic=True),
        {"job": "wedge1", "kind": "drill", "ranks": 1, "retries": 0,
         "argv": [py, "-c", "import sys; sys.exit(3)"],
         "est_step_time_s": 0.1, "steps": 1},
        # the victim: slow enough (slow_rank from step 1) that serve1's
        # arrival finds it mid-run; snapshots every step make the
        # eviction loss-free.
        fl("bench1", f"slow_rank@1:{slow_s}", steps, kind="bench"),
        # ready the moment bench1's step-6 snapshot commits (no
        # wall-clock guessing): a full-width, priority-0 serving fleet
        # that cannot fit without evicting someone.
        {"job": "serve1", "kind": "serve", "ranks": 4,
         "argv": [py, "-m", SERVE_LM, "--device", device,
                  "--snapshot", os.path.join(serve_dir, "snaps"),
                  "--size", "lm_tiny", "--init_if_missing",
                  "--slots", "2", "--max_len", "32",
                  "--drive", "24", "--clients", "2",
                  "--drive_max_new", "6",
                  "--results", os.path.join(serve_dir, "results.jsonl"),
                  "--stats", os.path.join(serve_dir, "stats.json")],
         "steps": 24, "est_step_time_s": 1.0,
         "after_file": os.path.join(workdir, "jobs", "bench1", "rank0",
                                    "snapshots", "snap_00000006.npz")},
    ]


def write_record(path: str, summary: dict, devices: int,
                 device: str = "cpu") -> None:
    """Queue-completion record, bench-record dialect: one JSON line per
    metric (SCHED_queue_*), each naming the device the jobs ran on (and,
    on the card, its name and power limit, also as ``detail.device``,
    which ``tools.bench_ratchet`` pivots on)."""
    detail = {"platform": device, "devices": devices,
              "status": summary["status"], "counts": summary["counts"],
              "makespan_s": summary["makespan_s"],
              "evictions": summary["evictions"],
              "shrinks": summary["shrinks"], "grows": summary["grows"],
              "retries": summary["retries"], "jobs": summary["jobs"]}
    detail["device"] = describe_device(device)
    if device == "cuda":
        detail["gpu"] = card_name_and_power_limit() or "not measured"
    done = summary["counts"].get("done", 0)
    rows = [
        {"metric": "sched_queue_jobs_done", "value": done,
         "unit": "jobs", "platform": device, "detail": detail},
        {"metric": "sched_queue_jobs_per_min",
         "value": (round(60.0 * done / summary["makespan_s"], 3)
                   if summary["makespan_s"] else 0.0),
         "unit": "jobs/min", "platform": device, "detail": detail},
    ]
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for row in rows:
            f.write(json.dumps(row, sort_keys=True) + "\n")
    os.replace(tmp, path)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--queue", default="",
                   help="queue file: JSON list of job dicts (or "
                        "{'jobs': [...]}); default $SCHED_QUEUE")
    p.add_argument("--demo", action="store_true",
                   help="write + run the canned 8-job mixed acceptance "
                        "queue (faultline jobs: one host_loss rank "
                        "kill, one SLO eviction) instead of --queue")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the device the --demo jobs run on, and the one "
                        "--record names (the scheduler itself uses "
                        "none)")
    p.add_argument("--devices", type=int, default=4,
                   help="gang slots (each placed rank takes card "
                        "rank %% device_count)")
    p.add_argument("--workdir", default="/tmp/sched",
                   help="scheduler scratch: sched.jsonl journal, "
                        "RUNS.jsonl ledger, per-job fleet workdirs")
    p.add_argument("--tick_s", type=float, default=None,
                   help="policy-loop cadence (default $SCHED_TICK_S, "
                        f"else {sched.DEFAULT_TICK_S}s)")
    p.add_argument("--ledger", default="",
                   help="run-ledger path (default <workdir>/RUNS.jsonl; "
                        "'none' disables)")
    p.add_argument("--journal", default="",
                   help="scheduler write-ahead journal (default "
                        "<workdir>/sched.jsonl)")
    p.add_argument("--max_job_s", type=float, default=0.0,
                   help="refuse jobs whose predicted cost exceeds this "
                        "(0 = no ceiling)")
    p.add_argument("--cost_margin", type=float, default=16.0,
                   help="per-attempt wall deadline = margin x predicted "
                        "cost, when the job pins no wall_timeout_s")
    p.add_argument("--trajectory", default="",
                   help="a trajectory file (JSON lines with family and "
                        "*steps_per_sec metrics) for measured step-time "
                        "predictions; default '' = declared estimates "
                        "only")
    p.add_argument("--record", default="",
                   help="write the queue-completion record (JSON lines, "
                        "SCHED_queue family) here")
    p.add_argument("--seed", type=int, default=0,
                   help="backoff-jitter seed (tests)")
    args = p.parse_args(argv)

    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    if args.demo:
        queue_path = os.path.join(workdir, "demo_queue.json")
        with open(queue_path, "w") as f:
            json.dump({"jobs": demo_queue(workdir, device=args.device)}, f,
                      indent=1)
        print(f"schedule: demo queue written to {queue_path}",
              file=sys.stderr, flush=True)
    else:
        queue_path = args.queue or sched.queue_path_default()
        if not queue_path:
            p.error("no queue: pass --queue FILE (or export "
                    "SCHED_QUEUE), or use --demo")
    jobs = sched.load_queue(queue_path)

    # Flight recorder for the scheduler itself (an operator's OBS_DIR
    # export wins), like the other long-running CLIs.
    os.environ.setdefault("OBS_DIR", os.path.join(workdir, "flight"))
    os.makedirs(os.environ["OBS_DIR"], exist_ok=True)
    obs_recorder.install(sigterm=False)

    s = sched.Scheduler(
        jobs, devices=args.devices, workdir=workdir,
        journal=Journal(args.journal
                        or os.path.join(workdir, "sched.jsonl")),
        ledger_path=("" if args.ledger == "none"
                     else args.ledger or None),
        tick_s=args.tick_s, seed=args.seed,
        cost_margin=args.cost_margin, max_job_s=args.max_job_s,
        trajectory_path=args.trajectory)
    summary = s.run()
    print(f"schedule: {summary['status']}: "
          + " ".join(f"{k}={v}" for k, v in summary["counts"].items()
                     if v)
          + f" makespan={summary['makespan_s']:.1f}s "
            f"evictions={summary['evictions']} "
            f"shrinks={summary['shrinks']} grows={summary['grows']} "
            f"retries={summary['retries']}",
          file=sys.stderr, flush=True)
    for jid, why in sorted(summary.get("why", {}).items()):
        if summary["jobs"][jid] in ("failed", "quarantined", "refused"):
            print(f"schedule:   {jid}: {summary['jobs'][jid]} — {why}",
                  file=sys.stderr, flush=True)
    if args.record and summary["status"] != "terminated":
        write_record(args.record, summary, args.devices, args.device)
        print(f"schedule: queue-completion record -> {args.record}",
              file=sys.stderr, flush=True)
    if summary["status"] == "terminated":
        return 143
    if summary["counts"].get("quarantined"):
        return 3
    if summary["counts"].get("failed"):
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
