# graftlint: stdlib-only
"""Run any entrypoint under the resilience supervisor (heartbeat watchdog,
jittered backoff, bounded retries, journaled attempts) — the JAX
package's ``tools/supervise.py``, generic mode:

  python -m distributedtensorflowexample_tpu_torch.tools.supervise \\
      --retries 5 --heartbeat_timeout_s 600 -- \\
      python -m distributedtensorflowexample_tpu_torch.trainers.trainer_sync_mnist \\
         --dataset synthetic --train_steps 5000 --log_dir /tmp/run
  # exit code mirrors the child's final verdict (0 ok, 3 wedged, else rc)

The child runs in its own process group; ``SUPERVISE_ATTEMPT``,
``SUPERVISE_HEARTBEAT`` (and the timeout edge), ``SUPERVISE_JOURNAL``
and ``OBS_PHASE`` are exported to it.  The port's trainers beat at step
boundaries when ``SUPERVISE_HEARTBEAT`` is set, save and exit 143 on
SIGTERM, and resume from their checkpoint on the restart.
``--heartbeat_timeout_s`` without ``--heartbeat`` derives a beat file in
the temporary directory.

``--capture`` (the JAX package's journaled capture window over its root
``bench*.py`` scripts) is refused by name: of its queue's harnesses only
``bench.py`` is ported (``tools.bench``); it still waits on
``bench_lm.py``, ``bench_profile.py`` and the ``bytes_audit`` task.

Exporting OBS_PROM_DIR makes every completed task refresh
<OBS_PROM_DIR>/supervise.prom (node-exporter textfile-collector
dialect) with the live attempt/kill/heartbeat counters.  For N-process
gangs, see ``supervise_fleet``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from distributedtensorflowexample_tpu_torch.obs import recorder as obs_recorder
from distributedtensorflowexample_tpu_torch.resilience.supervisor import (
    Journal, RetryPolicy, Supervisor)

#: ``supervise --capture``'s refusal (exit 2).
CAPTURE_REFUSAL = (
    "supervise: --capture is not ported: the JAX package's capture "
    "window queues its root bench.py, bench_lm.py, bench_profile.py and "
    "the tools/bytes_audit.py task; bench.py is ported (tools.bench, run "
    "on its own), and the capture still waits on the port's bench_lm and "
    "bench_profile, and on its bytes_audit task, which is not ported; "
    "supervise one command with -- CMD ARGS...")


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
                   help="the JAX package's capture window (refused here: "
                        "it waits for the port's bench.py and bench_lm.py)")
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
        print(CAPTURE_REFUSAL, file=sys.stderr, flush=True)
        return 2
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
        p.error("nothing to run: pass -- CMD ARGS...")
    return run_command(args, child)


if __name__ == "__main__":
    raise SystemExit(main())
