# graftlint: stdlib-only
"""Run an N-rank gang under the fleet supervisor (resilience/fleet.py):
per-rank heartbeats, whole-gang teardown on any rank loss, gang restart
from the agreed (maximum common valid) snapshot step — the JAX package's
``tools/supervise_fleet.py``.

  # 2 faultline ranks, rank 1 killed at step 4 by a rank-targeted plan
  # -> gang teardown -> gang restart from the agreed step -> both ranks
  # end bitwise equal to an uninterrupted run:
  python -m distributedtensorflowexample_tpu_torch.tools.supervise_fleet \\
      --num_ranks 2 --workdir /tmp/fleet -- \\
      python -m distributedtensorflowexample_tpu_torch.tools.faultline \\
          --plan 'kill@4%1' --steps 10 --model mnist_cnn \\
          --workdir '/tmp/fleet/rank{rank}' --keep 20
  # (add --device cpu to the faultline argv on a host without a card)

Every ``{rank}`` (and ``{num_ranks}``) in the child argv is substituted
per rank, so one command line fans out to per-rank workdirs.  Exported
per rank: TF_CONFIG (task index = rank), OBS_RANK, FLEET_NUM_RANKS,
SUPERVISE_ATTEMPT (the gang attempt), SUPERVISE_HEARTBEAT (+ the
timeout edge), OBS_HEALTH, FLEET_HOST_DOWN_FILE and — after any restart
— FLEET_RESUME_STEP, the agreed resume step every rank must restore
(0 = start fresh).  On a one-card host every rank opens its own CUDA
context on card 0.

Exit codes extend the supervisor protocol: 0 ok, 143 terminated
(SIGTERM forwarded to every rank group), 3 wedged (some rank reported
the backend provably gone), 4 rank lost + worker-tiled state (restart
with fewer workers is structurally illegal), 5 rank lost + refused
without --elastic, 1 crash budget exhausted (or a rank's own positive
rc, never 143: an exhausted fleet must not read as a clean
preemption).  With --elastic a lost rank shrinks the gang; the recovery
re-probe before every relaunch grows it back once the host answers
again (drill it with the host_loss fault).  OBS_PROM_DIR (optional)
receives a fleet.prom textfile-collector export after every gang
attempt; per-rank flight files land in OBS_DIR (default
<workdir>/flight).

``--heal`` closes the loop (``resilience/remediate.py``): the
remediation policy engine watches the same health files + ledger rows
and acts through guardrailed policies: straggler/regression → loss-free
stop + bitwise resume, NaN/plateau → rollback to the pinned last-good
snapshot, repeated host loss → rank quarantine.  Every decision is a
``heal_*`` ledger row; HEAL_DRY_RUN=1 journals without acting.  Drill it
with a slow rank (the step-time detector warmed up on 3 steps before
the slowdown):

  OBS_ANOMALY_WARMUP=3 python -m \
      distributedtensorflowexample_tpu_torch.tools.supervise_fleet \
      --num_ranks 2 --heal --kill_grace_s 30 --workdir /tmp/heal -- \
      python -m distributedtensorflowexample_tpu_torch.tools.faultline \
          --plan 'slow_rank@5:1.0%1' --steps 12 --keep 50 \
          --workdir '/tmp/heal/rank{rank}'

Online health (detection only without --heal): every rank's AnomalyHook
writes <workdir>/health_rank<r>.json; the fleet's monitor loop reads those,
flags stragglers/skew (obs/anomaly.detect_skew), annotates the journal
with ``anomaly`` events, and maintains the aggregate
<workdir>/health.json.  Every rank and the fleet append to the run
ledger <workdir>/RUNS.jsonl (exported as OBS_LEDGER; --ledger
overrides, 'none' disables).  With ``--http`` each rank gets an
OBS_HTTP_PORT export and serves /metrics, /health, /flight,
/ledger/tail live (obs/serve.py); the monitor then scrapes /health over
HTTP and falls back to the per-rank file.

The agreement pass journals its ``resume_agreement`` record
WRITE-AHEAD, so a supervisor that dies mid-discard (drill it with
``FLEET_DRILL_DIE_IN_DISCARD=<k>``) leaves an intent a restarted
invocation replays before its first launch.
"""

from __future__ import annotations

import argparse
import os
import sys

from distributedtensorflowexample_tpu_torch.obs import recorder as obs_recorder
from distributedtensorflowexample_tpu_torch.resilience import remediate
from distributedtensorflowexample_tpu_torch.resilience.fleet import (
    FleetSupervisor, RankLossRefused, RankLossStructurallyIllegal,
    resolve_ledger_dest)
from distributedtensorflowexample_tpu_torch.resilience.supervisor import (
    Journal, RetryPolicy)


def _run_healed(args, make_fleet, journal, child: list, workdir: str,
                snapshots: str):
    """``--heal``: the gang under ``remediate.run_remediated``.  One
    journal holds the fleet's AND the remediator's write-ahead records,
    one ledger both row families; the shared resolution rule
    (``fleet.resolve_ledger_dest``) keeps the remediator bound to the
    SAME file the fleet's anomaly/rank_lost rows land in.  Returns the
    last launch's ``GangResult``."""
    scope = args.name or "fleet"
    ledger_path = resolve_ledger_dest(
        "" if args.ledger == "none"
        else args.ledger or os.path.join(workdir, "RUNS.jsonl"))
    target = remediate.FleetTarget()
    actuators = {
        "evict": remediate.make_evict_actuator(target),
        "quarantine": remediate.make_quarantine_actuator(target),
    }
    if snapshots:
        actuators["rollback"] = remediate.make_rollback_actuator(
            snapshots, target=target)
    rem = remediate.Remediator(journal=journal, ledger_path=ledger_path,
                               actuators=actuators, scope=scope)
    watchers = [remediate.HealthWatcher(
        os.path.join(workdir, "health_rank*.json"),
        fleet_health=("" if args.health == "none"
                      else args.health
                      or os.path.join(workdir, "health.json")),
        scope=scope)]
    if ledger_path:
        # rank_lost ONLY: the ledger's `anomaly` rows mirror the same
        # conditions the health files already deliver — tailing both
        # would double-count one condition into one guardrail key and
        # cross the flap bar in a single poll cycle.
        watchers.append(remediate.LedgerWatcher(
            ledger_path, kinds=("rank_lost",), scope=scope))
    out = remediate.run_remediated(
        make_fleet, child, rem, watchers, target=target, name=args.name,
        snapshot_dir_template=snapshots,
        stdout_dir=args.stdout_dir or workdir,
        poll_s=args.heal_poll_s, max_heals=args.max_heals)
    print(f"supervise_fleet: heal: {out['healed']} relaunch(es), "
          f"{rem.guardrails.actions_used} action(s), final status "
          f"{out['status']}", file=sys.stderr, flush=True)
    return out["results"][-1]


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    child: list[str] = []
    if "--" in argv:
        split = argv.index("--")
        argv, child = argv[:split], argv[split + 1:]
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num_ranks", type=int, default=2)
    p.add_argument("--retries", type=int, default=3,
                   help="gang restarts after crashes (clean unanimous "
                        "preemptions are exempt)")
    p.add_argument("--backoff_base_s", type=float, default=1.0)
    p.add_argument("--backoff_max_s", type=float, default=60.0)
    p.add_argument("--timeout_s", type=float, default=0.0,
                   help="wall deadline per gang attempt (0 = none)")
    p.add_argument("--heartbeat_timeout_s", type=float, default=0.0,
                   help="tear the gang down when ANY rank's heartbeat "
                        "goes stale this long (0 = no heartbeat "
                        "watchdog)")
    p.add_argument("--kill_grace_s", type=float, default=10.0,
                   help="TERM-to-KILL grace per teardown (covers the "
                        "ranks' save-on-exit)")
    p.add_argument("--preempt_grace_s", type=float, default=30.0,
                   help="how long a partial 143 may wait for the rest "
                        "of the gang before it counts as divergence")
    p.add_argument("--workdir", default="/tmp/fleet",
                   help="fleet scratch: heartbeats, per-rank logs, "
                        "journal, flight dir")
    p.add_argument("--snapshots", default="",
                   help="per-rank SnapshotStore directory template "
                        "({rank} substituted) for the resume-step "
                        "agreement; default <workdir>/rank{rank}/"
                        "snapshots; pass 'none' to disable")
    p.add_argument("--journal", default="",
                   help="fleet journal path (default <workdir>/"
                        "fleet.jsonl)")
    p.add_argument("--stdout_dir", default="",
                   help="per-rank per-attempt child stdout files "
                        "(default <workdir>)")
    p.add_argument("--elastic", action="store_true",
                   help="on a permanently lost rank, continue with the "
                        "survivors (sync/replicated state only)")
    p.add_argument("--sync_mode", default="sync", choices=["sync", "async"],
                   help="what the ranks train: async means worker-tiled "
                        "state, where restarting with fewer workers is "
                        "structurally illegal")
    p.add_argument("--name", default="", help="task name for the journal")
    p.add_argument("--health", default="",
                   help="aggregate fleet health.json path (default "
                        "<workdir>/health.json; 'none' disables the "
                        "aggregate write — per-rank health_rank<r>.json "
                        "files land in the workdir either way)")
    p.add_argument("--skew_lag_steps", type=int, default=3,
                   help="step lag behind the front rank before a rank "
                        "counts as lagging")
    p.add_argument("--skew_time_ratio", type=float, default=4.0,
                   help="step-time multiple of the other ranks' median "
                        "that marks a laggard as a straggler (its own "
                        "regression flag also qualifies)")
    p.add_argument("--http", action="store_true",
                   help="export a per-rank OBS_HTTP_PORT so every rank "
                        "serves /metrics, /health, /flight, /ledger/tail "
                        "live (obs/serve.py); the fleet monitor then "
                        "prefers HTTP /health scrapes over the per-rank "
                        "file")
    p.add_argument("--ledger", default="",
                   help="run ledger path exported to every rank as "
                        "OBS_LEDGER (default <workdir>/RUNS.jsonl; "
                        "'none' disables the default — an operator's "
                        "own OBS_LEDGER export still wins)")
    p.add_argument("--heal", action="store_true",
                   help="self-healing mode (resilience/remediate.py): "
                        "watch the per-rank health files + ledger "
                        "rank_lost rows while the gang runs, and close "
                        "the loop — straggler/regression → loss-free "
                        "stop + bitwise resume, NaN/plateau → rollback "
                        "to the pinned last-good snapshot, repeated "
                        "host loss → rank quarantine.  Guardrailed "
                        "(HEAL_FLAP_N/HEAL_COOLDOWN_S/"
                        "HEAL_ACTION_BUDGET) and HEAL_DRY_RUN=1 "
                        "journals decisions without acting")
    p.add_argument("--heal_poll_s", type=float, default=0.25,
                   help="remediation watcher cadence under --heal")
    p.add_argument("--max_heals", type=int, default=4,
                   help="heal-driven relaunches before giving up")
    p.add_argument("--seed", type=int, default=None,
                   help="backoff-jitter seed (tests)")
    args = p.parse_args(argv)
    if not child:
        p.error("nothing to run: pass -- CMD ARGS... "
                "({rank} substituted per rank)")

    workdir = os.path.abspath(args.workdir)
    snapshots = args.snapshots or os.path.join(workdir,
                                               "rank{rank}", "snapshots")
    if snapshots == "none":
        snapshots = ""
    # Flight files from every rank (and the fleet's own) in one place,
    # named flight_<rank>_<pid>.json; an operator export of OBS_DIR wins.
    os.environ.setdefault("OBS_DIR", os.path.join(workdir, "flight"))
    os.makedirs(os.environ["OBS_DIR"], exist_ok=True)
    obs_recorder.install(sigterm=False)

    journal = Journal(args.journal
                      or os.path.join(workdir, "fleet.jsonl"))

    def make_fleet() -> FleetSupervisor:
        return FleetSupervisor(
            args.num_ranks,
            policy=RetryPolicy(retries=args.retries,
                               backoff_base_s=args.backoff_base_s,
                               backoff_max_s=args.backoff_max_s),
            journal=journal,
            heartbeat_timeout_s=args.heartbeat_timeout_s,
            wall_timeout_s=args.timeout_s,
            kill_grace_s=args.kill_grace_s,
            preempt_grace_s=args.preempt_grace_s,
            seed=args.seed,
            elastic=args.elastic,
            worker_tiled=(args.sync_mode == "async"),
            workdir=workdir,
            health_path=("" if args.health == "none"
                         else args.health or None),
            skew_lag_steps=args.skew_lag_steps,
            skew_time_ratio=args.skew_time_ratio,
            ledger_path=("" if args.ledger == "none"
                         else args.ledger or None),
            http=args.http)

    try:
        if args.heal:
            res = _run_healed(args, make_fleet, journal, child, workdir,
                              snapshots)
        else:
            res = make_fleet().run(child, name=args.name,
                                   snapshot_dir_template=snapshots,
                                   stdout_dir=args.stdout_dir or workdir)
    except RankLossStructurallyIllegal as e:
        print(f"supervise_fleet: {e}", file=sys.stderr, flush=True)
        return 4
    except RankLossRefused as e:
        print(f"supervise_fleet: {e}", file=sys.stderr, flush=True)
        return 5
    print(f"supervise_fleet: {res.status}: gang_attempts="
          f"{res.gang_attempts} restarts={res.restarts} "
          f"preemptions={res.preemptions} agreed_steps={res.agreed_steps} "
          f"ranks={res.ranks} rcs={res.last_rcs}",
          file=sys.stderr, flush=True)
    if res.status == "ok":
        return 0
    if res.status == "terminated":
        return 143
    if res.status == "wedged":
        return 3
    # Exhausted: forward a rank's own positive rc where one exists.
    # 143 is excluded — that code means "terminated/preempted cleanly"
    # to any outer supervisor honoring the protocol, and an EXHAUSTED
    # fleet whose last attempt happened to contain a preempted rank
    # must not masquerade as one (it would be restarted budget-free
    # forever).  Signal deaths are negative (waitpid convention) and
    # would wrap mod 256 — those, 143s, and an empty rc map all report
    # as a plain crash.
    bad = [rc for rc in res.last_rcs.values()
           if rc is not None and 0 < rc < 256 and rc != 143]
    return bad[0] if bad else 1


if __name__ == "__main__":
    raise SystemExit(main())
