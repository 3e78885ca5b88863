"""heal_drill — measured self-healing drills: inject each fault class,
let the remediation policy engine (resilience/remediate.py) detect and
heal it, and record time-to-detect / time-to-heal / work-lost (must be
zero) as HEAL_* bench-record rows (the JAX package's
``tools/heal_drill.py`` on the port).

  # the full drill battery on the card:
  python -m distributedtensorflowexample_tpu_torch.tools.heal_drill \\
      --out /tmp/heal.json
  # one drill, fast model, on the CPU:
  python -m distributedtensorflowexample_tpu_torch.tools.heal_drill \\
      --drill slow_rank --model softmax --device cpu --out /tmp/h.json

Every drill runs on ``--device`` (the card unless the CPU is asked
for), and every row's ``platform`` names it; the fleet drills' children
are the port's ``faultline`` (``-m ...tools.faultline``), each run with
one intra-op thread so that the CPU tapes do not depend on the host's
core count.

Drills (each a real end-to-end run, supervised):

- **slow_rank**: a 2-rank faultline fleet where rank 1 turns persistent
  straggler mid-run; the per-rank EWMA regression + the fleet's
  straggler naming feed the engine, which EVICTS loss-free
  (request_stop → TERM→143→snapshot) and relaunches; the resumed run
  is bitwise the uninterrupted one.
- **nan**: a poisoned batch NaNs the loss (OOV ids for LM models); the
  gang dies (fleet retries=0 — the REMEDIATOR owns the restart
  decision), the post-mortem health file still carries the flag, and
  the engine ROLLS BACK to the pinned last-good snapshot (< fired_step,
  validity-checked) before relaunching.
- **host_loss**: rank 1's host dies (tombstone + SIGKILL); the elastic
  fleet shrinks and completes — the engine's role here is detection
  (ledger ``rank_lost`` rows; quarantine is flap-gated for REPEATED
  offenders) and verifying the survivor lost zero steps.
- **serve_slo**: a burst floods a live lm serving worker past its
  latency target; the engine TIGHTENS admission (``set_slo_ms``) and
  the accepted-work p99 recovers — with every admitted request
  answered.
- **canary**: a candidate snapshot serves a slot fraction
  (serving/promote.Canary) with an injected latency regression; the
  window verdicts ROLLBACK, the canary arm drains to completion, and
  every request id lands exactly once.
- **ckpt**: a ``--mesh``-rank ZeRO-3 faultline (one fleet rank whose
  mesh ranks the faultline starts itself) is preempted and its
  shard-redundant snapshot set is damaged post-exit — one mesh-shard's
  whole directory deleted, and in a second run beside it one payload
  byte flipped (silent rot); the fleet's resume agreement still votes for that step
  (R=2 quorum holds), the relaunch RECONSTRUCTS the shard from its ring
  mirror — the rot is caught by sha256, never restored silently — and
  the finished run is bitwise the uninterrupted one.  Rides along:
  ``ckpt_shard_restore_failures`` / ``ckpt_digest_mismatch_unrecovered``
  must-be-zero rows.

``steps_lost`` is exact: the count of (step, loss) pairs from the
uninterrupted reference run that no healed attempt reproduced bit-for-
bit (a poisoned step's tape entry is superseded by its healthy replay).
MTTD = first ``heal_detect`` ledger row vs the detector's own onset
stamp; MTTR = detect → the healed run's completion.  The serve_slo
drill's MTTD is poll-granularity BY CONSTRUCTION (a scrape-based
detector's onset IS the first breaching observation); its MTTR line
carries the real claim: detect → accepted-work p99 measurably back
under the breach line.  Stdout is the JSON-lines record; prose on
stderr.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import glob
import json
import os
import sys
import threading
import time

FAULTLINE = [sys.executable, "-m",
             "distributedtensorflowexample_tpu_torch.tools.faultline"]
#: The fleet drills' children: one intra-op thread each.
_CHILD_ENV = {"OMP_NUM_THREADS": "1"}


def _log(msg: str) -> None:
    print(f"heal_drill: {msg}", file=sys.stderr, flush=True)


def _fresh(workdir: str) -> str:
    """Wipe-and-recreate a drill's own subdirectory.  Every drill is a
    MEASUREMENT: a reused workdir would replay the previous run's WAL
    into the guardrail budget, date MTTD from the previous run's
    heal_detect row, resume from its snapshots, and union its JSON
    tails into the steps_lost proof — all silent staleness."""
    import shutil
    if os.path.exists(workdir):
        shutil.rmtree(workdir)
    os.makedirs(workdir)
    return workdir


def _wall() -> float:
    from distributedtensorflowexample_tpu_torch.obs import metrics as obs_metrics
    return obs_metrics._wall()


# --- shared measurement plumbing -------------------------------------------

def _ledger_rows(path: str) -> list[dict]:
    from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
    rows, _ = obs_ledger.read_rows(path)
    return rows


def _mttd_mttr(ledger_path: str, kinds: tuple, t_healed: float,
               action_events: tuple) -> dict:
    """Timings from the ledger alone: onset from the detector's own stamp
    carried on the heal_detect row, detect from that row's write time,
    heal from the drill-observed completion wall time."""
    rows = _ledger_rows(ledger_path)
    detect = next((r for r in rows if r.get("event") == "heal_detect"
                   and r.get("kind") in kinds), None)
    action = next((r for r in rows if r.get("event") in action_events),
                  None)
    if detect is None:
        return {"mttd_ms": None, "mttr_ms": None, "detect_row": None}
    detail = detect.get("detail") or {}
    onset = detail.get("updated_unix") or detail.get("ts") \
        or detect.get("ts")
    mttd = max(0.0, float(detect["ts"]) - float(onset))
    mttr = max(0.0, t_healed - float(detect["ts"]))
    return {"mttd_ms": round(mttd * 1000.0, 1),
            "mttr_ms": round(mttr * 1000.0, 1),
            "detect_kind": detect.get("kind"),
            "action": (action or {}).get("event")}


def steps_lost(straight_losses: list, healed_tapes: list) -> int:
    """(step, loss) pairs of the uninterrupted reference that no healed
    attempt reproduced exactly.  NaN entries never match anything (a
    poisoned step only counts as recovered via its healthy replay)."""
    produced = {(s, l) for tape in healed_tapes for s, l in tape}
    return sum(1 for s, l in straight_losses if (s, l) not in produced)


def _straight_run(workdir: str, model: str, steps: int, device: str,
                  seed: int = 0) -> dict:
    """The uninterrupted reference, in-process, on one intra-op thread
    (the fleet children's count)."""
    import contextlib
    import io

    import torch

    from distributedtensorflowexample_tpu_torch.tools import faultline
    _fresh(workdir)
    buf = io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(buf):
            rc = faultline.main(["--plan", "none", "--steps", str(steps),
                                 "--model", model, "--workdir", workdir,
                                 "--keep", "50", "--seed", str(seed),
                                 "--device", device])
    finally:
        torch.set_num_threads(threads)
    assert rc == 0, f"straight reference run failed rc={rc}"
    lines = [l for l in buf.getvalue().splitlines() if l.strip()]
    return json.loads(lines[-1])


def _outs(workdir: str) -> list[dict]:
    """Every rank/attempt JSON tail the drill's placements left."""
    recs = []
    for path in sorted(glob.glob(os.path.join(
            workdir, "out", "launch*", "rank*_attempt*.out"))):
        with open(path) as f:
            lines = [l for l in f.read().splitlines() if l.strip()]
        if lines:
            try:
                recs.append(json.loads(lines[-1]))
            except json.JSONDecodeError:
                continue
    return recs


# --- the fleet drill harness -----------------------------------------------

def _fleet_drill(workdir: str, plan: str, steps: int, model: str,
                 device: str, *, ranks: int = 2, elastic: bool = False,
                 fleet_retries: int = 0, seed: int = 0,
                 poll_s: float = 0.2, max_heals: int = 2,
                 anomaly_env: dict | None = None,
                 extra_argv: list | None = None) -> dict:
    """Run one faultline gang under full remediation; return the drill
    report (status, heals, ledger path, per-attempt tails)."""
    from distributedtensorflowexample_tpu_torch.resilience import remediate
    from distributedtensorflowexample_tpu_torch.resilience.fleet import (
        FleetSupervisor)
    from distributedtensorflowexample_tpu_torch.resilience.supervisor import (
        Journal, RetryPolicy)

    _fresh(workdir)
    journal = Journal(os.path.join(workdir, "fleet.jsonl"))
    ledger = os.path.join(workdir, "RUNS.jsonl")
    snapshots = os.path.join(workdir, "rank{rank}", "snapshots")
    argv = [*FAULTLINE, "--plan", plan, "--steps", str(steps),
            "--model", model, "--device", device,
            "--workdir", os.path.join(workdir, "rank{rank}"),
            "--keep", "50", "--seed", str(seed)] + list(extra_argv or [])

    def make_fleet() -> FleetSupervisor:
        return FleetSupervisor(
            ranks,
            policy=RetryPolicy(retries=fleet_retries,
                               backoff_base_s=0.1, backoff_max_s=0.5),
            journal=journal, kill_grace_s=30.0, poll_s=0.05, seed=seed,
            elastic=elastic, workdir=workdir, ledger_path=ledger)

    target = remediate.FleetTarget()
    rem = remediate.Remediator(
        journal=journal, ledger_path=ledger, scope="drill",
        actuators={
            "evict": remediate.make_evict_actuator(target),
            "rollback": remediate.make_rollback_actuator(
                snapshots, target=target),
            "quarantine": remediate.make_quarantine_actuator(target)},
        guardrails=remediate.Guardrails(flap_n=2, flap_window_s=30.0,
                                        cooldown_s=10.0, budget=4))
    watchers = [
        remediate.HealthWatcher(
            os.path.join(workdir, "health_rank*.json"),
            fleet_health=os.path.join(workdir, "health.json"),
            scope="drill"),
        # rank_lost only — the anomaly mirror rows would double-count
        # the health files' conditions into the flap guardrail.
        remediate.LedgerWatcher(ledger, kinds=("rank_lost",),
                                scope="drill"),
    ]
    env = {"OBS_ANOMALY_WARMUP": "4", "OBS_ANOMALY_Z": "8", **_CHILD_ENV}
    env.update(anomaly_env or {})
    t0 = _wall()
    out = remediate.run_remediated(
        make_fleet, argv, rem, watchers, target=target, name="drill",
        snapshot_dir_template=snapshots,
        stdout_dir=os.path.join(workdir, "out"), env_extra=env,
        poll_s=poll_s, max_heals=max_heals)
    out.update(ledger=ledger, t0=t0, t_healed=_wall(),
               actions=rem.guardrails.actions_used,
               outs=_outs(workdir))
    return out


def _fleet_rows(name: str, report: dict, straight: dict, *,
                kinds: tuple, action_events: tuple, model: str,
                final_ranks=None, platform: str = "cpu") -> list[dict]:
    timings = _mttd_mttr(report["ledger"], kinds, report["t_healed"],
                         action_events)
    tapes = [[(s, l) for s, l in rec.get("losses", [])]
             for rec in report["outs"]]
    lost = steps_lost(straight["losses"], tapes)
    finals = [rec for rec in report["outs"]
              if rec.get("status") == "ok"
              and rec.get("step") == straight["step"]
              and (final_ranks is None or rec.get("rank") in final_ranks)]
    bitwise = bool(finals) and all(
        rec["digest"] == straight["digest"] for rec in finals)
    if not bitwise:
        _log(f"{name}: WARNING — final digests do not all match the "
             f"straight run ({len(finals)} final record(s))")
    detail = {"platform": platform, "model": model, "drill": name,
              "status": report["status"], "heals": report["healed"],
              "actions": report["actions"],
              "bitwise_resume": bitwise,
              "final_records": len(finals), **timings}
    rows = []
    for metric, value, unit in (
            (f"heal_{name}_mttd_ms", timings["mttd_ms"], "ms"),
            (f"heal_{name}_mttr_ms", timings["mttr_ms"], "ms"),
            (f"heal_{name}_steps_lost",
             lost if bitwise else max(lost, 1), "steps")):
        rows.append({"metric": metric, "value": value, "unit": unit,
                     "platform": platform, "detail": detail})
    return rows


# --- the drills ------------------------------------------------------------

def drill_slow_rank(base: str, model: str, steps: int = 24,
                    delay_s: float = 2.0,
                    device: str = "cuda") -> list[dict]:
    """Straggler → evict → bitwise resume."""
    _log(f"slow_rank: 2-rank {model} on {device}, rank 1 straggles "
         f"{delay_s}s/step from step 8")
    wd = os.path.join(base, "slow_rank")
    report = _fleet_drill(wd, f"slow_rank@8:{delay_s}%1", steps, model,
                          device, ranks=2)
    straight = _straight_run(os.path.join(base, "straight_slow"),
                             model, steps, device)
    return _fleet_rows("slow_rank", report, straight,
                       kinds=("step_time_regression", "straggler"),
                       action_events=("heal_evict",), model=model,
                       platform=device)


def drill_nan(base: str, model: str, steps: int = 12,
              device: str = "cuda") -> list[dict]:
    """NaN-poison → rollback to pinned last-good → bitwise resume.
    LM models take the corrupt-batch road (garbage ids → OOV poison →
    NaN); float models take nan_loss directly."""
    plan = "corrupt_batch@6" if model.startswith("lm_") else "nan_loss@6"
    _log(f"nan: 1-rank {model} on {device}, {plan}; fleet retries=0 — "
         f"the remediator owns the restart decision")
    wd = os.path.join(base, "nan")
    report = _fleet_drill(wd, plan, steps, model, device, ranks=1)
    straight = _straight_run(os.path.join(base, "straight_nan"),
                             model, steps, device)
    return _fleet_rows("nan", report, straight,
                       kinds=("nan_loss",),
                       action_events=("heal_rollback",), model=model,
                       platform=device)


def drill_host_loss(base: str, model: str, steps: int = 16,
                    device: str = "cuda") -> list[dict]:
    """Host loss → elastic shrink (fleet policy) + remediation-layer
    detection; the survivor loses zero steps."""
    _log(f"host_loss: 2-rank elastic {model} on {device}, rank 1's host "
         f"dies at step 5 (down forever)")
    wd = os.path.join(base, "host_loss")
    report = _fleet_drill(wd, "host_loss@5:0%1", steps, model, device,
                          ranks=2, elastic=True, fleet_retries=4)
    straight = _straight_run(os.path.join(base, "straight_host"),
                             model, steps, device)
    return _fleet_rows("host_loss", report, straight,
                       kinds=("rank_lost",),
                       action_events=("heal_quarantine",), model=model,
                       final_ranks=(0,), platform=device)


def _serving_engine(snaps: str, size: str, device: str, slots: int,
                    cache_len: int):
    """Promote ``snaps`` onto ``device`` and build a replicated engine."""
    from distributedtensorflowexample_tpu_torch.device import resolve_device
    from distributedtensorflowexample_tpu_torch.serving.engine import (
        DecodeEngine)
    from distributedtensorflowexample_tpu_torch.serving.promote import (
        promote)
    pm = promote(snaps, size, device=resolve_device(device))
    return pm, DecodeEngine(pm.model, slots=slots, cache_len=cache_len)


def drill_serve_slo(base: str, size: str = "lm_tiny",
                    breach_ms: float = 250.0,
                    target_ms: float = 150.0,
                    device: str = "cuda") -> list[dict]:
    """Serving p99 breach → admission tightened → accepted-work p99
    recovers, zero admitted requests dropped."""
    from distributedtensorflowexample_tpu_torch.resilience import remediate
    from distributedtensorflowexample_tpu_torch.resilience.supervisor import (
        Journal)
    from distributedtensorflowexample_tpu_torch.serving.promote import (
        init_lm_snapshot)
    from distributedtensorflowexample_tpu_torch.serving.queue import (
        ContinuousBatcher, RequestQueue, recent_p99_ms)

    _log(f"serve_slo: {size} on {device}, burst past p99 {breach_ms}ms → "
         f"tighten admission to {target_ms}ms")
    wd = _fresh(os.path.join(base, "serve_slo"))
    snaps = os.path.join(wd, "snaps")
    init_lm_snapshot(snaps, size)
    _, engine = _serving_engine(snaps, size, device, slots=2, cache_len=48)
    queue = RequestQueue(engine.vocab)
    batcher = ContinuousBatcher(engine, queue, slo_ms=0.0)
    ledger = os.path.join(wd, "RUNS.jsonl")
    rem = remediate.Remediator(
        journal=Journal(os.path.join(wd, "heal.jsonl")),
        ledger_path=ledger, scope="serve",
        actuators={"slo_tighten": remediate.make_slo_actuator(
            lambda: batcher.slo_ms, batcher.set_slo_ms, target_ms)},
        guardrails=remediate.Guardrails(flap_n=2, cooldown_s=5.0,
                                        budget=4))
    watcher = remediate.ServeWatcher(
        lambda: {"p99_ms": recent_p99_ms(batcher.completed, 32),
                 "completed": len(batcher.completed)},
        breach_ms=breach_ms)
    stop = threading.Event()
    t = threading.Thread(target=lambda: batcher.run(stop.is_set),
                         daemon=True)
    t.start()
    reqs = []
    # Phase A: the burst — queue wait drives end-to-end latency over
    # the breach line (admit-everything: slo starts at 0).
    for i in range(48):
        reqs.append(queue.submit([1 + i % 32, 2, 3], max_new=24,
                                 rid=f"burst{i}"))
    healed_at = None
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        for ev in watcher.poll():
            if rem.observe(ev) == "acted":
                healed_at = _wall()
        if healed_at is not None:
            break
        time.sleep(0.05)
    assert healed_at is not None, "serve_slo drill never breached/healed"
    # Phase B: paced traffic after the heal — the recovery measurement.
    for i in range(16):
        reqs.append(queue.submit([5 + i % 32, 6], max_new=4,
                                 rid=f"paced{i}"))
        time.sleep(0.05)
    for r in reqs:
        r.done.wait(timeout=120)
    stop.set()
    t.join(timeout=60)
    paced = [r for r in batcher.completed if r.rid.startswith("paced")]
    recovered_p99 = recent_p99_ms(paced, 16) or 0.0
    t_recovered = max((r.done_t for r in paced), default=None)
    # Zero admitted-and-lost: every request either completed or was
    # rejected loudly at admission; an admitted one with no outcome is
    # a loss.
    lost = sum(1 for r in reqs
               if r.admit_t is not None and r.outcome != "ok")
    timings = _mttd_mttr(ledger, ("serve_p99_breach",), healed_at,
                         ("heal_slo_tighten",))
    # MTTR for serving = detect → accepted-work p99 measurably back
    # under the breach line (the paced tape), not just the knob flip.
    rows_r = _ledger_rows(ledger)
    detect = next((r for r in rows_r
                   if r.get("event") == "heal_detect"), None)
    mttr = None
    if detect is not None and t_recovered is not None \
            and recovered_p99 <= breach_ms:
        # done_t is monotonic; convert via the shared offset now.
        mttr = round((time.time() - (time.monotonic() - t_recovered)
                      - float(detect["ts"])) * 1000.0, 1)
    detail = {"platform": device, "model": size, "drill": "serve_slo",
              "breach_ms": breach_ms, "target_ms": target_ms,
              "recovered_p99_ms": recovered_p99,
              "completed": len(batcher.completed),
              "slo_rejected": sum(1 for r in batcher.rejected
                                  if r.outcome == "slo_rejected"),
              **timings}
    return [
        {"metric": "heal_serve_slo_mttd_ms", "value": timings["mttd_ms"],
         "unit": "ms", "platform": device, "detail": detail},
        {"metric": "heal_serve_slo_mttr_ms",
         "value": mttr if mttr is not None else timings["mttr_ms"],
         "unit": "ms", "platform": device, "detail": detail},
        {"metric": "heal_serve_slo_requests_lost", "value": lost,
         "unit": "requests", "platform": device, "detail": detail},
    ]


def drill_canary(base: str, size: str = "lm_tiny",
                 n_requests: int = 24,
                 device: str = "cuda") -> list[dict]:
    """Canary promotion with an injected latency regression → window
    verdict ROLLBACK → canary arm drains; every id lands exactly once."""
    from distributedtensorflowexample_tpu_torch.resilience import remediate
    from distributedtensorflowexample_tpu_torch.resilience.supervisor import (
        Journal)
    from distributedtensorflowexample_tpu_torch.serving.promote import (
        Canary, init_lm_snapshot)
    from distributedtensorflowexample_tpu_torch.serving.queue import (
        ContinuousBatcher, RequestQueue)

    _log(f"canary: {size} on {device}, a candidate serves a slot "
         f"fraction with an injected latency regression — must roll back "
         f"without dropping a request")
    wd = _fresh(os.path.join(base, "canary"))
    base_snaps = os.path.join(wd, "baseline")
    cand_snaps = os.path.join(wd, "candidate")
    init_lm_snapshot(base_snaps, size, seed=0)
    init_lm_snapshot(cand_snaps, size, seed=1)

    arms, promoted = {}, {}
    for arm, snaps, slow in (("baseline", base_snaps, 0.0),
                             ("canary", cand_snaps, 0.15)):
        pm, engine = _serving_engine(snaps, size, device, slots=2,
                                     cache_len=32)
        promoted[arm] = pm
        q = RequestQueue(engine.vocab)
        # The injected fault: the candidate's decode boundary pays a
        # delay (a bad quantization, a layout regression) — the
        # slow_rank idiom, serving-side.
        b = ContinuousBatcher(
            engine, q, slo_ms=0.0,
            on_step=(lambda _b, s=slow: time.sleep(s)) if slow else None)
        arms[arm] = (q, b)

    canary = Canary(promoted["baseline"].step, promoted["canary"].step,
                    fraction=0.5, window=6, p99_ratio=2.0)
    assert canary.admit_candidate(promoted["canary"].model)
    ledger = os.path.join(wd, "RUNS.jsonl")
    rolled: dict = {}
    prompts: dict = {}
    final_reqs: dict = {}

    def canary_rollback(ev):
        """Revert: stop routing to the candidate, RE-ROUTE its queued
        (not-yet-admitted) requests to the baseline arm, and stop the
        canary batcher — its run loop's own drain decodes the in-flight
        slots to completion, so rollback drops nothing: admitted work
        finishes on the canary, queued work re-lands on the baseline."""
        rolled["at"] = _wall()
        pending = arms["canary"][0].drain_pending()
        for req in pending:
            final_reqs[req.rid] = arms["baseline"][0].submit(
                prompts[req.rid], max_new=req.max_new, rid=req.rid)
        stops["canary"].set()
        return {"rerouted": len(pending), **canary.payload()}

    rem = remediate.Remediator(
        journal=Journal(os.path.join(wd, "heal.jsonl")),
        ledger_path=ledger, scope="serve",
        actuators={"canary_rollback": canary_rollback},
        guardrails=remediate.Guardrails(flap_n=1, cooldown_s=5.0,
                                        budget=2))
    stops = {arm: threading.Event() for arm in arms}
    threads = {}
    for arm, (q, b) in arms.items():
        threads[arm] = threading.Thread(
            target=lambda b=b, arm=arm: b.run(stops[arm].is_set),
            daemon=True)
        threads[arm].start()

    # Warm both arms first (one unobserved request each): the first
    # request pays the lazy kernel loads — far above the steady state —
    # and an inflated baseline p99 would mask any canary regression
    # inside the verdict window.
    for arm, (q, _b) in arms.items():
        q.submit([1, 2, 3], max_new=4, rid=f"warm_{arm}").done.wait(
            timeout=120)
    t_first_canary = None
    routed = {}
    for i in range(n_requests):
        rid = f"req{i}"
        arm = canary.route(rid)
        if arm == "canary" and t_first_canary is None:
            t_first_canary = _wall()
        prompts[rid] = [1 + i % 24, 2, 3]
        routed[rid] = arm
        final_reqs[rid] = arms[arm][0].submit(prompts[rid], max_new=4,
                                              rid=rid)
        # Paced offered load: the comparison must measure the ARMS,
        # not self-inflicted queue wait on the healthy baseline.
        time.sleep(0.03)
    verdict = None
    observed: set = set()
    deadline = time.monotonic() + 180
    while verdict is None and time.monotonic() < deadline:
        for rid, r in list(final_reqs.items()):
            if r.done.is_set() and rid not in observed:
                observed.add(rid)
                canary.observe(routed[rid], r.latency_s or 0.0,
                               ok=r.outcome == "ok")
        verdict = canary.verdict()
        time.sleep(0.02)
    assert verdict == "rollback", f"canary verdict {verdict!r}"
    rem.observe(remediate.AnomalyEvent(
        kind="canary_regression", key="canary:rollback", scope="serve",
        source="canary", detail=canary.payload()))
    for rid, r in list(final_reqs.items()):
        r.done.wait(timeout=120)
    for arm in arms:
        stops[arm].set()
        threads[arm].join(timeout=60)
    # Exactly-once: every id's FINAL request object completed ok —
    # canary in-flight finished on the canary arm, re-routed queued
    # ids finished on the baseline.
    lost = sum(1 for r in final_reqs.values() if r.outcome != "ok")
    mttd = (None if t_first_canary is None
            else round((rolled.get("at", t_first_canary)
                        - t_first_canary) * 1000.0, 1))
    t_drained = _wall()
    mttr = (None if "at" not in rolled
            else round((t_drained - rolled["at"]) * 1000.0, 1))
    detail = {"platform": device, "model": size, "drill": "canary",
              "verdict": verdict, "canary": canary.payload(),
              "requests": n_requests}
    return [
        {"metric": "heal_canary_mttd_ms", "value": mttd, "unit": "ms",
         "platform": device, "detail": detail},
        {"metric": "heal_canary_mttr_ms", "value": mttr, "unit": "ms",
         "platform": device, "detail": detail},
        {"metric": "heal_canary_requests_lost", "value": lost,
         "unit": "requests", "platform": device, "detail": detail},
    ]


def _straight_zero3(workdir: str, model: str, steps: int, mesh: int,
                    device: str, seed: int = 0) -> dict:
    """The uninterrupted ZeRO-3 reference: the faultline as a
    subprocess, as in the drill (it starts its own mesh ranks)."""
    import subprocess
    _fresh(workdir)
    out = subprocess.run(
        [*FAULTLINE, "--plan", "none", "--steps", str(steps),
         "--model", model, "--workdir", workdir, "--device", device,
         "--keep", "50", "--seed", str(seed),
         "--layout", "zero3", "--mesh", str(mesh)],
        capture_output=True, text=True, env={**os.environ, **_CHILD_ENV})
    assert out.returncode == 0, (
        f"straight zero3 reference failed rc={out.returncode}: "
        f"{out.stderr[-800:]}")
    lines = [l for l in out.stdout.splitlines() if l.strip()]
    return json.loads(lines[-1])


def _ckpt_rows(name: str, report: dict, straight: dict, *,
               detect_event: str, model: str,
               platform: str = "cpu") -> list[dict]:
    """Rows for one shard-fault drill.  Detection here is the shard
    store's OWN (the sha256/census check at restore), not a watcher
    poll: onset is the faulted attempt's 143 exit (the post-exit fault
    lands at exit), detect is the first ``detect_event`` ledger row the
    reconstruction wrote, heal is the drill-observed completion."""
    rows_l = _ledger_rows(report["ledger"])
    onset = next((r.get("ts") for r in rows_l
                  if r.get("event") == "run_end"
                  and r.get("rc") == 143), None)
    detect = next((r for r in rows_l
                   if r.get("event") == detect_event), None)
    mttd = mttr = None
    if detect is not None:
        if onset is not None:
            mttd = round(max(0.0, float(detect["ts"]) - float(onset))
                         * 1000.0, 1)
        mttr = round(max(0.0, report["t_healed"] - float(detect["ts"]))
                     * 1000.0, 1)
    tapes = [[(s, l) for s, l in rec.get("losses", [])]
             for rec in report["outs"]]
    lost = steps_lost(straight["losses"], tapes)
    finals = [rec for rec in report["outs"]
              if rec.get("status") == "ok"
              and rec.get("step") == straight["step"]]
    # Same width saver->restorer, so BOTH digests must match: the full
    # row-state one and the materialized-params one.
    bitwise = bool(finals) and all(
        rec["digest"] == straight["digest"]
        and rec.get("params_digest") == straight.get("params_digest")
        for rec in finals)
    if not bitwise:
        _log(f"{name}: WARNING — final digests do not all match the "
             f"straight run ({len(finals)} final record(s))")
    restore_failures = sum(1 for r in rows_l
                           if r.get("event") == "ckpt_refused")
    mismatches = [r for r in rows_l
                  if r.get("event") == "ckpt_digest_mismatch"]
    rebuilt = {(r.get("step"), r.get("shard")) for r in rows_l
               if r.get("event") == "ckpt_reconstruct"}
    unrecovered = sum(1 for r in mismatches
                      if (r.get("step"), r.get("shard")) not in rebuilt)
    detail = {"platform": platform, "model": model, "drill": name,
              "status": report["status"],
              "detect_event": (detect or {}).get("event"),
              "reconstructs": len(rebuilt),
              "bitwise_resume": bitwise,
              "final_records": len(finals),
              "mttd_ms": mttd, "mttr_ms": mttr}
    rows = []
    for metric, value, unit in (
            (f"heal_{name}_mttd_ms", mttd, "ms"),
            (f"heal_{name}_mttr_ms", mttr, "ms"),
            (f"heal_{name}_steps_lost",
             lost if bitwise else max(lost, 1), "steps"),
            ("ckpt_shard_restore_failures", restore_failures, "count"),
            ("ckpt_digest_mismatch_unrecovered", unrecovered, "count")):
        rows.append({"metric": metric, "value": value, "unit": unit,
                     "platform": platform, "detail": detail})
    return rows


def drill_ckpt(base: str, model: str = "softmax", steps: int = 12,
               mesh: int = 4, device: str = "cuda") -> list[dict]:
    """Shard-redundant checkpointing: a ``mesh``-rank ZeRO-3 faultline
    is preempted and, after its final save, (a) one mesh-shard's whole
    snapshot directory is deleted, then separately (b) one payload byte
    of one shard is flipped in place.  The fleet's resume agreement
    still votes for that step (quorum holds at R=2), the relaunch
    reconstructs the shard from its ring mirror — detecting the rot by
    sha256, never silently restoring it — and the finished run is
    BITWISE the uninterrupted one.  To the fleet the faultline is one
    rank.  softmax by default: the row layout doesn't care about model
    size.  The reference and the two damaged runs share nothing but the
    host, and each spends most of its time starting processes, so the
    three run at once (the JAX drill runs them in turn)."""
    zero3 = ["--layout", "zero3", "--mesh", str(mesh)]
    plans = (("shard_loss", "ckpt_reconstruct"),
             ("bitflip", "ckpt_digest_mismatch"))
    for plan, _ in plans:
        _log(f"ckpt: one fleet rank of D={mesh} zero3 {model} on {device}, "
             f"{plan} after the final save — mirror reconstruction must "
             f"be bitwise")
    with concurrent.futures.ThreadPoolExecutor(1 + len(plans)) as pool:
        straight = pool.submit(_straight_zero3,
                               os.path.join(base, "straight_ckpt"), model,
                               steps, mesh, device)
        reports = [pool.submit(_fleet_drill,
                               os.path.join(base, f"ckpt_{plan}"), plan,
                               steps, model, device, ranks=1,
                               extra_argv=zero3) for plan, _ in plans]
        straight, reports = straight.result(), [r.result() for r in reports]
    rows: list[dict] = []
    for (plan, detect_event), report in zip(plans, reports):
        rows += _ckpt_rows(f"ckpt_{plan}", report, straight,
                           detect_event=detect_event, model=model,
                           platform=device)
    return rows


DRILLS = ("slow_rank", "nan", "host_loss", "serve_slo", "canary",
          "ckpt")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--drill", default="all",
                   help=f"one of {DRILLS} or 'all'")
    p.add_argument("--model", default="lm_tiny",
                   choices=["softmax", "mnist_cnn", "lm_tiny"],
                   help="workload for the fleet drills (the serving "
                        "drills always use the lm engine)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where every drill runs (cuda unless asked for "
                        "the CPU; no fallback)")
    p.add_argument("--mesh", type=int, default=4,
                   help="the ckpt drill's ZeRO-3 width")
    p.add_argument("--workdir", default="/tmp/heal_drill")
    p.add_argument("--out", default="",
                   help="write the record rows here (JSON lines); "
                        "default stdout only")
    args = p.parse_args(argv)

    if args.device == "cuda":
        from distributedtensorflowexample_tpu_torch.device import (
            require_cuda)
        require_cuda()
    from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
    obs_ledger.maybe_begin("heal_drill", config={"drill": args.drill,
                                                 "model": args.model,
                                                 "device": args.device})
    wanted = DRILLS if args.drill == "all" else tuple(
        d.strip() for d in args.drill.split(","))
    unknown = [d for d in wanted if d not in DRILLS]
    if unknown:
        p.error(f"unknown drill(s) {unknown}; known: {DRILLS}")
    rows: list[dict] = []
    dev = args.device
    for d in wanted:
        t0 = time.monotonic()
        if d == "slow_rank":
            rows += drill_slow_rank(args.workdir, args.model, device=dev)
        elif d == "nan":
            rows += drill_nan(args.workdir, args.model, device=dev)
        elif d == "host_loss":
            rows += drill_host_loss(args.workdir, args.model, device=dev)
        elif d == "serve_slo":
            rows += drill_serve_slo(args.workdir, device=dev)
        elif d == "canary":
            rows += drill_canary(args.workdir, device=dev)
        elif d == "ckpt":
            rows += drill_ckpt(args.workdir, model=args.model,
                               mesh=args.mesh, device=dev)
        _log(f"{d}: done in {time.monotonic() - t0:.1f}s")
    for row in rows:
        print(json.dumps(row, sort_keys=True), flush=True)
    if args.out:
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            for row in rows:
                f.write(json.dumps(row, sort_keys=True) + "\n")
        os.replace(tmp, args.out)
        _log(f"record written to {args.out}")
    bad = [r for r in rows
           if r["metric"].endswith(("_lost", "_restore_failures",
                                    "_unrecovered"))
           and r["value"] not in (0, 0.0)]
    obs_ledger.end_global(rc=1 if bad else 0)
    if bad:
        _log(f"FAILED must-be-zero invariants: "
             f"{[r['metric'] for r in bad]}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
