"""Distill a sim run into ratchet-format record rows — computed FROM
the ledger and journal rows the REAL control plane wrote, never from
sim-internal state (the whole point is that the evidence trail is the
live one).

Row families:

* **queue waits** — every ``sched_submit``/``sched_evict``/
  ``sched_retry``/``sched_grow`` opens a wait; the job's next
  ``sched_place`` closes it.  p50/p90/p99/max over all waits.
* **preemption storms** — total evictions + the worst count inside any
  sliding ``STORM_WINDOW_S`` virtual window.
* **MTTR tails** — ``heal_detect`` (straggler) → the scoped job's next
  ``sched_place``: detection-to-recovered-placement, the sim analogue
  of the MTTR that ``tools.heal_drill`` measures.
* **suppression ledger** — ``heal_suppressed`` counts by reason
  (flap/cooldown/budget/noop): proof the guardrails BOUND under storm.
* **must-be-zero invariants** — ``sim_fleet_steps_lost`` (snapshot
  resume forgot work) and ``sim_wal_unbalanced_violations`` (a
  ``sched_intent`` whose effect never landed) end in the suffixes that
  ``tools.sim_run`` fails on (and the JAX package's
  ``tools/bench_ratchet.py`` refuses to let regress above zero).
"""

from __future__ import annotations

from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger

#: Sliding window for the preemption-storm peak (virtual seconds).
STORM_WINDOW_S = 60.0

_REQUEUE = ("sched_submit", "sched_evict", "sched_retry", "sched_grow")


def _pct(values: list[float], q: float) -> float:
    if not values:
        return 0.0
    v = sorted(values)
    idx = min(len(v) - 1, max(0, round(q * (len(v) - 1))))
    return v[idx]


def _row(metric: str, value, unit: str, **detail) -> dict:
    return {"metric": metric, "value": value, "unit": unit,
            "platform": "cpu", "detail": detail or None}


def queue_waits(rows: list[dict]) -> list[float]:
    open_at: dict[str, float] = {}
    waits: list[float] = []
    for r in rows:
        job, ev, ts = r.get("job"), r.get("event"), r.get("ts")
        if not job or ts is None:
            continue
        if ev in _REQUEUE:
            open_at[job] = ts
        elif ev == "sched_place" and job in open_at:
            waits.append(round(ts - open_at.pop(job), 6))
    return waits


def storm_peak(rows: list[dict]) -> int:
    evs = sorted(r["ts"] for r in rows
                 if r.get("event") == "sched_evict")
    peak = lo = 0
    for hi in range(len(evs)):
        while evs[hi] - evs[lo] > STORM_WINDOW_S:
            lo += 1
        peak = max(peak, hi - lo + 1)
    return peak


def mttr_tails(rows: list[dict]) -> list[float]:
    """heal_detect → the same job's next sched_place (the healed
    relaunch), per detection key."""
    pending: dict[str, float] = {}      # job -> earliest open detect ts
    tails: list[float] = []
    for r in rows:
        ev, job, ts = r.get("event"), r.get("job"), r.get("ts")
        if ev == "heal_detect" and job and job != "serve":
            pending.setdefault(job, ts)
        elif ev == "sched_place" and job in pending:
            tails.append(round(ts - pending.pop(job), 6))
    return tails


def suppressed_by_reason(rows: list[dict]) -> dict:
    out: dict[str, int] = {}
    for r in rows:
        if r.get("event") == "heal_suppressed":
            reason = r.get("reason") or "unknown"
            out[reason] = out.get(reason, 0) + 1
    return out


def wal_unbalanced(journal_events) -> int:
    """Intents whose effect never landed: a ``sched_intent`` seq with
    no later same-seq applied/superseded row.  The live WAL contract
    says this is zero at quiescence."""
    intents: set = set()
    for rec in journal_events:
        ev = rec.get("event", "")
        seq = rec.get("seq")
        if ev == "sched_intent":
            intents.add(seq)
        elif ev.startswith("sched_") and isinstance(seq, int):
            intents.discard(seq)
    return len(intents)


def distill(world, prefix: str = "sim") -> list[dict]:
    """SimWorld (after ``run()``) → ratchet record rows.  ``prefix``
    namespaces the metric names per scenario (``sim_fleet10k_...``) so
    a battery's rows coexist in one record file."""
    summary = world.summary or {}
    rows, torn = obs_ledger.read_rows(world.ledger_path)
    waits = queue_waits(rows)
    tails = mttr_tails(rows)
    sup = suppressed_by_reason(rows)
    counts = (summary.get("summary") or {}).get("counts") or {}
    out = [
        _row(f"{prefix}_ranks", summary.get("total_ranks", 0), "ranks",
             scenario=summary.get("scenario"),
             seed=summary.get("seed")),
        _row(f"{prefix}_virtual_s", summary.get("virtual_s", 0.0), "s"),
        _row(f"{prefix}_jobs_done", counts.get("done", 0), "jobs",
             counts=counts),
        _row(f"{prefix}_queue_wait_p50_s", _pct(waits, 0.50), "s",
             n=len(waits)),
        _row(f"{prefix}_queue_wait_p99_s", _pct(waits, 0.99), "s",
             p90=_pct(waits, 0.90), max=max(waits) if waits else 0.0),
        _row(f"{prefix}_evictions",
             sum(1 for r in rows if r.get("event") == "sched_evict"),
             "evictions", storm_peak=storm_peak(rows),
             storm_window_s=STORM_WINDOW_S),
        _row(f"{prefix}_mttr_p50_s", _pct(tails, 0.50), "s",
             n=len(tails)),
        _row(f"{prefix}_mttr_max_s", max(tails) if tails else 0.0, "s"),
        _row(f"{prefix}_heal_suppressed", sum(sup.values()),
             "suppressions", by_reason=sup or None),
        _row(f"{prefix}_fleet_steps_lost",
             summary.get("steps_lost", 0.0), "steps"),
        _row(f"{prefix}_wal_unbalanced_violations",
             wal_unbalanced(world.scheduler.journal.events()
                            if world.scheduler else []),
             "intents", torn_ledger_lines=torn),
    ]
    serve = summary.get("serve")
    if serve:
        ups = sum(1 for r in rows if r.get("event") == "heal_scale_up")
        downs = sum(1 for r in rows
                    if r.get("event") == "heal_scale_down")
        out.append(_row(
            f"{prefix}_autoscale_actions", ups + downs, "actions",
            scale_up=ups, scale_down=downs,
            actions_used=serve.get("actions_used"),
            final_replicas=serve.get("final_replicas")))
        out.append(_row(
            f"{prefix}_serve_breach_s", serve.get("breach_s", 0.0),
            "s", replica_s=serve.get("replica_s")))
    return out
