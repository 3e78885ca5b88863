"""resilience/ — crash-consistent snapshots, fault injection and supervised
recovery (the JAX package's ``resilience/``, in import order):

- :mod:`.snapshot` — atomic payload, manifest last, keep-N,
  newest-valid fallback past a torn write; serving promotes from it
  (``serving/promote.py``).
- :mod:`.shardstore` — the row layouts' shard-redundant store: per-rank
  shards, ring mirrors, a sha256 quorum manifest, restore onto any mesh
  width.
- :mod:`.faults` — deterministic, seed-addressable fault plans injected
  at train-loop boundaries and into the batch stream (preemption, wedge,
  NaN loss, corrupt batch, torn snapshot, heartbeat flap, torn journal,
  kill, host loss, slow rank; ``shard_loss`` and ``bitflip`` damage a
  ``--layout zero3`` faultline's shard store after its final save).
- :mod:`.supervisor` — one child under a heartbeat watchdog, bounded
  jittered retries, the 0/143/3 exit-code protocol, and a journaled
  priority task queue.
- :mod:`.fleet` — gang supervision of N ranks: whole-gang teardown,
  budgets, elastic shrink and grow, and the resume-step agreement over
  the ranks' snapshot stores.

- :mod:`.remediate` — the self-healing layer: anomaly detections
  (health.json flags, ledger rows, serve scrapes) mapped through
  declared, rate-limited policies onto the actuators above —
  guardrailed (flap damping, cooldowns, a global action budget,
  dry-run), write-ahead journaled, every decision a ``heal_*`` ledger
  row (``tools.heal_drill`` measures MTTD/MTTR per fault class).
- :mod:`.scheduler` — the control plane over all of it: a journaled
  multi-job queue admitted against declared (or measured) cost, packed
  onto gang slots, with elastic shrink/grow-on-recovery and loss-free
  SLO preemption as policy (``tools.schedule``).

The names below are exported lazily (PEP 562): ``faults``,
``snapshot`` and ``shardstore`` import torch, while ``scheduler``,
``remediate``, ``fleet`` and ``supervisor`` do not, and the fleet
simulator (``sim/``) and the ledger's readers import those four alone.
"""

import importlib

_EXPORTS = {
    "faults": ("FAULT_KINDS", "FaultInjectionHook", "FaultPlan",
               "FaultSpec", "FaultyBatches", "MetricsTapeHook",
               "NaNGuardHook", "mark_host_down", "tear_journal"),
    "fleet": ("FleetSupervisor", "GangResult", "RankLossRefused",
              "RankLossStructurallyIllegal", "RankLostError"),
    "remediate": ("HEAL_EVENTS", "AnomalyEvent", "FleetTarget",
                  "Guardrails", "HealRule", "HealthWatcher",
                  "LedgerWatcher", "Remediator", "ServeWatcher",
                  "make_evict_actuator", "make_quarantine_actuator",
                  "make_rollback_actuator", "make_slo_actuator",
                  "run_remediated"),
    "scheduler": ("Job", "Scheduler", "load_queue"),
    "shardstore": ("ShardLayout", "ShardSnapshotHook", "ShardStore",
                   "quorum_valid_steps"),
    "snapshot": ("SnapshotHook", "SnapshotStore", "newest_common_step",
                 "valid_steps"),
    "supervisor": ("RetryPolicy", "SupervisedResult", "Supervisor", "Task",
                   "TaskQueue"),
}
_HOME = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_HOME)


def __getattr__(name):
    if name in _HOME:
        return getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
