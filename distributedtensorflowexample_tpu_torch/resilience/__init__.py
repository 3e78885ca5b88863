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
"""

from distributedtensorflowexample_tpu_torch.resilience.faults import (  # noqa: F401
    FAULT_KINDS, FaultInjectionHook, FaultPlan, FaultSpec, FaultyBatches,
    MetricsTapeHook, NaNGuardHook, mark_host_down, tear_journal)
from distributedtensorflowexample_tpu_torch.resilience.fleet import (  # noqa: F401
    FleetSupervisor, GangResult, RankLossRefused,
    RankLossStructurallyIllegal, RankLostError)
from distributedtensorflowexample_tpu_torch.resilience.remediate import (  # noqa: F401
    HEAL_EVENTS, AnomalyEvent, FleetTarget, Guardrails, HealRule,
    HealthWatcher, LedgerWatcher, Remediator, ServeWatcher,
    make_evict_actuator, make_quarantine_actuator,
    make_rollback_actuator, make_slo_actuator, run_remediated)
from distributedtensorflowexample_tpu_torch.resilience.scheduler import (  # noqa: F401
    Job, Scheduler, load_queue)
from distributedtensorflowexample_tpu_torch.resilience.shardstore import (  # noqa: F401
    ShardLayout, ShardSnapshotHook, ShardStore, quorum_valid_steps)
from distributedtensorflowexample_tpu_torch.resilience.snapshot import (  # noqa: F401
    SnapshotHook, SnapshotStore, newest_common_step, valid_steps)
from distributedtensorflowexample_tpu_torch.resilience.supervisor import (  # noqa: F401
    RetryPolicy, SupervisedResult, Supervisor, Task, TaskQueue)
