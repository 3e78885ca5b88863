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
  kill, host loss, slow rank; ``shard_loss`` and ``bitflip`` parse, but
  the port's ``tools/faultline.py`` refuses them with ``--layout
  zero3``).
- :mod:`.supervisor` — one child under a heartbeat watchdog, bounded
  jittered retries, the 0/143/3 exit-code protocol, and a journaled
  priority task queue.
- :mod:`.fleet` — gang supervision of N ranks: whole-gang teardown,
  budgets, elastic shrink and grow, and the resume-step agreement over
  the ranks' snapshot stores.

The JAX package's scheduler (``scheduler.py``) and remediation layer
(``remediate.py``) are not ported yet (ROADMAP Queue 1); they build on
these three.
"""

from distributedtensorflowexample_tpu_torch.resilience.faults import (  # noqa: F401
    FAULT_KINDS, FaultInjectionHook, FaultPlan, FaultSpec, FaultyBatches,
    MetricsTapeHook, NaNGuardHook, mark_host_down, tear_journal)
from distributedtensorflowexample_tpu_torch.resilience.fleet import (  # noqa: F401
    FleetSupervisor, GangResult, RankLossRefused,
    RankLossStructurallyIllegal, RankLostError)
from distributedtensorflowexample_tpu_torch.resilience.shardstore import (  # noqa: F401
    ShardLayout, ShardSnapshotHook, ShardStore, quorum_valid_steps)
from distributedtensorflowexample_tpu_torch.resilience.snapshot import (  # noqa: F401
    SnapshotHook, SnapshotStore, newest_common_step, valid_steps)
from distributedtensorflowexample_tpu_torch.resilience.supervisor import (  # noqa: F401
    RetryPolicy, SupervisedResult, Supervisor, Task, TaskQueue)
