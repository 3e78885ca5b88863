"""resilience/ — crash-consistent snapshots (the JAX package's
``resilience/snapshot.py``): atomic payload, manifest last, keep-N,
newest-valid fallback past a torn write.  Serving promotes from them
(``serving/promote.py``).

The JAX package's shard-redundant store (``shardstore.py``), fault
injection, supervisor, fleet, scheduler and remediation are not ported
yet (ROADMAP Queue 1).
"""

from distributedtensorflowexample_tpu_torch.resilience.snapshot import (  # noqa: F401
    SnapshotHook, SnapshotStore, newest_common_step, valid_steps)
