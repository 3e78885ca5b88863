"""resilience/ — crash-consistent snapshots (the JAX package's
``resilience/snapshot.py``: atomic payload, manifest last, keep-N,
newest-valid fallback past a torn write) and the shard-redundant store
of the row layouts (``shardstore.py``: per-rank shards, ring mirrors, a
sha256 quorum manifest, restore onto any mesh width).  Serving promotes
from the snapshots (``serving/promote.py``).

The JAX package's fault injection, supervisor, fleet, scheduler and
remediation are not ported yet (ROADMAP Queue 1).
"""

from distributedtensorflowexample_tpu_torch.resilience.snapshot import (  # noqa: F401
    SnapshotHook, SnapshotStore, newest_common_step, valid_steps)
from distributedtensorflowexample_tpu_torch.resilience.shardstore import (  # noqa: F401
    ShardLayout, ShardSnapshotHook, ShardStore, quorum_valid_steps)
