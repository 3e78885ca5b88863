"""Cluster-flag resolution (a copy of the JAX package's ``cluster.py``
resolver) and the ``torch.distributed`` start-up that replaces
``jax.distributed.initialize``.

* ``--worker_hosts``/``--task_index``, ``--coordinator_address`` with
  ``--process_id`` (or ``--task_index``), or a ``TF_CONFIG`` env var
  resolve to (num_processes, process_id, coordinator_address): one
  process per rank, rank = process id.
* ``--job_name=ps`` (and a ``TF_CONFIG`` ps or evaluator task) is accepted
  and exits with a notice: synchronous data parallelism has no parameter
  servers.
* chief == process 0 (the reference's is_chief == task_index 0).

The process group's backend follows the device: ``nccl`` on ``cuda``,
``gloo`` on ``cpu``.  A group the caller already initialized is used as
it is, rank, world size and backend included.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch.distributed as dist

from distributedtensorflowexample_tpu_torch.config import RunConfig

#: backend per device type (there is no flag for it)
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass
class ClusterInfo:
    num_processes: int = 1
    process_id: int = 0
    coordinator_address: str = ""
    is_chief: bool = True
    role: str = "worker"            # "worker" | "ps" (ps = exit-with-notice)

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def tf_config_env(workers: list[str], index: int,
                  task_type: str = "worker") -> str:
    """Serialize the reference-style ``TF_CONFIG`` for worker ``index``
    (the inverse of :func:`_from_tf_config`)."""
    return json.dumps({"cluster": {"worker": list(workers)},
                       "task": {"type": task_type, "index": index}})


def _from_tf_config() -> ClusterInfo | None:
    raw = os.environ.get("TF_CONFIG", "")
    if not raw:
        return None
    try:
        tf_config = json.loads(raw)
        clus = tf_config["cluster"]
        task = tf_config.get("task", {})
        task_type = str(task.get("type", "worker"))
        idx = int(task.get("index", 0))
    except (json.JSONDecodeError, KeyError, TypeError, ValueError):
        return None
    if task_type == "ps":
        return ClusterInfo(role="ps", is_chief=False)
    # TF task ordering: an optional single-entry "chief" job precedes the
    # "worker" job; both train.  An "evaluator" never joins the training
    # cluster: like ps, it has nothing to do here.
    if task_type == "evaluator":
        return ClusterInfo(role="ps", is_chief=False)
    chief = list(clus.get("chief", []))
    workers = chief + list(clus.get("worker", []))
    if not workers:
        return None
    pid = idx if task_type == "chief" else len(chief) + idx
    return ClusterInfo(num_processes=len(workers), process_id=pid,
                       coordinator_address=workers[0], is_chief=(pid == 0))


def resolve(cfg: RunConfig) -> ClusterInfo:
    """Resolve cluster flags + env into a ClusterInfo (no side effects)."""
    if cfg.job_name == "ps":
        return ClusterInfo(role="ps", is_chief=False)
    info = _from_tf_config()
    if info is not None:
        return info
    if cfg.coordinator_address:
        pid = cfg.process_id if cfg.process_id >= 0 else cfg.task_index
        return ClusterInfo(num_processes=cfg.num_processes, process_id=pid,
                           coordinator_address=cfg.coordinator_address,
                           is_chief=(pid == 0))
    workers = cfg.worker_host_list
    if len(workers) > 1 and cfg.job_name == "worker":
        pid = cfg.process_id if cfg.process_id >= 0 else cfg.task_index
        return ClusterInfo(num_processes=len(workers), process_id=pid,
                           coordinator_address=workers[0],
                           is_chief=(pid == 0))
    return ClusterInfo()


def maybe_initialize_distributed(info: ClusterInfo, device: str) -> None:
    """``torch.distributed.init_process_group`` over
    ``tcp://<coordinator_address>`` with this process's rank, when the
    cluster has more than one process and no group exists yet.
    Idempotent, like the JAX function: a group the caller initialized
    (``gloo`` ranks on one card, a file store in tests) is kept as it
    is."""
    if dist.is_initialized() or not info.is_distributed:
        return
    dist.init_process_group(
        backend=BACKENDS[device],
        init_method=f"tcp://{info.coordinator_address}",
        world_size=info.num_processes, rank=info.process_id)


PS_NOTICE = (
    "[distributedtensorflowexample_tpu_torch] --job_name=ps: parameter-"
    "server processes are obsolete in synchronous data parallelism — every "
    "rank holds the replicated parameters and gradient aggregation is one "
    "all-reduce. This process has nothing to serve and will exit. Launch "
    "only worker roles.")
