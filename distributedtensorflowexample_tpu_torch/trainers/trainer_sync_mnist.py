"""Config 3 — sync-SGD MNIST CNN on the port (the JAX package's
``trainers/trainer_sync_mnist.py``, same defaults).

    python -m distributedtensorflowexample_tpu_torch.trainers.trainer_sync_mnist \
        --dataset synthetic --dequant_impl pallas --pallas_ce true \
        --fused_optimizer true

runs on the CUDA card (``--device cpu`` for the plain versions on the
CPU).  Sync data parallelism over N ranks, one process each:
``--num_devices N`` starts N ranks on this host (cards 0..N-1 over NCCL,
0 = every visible card; N gloo ranks with ``--device cpu``), and the
cluster flags (``--coordinator_address``/``--num_processes``/
``--process_id``, ``--worker_hosts``/``--task_index``, ``TF_CONFIG``)
join a process started per rank.  ``--batch_size`` is per rank (the
global batch is N times it) and ``--replicas_to_aggregate R`` takes R of
the N rank gradients per step, as in the JAX package.
"""

from __future__ import annotations

import sys

from distributedtensorflowexample_tpu_torch.config import RunConfig, parse_flags
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec


def build_config(argv=None) -> RunConfig:
    """The config from the trainer's argv and its defaults."""
    return parse_flags(argv, description=__doc__,
                       batch_size=64, train_steps=2000, learning_rate=0.05,
                       momentum=0.9, dataset="mnist", sync_mode="sync")


def main(argv=None) -> dict:
    return Engine(RunSpec(model="mnist_cnn", dataset="mnist",
                          config=build_config(argv))).run()


if __name__ == "__main__":
    summary = main(sys.argv[1:])
    if summary.get("rank", 0) == 0:         # the chief prints, as it logs
        print(f"final accuracy: "
              f"{summary.get('final_accuracy', float('nan')):.4f}")
