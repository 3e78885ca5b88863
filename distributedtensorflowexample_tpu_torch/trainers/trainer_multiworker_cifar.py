"""Config 5 — multi-host data-parallel CIFAR-10 ResNet-20 on the port
(the JAX package's ``trainers/trainer_multiworker_cifar.py``): config 4's
defaults with the ``worker`` role, one process per host joined by the
cluster flags (one rank each, or M with ``--num_devices`` N*M).

    # on host a (rank 0) and host b (rank 1):
    python -m distributedtensorflowexample_tpu_torch.trainers.trainer_multiworker_cifar \
        --worker_hosts a:2222,b:2222 --task_index 0   # 1 on host b

or ``TF_CONFIG``, or ``--coordinator_address a:2222 --num_processes 2
--process_id r``.  Each rank runs on the card of its index among the
ranks on its own host, so two one-card hosts each use ``cuda:0``.  Only
the chief prints; a ``ps`` role prints the notice and exits.
"""

from __future__ import annotations

import sys

from distributedtensorflowexample_tpu_torch.config import RunConfig, parse_flags
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
from distributedtensorflowexample_tpu_torch.trainers.trainer_mirrored_cifar \
    import CIFAR_DEFAULTS


def build_config(argv=None) -> RunConfig:
    """The config from the trainer's argv and its defaults."""
    return parse_flags(argv, description=__doc__, job_name="worker",
                       **CIFAR_DEFAULTS)


def main(argv=None) -> dict:
    return Engine(RunSpec(model="resnet20", dataset="cifar10",
                          config=build_config(argv), augment=True)).run()


if __name__ == "__main__":
    summary = main(sys.argv[1:])
    if not summary.get("exited") and summary.get("rank", 0) == 0:
        print(f"final accuracy: "
              f"{summary.get('final_accuracy', float('nan')):.4f}")
