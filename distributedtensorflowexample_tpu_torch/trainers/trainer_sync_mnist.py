"""Config 3 — sync-SGD MNIST CNN on the port (the JAX package's
``trainers/trainer_sync_mnist.py``, same defaults).

    python -m distributedtensorflowexample_tpu_torch.trainers.trainer_sync_mnist \
        --dataset synthetic --dequant_impl pallas --pallas_ce true \
        --fused_optimizer true

runs on the CUDA card (``--device cpu`` for the plain versions on the
CPU).  One rank: ``--replicas_to_aggregate`` and multi-rank flags are
refused by name until the multi-rank slice.
"""

from __future__ import annotations

import sys

from distributedtensorflowexample_tpu_torch.config import parse_flags
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec


def main(argv=None) -> dict:
    cfg = parse_flags(argv, description=__doc__,
                      batch_size=64, train_steps=2000, learning_rate=0.05,
                      momentum=0.9, dataset="mnist", sync_mode="sync")
    return Engine(RunSpec(model="mnist_cnn", dataset="mnist",
                          config=cfg)).run()


if __name__ == "__main__":
    summary = main(sys.argv[1:])
    print(f"final accuracy: {summary.get('final_accuracy', float('nan')):.4f}")
