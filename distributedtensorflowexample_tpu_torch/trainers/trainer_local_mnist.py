"""Config 1 — local MNIST softmax regression on the port (the JAX
package's ``trainers/trainer_local_mnist.py``, same defaults: B=100, 1000
steps, lr 0.5, plain SGD, one device).

    python -m distributedtensorflowexample_tpu_torch.trainers.trainer_local_mnist \
        --dataset synthetic

runs on the CUDA card (``--device cpu`` for the CPU).  The model is one
float32 dense layer; momentum is 0, so ``--fused_optimizer`` (momentum
SGD only) is refused, as in the JAX package.
"""

from __future__ import annotations

import sys

from distributedtensorflowexample_tpu_torch.config import RunConfig, parse_flags
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec


def build_config(argv=None) -> RunConfig:
    """The config from the trainer's argv and its defaults."""
    return parse_flags(argv, description=__doc__,
                       batch_size=100, train_steps=1000, learning_rate=0.5,
                       num_devices=1, dataset="mnist")


def main(argv=None) -> dict:
    return Engine(RunSpec(model="softmax", dataset="mnist",
                          config=build_config(argv))).run()


if __name__ == "__main__":
    summary = main(sys.argv[1:])
    if summary.get("rank", 0) == 0:         # the chief prints, as it logs
        print(f"final accuracy: "
              f"{summary.get('final_accuracy', float('nan')):.4f}")
