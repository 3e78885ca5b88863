"""Config 4 — single-host data-parallel CIFAR-10 ResNet-20 on the port
(the JAX package's ``trainers/trainer_mirrored_cifar.py``, same
defaults: B=128 per rank, 5000 steps, lr 0.1, momentum 0.9, weight decay
1e-4, the step schedule after 200 warmup steps, and the on-device random
crop and flip).

    python -m distributedtensorflowexample_tpu_torch.trainers.trainer_mirrored_cifar \
        --dataset synthetic --dequant_impl pallas --pallas_ce true

runs on the CUDA card (``--device cpu`` for the CPU); ``--num_devices N``
starts N ranks on this host (one per card over NCCL; N gloo ranks with
``--device cpu``), whose batch norm normalizes over the global batch.
Weight decay rules out ``--fused_optimizer``, as in the JAX package.
"""

from __future__ import annotations

import sys

from distributedtensorflowexample_tpu_torch.config import RunConfig, parse_flags
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec

#: The CIFAR trainers' defaults (``trainer_multiworker_cifar`` adds its
#: worker role).
CIFAR_DEFAULTS = dict(batch_size=128, train_steps=5000, learning_rate=0.1,
                      momentum=0.9, weight_decay=1e-4, lr_schedule="step",
                      warmup_steps=200, dataset="cifar10")


def build_config(argv=None) -> RunConfig:
    """The config from the trainer's argv and its defaults."""
    return parse_flags(argv, description=__doc__, **CIFAR_DEFAULTS)


def main(argv=None) -> dict:
    return Engine(RunSpec(model="resnet20", dataset="cifar10",
                          config=build_config(argv), augment=True)).run()


if __name__ == "__main__":
    summary = main(sys.argv[1:])
    if summary.get("rank", 0) == 0:         # the chief prints, as it logs
        print(f"final accuracy: "
              f"{summary.get('final_accuracy', float('nan')):.4f}")
