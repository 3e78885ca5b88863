"""A new workload in ~50 lines (the JAX package's
``trainers/trainer_tiny_mlp.py``): a TinyMLP module, a blob
``input_fn`` and a ``RunSpec``.  The Engine supplies the ranks, the
replication mode, checkpoints, SIGTERM and the telemetry, so
``--sync_mode``, ``--bucket_grads``, ``--num_devices`` and resume work
here unchanged.

    python -m distributedtensorflowexample_tpu_torch.trainers.trainer_tiny_mlp \
        --train_steps 200

runs on the CUDA card (``--device cpu`` for the CPU).
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F
from torch import nn

from distributedtensorflowexample_tpu_torch.config import parse_flags
from distributedtensorflowexample_tpu_torch.data.synthetic import (
    make_synthetic)
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
from distributedtensorflowexample_tpu_torch.models.initializers import (
    lecun_normal_)

NUM_CLASSES = 4
FEATURES = (8, 8, 1)     # image-shaped so the shared eval path applies


class TinyMLP(nn.Module):
    """flax ``Dense(hidden)``, relu, ``Dense(NUM_CLASSES)`` in float32;
    the layers keep the flax names (``hidden``, ``logits``)."""

    def __init__(self, hidden: int = 32):
        super().__init__()
        self.hidden = nn.Linear(8 * 8, hidden)
        self.logits = nn.Linear(hidden, NUM_CLASSES)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for layer in (self.hidden, self.logits):
            lecun_normal_(layer.weight, layer.in_features, generator)
            layer.bias.zero_()
        return self

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).float()
        return self.logits(F.relu(self.hidden(x)))


def blobs(cfg, split):
    """Learnable blobs: the splits share templates (seed) and differ in
    their draws (sample_seed), so accuracy generalizes."""
    return make_synthetic(4096 if split == "train" else 512, FEATURES,
                          NUM_CLASSES, seed=cfg.seed,
                          sample_seed=cfg.seed + (split == "test"))


def main(argv=None) -> dict:
    cfg = parse_flags(argv, description=__doc__, batch_size=32,
                      train_steps=300, learning_rate=0.1, momentum=0.9,
                      dataset="tiny_blobs", dropout=0.0)
    spec = RunSpec(model="tiny_mlp", dataset="tiny_blobs", config=cfg,
                   model_fn=lambda cfg: TinyMLP(), input_fn=blobs)
    return Engine(spec).run()


if __name__ == "__main__":
    summary = main(sys.argv[1:])
    if summary.get("rank", 0) == 0:         # the chief prints, as it logs
        print(f"final accuracy: "
              f"{summary.get('final_accuracy', float('nan')):.4f}")
