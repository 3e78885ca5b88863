"""MNIST softmax regression (the JAX package's ``models/softmax.py``):
the image flattened and one float32 dense layer to 10 logits, 7,850
parameters.  The flax module sets no dtype, so it computes in float32;
so does this one, whatever ``dtype`` the trainer passes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributedtensorflowexample_tpu_torch.models.initializers import (
    lecun_normal_)


class SoftmaxRegression(nn.Module):
    def __init__(self, num_classes: int = 10, in_features: int = 28 * 28):
        super().__init__()
        self.logits = nn.Linear(in_features, num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's default init: a lecun-normal kernel, a zero bias."""
        lecun_normal_(self.logits.weight, self.logits.in_features, generator)
        self.logits.bias.zero_()
        return self

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).float()
        return F.linear(x, self.logits.weight, self.logits.bias)
