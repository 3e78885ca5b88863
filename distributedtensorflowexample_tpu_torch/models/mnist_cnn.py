"""MNIST CNN (the JAX package's ``models/mnist_cnn.py``): two 5x5 conv +
2x2 max-pool stages (32 and 64 channels), a 1024-wide dense layer with
dropout, and a 10-way head — 3,274,634 float32 parameters.

Like the flax module with ``dtype=bfloat16``, parameters stay float32 and
the forward casts the input and every weight and bias to the compute
dtype, then returns float32 logits.

Layout: the public input is NHWC ``[B, 28, 28, 1]`` as in the JAX
package; the convolutions run NCHW with OIHW weights, and the activation
is flattened in NHWC order before ``fc1`` (``permute`` back, then
``reshape``), so ``fc1.weight[:, k]`` multiplies the same feature as row
``k`` of the flax kernel (``convert.py`` moves weights, not feature
orders).  Dropout is active only when training and draws from the
``generator`` the caller passes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator | None) -> None:
    # flax's default kernel init: variance 1/fan_in from a normal
    # truncated at two standard deviations (the stddev is corrected for
    # the truncation, as jax.nn.initializers.variance_scaling does).
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class MnistCNN(nn.Module):
    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dropout_rate = float(dropout_rate)
        self.dtype = dtype
        self.conv1 = nn.Conv2d(1, 32, 5, padding=2)
        self.conv2 = nn.Conv2d(32, 64, 5, padding=2)
        self.fc1 = nn.Linear(7 * 7 * 64, 1024)
        self.logits = nn.Linear(1024, num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's default init: lecun-normal kernels, zero biases."""
        for layer in (self.conv1, self.conv2, self.fc1, self.logits):
            fan_in = layer.weight[0].numel()
            _lecun_normal_(layer.weight, fan_in, generator)
            layer.bias.zero_()
        return self

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)                    # NHWC -> NCHW
        x = F.conv2d(x, self.conv1.weight.to(dt), self.conv1.bias.to(dt),
                     padding=2)
        x = F.max_pool2d(F.relu(x), 2, 2)
        x = F.conv2d(x, self.conv2.weight.to(dt), self.conv2.bias.to(dt),
                     padding=2)
        x = F.max_pool2d(F.relu(x), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
        x = F.relu(F.linear(x, self.fc1.weight.to(dt), self.fc1.bias.to(dt)))
        if train and self.dropout_rate > 0.0:
            keep = 1.0 - self.dropout_rate
            u = torch.rand(x.shape, generator=generator, device=x.device)
            x = torch.where(u < keep, x / keep, torch.zeros((), dtype=dt,
                                                            device=x.device))
        x = F.linear(x, self.logits.weight.to(dt), self.logits.bias.to(dt))
        return x.float()
