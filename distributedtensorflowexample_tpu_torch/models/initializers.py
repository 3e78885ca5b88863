"""flax's default parameter initializers, drawn from a ``torch.Generator``.

The values cannot equal flax's (threefry against torch's generators); the
distributions are the same, so a port run from its own seed trains like
a JAX run from its seed.  Parity tests load the JAX package's params
through ``convert.py`` instead.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None) -> None:
    """flax's default kernel init: variance 1/fan_in from a normal
    truncated at two standard deviations (the stddev is corrected for the
    truncation, as ``jax.nn.initializers.variance_scaling`` does)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def embed_normal_(w: torch.Tensor, generator: torch.Generator | None) -> None:
    """flax ``nn.Embed``'s default init for a ``[num, features]`` table:
    ``variance_scaling(1.0, "fan_in", "normal", out_axis=0)``, a plain
    normal with stddev 1/sqrt(features)."""
    nn.init.normal_(w, std=1.0 / math.sqrt(w.shape[1]), generator=generator)
