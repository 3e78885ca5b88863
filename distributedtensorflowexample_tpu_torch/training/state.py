"""Training state (the JAX package's ``training/state.py``).

The JAX ``TrainState`` is an immutable pytree the jitted step donates and
returns.  Here it is a plain mutable holder: the step updates the model's
parameters in place (they are views into the optimizer's flat buffer) and
advances ``step``, a host int, so reading it never waits on the device.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from distributedtensorflowexample_tpu_torch.training.optimizers import (
    MomentumSGD)


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: MomentumSGD
    generator: torch.Generator      # dropout draws, on the model's device

    @classmethod
    def create(cls, model: nn.Module, build_opt, seed: int,
               device: torch.device) -> "TrainState":
        """Initialize ``model`` from ``seed`` on the host (flax's default
        init distributions), move it to ``device``, then hand it to
        ``build_opt(model)``, which binds its parameters into the
        optimizer's flat buffers.  Dropout draws from a second generator
        on ``device``, seeded from ``seed`` too."""
        init = torch.Generator().manual_seed(int(seed))
        model.reset_parameters(init)
        model.to(device)
        optimizer = build_opt(model)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) + 1)
        return cls(step=0, model=model, optimizer=optimizer, generator=gen)
