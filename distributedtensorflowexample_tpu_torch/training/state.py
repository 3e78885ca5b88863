"""Training state (the JAX package's ``training/state.py``).

The JAX ``TrainState`` is an immutable pytree the jitted step donates and
returns.  Here it is a plain mutable holder: the step updates the model's
parameters in place (they are views into the optimizer's flat buffer) and
advances ``step``, a host int, so reading it never waits on the device.

On a mesh of N ranks every rank holds a replica: each initializes from
the same seed and rank 0's flat parameters are broadcast, so the replicas
start bitwise equal and stay so (every rank applies the same all-reduced
gradient).  A model's buffers (batch norm's running statistics, outside
the flat parameter buffer) are broadcast from rank 0 with them, and stay
equal because every rank updates them from the same global-batch
statistics (``models/resnet.py``).  Dropout is drawn per rank, from a generator seeded from
``(seed, rank)``: each rank masks its own slice of the global batch, as
the JAX package draws one mask over the whole batch.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from distributedtensorflowexample_tpu_torch.parallel.mesh import (
    ONE_RANK, Mesh)
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
               device: torch.device,
               mesh: Mesh = ONE_RANK) -> "TrainState":
        """Initialize ``model`` from ``seed`` on the host (flax's default
        init distributions), move it to ``device``, then hand it to
        ``build_opt(model)``, which binds its parameters into the
        optimizer's flat buffers; rank 0 of ``mesh`` (``parallel/mesh.py``)
        then broadcasts its flat parameters and the model's buffers.
        Dropout draws from
        a second generator on ``device``, seeded from ``seed`` and the
        rank."""
        init = torch.Generator().manual_seed(int(seed))
        model.reset_parameters(init)
        model.to(device)
        optimizer = build_opt(model)
        mesh.broadcast(optimizer.params_flat)
        for buf in model.buffers():
            mesh.broadcast(buf)
        gen = torch.Generator(device=device)
        gen.manual_seed(_dropout_seed(seed, mesh.rank))
        return cls(step=0, model=model, optimizer=optimizer, generator=gen)


def _dropout_seed(seed: int, rank: int) -> int:
    """The seed of ``rank``'s dropout generator; rank 0 keeps the
    one-rank run's ``seed + 1``."""
    return (int(seed) + 1 + int(rank) * 0x9E3779B97F4A7C15) % (2 ** 63)
