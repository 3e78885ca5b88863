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

:func:`saveable_state_dict` and :func:`load_state_dict` are THE one
definition of what makes a run resumable (the JAX package's
``training/checkpoint.saveable_state_dict``): the step, the flat
parameters and momentum, the optimizer's count (the schedule's
position), the model's buffers, and the dropout generators' states of
every rank.  ``training/checkpoint.py`` writes and reads it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

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


def saveable_state_dict(state: TrainState, mesh: Mesh = ONE_RANK,
                        replicated: bool = True) -> dict[str, Any]:
    """This rank's resumable content as host copies (the optimizer updates
    its buffers in place, so nothing here aliases the live state).

    ``replicated``: the state is the same on every rank (sync mode), and
    one rank's copy is the checkpoint's, so the content carries every
    rank's dropout generator state, all-gathered (a collective: every
    rank calls it); otherwise (async mode, one worker per rank) only this
    rank's."""
    opt = state.optimizer
    host = lambda t: None if t is None else t.detach().to("cpu", copy=True)
    gen = state.generator.get_state()
    gens = mesh.all_gather(gen) if replicated else {mesh.rank: gen}
    return {"step": int(state.step), "count": int(opt.count),
            "params": host(opt.params_flat),
            "momentum": host(opt.momentum_flat),
            "buffers": {n: host(b) for n, b in state.model.named_buffers()},
            "generators": dict(enumerate(gens)) if replicated else gens}


def load_state_dict(state: TrainState, content: dict[str, Any],
                    mesh: Mesh = ONE_RANK) -> TrainState:
    """Put ``content`` (:func:`saveable_state_dict`'s, read back) into
    ``state`` in place.  A rank whose generator the content lacks (a
    replicated checkpoint written by fewer ranks) keeps its fresh one.
    Content of another model or optimizer is refused by name."""
    opt = state.optimizer
    want = {"params": opt.params_flat, "momentum": opt.momentum_flat,
            **{f"buffer {n}": b for n, b in state.model.named_buffers()}}
    got = {"params": content["params"], "momentum": content["momentum"],
           **{f"buffer {n}": b for n, b in content["buffers"].items()}}
    for name in want.keys() | got.keys():
        w, g = want.get(name), got.get(name)
        shapes = [None if t is None else tuple(t.shape) for t in (w, g)]
        if shapes[0] != shapes[1]:
            raise ValueError(
                f"checkpoint {name} has shape {shapes[1]}, this run's is "
                f"{shapes[0]}: it was written for another model or "
                f"optimizer")
    with torch.no_grad():
        for name, w in want.items():
            if w is not None:
                w.copy_(got[name])
    opt.count = int(content["count"])
    state.step = int(content["step"])
    gen = content["generators"].get(mesh.rank)
    if gen is not None:
        state.generator.set_state(gen)
    return state
