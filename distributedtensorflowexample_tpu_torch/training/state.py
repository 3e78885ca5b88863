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

Under the ZeRO modes (``MomentumSGD.layout``) the content follows the
checkpoint layout the run records: ``bucket_rows`` holds the flat
parameters and this rank's momentum rows, ``zero3_rows`` this rank's
parameter and momentum rows (one part per rank, as async mode's); the
tree form of ``--shard_update`` keeps its momentum as rows but saves the
full flat momentum (gathered from every rank) and takes its own rows
back on a restore, so its checkpoint is a ``tree`` one.
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


def _full_momentum(opt, mesh: Mesh) -> torch.Tensor:
    """The flat momentum of ``--shard_update``'s tree form, gathered from
    every rank's rows (a collective, uncounted)."""
    full = torch.zeros_like(opt.params_flat)
    for b, row in enumerate(opt.momentum_rows):
        opt.plan.unpack(mesh.all_gather_into(row, counted=False), full, b)
    return full


def saveable_state_dict(state: TrainState, mesh: Mesh = ONE_RANK,
                        replicated: bool = True) -> dict[str, Any]:
    """This rank's resumable content as host copies (the optimizer updates
    its buffers in place, so nothing here aliases the live state).

    ``replicated``: the state is the same on every rank (sync mode), and
    one rank's copy is the checkpoint's, so the content carries every
    rank's dropout generator state, all-gathered (a collective: every
    rank calls it); otherwise (async mode, one worker per rank, and the
    row layouts) only this rank's."""
    opt = state.optimizer
    host = lambda t: None if t is None else t.detach().to("cpu", copy=True)
    gen = state.generator.get_state()
    gens = mesh.all_gather(gen) if replicated else {mesh.rank: gen}
    content = {"step": int(state.step), "count": int(opt.count),
               "layout": opt.layout,
               "buffers": {n: host(b)
                           for n, b in state.model.named_buffers()},
               "generators": dict(enumerate(gens)) if replicated else gens}
    if opt.layout == "zero3_rows":
        content["params_rows"] = [host(r) for r in opt.params_rows]
    else:
        content["params"] = host(opt.params_flat)
    if opt.layout != "tree":
        content["momentum_rows"] = (None if opt.momentum_rows is None else
                                    [host(r) for r in opt.momentum_rows])
    elif opt.momentum_rows is not None:
        content["momentum"] = host(_full_momentum(opt, mesh))
    else:
        content["momentum"] = host(opt.momentum_flat)
    return content


def _targets(state: TrainState, content: dict) -> tuple[dict, dict]:
    """This state's tensors and the content's, by the same names."""
    opt = state.optimizer
    want = {f"buffer {n}": b for n, b in state.model.named_buffers()}
    got = {f"buffer {n}": b for n, b in content["buffers"].items()}
    for key in ("params", "momentum", "params_rows", "momentum_rows"):
        if key not in content:
            continue
        mine = getattr(opt, f"{key}_flat" if key in ("params", "momentum")
                       else key)
        if key == "momentum" and opt.momentum_rows is not None:
            mine = torch.empty_like(opt.params_flat)   # sharded below
        theirs = content[key]
        if key.endswith("_rows"):
            mine = dict(enumerate(mine or ()))
            theirs = dict(enumerate(theirs or ()))
            for i in mine.keys() | theirs.keys():
                want[f"{key}[{i}]"], got[f"{key}[{i}]"] = (mine.get(i),
                                                           theirs.get(i))
        else:
            want[key], got[key] = mine, theirs
    return want, got


def load_state_dict(state: TrainState, content: dict[str, Any],
                    mesh: Mesh = ONE_RANK) -> TrainState:
    """Put ``content`` (:func:`saveable_state_dict`'s, read back) into
    ``state`` in place.  A rank whose generator the content lacks (a
    replicated checkpoint written by fewer ranks) keeps its fresh one.
    Content of another model, optimizer or layout is refused by name."""
    opt = state.optimizer
    layout = content.get("layout", "tree")
    if layout != opt.layout:
        raise ValueError(f"checkpoint holds {layout!r} state; this run's "
                         f"layout is {opt.layout!r}")
    want, got = _targets(state, content)
    for name in want.keys() | got.keys():
        w, g = want.get(name), got.get(name)
        shapes = [None if t is None else tuple(t.shape) for t in (w, g)]
        if shapes[0] != shapes[1]:
            raise ValueError(
                f"checkpoint {name} has shape {shapes[1]}, this run's is "
                f"{shapes[0]}: it was written for another model, "
                f"optimizer or mesh size")
    with torch.no_grad():
        for name, w in want.items():
            if w is not None:
                w.copy_(got[name])
        if layout == "tree" and opt.momentum_rows is not None:
            for b, row in enumerate(opt.momentum_rows):
                row.copy_(opt.plan.pack_row(want["momentum"], b, mesh.rank))
    opt.count = int(content["count"])
    state.step = int(content["step"])
    gen = content["generators"].get(mesh.rank)
    if gen is not None:
        state.generator.set_state(gen)
    return state
