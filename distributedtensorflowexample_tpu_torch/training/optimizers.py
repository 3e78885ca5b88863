"""Learning-rate schedules and the momentum-SGD optimizer (the JAX
package's ``training/optimizers.py``).

Schedules are host-side: :func:`build_schedule` returns ``count -> lr``,
evaluated once per step with the operations and roundings of the optax
schedules the JAX package builds inside its jitted step, so constant,
step and warmup values equal optax's float32 bit for bit; the cosine
agrees to a fraction of an ulp of its cos (see ``_cosine``).

:class:`MomentumSGD` owns three flat float32 buffers — parameters,
momentum, gradients — and rebinds every model parameter (and its
``.grad``) as a view into them.  Backward accumulates straight into the
gradient buffer, and one apply updates every parameter: the fused kernel
(``--fused_optimizer``, ``ops/kernels/sgd.py``, one launch per step) or,
without the flag, the same recurrence in plain PyTorch.  Either way the
math is ``optax.sgd``'s: ``m = mu * m + g``, ``p = p - lr * m`` (plain
``p = p - lr * g`` when momentum is 0).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from distributedtensorflowexample_tpu_torch.config import RunConfig
from distributedtensorflowexample_tpu_torch.ops.kernels.sgd import (
    fused_sgd_apply, sgd_plain)
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal

_f32 = np.float32


def _constant(base: float) -> Callable[[int], np.float32]:
    return lambda count: _f32(base)


def _cosine(base: float, decay_steps: int) -> Callable[[int], np.float32]:
    # optax.cosine_decay_schedule (alpha 0, exponent 1), computed in
    # float64 and rounded once.  It cannot match optax bit for bit: XLA's
    # float32 cos is not correctly rounded (optax's own eager and jitted
    # values differ), and near the end 1 + cos(x) cancels, so the gap is
    # a fraction of an ulp of cos times base/2 (tests/test_torch_training.py).
    def sched(count):
        c = min(int(count), decay_steps)
        return _f32(base * 0.5 * (1.0 + np.cos(np.pi * c / decay_steps)))
    return sched


def _piecewise(base: float, boundaries: dict) -> Callable[[int], np.float32]:
    # optax.piecewise_constant_schedule.
    def sched(count):
        v = _f32(base)
        for threshold, scale in sorted(boundaries.items()):
            ind = np.maximum(_f32(0.0), np.sign(_f32(threshold - count)))
            v = v * ind + (_f32(1.0) - ind) * _f32(scale) * v
        return _f32(v)
    return sched


def _fma32(a, b, c) -> np.float32:
    """float32 fma(a, b, c), rounded once: the float64 product of two
    float32 values is exact."""
    return _f32(float(_f32(a)) * float(_f32(b)) + float(_f32(c)))


def _linear(init: float, end: float,
            steps: int) -> Callable[[int], np.float32]:
    # optax.linear_schedule (polynomial, power 1, no transition_begin) as
    # XLA compiles it inside the JAX package's jitted step: the division
    # by the constant step count becomes a multiply by its float32
    # reciprocal, and both multiply-adds contract into fmas.
    recip = _f32(1.0) / _f32(steps)

    def sched(count):
        c = min(max(int(count), 0), steps)
        frac = _fma32(-c, recip, 1.0)
        return _fma32(init - end, frac, end)
    return sched


def build_schedule(cfg: RunConfig) -> Callable[[int], np.float32]:
    base = cfg.learning_rate
    if cfg.lr_schedule == "constant":
        sched = _constant(base)
    elif cfg.lr_schedule == "cosine":
        sched = _cosine(base, max(1, cfg.train_steps - cfg.warmup_steps))
    elif cfg.lr_schedule == "step":
        # /10 at 50% and 75% of training, boundaries in the post-warmup
        # frame (see the JAX package's build_schedule).
        half = max(1, cfg.train_steps // 2 - cfg.warmup_steps)
        three_q = max(2, (cfg.train_steps * 3) // 4 - cfg.warmup_steps)
        sched = _piecewise(base, {half: 0.1, three_q: 0.1})
    else:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if cfg.warmup_steps > 0:
        warmup, after, w = _linear(0.0, base, cfg.warmup_steps), sched, \
            cfg.warmup_steps
        sched = lambda count: warmup(count) if count < w else after(count - w)
    return sched


class MomentumSGD:
    """Momentum SGD over flat buffers.  ``zero_grad`` clears the gradient
    buffer (one memset); ``step`` applies one update at
    ``schedule(count)`` and advances ``count``."""

    def __init__(self, model: nn.Module, schedule: Callable[[int], float],
                 momentum: float, fused: bool):
        named = [(n, p) for n, p in model.named_parameters()]
        device = named[0][1].device
        total = sum(p.numel() for _, p in named)
        self.schedule = schedule
        self.momentum = float(momentum)
        self.fused = fused
        self.count = 0
        self.params_flat = torch.empty(total, dtype=torch.float32,
                                       device=device)
        self.grads_flat = torch.zeros_like(self.params_flat)
        self.momentum_flat = (torch.zeros_like(self.params_flat)
                              if self.momentum > 0.0 else None)
        self.slices: dict[str, tuple[int, torch.Size]] = {}
        offset = 0
        with torch.no_grad():
            for name, p in named:
                n = p.numel()
                view = self.params_flat[offset:offset + n].view(p.shape)
                view.copy_(p)
                p.data = view
                p.grad = self.grads_flat[offset:offset + n].view(p.shape)
                self.slices[name] = (offset, p.shape)
                offset += n

    def views(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """``flat`` (one of the three buffers) cut into per-parameter
        views, keyed by the model's parameter names."""
        return {name: flat[off:off + shape.numel()].view(shape)
                for name, (off, shape) in self.slices.items()}

    def zero_grad(self) -> None:
        self.grads_flat.zero_()

    @torch.no_grad()
    def step(self) -> None:
        lr = float(self.schedule(self.count))
        if self.fused:
            fused_sgd_apply(self.params_flat, self.momentum_flat,
                            self.grads_flat, lr, self.momentum)
        elif self.momentum_flat is not None:
            sgd_plain(self.params_flat, self.momentum_flat, self.grads_flat,
                      lr, self.momentum)
        else:
            p = self.params_flat
            p.copy_(p.double().sub_(self.grads_flat.double()
                                    .mul_(float(_f32(lr)))))
        self.count += 1


def build_optimizer(cfg: RunConfig, model: nn.Module) -> MomentumSGD:
    """Rebinds ``model``'s parameters into the optimizer's flat buffers.
    Keeps the JAX package's ``--fused_optimizer`` refusals."""
    sched = build_schedule(cfg)
    if cfg.fused_optimizer:
        if cfg.momentum <= 0.0 or cfg.weight_decay > 0.0:
            raise ModeRefusal(
                "--fused_optimizer implements momentum SGD only; it needs "
                f"momentum > 0 (got {cfg.momentum}) and weight_decay == 0 "
                f"(got {cfg.weight_decay})")
        if cfg.shard_update:
            raise ModeRefusal(
                "--shard_update shards the update across ranks; the fused "
                "apply updates one flat buffer per rank — use one or the "
                "other")
    if cfg.weight_decay > 0.0:
        raise ModeRefusal(
            "--weight_decay (optax.add_decayed_weights) is not ported to "
            "the PyTorch package yet")
    if cfg.shard_update:
        raise ModeRefusal(
            "--shard_update (ZeRO-1 update sharding) is not ported to the "
            "PyTorch package yet; it needs the multi-rank slice")
    return MomentumSGD(model, sched, cfg.momentum, fused=cfg.fused_optimizer)
