"""CIFAR-10 ResNet (the JAX package's ``models/resnet.py``): a 3x3 stem,
three stages of basic residual blocks at widths 16/32/64 (stride 2 into
stages 1 and 2), batch norm, a global average pool and a 10-way head.
ResNet-20 (three blocks per stage) has 272,474 float32 parameters.

As in the flax module with ``dtype=bfloat16``, parameters and batch-norm
statistics stay float32 and the forward computes in ``dtype``, with the
reference's roundings kept where they differ from PyTorch's defaults:

- Convolutions are flax's ``padding="SAME"``: at stride 2 on an even
  input a 3x3 kernel pads (0, 1) (low, high), not the (1, 1) of
  ``padding=1``, which gives the same shapes and other values.
- Batch norm is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, not
  ``nn.BatchNorm2d``: statistics in float32 with the fast variance
  ``max(0, E[x^2] - E[x]^2)``, the normalization in float32 in flax's
  order ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` and one cast
  to ``dtype``; the running variance takes the biased batch variance.
  In training the statistics are those of the GLOBAL batch, as the JAX
  step computes them under its sharded jit: on a mesh of N ranks each
  batch-norm layer all-reduces its stacked per-channel ``[mean,
  mean(x^2)]`` in the forward and their cotangents in the backward
  (:class:`GlobalMean`, counted by ``Mesh.all_reduces``); one rank
  issues none.  In eval the running statistics are read, with no
  collective.
- The pool is ``jnp.mean`` over H and W: a float32 sum, then the cast to
  ``dtype``; the head is a ``dtype`` dense layer whose logits return as
  float32.

``remat="block"`` checkpoints each residual block
(``torch.utils.checkpoint``, non-reentrant): the backward recomputes a
block's forward instead of keeping its activations, as flax's
``nn.remat(BasicBlock)`` does.  The recompute must not replay the
block's side effects: it reuses the batch statistics of the first
forward (:class:`_StatsTape`; so under sync batch norm it issues no
second all-reduce) and leaves the running buffers alone, which the first
forward updated once.  The non-reentrant checkpoint backpropagates
through the first forward's graph, so the gradient and its all-reduces
are those of ``remat="none"``.  ResNet-20 draws no random numbers in its
forward (no dropout), so the recompute needs no generator state, and
none is saved (the checkpoint would restore only the global one).

Layout: the public input is NHWC ``[B, 32, 32, 3]``; the forward permutes
it to an NCHW view with channels-last strides, so cuDNN runs NHWC
convolutions on the card.  Weights are OIHW (``convert.py`` moves flax's
HWIO kernels), and every name follows the flax tree
(``stage1_block0.bn_proj.weight`` is ``stage1_block0/bn_proj/scale``,
its running mean the buffer ``stage1_block0.bn_proj.mean``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributedtensorflowexample_tpu_torch.models.initializers import (
    lecun_normal_)
from distributedtensorflowexample_tpu_torch.parallel.mesh import (
    ONE_RANK, Mesh)

BN_MOMENTUM = 0.9
BN_EPSILON = 1e-5


class GlobalMean(torch.autograd.Function):
    """Per-rank means ``[k, C]`` -> the means over the global batch: the
    sum over the ranks divided by N in the forward, and the same of the
    cotangent in the backward (every rank's loss reads the global means,
    so each local mean's gradient is the summed cotangent over N).  The
    ranks hold equal row counts, as the sharded global batch does."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return mesh.all_reduce(local.clone()).div_(mesh.size)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh = ctx.mesh
        return mesh.all_reduce(grad.contiguous().clone()).div_(mesh.size), \
            None


class _Replayed(GlobalMean):
    """The recompute's batch statistics: the first forward's global
    values, returned without a collective; the gradient is GlobalMean's
    (the non-reentrant checkpoint backpropagates through the first
    forward's graph, so it is not reached there)."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, first: torch.Tensor,
                mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return first.clone()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return GlobalMean.backward(ctx, grad)[0], None, None


class _StatsTape:
    """One checkpointed block call's batch statistics: each batch-norm
    layer appends its global ``[mean, mean(x^2)]`` in the first forward,
    and reads them back, in order, in the recompute."""

    def __init__(self):
        self.stats: list[torch.Tensor] = []
        self.replaying = False
        self._pos = 0

    def replay(self) -> None:
        self.replaying = True
        self._pos = 0

    def next(self) -> torch.Tensor:
        self._pos += 1
        return self.stats[self._pos - 1]


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding (low, high) of one spatial axis: the output
    has ``ceil(size / stride)`` positions and the extra row goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, weight: torch.Tensor,
              stride: int) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME", use_bias=False)`` on an NCHW
    ``x``, square kernels and strides."""
    k = weight.shape[-1]
    lo_h, hi_h = same_pads(x.shape[2], k, stride)
    lo_w, hi_w = same_pads(x.shape[3], k, stride)
    if lo_h == hi_h and lo_w == hi_w:
        return F.conv2d(x, weight, stride=stride, padding=(lo_h, lo_w))
    return F.conv2d(F.pad(x, (lo_w, hi_w, lo_h, hi_h)), weight,
                    stride=stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis of an NCHW input;
    ``weight`` is flax's ``scale``, and the buffers ``mean`` and ``var``
    are its ``batch_stats``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool,
                mesh: Mesh = ONE_RANK,
                tape: _StatsTape | None = None) -> torch.Tensor:
        """``tape``: the checkpointed block's statistics; in its recompute
        the first forward's statistics are reused and the buffers are not
        updated again (the recompute runs the same operations, which the
        checkpoint matches saved tensor by saved tensor)."""
        xf = x.float()
        if train:
            stats = torch.stack([xf.mean(dim=(0, 2, 3)),
                                 (xf * xf).mean(dim=(0, 2, 3))])
            replay = tape is not None and tape.replaying
            if replay:
                stats = _Replayed.apply(stats, tape.next(), mesh)
            elif mesh.size > 1:
                stats = GlobalMean.apply(stats, mesh)
            mean, mean2 = stats.unbind(0)
            var = (mean2 - mean * mean).clamp_min(0.0)
            if not replay:
                if tape is not None:
                    tape.stats.append(stats.detach())
                with torch.no_grad():
                    self.mean.copy_(BN_MOMENTUM * self.mean
                                    + (1 - BN_MOMENTUM) * mean)
                    self.var.copy_(BN_MOMENTUM * self.var
                                   + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + BN_EPSILON) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)


class BasicBlock(nn.Module):
    """conv-BN-relu, conv-BN, plus the input (through a strided 1x1
    ``proj`` and ``bn_proj`` when the shape changes), then relu."""

    def __init__(self, in_filters: int, filters: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_filters, filters, 3, bias=False)
        self.bn1 = BatchNorm(filters, dtype)
        self.conv2 = nn.Conv2d(filters, filters, 3, bias=False)
        self.bn2 = BatchNorm(filters, dtype)
        self.has_proj = stride != 1 or in_filters != filters
        if self.has_proj:
            self.proj = nn.Conv2d(in_filters, filters, 1, bias=False)
            self.bn_proj = BatchNorm(filters, dtype)

    def forward(self, x: torch.Tensor, train: bool, mesh: Mesh,
                tape: _StatsTape | None = None) -> torch.Tensor:
        dt = self.dtype
        # The tape only under remat: without it, the batch-norm layers
        # are called as they always were.
        extra = () if tape is None else (tape,)
        y = conv_same(x, self.conv1.weight.to(dt), self.stride)
        y = F.relu(self.bn1(y, train, mesh, *extra))
        y = conv_same(y, self.conv2.weight.to(dt), 1)
        y = self.bn2(y, train, mesh, *extra)
        residual = x
        if self.has_proj:
            residual = conv_same(x, self.proj.weight.to(dt), self.stride)
            residual = self.bn_proj(residual, train, mesh, *extra)
        return F.relu(y + residual)


def _checkpointed_block(block: BasicBlock, x: torch.Tensor,
                        mesh: Mesh) -> torch.Tensor:
    """A training forward of ``block`` under ``torch.utils.checkpoint``;
    its recompute replays the first forward's statistics (a tape per
    call)."""
    tape = _StatsTape()

    def run(inp: torch.Tensor) -> torch.Tensor:
        out = block(inp, True, mesh, tape)
        tape.replay()                   # any later call is the recompute
        return out

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class ResNetCIFAR(nn.Module):
    """He-style CIFAR ResNet of depth 6n+2, n = ``blocks_per_stage``.
    ``mesh`` is the data-parallel group whose global batch the
    batch-norm statistics span (one rank by default); ``remat``: ``none``
    or ``block`` (each residual block checkpointed in training)."""

    def __init__(self, blocks_per_stage: int = 3,
                 widths: tuple[int, ...] = (16, 32, 64),
                 num_classes: int = 10, dtype: torch.dtype = torch.bfloat16,
                 mesh: Mesh = ONE_RANK, remat: str = "none"):
        super().__init__()
        if remat not in ("none", "block"):
            raise ValueError(f"unknown remat policy {remat!r} (one of "
                             f"none, block)")
        self.dtype = dtype
        self.mesh = mesh
        self.remat = remat
        self.conv_init = nn.Conv2d(3, widths[0], 3, bias=False)
        self.bn_init = BatchNorm(widths[0], dtype)
        self.block_names = []
        filters = widths[0]
        for stage, width in enumerate(widths):
            for block in range(blocks_per_stage):
                stride = 2 if stage > 0 and block == 0 else 1
                name = f"stage{stage}_block{block}"
                self.add_module(name, BasicBlock(filters, width, stride,
                                                 dtype))
                self.block_names.append(name)
                filters = width
        self.logits = nn.Linear(filters, num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's defaults: lecun-normal conv and dense kernels, a zero
        dense bias, batch-norm scale 1 and bias 0, running mean 0 and
        variance 1."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()
        lecun_normal_(self.logits.weight, self.logits.in_features, generator)
        self.logits.bias.zero_()
        return self

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt, mesh = self.dtype, self.mesh
        x = x.to(dt).permute(0, 3, 1, 2)            # NHWC -> NCHW view
        x = conv_same(x, self.conv_init.weight.to(dt), 1)
        x = F.relu(self.bn_init(x, train, mesh))
        remat = (self.remat == "block" and train
                 and torch.is_grad_enabled())
        for name in self.block_names:
            block = getattr(self, name)
            x = (_checkpointed_block(block, x, mesh) if remat
                 else block(x, train, mesh))
        x = x.float().mean(dim=(2, 3)).to(dt)
        x = F.linear(x, self.logits.weight.to(dt), self.logits.bias.to(dt))
        return x.float()


def ResNet20(num_classes: int = 10, dtype: torch.dtype = torch.bfloat16,
             mesh: Mesh = ONE_RANK, remat: str = "none") -> ResNetCIFAR:
    return ResNetCIFAR(blocks_per_stage=3, num_classes=num_classes,
                       dtype=dtype, mesh=mesh, remat=remat)
