"""Decoder-only transformer LM (the JAX package's
``models/transformer_lm.py``): pre-LN causal blocks, a GELU MLP, learned
positions and a weight-tied head, in the size ladder ``LM_SIZES``
(lm_base: 57,289,728 float32 parameters).

Like the flax module, parameters stay float32 and the forward computes in
``dtype`` (bfloat16 by default), with the reference's roundings kept
where they differ from PyTorch's defaults:

- LayerNorm is flax's: epsilon 1e-6, statistics in float32 with the fast
  variance E[x^2] - E[x]^2 (clipped at 0), normalization in float32,
  one cast to ``dtype`` at the end.
- GELU is the tanh approximation (flax ``nn.gelu``'s default) written
  out as ``jax.nn.gelu`` writes it: its constants sqrt(2/pi) and 0.044715
  are rounded to ``dtype`` (0.796875 and 0.044677734375 in bfloat16) and
  every operation rounds to ``dtype``.  ``F.gelu(approximate="tanh")``
  keeps the constants in float32 and rounds once, which moves bfloat16
  logits by up to two ulps; written out, the lm_tiny forward is bitwise
  the JAX package's on the CPU.
- Attention scores are divided by sqrt(Dh) rounded to ``dtype`` first
  (5.65625 at Dh=32 in bfloat16), masked with ``dtype(-1e9)``, and
  softmaxed in float32 before the cast back.  The attention is plain
  matrix products, as in the reference (no fused attention, whose scaling
  and masking round elsewhere).
- The head is tied: logits = x @ E^T in ``dtype``, then float32.  The
  embedding is cast to ``dtype`` separately for the lookup and the head
  (as flax's ``Embed`` does), so its two gradients meet in float32.
- Out-of-vocabulary ids poison every logit to NaN, on the device and
  without a host sync; the lookup itself uses the clamped ids.

``remat="block"`` recomputes each block's forward in the backward pass
(``torch.utils.checkpoint``).  Dropout masks are drawn from the caller's
generator OUTSIDE the checkpointed function and passed in, so the
recompute sees the same masks; with dropout 0 remat is bitwise the plain
forward and backward.  The block's parameters, as the block reads them,
are passed in too, and bound for each run through
``torch.func.functional_call``: the recompute reads the tensors the
forward read even where the module no longer holds them when the
backward runs (ZeRO-3's gathered leaves, ``parallel/zero3.py``).

Parameter names follow the flax tree (``block3.ln1.weight`` is
``block3/ln1/scale``), so ``convert.py`` maps the two by name.
"""

from __future__ import annotations

import math
import operator

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from distributedtensorflowexample_tpu_torch.models.initializers import (
    embed_normal_, lecun_normal_)

#: The vocabulary: < 256, so token splits are stored as uint8 and ids
#: 250-255 are detectably out of vocabulary.
LM_VOCAB = 250

#: The size ladder (the JAX package's).
LM_SIZES = {
    "lm_tiny": dict(n_layers=2, d_model=64, n_heads=2, d_ff=256),
    "lm_small": dict(n_layers=4, d_model=256, n_heads=4, d_ff=1024),
    "lm_base": dict(n_layers=8, d_model=768, n_heads=12, d_ff=3072),
}

REMAT_POLICIES = ("none", "block")


def _dense(x: torch.Tensor, layer: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    return F.linear(x, layer.weight.to(dt), layer.bias.to(dt))


def _rounded(value: float, dt: torch.dtype) -> float:
    """``value`` rounded to ``dt``, as the reference's ``jnp.asarray(value,
    dtype)`` constants are."""
    return float(torch.tensor(value, dtype=dt, device="cpu"))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``: constants in ``x.dtype``."""
    c = _rounded(math.sqrt(2.0 / math.pi), x.dtype)
    k = _rounded(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def _keep_mask(x: torch.Tensor, rate: float,
               generator: torch.Generator | None) -> torch.Tensor:
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return u < 1.0 - rate


def _dropout(x: torch.Tensor, keep: torch.Tensor | None,
             rate: float) -> torch.Tensor:
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), 0.0)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=dtype)``; ``weight`` is flax's ``scale``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True)
               - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class DecoderBlock(nn.Module):
    """Pre-LN block: LN -> causal MHA -> residual, LN -> MLP -> residual."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"n_heads {n_heads}")
        self.n_heads = n_heads
        self.dropout_rate = float(dropout_rate)
        self.dtype = dtype
        head_dim = d_model // n_heads
        # The reference divides by jnp.asarray(Dh ** 0.5, dtype): the
        # constant is rounded to the compute dtype before the division.
        self.scale = _rounded(head_dim ** 0.5, dtype)
        self.ln1 = LayerNorm(d_model, dtype)
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.attn_out = nn.Linear(d_model, d_model)
        self.ln2 = LayerNorm(d_model, dtype)
        self.mlp_in = nn.Linear(d_model, d_ff)
        self.mlp_out = nn.Linear(d_ff, d_model)

    def qkv_heads(self, x: torch.Tensor) -> tuple:
        """x [B, T, d] -> (q, k, v), each [B, T, H, Dh]."""
        b, t, _ = x.shape
        qkv = _dense(self.ln1(x), self.qkv, self.dtype).view(
            b, t, 3, self.n_heads, -1)
        return qkv.unbind(2)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               live: torch.Tensor) -> torch.Tensor:
        """Queries q [B, T, H, Dh] over keys and values [B, S, H, Dh],
        where ``live`` (bool, broadcast to [B, H, T, S]) is True; -> the
        attention output through ``attn_out``, [B, T, d]."""
        dt = self.dtype
        scores = torch.einsum("bthd,bshd->bhts", q, k) / self.scale
        scores = torch.where(live, scores, -1e9)          # dt(-1e9)
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        att = torch.einsum("bhts,bshd->bthd", probs, v).flatten(2)
        return _dense(att, self.attn_out, dt)

    def mlp(self, x: torch.Tensor,
            keep_mlp: torch.Tensor | None = None) -> torch.Tensor:
        """The second residual half: x + MLP(LN(x))."""
        dt = self.dtype
        h = gelu_tanh(_dense(self.ln2(x), self.mlp_in, dt))
        return x + _dropout(_dense(h, self.mlp_out, dt), keep_mlp,
                            self.dropout_rate)

    def forward(self, x: torch.Tensor, keep_att: torch.Tensor | None = None,
                keep_mlp: torch.Tensor | None = None) -> torch.Tensor:
        """``keep_att``/``keep_mlp``: the two dropout keep-masks
        (``[B, T, d_model]`` bool), or None for no dropout."""
        q, k, v = self.qkv_heads(x)
        pos = torch.arange(x.shape[1], device=x.device)
        att = self.attend(q, k, v, pos[:, None] >= pos[None, :])
        x = x + _dropout(att, keep_att, self.dropout_rate)
        return self.mlp(x, keep_mlp)


class TransformerLM(nn.Module):
    """tokens [B, T] (any integer dtype; uint8 is the resident storage) ->
    logits [B, T, vocab] float32."""

    def __init__(self, vocab_size: int = LM_VOCAB, n_layers: int = 2,
                 d_model: int = 64, n_heads: int = 2, d_ff: int = 256,
                 max_len: int = 512, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, remat: str = "none"):
        super().__init__()
        if remat not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {remat!r} (one of "
                             f"{', '.join(REMAT_POLICIES)})")
        self.vocab_size = vocab_size
        self.n_layers = n_layers
        self.max_len = max_len
        self.dropout_rate = float(dropout_rate)
        self.dtype = dtype
        self.remat = remat
        self.embed = nn.Embedding(vocab_size, d_model)
        self.pos = nn.Embedding(max_len, d_model)
        for i in range(n_layers):
            self.add_module(f"block{i}", DecoderBlock(
                d_model, n_heads, d_ff, dropout_rate, dtype))
        self.ln_f = LayerNorm(d_model, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's default init: lecun-normal dense kernels and zero
        biases, normal(1/sqrt(d_model)) embeddings, LayerNorm scale 1 and
        bias 0."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.weight.shape[1], generator)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                embed_normal_(m.weight, generator)
            elif isinstance(m, LayerNorm):
                m.reset_parameters()
        return self

    def forward(self, tokens: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if tokens.dim() != 2:
            raise ValueError(f"token batch must be [B, T], got "
                             f"{tuple(tokens.shape)}")
        t = tokens.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds max_len "
                             f"{self.max_len}")
        dt = self.dtype
        ids = tokens.long()
        oov = ((ids < 0) | (ids >= self.vocab_size)).any()
        x = F.embedding(ids.clamp(0, self.vocab_size - 1),
                        self.embed.weight.to(dt))
        x = x + self.pos.weight[:t].to(dt)
        drop = train and self.dropout_rate > 0.0
        if drop:
            x = _dropout(x, _keep_mask(x, self.dropout_rate, generator),
                         self.dropout_rate)
        remat = self.remat == "block" and torch.is_grad_enabled()
        for i in range(self.n_layers):
            block = getattr(self, f"block{i}")
            masks = ((_keep_mask(x, self.dropout_rate, generator),
                      _keep_mask(x, self.dropout_rate, generator))
                     if drop else (None, None))
            if remat:
                x = _checkpointed(block, x, *masks)
            else:
                x = block(x, *masks)
        return self.head(x) + torch.where(oov, float("nan"), 0.0)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The final LayerNorm and the tied head: x [..., d] in ``dtype``
        -> float32 logits [..., vocab]."""
        return F.linear(self.ln_f(x), self.embed.weight.to(self.dtype)).float()


def _checkpointed(block: DecoderBlock, x: torch.Tensor,
                  *masks) -> torch.Tensor:
    """``block(x, *masks)``, recomputed in the backward, with the block's
    parameters (read as the forward reads them: by attribute) as inputs
    of the checkpointed call."""
    names = [name for name, _ in block.named_parameters()]
    params = [operator.attrgetter(name)(block) for name in names]

    def run(x, keep_att, keep_mlp, *params):
        return functional_call(block, dict(zip(names, params)),
                               (x, keep_att, keep_mlp))

    return checkpoint(run, x, *masks, *params, use_reentrant=False,
                      preserve_rng_state=False)


def build_lm(size: str, vocab_size: int = LM_VOCAB, dropout: float = 0.0,
             dtype: torch.dtype = torch.bfloat16, remat: str = "none",
             max_len: int = 512) -> TransformerLM:
    """Size-ladder constructor (``LM_SIZES`` keys)."""
    try:
        dims = LM_SIZES[size]
    except KeyError:
        raise ValueError(f"unknown LM size {size!r}; have "
                         f"{sorted(LM_SIZES)}") from None
    return TransformerLM(vocab_size=vocab_size, max_len=max_len,
                         dropout_rate=dropout, dtype=dtype, remat=remat,
                         **dims)
