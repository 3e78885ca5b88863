"""The decode engine: prefill and a one-token decode step over a
preallocated per-slot KV cache written in place (the JAX package's
``serving/engine.py``).

Training computes every position of every sequence each step; serving
generates one token per live request per step, so the work that matters
is (a) the prompt's one-time *prefill* (full causal attention, the
training forward) and (b) the steady *decode* step: one query per slot
against the K/V rows every earlier position already produced.  The rows
stay resident in two ``[L, S, T, H, Dh]`` caches, one slot per request
being decoded, allocated ONCE; every step writes its new rows into them
in place.  The JAX step donates its caches (XLA aliases the updated
cache onto the input buffers); here the buffers are simply never
reallocated, and :data:`DECODE_CONTRACT` states that claim, checked by
:func:`check_decode_contract` on a live engine.

Numerics: :class:`ServingLM` runs the training ``TransformerLM``'s own
submodules (its weights are bound, not copied) through the same methods
the training forward calls (``DecoderBlock.qkv_heads``, ``attend``,
``mlp``, ``TransformerLM.head``): flax's LayerNorm and tanh GELU, the
scale rounded to ``dtype``, the ``dtype(-1e9)`` mask, the float32
softmax and the tied float32 head.  Not ``scaled_dot_product_attention``,
which rounds elsewhere.  A query attends over masked cache rows whose
scores underflow to exactly 0.0 after the float32 exp, so greedy decoding
through the cache picks the tokens teacher-forced greedy through the
training forward picks (pinned in ``tests/test_torch_serving.py``).

Decode IS :meth:`ServingLM.verify` at K == 1, as in the JAX package: two
token-step programs could flip a near-tied argmax between them, and
speculative decoding's greedy oracle needs one program family.

Every slot's math is independent of the others' (the products batch over
slots, LayerNorm is per row), and a product of fixed shape computes each
row the same way whatever the other rows hold.  The decode step has one
shape ([S, 1]), and a prefill is padded to ``slots`` rows, so it has one
shape per bucket: a request's tokens do not depend on what shares its
step or its prefill, on the card as on the CPU.

Out-of-bounds rows: a slot parked at ``pos == T`` (a slot left out of a
verify) and a window padded past the cache's end write rows ``>= T``.
JAX's scatter drops them; ``index_copy_`` would raise.  Each cache is a
view of a buffer with one spare row per layer (the sink) that takes those
writes and is never read.  Positions past the positional table are
clamped to its last row, as JAX's gather clamps them; those outputs are
discarded by the callers.

Host traffic: each decode step uploads the slots' tokens and positions
(one pinned, non-blocking copy) and brings back one [S] int32 array, the
only synchronization of the step.  Every call runs under
``torch.inference_mode``.  Out-of-vocabulary requests never reach the
device: admission refuses them by name (``serving/queue.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from distributedtensorflowexample_tpu_torch.models.transformer_lm import (
    TransformerLM)
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal

#: What a decode step may and may not do to the device, checked by
#: :func:`check_decode_contract` (the port's form of the JAX package's
#: ``DECODE_HLO_CONTRACT``, which pins donation in the compiled HLO):
#: the caches' storage does not move across steps; on the card
#: ``torch.cuda.memory_allocated`` is the same before and after N steps
#: (steady decode allocates nothing that outlives a step); no tensor
#: wider than float32 appears; no collective runs (decode is one-device).
DECODE_CONTRACT = {
    "mode": "serve_decode",
    "cache_storage_fixed": True,
    "allocated_bytes_flat": True,
    "dtype_ceiling": torch.float32,
    "collective_budget": 0,
}

#: Default decode-slot count (SERVE_SLOTS overrides).
DEFAULT_SLOTS = 4

_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def serve_slots_default() -> int:
    """``SERVE_SLOTS``: default concurrent decode slots for
    ``serving/serve_lm.py`` (CLI flags override)."""
    try:
        return max(1, int(os.environ.get("SERVE_SLOTS", "")))
    except ValueError:
        return DEFAULT_SLOTS


class KVCache:
    """The two caches, ``k`` and ``v``, each ``[L, S, T, H, Dh]`` in the
    model's dtype, allocated once.  Each is a view of a buffer with one
    more row per layer, the sink, where a write past a slot's end lands
    (JAX drops it); the sink is never read."""

    def __init__(self, layers: int, slots: int, rows: int, heads: int,
                 head_dim: int, dtype: torch.dtype, device: torch.device):
        self.shape = (layers, slots, rows, heads, head_dim)
        store = (layers, slots * rows + 1, heads, head_dim)
        self.k_store = torch.zeros(store, dtype=dtype, device=device)
        self.v_store = torch.zeros(store, dtype=dtype, device=device)
        self.k = self.k_store[:, :slots * rows].view(self.shape)
        self.v = self.v_store[:, :slots * rows].view(self.shape)
        self.nbytes = 2 * int(np.prod(self.shape)) * self.k.element_size()

    def flat_index(self, rows: torch.Tensor) -> torch.Tensor:
        """rows [S, K] (slot s writes rows[s]) -> the buffer's row index
        of each, the sink for rows at or past the cache's end."""
        slots, length = self.shape[1], self.shape[2]
        base = torch.arange(slots, device=rows.device)[:, None] * length
        return torch.where(rows < length, base + rows,
                           slots * length).reshape(-1)

    def write(self, layer: int, index: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> None:
        """Write k, v [S, K, H, Dh] at :meth:`flat_index`'s rows."""
        self.k_store[layer].index_copy_(0, index, k.flatten(0, 1))
        self.v_store[layer].index_copy_(0, index, v.flatten(0, 1))

    def storage_ptrs(self) -> tuple:
        return self.k_store.data_ptr(), self.v_store.data_ptr()


class ServingLM:
    """The decode side of a training ``TransformerLM``: ``prefill``,
    ``verify`` and ``decode`` (= ``verify`` at K == 1) over the model's
    own blocks.  The model's ``max_len`` is its positional table's row
    count; the cache length is the engine's separate ``cache_len``."""

    def __init__(self, model: TransformerLM):
        self.model = model
        self.blocks = [getattr(model, f"block{i}")
                       for i in range(model.n_layers)]

    def _embed(self, tokens: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        m, dt = self.model, self.model.dtype
        positions = positions.clamp(max=m.max_len - 1)
        return (F.embedding(tokens, m.embed.weight.to(dt))
                + F.embedding(positions, m.pos.weight.to(dt)))

    def prefill(self, tokens: torch.Tensor) -> tuple:
        """tokens [B, P] -> (logits [B, P, V] float32,
        k [L, B, P, H, Dh], v [L, B, P, H, Dh])."""
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = self._embed(tokens, pos)
        causal = pos[:, None] >= pos[None, :]
        ks, vs = [], []
        for blk in self.blocks:
            q, k, v = blk.qkv_heads(x)
            x = blk.mlp(x + blk.attend(q, k, v, causal))
            ks.append(k)
            vs.append(v)
        return self.model.head(x), torch.stack(ks), torch.stack(vs)

    def verify(self, toks: torch.Tensor, positions: torch.Tensor,
               cache: KVCache) -> torch.Tensor:
        """A K-token window per slot: toks [S, K] starting at row
        positions [S] -> logits [S, K, V] float32.  Each layer writes the
        window's K/V into the cache at rows ``pos..pos+K-1`` before it
        reads; window query j attends rows ``<= pos+j``.  A slot at
        ``pos == T`` writes only the sink, and its outputs are garbage
        by construction (callers discard them)."""
        rows = positions[:, None] + torch.arange(toks.shape[1],
                                                 device=toks.device)
        x = self._embed(toks, rows)
        index = cache.flat_index(rows)
        t = torch.arange(cache.shape[2], device=toks.device)
        live = (t[None, None, :] <= rows[:, :, None])[:, None]
        for i, blk in enumerate(self.blocks):
            q, k, v = blk.qkv_heads(x)
            cache.write(i, index, k, v)
            x = blk.mlp(x + blk.attend(q, cache.k[i], cache.v[i], live))
        return self.model.head(x)

    def decode(self, tok: torch.Tensor, positions: torch.Tensor,
               cache: KVCache) -> torch.Tensor:
        """tok [S], positions [S] -> logits [S, V]: the K == 1 window of
        :meth:`verify`, not a separate program."""
        return self.verify(tok[:, None], positions, cache)[:, 0]


def serving_lm_for(model: TransformerLM) -> ServingLM:
    """The serving twin of a training model, over its own submodules."""
    return ServingLM(model)


def _prefill_buckets(cache_len: int, smallest: int = 8) -> tuple:
    """Padding buckets for prefill: powers of two from ``smallest`` up
    to ``cache_len`` (inclusive as the final bucket).  A prompt pads to
    the smallest bucket that fits, so prefill has log(N) shapes, not N."""
    out = []
    b = smallest
    while b < cache_len:
        out.append(b)
        b *= 2
    out.append(cache_len)
    return tuple(out)


class DecodeEngine:
    """Slots, caches and the steps (bucketed prefill, decode, verify).
    Host bookkeeping (which slot is live, each request's tokens) belongs
    to the ContinuousBatcher; this class owns the device state and
    refuses geometry it cannot serve.  The model's parameters are read
    where they are: the engine runs on their device."""

    def __init__(self, model: TransformerLM, *, slots: int = DEFAULT_SLOTS,
                 cache_len: int = 128, prefill_smallest: int = 8):
        if cache_len > model.max_len:
            raise ModeRefusal(
                f"--max_len {cache_len} exceeds the model's positional "
                f"table ({model.max_len} rows) — the snapshot was "
                f"trained with max_len {model.max_len}; a longer cache "
                f"would index past the table, not extrapolate it")
        if slots < 1:
            raise ValueError(f"slots {slots} must be >= 1")
        self.model = model
        self.smodel = serving_lm_for(model)
        self.device = model.embed.weight.device
        self.slots = int(slots)
        self.cache_len = int(cache_len)
        self.vocab = int(model.vocab_size)
        self.buckets = _prefill_buckets(self.cache_len, prefill_smallest)
        blk = self.smodel.blocks[0]
        heads = blk.n_heads
        head_dim = blk.qkv.in_features // heads
        with torch.inference_mode():
            self.cache = KVCache(model.n_layers, self.slots, self.cache_len,
                                 heads, head_dim, model.dtype, self.device)
        self.cache_bytes = self.cache.nbytes
        # Host-owned scalars per slot, uploaded per call (tiny).
        self.positions = np.zeros((self.slots,), np.int32)
        self.last_tokens = np.zeros((self.slots,), np.int32)
        self.decode_steps = 0
        self.prefills = 0
        # Buckets that have run once: the first call of a shape pays the
        # card's lazy kernel loading, which an admission predictor timing
        # prefill must not learn from.
        self._warm_buckets: set = set()
        self.last_prefill_was_cold = False

    # --- host <-> device --------------------------------------------------
    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """An int64 host array on the engine's device: on the card one
        pinned copy that does not wait for the device."""
        t = torch.from_numpy(np.ascontiguousarray(a, np.int64))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # --- the steps --------------------------------------------------------
    def bucket_for(self, prompt_len: int, max_new: int) -> int:
        """Smallest padding bucket holding ``prompt_len``, refusing
        work that cannot finish inside the cache."""
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if prompt_len + max_new > self.cache_len:
            raise ModeRefusal(
                f"prompt ({prompt_len} tokens) + --max_new ({max_new}) "
                f"exceeds the engine's --max_len cache ({self.cache_len} "
                f"rows/slot) — the request can never finish; raise "
                f"--max_len or shorten the request")
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise AssertionError("bucket table misses cache_len")  # unreachable

    def prefill(self, slot: int, prompt: np.ndarray,
                max_new: int = 1) -> int:
        """Fill ``slot``'s cache rows from the prompt and return the
        first generated token.  Pads to the chosen bucket with token 0 —
        pad rows land in the cache beyond the slot's frontier, where the
        decode mask excludes them until a real token overwrites each."""
        (tok, _), = self.prefill_many([(slot, prompt, max_new)]).values()
        return tok

    @torch.inference_mode()
    def prefill_many(self, assignments: list) -> dict:
        """Batched prefill: ``assignments`` is [(slot, prompt, max_new),
        ...]; prompts sharing a padding bucket share ONE forward, padded
        to ``slots`` rows.  Returns {slot: (first_token, last_logits)} —
        the float32 logits at each prompt's last position, for callers
        that sample the first token.  ``last_prefill_was_cold`` reports
        whether any bucket ran for the first time."""
        groups: dict = {}
        for slot, prompt, max_new in assignments:
            prompt = np.asarray(prompt, np.int32).ravel()
            bucket = self.bucket_for(len(prompt), max_new)
            groups.setdefault(bucket, []).append((slot, prompt))
        out: dict = {}
        cold = False
        for bucket, group in sorted(groups.items()):
            n = len(group)
            cold |= bucket not in self._warm_buckets
            self._warm_buckets.add(bucket)
            # [slots, bucket + 2]: tokens, then each row's slot and length.
            host = np.zeros((self.slots, bucket + 2), np.int64)
            for i, (slot, prompt) in enumerate(group):
                host[i, :len(prompt)] = prompt
                host[i, bucket:] = slot, len(prompt)
            dev = self._upload(host)
            logits, k, v = self.smodel.prefill(dev[:, :bucket])
            slots_ix = dev[:n, bucket]
            self.cache.k[:, slots_ix, :bucket] = k[:, :n]
            self.cache.v[:, slots_ix, :bucket] = v[:, :n]
            last = logits[torch.arange(n, device=self.device),
                          dev[:n, bucket + 1] - 1]
            last = last.cpu().numpy()            # the group's one sync
            toks = np.argmax(last, axis=-1)      # first maximum, as torch
            for i, (slot, prompt) in enumerate(group):
                self.positions[slot] = len(prompt)
                self.last_tokens[slot] = int(toks[i])
                out[slot] = (int(toks[i]), last[i])
            self.prefills += n
        self.last_prefill_was_cold = cold
        return out

    def _advance(self, busy) -> np.ndarray:
        advance = np.zeros(self.slots, bool)
        advance[list(range(self.slots)) if busy is None else list(busy)] = True
        self.positions = self.positions + advance.astype(np.int32)
        self.decode_steps += 1
        return advance

    @torch.inference_mode()
    def decode(self, busy=None) -> np.ndarray:
        """One decode step over ALL slots (idle slots compute too — the
        step has one static shape; their outputs are ignored and their
        stale rows are overwritten the next time the slot is live).
        Returns the next token per slot and advances the BUSY slots'
        frontiers (``busy=None`` advances all): an idle slot's parked
        frontier must not drift toward the cache's end."""
        io = self._upload(np.stack([self.last_tokens, self.positions]))
        logits = self.smodel.decode(io[0], io[1], self.cache)
        out = logits.argmax(-1).to(torch.int32).cpu().numpy()  # the sync
        advance = self._advance(busy)
        self.last_tokens = np.where(advance, out, self.last_tokens) \
            .astype(np.int32)
        return out

    @torch.inference_mode()
    def decode_logits(self, busy=None) -> np.ndarray:
        """One decode step returning the float32 logits [S, V] instead of
        the argmax — the sampling path.  Advances the busy slots'
        frontiers like :meth:`decode`, but the caller OWNS each busy
        slot's next token: it must ``set_slot(slot, token,
        positions[slot])`` before the next step."""
        io = self._upload(np.stack([self.last_tokens, self.positions]))
        out = self.smodel.decode(io[0], io[1], self.cache).cpu().numpy()
        self._advance(busy)
        return out

    @torch.inference_mode()
    def verify_step(self, toks, positions) -> tuple:
        """One batched K-token verify over all slots: toks [S, K],
        positions [S] (a slot not participating passes position ==
        cache_len: its writes go to the sink and its output rows are
        garbage to discard).  Returns (greedy [S, K] int32, logits
        [S, K, V] float32).  Advances NOTHING — the caller owns
        accept/rollback bookkeeping via :meth:`set_slot`."""
        toks = np.asarray(toks, np.int64)
        io = self._upload(np.concatenate(
            [toks, np.asarray(positions, np.int64)[:, None]], axis=1))
        logits = self.smodel.verify(io[:, :-1], io[:, -1], self.cache)
        logits = logits.cpu().numpy()
        self.decode_steps += 1
        return np.argmax(logits, axis=-1).astype(np.int32), logits

    def extend(self, slot: int, tokens, start: int) -> tuple:
        """Append already-known ``tokens`` to ``slot``'s cache at rows
        ``start..`` (the prefix-cache suffix path) via the verify
        window, padded to a power of two.  Returns (next_token,
        last_logits) at the final appended position."""
        tokens = np.asarray(tokens, np.int32).ravel()
        n = len(tokens)
        if n < 1:
            raise ValueError("empty extension")
        K = 1
        while K < n:
            K *= 2
        toks = np.zeros((self.slots, K), np.int32)
        pos = np.full((self.slots,), self.cache_len, np.int32)
        toks[slot, :n] = tokens
        pos[slot] = int(start)
        g, logits = self.verify_step(toks, pos)
        return int(g[slot, n - 1]), logits[slot, n - 1]

    @torch.inference_mode()
    def read_rows(self, slot: int, width: int) -> tuple:
        """Copies of ``slot``'s first ``width`` K/V rows, [L, width, H,
        Dh] each (the prefix-cache registration read)."""
        return (self.cache.k[:, slot, :width].clone(),
                self.cache.v[:, slot, :width].clone())

    @torch.inference_mode()
    def write_rows(self, slot: int, k_rows, v_rows) -> None:
        """Import stored K/V rows into ``slot`` (the prefix-cache hit
        write); the caller then ``set_slot``s the real prefix length."""
        width = k_rows.shape[1]
        self.cache.k[:, slot, :width].copy_(k_rows)
        self.cache.v[:, slot, :width].copy_(v_rows)

    def set_slot(self, slot: int, last_token: int, position: int) -> None:
        """Host bookkeeping hook (the batcher parks retired slots at
        position 0 so their frontier never walks off the cache end)."""
        self.last_tokens[slot] = int(last_token)
        self.positions[slot] = int(position)


class _OpAudit(TorchDispatchMode):
    """Records the ops that produced a tensor wider than ``ceiling``,
    and the collectives, of everything run under it."""

    def __init__(self, ceiling: torch.dtype):
        super().__init__()
        self.bits = ceiling.itemsize * 8
        self.wide: set = set()
        self.collectives: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace in _COLLECTIVE_NAMESPACES:
            self.collectives.append(str(func))
        if any(isinstance(t, torch.Tensor) and t.dtype.is_floating_point
               and t.dtype.itemsize * 8 > self.bits
               for t in tree_leaves(out)):
            self.wide.add(str(func))
        return out


def check_decode_contract(engine: DecodeEngine, steps: int = 100,
                          step=None,
                          contract: dict = DECODE_CONTRACT) -> list[str]:
    """Run ``steps`` decode steps (``step``, default ``engine.decode``)
    and return what broke ``contract`` (empty: it holds).  The first step
    is the warm-up: the card's libraries may allocate lasting workspaces
    at their first call, so the allocated bytes are read after it and
    after the last step (on the card only: the CPU has no such count).
    The steps overwrite cache rows: run it on an engine with no live
    request (positions and last tokens are put back)."""
    if steps < 2:
        raise ValueError(f"steps {steps} must be >= 2")
    step = step or engine.decode
    count_bytes = contract["allocated_bytes_flat"] \
        and engine.device.type == "cuda"
    saved = engine.positions.copy(), engine.last_tokens.copy()
    ptrs = engine.cache.storage_ptrs()
    audit = _OpAudit(contract["dtype_ceiling"])
    try:
        with audit:
            step()
            if count_bytes:
                torch.cuda.synchronize(engine.device)
                before = torch.cuda.memory_allocated(engine.device)
            for _ in range(steps - 1):
                step()
            if count_bytes:
                torch.cuda.synchronize(engine.device)
                after = torch.cuda.memory_allocated(engine.device)
    finally:
        engine.positions, engine.last_tokens = saved
    findings = []
    if contract["cache_storage_fixed"] \
            and engine.cache.storage_ptrs() != ptrs:
        findings.append(f"cache storage moved over {steps} decode steps "
                        f"(data pointers {ptrs} -> "
                        f"{engine.cache.storage_ptrs()}): the step "
                        f"reallocates its cache")
    if count_bytes and after != before:
        findings.append(f"torch.cuda.memory_allocated went {before} -> "
                        f"{after} bytes over {steps - 1} decode steps")
    if audit.wide:
        findings.append(f"tensors wider than {contract['dtype_ceiling']} "
                        f"from {sorted(audit.wide)}")
    if len(audit.collectives) > contract["collective_budget"]:
        findings.append(f"{len(audit.collectives)} collective(s) in "
                        f"{steps} decode steps, budget "
                        f"{contract['collective_budget']}: "
                        f"{sorted(set(audit.collectives))}")
    return findings
