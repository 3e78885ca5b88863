"""Temperature / top-k sampling with per-request RNG lanes (a copy of the
JAX package's ``serving/sampling.py``: numpy only).

Sampling runs on the HOST from the decode step's f32 logits
(``engine.decode_logits`` — the greedy decode step, which brings back
only its argmax, is untouched).  Each request gets its own
counter-based RNG lane keyed ``(worker seed, request id, token
index)``: the same rid replayed against the same snapshot and knobs
produces the SAME tokens regardless of slot placement, admission
order, or what the other slots are doing — the serving analog of the
trainers' seeded-determinism rule, and what makes a retried request's
output reproducible across placements.

Greedy stays the default; a sampler is opt-in per worker
(``--sample_temp``/``--sample_top_k``/``--sample_seed``).  It composes
with batched prefill and the prefix cache (both hand back the last
position's logits, so even the FIRST token is sampled), but not with
speculative decoding — acceptance there compares bitwise-greedy
tokens, and the batcher refuses the combination by name.
"""

from __future__ import annotations

import zlib

import numpy as np

from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal


class Sampler:
    """Stateless per-call sampling: every token draw reseeds its lane
    from ``(seed, rid, index)``, so there is no host RNG state to
    snapshot or to race — determinism is structural, not disciplined."""

    def __init__(self, *, temperature: float = 1.0, top_k: int = 0,
                 seed: int = 0):
        if not temperature > 0:
            raise ModeRefusal(
                f"--sample_temp {temperature} must be > 0 (temperature "
                f"0 is greedy — run without a sampler for that)")
        if top_k < 0:
            raise ModeRefusal(f"--sample_top_k {top_k} must be >= 0 "
                              f"(0 = full vocabulary)")
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)

    def describe(self) -> dict:
        return {"temperature": self.temperature, "top_k": self.top_k,
                "seed": self.seed}

    def sample(self, rid: str, index: int, logits) -> int:
        """Draw token ``index`` of request ``rid`` from f32 ``logits``
        [V] (the decode step's own, so the distribution is exactly the
        model's — the host just rolls the dice)."""
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed & 0xFFFFFFFF,
             zlib.crc32(str(rid).encode()),
             int(index)]))
        scores = np.asarray(logits, np.float64) / self.temperature
        if self.top_k and self.top_k < scores.size:
            kth = np.partition(scores, -self.top_k)[-self.top_k]
            scores = np.where(scores >= kth, scores, -np.inf)
        scores = scores - scores.max()
        probs = np.exp(scores)
        probs /= probs.sum()
        return int(rng.choice(scores.size, p=probs))
