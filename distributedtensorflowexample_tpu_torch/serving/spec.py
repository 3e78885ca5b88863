"""Speculative decoding on the size ladder: a small model drafts, the
served model verifies — tokens stay EXACTLY the served model's (the JAX
package's ``serving/spec.py``).

One round per step boundary: the draft engine (e.g. lm_tiny) runs k+1
sequential decode steps over the busy slots (k proposals + one
cache-maintenance step — see below), then the target engine scores the
window ``[last_token, d_1..d_k]`` in ONE batched verify step
(``engine.verify_step`` — the decode step extended one causal
diagonal, serving/engine.py).  Window query j's greedy argmax ``g_j``
is bitwise what the target's j-th sequential decode step would have
produced: plain decode IS the K == 1 verify window (one program family;
in the JAX package two programs once flipped a near-tied argmax), so the
only cross-shape assumption is that a product computes a row the same way
at K rows as at one.  That holds on the CPU; on the card cuBLAS may pick
another kernel for another row count, which can flip a near tie.
Acceptance is exact-match prefix: the longest ``a`` with ``d_i == g_{i-1}`` for
i ≤ a, and the round emits ``e = min(a+1, remaining)`` tokens
``g_0..g_{e-1}`` — the +1 is the verify step's own "free" token (on
total rejection the round still emits g_0, exactly one plain decode
step's worth, so speculation never decodes SLOWER in steps, only in
draft-side work).  Output is therefore bitwise plain greedy by
construction — the oracle tests in tests/test_torch_serving.py pin it
against solo greedy runs (including a mixed-bucket churn workload), and
``chip_smoke.py`` holds it on the card wherever the greedy top-2 logit
gap is wider than its tolerance.

Cache discipline: the verify scatter lands the window's K/V at rows
``p..p+k``, so accepted rows hold the right tokens' K/V by the accept
rule and rejected rows are junk beyond the new frontier ``p+e`` —
masked until the next write lands on each (the engine's
scatter-before-read rule).  The draft cache is reconciled the same way:
its rows ``p..p+e-1`` already hold the accepted tokens' K/V (drafted ==
accepted on the prefix) — and because a fully-accepted round has
``e == k+1``, the draft must have written row ``p+k`` too, which is
exactly why it steps k+1 times, not k (its j-th step writes row
``p+j-1``; the (k+1)-th proposal is discarded).  ``set_slot`` then
repoints both frontiers.  Slots not in the round pass position
``cache_len``: their scatters drop out of bounds and their output rows
are discarded — a parked or non-busy slot cannot be corrupted by
someone else's verify.

Sampling composes with none of this (acceptance compares GREEDY
tokens); the batcher refuses the combination by name.
"""

from __future__ import annotations

import numpy as np

from distributedtensorflowexample_tpu_torch.obs import metrics as obs_metrics
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal

_SPEC_ROUNDS = obs_metrics.counter(
    "serve_spec_rounds_total", "speculative draft+verify rounds")
_SPEC_EMITTED = obs_metrics.counter(
    "serve_spec_emitted_tokens_total", "tokens emitted by verify rounds")
_SPEC_ACCEPTED = obs_metrics.counter(
    "serve_spec_accepted_draft_total", "draft tokens accepted by verify")
_SPEC_DRAFTED = obs_metrics.counter(
    "serve_spec_drafted_tokens_total", "draft tokens proposed")
_SPEC_ACCEPT_LEN = obs_metrics.gauge(
    "serve_spec_accept_len", "rolling mean tokens emitted per slot-round")


class SpecDecoder:
    """Drafts on ``draft_engine``, verifies on ``engine``; the
    ContinuousBatcher drives one :meth:`round` per step boundary in
    place of one decode step.  Both engines must agree on geometry
    (slots, cache rows, vocabulary) — the accept rule compares token
    ids and the caches advance in lockstep."""

    def __init__(self, engine, draft_engine, *, k: int = 4):
        if k < 1:
            raise ValueError(f"draft window k {k} must be >= 1")
        if not hasattr(engine, "verify_step"):
            raise ModeRefusal(
                "--spec_draft needs the target engine's batched-verify "
                "seam, which the params-stay-sharded engine "
                "(--sharded_mesh) does not expose — speculative "
                "decoding composes with the replicated path only")
        if draft_engine.vocab != engine.vocab:
            raise ModeRefusal(
                f"draft model vocab {draft_engine.vocab} != target "
                f"vocab {engine.vocab} — acceptance compares token ids, "
                f"so the ladder sizes must share a vocabulary")
        if draft_engine.slots != engine.slots \
                or draft_engine.cache_len != engine.cache_len:
            raise ValueError(
                f"draft geometry (slots {draft_engine.slots}, cache "
                f"{draft_engine.cache_len}) must match the target's "
                f"(slots {engine.slots}, cache {engine.cache_len}) — "
                f"the caches advance in lockstep")
        self.engine = engine
        self.draft = draft_engine
        self.k = int(k)
        self.rounds = 0
        self.emitted = 0
        self.accepted_draft = 0
        self.drafted = 0
        self._accept_tape: list = []

    # --- lifecycle hooks (the batcher calls these) -------------------------
    def on_admit(self, slot: int, prompt, max_new: int) -> None:
        """Prefill the DRAFT cache for an admitted request (the target
        prefill already happened on the admission path)."""
        self.draft.prefill(slot, prompt, max_new)

    def park(self, slot: int) -> None:
        """Mirror the batcher's slot parking onto the draft engine."""
        self.draft.set_slot(slot, 0, 0)

    # --- the round ---------------------------------------------------------
    def round(self, busy: list, remaining: dict) -> dict:
        """One draft+verify round over ``busy`` slots (``remaining[s]``
        = tokens request s still needs, >= 1).  Returns {slot: [emitted
        tokens]} — between 1 and min(k+1, remaining) per slot, bitwise
        the target's plain-greedy tokens."""
        eng, draft, k = self.engine, self.draft, self.k
        S = eng.slots
        # k+1 draft steps for k proposals: a full-acceptance round emits
        # e == k+1 tokens and repoints the draft frontier to p+k+1, so
        # the draft cache must hold K/V through row p+k — which only its
        # (k+1)-th step writes (step j writes row p+j-1).  Without it,
        # every fully-accepted round left ONE junk row below the new
        # frontier and self-draft acceptance collapsed within a few
        # rounds (the d_{k+1} proposal itself is discarded).
        drafts = np.zeros((k + 1, S), np.int32)
        for j in range(k + 1):
            drafts[j] = draft.decode(busy=busy)
        toks = np.zeros((S, k + 1), np.int32)
        pos = np.full((S,), eng.cache_len, np.int32)
        for s in busy:
            toks[s, 0] = eng.last_tokens[s]
            toks[s, 1:] = drafts[:k, s]
            pos[s] = eng.positions[s]
        g, _ = eng.verify_step(toks, pos)
        out: dict = {}
        for s in busy:
            d, gs = drafts[:, s], g[s]
            a = 0
            while a < k and d[a] == gs[a]:
                a += 1
            e = min(a + 1, int(remaining[s]))
            emitted = [int(t) for t in gs[:e]]
            p = int(eng.positions[s])
            eng.set_slot(s, emitted[-1], p + e)
            draft.set_slot(s, emitted[-1], p + e)
            out[s] = emitted
            self.emitted += e
            self.accepted_draft += min(a, e)
            self._accept_tape.append(e)
        self.rounds += 1
        self.drafted += k * len(busy)
        _SPEC_ROUNDS.inc()
        _SPEC_DRAFTED.inc(k * len(busy))
        _SPEC_EMITTED.inc(sum(len(v) for v in out.values()))
        _SPEC_ACCEPTED.inc(sum(min(len(v) - 1, k) for v in out.values()))
        tape = self._accept_tape[-256:]
        _SPEC_ACCEPT_LEN.set(round(sum(tape) / len(tape), 4))
        return out

    def stats(self) -> dict:
        tape = self._accept_tape
        return {
            "k": self.k,
            "rounds": self.rounds,
            "emitted": self.emitted,
            "drafted": self.drafted,
            "accepted_draft": self.accepted_draft,
            "accept_len_mean": (round(sum(tape) / len(tape), 4)
                                if tape else None),
        }
