"""Token data for the transformer LM (the JAX package's ``data/lm.py``).

The ``lm`` dataset is a seeded order-1 Markov chain over ``LM_VOCAB``
tokens: from token ``t`` the next is ``perm[t]`` with probability
``LM_FOLLOW``, else uniform.  The numpy draws are the JAX package's, in
the same order, so both packages load bitwise the same splits.  Inputs
are uint8 (the vocabulary is < 256), targets int32.
"""

from __future__ import annotations

import numpy as np

from distributedtensorflowexample_tpu_torch.models.transformer_lm import (
    LM_VOCAB)

#: Sequence length of the shipped splits: inputs and targets are
#: [N, LM_SEQ_LEN], cut from sequences one token longer.
LM_SEQ_LEN = 128
#: The share of transitions that follow ``perm[t]``.
LM_FOLLOW = 0.85
_SYNTH_SIZES = {"train": 2048, "test": 512}


def make_synthetic_tokens(num: int, seq_len: int, vocab: int, seed: int,
                          sample_seed: int | None = None,
                          follow: float = LM_FOLLOW) -> np.ndarray:
    """[num, seq_len + 1] int32 sequences.  ``seed`` fixes the transition
    structure; splits that share it differ in ``sample_seed``."""
    rng = np.random.RandomState(seed)
    pref = rng.permutation(vocab).astype(np.int32)
    srng = np.random.RandomState(seed if sample_seed is None else sample_seed)
    seq = np.empty((num, seq_len + 1), np.int32)
    seq[:, 0] = srng.randint(0, vocab, size=num)
    for t in range(1, seq_len + 1):
        follows = srng.rand(num) < follow
        rand_tok = srng.randint(0, vocab, size=num).astype(np.int32)
        seq[:, t] = np.where(follows, pref[seq[:, t - 1]], rand_tok)
    return seq


def load_lm(data_dir: str, split: str, seed: int = 0,
            source: str = "real", num: int | None = None,
            seq_len: int = LM_SEQ_LEN,
            vocab: int = LM_VOCAB) -> tuple[np.ndarray, np.ndarray]:
    """(inputs uint8 [N, seq_len], targets int32 [N, seq_len]); int32
    inputs when ``vocab`` > 256.  Every ``source`` is the synthetic
    chain (there is no real corpus format); ``data_dir`` is accepted for
    the image loaders' signature and ignored."""
    del data_dir
    if source not in ("real", "synthetic", "fallback"):
        raise ValueError(f"unknown source {source!r}")
    if num is None:
        try:
            num = _SYNTH_SIZES[split]
        except KeyError:
            raise ValueError(f"unknown split {split!r} (one of "
                             f"{sorted(_SYNTH_SIZES)})") from None
    sample_seed = seed + {"train": 1, "test": 2}.get(split, 3)
    seq = make_synthetic_tokens(num, seq_len, vocab, seed,
                                sample_seed=sample_seed)
    if vocab > 256:
        return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)
    return (np.ascontiguousarray(seq[:, :-1]).astype(np.uint8),
            np.ascontiguousarray(seq[:, 1:]).astype(np.int32))
