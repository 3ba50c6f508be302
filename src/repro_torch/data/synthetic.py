"""Synthetic LM token stream, a numpy copy of
``repro.data.synthetic.make_lm_tokens`` that draws from
``np.random.RandomState`` in the same order (same seed, same tokens)."""
from __future__ import annotations

import numpy as np


def make_lm_tokens(seed: int, n_seqs: int, seq_len: int, vocab: int,
                   order: int = 2):
    """Markov token stream, learnable structure for LM training.
    -> {"tokens": (n_seqs, seq_len) int32}."""
    rng = np.random.RandomState(seed)
    # sparse transition table: each context maps to a few likely tokens
    n_ctx = 4096
    table = rng.randint(0, vocab, size=(n_ctx, 4))
    toks = rng.randint(0, vocab, size=(n_seqs, seq_len))
    ctx = rng.randint(0, n_ctx, size=n_seqs)
    for t in range(1, seq_len):
        choice = table[ctx, rng.randint(0, 4, size=n_seqs)]
        mask = rng.rand(n_seqs) < 0.8
        toks[:, t] = np.where(mask, choice, toks[:, t])
        ctx = (ctx * 31 + toks[:, t]) % n_ctx
    return {"tokens": toks.astype(np.int32)}
