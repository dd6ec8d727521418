"""Deterministic synthetic tokens (``src/repro/data/synthetic.py``).

Only ``synthetic_tokens`` is ported: the seeded prompt source of
``serve.requests.poisson_requests``. Same numpy draws as the reference,
so both packages build identical request lists from one seed.
"""
from __future__ import annotations

import numpy as np


def synthetic_tokens(n_seqs: int, seq_len: int, vocab: int,
                     seed: int = 0) -> np.ndarray:
    """Zipf-ish token stream — more realistic rank-frequency than uniform."""
    rng = np.random.default_rng(seed)
    z = rng.zipf(1.3, size=(n_seqs, seq_len + 1)).astype(np.int64)
    return (z % vocab).astype(np.int32)
