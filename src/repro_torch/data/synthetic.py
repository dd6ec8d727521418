"""Deterministic synthetic data (``src/repro/data/synthetic.py``).

``synthetic_tokens`` (the seeded prompt source of
``serve.requests.poisson_requests`` and the training batches),
``synthetic_oscar_text`` (the documents of the tokenizer -> indexed
dataset -> loader path) and ``synthetic_images`` (the ``resnet50``
workload's batch) are ported: the same numpy draws as the reference, so
both packages build identical request lists, token batches, documents
and images from one seed.
"""
from __future__ import annotations

import numpy as np

_WORDS = (
    "the of and to in is was for on that with as by at from benchmark "
    "accelerator energy power throughput token image training model "
    "hardware system performance measurement efficiency cluster node "
    "gpu ipu tpu memory bandwidth compute parallel data tensor pipeline"
).split()


def synthetic_tokens(n_seqs: int, seq_len: int, vocab: int,
                     seed: int = 0) -> np.ndarray:
    """Zipf-ish token stream — more realistic rank-frequency than uniform."""
    rng = np.random.default_rng(seed)
    z = rng.zipf(1.3, size=(n_seqs, seq_len + 1)).astype(np.int64)
    return (z % vocab).astype(np.int32)


def synthetic_oscar_text(n_docs: int, seed: int = 0,
                         words_per_doc: int = 200) -> list[str]:
    """OSCAR-like text documents for the tokenizer -> indexed-dataset path."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        n = int(rng.integers(words_per_doc // 2, words_per_doc * 2))
        idx = rng.zipf(1.4, size=n) % len(_WORDS)
        docs.append(" ".join(_WORDS[i] for i in idx))
    return docs


def synthetic_images(n: int, img_size: int, n_classes: int,
                     seed: int = 0):
    """(images NHWC float32 in [0,1), labels int32)."""
    rng = np.random.default_rng(seed)
    imgs = rng.random((n, img_size, img_size, 3), dtype=np.float32)
    labels = rng.integers(0, n_classes, size=(n,), dtype=np.int32)
    return imgs, labels
