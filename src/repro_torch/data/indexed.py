"""Megatron-style indexed dataset: .bin token stream + .idx offsets.

Copy of ``src/repro/data/indexed.py``: the files (``.bin``, ``.idx``
with magic ``REPRIDX1``, optional ``.json`` meta) are byte for byte the
reference's, so a dataset written by either package reads back equal in
the other.

The paper's LLM benchmark consumes OSCAR preprocessed into exactly this
format. Writer appends documents; reader memory-maps and serves fixed-length
training samples (with cross-document packing, as Megatron does).
"""
from __future__ import annotations

import json
import pathlib
import struct

import numpy as np

MAGIC = b"REPRIDX1"


class IndexedDatasetWriter:
    def __init__(self, prefix):
        self.prefix = pathlib.Path(prefix)
        self.prefix.parent.mkdir(parents=True, exist_ok=True)
        self._bin = open(self.prefix.with_suffix(".bin"), "wb")
        self._offsets = [0]
        self._n_tokens = 0

    def add_document(self, tokens):
        arr = np.asarray(tokens, dtype=np.int32)
        self._bin.write(arr.tobytes())
        self._n_tokens += arr.size
        self._offsets.append(self._n_tokens)

    def finalize(self, meta: dict | None = None):
        self._bin.close()
        off = np.asarray(self._offsets, dtype=np.int64)
        with open(self.prefix.with_suffix(".idx"), "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<q", len(off)))
            f.write(off.tobytes())
        if meta is not None:
            self.prefix.with_suffix(".json").write_text(json.dumps(meta))


class IndexedDatasetReader:
    def __init__(self, prefix):
        self.prefix = pathlib.Path(prefix)
        with open(self.prefix.with_suffix(".idx"), "rb") as f:
            assert f.read(8) == MAGIC, "bad index magic"
            (n,) = struct.unpack("<q", f.read(8))
            self.offsets = np.frombuffer(f.read(8 * n), dtype=np.int64)
        self.tokens = np.memmap(self.prefix.with_suffix(".bin"),
                                dtype=np.int32, mode="r")
        mp = self.prefix.with_suffix(".json")
        self.meta = json.loads(mp.read_text()) if mp.exists() else {}

    @property
    def n_documents(self) -> int:
        return len(self.offsets) - 1

    @property
    def n_tokens(self) -> int:
        return int(self.offsets[-1])

    def document(self, i: int) -> np.ndarray:
        return np.asarray(self.tokens[self.offsets[i]:self.offsets[i + 1]])

    def sample(self, idx: int, seq_len: int) -> np.ndarray:
        """Packed fixed-length sample idx (wraps around the stream)."""
        start = (idx * seq_len) % max(self.n_tokens - seq_len - 1, 1)
        return np.asarray(self.tokens[start:start + seq_len + 1])
