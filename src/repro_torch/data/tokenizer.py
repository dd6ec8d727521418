"""Byte-fallback word tokenizer with a GPT-2-like interface.

Copy of ``src/repro/data/tokenizer.py``: the same vocabulary from the
same documents, the same ids, and the same JSON file, which either
package's ``load`` reads.

The paper preprocesses OSCAR with the GPT-2 BPE tokenizer; offline we
provide a deterministic tokenizer with the same API surface (encode /
decode / vocab_size) built from a learned word vocabulary + byte fallback,
so the data pipeline (tokenize -> indexed dataset -> loader) is exercised
end to end.
"""
from __future__ import annotations

import collections
import json
import pathlib
from typing import Iterable

BYTE_OFFSET = 3  # 0=pad, 1=bos, 2=eos; bytes occupy [3, 259)
FIRST_WORD_ID = 259


class ByteFallbackTokenizer:
    def __init__(self, vocab: dict[str, int] | None = None,
                 max_vocab: int = 50257):
        self.word_to_id = vocab or {}
        self.id_to_word = {i: w for w, i in self.word_to_id.items()}
        self.max_vocab = max_vocab

    # -- training ----------------------------------------------------------
    @classmethod
    def train(cls, docs: Iterable[str], max_vocab: int = 50257
              ) -> "ByteFallbackTokenizer":
        counts = collections.Counter()
        for d in docs:
            counts.update(d.split())
        n_words = max_vocab - FIRST_WORD_ID
        vocab = {w: FIRST_WORD_ID + i
                 for i, (w, _) in enumerate(counts.most_common(n_words))}
        return cls(vocab, max_vocab)

    # -- core API ------------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return self.max_vocab

    @property
    def bos(self) -> int:
        return 1

    @property
    def eos(self) -> int:
        return 2

    def encode(self, text: str, add_special: bool = True) -> list[int]:
        ids = [self.bos] if add_special else []
        for i, word in enumerate(text.split()):
            if word in self.word_to_id:
                ids.append(self.word_to_id[word])
            else:  # byte fallback
                ids.extend(BYTE_OFFSET + b for b in word.encode("utf-8"))
            ids.append(BYTE_OFFSET + ord(" "))
        if ids and ids[-1] == BYTE_OFFSET + ord(" "):
            ids.pop()
        if add_special:
            ids.append(self.eos)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        out: list[str] = []
        byte_buf: list[int] = []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for t in ids:
            if t in (0, 1, 2):
                continue
            if BYTE_OFFSET <= t < FIRST_WORD_ID:
                byte_buf.append(t - BYTE_OFFSET)
            else:
                flush()
                out.append(self.id_to_word.get(t, "<unk>"))
        flush()
        return "".join(
            w if (i == 0 or w == " " or out[i - 1] == " ") else " " + w
            for i, w in enumerate(out)).replace("  ", " ")

    # -- persistence ----------------------------------------------------------
    def save(self, path):
        pathlib.Path(path).write_text(json.dumps(
            {"max_vocab": self.max_vocab, "vocab": self.word_to_id}))

    @classmethod
    def load(cls, path) -> "ByteFallbackTokenizer":
        d = json.loads(pathlib.Path(path).read_text())
        return cls(d["vocab"], d["max_vocab"])
