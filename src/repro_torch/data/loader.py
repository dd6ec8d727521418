"""Shard-aware, prefetching data loader.

Each data-parallel rank reads its own disjoint slice of the sample index
space (rank-strided, like Megatron's data sampler); a background thread
prefetches the next batches while the step runs.

Copy of ``src/repro/data/loader.py``. Batches stay numpy arrays: the
loader's thread builds them on the host and never touches the card, and
the caller moves each batch to its device on its own thread (a thread
that made CUDA tensors could hang the interpreter's exit). ``close()``
the loader when done (in a ``finally``), as the reference's callers do.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np


class ShardedLoader:
    def __init__(self, sample_fn: Callable[[int], dict], global_batch: int,
                 *, rank: int = 0, world: int = 1, prefetch: int = 2,
                 start_step: int = 0):
        """sample_fn(global_sample_idx) -> dict of arrays (one sample)."""
        assert global_batch % world == 0, (global_batch, world)
        self.sample_fn = sample_fn
        self.global_batch = global_batch
        self.local_batch = global_batch // world
        self.rank, self.world = rank, world
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _build(self, step: int) -> dict:
        base = step * self.global_batch
        samples = [self.sample_fn(base + self.rank * self.local_batch + j)
                   for j in range(self.local_batch)]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._build(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def close(self):
        self._stop.set()


def lm_sample_fn(reader, seq_len: int):
    """Adapter: IndexedDatasetReader -> (tokens, labels) samples."""
    def fn(idx: int) -> dict:
        chunk = reader.sample(idx, seq_len)
        return {"tokens": chunk[:-1].astype(np.int32),
                "labels": chunk[1:].astype(np.int32)}
    return fn
