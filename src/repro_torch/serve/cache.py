"""Paged KV cache: device block pools, host allocator, prefix index.

Port of the paged part of ``src/repro/serve/cache.py``:
``PagedKVCache`` (trash block 0, host free list, ``ensure``/``free``/
``adopt``/``make_writable``, the prefix-cache methods,
``device_tables`` and the int8 pool layout), ``_quantize_block``,
``insert_paged_prefill``, ``copy_blocks`` and a copy of
``PrefixIndex``.

Attention K/V lives in fixed-size blocks inside one shared pool per
layer, addressed through per-slot block tables. Block 0 is the *trash
block*: every unowned table column points at it, so idle slots riding
along in a batched decode step write their dead tokens there.

Where the reference rebuilds its pools functionally under donation, the
port updates the pool tensors in place. The reference also relies on
JAX's ``mode="drop"`` scatter to discard the engine's padding rows
(pad block ids are ``n_blocks``); torch would raise on such indices, so
the port masks them out explicitly on the host before scattering.

Cache tree: ``{"slot0": {"k", "v"}}`` with leaves
``(L, n_blocks, block_size, Kh, Dh)`` in the model's activation dtype;
with ``kv_dtype="int8"`` the k/v leaves hold int8 codes and
``"k_scale"``/``"v_scale"`` leaves ``(L, n_blocks, Kh)`` fp32 hold their
symmetric per-(block, KV head) scales.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import check_family
from repro_torch.models.common import dtype_of

Params = Any


class CacheOOM(RuntimeError):
    """The paged pool ran out of free blocks (admission control signal)."""


def _rows_to_blocks(small: torch.Tensor, block_size: int) -> torch.Tensor:
    """(L, Kp, S, Kh, Dh) -> (L, Kp * ceil(S / bs), bs, Kh, Dh); the tail
    of a partial block is zero-padded (position-masked until decode
    overwrites it)."""
    l, kp, s = small.shape[:3]
    pad = -s % block_size
    if pad:
        small = torch.nn.functional.pad(small, (0, 0, 0, 0, 0, pad))
        s += pad
    return small.reshape((l, kp * (s // block_size), block_size)
                         + tuple(small.shape[3:]))


def _quantize_block(blk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of pool-shaped KV ``(L, n, bs, Kh,
    Dh)`` per (block, KV head): scale = maxabs / 127 over the block's
    (bs, Dh) slab, codes = round-half-to-even(x / scale) clamped to
    +-127. Returns (int8 codes, fp32 scales (L, n, Kh)). Zero slabs get
    scale 0 and all-zero codes. Same arithmetic as the reference, op for
    op (a true division, not a reciprocal multiply), so the same fp32
    input gives the same codes and scales."""
    blk = blk.float()
    sc = blk.abs().amax(dim=(2, 4)) / 127.0
    div = torch.where(sc > 0.0, sc, torch.ones_like(sc))
    q = torch.round(blk / div[:, :, None, :, None])
    return q.clamp(-127, 127).to(torch.int8), sc


def insert_paged_prefill(caches: Params, rows: Params, blocks, *,
                         block_size: int) -> Params:
    """Scatter a batched prefill result into the paged pool, in place.

    ``rows``: cache tree with k/v leaves (L, Kp, S, Kh, Dh); ``blocks``:
    host (Kp, ceil(S / block_size)) int block ids per request in position
    order. Ids out of range — the pad rows of the batched prefill (block
    ``n_blocks``) and the unowned tail columns of short prompts — are
    DROPPED, by masking them out here. (The reference's per-slot state
    leaves, padded with slot ``n_slots``, belong to the mamba families
    the port has not ported.) A k/v pool with a ``_scale`` sibling (the
    int8 layout) is written as :func:`_quantize_block` codes, and the
    scales of the same blocks beside it. Returns ``caches``.
    """
    flat = np.asarray(blocks).reshape(-1)
    tree = caches["slot0"]
    for name, small in rows["slot0"].items():
        pool = tree[name]
        keep = np.nonzero((flat >= 0) & (flat < pool.shape[1]))[0]
        src = _rows_to_blocks(small, block_size)[:, _idx(keep, pool)]
        dst = _idx(flat[keep], pool)
        if name + "_scale" in tree:
            codes, sc = _quantize_block(src)
            pool[:, dst] = codes
            tree[name + "_scale"][:, dst] = sc
        else:
            pool[:, dst] = src.to(pool.dtype)
    return caches


def _idx(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64)).to(like.device)


def copy_blocks(caches: Params, src, dst) -> Params:
    """Copy pool blocks ``src[i] -> dst[i]`` (host ints) on every k/v
    pool and, on an int8 pool, on its scale leaves, in place — the
    copy-on-write of a shared block, which then dequantizes as its
    parent does."""
    for pool in caches["slot0"].values():
        pool[:, _idx(dst, pool)] = pool[:, _idx(src, pool)]
    return caches


@dataclass
class _PrefixEntry:
    """One registered full KV block: the chain key addressing its token
    content, the physical block id, and LRU bookkeeping."""

    key: tuple
    block: int
    parent: Optional[tuple]     # chain key of the previous block (depth>0)
    children: int = 0           # live child entries (evict leaves first)
    last_used: int = 0


class PrefixIndex:
    """Content-addressed index over full KV blocks (shared prefixes).

    Copy of ``src/repro/serve/cache.py::PrefixIndex``. Keys are
    cumulative chains: block ``i`` of a prompt is addressed by
    ``(key_of_block_{i-1}, tokens[i*bs:(i+1)*bs])`` with ``()`` as the
    root, compared by value, so a hit means the whole token prefix
    matches exactly. Only full blocks are indexed. The index holds no
    refcounts: :class:`PagedKVCache` pins one reference per indexed block
    and reclaims via :meth:`pop_lru_leaf` (leaf-first, so no entry is
    orphaned).
    """

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._entries: dict[tuple, _PrefixEntry] = {}
        self._clock = 0

    def __len__(self) -> int:
        return len(self._entries)

    def blocks(self) -> list[int]:
        return [e.block for e in self._entries.values()]

    def match(self, tokens, max_tokens: Optional[int] = None) -> list[int]:
        """Longest indexed full-block chain prefixing ``tokens``, capped
        at ``max_tokens`` tokens. Returns the physical block ids and
        touches their LRU clocks."""
        bs = self.block_size
        limit = len(tokens) if max_tokens is None else min(len(tokens),
                                                           max_tokens)
        self._clock += 1
        key: tuple = ()
        out: list[int] = []
        for i in range(limit // bs):
            key = (key, tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
            e = self._entries.get(key)
            if e is None:
                break
            e.last_used = self._clock
            out.append(e.block)
        return out

    def register(self, tokens, block_ids) -> list[int]:
        """Index the full blocks of a prompt held in ``block_ids``
        (position order). Chains already present are kept (the first
        registrant's block stays canonical); returns the block ids of
        NEWLY created entries, which the caller must pin (+1 ref)."""
        bs = self.block_size
        n_full = min(len(tokens) // bs, len(block_ids))
        self._clock += 1
        key: tuple = ()
        new: list[int] = []
        for i in range(n_full):
            pkey, key = key, (
                key, tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
            e = self._entries.get(key)
            if e is None:
                e = _PrefixEntry(key=key, block=int(block_ids[i]),
                                 parent=pkey if i else None,
                                 last_used=self._clock)
                if i:
                    self._entries[pkey].children += 1
                self._entries[key] = e
                new.append(e.block)
            else:
                e.last_used = self._clock
        return new

    def pop_lru_leaf(self) -> Optional[_PrefixEntry]:
        """Remove and return the least-recently-used *leaf* entry, or
        None when the index is empty. The caller unpins its block."""
        leaves = [e for e in self._entries.values() if e.children == 0]
        if not leaves:
            return None
        e = min(leaves, key=lambda x: x.last_used)
        del self._entries[e.key]
        if e.parent is not None:
            parent = self._entries.get(e.parent)
            if parent is not None:
                parent.children -= 1
        return e

    def pop_all(self) -> list[int]:
        """Drain the index; returns every indexed block id (to unpin)."""
        out = self.blocks()
        self._entries.clear()
        return out


class PagedKVCache:
    """Block-table KV cache: device pools + host allocator.

    Device state: ``caches``, the pool tree (see the module docstring),
    which the serve engine takes over and updates in place; and
    ``device_tables()``, the ``(n_slots, max_blocks)`` int32 block table,
    uploaded again only after alloc/free changed it.

    Host state: a free list, per-slot owned-block lists and per-block
    reference counts (one per owning slot — shared-prefix adoption makes
    that >1 — plus one per prefix-index entry). ``ensure`` grows a slot
    (raising :class:`CacheOOM` when the pool is exhausted), ``free``
    returns a slot's references and points its table row back at the
    trash block 0. The default pool reserves worst-case capacity
    ``n_slots * max_len / block_size`` blocks plus the trash block.

    ``kv_dtype="int8"`` stores int8 codes with ``(L, n_blocks, Kh)`` fp32
    scale leaves beside the pools. ``pool_bytes`` (codes and scales),
    ``pool_bytes_fp`` (the same blocks at the model's KV dtype),
    ``bytes_per_block`` and ``max_concurrency`` (worst-case-length
    requests that fit in the fp byte budget) are the reference's
    capacity arithmetic.
    """

    def __init__(self, c: ModelConfig, n_slots: int, max_len: int, *,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 kv_dtype: str = "fp32", device: torch.device):
        check_family(c)
        if kv_dtype not in ("fp32", "int8"):
            raise ValueError(f"kv_dtype {kv_dtype!r}: fp32 or int8")
        if max_len % block_size:
            raise ValueError(f"max_len {max_len} is not a multiple of "
                             f"block_size {block_size}")
        self.n_slots, self.max_len = n_slots, max_len
        self.block_size = block_size
        self.device = device
        self.max_blocks = max_len // block_size
        total = (1 + n_slots * self.max_blocks) if n_blocks is None \
            else int(n_blocks)
        if total < 1 + self.max_blocks:
            raise ValueError(
                f"pool of {total} blocks cannot hold even one full slot "
                f"({self.max_blocks} blocks) plus the trash block")
        self.n_blocks = total
        shape = (c.n_layers, total, block_size, c.n_kv_heads, c.d_head)
        fp = dtype_of(c)
        tree = {name: torch.zeros(shape, dtype=torch.int8 if kv_dtype ==
                                  "int8" else fp, device=device)
                for name in ("k", "v")}
        if kv_dtype == "int8":
            for name in ("k", "v"):
                tree[name + "_scale"] = torch.zeros(
                    (c.n_layers, total, c.n_kv_heads), dtype=torch.float32,
                    device=device)
        self.caches = {"slot0": tree}
        self.pool_bytes = sum(t.numel() * t.element_size()
                              for t in tree.values())
        self.pool_bytes_fp = 2 * int(np.prod(shape)) * fp.itemsize
        self.bytes_per_block = self.pool_bytes // total
        self.max_concurrency = int(
            self.pool_bytes_fp // (self.max_blocks * self.bytes_per_block))
        self.tables_np = np.zeros((n_slots, self.max_blocks), np.int32)
        self._tables = torch.from_numpy(self.tables_np.copy()).to(device)
        self._dirty = False
        self._free = list(range(total - 1, 0, -1))   # block 0 = trash
        self._owned: list[list[int]] = [[] for _ in range(n_slots)]
        self._ref = [0] * total
        self._prefix: Optional[PrefixIndex] = None

    # -- allocator -------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def owned(self, slot: int) -> int:
        return len(self._owned[slot])

    def max_owned(self) -> int:
        """Longest live slot, in blocks (>= 1: the idle-slot trash column
        still has to be read by the decode step)."""
        return max((len(o) for o in self._owned), default=1) or 1

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow ``slot`` to hold ``n_tokens`` tokens, evicting LRU prefix
        index entries first when only they hold the spare blocks."""
        if n_tokens > self.max_len:
            raise ValueError(f"{n_tokens} tokens > max_len {self.max_len}")
        need = -(-n_tokens // self.block_size)
        owned = self._owned[slot]
        while len(owned) < need:
            if not self._free and not self._reclaim_prefix_block():
                raise CacheOOM(
                    f"paged pool exhausted: slot {slot} needs block "
                    f"{len(owned) + 1}/{need}, 0 of {self.n_blocks} free")
            blk = self._free.pop()
            self._ref[blk] = 1
            self.tables_np[slot, len(owned)] = blk
            owned.append(blk)
            self._dirty = True

    def free(self, slot: int) -> int:
        """Drop the slot's references; blocks whose refcount reaches zero
        return to the free list. The table row reverts to the trash
        block. Returns the number of blocks actually freed."""
        freed = 0
        if self._owned[slot]:
            for blk in reversed(self._owned[slot]):
                self._ref[blk] -= 1
                assert self._ref[blk] >= 0, (slot, blk)
                if self._ref[blk] == 0:
                    self._free.append(blk)
                    freed += 1
            self._owned[slot] = []
            self.tables_np[slot] = 0
            self._dirty = True
        return freed

    def adopt(self, slot: int, block_ids) -> None:
        """Attach existing (prefix) blocks to an empty ``slot``: each
        gains a reference and fills the next table columns."""
        owned = self._owned[slot]
        if owned:
            raise ValueError(f"adopt into non-empty slot {slot}")
        for blk in block_ids:
            blk = int(blk)
            if self._ref[blk] <= 0:
                raise ValueError(f"adopting dead block {blk}")
            self._ref[blk] += 1
            self.tables_np[slot, len(owned)] = blk
            owned.append(blk)
        if owned:
            self._dirty = True

    def make_writable(self, slot: int, pos: int,
                      n_tokens: int = 1) -> tuple[list[int], list[int]]:
        """Copy-on-write: make the blocks covering positions
        ``[pos, pos + n_tokens)`` exclusively owned by ``slot``. Returns
        the ``(src, dst)`` block pairs the caller must copy on the device
        (:func:`copy_blocks`) before writing."""
        bs = self.block_size
        owned = self._owned[slot]
        src: list[int] = []
        dst: list[int] = []
        for bi in range(pos // bs, (pos + n_tokens - 1) // bs + 1):
            assert bi < len(owned), (slot, pos, n_tokens, len(owned))
            old = owned[bi]
            if self._ref[old] <= 1:
                continue
            if not self._free and not self._reclaim_prefix_block():
                raise CacheOOM(
                    f"paged pool exhausted during copy-on-write for slot "
                    f"{slot} block {bi}")
            new = self._free.pop()
            self._ref[new] = 1
            self._ref[old] -= 1
            owned[bi] = new
            self.tables_np[slot, bi] = new
            self._dirty = True
            src.append(old)
            dst.append(new)
        return src, dst

    # -- prefix caching --------------------------------------------------
    @property
    def reclaimable_blocks(self) -> int:
        """Blocks held ONLY by the prefix index — evictable on demand."""
        if self._prefix is None:
            return 0
        return sum(1 for blk in self._prefix.blocks() if self._ref[blk] == 1)

    @property
    def available_blocks(self) -> int:
        """Free plus index-only blocks: what admission budgets against."""
        return len(self._free) + self.reclaimable_blocks

    def enable_prefix_cache(self) -> None:
        if self._prefix is None:
            self._prefix = PrefixIndex(self.block_size)

    def prefix_match(self, tokens) -> list[int]:
        """Longest cached full-block chain prefixing ``tokens``, capped
        at ``len(tokens) - 1`` tokens so at least one suffix token
        remains to prefill."""
        if self._prefix is None:
            return []
        return self._prefix.match(tokens, max_tokens=len(tokens) - 1)

    def prefix_register(self, slot: int, tokens) -> int:
        """Index ``slot``'s full prompt blocks; each newly indexed block
        gains the index's pin. Returns the number newly registered."""
        if self._prefix is None:
            return 0
        n_full = len(tokens) // self.block_size
        new = self._prefix.register(tokens, self._owned[slot][:n_full])
        for blk in new:
            self._ref[blk] += 1
        return len(new)

    def _reclaim_prefix_block(self) -> bool:
        """Evict LRU leaf index entries until one block returns to the
        free list. False when the index has nothing left."""
        if self._prefix is None:
            return False
        while True:
            e = self._prefix.pop_lru_leaf()
            if e is None:
                return False
            self._ref[e.block] -= 1
            if self._ref[e.block] == 0:
                self._free.append(e.block)
                return True

    def clear_prefix(self) -> None:
        """Drop every index entry (unpin; free refcount-zero blocks)."""
        if self._prefix is None:
            return
        for blk in self._prefix.pop_all():
            self._ref[blk] -= 1
            if self._ref[blk] == 0:
                self._free.append(blk)

    def block_ids(self, slot: int, n_tokens: int) -> np.ndarray:
        """(ceil(n_tokens/bs),) physical ids covering [0, n_tokens)."""
        need = -(-n_tokens // self.block_size)
        assert len(self._owned[slot]) >= need, (slot, n_tokens)
        return self.tables_np[slot, :need].copy()

    # -- device views ----------------------------------------------------
    def device_tables(self) -> torch.Tensor:
        if self._dirty:
            self._tables = torch.from_numpy(self.tables_np.copy()).to(
                self.device)
            self._dirty = False
        return self._tables
