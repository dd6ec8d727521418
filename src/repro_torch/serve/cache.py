"""KV and state caches: the slotted row pool, and the paged block pools
with their host allocator and prefix index.

Port of ``src/repro/serve/cache.py``: ``abstract_caches`` (the caches
a prefill emits, on the ``meta`` device: the dry run's shapes), the
slotted-cache ops
(``grow_caches``, ``slotted_cache``, ``insert_slot``, ``reset_slot``,
``insert_rows``, ``compact_slots``), ``PagedKVCache`` (trash block 0,
host free list, ``ensure``/``free``/``adopt``/``make_writable``, the
prefix-cache methods, ``device_tables`` and the int8 pool layout),
``_quantize_block``, ``insert_paged_prefill``, ``copy_blocks`` and a
copy of ``PrefixIndex``.

Cache tree layout, one entry per slot of the layer pattern's period
(``models.blocks.slot_kinds``), every leaf stacked over the
``n_periods`` periods:

  attention slots: ``{"k", "v"}`` (n_periods, n_slots, max_len, Kh, Dh)
                   [slotted] or (n_periods, n_blocks, bs, Kh, Dh)
                   [paged], in the model's activation dtype; an int8
                   pool holds int8 codes with ``"k_scale"``/``"v_scale"``
                   leaves (n_periods, n_blocks, Kh) fp32 beside them,
                   its symmetric per-(block, KV head) scales;
  mamba slots:     ``{"ssm", "conv"}`` per-slot rows (n_periods,
                   n_slots, ...) in either layout: the fp32 SSD state
                   and the pre-conv tail in the activation dtype, the
                   dtypes the prefill emits (a bf16 state leaf would
                   round the recurrence every token).

The slotted cache keeps one dense row of ``max_len`` positions per slot.
Decode writes a slot's token at its own position and attends over the
whole row under a position mask (``models.attention.decode_attention``),
so no kernel carries it, in the reference as here. In the paged layout
attention K/V lives in fixed-size blocks inside one shared pool per
layer, addressed through per-slot block tables. Block 0 is the *trash
block*: every unowned table column points at it, so idle slots riding
along in a batched decode step write their dead tokens there. Only the
k/v leaves are pools; state leaves stay per-slot rows, which the slot
ops write by slot id.

Where the reference rebuilds its caches functionally under donation, the
port updates the tensors in place. The reference also relies on JAX's
``mode="drop"`` scatter to discard the engine's padding rows (pad block
ids are ``n_blocks``, pad slot ids ``n_slots``); torch would raise on
such indices, so the port masks them out explicitly on the host before
scattering.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.blocks import period_of, slot_kinds
from repro_torch.models.common import dtype_of, param_dtype_of
from repro_torch.models.ssm import mamba_state_shapes

Params = Any

#: leaves with a token (T) axis: attention K/V, pooled in the paged layout
KV = ("k", "v")
#: pool leaves: what ``copy_blocks`` copies and ``pool_bytes`` counts
POOL = ("k", "v", "k_scale", "v_scale")


class CacheOOM(RuntimeError):
    """The paged pool ran out of free blocks (admission control signal)."""


def abstract_caches(c: ModelConfig, batch: int, seq_len: int,
                    abstract_params: Params):
    """The caches and encoder K/V a prefill of ``batch`` rows of
    ``seq_len`` positions emits, as ``meta`` tensors (no storage), from
    a prefill traced on ``meta`` with ``abstract_params``
    (``lm.init_abstract``). Returns ``((caches, enc_kv), kw)``, ``kw``
    holding the side inputs' meta tensors (a vlm's ``patch_embeds``, an
    encdec's ``enc_frames``), as the reference returns its
    ``eval_shape``."""
    meta = torch.device("meta")
    kw = {}
    s_text = seq_len - (c.n_patches if c.family == "vlm" else 0)
    tokens = torch.empty((batch, s_text), dtype=torch.int32, device=meta)
    if c.family == "vlm":
        kw["patch_embeds"] = torch.empty((batch, c.n_patches, c.d_model),
                                         dtype=dtype_of(c), device=meta)
    if c.family == "encdec":
        kw["enc_frames"] = torch.empty((batch, c.enc_seq, c.d_model),
                                       dtype=dtype_of(c), device=meta)
    with torch.no_grad():
        _logits, caches, enc_kv = lm.prefill(c, abstract_params, tokens, **kw)
    return (caches, enc_kv), kw


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


def _state_leaves(c: ModelConfig, n_periods: int, n_slots: int,
                  device) -> dict:
    """Zero ``{"ssm", "conv"}`` rows of one mamba slot, in the dtypes
    ``models.ssm.mamba_forward`` emits: fp32 state, and the pre-conv
    tail in the dtype of ``x @ in_proj``."""
    conv, ssm = mamba_state_shapes(c, n_slots)
    conv_dt = torch.promote_types(dtype_of(c), param_dtype_of(c))
    return {"ssm": torch.zeros((n_periods, *ssm), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((n_periods, *conv), dtype=conv_dt,
                                device=device)}


def grow_caches(caches: Params, max_len: int) -> Params:
    """A new tree with every k/v leaf's T axis (axis 2) zero-padded up to
    ``max_len`` rows (the fixed-batch policy grows prompt caches for
    decode with it, and slot insertion a prefill row to slot
    capacity); state leaves pass through."""
    out = {}
    for slot, tree in caches.items():
        out[slot] = {}
        for name, leaf in tree.items():
            if name not in KV:
                out[slot][name] = leaf
                continue
            pad = max_len - leaf.shape[2]
            if pad < 0:
                raise ValueError(f"{name} has {leaf.shape[2]} rows > "
                                 f"max_len {max_len}")
            out[slot][name] = torch.nn.functional.pad(
                leaf, (0, 0, 0, 0, 0, pad))
    return out


def slotted_cache(c: ModelConfig, n_slots: int, max_len: int, *,
                  device: torch.device) -> Params:
    """Zero cache pool of ``n_slots`` rows of ``max_len`` capacity (see
    the module docstring for its leaves), then only updated in place."""
    n_periods = c.n_layers // period_of(c)
    out = {}
    for i, (mixer, _ffn) in enumerate(slot_kinds(c)):
        if mixer == "attn":
            shape = (n_periods, n_slots, max_len, c.n_kv_heads, c.d_head)
            out[f"slot{i}"] = {name: torch.zeros(shape, dtype=dtype_of(c),
                                                 device=device)
                               for name in KV}
        else:
            out[f"slot{i}"] = _state_leaves(c, n_periods, n_slots, device)
    return out


def insert_slot(caches: Params, row: Params, slot: int) -> Params:
    """Write a batch-1 cache tree into batch row ``slot`` of the pool, in
    place: k/v leaves fill the row from position 0 (the old content past
    them stays, masked by position until decode overwrites it), state
    leaves replace the row's state."""
    for key, tree in row.items():
        for name, small in tree.items():
            big = caches[key][name]
            if name in KV:
                big[:, slot:slot + 1, :small.shape[2]] = small.to(big.dtype)
            else:
                big[:, slot:slot + 1] = small.to(big.dtype)
    return caches


def reset_slot(caches: Params, slot: int) -> Params:
    """Zero batch row ``slot`` of every leaf (state rows included), in
    place."""
    for tree in caches.values():
        for leaf in tree.values():
            leaf[:, slot] = 0
    return caches


def insert_rows(caches: Params, rows: Params, slots) -> Params:
    """Batched :func:`insert_slot`, in place: ``rows`` holds ``Kp``
    prefill results (k/v leaves ``(L, Kp, S, Kh, Dh)``, ``S <= max_len``;
    state leaves ``(L, Kp, ...)``) and ``slots`` (host, ``(Kp,)`` ints)
    their pool rows; rows ``[S, max_len)`` of a target keep what they
    held. Slot ids out of range — the pad rows of the batched prefill
    carry ``n_slots`` — are DROPPED, as the reference's ``mode="drop"``
    scatter drops them; torch would raise on them, so they are masked out
    here."""
    slots = np.asarray(slots).reshape(-1)
    for key, tree in rows.items():
        for name, small in tree.items():
            big = caches[key][name]
            keep = np.nonzero((slots >= 0) & (slots < big.shape[1]))[0]
            if not len(keep):
                continue
            dst = _idx(slots[keep], big)
            src = small[:, _idx(keep, small)].to(big.dtype)
            if name in KV:
                big[:, dst, :small.shape[2]] = src
            else:
                big[:, dst] = src
    return caches


def compact_slots(caches: Params, perm) -> Params:
    """Gather batch rows by ``perm`` (``(n_slots,)``), in place: row ``i``
    takes what row ``perm[i]`` held (packs active slots to the front)."""
    for tree in caches.values():
        for leaf in tree.values():
            leaf.copy_(leaf.index_select(1, _idx(np.asarray(perm), leaf)))
    return caches


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


def insert_paged_prefill(caches: Params, rows: Params, blocks, slots=None,
                         *, block_size: int) -> Params:
    """Scatter a batched prefill result into the paged pool, in place.

    ``rows``: cache tree with k/v leaves (L, Kp, S, Kh, Dh) and, on mamba
    slots, state leaves (L, Kp, ...); ``blocks``: host
    (Kp, ceil(S / block_size)) int block ids per request in position
    order; ``slots``: host (Kp,) slot ids, the rows the state leaves go
    to (needed only when ``rows`` has state leaves). Ids out of range —
    the pad rows of the batched prefill (block ``n_blocks``, slot
    ``n_slots``) and the unowned tail columns of short prompts — are
    DROPPED, by masking them out here. A k/v pool with a ``_scale``
    sibling (the int8 layout) is written as :func:`_quantize_block`
    codes, and the scales of the same blocks beside it. Returns
    ``caches``.
    """
    flat = np.asarray(blocks).reshape(-1)
    for key, small_tree in rows.items():
        tree = caches[key]
        state = {n: t for n, t in small_tree.items() if n not in KV}
        if state:
            if slots is None:
                raise ValueError(f"{key} holds state rows: pass their slots")
            insert_rows({key: tree}, {key: state}, slots)
        for name in KV:
            if name not in small_tree:
                continue
            small, pool = small_tree[name], tree[name]
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
    parent does. State leaves are per-slot rows and stay as they are."""
    for tree in caches.values():
        for name, pool in tree.items():
            if name in POOL:
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

    Device state: ``caches``, the cache tree (see the module docstring:
    attention slots' pools, mamba slots' per-slot state rows), which the
    serve engine takes over and updates in place; and
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
    scale leaves beside the pools. ``pool_bytes`` (codes and scales of
    the pools only), ``pool_bytes_fp`` (the same blocks at the model's KV
    dtype), ``bytes_per_block`` and ``max_concurrency`` (worst-case-length
    requests that fit in the fp byte budget; ``n_slots`` for a stack
    without attention, whose ``bytes_per_block`` is 0) are the
    reference's capacity arithmetic.
    """

    def __init__(self, c: ModelConfig, n_slots: int, max_len: int, *,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 kv_dtype: str = "fp32", device: torch.device):
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
        n_periods = c.n_layers // period_of(c)
        shape = (n_periods, total, block_size, c.n_kv_heads, c.d_head)
        fp = dtype_of(c)
        caches = {}
        for i, (mixer, _ffn) in enumerate(slot_kinds(c)):
            if mixer != "attn":
                caches[f"slot{i}"] = _state_leaves(c, n_periods, n_slots,
                                                   device)
                continue
            tree = {name: torch.zeros(shape, dtype=torch.int8 if kv_dtype ==
                                      "int8" else fp, device=device)
                    for name in KV}
            if kv_dtype == "int8":
                for name in KV:
                    tree[name + "_scale"] = torch.zeros(
                        (n_periods, total, c.n_kv_heads),
                        dtype=torch.float32, device=device)
            caches[f"slot{i}"] = tree
        self.caches = caches
        pools = [t for tree in caches.values() for n, t in tree.items()
                 if n in POOL]
        self.pool_bytes = sum(t.numel() * t.element_size() for t in pools)
        self.pool_bytes_fp = 2 * int(np.prod(shape)) * fp.itemsize * sum(
            "k" in tree for tree in caches.values())
        self.bytes_per_block = self.pool_bytes // total
        # a pure-SSM stack has no attention KV: no pool, no paging
        # capacity story to tell
        self.max_concurrency = n_slots if self.bytes_per_block == 0 else int(
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
