"""Serving engine: continuous and fixed-batch policies over the paged or
slotted KV cache, with energy-per-token accounting.

Port of ``src/repro/serve/engine.py`` (``ServeEngine``, ``BatchedServer``,
``GenerationResult``, ``make_prefill_fn``, ``make_decode_fn``). Scheduled
serving (``serve``) runs the dense, moe, ssm and hybrid families, both
cache layouts (``cache="paged"`` and
``"slotted"``), both schedulers (``sched="phased"`` and ``"chunked"``,
the latter paged only), both pool layouts (``kv_dtype="fp32"`` and
``"int8"``, the latter paged only) and the prefix cache off or on (paged
only). Stacks with mamba layers (ssm, hybrid) prefill each prompt at its
exact length, and refuse the prefix cache and the chunked scheduler, as
the reference does: a mamba recurrence runs through every token of the
sequence, so it can neither skip a cached prefix nor restart at a chunk
edge, and it would carry pad tokens into its state. Their per-slot state
rows ride beside the attention pools. The decode hot path keeps the
reference's mechanisms:

  * **slotted KV** — ``serve.cache.slotted_cache``: one dense
    ``max_len`` row per slot; a prefill batch lands through
    ``insert_rows`` and decode writes each slot's token at its own
    position and attends over the row under a position mask (``sdpa``;
    no kernel carries it, in the reference as here);
  * **paged KV** — ``serve.cache.PagedKVCache``: fixed-size blocks in a
    shared pool addressed by per-slot block tables; decode attention
    walks only the first ``nb`` table columns (``nb`` bucketed to the
    longest live slot) through ``kernels.ops.paged_decode_attention``;
    an int8 pool quantizes on insert and on every decode write
    (``models.attention._quantized_block_write``) and both kernels
    dequantize with its per-(block, KV head) scales;
  * **batched admission prefill** — newly admitted requests prefill as
    one batch per (prompt bucket, prefix depth) group, padded to
    ``n_slots`` rows like the reference, so both packages run the same
    shapes; a prefix-cache hit prefills only its suffix, attending over
    the shared prefix blocks in the pool through
    ``kernels.ops.paged_prefill_attention``;
  * **fused decode windows** — when the scheduler can prove no slot can
    finish or be admitted within ``k`` steps, ``k`` decode steps run
    back to back with the tokens chained on the device, and all ``k``
    outputs come back in one ``.cpu()``.

Two scheduler modes share the loop (``sched=``):

  * ``phased``  — a newly admitted request's whole prompt prefills at
    admission, which reserves its worst-case blocks (prompt + budget);
    a shortfall defers the queue head (FIFO);
  * ``chunked`` — each loop iteration runs at most one block-aligned
    ``chunk_tokens`` prefill slice per mid-prefill slot (batched across
    slots), then one decode step for every fully prefilled slot. Every
    chunk after the first is a suffix prefill over the slot's own blocks
    through the paged prefill kernel. Admission reserves only prompt + 1
    blocks; a shortfall at admission or during decode growth PREEMPTS
    the youngest strictly younger request (its blocks free, it re-queues
    at the front) and the resume re-prefills the original prompt chunk
    by chunk, then REPLAYS the already-emitted tail through the decode
    program as forced inputs, so the resumed stream equals the
    never-preempted one.

The reference's JIT programs become eager calls and its donated buffers
become in-place updates of the cache. Energy: every step window is
bracketed by synchronous ``PowerMethod`` samples — board power in watts,
or a cumulative energy counter in joules (NVML's, ``power_source=
"nvml_energy"``) — and ``core.metrics.attribute_energy`` takes each
window's energy from them (Wh/token, Wh/request).

Degradation: a request's ``deadline_s`` sheds it while still queued past
its admission deadline (``finish_reason="shed"``, zero tokens); a
``faults.schedule.FaultSchedule``'s overload windows cap the queue,
shedding the newest arrivals first, and its slot faults evict the
youngest decoding slot (chunked runs only: the victim resumes through
the preemption replay, so its stream equals the fault-free one). A
``core.runner.StragglerWatchdog`` watches every decode window.

Scripted mode (``prefill_fn``/``decode_fn``, host callables, with a fake
``clock``/``sleep_fn``) runs the reference's legacy one-request-prefill,
one-step-decode loop and touches no device: the energy, scheduler and
degradation tests drive it.

Fixed-batch ``generate`` (and ``BatchedServer`` over it) prefills a
whole batch and decodes it at one shared position through the dense
branch of ``decode_attention`` (no kernel, as in the reference); it is
the only way to serve the encdec and vlm families, whose side inputs
(encoder frames, patch embeddings) are per batch. It starts decoding at
the prefill cache's length: for a vlm that is patches plus text, where
the reference's ``generate`` starts at the text length (ROADMAP Queue 3).

Beyond the reference, the engine counts ``replayed_tokens`` (forced
decode inputs of resumed requests) and ``paged_prefills`` (batched
prefill calls that attended over pool blocks: prefix hits and chunks
after the first) in the last ``serve()``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.metrics import (
    ServeSummary, attribute_energy, serve_summary,
)
from repro_torch.core.runner import StragglerWatchdog
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm
from repro_torch.serve.cache import (
    CacheOOM, PagedKVCache, copy_blocks, grow_caches, insert_paged_prefill,
    insert_rows, slotted_cache,
)
from repro_torch.serve.requests import Request, RequestResult
from repro_torch.serve.scheduler import Scheduler, Slot, StepRecord

Params = Any


#: families with mamba layers: exact-length prefill, no prefix cache, no
#: chunked prefill
RECURRENT = ("ssm", "hybrid")
_RECURRENT_REFUSAL = (
    "family {!r} has mamba layers, whose recurrence runs through the whole "
    "sequence: prefix caching and chunked prefill need attention-only "
    "families")


#: families with per-request side inputs: fixed-batch ``generate`` only
SIDE_INPUTS = ("encdec", "vlm")


def make_prefill_fn(c: ModelConfig):
    """``prefill(params, tokens, extras) -> (logits, caches, enc_kv)``,
    ``extras`` holding a vlm's ``patch_embeds`` or an encdec's
    ``enc_frames``."""
    def prefill_step(params, tokens, extras):
        return lm.prefill(c, params, tokens,
                          patch_embeds=extras.get("patch_embeds"),
                          enc_frames=extras.get("enc_frames"))
    return prefill_step


def make_decode_fn(c: ModelConfig):
    """``decode(params, token, caches, pos, enc_kv=None) -> (logits,
    caches)``, the caches updated in place."""
    def serve_step(params, token, caches, pos, enc_kv=None):
        return lm.decode_step(c, params, token, caches, pos, enc_kv=enc_kv)
    return serve_step


@dataclass
class GenerationResult:
    tokens: Any                   # (B, n_steps) greedy tokens
    steps: int
    prefill_s: float
    decode_s: float

    @property
    def decode_tokens_per_s(self) -> float:
        n = self.tokens.shape[0] * self.steps
        return n / max(self.decode_s, 1e-9)


@dataclass
class ServeRunResult:
    """Outcome of one ``ServeEngine.serve`` run."""

    results: list                 # RequestResult, completion order
    steps: list                   # StepRecord log (energy attribution)
    sample_ts: list               # synchronous sample times
    #: the readings summed over the engine's methods at each sample:
    #: watts (``sample_kind == "power"``) or cumulative joules
    #: (``"energy"``)
    sample_ws: list
    summary: ServeSummary
    sample_kind: str = "power"
    straggler_events: list = field(default_factory=list)

    def by_rid(self) -> dict:
        return {r.rid: r for r in self.results}


class ServeEngine:
    """Serving engine over the paged or slotted KV cache (see module
    docstring).

    ``params`` is the model's parameter tree (``lm.init`` or
    ``bridge.params_from_numpy``) on ``device`` — the CUDA card unless
    the caller passes ``device="cpu"``. ``max_len`` is the total
    per-slot capacity (prompt + generated tokens); ``cache`` the layout
    (``"paged"``, the port's default, or ``"slotted"``, the reference's);
    ``decode_window`` caps how many decode steps a fused run keeps in
    flight (1 syncs every token). ``kv_dtype`` picks the pool layout
    (``"fp32"``: the model's activation dtype; ``"int8"``: codes +
    scales); ``sched`` and ``chunk_tokens`` are the default scheduler of
    ``serve()``. ``power_methods`` must all be of one ``kind``.
    ``clock`` and ``sleep_fn`` time the run and wait for arrivals;
    ``watchdog`` observes every decode window's time a step.

    Scripted mode: pass ``prefill_fn``/``decode_fn`` (and no model) —
    host callables with no device work,

      prefill_fn(slot: int, prompt: np.ndarray) -> int   first token
      decode_fn(tokens (S,), positions (S,), active (S,) bool) -> (S,)

    with a fake ``clock``/``sleep_fn`` pair, which makes the energy
    accounting exactly computable; such an engine serves phased only.
    """

    def __init__(self, c: Optional[ModelConfig] = None,
                 params: Params = None, *,
                 n_slots: int = 4, max_len: int = 256,
                 cache: str = "paged", block_size: int = 16,
                 n_blocks: Optional[int] = None,
                 prefix_cache: bool = False, kv_dtype: str = "fp32",
                 decode_window: int = 8, sched: str = "phased",
                 chunk_tokens: int = 32, device: DeviceLike = None,
                 prefill_fn: Optional[Callable] = None,
                 decode_fn: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep_fn: Optional[Callable[[float], None]] = None,
                 power_methods: Sequence = (),
                 watchdog: Optional[StragglerWatchdog] = None):
        if cache not in ("slotted", "paged"):
            raise ValueError(f"cache {cache!r}: slotted or paged")
        if sched not in ("phased", "chunked"):
            raise ValueError(f"sched {sched!r}: phased or chunked")
        if kv_dtype not in ("fp32", "int8"):
            raise ValueError(f"kv_dtype {kv_dtype!r}: fp32 or int8")
        if prefix_cache and cache != "paged":
            raise ValueError("prefix caching shares KV blocks: it needs "
                             "cache='paged'")
        if kv_dtype != "fp32" and cache != "paged":
            raise ValueError("int8 KV quantizes pool blocks: it needs "
                             "cache='paged'")
        power_methods = list(power_methods)
        kinds = {m.kind for m in power_methods}
        if len(kinds) > 1:
            raise ValueError(f"power methods of mixed kinds {sorted(kinds)}: "
                             "watts and joules cannot be summed")
        self._scripted = prefill_fn is not None or decode_fn is not None
        if self._scripted:
            if prefill_fn is None or decode_fn is None or c is not None:
                raise ValueError("scripted mode takes prefill_fn and "
                                 "decode_fn, and no model")
            self._slot_prefill, self._slot_decode = prefill_fn, decode_fn
            self.device = None
        else:
            if c is None or params is None:
                raise ValueError("a model engine needs (c, params)")
            if c.family in RECURRENT and (prefix_cache or sched == "chunked"):
                raise ValueError(_RECURRENT_REFUSAL.format(c.family))
            self.device = resolve_device(device)
            leaf = params["embed"]["tok"]
            if leaf.device.type != self.device.type:
                raise ValueError(f"params on {leaf.device}, engine on "
                                 f"{self.device}")
        self.c, self.params = c, params
        self.n_slots, self.max_len = n_slots, max_len
        self.cache_kind = cache
        self.block_size = block_size
        self._n_blocks = n_blocks
        self.prefix_cache = prefix_cache
        self.kv_dtype = kv_dtype
        self.decode_window = max(int(decode_window), 1)
        self.sched = sched
        self.chunk_tokens = int(chunk_tokens)
        self.preemptions = 0          # preempt events in the last serve()
        self.replayed_tokens = 0      # replayed decode inputs, last serve()
        self.paged_prefills = 0       # prefill calls over pool blocks
        self.shed = 0                 # requests shed in the last serve()
        self.injected_faults = 0      # slot faults fired in the last serve()
        self.clock = clock
        self.sleep_fn = sleep_fn or time.sleep
        self.watchdog = watchdog
        #: decode windows run over the engine's life (the watchdog's step
        #: index and the fault schedule's clock), as the reference counts
        self._decode_idx = 0
        self.power_methods = power_methods
        self.power_kind = kinds.pop() if kinds else "power"
        self.prefix_stats: dict = self._blank_prefix_stats()
        self._paged: Optional[PagedKVCache] = None
        #: admission-control ledger: slot -> reserved block demand
        #: (phased: prompt + full token budget; chunked: prompt + 1)
        self._slot_cap: dict[int, int] = {}
        #: available-block count snapshotted when admission last deferred
        #: the queue head; admission retries only once it changes
        self._defer_free_blocks: Optional[int] = None
        self.caches: Params = None   # the cache tree, allocated on first use
        if not self._scripted:
            # the fixed-batch generate() programs
            self._prefill_fn = make_prefill_fn(c)
            self._decode_fn = make_decode_fn(c)

    # ------------------------------------------------------------------
    # Cache + bucketing
    # ------------------------------------------------------------------

    def _ensure_cache(self):
        if self.caches is not None:
            return
        if self.c.family in SIDE_INPUTS:
            raise ValueError(
                f"family {self.c.family!r} needs per-request side inputs "
                "(encoder frames, patch embeddings): serve it with the "
                "fixed-batch generate() / BatchedServer")
        if self.cache_kind == "slotted":
            self.caches = slotted_cache(self.c, self.n_slots, self.max_len,
                                        device=self.device)
            return
        self._paged = PagedKVCache(self.c, self.n_slots, self.max_len,
                                   block_size=self.block_size,
                                   n_blocks=self._n_blocks,
                                   kv_dtype=self.kv_dtype,
                                   device=self.device)
        if self.prefix_cache:
            self._paged.enable_prefix_cache()
        self.caches = self._paged.caches

    @staticmethod
    def _blank_prefix_stats() -> dict:
        return {"hit_requests": 0, "miss_requests": 0,
                "reused_blocks": 0, "registered_blocks": 0}

    def _nb_bucket(self, n: int) -> int:
        """Table columns decode reads for ``n`` live blocks: the next
        power of two, capped at ``max_blocks`` (the reference's static
        gather width, kept so both packages run the same shapes)."""
        cap = self._paged.max_blocks
        b = 1
        while b < n and b < cap:
            b *= 2
        return min(b, cap)

    def _prompt_bucket(self, n: int) -> int:
        """Prompt-length bucket for batched prefill: the next
        ``block_size`` multiple (causal masking hides the pad tokens'
        K/V until decode overwrites it). Stacks with mamba layers prefill
        at the exact length ``n``: the SSD recurrence and conv tail would
        run through trailing pad tokens into decode state."""
        if self.c.family in RECURRENT:
            return n
        b = -(-n // self.block_size) * self.block_size
        return min(max(b, self.block_size), self.max_len)

    # ------------------------------------------------------------------
    # Paged admission control (pool shortfall -> deferral, not a crash)
    # ------------------------------------------------------------------

    def _free_paged_slot(self, slot_index: int) -> None:
        """Return a finished slot's blocks (a slotted row needs no
        freeing: the next prefill overwrites it)."""
        if self._paged is None:
            return
        self._paged.free(slot_index)
        self._slot_cap.pop(slot_index, None)

    def _paged_headroom(self) -> int:
        """Available blocks not yet spoken for by active slots'
        worst-case growth."""
        reserved = sum(max(0, cap - self._paged.owned(s))
                       for s, cap in self._slot_cap.items())
        return self._paged.available_blocks - reserved

    def _admit_paged(self, sched: Scheduler, admitted: list,
                     results=None, chunked: bool = False) -> list:
        """Reserve pool blocks for new admissions; defer (phased) or
        preempt (chunked) when the pool cannot cover them.

        Phased: each admission reserves its worst-case demand (prompt +
        full budget); when the unreserved headroom cannot cover the next
        request, it and everything behind it go back to the queue front
        (FIFO kept) until blocks free up. Chunked: the reservation is
        optimistic (prompt + first token) and a shortfall first unadmits
        the not-yet-prefilled tail, then preempts strictly younger
        running slots until the head fits (the head defers itself when
        no younger victim is left); the tail re-admits on the next loop
        iteration, behind any just-preempted (older) victims.
        """
        ok = []
        for i, slot in enumerate(admitted):
            req = slot.request
            if chunked:
                cap = -(-(req.prompt_len + 1) // self.block_size)
            else:
                cap = -(-(req.prompt_len + req.max_new_tokens)
                        // self.block_size)
            if cap > self._paged_headroom():
                if not chunked:
                    for later in reversed(admitted[i:]):
                        sched.unadmit(later)
                    self._defer_free_blocks = self._paged.available_blocks
                    break
                for later in reversed(admitted[i + 1:]):
                    sched.unadmit(later)
                me = (req.arrival_s, req.rid)
                while cap > self._paged_headroom():
                    victim = self._pick_victim(sched, me)
                    if victim is None:
                        break
                    self._preempt_slot(sched, victim, results)
                if cap > self._paged_headroom():
                    sched.unadmit(slot)
                    self._defer_free_blocks = self._paged.available_blocks
                    break
                self._slot_cap[slot.index] = cap
                ok.append(slot)
                break
            self._slot_cap[slot.index] = cap
            ok.append(slot)
        return ok

    def _admission_blocked(self) -> bool:
        """True while a deferred queue head cannot possibly admit."""
        snap = self._defer_free_blocks
        return (snap is not None and self._paged is not None
                and self._paged.available_blocks == snap)

    # ------------------------------------------------------------------
    # Block-granular preemption (chunked scheduler)
    # ------------------------------------------------------------------

    def _ensure_with_preempt(self, sched: Scheduler, slot: Slot,
                             n_tokens: int, results) -> bool:
        """Grow ``slot`` to ``n_tokens`` rows, preempting strictly
        younger requests on ``CacheOOM``; when none is left the slot
        preempts itself. True once the growth lands, False when the slot
        itself was preempted. The oldest active request can therefore
        always preempt its way to completion: an oversubscribed pool
        degrades to FIFO service, never to livelock."""
        req = slot.request
        me = (req.arrival_s, req.rid)
        while True:
            try:
                self._paged.ensure(slot.index, n_tokens)
                return True
            except CacheOOM:
                victim = self._pick_victim(sched, me)
                if victim is None:
                    self._preempt_slot(sched, slot, results)
                    return False
                self._preempt_slot(sched, victim, results)

    def _pick_victim(self, sched: Scheduler, me: tuple) -> Optional[Slot]:
        """Youngest active request strictly younger than ``me``; among
        equal arrivals the one holding the fewest blocks."""
        cands = [s for s in sched.slots if s.active
                 and (s.request.arrival_s, s.request.rid) > me]
        if not cands:
            return None
        return max(cands, key=lambda s: (s.request.arrival_s,
                                         -self._paged.owned(s.index),
                                         s.request.rid))

    def _preempt_slot(self, sched: Scheduler, victim: Slot,
                      results) -> None:
        """Evict ``victim``: the scheduler captures its emitted stream in
        the resume request, then its blocks are reclaimed."""
        idx = victim.index
        sched.preempt(victim, results[victim.request.rid].tokens)
        self._free_paged_slot(idx)
        # blocks moved: a headroom-deferred queue head may retry
        self._defer_free_blocks = None
        self.preemptions += 1

    # ------------------------------------------------------------------
    # Model phases
    # ------------------------------------------------------------------

    def _tensor(self, a: np.ndarray, dtype=torch.int64) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device,
                                                            dtype)

    def _prefill(self, tokens: np.ndarray, last: np.ndarray, npre: int,
                 pre_blocks: np.ndarray):
        """One batched prefill: cold (``npre == 0``), or a suffix (a
        prefix-cache hit, or a chunk after the first) that attends over
        ``npre`` pool blocks through the paged prefill kernel. Returns
        (first tokens on the device, suffix cache rows)."""
        kw = {}
        if npre:
            kw = dict(paged_prefix=self.caches,
                      paged_tables=self._tensor(pre_blocks, torch.int32),
                      pos_offset=npre * self.block_size)
            self.paged_prefills += 1
        logits, rows, _ = lm.prefill(self.c, self.params,
                                     self._tensor(tokens),
                                     last_pos=self._tensor(last), **kw)
        return logits[:, -1].argmax(-1), rows

    def _model_prefill_admitted(self, sched: Scheduler, admitted, results,
                                steps, ts, ws):
        """Prefill newly admitted slots as one padded batch per
        (suffix-bucket, prefix-depth) group; one host fetch returns the
        group's first tokens. With the prefix cache on, each prompt is
        matched against the index first: a hit of ``npre`` full blocks
        adopts them (shared, refcounted) and prefills only the suffix.
        Every prompt then registers its own full blocks. A slotted cache
        takes the rows into the slots' own rows (``insert_rows``)."""
        bs = self.block_size
        paged = self._paged is not None
        groups: dict[tuple, list] = {}
        for slot in admitted:
            pre: list = []
            if self.prefix_cache:
                pre = self._paged.prefix_match(
                    [int(t) for t in slot.request.prompt])
            npre = len(pre)
            bucket = self._prompt_bucket(slot.request.prompt_len - npre * bs)
            groups.setdefault((bucket, npre), []).append((slot, pre))
        for (bucket, npre), entries in sorted(groups.items()):
            kp = self.n_slots       # fixed batch, as the reference's programs
            pre_len = npre * bs
            t0 = self.clock()
            self._sample_power(ts, ws)   # bracket the prefill window
            tokens = np.zeros((kp, bucket), np.int64)
            last = np.zeros((kp,), np.int64)
            # pad rows read the trash block — harmless, never read back
            pre_blocks = np.zeros((kp, npre), np.int32)
            slot_ids = np.full((kp,), self.n_slots)         # pad: dropped
            slot_ids[:len(entries)] = [s.index for s, _pre in entries]
            for i, (slot, pre) in enumerate(entries):
                plen = slot.request.prompt_len
                prompt = np.asarray(slot.request.prompt, np.int64)
                tokens[i, :plen - pre_len] = prompt[pre_len:]
                last[i] = plen - pre_len - 1
                if npre:
                    pre_blocks[i] = pre
            first, rows = self._prefill(tokens, last, npre, pre_blocks)
            if paged:
                blocks = np.full((kp, -(-bucket // bs)),
                                 self._paged.n_blocks, np.int64)  # pad: dropped
                for i, (slot, pre) in enumerate(entries):
                    plen = slot.request.prompt_len
                    if npre:
                        self._paged.adopt(slot.index, pre)
                    self._paged.ensure(slot.index, plen)
                    own = self._paged.block_ids(slot.index, plen)[npre:]
                    blocks[i, :len(own)] = own
                insert_paged_prefill(self.caches, rows, blocks, slot_ids,
                                     block_size=bs)
            else:
                insert_rows(self.caches, rows, slot_ids)
            if self.prefix_cache:
                st = self.prefix_stats
                st["hit_requests" if npre else "miss_requests"] += len(entries)
                st["reused_blocks"] += npre * len(entries)
                for slot, _pre in entries:
                    st["registered_blocks"] += self._paged.prefix_register(
                        slot.index, [int(t) for t in slot.request.prompt])
            first_np = first.cpu().numpy()      # one batched device fetch
            t1 = self.clock()
            self._sample_power(ts, ws)
            rids = tuple(s.request.rid for s, _pre in entries)
            steps.append(StepRecord("prefill", t0, t1, rids, len(rids)))
            for i, (slot, _pre) in enumerate(entries):
                res = results[slot.request.rid]
                res.slot = slot.index
                res.admitted_s, res.first_token_s = t0, t1
                tok = int(first_np[i])
                res.tokens.append(tok)
                slot_index = slot.index
                reason = sched.record_token(slot, tok)
                if reason is not None:
                    res.finish_s, res.finish_reason = t1, reason
                    self._free_paged_slot(slot_index)

    def _start_chunked(self, admitted, results) -> None:
        """Begin chunked prefill for newly admitted slots: rewind
        ``prefill_pos`` (``refill`` set it to ``prompt_len``, the phased
        default) to the prefix-match depth, adopting the matched shared
        blocks. A resume adopts no block of its replay region and leaves
        at least one original-prompt token to prefill."""
        t_admit = self.clock()
        for slot in admitted:
            req = slot.request
            res = results[req.rid]
            res.slot = slot.index
            # a resume keeps its first admission stamp: TTFT measures
            # first service, not re-service
            if res.admitted_s == 0.0:
                res.admitted_s = t_admit
            pre: list = []
            if self.prefix_cache:
                pre = self._paged.prefix_match([int(t) for t in req.prompt])
                if req.n_replay:
                    pre = pre[:max(slot.prefill_target - 1, 0)
                              // self.block_size]
                st = self.prefix_stats
                st["hit_requests" if pre else "miss_requests"] += 1
                st["reused_blocks"] += len(pre)
            if pre:
                self._paged.adopt(slot.index, pre)
            slot.prefill_pos = len(pre) * self.block_size
            slot.pos = slot.prefill_pos   # KV rows landed so far

    def _model_prefill_chunks(self, sched: Scheduler, results, steps, ts,
                              ws, chunk_tokens: int) -> None:
        """Run ONE ``chunk_tokens`` prefill slice for every mid-prefill
        slot, batched per (suffix-bucket, prefix-depth) group. Chunk
        ``j > 0`` is a suffix prefill over the slot's own first
        ``prefill_pos / block_size`` blocks (the paged prefill kernel).
        A non-final chunk writes K/V only (its argmax is discarded); the
        final chunk emits the first token as phased prefill does and
        registers the prompt with the prefix index — unless the slot is
        a resume, which starts its decode replay instead. Pool growth
        for a chunk may preempt a younger slot, possibly one of this
        wave, which then drops out before grouping."""
        bs = self.block_size
        slots = [s for s in sched.slots if s.prefilling]
        # grow oldest-first so preemption flows old -> young
        for slot in sorted(slots, key=lambda s: (s.request.arrival_s,
                                                 s.index)):
            if not slot.prefilling:
                continue    # preempted by an older slot's growth
            end = min(slot.prefill_pos + chunk_tokens, slot.prefill_target)
            self._ensure_with_preempt(sched, slot, end, results)
        groups: dict[tuple, list] = {}
        for slot in slots:
            if not slot.prefilling:
                continue
            start = slot.prefill_pos
            end = min(start + chunk_tokens, slot.prefill_target)
            bucket = self._prompt_bucket(end - start)
            groups.setdefault((bucket, start // bs), []).append(
                (slot, start, end))
        for (bucket, npre), entries in sorted(groups.items()):
            kp = self.n_slots
            pre_len = npre * bs
            t0 = self.clock()
            self._sample_power(ts, ws)   # bracket the chunk window
            tokens = np.zeros((kp, bucket), np.int64)
            last = np.zeros((kp,), np.int64)
            pre_blocks = np.zeros((kp, npre), np.int32)
            for i, (slot, start, end) in enumerate(entries):
                prompt = np.asarray(slot.request.prompt, np.int64)
                tokens[i, :end - start] = prompt[start:end]
                last[i] = end - start - 1
                if npre:
                    pre_blocks[i] = self._paged.block_ids(slot.index,
                                                          pre_len)
            first, rows = self._prefill(tokens, last, npre, pre_blocks)
            blocks = np.full((kp, -(-bucket // bs)), self._paged.n_blocks,
                             np.int64)                       # pad: dropped
            for i, (slot, start, end) in enumerate(entries):
                own = self._paged.block_ids(slot.index, end)[npre:]
                blocks[i, :len(own)] = own
            insert_paged_prefill(self.caches, rows, blocks, block_size=bs)
            finals = [(i, slot) for i, (slot, _s, end) in enumerate(entries)
                      if end == slot.prefill_target]
            emitting = [(i, s) for i, s in finals if not s.request.n_replay]
            first_np = first.cpu().numpy() if emitting else None
            t1 = self.clock()
            self._sample_power(ts, ws)
            rids = tuple(s.request.rid for s, _s, _e in entries)
            # the window's energy splits across every chunking request;
            # n_tokens counts only first tokens actually emitted
            steps.append(StepRecord("prefill", t0, t1, rids, len(emitting)))
            for slot, _start, end in entries:
                slot.prefill_pos = end
                slot.pos = end
            for i, slot in finals:
                req = slot.request
                if req.n_replay:
                    # resume: the original prompt is back; the emitted
                    # tail replays through decode as forced inputs (this
                    # chunk's argmax recomputes an emitted token: drop
                    # it). No prefix registration: the tail blocks will
                    # hold decode-built K/V.
                    slot.replay = req.n_replay
                    slot.last_token = int(req.prompt[slot.prefill_pos])
                    continue
                if self.prefix_cache:
                    self.prefix_stats["registered_blocks"] += \
                        self._paged.prefix_register(
                            slot.index, [int(t) for t in req.prompt])
                res = results[req.rid]
                if res.first_token_s == 0.0:
                    res.first_token_s = t1
                tok = int(first_np[i])
                res.tokens.append(tok)
                slot_index = slot.index
                reason = sched.record_token(slot, tok)
                if reason is not None:
                    res.finish_s, res.finish_reason = t1, reason
                    self._free_paged_slot(slot_index)

    def _decode_plan(self, sched: Scheduler, active,
                     admission_blocked: bool = False,
                     prefilling: bool = False) -> int:
        """How many decode steps can run before the host must look: fused
        only when no slot is mid-chunked-prefill (its next chunk goes
        between decode steps) or replaying (its inputs are forced host
        tokens, not the chained argmax), no active request can hit EOS,
        each has at least ``k`` budget left, and no admission could
        happen meanwhile (a headroom-deferred head cannot admit until a
        slot finishes, and finishes land on window edges)."""
        if self.decode_window <= 1 or prefilling:
            return 1
        if any(s.replay for s in active):
            return 1
        if (len(active) < self.n_slots and sched.n_pending
                and not admission_blocked and sched.policy != "fixed"):
            return 1
        if any(s.request.eos_id is not None for s in active):
            return 1
        k = min(s.request.max_new_tokens - s.generated for s in active)
        k = min(k, min(self.max_len - s.pos for s in active))
        return max(1, min(k, self.decode_window))

    def _grow_for_decode(self, sched: Scheduler, active, k: int, results,
                         allow_preempt: bool) -> list:
        """Grow every active slot's blocks to cover ``k`` more tokens
        (preempting younger slots, oldest first, under the chunked
        scheduler) and copy out any shared block under a write cursor.
        Returns the slots still decoding."""
        if allow_preempt:
            for s in sorted(active, key=lambda s: (s.request.arrival_s
                                                   if s.request else 0.0,
                                                   s.index)):
                if not s.decoding:
                    continue    # preempted by an older slot's growth
                self._ensure_with_preempt(sched, s, s.pos + k, results)
            active = [s for s in active if s.decoding]
        else:
            for s in active:
                self._paged.ensure(s.index, s.pos + k)
        if self.prefix_cache:
            # copy-on-write net: decode writes land past every shared
            # (full, block-aligned) prefix block, so this stays a no-op
            # unless a shared block ever ends up under a write cursor
            srcs: list = []
            dsts: list = []
            for s in active:
                sc, dc = self._paged.make_writable(s.index, s.pos, k)
                srcs += sc
                dsts += dc
            if srcs:
                copy_blocks(self.caches, srcs, dsts)
        return active

    def _model_decode_run(self, sched: Scheduler, active, k: int, results,
                          steps, ts, ws, allow_preempt: bool = False):
        """Run ``k`` decode steps with the token stream chained on the
        device, then drain all outputs in one ``.cpu()``. Under the
        chunked scheduler (``allow_preempt``) growth past the optimistic
        reservation preempts younger slots, oldest first; a replaying
        slot consumes its forced inputs and emits only after the last.
        A slotted cache needs no growth and no tables."""
        paged_kw = {}
        if self._paged is not None:
            active = self._grow_for_decode(sched, active, k, results,
                                           allow_preempt)
            if not active:
                return
            paged_kw = dict(block_tables=self._paged.device_tables(),
                            n_kv_blocks=self._nb_bucket(
                                self._paged.max_owned()))
        tok = self._tensor(sched.input_tokens())
        pos0 = self._tensor(sched.positions(), torch.int32)
        adv = self._tensor(sched.active_mask(), torch.int32)  # idle rows park
        rids = tuple(s.request.rid for s in active)
        t0 = self.clock()
        self._sample_power(ts, ws)   # bracket the decode window
        outs = []
        for i in range(k):
            logits, _ = lm.decode_step(self.c, self.params, tok[:, None],
                                       self.caches, pos0 + i * adv,
                                       **paged_kw)
            tok = logits[:, -1].argmax(-1)
            outs.append(tok)
        outs_np = torch.stack(outs).cpu().numpy()   # pipeline drain: one sync
        t1 = self.clock()
        self._sample_power(ts, ws)
        if self.watchdog is not None:
            self.watchdog.observe(self._decode_idx, (t1 - t0) / k)
        self._decode_idx += 1
        emitted = 0
        for out in outs_np:
            for s in active:
                if s.request is None:     # finished at an earlier micro-step
                    continue
                if s.replay:
                    # a forced emitted-tail input was consumed; only the
                    # last replay step's argmax is a new token
                    s.replay -= 1
                    self.replayed_tokens += 1
                    if s.replay:
                        s.pos += 1
                        s.last_token = int(s.request.prompt[s.pos])
                        continue
                res = results[s.request.rid]
                tok_i = int(out[s.index])
                emitted += 1
                res.tokens.append(tok_i)
                slot_index = s.index
                reason = sched.record_token(s, tok_i)
                if reason is not None:
                    res.finish_s, res.finish_reason = t1, reason
                    self._free_paged_slot(slot_index)
        # every stepped slot is credited the window's energy (replay
        # steps burn compute too); n_tokens counts appended tokens only
        steps.append(StepRecord("decode", t0, t1, rids * k, emitted,
                                n_steps=k))

    # ------------------------------------------------------------------
    # Warmup + prefix-cache reset
    # ------------------------------------------------------------------

    def warmup(self, prompt_len: int = 8,
               requests: Optional[Sequence[Request]] = None,
               repeat: int = 1, sched: Optional[str] = None):
        """Serve a throwaway request set (under ``sched``, default the
        engine's) with power sampling and the watchdog detached, so
        first-call set-up (CUDA context, library handles, allocator)
        stays outside measured runs; the prefix index is cleared after.
        A scripted engine has nothing to warm."""
        if self._scripted:
            return
        if requests is None:
            budget = max(self.max_len - prompt_len, 1)
            requests = [Request(rid=-(i + 1),
                                prompt=np.zeros(prompt_len, np.int32),
                                max_new_tokens=budget, arrival_s=0.0)
                        for i in range(self.n_slots)]
        saved = self.power_methods, self.watchdog
        self.power_methods, self.watchdog = [], None
        try:
            for _ in range(max(int(repeat), 1)):
                self.serve(requests, policy="continuous", sched=sched)
        finally:
            self.power_methods, self.watchdog = saved
            self.reset_prefix_cache()

    def reset_prefix_cache(self):
        """Drop every prefix-index entry and zero the hit counters."""
        if self._paged is not None and self.prefix_cache:
            self._paged.clear_prefix()
        self.prefix_stats = self._blank_prefix_stats()

    # ------------------------------------------------------------------
    # Run loop
    # ------------------------------------------------------------------

    def _sample_power(self, ts: list, ws: list):
        """One sample of every power method, summed (watts, or joules of
        a cumulative counter). A failing read raises: no reading is
        substituted."""
        if not self.power_methods:
            return
        w = sum(sum(m.read().values()) for m in self.power_methods)
        ts.append(self.clock())
        ws.append(w)

    def serve(self, requests: Sequence[Request], *,
              policy: str = "continuous", poll_s: float = 0.002,
              sched: Optional[str] = None,
              chunk_tokens: Optional[int] = None,
              faults=None) -> ServeRunResult:
        """Run a request set to completion under ``policy``
        (``continuous`` or ``fixed``). ``arrival_s`` is relative to the
        run start; the engine sleeps (``sleep_fn``) while the queue is
        empty and slots are idle. ``sched`` and ``chunk_tokens`` override
        the engine's for this run; a chunked run needs a model engine,
        the paged cache (preemption reclaims blocks) and ``chunk_tokens``
        a positive multiple of ``block_size`` (chunk edges land on block
        edges).

        Degradation: a request still queued past its ``deadline_s`` is
        shed (zero tokens, ``finish_reason="shed"``); ``faults``, a
        ``FaultSchedule``, caps the queue in its overload windows
        (shedding the newest arrivals first: the oldest queued request
        is never shed) and evicts the youngest decoding slot at each of
        its slot faults (chunked runs only: the victim resumes through
        the preemption replay). ``self.shed`` and
        ``self.injected_faults`` count both in the last run."""
        mode = sched or self.sched
        if mode not in ("phased", "chunked"):
            raise ValueError(f"sched {mode!r}: phased or chunked")
        chunked = mode == "chunked"
        ct = int(chunk_tokens if chunk_tokens is not None
                 else self.chunk_tokens)
        if chunked and self._scripted:
            raise ValueError("chunked prefill runs the model: a scripted "
                             "engine serves phased only")
        if chunked and self.cache_kind != "paged":
            raise ValueError("chunked prefill and preemption need "
                             "block-granular reclaim (cache='paged')")
        if chunked and self.c.family in RECURRENT:
            raise ValueError(_RECURRENT_REFUSAL.format(self.c.family))
        if chunked and (ct <= 0 or ct % self.block_size):
            raise ValueError(f"chunk_tokens {ct} must be a positive "
                             f"multiple of block_size {self.block_size}")
        if faults is not None and not chunked and any(
                e.kind == "slot_fault" for e in faults.events):
            raise ValueError("slot faults recover through the preemption "
                             "replay, which only the chunked scheduler of "
                             "a model engine runs")
        with torch.no_grad():
            return self._serve(requests, policy, poll_s, chunked, ct,
                               faults)

    def _scripted_prefill(self, sched: Scheduler, admitted, results, steps,
                          ts, ws) -> None:
        """The reference's legacy loop: one prefill window a request."""
        for slot in admitted:
            req = slot.request
            res = results[req.rid]
            res.slot = slot.index
            res.admitted_s = self.clock()
            self._sample_power(ts, ws)   # bracket the prefill window
            first = int(self._slot_prefill(slot.index, req.prompt))
            t1 = self.clock()
            self._sample_power(ts, ws)
            res.first_token_s = t1
            res.tokens.append(first)
            steps.append(StepRecord("prefill", res.admitted_s, t1,
                                    (req.rid,), 1))
            reason = sched.record_token(slot, first)
            if reason is not None:
                res.finish_s, res.finish_reason = t1, reason

    def _scripted_decode(self, sched: Scheduler, active, results, steps,
                         ts, ws) -> None:
        """One decode window over every active slot, one step."""
        rids = tuple(s.request.rid for s in active)
        t0 = self.clock()
        self._sample_power(ts, ws)   # bracket the decode window
        out = self._slot_decode(sched.input_tokens(), sched.positions(),
                                sched.active_mask())
        t1 = self.clock()
        self._sample_power(ts, ws)
        if self.watchdog is not None:
            self.watchdog.observe(self._decode_idx, t1 - t0)
        self._decode_idx += 1
        steps.append(StepRecord("decode", t0, t1, rids, len(rids)))
        out = np.asarray(out)
        for s in active:
            res = results[s.request.rid]
            tok = int(out[s.index])
            res.tokens.append(tok)
            reason = sched.record_token(s, tok)
            if reason is not None:
                res.finish_s, res.finish_reason = t1, reason

    def _serve(self, requests, policy: str, poll_s: float, chunked: bool,
               chunk_tokens: int, faults) -> ServeRunResult:
        if not self._scripted:
            self._ensure_cache()
        self.preemptions = self.replayed_tokens = self.paged_prefills = 0
        self.shed = self.injected_faults = 0
        sched = Scheduler(self.n_slots, self.max_len, policy=policy)
        has_deadlines = any(r.deadline_s is not None for r in requests)
        t_start = self.clock()
        results: dict[int, RequestResult] = {}
        for r in requests:
            sched.submit(r)
            results[r.rid] = RequestResult(
                rid=r.rid, prompt_len=r.prompt_len,
                arrival_s=t_start + r.arrival_s, tenant=r.tenant)
        steps: list[StepRecord] = []
        ts: list[float] = []
        ws: list[float] = []
        self._defer_free_blocks = None
        self.prefix_stats = self._blank_prefix_stats()
        self._sample_power(ts, ws)

        def mark_shed(req: Request):
            res = results[req.rid]
            res.finish_s = self.clock()
            res.finish_reason = "shed"
            self.shed += 1

        poll = 0
        while sched.has_work:
            now_rel = self.clock() - t_start
            # graceful degradation: deadline expiry, then overload caps
            if has_deadlines or faults is not None:
                sched._absorb_arrivals(now_rel)
                if has_deadlines:
                    for req in sched.shed_expired(now_rel):
                        mark_shed(req)
                cap = faults.queue_cap_at(poll) if faults is not None \
                    else None
                if cap is not None:
                    for req in sched.shed_newest(cap):
                        mark_shed(req)
            poll += 1
            # a headroom-deferred head retries only once blocks moved
            if self._admission_blocked():
                admitted = []
            else:
                self._defer_free_blocks = None
                admitted = sched.refill(now_rel)
                if admitted and self._paged is not None:
                    admitted = self._admit_paged(sched, admitted, results,
                                                 chunked=chunked)
            if chunked:
                if admitted:
                    self._start_chunked(admitted, results)
                if any(s.prefilling for s in sched.slots):
                    self._model_prefill_chunks(sched, results, steps, ts,
                                               ws, chunk_tokens)
            elif admitted and self._scripted:
                self._scripted_prefill(sched, admitted, results, steps, ts,
                                       ws)
            elif admitted:
                self._model_prefill_admitted(sched, admitted, results,
                                             steps, ts, ws)
            active = sched.decode_slots()
            if (faults is not None and active
                    and faults.slot_fault_at(self._decode_idx)):
                # an injected slot failure evicts the YOUNGEST decoding
                # slot (FIFO degradation); it re-queues at the front and
                # resumes through the decode replay
                victim = max(active, key=lambda s: (s.request.arrival_s,
                                                    s.request.rid))
                self._preempt_slot(sched, victim, results)
                self.injected_faults += 1
                active = sched.decode_slots()
            prefilling = any(s.prefilling for s in sched.slots)
            if active and self._scripted:
                self._scripted_decode(sched, active, results, steps, ts, ws)
            elif active:
                k = self._decode_plan(
                    sched, active,
                    admission_blocked=self._admission_blocked(),
                    prefilling=prefilling)
                self._model_decode_run(sched, active, k, results,
                                       steps, ts, ws, allow_preempt=chunked)
            elif sched.n_pending and not prefilling:
                # idle: nothing admitted yet — wait for the next arrival
                nxt = sched.next_arrival_s()
                wait = (t_start + nxt) - self.clock() if nxt is not None \
                    else poll_s
                if wait > 0:
                    self.sleep_fn(min(wait, 0.05))

        self._sample_power(ts, ws)
        out_results = sorted(results.values(), key=lambda r: r.finish_s)
        kind = self.power_kind
        for rid, wh in attribute_energy(steps, ts, ws, kind).items():
            results[rid].energy_wh = wh
        return ServeRunResult(
            results=out_results, steps=steps, sample_ts=ts, sample_ws=ws,
            summary=serve_summary(out_results, steps, ts, ws,
                                  n_slots=self.n_slots, kind=kind),
            sample_kind=kind,
            straggler_events=list(self.watchdog.events)
            if self.watchdog is not None else [])

    # ------------------------------------------------------------------
    # Fixed-batch generation (the reference's legacy BatchedServer path)
    # ------------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, tokens, n_steps: int, extras: Optional[dict] = None,
                 gen_budget: Optional[int] = None) -> GenerationResult:
        """Fixed-batch greedy decode: prefill the whole (B, S) batch (with
        ``extras``: a vlm's ``patch_embeds``, an encdec's ``enc_frames``),
        then ``n_steps - 1`` decode steps at one position shared by every
        row, starting at the prefill cache's length (``n_patches + S``
        for a vlm, ``S`` otherwise). ``gen_budget`` (default
        ``n_steps + 1``) is how far the K/V caches grow past that length.
        Returns the (B, n_steps) tokens and the prefill (encoder
        included) and decode wall times, the card synchronised around
        each."""
        if self._scripted:
            raise ValueError("generate runs the model: not a scripted engine")
        extras = {k: torch.as_tensor(v, device=self.device)
                  for k, v in (extras or {}).items()}
        budget = gen_budget if gen_budget is not None else n_steps + 1
        tokens = torch.as_tensor(tokens, device=self.device).long()
        n = tokens.shape[1]
        if self.c.family == "vlm" and "patch_embeds" in extras:
            n += extras["patch_embeds"].shape[1]
        with torch.no_grad():
            self._sync()
            t0 = time.perf_counter()
            logits, caches, enc_kv = self._prefill_fn(self.params, tokens,
                                                      extras)
            self._sync()
            t1 = time.perf_counter()
            # grow K/V so decode can append (state leaves pass through)
            caches = grow_caches(caches, n + budget)
            out = [logits[:, -1].argmax(-1)]
            for pos in range(n, n + n_steps - 1):
                logits, caches = self._decode_fn(self.params, out[-1][:, None],
                                                 caches, pos, enc_kv)
                out.append(logits[:, -1].argmax(-1))
            toks = torch.stack(out, 1)
            self._sync()
            t2 = time.perf_counter()
        return GenerationResult(toks, n_steps, t1 - t0, t2 - t1)


class BatchedServer:
    """Fixed-batch greedy decoding over ``ServeEngine.generate``.

    ``max_len`` keeps the reference's historical meaning here: the K/V
    growth budget past the prompt (``ServeEngine.max_len`` is a slot's
    total capacity)."""

    def __init__(self, c: ModelConfig, params: Params, *,
                 max_len: int = 256, device: DeviceLike = None):
        self.c, self.params, self.max_len = c, params, max_len
        self.engine = ServeEngine(c, params, n_slots=1, max_len=max_len,
                                  device=device)

    def generate(self, tokens, n_steps: int,
                 extras: Optional[dict] = None) -> GenerationResult:
        return self.engine.generate(tokens, n_steps, extras,
                                    gen_budget=self.max_len)
