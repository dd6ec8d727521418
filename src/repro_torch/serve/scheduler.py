"""Continuous-batching scheduler: queue, slot admission, refill, early exit.

Copy of ``src/repro/serve/scheduler.py`` (framework-neutral; the port
keeps its own copy so that it imports nothing of ``repro``).

Pure host-side bookkeeping — no device work. The engine owns the device work; the
scheduler owns WHICH request sits in WHICH batch slot at every decode
step. The model of operation (Orca/vLLM-style iteration-level scheduling,
reduced to fixed slots):

  * a fixed pool of ``n_slots`` batch slots, each backed by one KV-cache
    row of capacity ``max_len`` tokens (prompt + generated);
  * arriving requests queue FIFO; ``refill(now)`` admits arrived requests
    into free slots *between* decode steps (admission = one prefill);
  * every decode step advances all active slots by one token;
  * a slot frees as soon as its request hits EOS or its token budget
    ("early exit"), and is refilled from the queue before the next step —
    finished requests never occupy batch rows.

Two policies share this class:

  ``continuous`` — refill whenever a slot is free (the tentpole);
  ``fixed``      — admit only when ALL slots are idle, i.e. classic
                   fixed-batch serving with a batch-fill barrier; used as
                   the benchmark baseline.
"""
from __future__ import annotations

import bisect
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.serve.requests import Request


@dataclass
class Slot:
    """One batch row: its request and per-slot position/length state."""

    index: int
    request: Optional[Request] = None
    pos: int = 0          # next KV write position == tokens in the row
    generated: int = 0
    last_token: int = 0   # input token for the next decode step
    #: prompt tokens prefilled so far. The phased scheduler prefills the
    #: whole prompt at admission (``refill`` sets this to ``prompt_len``
    #: immediately); the chunked engine resets it to the prefix-match
    #: depth and advances it one ``chunk_tokens`` slice per iteration —
    #: a slot decodes only once the prompt is fully prefilled.
    prefill_pos: int = 0
    #: preemption-resume replay: previously-emitted prompt-tail tokens
    #: still to feed through the DECODE program as forced inputs (their
    #: logits are discarded except the last, which continues the
    #: stream). Prefill numerics are not bit-equal to decode's, so the
    #: emitted tail must be rebuilt by the same program that built it.
    replay: int = 0

    @property
    def active(self) -> bool:
        return self.request is not None

    @property
    def prefill_target(self) -> int:
        """Where chunked prefill stops: the ORIGINAL prompt. A resume
        request's trailing ``n_replay`` emitted tokens rebuild their KV
        via decode replay instead."""
        return self.request.prompt_len - self.request.n_replay

    @property
    def prefilling(self) -> bool:
        """Mid-chunked-prefill: admitted but the prefillable prompt
        region isn't fully in cache yet — the slot must not take decode
        steps."""
        return (self.request is not None
                and self.prefill_pos < self.prefill_target)

    @property
    def decoding(self) -> bool:
        return self.request is not None and not self.prefilling


@dataclass
class StepRecord:
    """One engine step window (prefill or decode) for energy attribution.

    ``rids`` are the request ids credited with tokens in this window,
    one entry per token: a decode window covering ``n_steps`` fused
    micro-steps lists every active slot's rid ``n_steps`` times, a
    (batched) prefill window lists each admitted request once. Energy
    integrated over the window splits equally across the entries
    (``core.metrics.attribute_energy``), so per-request attribution
    stays exact under both batched prefill and fused decode runs.

    ``n_steps`` is the number of decode micro-steps the window fused
    (1 for prefill and legacy single-step decode) — the denominator for
    per-step occupancy: ``n_tokens / (n_steps * n_slots)``.
    """

    kind: str             # "prefill" | "decode"
    t0: float
    t1: float
    rids: tuple
    n_tokens: int
    n_steps: int = 1

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


class Scheduler:
    """Slot admission / refill / early-exit state machine."""

    def __init__(self, n_slots: int, max_len: int, *,
                 policy: str = "continuous"):
        assert policy in ("continuous", "fixed"), policy
        self.n_slots = n_slots
        self.max_len = max_len
        self.policy = policy
        self.slots = [Slot(i) for i in range(n_slots)]
        self.queue: deque[Request] = deque()
        self._arrivals: list[Request] = []   # not yet arrived (future)

    # -- submission ------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Register a request; it becomes admissible once now >= arrival.

        ``_arrivals`` is kept sorted by insertion point (``insort_right``
        keyed on ``arrival_s``) — re-sorting the whole list per submit
        was O(n^2 log n) over an n-request trace. Right-insertion keeps
        submission order among equal-arrival ties, so FIFO service is
        stable however the trace was built.
        """
        cap = req.prompt_len + req.max_new_tokens
        assert cap <= self.max_len, (
            f"request {req.rid} needs {cap} cache rows > max_len "
            f"{self.max_len}")
        bisect.insort_right(self._arrivals, req,
                            key=lambda r: r.arrival_s)

    def _absorb_arrivals(self, now: float) -> None:
        idx = 0
        while idx < len(self._arrivals) \
                and self._arrivals[idx].arrival_s <= now:
            idx += 1
        if idx:
            self.queue.extend(self._arrivals[:idx])
            del self._arrivals[:idx]

    def next_arrival_s(self) -> Optional[float]:
        return self._arrivals[0].arrival_s if self._arrivals else None

    # -- admission -------------------------------------------------------
    def refill(self, now: float) -> list[Slot]:
        """Admit arrived+queued requests into free slots (FIFO).

        Returns the newly-filled slots; the engine prefills each. Under
        the ``fixed`` policy admission waits for the batch to fully drain
        (the classic fixed-batch barrier the benchmark measures against).
        """
        self._absorb_arrivals(now)
        if self.policy == "fixed":
            if any(s.active for s in self.slots):
                return []
            # batch-fill barrier: when more requests are still arriving,
            # wait until a FULL batch is queued (the strongest fixed-batch
            # baseline — admitting partial batches would only flatter the
            # continuous policy in the benchmark comparison)
            if self._arrivals and len(self.queue) < self.n_slots:
                return []
        admitted = []
        for slot in self.slots:
            if not self.queue:
                break
            if slot.active:
                continue
            req = self.queue.popleft()
            slot.request = req
            slot.pos = req.prompt_len     # prefill fills rows [0, len)
            slot.generated = 0
            slot.last_token = 0
            # phased default: the whole prompt prefills at admission.
            # The chunked engine rewinds this to the prefix-match depth
            # and advances chunk by chunk.
            slot.prefill_pos = req.prompt_len
            admitted.append(slot)
        return admitted

    # -- step bookkeeping ------------------------------------------------
    def active_slots(self) -> list[Slot]:
        return [s for s in self.slots if s.active]

    def decode_slots(self) -> list[Slot]:
        """Slots eligible for a decode step: active AND fully prefilled
        (mid-chunk slots ride along idle until their prompt lands)."""
        return [s for s in self.slots if s.decoding]

    def record_token(self, slot: Slot, token: int) -> Optional[str]:
        """Account one generated token for ``slot``.

        Returns a finish reason ("eos" | "length") and frees the slot if
        the request completed, else None. EOS counts as a generated
        token (it is the model's output) but stops the request early.

        Position invariant: token ``g`` (1-indexed, g=1 from prefill) is
        the *input* of decode step ``g`` and gets written to cache row
        ``prompt_len + g - 1``; so after recording token g the slot's
        next write position is ``prompt_len + g - 1``.
        """
        req = slot.request
        assert req is not None
        slot.generated += 1
        slot.last_token = int(token)
        slot.pos = req.prompt_len + slot.generated - 1
        if req.eos_id is not None and int(token) == req.eos_id:
            self._free(slot)
            return "eos"
        if slot.generated >= req.max_new_tokens:
            self._free(slot)
            return "length"
        if slot.pos >= self.max_len:   # cache row exhausted (defensive)
            self._free(slot)
            return "length"
        return None

    def _free(self, slot: Slot) -> None:
        slot.request = None
        slot.generated = 0
        slot.prefill_pos = 0
        slot.replay = 0

    def preempt(self, slot: Slot, tokens) -> Request:
        """Evict a RUNNING request from its slot, to be resumed later by
        recompute-from-prompt: the resume request's prompt is the
        original prompt plus every token already emitted (``tokens`` is
        the engine's result stream for this rid), its budget is the
        remaining budget, and it re-enters the queue FRONT so eviction
        never reorders service. The original-prompt region prefills
        again; the emitted tail (``n_replay``) is instead REPLAYED
        through the decode program (the program that first produced its
        KV — see ``Request.n_replay``), whose last replay logits ARE
        the next token: the resumed stream continues bit-identically
        and already-emitted tokens are never re-emitted.

        The caller (the engine) reclaims the slot's cache blocks; this
        method owns only the scheduler state. Works mid-chunked-prefill
        too: nothing was emitted yet, so the resume request is simply
        the original one.
        """
        req = slot.request
        assert req is not None, f"preempting idle slot {slot.index}"
        remaining = req.max_new_tokens - slot.generated
        assert remaining >= 1, (
            "a slot with exhausted budget frees, never preempts")
        if slot.generated:
            emitted = [int(t) for t in tokens[-slot.generated:]]
            prompt = np.concatenate([
                np.asarray(req.prompt, np.int32),
                np.asarray(emitted, np.int32)])
        else:
            prompt = req.prompt
        resume = Request(rid=req.rid, prompt=prompt,
                         max_new_tokens=remaining,
                         arrival_s=req.arrival_s, eos_id=req.eos_id,
                         tenant=req.tenant, resumed=True,
                         # a re-preempted resume replays its WHOLE
                         # emitted history, not just this admission's
                         n_replay=req.n_replay + slot.generated)
        self._free(slot)
        self.queue.appendleft(resume)
        return resume

    # -- graceful degradation (shedding) --------------------------------
    def shed_expired(self, now: float) -> list[Request]:
        """Remove queued requests whose admission deadline has passed
        (``now - arrival_s > deadline_s``). Only never-admitted, fresh
        requests are sheddable: a preemption-resume already received
        service and must complete (FIFO-degradation invariant). Returns
        the shed requests, queue order."""
        if not self.queue:
            return []
        shed: list[Request] = []
        kept: deque[Request] = deque()
        for r in self.queue:
            if (not r.resumed and r.deadline_s is not None
                    and now - r.arrival_s > r.deadline_s):
                shed.append(r)
            else:
                kept.append(r)
        self.queue = kept
        return shed

    def shed_newest(self, cap: int) -> list[Request]:
        """Overload response: pop queued requests from the BACK (newest
        arrivals) until the queue fits ``cap``. The front of the queue —
        the oldest request, and any preemption-resumes parked there — is
        never shed, so under overload service degrades newest-first and
        the oldest request always completes (the FIFO-degradation
        invariant, extended to admission control). Returns the shed
        requests, newest first."""
        shed: list[Request] = []
        floor = max(1, int(cap))
        while len(self.queue) > floor:
            if self.queue[-1].resumed:
                break   # resumed work is never shed
            shed.append(self.queue.pop())
        return shed

    def unadmit(self, slot: Slot) -> Request:
        """Return a just-admitted (not yet prefilled) request to the
        FRONT of the queue and free its slot — the engine's admission-
        control hook for a cache pool that cannot reserve the request's
        worst-case footprint yet. Unadmit in reverse admission order to
        preserve FIFO."""
        req = slot.request
        assert req is not None and slot.generated == 0, (
            "unadmit is only valid before the first token")
        self._free(slot)
        self.queue.appendleft(req)
        return req

    # -- batched views for the decode step -------------------------------
    def input_tokens(self) -> np.ndarray:
        """(n_slots,) int32 — each slot's next input token (0 if idle).

        All three step views key on ``decoding``, not ``active``: a slot
        mid-chunked-prefill has no last token yet and must ride through
        the decode step as an idle row (its dead write lands at the
        parked position / the paged trash block).
        """
        return np.asarray([s.last_token if s.decoding else 0
                           for s in self.slots], np.int32)

    def positions(self) -> np.ndarray:
        """(n_slots,) int32 — per-slot KV write position.

        Idle (and mid-prefill) slots report ``max_len - 1``: a valid
        in-bounds row whose write is harmless (the row is dead until the
        next prefill overwrites it; a mid-prefill paged slot's unowned
        table columns point at the trash block) — keeps the jitted
        decode free of masking.
        """
        return np.asarray([s.pos if s.decoding else self.max_len - 1
                           for s in self.slots], np.int32)

    def active_mask(self) -> np.ndarray:
        return np.asarray([s.decoding for s in self.slots], bool)

    # -- run state -------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return (bool(self.queue) or bool(self._arrivals)
                or any(s.active for s in self.slots))

    @property
    def n_pending(self) -> int:
        return len(self.queue) + len(self._arrivals)
