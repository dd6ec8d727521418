"""Serving request/result records with per-request latency accounting.

Copy of ``src/repro/serve/requests.py`` (framework-neutral; the port
keeps its own copy so that it imports nothing of ``repro``).

The MLPerf-Power observation (PAPERS.md, arXiv:2410.12032) is that the
metric that matters at scale is energy per *served inference* under a
realistic arrival process — not fixed-batch peak throughput. These records
carry everything needed to compute it: arrival/admission/first-token/
finish timestamps per request, and the energy attributed to the request
by :func:`repro_torch.core.metrics.attribute_energy`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.data.synthetic import synthetic_tokens

J_PER_WH = 3600.0


@dataclass
class Request:
    """One generation request entering the serve queue.

    ``arrival_s`` is relative to the engine run start (the engine offsets
    it by its clock at run begin); requests with ``arrival_s`` in the
    future stay queued until the (possibly fake) clock reaches them —
    this is how the benchmark injects Poisson arrivals.
    """

    rid: int
    prompt: np.ndarray                  # (prompt_len,) int32 token ids
    max_new_tokens: int
    arrival_s: float = 0.0
    eos_id: Optional[int] = None        # None -> run to max_new_tokens
    tenant: str = ""                    # multi-tenant traces (serve.traffic)
    #: admission deadline, seconds after arrival: a request still queued
    #: (never admitted) past it is SHED by the engine rather than served
    #: hopelessly late — it finishes with reason "shed", zero tokens,
    #: and counts against goodput. None disables the timeout.
    deadline_s: Optional[float] = None
    #: True for a preemption-resume request (``Scheduler.preempt``): the
    #: prompt already contains previously-emitted tokens, so the engine
    #: must append its prefill token to the existing result stream
    #: without resetting the admission/first-token timestamps.
    resumed: bool = False
    #: how many trailing prompt tokens are previously-EMITTED tokens
    #: (0 for fresh requests). The engine prefills only the original
    #: prompt (``prompt_len - n_replay`` tokens) and REPLAYS the tail
    #: through the decode program — the emitted tokens were produced by
    #: decode steps, and prefill's attention numerics are not bit-equal
    #: to decode's, so recomputing them via prefill would let low-bit KV
    #: drift flip a downstream argmax. Replay keeps the resumed stream
    #: bit-identical to the never-preempted one by construction.
    n_replay: int = 0

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.prompt).shape[-1])


@dataclass
class RequestResult:
    """Per-request serving outcome: tokens + latency + energy."""

    rid: int
    prompt_len: int
    tokens: list = field(default_factory=list)   # generated token ids
    arrival_s: float = 0.0
    admitted_s: float = 0.0             # slot admission (prefill start)
    first_token_s: float = 0.0          # end of prefill = first token
    finish_s: float = 0.0
    finish_reason: str = ""             # "eos" | "length" | "shed"
    slot: int = -1
    energy_wh: float = 0.0              # attributed by core.metrics
    tenant: str = ""                    # copied from the request

    # -- latency figures of merit ---------------------------------------
    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    @property
    def ttft_s(self) -> float:
        """Time to first token, from arrival (includes queueing delay)."""
        return self.first_token_s - self.arrival_s

    @property
    def queue_s(self) -> float:
        return self.admitted_s - self.arrival_s

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s

    @property
    def tpot_s(self) -> float:
        """Time per output token over the decode phase (TPOT): the
        steady-state inter-token latency after the first token. 0.0 for
        single-token results (no decode phase to time)."""
        if self.n_tokens <= 1:
            return 0.0
        return (self.finish_s - self.first_token_s) / (self.n_tokens - 1)

    @property
    def decode_tok_s(self) -> float:
        """Steady-state decode rate (excludes queueing and prefill)."""
        gen_window = self.finish_s - self.first_token_s
        if self.n_tokens <= 1 or gen_window <= 0:
            return 0.0
        return (self.n_tokens - 1) / gen_window

    # -- energy figures of merit ----------------------------------------
    @property
    def wh_per_token(self) -> float:
        return self.energy_wh / self.n_tokens if self.n_tokens else 0.0

    @property
    def tokens_per_wh(self) -> float:
        return self.n_tokens / self.energy_wh if self.energy_wh > 0 else 0.0


def exponential_arrivals(rng: np.random.Generator, n: int,
                         rate_hz: float) -> np.ndarray:
    """Seeded Poisson arrival times: exponential inter-arrival gaps at
    ``rate_hz``, shifted so the first request arrives at t=0. The single
    arrival-process primitive shared by :func:`poisson_requests` and the
    multi-tenant trace generator (``serve.traffic``) — it consumes
    exactly ``n`` exponential draws from ``rng``, so the legacy
    ``poisson_requests`` stream is bit-identical to before the split."""
    gaps = rng.exponential(1.0 / rate_hz, size=n)
    return np.cumsum(gaps) - gaps[0]


def poisson_requests(n: int, rate_hz: float, vocab: int, *,
                     prompt_len: int = 8, seed: int = 0,
                     short: tuple[int, int] = (2, 8),
                     long: tuple[int, int] = (64, 88),
                     p_long: float = 0.25) -> list[Request]:
    """Seeded synthetic request stream shared by the serve benchmark and
    the serving CLI: exponential inter-arrival gaps (Poisson process) and
    a bimodal short/long token-budget mix — the realistic serving load
    (mostly short answers, a tail of long generations) that iteration-level
    refill monetizes against a batch-fill barrier.
    """
    rng = np.random.default_rng(seed)
    prompts = synthetic_tokens(n, prompt_len, vocab, seed)[:, :prompt_len]
    arrivals = exponential_arrivals(rng, n, rate_hz)
    is_long = rng.random(n) < p_long
    budgets = np.where(is_long,
                       rng.integers(long[0], long[1] + 1, size=n),
                       rng.integers(short[0], short[1] + 1, size=n))
    return [Request(rid=i, prompt=prompts[i], max_new_tokens=int(budgets[i]),
                    arrival_s=float(arrivals[i])) for i in range(n)]
