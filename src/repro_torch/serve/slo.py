"""SLO evaluation: goodput, latency quantiles, Wh-per-SLO-met-request.

Copy of ``src/repro/serve/slo.py`` (framework-neutral; the port keeps
its own copy so that it imports nothing of ``repro``).

The MLPerf-Power framing (PAPERS.md, arXiv:2410.12032): at scale, the
figure of merit is energy per *useful* unit of work — and "useful" for
a serving stack means the request met its latency SLO. This module turns
the engine's per-request latency record (``RequestResult``: TTFT from
arrival, TPOT over the decode phase) plus per-tenant SLO targets into

  goodput              fraction of requests meeting BOTH targets
  ttft_p50 / ttft_p99  TTFT quantiles (includes queueing delay)
  tpot_p50 / tpot_p99  TPOT quantiles (steady-state decode latency)
  wh_per_slo_request   attributed energy / SLO-met requests — the
                       energy-per-useful-inference metric; ``inf`` when
                       nothing met (all energy, zero useful work)

A request meets its SLO when ``ttft_s <= slo.ttft_s`` AND
``tpot_s <= slo.tpot_s`` — boundary equality counts as met (a target is
a budget, and landing exactly on budget is within it). Per-tenant
targets come from a ``{tenant: SLO}`` map with a default fallback;
per-tenant sub-reports ride along for the workload's result columns.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence, Union

from repro_torch.core.metrics import percentile


@dataclass(frozen=True)
class SLO:
    """Latency targets for one tenant (seconds). Requests meet the SLO
    when TTFT and TPOT are both at-or-under target."""

    ttft_s: float
    tpot_s: float

    def met_by(self, result) -> bool:
        # a shed (or otherwise tokenless) request delivered nothing —
        # it can never meet the SLO, whatever its timestamps say
        if result.finish_reason == "shed" or result.n_tokens == 0:
            return False
        return (result.ttft_s <= self.ttft_s
                and result.tpot_s <= self.tpot_s)


@dataclass
class SLOReport:
    """Aggregate (or per-tenant) SLO outcome over one serve run."""

    n_requests: int
    n_met: int
    ttft_p50_s: float
    ttft_p99_s: float
    tpot_p50_s: float
    tpot_p99_s: float
    energy_wh: float
    per_tenant: dict = field(default_factory=dict)   # name -> SLOReport

    @property
    def goodput(self) -> float:
        """Fraction of requests meeting their SLO (0.0 for an empty
        run: no requests served means no useful work delivered)."""
        return self.n_met / self.n_requests if self.n_requests else 0.0

    @property
    def wh_per_slo_request(self) -> float:
        """Energy per SLO-met request. ``inf`` when energy was spent
        but nothing met the SLO — the honest 'all cost, no useful work'
        signal; 0.0 only when there was no energy either."""
        if self.n_met:
            return self.energy_wh / self.n_met
        return float("inf") if self.energy_wh > 0 else 0.0


SLOTargets = Union[SLO, Mapping[str, SLO]]


def _slo_for(targets: SLOTargets, tenant: str, default: Optional[SLO]) -> SLO:
    if isinstance(targets, SLO):
        return targets
    slo = targets.get(tenant, default)
    assert slo is not None, (
        f"no SLO for tenant {tenant!r} and no default given")
    return slo


def _report(results, met_flags, energy_wh: float) -> SLOReport:
    # latency quantiles cover SERVED requests only: a shed request has
    # no first token, so its "TTFT" is a meaningless negative number
    # that would drag the percentiles. It still counts in n_requests
    # (and therefore against goodput) — shedding is not free.
    served = [r for r in results if r.n_tokens > 0]
    ttfts = [r.ttft_s for r in served]
    tpots = [r.tpot_s for r in served]
    return SLOReport(
        n_requests=len(results),
        n_met=sum(met_flags),
        ttft_p50_s=percentile(ttfts, 50.0),
        ttft_p99_s=percentile(ttfts, 99.0),
        tpot_p50_s=percentile(tpots, 50.0),
        tpot_p99_s=percentile(tpots, 99.0),
        energy_wh=energy_wh,
    )


def evaluate_slo(results: Sequence, targets: SLOTargets, *,
                 default: Optional[SLO] = None,
                 total_energy_wh: Optional[float] = None) -> SLOReport:
    """Score a serve run's results against (per-tenant) SLO targets.

    ``targets`` is either one :class:`SLO` for every request or a
    ``{tenant: SLO}`` map (``default`` catches unmapped tenants).
    ``total_energy_wh`` overrides the energy numerator (e.g. run-total
    including idle overhead); the default is the sum of per-request
    attributed energies — the marginal-cost view matching
    ``ServeSummary.wh_per_request``. Per-tenant energy always uses each
    tenant's own attributed sum.
    """
    results = list(results)
    met = [_slo_for(targets, r.tenant, default).met_by(r) for r in results]
    energy = (sum(r.energy_wh for r in results)
              if total_energy_wh is None else float(total_energy_wh))
    report = _report(results, met, energy)
    tenants = sorted({r.tenant for r in results})
    for name in tenants:
        sub = [(r, m) for r, m in zip(results, met) if r.tenant == name]
        report.per_tenant[name] = _report(
            [r for r, _ in sub], [m for _, m in sub],
            sum(r.energy_wh for r, _ in sub))
    return report
