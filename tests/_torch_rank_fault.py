"""A dp2 workload whose rank 1 raises at its second point.

Importing the module registers ``rank_fault``; the bench runner's ranks
import it by the spec's module, as they do the registry's workloads
(``tests/test_torch_parallel_bench.py``)."""
import torch
import torch.distributed as dist

from repro_torch.bench.spec import workload
from repro_torch.core.params import Space


@workload("rank_fault", analog="test", space=Space(
    {"placement": ["dp2"], "x": [0, 1]}))
def build(pt, ctx):
    group = ctx.mesh().group("data")

    def step():
        if pt["x"] == 1 and dist.get_rank() == 1:
            raise ValueError("injected fault on rank 1")
        t = torch.ones(1)
        dist.all_reduce(t, group=group)
        return {"sum": float(t)}

    return {"step": step}
