"""CARAML core of the port (``src/repro/core``): the benchmark harness
(JUBE analog) with jpwr-style energy measurement. Substrate subsystems
live in sibling subpackages."""
from repro_torch.core.metrics import (
    Throughput, images_per_s, mfu, tokens_per_s,
)
from repro_torch.core.params import Space, batch_at_least_dp, divisible_batch
from repro_torch.core.results import heatmap, save_results, table
from repro_torch.core.runner import Runner, StragglerWatchdog
from repro_torch.core.suite import BenchmarkSuite, Step

__all__ = [
    "Throughput", "images_per_s", "mfu", "tokens_per_s", "Space",
    "batch_at_least_dp", "divisible_batch", "heatmap", "save_results",
    "table", "Runner", "StragglerWatchdog", "BenchmarkSuite", "Step",
]
