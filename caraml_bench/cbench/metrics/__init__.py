"""Per-layer metrics: one reader a metric, ``read(ctx) -> float | None``
(``ctx``: ``cbench.runner.Context``). A reader that finds nothing to
read returns None, and the run leaves that metric out of its line."""
