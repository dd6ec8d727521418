"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

A run trains one cell of ``BENCHMARK.json`` for a fixed window on one
card and prints one JSON line. Everything that belongs to one model
kind, traffic mix or per-layer metric lives in a file of its own that
the harness finds by name (``spec``):

  * ``configs/<name>.json``, ``traffic/<name>.json``,
    ``limits/<cell>.json``: data;
  * ``cbench/models/<arch>.py``: the glue to the port's entry points;
  * ``cbench/work/<arch>.py``: operations and bytes from the shapes;
  * ``cbench/reference/<arch>.py``: the plain fp32 reference;
  * ``cbench/metrics/<metric>.py``: one reader per per-layer metric.
"""
