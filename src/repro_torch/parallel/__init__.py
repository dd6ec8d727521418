"""Sharding rules, ZeRO-1 slices, gradient synchronisation and
compression, and the pipeline, across ``torch.distributed`` ranks (port
of ``src/repro/parallel``; ``compat.py``, a ``shard_map`` shim, has no
analog)."""
