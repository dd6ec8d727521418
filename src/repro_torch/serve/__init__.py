"""Serving of the port (``src/repro/serve``): paged KV cache, scheduler,
engine."""
