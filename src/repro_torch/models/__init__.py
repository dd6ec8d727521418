"""Model stack of the port (``src/repro/models``), dense family."""
