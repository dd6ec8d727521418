"""Power measurement of the port (``src/repro/power``)."""
