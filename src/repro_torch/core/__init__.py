"""Figures of merit of the port (``src/repro/core``)."""
