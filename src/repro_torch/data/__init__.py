"""Synthetic data of the port (``src/repro/data``)."""
