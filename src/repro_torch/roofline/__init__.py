"""Roofline analysis of the dry run's counts (``src/repro/roofline``)."""
