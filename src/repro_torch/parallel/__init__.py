"""Gradient synchronisation and compression (port of
``src/repro/parallel``; the one-device part)."""
