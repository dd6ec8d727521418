"""Training: loss, optimizers, the train step and the loop (port of
``src/repro/train``)."""
