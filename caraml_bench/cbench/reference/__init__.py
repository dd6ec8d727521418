"""Plain PyTorch references of the benchmark's models, in float32.

They import only ``torch`` and each other, never the program, and take
nothing the program made: the harness regenerates the weights and the
batches from the seed and hands the same to both sides. ``lowp`` holds
the products they run through (float32, or fp8 for the control), and
``adamw.follow`` trains a reference for the steps the check compares.
"""
