"""Model stack of the port (``src/repro/models``): the dense, moe, ssm and
hybrid decoder families, and ResNet50."""
