"""The port's workloads, registered on import.

Port of ``src/repro/bench/workloads/__init__.py``. Importing this package
populates the WorkloadSpec registry; the modules stay side-effect-free
beyond registration (no device access, no kernel build at import time).
"""
from repro_torch.bench.workloads import kernels  # noqa: F401 - registration
