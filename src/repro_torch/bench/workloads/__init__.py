"""The port's workloads, registered on import.

Port of ``src/repro/bench/workloads/__init__.py``. Importing this package
populates the WorkloadSpec registry; the modules stay side-effect-free
beyond registration (no device access, no kernel build at import time).
"""
from repro_torch.bench.workloads import kernels  # noqa: F401 - registration
from repro_torch.bench.workloads import llm_train  # noqa: F401 - registration
from repro_torch.bench.workloads import resilience  # noqa: F401 - registration
from repro_torch.bench.workloads import resnet50  # noqa: F401 - registration
from repro_torch.bench.workloads import serve  # noqa: F401 - registration
from repro_torch.bench.workloads import serve_slo  # noqa: F401 - registration
