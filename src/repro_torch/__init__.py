"""PyTorch + CUDA port of the ``repro`` package (JAX + Pallas).

Module paths mirror the reference: ``repro_torch/models/attention.py``
ports ``repro/models/attention.py`` and so on; each module's docstring
names its reference file. The port imports ``torch``, ``numpy`` and the
standard library only — never JAX and never ``repro``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""
