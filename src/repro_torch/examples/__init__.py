"""The repo's four examples on the port (``examples/*.py``), each run as

  PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

``quickstart`` (the data pipeline into a checkpointed train loop with an
energy reading), ``fault_tolerance`` (a supervised crash and resume and
an elastic rescale plan, recorded through the bench runner),
``llm_sweep`` (a global batch x microbatch sweep and its heatmap) and
``serve_decode`` (dense, SSM and MoE through ``BatchedServer``). Each
keeps its reference's steps, sizes and asserts and runs on the card
unless ``--device cpu`` is given.
"""
