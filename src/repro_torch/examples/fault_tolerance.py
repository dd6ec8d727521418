"""Fault-tolerance demo: a seeded fault schedule crashes training mid-run,
the bounded-restart supervisor backs off and auto-resumes from the newest
valid atomic checkpoint, and an elastic rescale is planned after losing
devices — a thin script over the ``repro_torch.faults`` subsystem,
recorded as a WorkloadSpec through the bench runner (one ResultRecord
with crash/resume/rescale metrics under ``artifacts/examples_torch/``).

Port of ``examples/fault_tolerance.py``: its workload, steps, sizes and
asserts. The spec is run directly, not registered, so importing this
module leaves the bench CLI's registry as it is.

  PYTHONPATH=src python -m repro_torch.examples.fault_tolerance
  PYTHONPATH=src python -m repro_torch.examples.fault_tolerance --device cpu
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.bench import WorkloadRunner, WorkloadSpec
from repro_torch.bench.spec import Placement
from repro_torch.ckpt.elastic import plan_rescale
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import Space
from repro_torch.device import resolve_device
from repro_torch.faults.schedule import FaultSchedule
from repro_torch.launch.train import main as train_main

STEPS = 30


def build(pt, ctx):
    """Supervised crash/resume train + elastic rescale plan."""
    preset = pt["fault_preset"]

    def supervised():
        faults = FaultSchedule.from_preset(preset, seed=0, total_steps=STEPS)
        print(f"== 1. train under fault schedule {faults!r}")
        print("   (the supervisor catches the crash, backs off, and "
              "resumes from the newest valid checkpoint)")
        with tempfile.TemporaryDirectory() as ckpt:
            res = train_main(["--arch", "gpt-117m", "--preset", "tiny",
                              "--steps", str(STEPS), "--global-batch", "4",
                              "--seq-len", "64", "--ckpt-dir", ckpt,
                              "--ckpt-every", "10",
                              "--fault-preset", preset, "--fault-seed", "0",
                              "--device", str(ctx.device)])
        assert res.final_step == STEPS, res
        assert res.resumed_from is not None, "run never crashed/resumed"
        return {"schedule_hash": faults.schedule_hash,
                "resumed_from": res.resumed_from,
                "final_step": res.final_step}

    def rescale():
        print("== 2. elastic rescale plan after losing 32 chips of a "
              "256-pod")
        c = get_config("granite-8b")
        plan = plan_rescale(c, SHAPES["train_4k"],
                            Placement.of({"dp": 16, "tp": 16}),
                            lost_devices=32)
        print(f"   {plan.old_shape} -> {plan.new_shape} ({plan.note})")
        print("   checkpoints are mesh-agnostic: whole leaves on disk, "
              "which a restore cuts into the new mesh's shards")
        return {"rescale_ok": 1}

    return {"supervised": supervised, "rescale": rescale}


SPEC = WorkloadSpec(
    name="fault_tolerance",
    analog="example: fault schedule -> supervised resume -> elastic rescale",
    space=Space({"fault_preset": ["crash_mid"]}), build=build,
    tags=frozenset({"example"}),
    result_columns=["fault_preset", "schedule_hash", "resumed_from",
                    "final_step", "rescale_ok"],
    primary_metric="final_step",
    description="Supervised crash/resume train + elastic rescale plan.")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default="artifacts/examples_torch")
    args = ap.parse_args(argv)
    runner = WorkloadRunner(SPEC, device=resolve_device(args.device),
                            out_dir=args.out, power="none")
    records = runner.run(verbose=False)
    print("\n== recorded ==")
    print(runner.result_table())
    assert all(r.ok for r in records), [r.error for r in records]
    return records


if __name__ == "__main__":
    main()
