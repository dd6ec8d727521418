"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 caraml_bench/control.py --workload <cell> --seeds 1,2,...,12 \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--out file.jsonl]

For each seed, in one process on the card and at the cell's own sizes:
the program's sound readings (its first steps against the float32
reference, as every run checks them); on ``--control-seeds`` the
control, the reference put in the program's place and computed in fp8
(``cbench.reference.lowp``), against the float32 reference; on
``--fault-seeds`` the fault of half the batch left out (the mean over
the rest), planted in the reference put in the program's place. A
step that returns its state unchanged reads 1 in ``grad_gap`` and
``change_gap`` by their definition and needs no run. One JSON line per
reading. The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))


def _detail(got, ref, n=6) -> dict:
    """The leaves that read worst, with both norms, and each step's loss
    gap."""
    from cbench import check
    out = {}
    for key, keep in (("grad", list(ref["grad"])),
                      ("change", check.moved(ref))):
        per = check.leaf_gaps(got[key], ref[key], keep)
        worst = sorted(per, key=per.get, reverse=True)[:n]
        out[key + "_worst"] = [[w, per[w], got[key][w], ref[key][w]]
                               for w in worst]
    out["loss_step_gaps"] = [abs(a - b) / abs(b) for a, b in
                             zip(got["losses"], ref["losses"])]
    return out


def readings(cell, seeds, control_seeds, fault_seeds, device, emit,
             look_seeds=(), vectors=False):
    """Emit ``{"seed", "kind", <gaps>}`` for every reading asked for."""
    from cbench import check, runner, spec, weights
    from cbench.traffic import Feed
    models = spec.arch_module("models", cell.arch)
    specs = models.leaf_specs(cell.config)
    for seed in seeds:
        t0 = time.perf_counter()
        named = weights.make(specs, seed, device, runner.param_dtype(cell))
        prog = models.Program(cell.config, cell.traffic, named, device)
        got = runner.program_readings(
            prog, Feed(cell.traffic, cell.config, seed, device), specs,
            cell, seed, device, vectors=vectors)
        del prog, named
        runner.free(device)
        ref = runner.reference_readings(cell, seed, device,
                                         vectors=vectors)
        emit({"seed": seed, "kind": "program", **check.gaps(got, ref), **_detail(got, ref),
              "losses": got["losses"], "ref_losses": ref["losses"],
              "seconds": time.perf_counter() - t0})
        if seed in control_seeds:
            low = runner.reference_readings(cell, seed, device, "fp8",
                                             vectors=vectors)
            emit({"seed": seed, "kind": "control_fp8",
                  **check.gaps(low, ref), **_detail(low, ref), "losses": low["losses"]})
        if seed in fault_seeds:
            half = runner.reference_readings(cell, seed, device,
                                             half_batch=True,
                                             vectors=vectors)
            emit({"seed": seed, "kind": "fault_half_batch",
                  **check.gaps(half, ref), **_detail(half, ref), "losses": half["losses"]})
        if seed in fault_seeds:
            still = runner.reference_readings(cell, seed, device,
                                              vectors=vectors, frozen=True)
            emit({"seed": seed, "kind": "fault_unchanged",
                  **check.gaps(still, ref), "losses": still["losses"]})
        if seed in look_seeds:
            again = runner.reference_readings(cell, seed, device,
                                              vectors=vectors)
            emit({"seed": seed, "kind": "fp32_again",
                  **check.gaps(again, ref), **_detail(again, ref)})
            for eps in (1e-6, 1e-3):
                nudged = runner.reference_readings(
                    cell, seed, device, nudge=eps, vectors=vectors)
                emit({"seed": seed, "kind": f"fp32_nudged_{eps:g}",
                      **check.gaps(nudged, ref), **_detail(nudged, ref)})
        runner.free(device)


def _ints(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--look-seeds", type=_ints, default=[])
    ap.add_argument("--vectors", action="store_true",
                    help="also compare the first gradients and the changes "
                         "element by element (host memory)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from cbench import chip, spec
    cell = spec.find_cell(spec.load_benchmark(), args.workload)
    chip.require_cards(cell.chips)
    print(f"[control] {torch.cuda.get_device_name(0)}", file=sys.stderr)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(dict(rec, workload=cell.name))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        readings(cell, args.seeds, set(args.control_seeds),
                 set(args.fault_seeds), torch.device("cuda", 0), emit,
                 set(args.look_seeds), args.vectors)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
