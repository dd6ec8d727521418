"""Run one cell of the port's benchmark once and print one JSON line.

    python3 caraml_bench/run.py --workload <cell> --seed <n> \
        --seconds <window> --trace <0|1>

from the root of a checkout. The program is ``repro_torch`` under
``src/``. With ``--trace 0`` the line holds the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, the device's busy
seconds and a breakdown. The numbers that decide ``correct`` are
printed as the last lines of standard error and under ``checks``, the
line's last key. Without a card (or with fewer than the cell asks
for), without the program, or with JAX loaded, the run exits non-zero
and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT / "src"))
# build and kernel caches at fixed paths inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(HERE / ".cache" / _sub)


def _finite(x):
    """``x`` with every non-finite float made None (JSON has no NaN)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from cbench import chip, runner, spec
    cell = spec.find_cell(spec.load_benchmark(), args.workload)
    try:
        chip.require_cards(cell.chips)
    except chip.NoCard as e:
        print(f"[run] {e}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the program must be there)
    counter = chip.NvmlCounter(chip.cuda_uuid(0))
    kind = torch.cuda.get_device_name(0)
    print(f"[run] {kind}, power limit {counter.power_limit_w():.2f} W, "
          f"torch {torch.__version__}", file=sys.stderr)
    try:
        out = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                         device=torch.device("cuda", 0), counter=counter,
                         kind=kind, t_start=T_START,
                         log=lambda s: print(s, file=sys.stderr))
    finally:
        counter.close()
    bad = runner.forbidden_modules()      # the window has closed
    if bad:
        print("[run] JAX or the JAX package was loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    out = _finite(out)
    print(f"[run] {time.perf_counter() - T_START:.1f} s in all",
          file=sys.stderr)
    if any(v is None for c in out["checks"].values() for v in c.values()):
        out["correct"] = False
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
