"""What decides ``correct``: the program's first training steps against
the plain reference's, from the same weights and batches.

Both sides give, for the steps the check follows, each step's loss, each
leaf's first gradient (the program's worked out from its AdamW state
after one step: ``m / (1 - b1)``, over the clip's scale from the step's
own ``gnorm``) and each leaf's change over the steps (the program's from
its fp32 master weights); by default as norms, with ``vectors`` the
tensors themselves. From them come the numbers below; a cell compares
those that its ``limits/<cell>.json`` gives a limit, and why it compares
those is set out beside the readings the limits were set from.

  * ``loss_gap``, ``loss1_gap``: the largest relative gap of a step's
    loss; the first step's;
  * ``grad_gap``, ``grad_median_gap``: over the leaves, the gap between
    the two norms of the first gradient, over the reference's norm of
    that leaf or of the median leaf, whichever is larger; the worst
    leaf's and the median leaf's;
  * ``change_gap``, ``change_median_gap``: the same for the change of the
    params, over the leaves whose reference gradient is at least a
    thousandth of the median leaf's (a leaf with none, as a key bias
    under softmax, moves under Adam by round-off alone);
  * ``grad_diff_median`` (with ``vectors``): the norm of the difference
    of the two first gradients, over the same denominator, the median
    leaf's.
"""
from __future__ import annotations

import statistics

MOVED = 1e-3        # of the median leaf's first gradient


def moved(ref: dict) -> list:
    """The leaves whose reference gradient is at least ``MOVED`` of the
    median leaf's."""
    g = ref["grad"]
    med = statistics.median(g.values())
    return [n for n in g if g[n] >= MOVED * med]


def leaf_gaps(prog: dict, ref: dict, keep, diff: dict = None) -> dict:
    """``{leaf: gap}``: each leaf's gap of norms (or, with ``diff``, the
    norm of its difference) over the larger of its reference norm and
    the median leaf's."""
    med = statistics.median(ref[n] for n in keep)
    num = diff or {n: abs(prog[n] - ref[n]) for n in keep}
    return {n: num[n] / max(ref[n], med, 1e-30) for n in keep}


def gaps(prog: dict, ref: dict) -> dict:
    """Every number of the module's list that the readings allow."""
    steps = [abs(p - r) / abs(r)
             for p, r in zip(prog["losses"], ref["losses"], strict=True)]
    out = {"loss_gap": max(steps), "loss1_gap": steps[0]}
    for key, keep in (("grad", list(ref["grad"])), ("change", moved(ref))):
        per = leaf_gaps(prog[key], ref[key], keep)
        out[key + "_gap"] = max(per.values())
        out[key + "_median_gap"] = statistics.median(per.values())
    if "grad_vec" in prog and "grad_vec" in ref:
        a, b = prog["grad_vec"], ref["grad_vec"]
        diff = {n: float((a[n].to(b[n].device) - b[n]).norm()) for n in b}
        per = leaf_gaps(prog["grad"], ref["grad"], list(b), diff)
        out["grad_diff_median"] = statistics.median(per.values())
    return out


def compared(limits: dict) -> list:
    """The numbers a cell compares: those its limits file gives a limit."""
    return [n for n, v in limits.items()
            if isinstance(v, dict) and "limit" in v]


def needs_vectors(limits: dict) -> bool:
    return "grad_diff_median" in compared(limits)


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """``(every compared number within its limit, {name: {"value",
    "limit"}})``; a number that is not finite, or a cell that compares
    none, fails."""
    names = compared(limits)
    checks, ok = {}, bool(names)
    for name in names:
        value = values.get(name, float("nan"))
        limit = limits[name]["limit"]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value == value and value <= limit
    return ok, checks
