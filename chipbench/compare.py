"""The numbers a training cell's first steps are judged by, program
against reference.

Each is a gap of norms by the worst weight: for every weight, the gap
between the program's norm and the reference's, measured against the
reference's norm of that weight or of the median weight, whichever is
larger (some gradients are all but zero); then the largest over the
weights.

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: of the first gradient as the optimizer takes it (synced,
  clipped), read from the program's first moment after one step;
- ``change_gap``: of each weight's change over the steps, leaving out
  the weights whose reference gradient is under a thousandth of the
  median weight's (they move by round-off alone).
"""
from statistics import median

QUIET = 1e-3      # a weight whose gradient is under this share of the median's


def _worst(prog: dict, want: dict, keys: list) -> tuple:
    med = median(want[k] for k in keys)
    worst, at = 0.0, None
    for k in keys:
        gap = abs(prog[k] - want[k]) / max(want[k], med)
        if gap > worst or at is None:
            worst, at = gap, k
    return worst, at


def gaps(prog: dict, want: dict) -> dict:
    """``prog`` and ``want`` as ``reference.qwen3.train_readings``
    returns them, over the same weight names."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["loss"], want["loss"]))
    names = list(want["grad"])
    grad_gap, grad_at = _worst(prog["grad"], want["grad"], names)
    gmed = median(want["grad"].values())
    moved = [k for k in names if want["grad"][k] >= QUIET * gmed]
    change_gap, change_at = _worst(prog["change"], want["change"], moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_worst": grad_at,
            "change_worst": change_at,
            "left_out": sorted(set(names) - set(moved))}
