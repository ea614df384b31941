"""The numbers that decide ``correct``, each worked out from the program's
readings and the reference's.

Training: each round's loss, the norm of each leaf's first update over the
learning rate (the gradient as the optimiser took it), and the norm of each
leaf's change over the first three rounds. A norm is compared by its gap,
``| |prog| - |ref| |``, over the larger of the reference's norm of that
leaf and the median leaf's, and the worst leaf is the number. Leaves whose
reference gradient is under a thousandth of the median leaf's are left out
of the change (they move by round-off alone).
"""

from __future__ import annotations

import statistics

import numpy as np

EXCLUDE_BELOW = 1e-3


def leaf_norms(tensors) -> list[float]:
    return [float(t.double().norm()) for t in tensors]


def training_readings(params0, states, losses, lr) -> dict:
    """What one side gives: its losses, its first update's norms over lr,
    its change's norms after the last state. ``states``: the params after
    each round (at least three)."""
    first = [(a.float() - b.float()) / lr for a, b in zip(params0, states[0])]
    change = [(b.float() - a.float()) for a, b in zip(params0, states[2])]
    return {"losses": [float(x) for x in losses[:3]], "grad": leaf_norms(first),
            "change": leaf_norms(change)}


def _worst_gap(prog, ref, keep=None) -> float:
    keep = keep if keep is not None else [True] * len(ref)
    med = statistics.median(r for r, k in zip(ref, keep) if k)
    gaps = [abs(p - r) / max(r, med) for p, r, k in zip(prog, ref, keep) if k]
    return max(gaps) if gaps else 0.0


def training_numbers(prog: dict, ref: dict) -> dict:
    """{loss_gap, grad_gap, change_gap} of one side against the reference."""
    if len(prog["grad"]) != len(ref["grad"]) or len(prog["losses"]) != len(ref["losses"]):
        return {"loss_gap": float("inf"), "grad_gap": float("inf"), "change_gap": float("inf")}
    med = statistics.median(ref["grad"])
    keep = [g >= EXCLUDE_BELOW * med for g in ref["grad"]]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    nums = {"loss_gap": loss_gap, "grad_gap": _worst_gap(prog["grad"], ref["grad"]),
            "change_gap": _worst_gap(prog["change"], ref["change"], keep)}
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in nums.items()}


def prediction_numbers(outputs, references) -> dict:
    """{pred_err}: the largest |decoded - reference| over every answer."""
    worst = 0.0
    for got, want in zip(outputs, references):
        got = np.asarray(got, dtype=np.float64)
        if got.shape != want.shape or not np.isfinite(got).all():
            return {"pred_err": float("inf")}
        worst = max(worst, float(np.abs(got - want).max()))
    if len(outputs) != len(references) or not outputs:
        return {"pred_err": float("inf")}
    return {"pred_err": worst}


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(every number within its limit, [(name, number, limit), ...])."""
    rows = [(k, numbers[k], limits[k]) for k in limits]
    return all(v <= lim for _, v, lim in rows), rows
