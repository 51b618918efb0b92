"""The numbers that decide ``correct``: how far the program's readings
lie from the reference's.  Each is compared with its cell's limit
(``limits/<workload>.json``); a missing or non-finite reading counts as
infinitely far."""
from __future__ import annotations

import math
import statistics

import torch

#: a leaf whose first gradient in the reference is below this share of
#: the median leaf's is nought to rounding (it moves under Adam by
#: round-off alone) and is left out of the change's comparison
NOUGHT_GRAD = 1e-3


def _finite(x) -> float:
    x = float(x)
    return x if math.isfinite(x) else math.inf


def worst_leaf(prog: dict, ref: dict, names) -> float:
    """The largest gap between a leaf's norm in the program and in the
    reference, over the larger of the reference's norm of that leaf and
    of the median leaf."""
    names = list(names)
    med = statistics.median(ref[n] for n in names)
    worst = 0.0
    for n in names:
        gap = abs(_finite(prog.get(n, math.inf)) - ref[n])
        worst = max(worst, gap / max(ref[n], med))
    return worst


def train(prog: dict, ref: dict) -> dict:
    """``loss_gap``: the largest relative gap of a step's loss;
    ``grad_gap`` and ``change_gap``: :func:`worst_leaf` of the first
    gradient's norms and of the change's norms (the leaves whose first
    gradient is nought to rounding left out of the latter)."""
    loss_gap = max(abs(_finite(p) - r) / abs(r)
                   for p, r in zip(prog["loss"], ref["loss"], strict=True))
    grads = ref["grad"]
    med = statistics.median(grads.values())
    moved = [n for n in grads if grads[n] >= NOUGHT_GRAD * med]
    return {"loss_gap": loss_gap,
            "grad_gap": worst_leaf(prog["grad"], grads, grads),
            "change_gap": worst_leaf(prog["change"], ref["change"], moved)}


def prefill(prog: torch.Tensor, ref: torch.Tensor, vocab: int) -> dict:
    """``logit_err``: the norm of the program's last-position logits less
    the reference's, over the norm of the reference's, on the real
    vocabulary."""
    p, r = prog[:vocab].double().cpu(), ref[:vocab].double().cpu()
    err = torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r)
    return {"logit_err": _finite(err)}
