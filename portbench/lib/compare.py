"""The numbers that decide `correct` for a training cell, worked out the
same way for every cell: the worst relative loss gap of the followed
steps, and per leaf the gap between the program's and the reference's norm
of the first gradient, of the parameters' change over the followed steps
and of the running statistics' change, each against the reference's norm
of that leaf or of the median leaf, whichever is larger, taken by the
worst leaf, the median leaf or the worst conv kernel; and the median
leaf's gap of each leaf's share of the whole first gradient, which an
error of scale common to every leaf does not move.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Sequence


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    if len(prog) != len(ref) or not all(map(math.isfinite, prog)):
        return math.inf
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keys: Iterable[str]) -> list:
    """|prog - ref| / max(ref, median of ref over all leaves) for each of
    `keys`; inf where a leaf is missing or not finite."""
    med = statistics.median(ref.values())
    out = []
    for k in keys:
        p = prog.get(k, math.nan)
        out.append(abs(p - ref[k]) / max(ref[k], med) if math.isfinite(p)
                   else math.inf)
    return out


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keys: Iterable[str]) -> float:
    """The worst leaf's gap (`_leaf_gaps`)."""
    return max(_leaf_gaps(prog, ref, keys))


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    keys: Iterable[str]) -> float:
    """The median leaf's gap (`_leaf_gaps`): steady from seed to seed where
    the worst leaf is one whose true value all but cancels."""
    return statistics.median(_leaf_gaps(prog, ref, keys))


def shape_gap(prog: Dict[str, float], ref: Dict[str, float],
              keys: Sequence[str]) -> float:
    """The median leaf's gap (`_leaf_gaps`) of each leaf's share of the
    whole gradient's norm over `keys`: an error of scale that every leaf
    shares drops out, an error of the gradient's make-up stays."""
    def shares(norms):
        total = math.sqrt(sum(norms.get(k, math.nan) ** 2 for k in keys))
        return {k: norms.get(k, math.nan) / total for k in keys}
    total = math.sqrt(sum(prog.get(k, math.nan) ** 2 for k in keys))
    if not math.isfinite(total) or total == 0:
        return math.inf
    return median_leaf_gap(shares(prog), shares(ref), keys)


def moved_keys(ref_grad: Dict[str, float], share: float = 1e-3):
    """The leaves whose reference gradient is above `share` of the median
    leaf's: the others (a bias under a batch norm) move under Adam by
    round-off alone."""
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= share * med]


def norms(tensors) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def check(name: str, value: float, limit: float) -> dict:
    return {"name": name, "value": value, "limit": limit}


def readings(out: dict, weights: dict) -> dict:
    """A reference-like run's readings: its losses, and per leaf the norm of
    the first gradient, of the parameters' change and of the running
    statistics' change."""
    return {"losses": list(out["losses"]),
            "convs": sorted(k for k, v in out["grads"].items()
                            if v.ndim == 5),
            "grads": norms(out["grads"]),
            "change": norms({k: v - weights[k]
                             for k, v in out["params"].items()}),
            "stats": norms({k: v - weights[k]
                            for k, v in out["stats"].items()})}


def training_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """Every number a training cell can compare, from readings (`readings`,
    or the program's own).  Leaves whose reference gradient is under a
    thousandth of the median leaf's (`moved_keys`: a bias under a batch
    norm) count in none of the gradient and change numbers: round-off
    alone sets them.  `grad_conv_gap` is the worst leaf among the conv
    kernels (5-D in the reference): a fault at one site's weight gradient
    moves that leaf alone."""
    moved = moved_keys(ref["grads"])
    grads = {k: ref["grads"][k] for k in moved}
    change = {k: ref["change"][k] for k in moved}
    convs = [k for k in moved if k in ref["convs"]]
    return {
        "loss_gap": loss_gap(prog["losses"], ref["losses"]),
        "grad_gap": leaf_gap(prog["grads"], grads, moved),
        "grad_median_gap": median_leaf_gap(prog["grads"], grads, moved),
        "grad_shape_gap": shape_gap(prog["grads"], grads, moved),
        "grad_conv_gap": leaf_gap(prog["grads"], grads, convs),
        "change_gap": leaf_gap(prog["change"], change, moved),
        "change_median_gap": median_leaf_gap(prog["change"], change, moved),
        "stats_gap": leaf_gap(prog["stats"], ref["stats"], ref["stats"]),
    }


def training_checks(prog: dict, ref: dict, limits: dict) -> list:
    """The numbers of a training cell that its traffic mix gives a limit,
    each beside its limit."""
    numbers = training_numbers(prog, ref)
    return [check(k, numbers[k], limits[k]) for k in numbers if k in limits]


def worst_leaves(prog: dict, ref: dict, kind: str, top: int = 3) -> list:
    """(gap, leaf, reference / median, program / median) of the leaves with
    the largest gaps of `kind` (for diagnosis)."""
    med = statistics.median(ref[kind].values())
    rows = [(abs(prog[kind].get(k, math.nan) - v) / max(v, med), k,
             v / med, prog[kind].get(k, math.nan) / med)
            for k, v in ref[kind].items()]
    return sorted(rows, reverse=True)[:top]
