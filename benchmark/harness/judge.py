"""The numbers that decide `correct`, each against the limit of the cell
(`benchmark/limits/<cell>.json`), and the comparisons they come from.

A leaf's gap is |program's norm - reference's norm| over the larger of
the reference's norm of that leaf and of the median leaf; a number is the
worst leaf's gap. The change of parameters leaves out the leaves whose
reference gradient is under a thousandth of the median leaf's (a key's
bias under softmax: Adam moves it by round-off alone).

`grad_share_gap` compares, for the leaves outside the CLIP tower
(`encoder.visual_model.*`: the joint encoder, the visual projection and
the head), each leaf's share of those leaves' joint norm, in the first
step's gradient: the worst leaf's gap as above, on the shares. The
shares leave out what all these leaves have in common, the clip factor
and the scale of the loss's gradient, which bf16 rounding moves by up to
a tenth where the heat map's logits start far from 0; the tower's own
leaves, small differences of large sums, are left out as well.
"""

from __future__ import annotations

import json
import math
import os
import statistics
from typing import Dict, Iterable, Optional, Tuple

SMALL_GRAD = 1e-3
TOWER = "encoder.visual_model."


def worst_gap(prog: Dict[str, float], ref: Dict[str, float],
              names: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    names = list(ref if names is None else names)
    med = statistics.median(ref[n] for n in names)
    worst, at = 0.0, ""
    for n in names:
        den = max(ref[n], med)
        g = abs(prog[n] - ref[n]) / den if den > 0 else abs(prog[n] - ref[n])
        if g > worst:
            worst, at = g, n
    return worst, at


def shares(norms: Dict[str, float], names: Iterable[str]) -> Dict[str, float]:
    """Each named leaf's norm over the named leaves' joint norm (all 0 where
    that is 0, as for a gradient that the optimizer never took)."""
    names = list(names)
    total = math.sqrt(sum(norms[n] ** 2 for n in names))
    return {n: norms[n] / total if total > 0 else 0.0 for n in names}


def moved(ref_grad: Dict[str, float]):
    med = statistics.median(ref_grad.values())
    return [n for n, v in ref_grad.items() if v >= SMALL_GRAD * med]


def median_gap(prog: Dict[str, float], ref: Dict[str, float]
               ) -> Tuple[float, str]:
    """The median over leaves of each leaf's gap (as `worst_gap`)."""
    med = statistics.median(ref.values())
    gaps = sorted((abs(prog[n] - ref[n]) / max(ref[n], med), n) for n in ref)
    return gaps[len(gaps) // 2]


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """loss_gap (worst of the first steps' relative loss gaps),
    loss_gap_first (the first step's alone), grad_gap (first step's
    clipped gradient, worst leaf), grad_gap_median (its median leaf),
    grad_share_gap (its leaves outside the tower, by their shares),
    change_gap (parameters' change over the steps) and, with a BatchNorm
    tower, bn_stats_gap (its running statistics after the steps). A cell
    compares those its limits name."""
    joint = [n for n in ref["grad"] if not n.startswith(TOWER)]
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                ref["losses"])]
    at = f"losses {prog['losses']} vs {ref['losses']}"
    out = {"loss_gap": (max(gaps), at), "loss_gap_first": (gaps[0], at),
           "grad_gap": worst_gap(prog["grad"], ref["grad"]),
           "grad_gap_median": median_gap(prog["grad"], ref["grad"]),
           "grad_share_gap": worst_gap(shares(prog["grad"], joint),
                                       shares(ref["grad"], joint)),
           "change_gap": worst_gap(prog["change"], ref["change"],
                                   moved(ref["grad"]))}
    if ref.get("buffers"):
        out["bn_stats_gap"] = worst_gap(prog["buffers"], ref["buffers"])
    return out


def load_limits(root: str, cell: str) -> Dict[str, float]:
    with open(os.path.join(root, "benchmark", "limits", f"{cell}.json")) as f:
        return json.load(f)["limits"]


def checks(numbers: Dict[str, Tuple[float, str]], limits: Dict[str, float]
           ) -> Dict[str, Dict]:
    """name -> {value, limit, ok, at} of each number the cell's limits
    name; a limit whose number the run did not produce fails."""
    out = {}
    for name, lim in limits.items():
        value, at = numbers.get(name, (float("nan"), "not produced"))
        ok = value == value and value <= lim
        out[name] = {"value": value, "limit": lim, "ok": bool(ok), "at": at}
    return out
