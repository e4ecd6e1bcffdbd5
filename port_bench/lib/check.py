"""The comparison that decides `correct`: the numbers compared, each
against its limit from the workload file's `check`.

Training cells (three steps of the program against three of the
reference, from the same weights, batches and dropout draws):
* loss_gap: the largest |loss - reference loss| / |reference loss| over
  the three steps,
* grad_gap: the median over the leaves of the gap between the norm of
  the program's first gradient as its optimizer got it (its first moment
  after one step over 1 - beta1) and the reference's, each side's norms
  over its own median leaf's, the gap over the larger of the reference's
  scaled norm and 1 (the median leaf),
* change_gap: the same of the norms of each leaf's change over the three
  steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf whose gradient is nought to
  rounding, as a key's bias under softmax, moves under Adam by round-off
  alone).
The median and not the worst leaf, and norms over the median leaf's: the
box head's gates, log(max(relu(g), 1e-6)), give the 16 gate leaves
gradients of 1/g where g is near 0, which bf16 rounding moves by tens of
percent on some seeds and not on others; where they dominate the global
norm, the clip passes their rounding to every leaf by one factor, which the
scaling by the median leaf removes (PERF.md).  The worst leaf of each is
reported beside the numbers.

Served cells:
* logit_gap: over the sampled batches, the largest |logit - reference
  logit| over the batch's largest |reference logit|.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional, Tuple

MOVED_SHARE = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves) -> Dict[str, float]:
    leaves = list(leaves)
    med = statistics.median(ref[n] for n in leaves)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves}


def _per_median(norms: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's norm over the median leaf's: the global clip's factor,
    common to every leaf, cancels."""
    med = statistics.median(norms.values())
    return {n: (v / med if med > 0 else 0.0) for n, v in norms.items()}


def training_numbers(prog: dict, ref: dict) -> Tuple[Dict[str, float], Dict[str, list]]:
    """-> ({loss_gap, grad_gap, change_gap}, {the worst leaf of each: [leaf, gap]})."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    grad = _leaf_gaps(_per_median(prog["grad"]), _per_median(ref["grad"]), ref["grad"])
    med = statistics.median(ref["grad"].values())
    moved = [n for n, g in ref["grad"].items() if g >= MOVED_SHARE * med]
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    worst = {k: list(max(gaps.items(), key=lambda kv: kv[1]))
             for k, gaps in (("grad_gap", grad), ("change_gap", change))}
    return ({"loss_gap": loss_gap, "grad_gap": statistics.median(grad.values()),
             "change_gap": statistics.median(change.values())}, worst)


def logit_gap(prog, ref) -> float:
    """Largest |prog - ref| over the largest |ref|, of one batch's logits."""
    return float((prog.float() - ref.float()).abs().max() / ref.float().abs().max())


def verdict(numbers: Dict[str, float], limits: Dict[str, Optional[float]]) -> Tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number
    that has a limit is within it, and at least one has."""
    out = {n: {"value": v, "limit": limits.get(n)} for n, v in numbers.items()}
    held = [n for n in numbers if limits.get(n) is not None]
    ok = bool(held) and all(numbers[n] <= limits[n] for n in held)
    return ok, out
