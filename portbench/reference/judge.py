"""The comparisons that decide ``correct``, and the checks of the program's
draws that the training reference takes as inputs.

Training (per cell, numbers and their limits in ``limits/<cell>.json``):
  * ``loss_gap``: the largest gap, over the first steps, between the
    program's step loss and the reference's, over the reference's;
  * ``grad_gap``: the worst leaf's gap between the program's first gradient
    norm (from AdamW's first moment after one step: m = (1 - b1) g) and the
    reference's, over the larger of the reference's norm of that leaf and
    the median leaf's;
  * ``change_gap``: the same of each leaf's change over the first steps,
    over the leaves the reference moves by more than round-off (the largest
    reference gradient norm over the steps at least 1e-3 of the median
    leaf's).
  * ``pred1_gap``: the largest gap between a probability the program's
    first step gave a row (its aux) and the reference's.  Both start that
    step from the same weights; from the second step on each follows its
    own AdamW updates, whose first step moves every element by about the
    learning rate in the sign of its gradient, so an element whose gradient
    is nought to rounding moves either way on either side, and on some seeds
    the later steps' probabilities part by twice to five times the first
    step's gap (PERF.md);
  * ``pred_gap``: the same over all the first steps (reported, not
    compared, for that reason);
  * ``bce_gap``: the largest gap between the step's BCE as the program
    reports it and the BCE worked out from the program's own probabilities
    of the step's rows, over the latter (the loss's reduction judged apart
    from the forward's rounding).
Scoring: ``proba_gap``, the largest gap between a returned probability and
the reference's, over the sampled requests.

The draws: each step's rows are rows of the cell's positives with their
weights; each negative is sorted, of distinct nodes, keeps each member's
chromosome, and is not a positive unless the sampler counted it as a
fallback; each dropout uniform lies in [0, 1) with a mean within six
standard errors of 1/2.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np


def rel(a: float, b: float, scale: float) -> float:
    return abs(a - b) / max(abs(scale), 1e-30)


def loss_gap(prog: List[float], ref: List[float]) -> float:
    return max(rel(p, r, r) for p, r in zip(prog, ref))


def moved_leaves(ref_grads: List[Dict[str, float]]) -> List[str]:
    peak = {n: max(g[n] for g in ref_grads) for n in ref_grads[0]}
    med = statistics.median(peak.values())
    return [n for n, v in peak.items() if v >= 1e-3 * med]


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             names: List[str]) -> float:
    med = statistics.median(ref[n] for n in names)
    return max(rel(prog[n], ref[n], max(ref[n], med)) for n in names)


def bce_of(pred, rows: Dict[int, int], n_pos: Dict[int, int], ws) -> float:
    """The weighted BCE of a step worked out from its probabilities (rows
    of the sizes in ascending order, (positives; negatives) each), in
    float64."""
    p = np.asarray(pred, np.float64)
    total, off = 0.0, 0
    for k in sorted(rows):
        q = p[off:off + rows[k]]
        b = n_pos[k]
        w = np.asarray(ws[k], np.float64).reshape(-1)
        total += (-(w * np.log(q[:b])).sum()
                  - np.log1p(-q[b:]).sum()) / rows[k]
        off += rows[k]
    return total / len(rows)


def pred_gap(prog: list, ref: list) -> float:
    return max(float(np.max(np.abs(np.asarray(p, np.float64)
                                   - np.asarray(r, np.float64))))
               for p, r in zip(prog, ref))


def bce_gap(bce: List[float], pred: list, steps: List[dict]) -> float:
    """The largest gap between a step's BCE as reported and as worked out
    from its own probabilities, over the latter."""
    out = 0.0
    for b, p, st in zip(bce, pred, steps):
        want = bce_of(p, st["rows"], st["n_pos"], st["ws"])
        out = max(out, float(rel(b, want, want)))
    return out


def train_gaps(prog: dict, ref: dict, steps: List[dict]) -> Dict[str, float]:
    """prog / ref: {"loss", "bce", "pred": [per step], "grad_norms":
    [{leaf: norm}, ...], "change": {leaf: norm}} (the program's grad_norms
    hold its first step only); steps: {"rows", "n_pos", "ws"} per step."""
    names = sorted(ref["change"])
    return {"loss_gap": loss_gap(prog["loss"], ref["loss"]),
            "pred1_gap": pred_gap(prog["pred"][:1], ref["pred"][:1]),
            "pred_gap": pred_gap(prog["pred"], ref["pred"]),
            "bce_gap": bce_gap(prog["bce"], prog["pred"], steps),
            "grad_gap": norm_gap(prog["grad_norms"][0], ref["grad_norms"][0],
                                 names),
            "change_gap": norm_gap(prog["change"], ref["change"],
                                   moved_leaves(ref["grad_norms"]))}


def check_uniforms(draws) -> List[str]:
    bad = []
    for i, u in enumerate(draws):
        n = u.numel()
        lo, hi, mean = float(u.min()), float(u.max()), float(u.double().mean())
        if lo < 0.0 or hi >= 1.0 or abs(mean - 0.5) > 6 * (1 / 12 / n) ** 0.5:
            bad.append(f"draw {i} of {tuple(u.shape)}: min {lo} max {hi} "
                       f"mean {mean}")
    return bad


def check_rows(step: dict, pos_index: Dict[int, dict], chrom: np.ndarray,
               neg_num: int) -> List[str]:
    """step: {"xs": {k: (B (1 + neg_num), k)}, "n_pos", "ws", "fallback"
    (the sampler's bloom + orig fallback count of the step)} on the host;
    pos_index: {k: {row tuple: weight}}."""
    bad, in_pos = [], 0
    for k, x in step["xs"].items():
        x = np.asarray(x, np.int64)
        b = step["n_pos"][k]
        pos, neg = x[:b], x[b:]
        w = np.asarray(step["ws"][k], np.float32).reshape(-1)
        idx = pos_index[k]
        for row, wt in zip(map(tuple, pos.tolist()), w.tolist()):
            if idx.get(row) != wt:
                bad.append(f"k={k}: step row {row} weight {wt} is not a "
                           f"positive of the cell")
                break
        if neg.shape != (b * neg_num, k):
            bad.append(f"k={k}: negatives of shape {neg.shape}")
            continue
        if not (np.diff(neg, axis=1) > 0).all():
            bad.append(f"k={k}: a negative is not sorted with distinct nodes")
        if (neg < 1).any() or (neg >= len(chrom)).any():
            bad.append(f"k={k}: a negative holds an id out of range")
            continue
        orig = np.tile(pos, (neg_num, 1))
        if not (chrom[neg] == chrom[orig]).all():
            bad.append(f"k={k}: a negative moved a member off its "
                       f"chromosome")
        in_pos += sum(r in idx for r in map(tuple, neg.tolist()))
    if in_pos > step["fallback"]:
        bad.append(f"{in_pos} negatives are positives, the sampler counted "
                   f"{step['fallback']} fallbacks")
    return bad
