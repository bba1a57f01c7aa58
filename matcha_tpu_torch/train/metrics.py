"""Evaluation metrics: AUROC / AUPRC / accuracy, overall and per hyperedge
size.

Port of ``matcha_tpu/train/metrics.py`` without scikit-learn: one torch
implementation of scikit-learn's tie-aware definitions (the JAX package's
device path, ``_group_metrics_device``) serves both devices.  On the card a
training epoch's metrics then cost one sort per group and a fetch of a few
scalars instead of shipping the (steps, P) predictions to the host.  Sums
run in float64, so the rank sums of millions of rows stay exact to well
below 1e-6.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _group_metrics_device(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """scikit-learn-equal (auroc, auprc, acc, n_pos) of one group as a (4,)
    float64 tensor on p's device, with no host synchronisation.

    p: (m,) predictions; y: (m,) labels (> 0.5 = positive).  AUROC is the
    tie-aware rank sum (midranks over tied blocks, equal to the trapezoidal
    ROC integral); AUPRC is ``average_precision_score``'s sum of recall steps
    times the precision at each DISTINCT threshold (ties collapse to the
    block's end).  NaN where a class is missing."""
    m = p.shape[0]
    f64 = torch.float64
    ps, order = torch.sort(p.reshape(-1))
    ys = (y.reshape(-1)[order] > 0.5).to(f64)
    r = torch.arange(1, m + 1, dtype=f64, device=p.device)
    step = ps[1:] != ps[:-1]
    one = torch.ones((1,), dtype=torch.bool, device=p.device)
    new_blk = torch.cat([one, step])
    is_end = torch.cat([step, one])
    # ranks ascend: a running max of block-start ranks is each row's block
    # start; a reversed running min of block-end ranks its block end
    first_b = torch.cummax(torch.where(new_blk, r, torch.zeros_like(r)),
                           0).values
    last_b = torch.cummin(torch.where(is_end, r, torch.full_like(r, np.inf))
                          .flip(0), 0).values.flip(0)
    midrank = (first_b + last_b) * 0.5
    n_pos = ys.sum()
    n_neg = m - n_pos
    nan = torch.full((), np.nan, dtype=f64, device=p.device)
    auroc = torch.where((n_pos > 0) & (n_neg > 0),
                        ((midrank * ys).sum() - n_pos * (n_pos + 1) * 0.5)
                        / torch.clamp(n_pos * n_neg, min=1.0), nan)
    # average precision over descending scores: each row adds its recall
    # step times the precision at its block's end, which in descending order
    # is the block's last row: the next flagged position at or after it
    yd = ys.flip(0)
    tp = torch.cumsum(yd, 0)
    prec = tp / r
    rec = tp / torch.clamp(n_pos, min=1.0)
    is_end_d = new_blk.flip(0)
    pos = torch.arange(m, device=p.device)
    nxt = torch.cummin(torch.where(is_end_d, pos, torch.full_like(pos, m))
                       .flip(0), 0).values.flip(0)
    d_rec = torch.diff(rec, prepend=torch.zeros((1,), dtype=f64,
                                                device=p.device))
    ap = torch.where(n_pos > 0, (d_rec * prec[nxt]).sum(), nan)
    acc = ((ps >= 0.5) == (ys > 0.5)).to(f64).mean()
    return torch.stack([auroc, ap, acc, n_pos])


def device_metrics_fn(y: np.ndarray, sizes: np.ndarray):
    """fn(preds (S, P) tensor) -> {group: (4,) tensor} for a FIXED per-step
    label/size layout (y, sizes (P,) host arrays, the same every step, as
    ``labels_for_batch`` gives them): the groups of
    ``size_stratified_metrics`` over the S steps, computed on the
    predictions' device with no host synchronisation.  ``fn.group_sizes``
    holds each group's rows per step."""
    y = np.asarray(y).reshape(-1)
    sizes = np.asarray(sizes).reshape(-1)
    groups = {"all": np.arange(y.size)}
    for s in np.unique(sizes):
        groups[int(s)] = np.flatnonzero(sizes == s)
    ypos = (y > 0.5).astype(np.float32)

    def fn(preds: torch.Tensor) -> Dict[str, torch.Tensor]:
        flat = preds.reshape(preds.shape[0], -1)
        dev = flat.device
        yrow = torch.as_tensor(ypos).to(dev, non_blocking=True)
        out = {}
        for name, cols in groups.items():
            if cols.size and np.array_equal(
                    cols, np.arange(cols[0], cols[-1] + 1)):
                p, yg = flat[:, cols[0]:cols[-1] + 1], yrow[cols[0]:
                                                            cols[-1] + 1]
            else:
                idx = torch.as_tensor(cols).to(dev, non_blocking=True)
                p, yg = flat[:, idx], yrow[idx]
            out[str(name)] = _group_metrics_device(
                p.reshape(-1), yg.expand(p.shape).reshape(-1))
        return out

    fn.group_sizes = {name: int(cols.size) for name, cols in groups.items()}
    return fn


def metrics_from_device(vals: Dict, group_sizes: Dict, steps: int) -> Dict:
    """``device_metrics_fn`` output (tensors, fetched here in one host
    synchronisation, or arrays already fetched) -> the
    ``size_stratified_metrics`` dict."""
    names = list(vals)
    vs = [vals[n] for n in names]
    host = (torch.stack(vs).cpu().numpy() if torch.is_tensor(vs[0])
            else np.stack([np.asarray(v) for v in vs]))
    out = {}
    for name, (auroc, ap, acc, _) in zip(names, host):
        key = int(name) if name.isdigit() else name
        out[key] = {"auroc": float(auroc), "auprc": float(ap),
                    "acc": float(acc),
                    "n": int(group_sizes[key]) * int(steps)}
    return out


def size_stratified_metrics(y_true, y_pred, sizes) -> Dict:
    """{"all": {...}, k: {"auroc", "auprc", "acc", "n"} per size}.  y_true
    and sizes are host arrays; y_pred a tensor (on any device) or an
    array."""
    fn = device_metrics_fn(y_true, sizes)
    pred = torch.as_tensor(y_pred).reshape(1, -1)
    return metrics_from_device(fn(pred), fn.group_sizes, 1)


def format_metrics(metrics: Dict) -> Tuple[str, str, str]:
    """Reference-style strings 'all 0.912 2 0.905 3 ...' for roc / aupr /
    acc."""
    if not metrics:
        # eval_epoch returns {} when every test bucket was empty
        return ("n/a",) * 3
    keys = ["all"] + sorted(k for k in metrics if k != "all")
    roc = " ".join(f"{k} {metrics[k]['auroc']:.3f}" for k in keys)
    aupr = " ".join(f"{k} {metrics[k]['auprc']:.3f}" for k in keys)
    acc = " ".join(f"{k} {metrics[k]['acc']:.3f}" for k in keys)
    return roc, aupr, acc
