"""The reference's side of a training cell's output check: it follows the
program's first steps from the same initial weights and frozen tables, on
the same rows, negatives, dropout uniforms and recon chromosomes, and gives
each step's loss, each leaf's gradient norm and each leaf's change.

The draws are the program's, judged on their own first (``judge.py``): the
reference cannot draw the program's random streams itself without being a
copy of its code.  ``assign_draws`` places a step's dropout uniforms by the
published model's sites, in its order (the feature tables, one or one per
chromosome; the attention output per size in ascending k; the feed-forward's
inner layer over all tokens), and refuses a step whose draws do not fit
them.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference import model as M


class DrawMismatch(ValueError):
    pass


def assign_draws(raw: List[torch.Tensor], lay, xs: Dict[int, torch.Tensor],
                 d: int):
    """A step's uniforms in draw order -> (feature uniforms per chromosome,
    {k: attention uniforms}, feed-forward uniforms)."""
    ks = sorted(xs)
    C, W = lay.n_chroms, lay.f_max
    if raw and tuple(raw[0].shape) == (C, W, W):
        feat = [raw[0][c, :b, :b] for c, b in enumerate(lay.bins)]
        rest = raw[1:]
    else:
        feat = raw[:C]
        for u, b in zip(feat, lay.bins):
            if tuple(u.shape) != (b, b):
                raise DrawMismatch(f"feature draw {tuple(u.shape)} is not "
                                   f"({b}, {b})")
        rest = raw[C:]
    if len(rest) != len(ks) + 1:
        raise DrawMismatch(f"{len(rest)} draws after the feature tables, "
                           f"the model has {len(ks) + 1} dropout sites")
    attn = {}
    for k, u in zip(ks, rest):
        want = (xs[k].shape[0], k, d)
        if tuple(u.shape) != want:
            raise DrawMismatch(f"attention draw {tuple(u.shape)} for k={k}, "
                               f"want {want}")
        attn[k] = u
    T = sum(int(xs[k].numel()) for k in ks)
    if tuple(rest[-1].shape) != (T, d):
        raise DrawMismatch(f"feed-forward draw {tuple(rest[-1].shape)}, "
                           f"want {(T, d)}")
    return feat, attn, rest[-1]


def follow(params0, tables, lay, model: dict, steps: List[dict],
           rounding: str = "float32", device=None,
           half_batch: bool = False) -> dict:
    """Runs the reference over ``steps`` (each {"xs", "n_pos", "ws",
    "draws", "r"}) from params0 (left as they are).  -> {"loss": [per
    step], "bce", "recon": [its parts], "pred": [per step: the rows'
    probabilities, sizes ascending, (positives; negatives) each],
    "grad_norms": [per step: {leaf: norm}], "change": {leaf: norm of the
    change after the last step}}.  half_batch: each size's loss is the
    mean over the first half of its positives and of its negatives only (a
    fault, for the limits)."""
    M.no_tf32()
    rnd = M.Rounding(rounding)
    names = [n for n, _ in M.named_leaves(params0)]
    leaves = [t.detach().float().clone().to(device or t.device)
              .requires_grad_(True) for _, t in M.named_leaves(params0)]
    tree = _rebuild(params0, iter(leaves))
    opt = M.AdamW(leaves, float(model["learning_rate"]),
                  float(model["weight_decay"]))
    d = int(model["d_model"])
    rates = (float(model["dropout_attention"]), float(model["dropout_pff"]))
    out = {"loss": [], "bce": [], "recon": [], "pred": [], "grad_norms": []}
    for st in steps:
        xs = {k: v.to(leaves[0].device) for k, v in st["xs"].items()}
        feat_u, attn_u, pff_u = assign_draws(st["draws"], lay, xs, d)
        H = M.node_table(tree, tables.features, rnd, feat_u,
                         float(model["dropout_feature"]))
        lg = M.logits(tree, tables, xs, int(model["n_head"]), rnd, H,
                      attn_u, pff_u, rates)
        rows = None
        if half_batch:
            rows = {}
            for k in xs:
                b, n = st["n_pos"][k], xs[k].shape[0]
                rows[k] = torch.cat([torch.arange(b // 2),
                                     b + torch.arange((n - b) // 2)]
                                    ).to(xs[k].device)
        bce = M.bce(lg, st["n_pos"], st["ws"], rows)
        recon = M.recon_loss(tree, tables, lay, xs, H, int(st["r"]), rnd)
        loss = float(model["alpha"]) * bce + float(model["beta"]) * recon
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        out["loss"].append(float(loss.detach()))
        out["bce"].append(float(bce.detach()))
        out["recon"].append(float(recon.detach()))
        out["pred"].append(torch.sigmoid(torch.cat(
            [lg[k].detach() for k in sorted(lg)])).cpu())
        out["grad_norms"].append({n: float(g.norm())
                                  for n, g in zip(names, grads)})
        opt.step(grads)
    out["change"] = {n: float((p.detach() - p0.to(p.device).float()).norm())
                     for n, p, (_, p0) in zip(names, leaves,
                                              M.named_leaves(params0))}
    return out


def _rebuild(template, it):
    if isinstance(template, dict):
        return {k: _rebuild(template[k], it) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return [_rebuild(v, it) for v in template]
    return next(it)


def score(params, tables, xs: Dict[int, torch.Tensor], n_head: int,
          rounding: str = "float32", block: int = 10_000
          ) -> Dict[int, torch.Tensor]:
    """Eval-mode probabilities {k: (n_k,)} of per-size rows, in blocks."""
    M.no_tf32()
    rnd = M.Rounding(rounding)
    with torch.no_grad():
        H = M.node_table(params, tables.features, rnd)
        out = {}
        for k, x in xs.items():
            parts = [M.logits(params, tables, {k: x[lo:lo + block]}, n_head,
                              rnd, H)[k] for lo in range(0, len(x), block)]
            out[k] = torch.sigmoid(torch.cat(parts))
    return out
