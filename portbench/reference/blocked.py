"""The reference of a training cell whose frozen tables no one process holds
whole: the published model (``model.py``'s functions, f32, TF32 off) run by
every rank of a ``torch.distributed`` world on its own blocks of rows of the
tables, as a mesh's model axis cuts them.  It imports nothing of the
program; the process group is the caller's.

A rank holds rows [lo, hi) of each chromosome's feature table and rows
[lo, hi) of ``inter_z`` (``rows``: {"features": [(lo, hi)], "inter_z":
(lo, hi)}, rows past a table's end are zero pad).  A step:
  * the node table: each rank encodes its feature rows (the feature dropout
    given as those rows' keep masks, ``RankKeep``) into a zero (N + 1, d)
    table, and one all-reduce sums the ranks' tables into the whole one;
  * the logits and the BCE from the whole table, alike on every rank;
  * the recon loss: each rank sums the squared errors of the tokens whose
    ``inter_z`` row it holds, in blocks of tokens; an all-reduce of the sum
    gives the loss;
  * gradients: each rank differentiates alpha x BCE / W + beta x its part
    of the recon loss with respect to every leaf but the autoencoders and
    to the node table; one all-reduce sums them; then each rank takes its
    feature rows' share of the autoencoders' gradients, one chromosome at a
    time, from the summed node-table gradient, and a last all-reduce sums
    those.
So no rank holds more than its blocks and one chromosome's rows at a time.
The control's rounding (``model.Rounding("fp8")``) scales each product's
operands by their own largest magnitude, here a rank's block's.

The feature dropout of one (n_c, n_c) draw is kept per rank as ``RankKeep``:
the keep bits of the rank's rows, packed, and the whole draw's least,
largest and mean value (``check``); a draw small enough to keep (the
feature tables drawn as one batch) is kept whole.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from portbench.reference import model as M
from portbench.reference.follow import _rebuild, assign_draws

_BITS = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8)


class RankKeep:
    """One rank's rows of a feature-dropout draw u of ``shape`` (b, b): the
    keep mask u[rows] < 1 - rate, packed 8 to a byte, and u's least,
    largest and mean value (the whole draw's)."""

    def __init__(self, u: torch.Tensor, rows: Sequence[int], rate: float):
        self.shape = tuple(u.shape)
        self.rate = float(rate)
        lo, hi = int(rows[0]), int(rows[1])
        keep = (u[lo:hi] < 1.0 - rate).reshape(-1)
        self.n_rows, self.numel = hi - lo, keep.numel()
        self.stats = (float(u.min()), float(u.max()),
                      float(u.mean(dtype=torch.float64)), u.numel())
        pad = (-keep.numel()) % 8
        bits = torch.nn.functional.pad(keep, (0, pad)).view(-1, 8)
        self.packed = (bits.to(torch.uint8)
                       * _BITS.to(bits.device)).sum(dim=1).to(torch.uint8)

    def cpu(self) -> "RankKeep":
        self.packed = self.packed.cpu()
        return self

    def keep(self, device=None) -> torch.Tensor:
        """(rows, b) bool."""
        p = self.packed.to(device or self.packed.device)
        bits = (p[:, None] & _BITS.to(p.device)) != 0
        return bits.reshape(-1)[:self.numel].view(self.n_rows, self.shape[1])

    def check(self) -> List[str]:
        """The whole draw's values in [0, 1) with a mean within six standard
        errors of 1/2, and the rows' keep share within six of 1 - rate."""
        bad = []
        lo, hi, mean, n = self.stats
        if lo < 0.0 or hi >= 1.0 or abs(mean - 0.5) > 6 * (1 / 12 / n) ** 0.5:
            bad.append(f"feature draw of {self.shape}: min {lo} max {hi} "
                       f"mean {mean}")
        if self.numel:
            p = 1.0 - self.rate
            # the set bits of the packed bytes (the pad bits are clear)
            ones = torch.tensor([bin(i).count("1") for i in range(256)],
                                dtype=torch.int64, device=self.packed.device)
            share = float(ones[self.packed.long()].sum()) / self.numel
            if abs(share - p) > 6 * (p * (1 - p) / self.numel) ** 0.5:
                bad.append(f"feature draw of {self.shape}: keep share "
                           f"{share} of {self.numel} entries, want {p}")
        return bad


def _all_sum(t: torch.Tensor, group) -> torch.Tensor:
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(t, group=group)
    return t


def _encode(tree, X: torch.Tensor, keep: Optional[torch.Tensor], c: int,
            rnd: M.Rounding, rate: float) -> torch.Tensor:
    ae = tree["embed"]["ae"][c]
    X = X.float()
    if keep is not None:
        X = torch.where(keep, X / (1.0 - rate),
                        torch.zeros((), device=X.device))
    return rnd.mm(torch.tanh(rnd.mm(X, ae["w1"])), ae["w2"])


def _keep(draw, lo: int, n: int, rate: float, device) -> torch.Tensor:
    """The keep mask of rows [lo, lo + n) of a feature draw: a rank's
    ``RankKeep`` of those rows, or a whole uniform draw."""
    if isinstance(draw, RankKeep):
        return draw.keep(device)[:n]
    return draw[lo:lo + n].to(device) < 1.0 - rate


def _real(lo: int, hi: int, n: int) -> int:
    """Rows of [lo, hi) that lie in a table of n rows."""
    return max(0, min(hi, n) - lo)


def follow(params0, tables, lay, model: dict, steps: List[dict],
           rows: Dict, rounding: str = "float32", device=None,
           half_batch: bool = False, group=None,
           block: int = 65_536, exchange: bool = True) -> dict:
    """``follow.follow`` on this rank's blocks of the tables (see the module
    docstring); ``steps[i]["draws"]`` hold ``RankKeep`` for the feature
    draws.  Every rank of ``group`` (the default world) calls it; each gets
    the same result: {"loss", "bce", "recon", "pred", "grad_norms",
    "change"}.  ``exchange`` False plants a fault: the gradient all-reduces
    are skipped, so each rank steps on its own part of the gradient (the
    forward's sums stay)."""
    M.no_tf32()
    rnd = M.Rounding(rounding)
    world = (dist.get_world_size(group) if dist.is_available()
             and dist.is_initialized() else 1)
    names = [n for n, _ in M.named_leaves(params0)]
    leaves = [t.detach().float().clone().to(device or t.device)
              .requires_grad_(True) for _, t in M.named_leaves(params0)]
    tree = _rebuild(params0, iter(leaves))
    ae_ids = {id(p) for a in tree["embed"]["ae"] for p in a.values()}
    rest = [i for i, p in enumerate(leaves) if id(p) not in ae_ids]
    opt = M.AdamW(leaves, float(model["learning_rate"]),
                  float(model["weight_decay"]))
    d = int(model["d_model"])
    rate = float(model["dropout_feature"])
    rates = (float(model["dropout_attention"]), float(model["dropout_pff"]))
    alpha, beta = float(model["alpha"]), float(model["beta"])
    z_lo, z_hi = rows["inter_z"]
    N = lay.n_nodes
    chrom_of = torch.as_tensor(lay.chrom_of_node())
    out = {"loss": [], "bce": [], "recon": [], "pred": [], "grad_norms": []}
    for st in steps:
        dev = leaves[0].device
        xs = {k: v.to(dev) for k, v in st["xs"].items()}
        feat, attn_u, pff_u = assign_draws(st["draws"], lay, xs, d)
        # the node table: this rank's feature rows, summed over the ranks
        H = torch.zeros((N + 1, d), device=dev)
        with torch.no_grad():
            for c, ((lo, hi), X) in enumerate(zip(rows["features"],
                                                  tables.features)):
                n = _real(lo, hi, lay.bins[c])
                if n:
                    s = lay.starts[c] + lo
                    H[s:s + n] = _encode(tree, X[:n], _keep(
                        feat[c], lo, n, rate, dev), c, rnd, rate)
        H = _all_sum(H, group).requires_grad_(True)
        lg = M.logits(tree, tables, xs, int(model["n_head"]), rnd, H,
                      attn_u, pff_u, rates)
        half = None
        if half_batch:
            half = {}
            for k in xs:
                b, n = st["n_pos"][k], xs[k].shape[0]
                half[k] = torch.cat([torch.arange(b // 2),
                                     b + torch.arange((n - b) // 2)]
                                    ).to(dev)
        bce = M.bce(lg, st["n_pos"], st["ws"], half)
        # the recon loss: the tokens off chromosome r whose row is held here
        r = int(st["r"])
        tok = torch.cat([xs[k].reshape(-1).long() for k in sorted(xs)])
        tok = tok[(chrom_of.to(dev)[tok] != r) & (tok != 0)]
        n_tok = tok.numel()
        mine = tok[(tok >= z_lo) & (tok < min(z_hi, N + 1))]
        dec = tree["embed"]["recon"][r]
        c0, w = lay.starts[r] - 1, lay.bins[r]
        part = torch.zeros((), device=dev)
        for lo in range(0, mine.numel(), block):
            t = mine[lo:lo + block]
            pred = M._linear(dec, torch.tanh(H[t]), rnd)
            target = tables.inter_z[t - z_lo, c0:c0 + w].float()
            part = part + ((pred - target) ** 2).mean(dim=-1).sum()
        scale = 100.0 / max(n_tok, 1)
        recon = _all_sum(part.detach().clone(), group) * scale
        own = alpha * bce / world + beta * part * scale
        got = torch.autograd.grad(own, [leaves[i] for i in rest] + [H],
                                  allow_unused=True)
        got = [torch.zeros_like(p) if g is None else g
               for p, g in zip([leaves[i] for i in rest] + [H], got)]
        flat = torch.cat([g.reshape(-1) for g in got])
        if exchange:
            flat = _all_sum(flat, group)
        got = list(flat.split([g.numel() for g in got]))
        dH = got.pop().view(N + 1, d)
        grads = [None] * len(leaves)
        for i, g in zip(rest, got):
            grads[i] = g.view(leaves[i].shape)
        # the autoencoders: this rank's rows' share, a chromosome at a time
        ae_grads = []
        for c, ((lo, hi), X) in enumerate(zip(rows["features"],
                                              tables.features)):
            ae = tree["embed"]["ae"][c]
            n = _real(lo, hi, lay.bins[c])
            if n:
                s = lay.starts[c] + lo
                Hc = _encode(tree, X[:n], _keep(feat[c], lo, n, rate, dev),
                             c, rnd, rate)
                ae_grads += torch.autograd.grad(Hc, [ae["w1"], ae["w2"]],
                                                grad_outputs=dH[s:s + n])
            else:
                ae_grads += [torch.zeros_like(ae["w1"]),
                             torch.zeros_like(ae["w2"])]
        flat = torch.cat([g.reshape(-1) for g in ae_grads])
        if exchange:
            flat = _all_sum(flat, group)
        ae_grads = iter(flat.split([g.numel() for g in ae_grads]))
        by_id = {}
        for a in tree["embed"]["ae"]:
            for key in ("w1", "w2"):
                by_id[id(a[key])] = next(ae_grads).view(a[key].shape)
        for i, p in enumerate(leaves):
            if grads[i] is None:
                grads[i] = by_id[id(p)]
        loss = alpha * bce.detach() + beta * recon
        out["loss"].append(float(loss))
        out["bce"].append(float(bce.detach()))
        out["recon"].append(float(recon))
        out["pred"].append(torch.sigmoid(torch.cat(
            [lg[k].detach() for k in sorted(lg)])).cpu())
        out["grad_norms"].append({n: float(g.norm())
                                  for n, g in zip(names, grads)})
        opt.step(grads)
    out["change"] = {n: float((p.detach() - p0.to(p.device).float()).norm())
                     for n, p, (_, p0) in zip(names, leaves,
                                              M.named_leaves(params0))}
    return out

