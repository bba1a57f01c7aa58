"""Plain PyTorch reference of MATCHA's Hyper-SAGNN (Zhang & Ma, Cell Systems
2020; github.com/ma-compbio/MATCHA ``Code/Modules.py`` and ``Code/main.py``),
written from the published model: no kernels, no batching tricks, f32 with
TF32 off.  It imports nothing of the program.

The model, for one batch of hyperedges x (rows of k node ids):
  * node table: per chromosome c, H_c = tanh(drop(X_c) @ W1_c) @ W2_c over
    its frozen feature table X_c (feature dropout 0.2 in training); id 0 is
    a zero row;
  * tokens: e = H[x] + attr_nn(attr[x]); h = tanh(next_w(e));
  * dynamic: self-attention over the k members with each member's own key
    masked (8 heads of 64; LayerNorm on q, k and v inputs; softmax over the
    other members), fc1 back to 64, dropout 0.3; then the position-wise
    feed-forward tanh(W1 d) -> dropout 0.4 -> W2, plus d, LayerNorm;
  * score: classifier((LN_dyn(dynamic) - LN_static(h))^2) per member, the
    mean over the members is the logit;
  * loss (stage 2): alpha x the mean over sizes of the weighted BCE (each
    positive weighted by its quantile weight, each negative by 1) + beta x
    the recon loss: for one chromosome r, every token whose node is not on
    r decodes tanh(H[node]) through r's decoder, and the mean squared error
    against the node's z-scored inter-chromosome row over r's columns,
    x 100, is averaged over those tokens;
  * AdamW (lr 1e-3, betas 0.9 / 0.999, eps 1e-8, decoupled weight decay).

Dropout keeps an entry where its uniform draw is below 1 - rate and scales
it by 1 / (1 - rate); the uniforms are inputs here (see ``judge.py``).

``Rounding`` puts every product's operands and result through a precision:
"float32" leaves them; "fp8" rounds them to float8 e4m3 with a per-tensor
scale (its largest magnitude onto 448): the control, the reference computed
as an fp8 path of the program would.  The backward passes through the
roundings.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Rounding:
    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8"):
            raise ValueError(f"unknown rounding {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.kind == "float32":
            return x
        scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x).detach()          # rounded forward, plain backward

    def mm(self, a, b):
        """A product in this precision: operands and result rounded."""
        return self(self(a) @ self(b))


def named_leaves(tree, prefix: str = ""):
    """[(dotted name, leaf)] of a weight tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def _ln(x, p, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["g"] + p["b"]


def _drop(x, u, rate):
    if u is None:
        return x
    return torch.where(u.to(x.device) < 1.0 - rate, x / (1.0 - rate),
                       torch.zeros((), device=x.device))


def node_table(params, features: Sequence[torch.Tensor], rnd: Rounding,
               feat_u: Optional[List[torch.Tensor]] = None,
               rate: float = 0.2) -> torch.Tensor:
    """(N + 1, d) node table; feat_u: one (n_c, n_c) uniform per chromosome
    (training) or None (no dropout)."""
    ae = params["embed"]["ae"]
    d = ae[0]["w2"].shape[1]
    rows = [torch.zeros((1, d), device=features[0].device)]
    for c, X in enumerate(features):
        X = _drop(X.float(), None if feat_u is None else feat_u[c], rate)
        rows.append(rnd.mm(torch.tanh(rnd.mm(X, ae[c]["w1"])), ae[c]["w2"]))
    return torch.cat(rows)


def attention(p, x, n_head: int, rnd: Rounding, u=None, rate: float = 0.3):
    """Diag-masked multi-head self-attention over rows x (n, k, d)."""
    n, k, d = x.shape
    hd = p["wq"].shape[1]
    dk = hd // n_head

    def proj(ln, w):
        return rnd.mm(_ln(x, p[ln]), p[w]).view(n, k, n_head, dk) \
            .transpose(1, 2)                                  # (n, H, k, dk)
    q, kk, v = proj("ln_q", "wq"), proj("ln_k", "wk"), proj("ln_v", "wv")
    s = rnd.mm(q, kk.transpose(-1, -2)) / math.sqrt(dk)
    eye = torch.eye(k, dtype=torch.bool, device=x.device)
    a = torch.softmax(s.masked_fill(eye, float("-inf")), dim=-1)
    o = rnd.mm(a, v).transpose(1, 2).reshape(n, k, hd)
    o = rnd.mm(o, p["fc1"]["w"]) + p["fc1"]["b"]
    return _drop(o, u, rate)


def _linear(p, x, rnd):
    return rnd.mm(x, p["w"]) + p["b"]


def logits(params, tables, xs: Dict[int, torch.Tensor], n_head: int,
           rnd: Rounding, H: torch.Tensor, attn_u=None, pff_u=None,
           rates=(0.3, 0.4)) -> Dict[int, torch.Tensor]:
    """{k: (n_k,) logits} of the per-size rows xs; H the node table.
    attn_u: {k: (n_k, k, d)} uniforms; pff_u: (T, d) over the tokens of
    every size in ascending k, row-major; None: no dropout."""
    ks = sorted(xs)
    attr = _linear(params["attr_nn"], tables.attr_table.float(), rnd)
    comb = H + attr
    hs, dyn = [], []
    for k in ks:
        e = comb[xs[k].long()]                                 # (n, k, d)
        h = torch.tanh(_linear(params["next_w"]["layers"][0], e, rnd))
        hs.append(h.reshape(-1, h.shape[-1]))
        dyn.append(attention(params["encoder"]["mha"], h, n_head, rnd,
                             None if attn_u is None else attn_u[k],
                             rates[0]).reshape(-1, h.shape[-1]))
    h, dyn = torch.cat(hs), torch.cat(dyn)
    pn = params["encoder"]["pff_n1"]
    t = torch.tanh(_linear(pn["layers"][0], dyn, rnd))
    t = _linear(pn["layers"][1], _drop(t, pff_u, rates[1]), rnd)
    dyn = _ln(t + dyn, pn["ln"])
    out = (_ln(dyn, params["ln_dynamic"]) - _ln(h, params["ln_static"])) ** 2
    per_pos = _linear(params["pff_classifier"]["layers"][0], out, rnd)[:, 0]
    res, off = {}, 0
    for k in ks:
        n = xs[k].shape[0]
        res[k] = per_pos[off:off + n * k].view(n, k).mean(dim=-1)
        off += n * k
    return res


def recon_loss(params, tables, lay, xs: Dict[int, torch.Tensor],
               H: torch.Tensor, r: int, rnd: Rounding,
               block: int = 65_536) -> torch.Tensor:
    """x 100 mean over the tokens not on chromosome r of the squared error
    of r's decode of tanh(H[node]) against inter_z's row over r's
    columns, in blocks of tokens."""
    tok = torch.cat([xs[k].reshape(-1).long() for k in sorted(xs)])
    chrom = torch.as_tensor(lay.chrom_of_node(), device=tok.device)[tok]
    tok = tok[(chrom != r) & (tok != 0)]
    if tok.numel() == 0:
        return torch.zeros((), device=H.device)
    dec = params["embed"]["recon"][r]
    c0, w = lay.starts[r] - 1, lay.bins[r]
    total = torch.zeros((), device=H.device)
    for lo in range(0, tok.numel(), block):
        t = tok[lo:lo + block]
        pred = _linear(dec, torch.tanh(H[t]), rnd)
        target = tables.inter_z[t, c0:c0 + w].float()
        total = total + ((pred - target) ** 2).mean(dim=-1).sum()
    return total / tok.numel() * 100.0


def bce(lg: Dict[int, torch.Tensor], n_pos: Dict[int, int],
        ws: Dict[int, torch.Tensor], rows=None) -> torch.Tensor:
    """Mean over sizes of the weighted BCE of (positives; negatives) rows;
    rows: {k: row indices} to average over instead of all."""
    total = 0.0
    for k in sorted(lg):
        z = lg[k]
        y = torch.zeros_like(z)
        y[:n_pos[k]] = 1.0
        w = torch.ones_like(z)
        w[:n_pos[k]] = ws[k].float()
        loss = w * torch.nn.functional.binary_cross_entropy_with_logits(
            z, y, reduction="none")
        total = total + (loss.mean() if rows is None
                         else loss[rows[k]].mean())
    return total / len(lg)


class AdamW:
    """torch's AdamW update, written out (decoupled decay, bias-corrected
    moments, eps added to the corrected root)."""

    def __init__(self, leaves: List[torch.Tensor], lr: float, wd: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.leaves, self.lr, self.wd = leaves, lr, wd
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            p.mul_(1.0 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr / c1 * m / (v.sqrt() / math.sqrt(c2) + self.eps))
