"""Closed-form all-pairs hyperedge scoring (the denoise fast path).

Port of ``matcha_tpu/apps/pairwise_fast.py``.  For a pair (k = 2) with the
diagonal masked, each position's softmax row has one key, the other member,
so the attention weights are exactly [0, 1] and the "dynamic" embedding of a
position is a function of the other node alone.  The model factorises into
per-node tables:

    h_n   = tanh(next_w(H[n] + attr_n))                 (the pre-attention x)
    A'_n  = fc1(concat_heads(W_v ln_v(h_n)))            (dynamic before pff)
    A_n   = LN1(pff_n1(A'_n))                           (per-position dynamic)
    S_n   = LN2(h_n)                                    (per-position static)
    logit(i,j) = mean over the two positions of  w.(A_other - S_self)^2 + b

which expands to rank-1 outer sums and one (M, d) x (d, M) product:

    alpha_n = w.A_n^2,  sigma_n = w.S_n^2,  M = (w * A) S^T
    logit(i,j) = b + (alpha_i + alpha_j + sigma_i + sigma_j) / 2 - M[i,j] - M[j,i]

Exact in eval mode, the diagonal (i, i) included.  Plain PyTorch on the
device of the frozen tables: the product is a matmul the JAX package
computes outside any kernel.  As there, the node table is encoded in the
compute dtype and the attribute projection in f32, so the tables after the
sum are f32 (bf16 + f32 promotes).
"""

from __future__ import annotations

import numpy as np
import torch

from matcha_tpu_torch.models.hypersagnn import (FrozenTables, ModelDims,
                                                encode_node_table)
from matcha_tpu_torch.models.modules import (feed_forward, layer_norm, linear,
                                             pff, tanh)


def _node_tables(params, frozen: FrozenTables, dims: ModelDims):
    """-> (A (N+1, d), S (N+1, d)) per-node dynamic and static tables."""
    table = encode_node_table(params, frozen, dims, train=False)
    attr = linear(params["attr_nn"], frozen.attr_table.float())
    h = tanh(feed_forward(params["next_w"], table + attr))      # (N+1, d)

    mha = params["encoder"]["mha"]
    v = layer_norm(mha["ln_v"], h) @ mha["wv"].to(h.dtype)       # (N+1, h*dk)
    a_raw = linear(mha["fc1"], v)                                # (N+1, d)
    a = layer_norm(params["ln_dynamic"],
                   pff(params["encoder"]["pff_n1"], a_raw, residual=True))
    s = layer_norm(params["ln_static"], h)
    return a, s


def pairwise_logits(params, frozen: FrozenTables, dims: ModelDims,
                    nodes: np.ndarray) -> torch.Tensor:
    """(M, M) raw f32 logits for every pair of the given node ids, on the
    tables' device; entry (i, j) scores the pair (nodes[i], nodes[j])."""
    with torch.inference_mode():
        a, s = _node_tables(params, frozen, dims)
        cl = params["pff_classifier"]["layers"][0]
        w = cl["w"][:, 0].to(a.dtype)                            # (d,)
        b = cl["b"][0].to(a.dtype)
        idx = torch.as_tensor(np.asarray(nodes, np.int64)).to(a.device)
        a = a[idx]
        s = s[idx]
        alpha = (a * a) @ w                                      # (M,)
        sigma = (s * s) @ w
        m = (a * w) @ s.T                                        # (M, M)
        half = 0.5 * (alpha + sigma)
        return (b + half[:, None] + half[None, :] - m - m.T).float()


def pairwise_proba_matrix(params, frozen, dims, genome, chrom_id: int,
                          ) -> np.ndarray:
    """Sigmoid pair probabilities (float64, on the host) for one
    chromosome's full bin range."""
    s, e = genome.chrom_range[chrom_id]
    logits = pairwise_logits(params, frozen, dims, np.arange(s, e))
    return 1.0 / (1.0 + np.exp(-logits.cpu().numpy().astype(np.float64)))
