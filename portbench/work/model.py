"""Model FLOPs of MATCHA's Hyper-SAGNN: the products the published model
needs, counted from the shapes (no recompute, no one-hot gathers, no
element-wise work).

Forward, for the node table: each chromosome's tied encoder over all its
rows, 2 n_c^2 d + 2 n_c d^2; the attribute projection over every row,
2 (N + 1)(C + 1) d.  Per token: next_w 2 d^2; the attention's projections
(q, k, v: 3 x 2 d hd with hd = n_head x d_k; fc1: 2 hd d), scores and
a @ v (2 x 2 L hd for a hyperedge of L members); for L = 2 the diagonal
mask leaves one key, so only v and fc1 are needed; the feed-forward
2 x 2 d^2 and the classifier 2 d.  Recon: one chromosome's decoder over
every node row, 2 (N + 1) d F with F the mean chromosome width.

Training multiplies each product by 3 (forward, and two products in the
backward) except the two whose input is frozen (the encoder's first
product and the attribute projection), which need no input gradient: x 2.
Scoring is the forward without the recon decode."""

from __future__ import annotations


def table_flops(bins, d, C):
    enc1 = sum(2 * b * b * d for b in bins)
    enc2 = sum(2 * b * d * d for b in bins)
    attr = 2 * (sum(bins) + 1) * (C + 1) * d
    return enc1 + attr, enc2


def token_flops(rows: dict, d: int, hd: int) -> int:
    """rows: {L: number of hyperedges of L members}."""
    total = 0
    for L, n in rows.items():
        per_tok = 2 * d * d + 4 * d * d + 2 * d
        per_tok += (2 * d * hd + 2 * hd * d if L == 2
                    else 3 * 2 * d * hd + 2 * hd * d + 4 * L * hd)
        total += n * L * per_tok
    return total


def step_flops(bins, d: int, hd: int, rows: dict, train: bool) -> float:
    C, N = len(bins), sum(bins)
    frozen_in, rest = table_flops(bins, d, C)
    tok = token_flops(rows, d, hd)
    if not train:
        return float(frozen_in + rest + tok)
    recon = 2 * (N + 1) * d * (N / C)
    return float(2 * frozen_in + 3 * (rest + tok + recon))
