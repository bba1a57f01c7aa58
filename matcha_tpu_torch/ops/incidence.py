"""Incidence-structure ops over a padded hyperedge matrix (SpMM / SDDMM
family).

Port of ``matcha_tpu/ops/incidence.py``, which is XLA-only (no Pallas
kernel), so plain PyTorch is the port here.  The incidence structure is a
padded (E, k_max) matrix of node ids with 0 as padding:

  PaddedIncidence: (E, k_max) int32 node ids, 0 = padding
  edge_gather_sum: Y[e] = w_e * sum_{v in e} X[v]      (SpMM  E x N . N x d)
  node_scatter_add: Z[v] = sum_{e : v in e} Y[e]       (SpMM  N x E . E x d)
  pair_cooccurrence: W[u, v] = sum_{e ∋ u, v} w_e      (EV^T diag(w) EV)
  edge_sddmm: S[e] = sum_{u<v in e} <X[u], X[v]>       (hyperedge SDDMM)

``pair_cooccurrence`` backs the hypergraph walks' first-order transition
weights (``walks/hyper.py:cooccurrence_csr``), and their alias tables are
built from its values, so it must give the same bits on every call.  A
scatter-add with float atomics does not (the CPU's threaded
``index_put_(accumulate=True)`` differs from call to call at this size), so
it reduces in sorted-key order instead: a stable sort of the (u, v) keys,
one sum per run of equal keys (``segment_reduce``), one write per distinct
key.  ``chip_smoke.py`` phase 3 and ``tests/test_torch_cuda.py`` hold it
bit-equal across two calls on the card.  ``node_scatter_add`` is an
``index_add_`` (float atomics on the card: its sums may differ in the last
bits from call to call, as a segment sum may).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from matcha_tpu_torch.device import resolve_device


class PaddedIncidence(NamedTuple):
    """Padded hyperedge members: (E, k_max) int32 node ids, 0 = pad."""
    members: torch.Tensor

    @property
    def mask(self) -> torch.Tensor:
        return self.members != 0

    @classmethod
    def from_ragged(cls, hyperedges, k_max: Optional[int] = None,
                    device="cuda") -> "PaddedIncidence":
        sizes = [len(e) for e in hyperedges]
        k_max = k_max or (max(sizes) if sizes else 1)
        out = np.zeros((len(hyperedges), k_max), dtype=np.int32)
        for i, e in enumerate(hyperedges):
            out[i, :len(e)] = np.asarray(e)
        return cls(members=torch.from_numpy(out).to(resolve_device(device)))

    @classmethod
    def from_csr(cls, flat: np.ndarray, offsets: np.ndarray,
                 k_max: Optional[int] = None,
                 device="cuda") -> "PaddedIncidence":
        sizes = np.diff(offsets)
        k_max = k_max or int(sizes.max() if len(sizes) else 1)
        out = np.zeros((len(sizes), k_max), dtype=np.int32)
        for i in range(len(sizes)):
            out[i, :sizes[i]] = flat[offsets[i]:offsets[i + 1]]
        return cls(members=torch.from_numpy(out).to(resolve_device(device)))


def edge_gather_sum(inc: PaddedIncidence, node_feats: torch.Tensor,
                    edge_weight: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Y[e] = w_e * sum_{v in e} X[v].  node_feats: (N+1, d) with row 0
    zeros (the pad row makes masking free)."""
    y = node_feats[inc.members.long()].sum(dim=1)      # (E, d)
    if edge_weight is not None:
        y = y * edge_weight[:, None]
    return y


def node_scatter_add(inc: PaddedIncidence, edge_feats: torch.Tensor,
                     num_nodes: int) -> torch.Tensor:
    """Z[v] = sum_{e containing v} Y[e] -> (N+1, d); row 0 collects pads."""
    _, k = inc.members.shape
    flat_ids = inc.members.reshape(-1).long()
    flat_feats = edge_feats.repeat_interleave(k, dim=0)
    out = torch.zeros((num_nodes + 1,) + tuple(edge_feats.shape[1:]),
                      dtype=edge_feats.dtype, device=edge_feats.device)
    return out.index_add_(0, flat_ids, flat_feats)


def pair_cooccurrence(inc: PaddedIncidence, edge_weight: torch.Tensor,
                      num_nodes: int) -> torch.Tensor:
    """Dense node-node co-occurrence weights ``W[u, v] = sum over edges e
    containing both u and v of w_e`` (ref History_version/Code/
    random_walk_hyper.py:128-141, where w_e = 1/|e| gives the first-order
    transition weights), over the E*k^2 member pairs -> (N+1, N+1) with pad
    row/col 0 and the diagonal zeroed.  Each entry sums its pairs in edge
    order, the same bits on every call (module docstring).  The key u*(N+1)
    + v is int64 (the JAX package keeps a 2-D index because its int32 key
    overflows past ~46k nodes)."""
    m = inc.members.long()                               # (E, k), 0 = pad
    _, k = m.shape
    u = m.repeat_interleave(k, dim=1).reshape(-1)        # (E*k*k,)
    v = m.repeat(1, k).reshape(-1)
    w = edge_weight.repeat_interleave(k * k)
    keep = (u != 0) & (v != 0) & (u != v)
    n1 = num_nodes + 1
    out = torch.zeros(n1 * n1, dtype=edge_weight.dtype,
                      device=edge_weight.device)
    key, order = torch.sort((u * n1 + v)[keep], stable=True)
    if key.numel():
        first, counts = torch.unique_consecutive(key, return_counts=True)
        out[first] = torch.segment_reduce(w[keep][order], "sum",
                                          lengths=counts)
    return out.view(n1, n1)


def edge_sddmm(inc: PaddedIncidence, node_feats: torch.Tensor
               ) -> torch.Tensor:
    """S[e] = sum over unordered member pairs of <X[u], X[v]> — the sampled
    dense-dense product over the incidence sparsity.  Pad-safe via the zero
    row."""
    g = node_feats[inc.members.long()]              # (E, k, d)
    s = g.sum(dim=1)                                # (E, d)
    total = (s * s).sum(dim=-1)                     # ||sum||^2
    norms = (g * g).sum(dim=-1).sum(dim=-1)         # sum ||x_i||^2
    return 0.5 * (total - norms)
