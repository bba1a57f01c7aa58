"""True hypergraph random walks over the incidence structure.

Semantics of the reference's ``random_walk_hyper.py`` (ref History_version/
Code/random_walk_hyper.py):

  * incidence matrices EV (E x N), VE, and degree-normalized
    EV_over_delta = diag(1/sqrt(|e|)) EV  (ref build_graph :84-126)
  * first-order weight src->dst:
        ff(src,dst) = sum_{e ∋ src,dst} 1/|e|          (the VE_od @ EV_od SpMM,
        ref get_first_order_part :128-141)
    prob ∝ ff / sqrt(node_degree(dst))
  * second-order (src -> dst -> x) over x in nbr(dst)
    (ref get_alias_n2n_2nd :222-254), with weight_1st=1, weight_degree=-0.5:
        pp = 1/q
        pp /= p  if x co-occurs in a hyperedge with some e ∋ {src,dst}
                 (i.e. x belongs to at least one hyperedge containing both)
        pp *= q  if x == src or x adjacent to src
        prob ∝ pp * ff(dst,x) * node_degree(x)^-0.5
  * walks as in the clique walker; node ids here are 0-based (the reference
    shifts its 1-based hyperedges down by one, ref toint :436-437)

The first-order SpMM runs on the device as one scatter-add over padded
member pairs (ops.incidence.pair_cooccurrence; the reference recomputes rows
per node across an 80-process pool), falling back to scipy above the
dense-buffer cap; tabulation is vectorized per (src,dst) with CSR set
intersections; simulation reuses the flat alias walker.

A copy of ``matcha_tpu/walks/hyper.py`` (numpy and scipy) whose "device"
co-occurrence backend runs the port's ``pair_cooccurrence`` on ``device``
(the card unless the caller names the CPU); the walks equal the JAX
package's, bit for bit, for one seed and backend.  ``timings`` keeps the
phases' host-clock seconds unrounded.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import csr_matrix

from matcha_tpu_torch import telemetry
from matcha_tpu_torch.ops.incidence import PaddedIncidence, pair_cooccurrence

from matcha_tpu_torch.walks.alias import (build_alias_tables,
                                          simulate_second_order_walks)


def incidence_matrices(num_nodes: int, hyperedges):
    """EV (E x N) binary incidence + degree-normalized variant."""
    indptr = np.zeros(len(hyperedges) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in hyperedges], out=indptr[1:])
    indices = np.concatenate([np.asarray(e) for e in hyperedges]) \
        if len(hyperedges) else np.zeros(0, np.int64)
    data = np.ones(len(indices), dtype=np.float32)
    EV = csr_matrix((data, indices, indptr),
                    shape=(len(hyperedges), num_nodes))
    sizes = np.asarray(EV.sum(axis=1)).reshape(-1)
    inv_sqrt = 1.0 / np.sqrt(np.maximum(sizes, 1))
    EV_od = csr_matrix(EV.multiply(inv_sqrt[:, None]))
    return EV, EV_od


# dense (N+1)^2 f32 device buffer cap for the on-device co-occurrence path
_DEVICE_COOC_MAX_BYTES = 2 << 30


def cooccurrence_csr(num_nodes: int, hyperedges, backend: str = "auto",
                     ev_matrices=None, device="cuda"):
    """First-order walk weights ``W[u,v] = sum_{e ∋ u,v} 1/|e|`` (diagonal
    dropped) as scipy CSR — the ``VE_od @ EV_od`` product of
    ref random_walk_hyper.py:128-141.

    backend:
      "device" — one scatter-add over padded member pairs on ``device``
        (ops.incidence.pair_cooccurrence), then a single transfer of the
        dense result; at walk scale (≈3k nodes @ 1 Mb) this replaces the
        scipy SpMM entirely.
      "scipy"  — host CSR product.
      "auto"   — device when the dense (N+1)^2 buffer is < 2 GB, else scipy.
    """
    if backend == "auto":
        dense_bytes = 4 * (num_nodes + 1) ** 2
        backend = "device" if dense_bytes < _DEVICE_COOC_MAX_BYTES else "scipy"
    if backend == "device":
        # walk node ids are 0-based (ref toint :436-437); the padded
        # incidence reserves id 0 for padding -> shift up by one
        shifted = [np.asarray(e, dtype=np.int64) + 1 for e in hyperedges]
        inc = PaddedIncidence.from_ragged(shifted, device=device)
        w_e = torch.tensor([1.0 / max(len(e), 1) for e in hyperedges],
                           dtype=torch.float32, device=inc.members.device)
        W = pair_cooccurrence(inc, w_e, num_nodes).cpu().numpy()[1:, 1:]
        W = csr_matrix(W)
    else:
        # callers that already built the incidence matrices pass them in —
        # at scipy-fallback scale (num_nodes past the 2 GB dense cap) a
        # second full CSR construction is the setup bottleneck
        EV_od = (ev_matrices[1] if ev_matrices is not None
                 else incidence_matrices(num_nodes, hyperedges)[1])
        W = (EV_od.T @ EV_od).tocsr()
        W.setdiag(0)
    W.eliminate_zeros()
    W.sort_indices()
    return W


def first_order_tables(W, node_degree):
    """First-order alias tables: prob(dst | src) ∝ ff/sqrt(deg(dst))
    (ref get_first_order_part :128-141)."""
    num_nodes = W.shape[0]
    dists, values = [], []
    for v in range(num_nodes):
        s, e = W.indptr[v], W.indptr[v + 1]
        nbrs = W.indices[s:e]
        w = W.data[s:e] / np.sqrt(np.maximum(node_degree[nbrs], 1))
        tot = w.sum()
        dists.append(w / tot if tot > 0 else w)
        values.append(nbrs)
    return build_alias_tables(dists, values)


def _second_order_dst(dst, W, EV, VE, node_degree, p, q):
    """All directed (src -> dst) second-order rows for one dst, vectorized
    over src: the per-src "shares a hyperedge containing dst" test becomes
    the boolean of ONE sparse product B.T @ B with B = EV[edges ∋ dst][:,
    dst_nbr] — the triangle condition ∃e ⊇ {src, dst, x} — replacing the
    per-(src,dst) member-set intersections the reference tabulates across
    an 80-process pool (ref get_alias_n2n_2nd :222-254).
    Returns (dists2, values2, keys2) lists."""
    num_nodes = W.shape[0]
    s, e = W.indptr[dst], W.indptr[dst + 1]
    dst_nbr = W.indices[s:e]
    n = len(dst_nbr)
    if n == 0:
        return [], [], []
    ff_deg = W.data[s:e] * node_degree[dst_nbr] ** -0.5
    e_dst = VE.indices[VE.indptr[dst]:VE.indptr[dst + 1]]
    # C[src_i, x_j] = 1  iff some hyperedge contains {src, dst, x}
    B = EV[e_dst][:, dst_nbr]                       # (|e_dst|, n) sparse
    C = np.asarray((B.T @ B).todense() > 0)         # (n, n) bool
    # back[src_i, x_j] = x ∈ nbr(src) or x == src   (ref :234-238)
    back = np.asarray(W[dst_nbr][:, dst_nbr].todense() > 0)
    np.fill_diagonal(back, True)
    PP = np.full((n, n), 1.0 / q)
    PP[C] /= p                                      # ref :231-232
    PP[back] *= q
    PR = PP * ff_deg[None, :]                       # ref :246-249
    tots = PR.sum(axis=1)
    ok = tots > 0
    PR[ok] /= tots[ok, None]
    dists2 = list(PR)
    values2 = [dst_nbr] * n
    keys2 = (dst_nbr.astype(np.int64) * num_nodes + dst).tolist()
    return dists2, values2, keys2


def second_order_tables(W, EV, node_degree, *, p: float = 2,
                        q: float = 0.25):
    """Second-order alias tables per directed (src, dst) pair.
    Returns (tables, edge_keys sorted ascending)."""
    VE = EV.T.tocsr()
    EV = EV.tocsr()
    num_nodes = W.shape[0]
    dists2, values2, keys2 = [], [], []
    for dst in range(num_nodes):
        d2, v2, k2 = _second_order_dst(dst, W, EV, VE, node_degree, p, q)
        dists2 += d2
        values2 += v2
        keys2 += k2
    keys2 = np.asarray(keys2, dtype=np.int64)
    order = np.argsort(keys2)
    second = build_alias_tables([dists2[i] for i in order],
                                [values2[i] for i in order])
    return second, keys2[order]


def build_walk_tables(num_nodes: int, hyperedges, *, p: float = 2,
                      q: float = 0.25, weight_backend: str = "auto",
                      timings: dict | None = None, device="cuda"):
    """Full table-construction phase of the hypergraph walker:
    incidence -> co-occurrence weights -> first/second-order alias tables.
    timings: optional dict that receives per-phase host seconds (telemetry
    spans) and the weights' nonzero count."""
    with telemetry.span("incidence", into=timings):
        ev_mats = incidence_matrices(num_nodes, hyperedges)
        EV = ev_mats[0]
        node_degree = np.asarray(EV.sum(axis=0)).reshape(-1)
    # ff = VE_od @ EV_od : (N, N) node-node weights, diagonal removed —
    # computed on device by default (see cooccurrence_csr)
    with telemetry.span("cooccurrence", into=timings):
        W = cooccurrence_csr(num_nodes, hyperedges, backend=weight_backend,
                             ev_matrices=ev_mats, device=device)
    with telemetry.span("first_order", into=timings):
        first = first_order_tables(W, node_degree)
    with telemetry.span("second_order", into=timings):
        second, edge_keys = second_order_tables(W, EV, node_degree, p=p,
                                                q=q)
    if timings is not None:
        timings["w_nnz"] = int(W.nnz)
    return first, second, edge_keys


def hypergraph_walks(num_nodes: int, hyperedges, *, p: float = 2,
                     q: float = 0.25, num_walks: int = 10,
                     walk_length: int = 80, seed: int = 0,
                     weight_backend: str = "auto",
                     timings: dict | None = None,
                     device="cuda") -> np.ndarray:
    """-> (num_nodes * num_walks, walk_length) walks (0-based node ids)."""
    rng = np.random.default_rng(seed)
    first, second, edge_keys = build_walk_tables(
        num_nodes, hyperedges, p=p, q=q, weight_backend=weight_backend,
        timings=timings, device=device)
    # lockstep simulation — the same walker as the clique path
    with telemetry.span("simulate", into=timings):
        walks = simulate_second_order_walks(num_nodes, first, second,
                                            edge_keys, num_walks,
                                            walk_length, rng)
    return walks
