"""node2vec walks on the clique expansion of the hypergraph.

Semantics of the reference's ``random_walk.py`` (ref History_version/Code/
random_walk.py):

  * clique expansion: every hyperedge contributes weight 1 to each of its
    member pairs (ref read_graph :217-237)
  * first-order probs from node v:   w(v,x) / sqrt(degree(x))   (ref :84-93)
  * second-order probs for (t -> v -> x), degree-normalized p/q biasing
    (ref get_alias_edge :32-62):
        w(v,x)/p / sqrt(deg x)   if x == t
        w(v,x)   / sqrt(deg x)   if (x, t) is an edge
        w(v,x)/q / sqrt(deg x)   otherwise
    where degree(x) = sum of incident edge weights
  * walks: per start node, ``num_walks`` walks of ``walk_length``; dead-end
    nodes repeat themselves (ref node2vec_walk :172-197)

The per-walker Python loops + 100-process pool become flat alias tables +
lockstep vectorized simulation (walks/alias.py).  A copy of
``matcha_tpu/walks/clique.py`` (numpy and scipy): its walks are the JAX
package's, bit for bit, for one seed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.sparse import coo_matrix, csr_matrix

from matcha_tpu_torch.walks.alias import (AliasTables, build_alias_tables,
                                          simulate_second_order_walks)


def clique_expansion(num_nodes: int, hyperedges) -> csr_matrix:
    """(N, N) weighted adjacency: co-membership counts (ref read_graph)."""
    rows, cols = [], []
    for e in hyperedges:
        e = np.asarray(e)
        k = len(e)
        if k < 2:
            continue
        i, j = np.triu_indices(k, 1)
        rows.append(e[i])
        cols.append(e[j])
    if not rows:
        return csr_matrix((num_nodes, num_nodes), dtype=np.float64)
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    data = np.ones(len(r))
    m = coo_matrix((np.concatenate([data, data]),
                    (np.concatenate([r, c]), np.concatenate([c, r]))),
                   shape=(num_nodes, num_nodes)).tocsr()
    m.sum_duplicates()
    return m


def _first_order_tables(adj: csr_matrix, degree: np.ndarray) -> AliasTables:
    n = adj.shape[0]
    dists, values = [], []
    for v in range(n):
        s, e = adj.indptr[v], adj.indptr[v + 1]
        nbrs = adj.indices[s:e]
        w = adj.data[s:e] / np.sqrt(degree[nbrs])
        tot = w.sum()
        dists.append(w / tot if tot > 0 else w)
        values.append(nbrs)
    return build_alias_tables(dists, values)


def _second_order_tables(adj: csr_matrix, degree: np.ndarray, p: float,
                         q: float) -> Tuple[AliasTables, np.ndarray, csr_matrix]:
    """One table per DIRECTED edge (t, v): distribution over neighbors of v.

    Returns (tables, directed-edge keys sorted, key->table csr helper)."""
    n = adj.shape[0]
    dists, values, keys = [], [], []
    indptr, indices, data = adj.indptr, adj.indices, adj.data
    for v in range(n):
        s, e = indptr[v], indptr[v + 1]
        nbrs = indices[s:e]
        w = data[s:e]
        inv_sqrt_deg = 1.0 / np.sqrt(degree[nbrs])
        for t in nbrs:                      # incoming edge (t, v)
            # x == t  -> /p ; x adjacent to t -> 1 ; else /q  (ref :42-56)
            t_row = indices[indptr[t]:indptr[t + 1]]
            bias = np.full(len(nbrs), 1.0 / q)
            bias[np.isin(nbrs, t_row)] = 1.0
            bias[nbrs == t] = 1.0 / p
            pr = w * bias * inv_sqrt_deg
            tot = pr.sum()
            dists.append(pr / tot if tot > 0 else pr)
            values.append(nbrs)
            keys.append(t * n + v)
    keys = np.asarray(keys, dtype=np.int64)
    order = np.argsort(keys)
    dists = [dists[i] for i in order]
    values = [values[i] for i in order]
    return build_alias_tables(dists, values), keys[order], None


def clique_node2vec_walks(num_nodes: int, hyperedges, *, p: float = 2,
                          q: float = 0.25, num_walks: int = 10,
                          walk_length: int = 80,
                          seed: int = 0) -> np.ndarray:
    """-> (num_starts * num_walks, walk_length) int array of node ids.

    Defaults p=2, q=0.25 follow the legacy driver
    (ref History_version/Code/main_SPRITE.py argparse defaults)."""
    rng = np.random.default_rng(seed)
    adj = clique_expansion(num_nodes, hyperedges)
    degree = np.asarray(adj.sum(axis=1)).reshape(-1)

    first = _first_order_tables(adj, degree)
    second, edge_keys, _ = _second_order_tables(adj, degree, p, q)

    return simulate_second_order_walks(num_nodes, first, second, edge_keys,
                                       num_walks, walk_length, rng)
