"""Walk -> skip-gram node-embedding pretraining.

Port of ``matcha_tpu/walks/pretrain.py``.  The legacy reference path (ref
History_version/Code/main_SPRITE.py:640-765): hypergraph (or clique) random
walks -> walk strings -> gensim skip-gram -> the initial trainable
node-embedding table.  Here: vectorized host walks (their first-order
weights on ``device`` in the hypergraph mode) -> SGNS on ``device`` (K3 and
K4 on the card) -> a (N, dim) table for
``init_model(embedding_mode="table", table_init=...)``.
"""

from __future__ import annotations

from typing import Literal, Optional, Tuple

import numpy as np

from matcha_tpu_torch.walks.clique import clique_node2vec_walks
from matcha_tpu_torch.walks.hyper import hypergraph_walks
from matcha_tpu_torch.walks.skipgram import train_skipgram


def pretrain_node_embeddings(
        num_nodes: int, hyperedges, dim: int, *,
        walk_mode: Literal["hyper", "clique"] = "hyper",
        p: float = 2.0, q: float = 0.25, num_walks: int = 10,
        walk_length: int = 80, window: int = 10, epochs: int = 1,
        seed: int = 0, device="cuda",
        timings: Optional[dict] = None) -> Tuple[np.ndarray, np.ndarray]:
    """-> ((N, dim) embeddings for nodes 1..N, per-epoch SGNS losses).

    hyperedges use 1-based node ids (the framework convention); walks run on
    the 0-based view, as the legacy code does (ref random_walk_hyper.py
    toint :436-437).  ``timings`` receives the host-clock seconds of the
    walk build's phases, the walk simulation (hypergraph mode), the pair
    building and the SGNS epochs."""
    zero_based = [np.asarray(e) - 1 for e in hyperedges]
    if walk_mode == "hyper":
        walks = hypergraph_walks(num_nodes, zero_based, p=p, q=q,
                                 num_walks=num_walks,
                                 walk_length=walk_length, seed=seed,
                                 timings=timings, device=device)
    else:
        walks = clique_node2vec_walks(num_nodes, zero_based, p=p, q=q,
                                      num_walks=num_walks,
                                      walk_length=walk_length, seed=seed)
    emb, losses = train_skipgram(walks, num_nodes, dim, window=window,
                                 epochs=epochs, seed=seed, device=device,
                                 timings=timings)
    return emb, losses
