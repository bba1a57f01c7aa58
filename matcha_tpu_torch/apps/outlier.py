"""Outlier-member detection: which member of a hyperedge does not belong?

Port of ``matcha_tpu/apps/outlier.py``.  The per-position classifier scores
(the signal before the masked mean of ``forward``) rank the members of a
hyperedge by anomaly; on a CUDA tensor the attention of an edge of 3 to 8
members at the kernel's width runs on K1.  Scoring goes in chunks of
``batch_size`` rows over one node-table encode, as ``apps/predict.py``
does; the rows are independent in eval mode, so the chunking does not
change a score.

Evaluation protocol (parity with the legacy ``generate_outlier_part``):
corrupt one position of each real hyperedge with a random node that forms
no known pair with the remaining members, then measure how often that
position ranks in the top-k most anomalous.
"""

from __future__ import annotations

from typing import Set, Tuple

import numpy as np
import torch

from matcha_tpu_torch.models.hypersagnn import encode_node_table, forward


def per_position_scores(params, frozen, dims, x: np.ndarray,
                        batch_size: int = 10_000) -> np.ndarray:
    """(B, L) per-position raw f32 scores; LOWER = more anomalous (the
    score feeds the hyperedge logit via the masked mean)."""
    x = np.asarray(x)
    device = frozen.attr_table.device
    parts = []
    with torch.inference_mode():
        node_table = encode_node_table(params, frozen, dims)
        for lo in range(0, len(x), batch_size):
            chunk = torch.as_tensor(x[lo:lo + batch_size].astype(np.int64))
            _, pos = forward(params, frozen, dims, chunk.to(device),
                             node_table=node_table, return_positions=True)
            parts.append(pos)
        if not parts:
            return np.zeros(x.shape, np.float32)
        return torch.cat(parts).cpu().numpy()


def rank_outliers(params, frozen, dims, x: np.ndarray, k: int = 3,
                  batch_size: int = 10_000) -> np.ndarray:
    """(B, k) position indices sorted most-anomalous-first (pads excluded)."""
    scores = per_position_scores(params, frozen, dims, x, batch_size)
    scores = np.where(x == 0, np.inf, scores)   # never pick pads
    return np.argsort(scores, axis=1)[:, :k]


def generate_outliers(edges: np.ndarray, known_pairs: Set[Tuple[int, int]],
                      num_nodes: int, rng: np.random.Generator,
                      per_edge: int = 20, max_trials: int = 100,
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Corrupt one random position per copy of each hyperedge with a node
    forming no known pair with the rest (ref generate_outlier_part
    semantics, generalized from its per-node-type ranges to any node)."""
    inputs, points = [], []
    for e in edges:
        point = int(rng.integers(0, len(e)))
        count = 0
        for _ in range(max_trials):
            if count >= per_edge:
                break
            j = int(rng.integers(1, num_nodes + 1))
            # check against the REMAINING members only: the replaced one
            # leaves the edge, so a pair with it alone is irrelevant
            if any((j, n) in known_pairs or (n, j) in known_pairs
                   for idx, n in enumerate(e) if idx != point):
                continue
            temp = np.copy(e)
            temp[point] = j
            inputs.append(temp)
            points.append(point)
            count += 1
    if not inputs:
        return np.zeros((0, edges.shape[1]), np.int32), np.zeros(0, np.int64)
    inputs, index = np.unique(np.asarray(inputs), axis=0, return_index=True)
    return inputs.astype(np.int32), np.asarray(points)[index]


def outlier_hit_rate(params, frozen, dims, inputs: np.ndarray,
                     points: np.ndarray, k: int = 3,
                     batch_size: int = 10_000) -> np.ndarray:
    """Cumulative top-1..top-k hit rates of the corrupted position
    (ref check_outlier's cumsum/size report)."""
    ranks = rank_outliers(params, frozen, dims, inputs, k=k,
                          batch_size=batch_size)
    hits = ranks == points[:, None]
    return hits.mean(axis=0).cumsum()
