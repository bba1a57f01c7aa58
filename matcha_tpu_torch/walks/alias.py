"""Flat-array alias method for batched walk simulation.

A copy of ``matcha_tpu/walks/alias.py`` (numpy only): the walks it draws are
the JAX package's, bit for bit, for one seed.  The reference builds
per-node/per-edge alias tables as Python dict-of-tuples and draws one sample
per Python call (ref History_version/Code/random_walk.py:119-162).  Here all
tables live in three flat arrays (probabilities, alias indices, neighbor
ids) addressed by an offsets vector, so ONE vectorized draw advances every
walker simultaneously.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


def alias_setup(probs: np.ndarray):
    """Vose alias construction for one distribution (semantics of ref
    alias_setup, History_version/Code/random_walk.py:119-149)."""
    k = len(probs)
    q = np.asarray(probs, dtype=np.float64) * k
    J = np.zeros(k, dtype=np.int64)
    smaller = [i for i in range(k) if q[i] < 1.0]
    larger = [i for i in range(k) if q[i] >= 1.0]
    while smaller and larger:
        small = smaller.pop()
        large = larger.pop()
        J[small] = large
        q[large] = q[large] + q[small] - 1.0
        (smaller if q[large] < 1.0 else larger).append(large)
    return J, q


class AliasTables(NamedTuple):
    """Many alias tables in flat storage."""
    offsets: np.ndarray    # (T+1,) start of table t
    prob: np.ndarray       # (sum sizes,) acceptance thresholds
    alias: np.ndarray      # (sum sizes,) alias indices (local)
    value: np.ndarray      # (sum sizes,) the sampled payload (neighbor ids)

    def draw(self, table_ids: np.ndarray, rng: np.random.Generator,
             ) -> np.ndarray:
        """Vectorized draw: one sample from each listed table."""
        table_ids = np.asarray(table_ids)
        start = self.offsets[table_ids]
        size = self.offsets[table_ids + 1] - start
        kk = np.floor(rng.random(len(table_ids)) * size).astype(np.int64)
        flat = start + kk
        accept = rng.random(len(table_ids)) < self.prob[flat]
        choice = np.where(accept, kk, self.alias[flat])
        return self.value[start + choice]

    def size(self, table_ids: np.ndarray) -> np.ndarray:
        table_ids = np.asarray(table_ids)
        return self.offsets[table_ids + 1] - self.offsets[table_ids]


def build_alias_tables(dists: Sequence, values: Sequence) -> AliasTables:
    """dists[t]: probability vector of table t; values[t]: payloads."""
    sizes = [len(d) for d in dists]
    offsets = np.zeros(len(dists) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    total = int(offsets[-1])
    prob = np.zeros(total)
    alias = np.zeros(total, dtype=np.int64)
    value = np.zeros(total, dtype=np.int64)
    for t, (d, v) in enumerate(zip(dists, values)):
        if len(d) == 0:
            continue
        J, q = alias_setup(np.asarray(d, dtype=np.float64))
        s, e = offsets[t], offsets[t + 1]
        prob[s:e] = q
        alias[s:e] = J
        value[s:e] = v
    return AliasTables(offsets, prob, alias, value)


def simulate_second_order_walks(num_nodes: int, first: AliasTables,
                                second: AliasTables, edge_keys: np.ndarray,
                                num_walks: int, walk_length: int,
                                rng: np.random.Generator) -> np.ndarray:
    """Lockstep node2vec-style walk simulation, shared by the clique and
    hypergraph walkers: step 1 draws first-order, steps 2+ draw second-order
    via a (prev, cur) edge-key lookup with first-order fallback after a
    dead-end repeat (prev == cur has no edge key); dead ends repeat their
    node (ref random_walk.py:193-195).  Returns (num_nodes * num_walks,
    walk_length) walks, shuffled (ref simulate_walks shuffles)."""
    starts = np.repeat(np.arange(num_nodes), num_walks)
    walks = np.zeros((len(starts), walk_length), dtype=np.int64)
    walks[:, 0] = starts
    has_nbr = first.size(np.arange(num_nodes)) > 0

    if walk_length > 1:
        cur = starts
        nxt = cur.copy()
        live = has_nbr[cur]
        if live.any():
            nxt[live] = first.draw(cur[live], rng)
        walks[:, 1] = nxt

    for step in range(2, walk_length):
        prev, cur = walks[:, step - 2], walks[:, step - 1]
        live = has_nbr[cur]
        nxt = cur.copy()                    # dead ends repeat
        if live.any():
            key = prev[live] * num_nodes + cur[live]
            tid = np.searchsorted(edge_keys, key)
            valid = (tid < len(edge_keys)) & (edge_keys[np.minimum(
                tid, len(edge_keys) - 1)] == key)
            sub = np.zeros(live.sum(), dtype=np.int64)
            if valid.any():
                sub[valid] = second.draw(tid[valid], rng)
            if (~valid).any():
                sub[~valid] = first.draw(cur[live][~valid], rng)
            nxt[live] = sub
        walks[:, step] = nxt

    return walks[rng.permutation(len(walks))]
