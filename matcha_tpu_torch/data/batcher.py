"""Size-bucketed hyperedge batcher.

A copy of ``matcha_tpu/data/batcher.py`` (pure numpy; the port imports
nothing of the JAX package): per hyperedge size k an independent shuffled
ring buffer over fixed base arrays; small buckets are duplicated so every
epoch draws ``num_batch_per_iter * batch_size`` samples per size; the ring
wraps and reshuffles on exhaustion.  ``next_epoch`` returns per-k arrays of
shape ``(num_batch_per_iter, batch_size, k)``; ``next_epoch_indices`` returns
the same draw as indices into the base arrays, which the Trainer pins on the
card (``train_epoch_indexed``).  Both advance the same ring state, and one
seed gives the JAX package's index stream.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

Buckets = Dict[int, Tuple[np.ndarray, np.ndarray]]


class BucketedBatcher:
    def __init__(self, buckets: Buckets, batch_size: int,
                 num_batch_per_iter: int, seed: int = 0):
        self.batch_size = int(batch_size)
        self.num_batch_per_iter = int(num_batch_per_iter)
        self.rng = np.random.default_rng(seed)
        self.k_list = sorted(buckets.keys())
        self.base_edges: Dict[int, np.ndarray] = {}
        self.base_weights: Dict[int, np.ndarray] = {}
        self.order: Dict[int, np.ndarray] = {}
        self.pointer: Dict[int, int] = {}

        need = self.num_batch_per_iter * self.batch_size
        for k in self.k_list:
            e, w = buckets[k]
            e = np.asarray(e, dtype=np.int32)
            w = np.asarray(w, dtype=np.float32)
            if len(e) == 0:
                raise ValueError(f"empty bucket for k={k}")
            # duplicate small buckets until they cover one epoch draw
            # (ref Code/Modules.py:638-641)
            while len(e) <= need:
                e = np.concatenate([e, e])
                w = np.concatenate([w, w])
            self.base_edges[k], self.base_weights[k] = e, w
            self.order[k] = np.arange(len(e), dtype=np.int64)
            self._shuffle(k)
            self.pointer[k] = 0

    def _shuffle(self, k: int) -> None:
        # composing permutations on the index vector draws the same RNG
        # stream — and therefore the same row sequence — as permuting the
        # data arrays in place did
        self.order[k] = self.order[k][self.rng.permutation(len(self.order[k]))]

    def _draw_indices(self) -> Dict[int, np.ndarray]:
        """Advance the ring one epoch; per k, indices into base of shape
        (num_batch_per_iter, batch_size)."""
        need = self.num_batch_per_iter * self.batch_size
        out: Dict[int, np.ndarray] = {}
        for k in self.k_list:
            p = self.pointer[k]
            n = len(self.order[k])
            if p + need <= n:
                idx = self.order[k][p:p + need]
                self.pointer[k] = p + need
            else:
                head = self.order[k][p:n]
                self._shuffle(k)
                left = need - (n - p)
                idx = np.concatenate([head, self.order[k][:left]])
                self.pointer[k] = left
            out[k] = idx.reshape(self.num_batch_per_iter, self.batch_size)
        return out

    def next_epoch_indices(self) -> Dict[int, np.ndarray]:
        """One epoch's draw as int32 indices into the pinned base arrays
        (the device-resident epoch path gathers on device)."""
        return {k: v.astype(np.int32) for k, v in self._draw_indices().items()}

    def skip_epoch(self) -> None:
        """Advance the ring state without materializing the draw (resume
        fast-forward)."""
        self._draw_indices()

    def next_epoch(self) -> Buckets:
        """Draw one epoch: per k, arrays of shape (num_batch, batch, k) and
        (num_batch, batch).  Wraps + reshuffles per ring (ref :653-681)."""
        idxs = self._draw_indices()
        out: Buckets = {}
        for k in self.k_list:
            idx = idxs[k].reshape(-1)
            out[k] = (self.base_edges[k][idx].reshape(
                          self.num_batch_per_iter, self.batch_size, k),
                      self.base_weights[k][idx].reshape(
                          self.num_batch_per_iter, self.batch_size))
        return out

    def base_nbytes(self) -> int:
        """HBM cost of pinning the base arrays (Trainer budget check)."""
        return sum(self.base_edges[k].nbytes + self.base_weights[k].nbytes
                   for k in self.k_list)
