"""Hyperedge store: quantile labeling, positive/unlabeled selection, splits.

A copy of ``matcha_tpu/data/store.py`` (the port imports nothing of the JAX
package), with scikit-learn's quantile transform replaced by
``quantile_transform`` below: the machine with the card has no scikit-learn.
Mirrors the label/weight preparation of the reference's main script
(ref: Code/main.py:548-603,646-667):

  * per k independently: frequency -> quantile transform (1,000 quantiles,
    uniform output) -> weight in [0,1]
  * positives: weight > quantile_cutoff_for_positive
  * unlabeled (negative-sampler rejection set): weight > quantile_cutoff_for_unlabel
  * positive weights mean-normalized over all sizes combined, then * neg_num
  * 80/20 random train/test split over the combined positive set

Edges live in per-k buckets of static shape ``(N_k, k)``.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np

N_QUANTILES = 1000
SUBSAMPLE = 10_000


def quantile_transform(freqs: np.ndarray, random_state=None) -> np.ndarray:
    """Frequency -> uniform quantile weight (f32): what scikit-learn's
    ``QuantileTransformer(n_quantiles=1000, output_distribution="uniform",
    subsample=10_000).fit_transform`` computes on the f32 column, which is
    the reference's transform (ref Code/main.py:555).

    ``min(1000, n)`` quantiles at ``linspace(0, 100, .)`` percent of the
    column (``np.nanpercentile``, made non-decreasing); each value maps to
    the mean of the interpolation up the quantiles and down them (ties
    share their mid rank); values equal to the first or last quantile map
    to exactly 0 and 1.  Above 10,000 rows the quantiles come from 10,000
    rows drawn without replacement by ``random_state`` (None: numpy's
    global RandomState, as scikit-learn; an int seeds a RandomState; or a
    RandomState)."""
    col = np.asarray(freqs, dtype=np.float32).reshape(-1)
    n = col.shape[0]
    n_quantiles = max(1, min(N_QUANTILES, n))
    references = np.linspace(0, 1, n_quantiles, endpoint=True)
    fit = col
    if n > SUBSAMPLE:
        if random_state is None:
            rs = np.random.mtrand._rand
        elif isinstance(random_state, np.random.RandomState):
            rs = random_state
        else:
            rs = np.random.RandomState(random_state)
        index = np.arange(n)
        rs.shuffle(index)
        fit = col[index[:SUBSAMPLE]]
    quantiles = np.maximum.accumulate(
        np.nanpercentile(fit[:, None], references * 100, axis=0))[:, 0]
    out = col.copy()
    lower = out == quantiles[0]
    upper = out == quantiles[-1]
    finite = ~np.isnan(out)
    x = out[finite]
    out[finite] = 0.5 * (np.interp(x, quantiles, references)
                         - np.interp(-x, -quantiles[::-1], -references[::-1]))
    out[upper] = 1
    out[lower] = 0
    return out


Bucketed = Dict[int, Tuple[np.ndarray, np.ndarray]]   # k -> (edges, weights)


def split_by_frequency_bands(kmers: np.ndarray, freqs: np.ndarray,
                             bands: Sequence[Tuple[int, int]],
                             ) -> Dict[Tuple[int, int], np.ndarray]:
    """Split k-mers into frequency bands [lo, hi) (the legacy scripts train
    on banded tuple files [3,5),[5,8),[8,12),[12,inf) —
    ref History_version/Code/main_SPRITE.py:580-591).  Pass hi=-1 for an
    open upper band."""
    out = {}
    for lo, hi in bands:
        mask = freqs >= lo if hi < 0 else (freqs >= lo) & (freqs < hi)
        out[(lo, hi)] = kmers[mask]
    return out


class HyperedgeStore:
    """Per-k positive hyperedges + weights, train/test split, unlabeled set.

    The split and, above 10,000 k-mers of one size, the quantile subsample
    draw from ``seed``, so a run repeats; the JAX package draws that
    subsample unseeded."""

    def __init__(self, kmer_data: Dict[int, Tuple[np.ndarray, np.ndarray]],
                 *, quantile_cutoff_for_positive: float,
                 quantile_cutoff_for_unlabel: float, neg_num: int,
                 split: float = 0.8, seed: int = 0):
        self.k_list = sorted(kmer_data.keys())
        rng = np.random.default_rng(seed)
        subsample_rs = np.random.RandomState(seed)

        pos_edges, pos_weights, pos_sizes = [], [], []
        unlabeled: Dict[int, np.ndarray] = {}
        for k in self.k_list:
            kmers, freqs = kmer_data[k]
            kmers = np.asarray(kmers, dtype=np.int32)
            w = quantile_transform(freqs, subsample_rs)
            pos_mask = w > quantile_cutoff_for_positive
            unl_mask = w > quantile_cutoff_for_unlabel
            pos_edges.append(kmers[pos_mask])
            pos_weights.append(w[pos_mask].astype(np.float32))
            pos_sizes.append(np.full(pos_mask.sum(), k, dtype=np.int32))
            unlabeled[k] = kmers[unl_mask]

        weights = np.concatenate(pos_weights) if pos_weights else np.zeros(0, np.float32)
        # mean-normalize over ALL sizes combined, then * neg_num (ref :594-595)
        if weights.size:
            weights = weights / weights.mean() * neg_num
        sizes = np.concatenate(pos_sizes) if pos_sizes else np.zeros(0, np.int32)

        # 80/20 split over the combined set (ref :598-603)
        n = weights.size
        index = rng.permutation(n)
        cut = int(split * n)
        train_idx, test_idx = index[:cut], index[cut:]

        self.train: Bucketed = self._bucket(pos_edges, weights, sizes, train_idx)
        self.test: Bucketed = self._bucket(pos_edges, weights, sizes, test_idx)
        self.unlabeled: Dict[int, np.ndarray] = unlabeled

    def _bucket(self, pos_edges: Sequence[np.ndarray], weights: np.ndarray,
                sizes: np.ndarray, idx: np.ndarray) -> Bucketed:
        # reconstruct flat per-row access into the per-k arrays
        out: Bucketed = {}
        offsets = np.cumsum([0] + [len(e) for e in pos_edges])
        for ki, k in enumerate(self.k_list):
            lo, hi = offsets[ki], offsets[ki + 1]
            rows = idx[(idx >= lo) & (idx < hi)]
            out[k] = (pos_edges[ki][rows - lo], weights[rows])
        return out

    def train_sizes(self) -> Dict[int, int]:
        return {k: len(v[0]) for k, v in self.train.items()}

    def save(self, temp_dir: str) -> None:
        """Write the buckets as the JAX package's ``save`` does, file for
        file: ``{train,test}_<k>_{edges,weights}.npy`` and
        ``unlabeled_<k>_edges.npy``."""
        os.makedirs(temp_dir, exist_ok=True)
        for k in self.k_list:
            for name, bucket in (("train", self.train), ("test", self.test)):
                e, w = bucket[k]
                np.save(os.path.join(temp_dir, f"{name}_{k}_edges.npy"), e)
                np.save(os.path.join(temp_dir, f"{name}_{k}_weights.npy"), w)
            np.save(os.path.join(temp_dir, f"unlabeled_{k}_edges.npy"),
                    self.unlabeled[k])

    @classmethod
    def from_temp_dir(cls, temp_dir: str, k_list: Sequence[int], *,
                      quantile_cutoff_for_positive: float,
                      quantile_cutoff_for_unlabel: float, neg_num: int,
                      split: float = 0.8, seed: int = 0) -> "HyperedgeStore":
        """Build from reference-layout k-mer artifacts
        (``all_<k>_counter.npy`` etc., ref Code/main.py:552-553)."""
        data = {}
        for k in k_list:
            kmers = np.load(os.path.join(temp_dir, f"all_{k}_counter.npy")
                            ).astype(np.int32)
            freqs = np.load(os.path.join(temp_dir, f"all_{k}_freq_counter.npy")
                            ).astype(np.float32)
            data[int(k)] = (kmers, freqs)
        return cls(data,
                   quantile_cutoff_for_positive=quantile_cutoff_for_positive,
                   quantile_cutoff_for_unlabel=quantile_cutoff_for_unlabel,
                   neg_num=neg_num, split=split, seed=seed)
