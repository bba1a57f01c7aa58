"""Frequency-band k-mer analysis app.

Port of ``matcha_tpu/apps/analysis_bands.py`` (host numpy and the native
k-mer counter where it builds; no device work), the same files: count
k-mers of a given size over the cluster set with all adjacent node-id gaps
> 5 (the legacy ``analysis_SPRITE.py`` rule,
ref History_version/Code/analysis_SPRITE.py:26-42,88-116,150-168), bin them
into frequency bands and write the banded tuple files the legacy scripts
train on (``{lo}_{hi}_{size}.npy``, ref main_SPRITE.py:580-591); the open
upper band is ``upper_{size}.npy``.

    python -m matcha_tpu_torch.apps.analysis_bands -c config.JSON -s 3
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np

from matcha_tpu_torch.data.kmers import count_kmers
from matcha_tpu_torch.data.store import split_by_frequency_bands

# ref analysis_SPRITE.py:24 thresh_list + the open upper band
DEFAULT_BANDS: Tuple[Tuple[int, int], ...] = (
    (2, 3), (3, 5), (5, 8), (8, 12), (12, -1))


def build_frequency_band_files(flat: np.ndarray, offsets: np.ndarray,
                               size: int, out_dir: str, *,
                               bands: Sequence[Tuple[int, int]] = DEFAULT_BANDS,
                               min_distance: int = 5,
                               max_cluster_size: int = 24,
                               verbose: bool = True,
                               ) -> Dict[Tuple[int, int], np.ndarray]:
    """Count + band-split + save; returns {(lo, hi): (N, size) kmers}.

    max_cluster_size defaults to 24: the reference's shrink step keeps
    clusters with ``size <= len < 25`` (analysis_SPRITE.py:50-52)."""
    kmers, freqs = count_kmers(flat, offsets, size, max_cluster_size,
                               min_distance)
    banded = split_by_frequency_bands(kmers, freqs, bands)
    os.makedirs(out_dir, exist_ok=True)
    for (lo, hi), rows in banded.items():
        name = (f"upper_{size}.npy" if hi < 0 else f"{lo}_{hi}_{size}.npy")
        np.save(os.path.join(out_dir, name), rows)
        if verbose:
            print(f"band [{lo},{'inf' if hi < 0 else hi}): {len(rows)} "
                  f"{size}-mers -> {name}")
    return banded


def main(argv=None):
    import argparse
    from matcha_tpu_torch.config import load_config
    from matcha_tpu_torch.data.clusters import load_edge_list
    p = argparse.ArgumentParser(
        description="frequency-band k-mer analysis (legacy analysis_SPRITE)")
    p.add_argument("-c", "--config", default=None, help="config.JSON path")
    p.add_argument("-s", "--size", type=int, default=3)
    p.add_argument("-o", "--out", default=None,
                   help="output dir (default: temp_dir)")
    p.add_argument("--min-distance", type=int, default=5)
    a = p.parse_args(argv)
    config = load_config(a.config)
    flat, offsets = load_edge_list(config.temp_dir)
    build_frequency_band_files(flat, offsets, a.size,
                               a.out or config.temp_dir,
                               min_distance=a.min_distance)


if __name__ == "__main__":
    main()
