"""SPRITE/ChIA-Drop ``.clusters`` file ingest.

Behavioural parity with the reference's ``parse_file`` (ref: Code/process.py:42-87):

  * one cluster per line: ``cluster_id<TAB>chrom:coord<TAB>chrom:coord...``
  * lines with < 2 raw members or > ``max_cluster_size * 50`` raw members skipped
  * members on chromosomes outside ``chrom_list`` dropped
  * coordinates floored to the bin grid, mapped to node ids
  * members deduplicated; clusters with > ``max_cluster_size`` distinct nodes
    or < 2 distinct nodes dropped
  * each surviving cluster is a **sorted tuple of distinct node ids**
    (the global hyperedge invariant, ref Code/main.py:587-588)

The output is a ragged list encoded TPU-style as a flat int32 member array +
int64 offsets (CSR), rather than a Python list of lists.

A copy of ``matcha_tpu/data/clusters.py`` on the port's own modules (the
port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from typing import Iterable, Tuple

import numpy as np

from matcha_tpu_torch.genome import GenomeBins


def _parse_lines(lines: Iterable[str], genome: GenomeBins,
                 max_cluster_size: int) -> Tuple[np.ndarray, np.ndarray]:
    res = genome.resolution
    name2idx = {c: i for i, c in enumerate(genome.chrom_names)}
    first_node = genome.chrom_range[:, 0]

    members: list[np.ndarray] = []
    sizes: list[int] = []
    raw_cap = max_cluster_size * 50

    for line in lines:
        parts = line.rstrip("\n").split("\t")[1:]
        n_raw = len(parts)
        if n_raw < 2 or n_raw > raw_cap:
            continue
        nodes = []
        for info in parts:
            chrom, _, coord = info.partition(":")
            ci = name2idx.get(chrom)
            if ci is None:
                continue
            nodes.append(first_node[ci] + int(coord) // res)
        uniq = np.unique(np.asarray(nodes, dtype=np.int32))  # dedup + sort
        n = uniq.shape[0]
        if n < 2 or n > max_cluster_size:
            continue
        members.append(uniq)
        sizes.append(n)

    if members:
        flat = np.concatenate(members).astype(np.int32)
    else:
        flat = np.zeros((0,), dtype=np.int32)
    offsets = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    return flat, offsets


def parse_clusters(path: str, genome: GenomeBins, max_cluster_size: int,
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a ``.clusters`` file -> (flat int32 members, int64 offsets).

    Uses the multithreaded mmap C++ parser when available (the Python
    line loop is hours on real 4DN-scale inputs); _parse_lines is the
    fallback and the oracle the native kernel is pinned against."""
    from matcha_tpu_torch.native import cluster_native
    if cluster_native.available():
        return cluster_native.parse_clusters(path, genome, max_cluster_size)
    with open(path) as f:
        return _parse_lines(f, genome, max_cluster_size)


def clusters_to_list(flat: np.ndarray, offsets: np.ndarray) -> list:
    """CSR -> Python list-of-lists (reference ``edge_list.npy`` layout)."""
    return [flat[offsets[i]:offsets[i + 1]].tolist()
            for i in range(len(offsets) - 1)]


def save_edge_list(temp_dir: str, flat: np.ndarray, offsets: np.ndarray,
                   ragged: str = "auto") -> None:
    """Persist the CSR arrays and (optionally) a reference-layout
    ``edge_list.npy``.  The ragged object array exists only for interop with
    reference-produced/consumed temp dirs; at 4DN scale (10M+ clusters) the
    pickle costs minutes and GBs, so ``ragged="auto"`` skips it above 2M
    clusters (``"on"``/``"off"`` force)."""
    os.makedirs(temp_dir, exist_ok=True)
    np.save(os.path.join(temp_dir, "edge_members.npy"), flat)
    np.save(os.path.join(temp_dir, "edge_offsets.npy"), offsets)
    n_clusters = len(offsets) - 1
    if ragged == "on" or (ragged == "auto" and n_clusters <= 2_000_000):
        arr = np.empty(n_clusters, dtype=object)
        arr[:] = clusters_to_list(flat, offsets)
        np.save(os.path.join(temp_dir, "edge_list.npy"), arr)


def load_edge_list(temp_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    csr_m = os.path.join(temp_dir, "edge_members.npy")
    csr_o = os.path.join(temp_dir, "edge_offsets.npy")
    if os.path.exists(csr_m) and os.path.exists(csr_o):
        return np.load(csr_m), np.load(csr_o)
    # fall back to the reference's ragged layout
    ragged = np.load(os.path.join(temp_dir, "edge_list.npy"), allow_pickle=True)
    sizes = [len(e) for e in ragged]
    flat = (np.concatenate([np.asarray(e) for e in ragged]).astype(np.int32)
            if len(ragged) else np.zeros((0,), np.int32))
    offsets = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    return flat, offsets
