"""``.mcool`` contact-matrix ingest.

Behavioural parity with ``parse_cool_contact`` (ref: Code/process.py:107-176):
reads ``resolutions/<res>/{bins,chroms,pixels}`` via h5py, maps cooler bin
indices to node ids, and accumulates symmetric dense intra-/inter-chromosomal
adjacency matrices of shape ``(node_num-1, node_num-1)`` (row r = node r+1).
Prefers the ``balanced`` pixel column over ``count``; NaN entries skipped.

The reference's per-pixel Python loop is replaced by vectorized scatter-adds.

A copy of ``matcha_tpu/data/mcool.py`` on the port's own modules (the
port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from matcha_tpu_torch.genome import GenomeBins


def _cool_bins_to_nodes(genome: GenomeBins, bin_chrom: np.ndarray,
                        bin_start: np.ndarray,
                        chrom_names: np.ndarray) -> np.ndarray:
    """Map cooler bin index -> node id; -1 for bins on excluded chromosomes."""
    name_to_idx = {c: i for i, c in enumerate(genome.chrom_names)}
    # cooler chrom column is an index into its own chroms/name table
    cool_to_ours = np.array(
        [name_to_idx.get(str(n), -1) for n in chrom_names], dtype=np.int64)
    ours = cool_to_ours[bin_chrom]
    valid = ours >= 0
    node = np.full(bin_chrom.shape[0], -1, dtype=np.int64)
    node[valid] = (genome.chrom_range[ours[valid], 0]
                   + bin_start[valid] // genome.resolution)
    return node


def contacts_from_arrays(genome: GenomeBins, bin1_node: np.ndarray,
                         bin2_node: np.ndarray, counts: np.ndarray,
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Accumulate (intra, inter) dense matrices from node-id pixel arrays."""
    n = genome.node_num - 1
    valid = (bin1_node > 0) & (bin2_node > 0) & ~np.isnan(counts)
    i = bin1_node[valid] - 1          # node ids start at 1 (ref :157-159)
    j = bin2_node[valid] - 1
    w = counts[valid].astype(np.float64)
    same = genome.node2chrom[i + 1] == genome.node2chrom[j + 1]

    intra = np.zeros((n, n), dtype=np.float64)
    inter = np.zeros((n, n), dtype=np.float64)
    np.add.at(intra, (i[same], j[same]), w[same])
    np.add.at(intra, (j[same], i[same]), w[same])
    np.add.at(inter, (i[~same], j[~same]), w[~same])
    np.add.at(inter, (j[~same], i[~same]), w[~same])
    return intra.astype(np.float32), inter.astype(np.float32)


def parse_mcool_contacts(path: str, genome: GenomeBins,
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Read an mcool file -> (intra_adj, inter_adj) float32 matrices.
    Needs h5py, imported here: loading or saving saved contacts does not."""
    import h5py
    with h5py.File(path, "r") as f:
        grp = f["resolutions"][str(genome.resolution)]
        bin_chrom = np.asarray(grp["bins"]["chrom"])
        bin_start = np.asarray(grp["bins"]["start"], dtype=np.int64)
        chrom_names = np.asarray(grp["chroms"]["name"]).astype("str")
        node_of_bin = _cool_bins_to_nodes(genome, bin_chrom, bin_start,
                                          chrom_names)
        pix = grp["pixels"]
        b1 = np.asarray(pix["bin1_id"], dtype=np.int64)
        b2 = np.asarray(pix["bin2_id"], dtype=np.int64)
        col = "balanced" if "balanced" in pix.keys() else "count"
        counts = np.asarray(pix[col], dtype=np.float64)
    return contacts_from_arrays(genome, node_of_bin[b1], node_of_bin[b2], counts)


def save_contacts(temp_dir: str, intra: np.ndarray, inter: np.ndarray) -> None:
    os.makedirs(temp_dir, exist_ok=True)
    np.save(os.path.join(temp_dir, "intra_adj.npy"), intra)
    np.save(os.path.join(temp_dir, "inter_adj.npy"), inter)


def load_contacts(temp_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    return (np.load(os.path.join(temp_dir, "intra_adj.npy")),
            np.load(os.path.join(temp_dir, "inter_adj.npy")))
