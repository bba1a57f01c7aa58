"""Genome binning and the node dictionary.

The port's own copy of ``matcha_tpu/genome.py`` (numpy only): the PyTorch
package imports nothing of ``matcha_tpu``.

Re-implements the semantics of the reference's ``build_node_dict``
(ref: Code/process.py:10-39): every chromosome in ``chrom_list`` is cut into
``resolution``-sized bins; each bin gets a node id starting at **1** (0 is the
padding id).  A chromosome of size S contributes ``ceil(S/res) + 1`` bins
(bins 0..ceil inclusive, matching the reference's off-by-one-friendly loop).

Instead of Python dicts, the canonical representation here is a set of dense
arrays (TPU-friendly, O(1) vectorized lookup):

  chrom_range : (C, 2) int64 — per-chrom [first_node, one_past_last_node]
  node2chrom  : (N+1,) int32 — chromosome index per node (entry 0 unused)
  node2start  : (N+1,) int64 — genomic start coordinate per node

Dict views (bin2node/node2bin) are provided for artifact parity with the
reference's ``.npy`` outputs (ref: Code/process.py:36-39).
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import numpy as np


class GenomeBins:
    def __init__(self, chrom_names: Sequence[str], chrom_sizes: Sequence[int],
                 resolution: int):
        self.chrom_names = list(chrom_names)
        self.chrom_sizes = [int(s) for s in chrom_sizes]
        self.resolution = int(resolution)

        # bins per chromosome: ceil(size/res) + 1  (ref Code/process.py:23-31)
        self.bins_per_chrom = np.array(
            [math.ceil(s / self.resolution) + 1 for s in self.chrom_sizes],
            dtype=np.int64)
        ends = np.cumsum(self.bins_per_chrom) + 1          # node ids start at 1
        starts = ends - self.bins_per_chrom
        self.chrom_range = np.stack([starts, ends], axis=1)  # (C, 2)
        self.node_num = int(ends[-1])                      # == max(chrom_range)

        n = self.node_num
        self.node2chrom = np.zeros(n, dtype=np.int32)
        self.node2start = np.zeros(n, dtype=np.int64)
        for c in range(len(self.chrom_names)):
            s, e = self.chrom_range[c]
            self.node2chrom[s:e] = c
            self.node2start[s:e] = np.arange(e - s, dtype=np.int64) * self.resolution

        self._name2idx = {name: i for i, name in enumerate(self.chrom_names)}

    # ------------------------------------------------------------------ lookup
    @property
    def num_chroms(self) -> int:
        return len(self.chrom_names)

    @property
    def num_nodes(self) -> int:
        """Number of real nodes (excluding the padding id 0)."""
        return self.node_num - 1

    def coords_to_nodes(self, chroms: np.ndarray, coords: np.ndarray) -> np.ndarray:
        """Vectorized (chrom_idx, coordinate) -> node id (floored to bin)."""
        bins = np.asarray(coords, dtype=np.int64) // self.resolution
        return self.chrom_range[chroms, 0] + bins

    def node_for(self, chrom: str, coord: int) -> int:
        c = self._name2idx[chrom]
        return int(self.chrom_range[c, 0] + coord // self.resolution)

    def has_chrom(self, chrom: str) -> bool:
        return chrom in self._name2idx

    def chrom_index(self, chrom: str) -> int:
        return self._name2idx[chrom]

    # ------------------------------------------------------------- dict views
    def bin2node_dict(self) -> dict:
        """``{"chrom:coord": node}`` view (ref artifact bin2node.npy)."""
        out = {}
        for c, name in enumerate(self.chrom_names):
            s, e = self.chrom_range[c]
            for i, node in enumerate(range(s, e)):
                out[f"{name}:{i * self.resolution}"] = node
        return out

    def node2bin_dict(self) -> dict:
        return {v: k for k, v in self.bin2node_dict().items()}

    def node2chrom_dict(self) -> dict:
        return {n: int(self.node2chrom[n]) for n in range(1, self.node_num)}

    # ------------------------------------------------------------ persistence
    def save(self, temp_dir: str) -> None:
        """Write reference-layout artifacts (ref Code/process.py:36-39)."""
        os.makedirs(temp_dir, exist_ok=True)
        np.save(os.path.join(temp_dir, "chrom_range.npy"), self.chrom_range)
        np.save(os.path.join(temp_dir, "bin2node.npy"), self.bin2node_dict())
        np.save(os.path.join(temp_dir, "node2bin.npy"), self.node2bin_dict())
        np.save(os.path.join(temp_dir, "node2chrom.npy"), self.node2chrom_dict())
        np.save(os.path.join(temp_dir, "genome_meta.npy"),
                {"chrom_names": self.chrom_names,
                 "chrom_sizes": self.chrom_sizes,
                 "resolution": self.resolution})

    @classmethod
    def load(cls, temp_dir: str) -> "GenomeBins":
        meta = np.load(os.path.join(temp_dir, "genome_meta.npy"),
                       allow_pickle=True).item()
        return cls(meta["chrom_names"], meta["chrom_sizes"], meta["resolution"])

    @classmethod
    def from_chrom_sizes_file(cls, path: str, chrom_list: Sequence[str],
                              resolution: int) -> "GenomeBins":
        """Read a chrom-sizes TSV (ref Code/process.py:11-22); for duplicated
        chromosome rows the max size wins, as in the reference."""
        sizes: dict[str, int] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                name, size = line.split("\t")[:2]
                size = int(size)
                sizes[name] = max(size, sizes.get(name, 0))
        missing = [c for c in chrom_list if c not in sizes]
        if missing:
            raise ValueError(f"chromosomes missing from {path}: {missing}")
        return cls(list(chrom_list), [sizes[c] for c in chrom_list], resolution)
