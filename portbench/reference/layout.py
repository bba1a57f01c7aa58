"""The genome's node layout, worked out from a configuration's chromosome
sizes and resolution alone: MATCHA bins a chromosome of S bp into
ceil(S / resolution) + 1 nodes (reference ``Code/process.py``), numbers the
nodes from 1 in chromosome order, and keeps id 0 for padding."""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np


class Layout(NamedTuple):
    bins: List[int]          # nodes per chromosome
    starts: List[int]        # first node id of each chromosome
    n_nodes: int             # N (ids 1..N)

    @property
    def n_chroms(self) -> int:
        return len(self.bins)

    @property
    def f_max(self) -> int:
        return max(self.bins)

    def chrom_of_node(self) -> np.ndarray:
        """(N + 1,) int64 chromosome index of each id; id 0 takes 0."""
        out = np.zeros(self.n_nodes + 1, np.int64)
        for c, (s, b) in enumerate(zip(self.starts, self.bins)):
            out[s:s + b] = c
        return out


def layout(config: dict) -> Layout:
    g = config["genome"]
    bins = [math.ceil(int(s) / int(g["resolution"])) + 1
            for s in g["chrom_sizes"]]
    starts = (1 + np.concatenate([[0], np.cumsum(bins)[:-1]])).tolist()
    return Layout(bins, [int(s) for s in starts], int(sum(bins)))
