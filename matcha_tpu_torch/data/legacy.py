"""Legacy (History_version) preprocessing surfaces.

A copy of ``matcha_tpu/data/legacy.py`` (numpy; pandas inside
``parse_contact_pairs``): the port imports nothing of the JAX package.
The manuscript pipeline's low-frequency node filter, and its text
pair-list contact ingest (``parse_contact_pairs``).

The low-frequency node filter
(ref: History_version/Code/process_SPRITE.py:93-161) — drop every node that
appears in <= ``min_freq`` clusters (frequency counted only over clusters of
size <= ``freq_count_cap``), renumber the survivors contiguously from 1,
rewrite every cluster with dropped members removed (keeping clusters that
retain >= 2 members), and remap the per-chromosome node ranges.

The reference does this with four Python dicts and three passes over the
ragged edge list.  Its renumbering collapses to one closed form: for any node
``n``, the number of surviving nodes with id < n, plus one — which equals
``cumsum(survived)[n]`` for survivors and ``cumsum(survived)[n] + 1`` for
dropped boundary nodes (the reference's ``node2newnode`` vs
``dropnode2newnode`` split, process_SPRITE.py:105-118).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class NodeFilterResult:
    flat: np.ndarray          # filtered CSR members (new node ids)
    offsets: np.ndarray       # filtered CSR offsets
    chrom_range: np.ndarray   # (C, 2) remapped [first, one_past_last]
    node2newnode: np.ndarray  # (old_node_num,) old id -> new id; 0 = dropped
    survived: np.ndarray      # (old_node_num,) bool per old node
    node_freq: np.ndarray     # (old_node_num,) counted frequency per old node

    @property
    def new_node_num(self) -> int:
        """One past the largest new node id (= reference's final ``count``)."""
        return int(self.survived.sum()) + 1


def filter_low_frequency_nodes(flat: np.ndarray, offsets: np.ndarray,
                               chrom_range: np.ndarray, *,
                               min_freq: int = 50,
                               freq_count_cap: int = 25) -> NodeFilterResult:
    """Drop nodes with cluster frequency <= ``min_freq`` and renumber.

    Matches History_version/Code/process_SPRITE.py:93-161: frequency is
    counted over clusters with <= ``freq_count_cap`` members (:95-99), the
    drop set is ``freq <= min_freq`` (:102), surviving nodes are renumbered
    1..S in ascending order (:109-117), clusters keep only surviving members
    and must retain >= 2 (:134-141), and chromosome range boundaries map
    through the renumbering with dropped boundaries snapping to the next
    surviving id (:143-156).
    """
    chrom_range = np.asarray(chrom_range, dtype=np.int64)
    node_num = int(chrom_range.max())          # one past the last old node id
    sizes = np.diff(offsets)

    keep_for_freq = np.repeat(sizes <= freq_count_cap, sizes)
    node_freq = np.bincount(flat[keep_for_freq], minlength=node_num + 1)

    survived = node_freq > min_freq
    survived[0] = False                         # 0 is the padding id
    survived[node_num:] = False                 # the one-past-end sentinel

    # survivors_upto[n] = number of surviving nodes with id <= n
    survivors_upto = np.cumsum(survived)
    node2newnode = np.where(survived, survivors_upto, 0).astype(np.int64)
    # boundary map: a dropped boundary snaps to 1 + (#survivors < n)
    boundary_id = survivors_upto + (~survived).astype(np.int64)
    new_chrom_range = boundary_id[chrom_range]

    # rewrite clusters: keep surviving members (already sorted / distinct,
    # and renumbering is monotone so they stay sorted), need >= 2 left
    member_kept = survived[flat]
    # segment-sum via cumsum difference (add.reduceat raises on a trailing
    # empty cluster — offsets[i] == len(flat) — and silently reads a
    # neighboring element for interior empty segments)
    csum = np.concatenate([[0], np.cumsum(member_kept.astype(np.int64))])
    new_sizes = csum[offsets[1:]] - csum[offsets[:-1]]
    edge_kept = new_sizes >= 2
    new_flat = node2newnode[flat[member_kept & np.repeat(edge_kept, sizes)]]
    new_flat = new_flat.astype(np.int32)
    kept_sizes = new_sizes[edge_kept]
    new_offsets = np.zeros(kept_sizes.shape[0] + 1, dtype=np.int64)
    np.cumsum(kept_sizes, out=new_offsets[1:])

    return NodeFilterResult(new_flat, new_offsets, new_chrom_range,
                            node2newnode, survived,
                            node_freq[:node_num].astype(np.int64))


def parse_contact_pairs(path: str, genome) -> tuple[np.ndarray, np.ndarray]:
    """Legacy text pair-list contact ingest
    (ref History_version/Code/process_SPRITE.py:164-202): a TSV with columns
    ``chrom1 start1 chrom2 start2 balanced`` accumulated into symmetric dense
    ``intra_adj`` / ``inter_adj`` of shape (node_num-1, node_num-1).

    Reference rules preserved: rows with a chromosome outside the genome's
    list or a NaN ``balanced`` weight are skipped; a start coordinate that is
    not an exact bin start (not in the ``bin2node`` dict) skips the row
    (:186-188, the ref prints it); both (i, j) and (j, i) are incremented, so
    a self-pair lands 2w on the diagonal (:191-196, quirk preserved).

    Vectorized pandas/numpy replacement for the reference's per-row loop.
    """
    import pandas as pd

    # dtype=str: bare-numeric chromosome names (Ensembl "1", "2") would
    # otherwise be inferred as int64 and miss every str key in _name2idx
    df = pd.read_table(path, sep="\t",
                       dtype={"chrom1": str, "chrom2": str})
    n = genome.num_nodes
    intra = np.zeros((n, n))
    inter = np.zeros((n, n))
    if len(df) == 0:
        return intra, inter

    c1 = df["chrom1"].map(genome._name2idx).to_numpy(dtype=np.float64,
                                                     na_value=np.nan)
    c2 = df["chrom2"].map(genome._name2idx).to_numpy(dtype=np.float64,
                                                     na_value=np.nan)
    s1 = df["start1"].to_numpy(np.int64)
    s2 = df["start2"].to_numpy(np.int64)
    w = df["balanced"].to_numpy(np.float64)

    res = genome.resolution
    bins = genome.bins_per_chrom
    keep = ~np.isnan(c1) & ~np.isnan(c2) & ~np.isnan(w)
    ci1 = np.where(keep, c1, 0).astype(np.int64)
    ci2 = np.where(keep, c2, 0).astype(np.int64)
    # "bin in bin2node": exact nonneg bin-start coord within the chromosome
    keep &= (s1 >= 0) & (s1 % res == 0) & (s1 // res < bins[ci1])
    keep &= (s2 >= 0) & (s2 % res == 0) & (s2 // res < bins[ci2])

    ci1, ci2, s1, s2, w = ci1[keep], ci2[keep], s1[keep], s2[keep], w[keep]
    n1 = genome.coords_to_nodes(ci1, s1) - 1        # ref offsets ids by -1
    n2 = genome.coords_to_nodes(ci2, s2) - 1
    same = ci1 == ci2
    for adj, m in ((intra, same), (inter, ~same)):
        np.add.at(adj, (n1[m], n2[m]), w[m])
        np.add.at(adj, (n2[m], n1[m]), w[m])
    return intra, inter


def remap_node_dicts(result: NodeFilterResult, node2bin: dict,
                     node2chrom: dict) -> tuple[dict, dict, dict]:
    """Rebuild the bin/chrom dict artifacts for the surviving nodes
    (ref process_SPRITE.py:121-132): returns (bin2node, node2bin, node2chrom)
    keyed by the new ids."""
    new_node2bin, new_bin2node, new_node2chrom = {}, {}, {}
    for old, new in enumerate(result.node2newnode):
        if new == 0 or old not in node2bin:
            continue
        new_node2bin[int(new)] = node2bin[old]
        new_bin2node[node2bin[old]] = int(new)
        new_node2chrom[int(new)] = node2chrom[old]
    return new_bin2node, new_node2bin, new_node2chrom
