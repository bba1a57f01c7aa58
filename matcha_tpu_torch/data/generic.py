"""Generic (non-genomic) hypergraph datasets.

Capability parity with the legacy dataset-generic driver
(ref History_version/Code/main_drop.py:543-620): hypergraphs over typed node
spaces (``nums_type``), initial node features from the row-normalized
clique-expansion adjacency, per-type negative-sampling ranges
(``start_end_dict``), optional attribute matrices.

The genomic pipeline is the special case "node type == chromosome", so the
same model/sampler/trainer stack is reused: a typed node space is expressed
as a GenomeBins-shaped object (one "chromosome" per node type), and the
frozen tables are built from the hyperedge clique expansion instead of an
mcool contact matrix.

Port of ``matcha_tpu/data/generic.py``: the numpy parts are copies, and
``build_generic_problem`` builds the port's model params (from a seeded
``torch.Generator``), frozen tables and chromosome table on ``device``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

import torch

from matcha_tpu_torch.device import resolve_device
from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.utils import edgelist_to_adjacency


def node_space_from_type_counts(type_names: Sequence[str],
                                counts: Sequence[int]) -> GenomeBins:
    """A typed node space as a GenomeBins: type t holds ``counts[t]`` nodes,
    ids contiguous, 1-based with 0 = padding — the ``nums_type`` /
    ``num_list`` structure of the legacy driver (ref main_drop.py:579-599)."""
    counts = [int(c) for c in counts]
    if any(c <= 0 for c in counts):
        # GenomeBins cannot express a 0-node chromosome (every chrom gets
        # >= 1 bin), which would add a phantom node the sampler could draw
        raise ValueError(f"every node type needs >= 1 node, got {counts}")
    # bins_per_chrom = ceil(size/res)+1; with res=1 and size=n-1 -> n bins
    sizes = [c - 1 for c in counts]
    return GenomeBins(list(type_names), sizes, resolution=1)


def adjacency_features(space: GenomeBins, flat: np.ndarray,
                       offsets: np.ndarray,
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Initial features from the hyperedge clique expansion
    (ref get_adjacency, main_drop.py:543-563): co-occurrence adjacency split
    into intra-type (feature blocks) and inter-type (recon targets)."""
    n = space.num_nodes
    adj = edgelist_to_adjacency(flat, offsets, n)
    t = space.node2chrom[1:]
    same = t[:, None] == t[None, :]
    intra = np.where(same, adj, 0.0).astype(np.float32)
    inter = np.where(same, 0.0, adj).astype(np.float32)
    return intra, inter


def packed_coord_attributes(attribute_dict: np.ndarray,
                            n_first_type: int) -> np.ndarray:
    """Decode the legacy ``attribute_dict`` layout into a per-node attribute
    column (ref History_version/Code/main_drop.py:607-631): the stored
    (M, 1) values pack two genomic coordinates as ``start*1e7 + end``; the
    reference splits them into end (``% 1e7``) then start (``// 1e7``)
    stacked along the NODE axis (one half per node type), scales by the
    global max, and prepends zero rows for the first (attribute-less) node
    type plus the padding id.  Returns (1 + n_first_type + 2M, 1) float32,
    indexable by 1-based node id like ``FrozenTables.attr_table``."""
    a = np.asarray(attribute_dict, dtype=np.float64).reshape(-1, 1)
    a = np.concatenate([a % 1e7, np.floor(a / 1e7)])
    if a.size == 0 or np.max(a) <= 0:
        # max-normalization needs a positive max; 0/0 would silently fill
        # the attribute table (and then the losses) with NaN
        raise ValueError("attribute_dict must contain a positive value")
    a = a / np.max(a)
    return np.concatenate(
        [np.zeros((int(n_first_type) + 1, 1)), a]).astype(np.float32)


def load_npz_dataset(path: str) -> Dict:
    """Load the legacy ``train_data.npz``/``test_data.npz`` layout
    (ref main_drop.py:579-620): arrays ``train_data``/``test_data`` (ragged
    hyperedges, 0-based per-type... stored as tuples) and ``nums_type``."""
    data = np.load(path, allow_pickle=True)
    out = {k: data[k] for k in data.files}
    return out


def build_generic_problem(type_counts: Sequence[int], hyperedges,
                          dim: int = 64, n_head: int = 8,
                          type_names: Optional[Sequence[str]] = None,
                          seed: int = 0,
                          attributes: Optional[np.ndarray] = None,
                          device="cuda"):
    """One-call setup for an arbitrary hypergraph: node space, frozen tables
    (clique-expansion features), model params, chromosome/type table.

    hyperedges: iterable of 1-based node-id lists (sorted, distinct).
    attributes: optional (N, A) or (N+1, A) per-node attribute matrix fed
    through ``attr_nn`` in place of the built-in one-hot-type + coord table
    — the legacy ``attribute_dict`` surface (ref main_drop.py:607-631; use
    ``packed_coord_attributes`` to decode that file layout).  Row 0 is the
    padding id; an (N, A) input gets a zero row prepended.
    The params, frozen tables and chromosome table are on ``device``; the
    params are drawn from ``torch.Generator().manual_seed(seed)``.
    Returns (space, dims, params, frozen, chrom_table)."""
    from matcha_tpu_torch.models.hypersagnn import (ModelDims,
                                                    build_frozen_tables,
                                                    init_model)
    from matcha_tpu_torch.sampler.negative import ChromTable
    dev = resolve_device(device)

    if type_names is None:
        type_names = [f"type{i}" for i in range(len(type_counts))]
    space = node_space_from_type_counts(type_names, type_counts)

    hyperedges = [list(e) for e in hyperedges]   # tolerate generators
    sizes = [len(e) for e in hyperedges]
    flat = (np.concatenate([np.asarray(e) for e in hyperedges])
            .astype(np.int32) if sizes else np.zeros(0, np.int32))
    offsets = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])

    intra, inter = adjacency_features(space, flat, offsets)
    attr_dim = 0
    if attributes is not None:
        attributes = np.asarray(attributes, dtype=np.float32)
        if attributes.ndim != 2:
            raise ValueError(f"attributes must be 2-D, got {attributes.shape}")
        if attributes.shape[0] == space.num_nodes:      # prepend pad row 0
            attributes = np.concatenate(
                [np.zeros((1, attributes.shape[1]), np.float32), attributes])
        if attributes.shape[0] != space.num_nodes + 1:
            raise ValueError(
                f"attributes rows must be N={space.num_nodes} or N+1, "
                f"got {attributes.shape[0]}")
        attr_dim = attributes.shape[1]
    dims = ModelDims(dim=dim, n_head=n_head, num_chroms=space.num_chroms,
                     num_nodes=space.num_nodes, attr_dim=attr_dim)
    chrom_sizes = [int(e - s) for s, e in space.chrom_range]
    params = init_model(torch.Generator().manual_seed(int(seed)), dims,
                        chrom_sizes, device=dev)
    frozen = build_frozen_tables(space, intra, inter, device=dev)
    if attributes is not None:
        frozen = frozen._replace(
            attr_table=torch.from_numpy(attributes).to(dev))
    return (space, dims, params, frozen,
            ChromTable.from_genome(space, device=dev))
