"""Model bundle I/O (the inference-app artifact ``temp_dir/model2load``).

Port of ``save_model_bundle`` / ``load_model_bundle`` of
``matcha_tpu/train/runtime.py``, file for file: ``params.pkl`` (the param
tree as numpy arrays), ``meta.pkl`` (dims as a plain dict + genome
metadata), ``intra_adj.npy`` and ``inter_adj.npy``.  A bundle written by
either package loads in the other.  The trainer comes in a later slice.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.interop import params_from_numpy, params_to_numpy
from matcha_tpu_torch.models.hypersagnn import ModelDims, build_frozen_tables


def save_model_bundle(path: str, params, dims: ModelDims, genome,
                      intra_adj=None, inter_adj=None) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "params.pkl"), "wb") as f:
        pickle.dump(params_to_numpy(params), f)
    with open(os.path.join(path, "meta.pkl"), "wb") as f:
        pickle.dump({"dims": dims._asdict(),
                     "chrom_names": genome.chrom_names,
                     "chrom_sizes": genome.chrom_sizes,
                     "resolution": genome.resolution}, f)
    if intra_adj is not None:
        np.save(os.path.join(path, "intra_adj.npy"), intra_adj)
    if inter_adj is not None:
        np.save(os.path.join(path, "inter_adj.npy"), inter_adj)


def load_model_bundle(path: str, device="cuda"):
    """-> (params, dims, genome, frozen), params and frozen on ``device``.
    Unpickles the bundle: load only bundles this project wrote."""
    with open(os.path.join(path, "params.pkl"), "rb") as f:
        params = params_from_numpy(pickle.load(f), device)
    with open(os.path.join(path, "meta.pkl"), "rb") as f:
        meta = pickle.load(f)
    genome = GenomeBins(meta["chrom_names"], meta["chrom_sizes"],
                        meta["resolution"])
    dims = ModelDims(**meta["dims"])
    # the adjacency matrices are optional ("table" mode needs no features)
    ip = os.path.join(path, "intra_adj.npy")
    jp = os.path.join(path, "inter_adj.npy")
    n = genome.num_nodes
    intra = np.load(ip) if os.path.exists(ip) else np.zeros((n, n),
                                                            np.float32)
    inter = np.load(jp) if os.path.exists(jp) else np.zeros((n, n),
                                                            np.float32)
    frozen = build_frozen_tables(genome, intra, inter, device=device)
    return params, dims, genome, frozen
