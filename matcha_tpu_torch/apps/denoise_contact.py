"""Contact-map denoising app.

Port of ``matcha_tpu/apps/denoise_contact.py``, the same output: per
chromosome, score every intra-chromosomal bin pair with gap >=
min_distance, sqrt-coverage-normalise the probability and raw matrices,
combine them as max(proba * origin, proba), renormalise, zero the gap rows
and columns, quantile-transform, and write the pixels into a cooler-layout
``denoised.mcool`` (and origin / denoise heatmaps on request).

Scoring runs on the device of the bundle's tables: the closed-form pair
scorer (``apps/pairwise_fast.py``) or the model's forward over the explicit
pairs (``apps/predict.py``).  The quantile transform is the port's numpy
copy of scikit-learn's (``data/store.quantile_transform``), unseeded as the
JAX package's is: above 10,000 values it fits on a subsample drawn from
numpy's global RandomState.  Every chromosome is computed before anything
is written (``denoise_pixels``); h5py and matplotlib are imported only by
the functions that write, so the computation runs where they are missing.

    python -m matcha_tpu_torch.apps.denoise_contact -m <bundle> -o denoised.mcool [--device cpu]
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from matcha_tpu_torch.apps.pairwise_fast import pairwise_proba_matrix
from matcha_tpu_torch.apps.predict import predict_proba
from matcha_tpu_torch.data.store import quantile_transform
from matcha_tpu_torch.genome import GenomeBins


def generate_pair_wise(genome: GenomeBins, chrom_id: int,
                       min_distance: int) -> np.ndarray:
    """All intra-chrom node pairs (i, j) with j >= i + min_distance
    (ref :67-74; note j starts AT i+min_distance, so min_distance=0 includes
    the diagonal, as in the reference)."""
    s, e = genome.chrom_range[chrom_id]
    i, j = np.meshgrid(np.arange(s, e), np.arange(s, e), indexing="ij")
    keep = j >= i + min_distance
    return np.stack([i[keep], j[keep]], axis=1).astype(np.int64)


def proba2matrix(pairs: np.ndarray, proba: np.ndarray) -> np.ndarray:
    """Symmetric dense accumulation (ref proba2matrix :31-61, intra branch)."""
    lo = pairs.min()
    size = int(pairs.max() - lo + 1)
    m = np.zeros((size, size), dtype="float32")
    np.add.at(m, (pairs[:, 0] - lo, pairs[:, 1] - lo), proba)
    return m + m.T


def _sqrt_coverage_normalize(m: np.ndarray) -> np.ndarray:
    c1 = np.sqrt(m.mean(axis=-1, keepdims=True))
    c2 = np.sqrt(m.mean(axis=0, keepdims=True))
    return m / (c1 + 1e-15) / (c2 + 1e-15)


def _quantile(m: np.ndarray) -> np.ndarray:
    """scikit-learn's ``QuantileTransformer(n_quantiles=1000,
    output_distribution="uniform").fit_transform`` of the flattened matrix,
    its subsample drawn from numpy's global RandomState."""
    return quantile_transform(m.reshape(-1)).reshape(m.shape)


def chromosome_proba(params, frozen, dims, genome: GenomeBins, chrom_id: int,
                     pairs: np.ndarray, *, use_fast: bool = True,
                     batch_size: int = 10_000) -> np.ndarray:
    """(P,) f32 probabilities of one chromosome's pairs: the closed form
    over all the chromosome's pairs, or the forward over the explicit
    pairs in chunks of ``batch_size``."""
    if not use_fast:
        return predict_proba(params, frozen, dims, pairs,
                             batch_size=batch_size)
    full = pairwise_proba_matrix(params, frozen, dims, genome, chrom_id)
    s = genome.chrom_range[chrom_id, 0]
    return full[pairs[:, 0] - s, pairs[:, 1] - s].astype(np.float32)


def normalise(pairs: np.ndarray, proba: np.ndarray,
              origin_vals: np.ndarray) -> Tuple[np.ndarray, ...]:
    """The chain before the quantile transform (ref :160-185) -> (denoised,
    origin, proba) matrices."""
    my_proba = _sqrt_coverage_normalize(proba2matrix(pairs, proba))
    origin_part = proba2matrix(pairs, origin_vals)
    gap1 = origin_part.sum(axis=-1) == 0
    gap2 = origin_part.sum(axis=0) == 0
    origin_part = _sqrt_coverage_normalize(origin_part)

    my = np.maximum(my_proba * origin_part, my_proba)
    my = _sqrt_coverage_normalize(my)
    my[gap1, :] = 0.0
    my[:, gap2] = 0.0
    my_proba[gap1, :] = 0.0
    my_proba[:, gap2] = 0.0
    return my, origin_part, my_proba


def denoise_chromosome(params, frozen, dims, genome: GenomeBins,
                       intra_adj: np.ndarray, chrom_id: int,
                       min_distance: int, batch_size: int = 10_000,
                       use_fast: bool = True):
    """-> (pairs, denoised matrix, origin matrix, proba matrix, pixel values)

    use_fast: score all pairs with the closed-form factorization
    (apps/pairwise_fast.py; exact for k=2), else with the forward over the
    explicit pairs."""
    pairs = generate_pair_wise(genome, chrom_id, min_distance)
    proba = chromosome_proba(params, frozen, dims, genome, chrom_id, pairs,
                             use_fast=use_fast, batch_size=batch_size)
    origin_vals = intra_adj[pairs[:, 0] - 1, pairs[:, 1] - 1]
    my, origin_part, my_proba = normalise(pairs, proba, origin_vals)
    # the JAX package's order of the three transforms: each draws its
    # subsample from the global RandomState in turn
    my = _quantile(my)
    origin_part = _quantile(origin_part)
    my_proba = _quantile(my_proba)

    lo = pairs.min()
    values = my[pairs[:, 0] - lo, pairs[:, 1] - lo]
    return pairs, my, origin_part, my_proba, values


def denoise_pixels(params, frozen, dims, genome: GenomeBins,
                   intra_adj: np.ndarray, *, min_distance: int = 0,
                   batch_size: int = 10_000, use_fast: bool = True,
                   keep_matrices: bool = False, log=print):
    """Every chromosome's pixels -> (bin1 ids, bin2 ids, balanced values,
    {chromosome name: (denoised, origin) matrices}); the matrices only with
    ``keep_matrices`` (each is dense, bins x bins).  A chromosome with no
    more bins than ``min_distance`` has no pairs and is skipped."""
    bin1, bin2, balanced = [], [], []
    matrices: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for c in range(genome.num_chroms):
        s_, e_ = genome.chrom_range[c]
        name = genome.chrom_names[c]
        if int(e_ - s_) <= min_distance:
            log(f"skipping {name}: fewer bins than "
                f"min_distance={min_distance}")
            continue
        pairs, my, origin, _, values = denoise_chromosome(
            params, frozen, dims, genome, intra_adj, c, min_distance,
            batch_size, use_fast)
        bin1.append(pairs[:, 0] - 1)
        bin2.append(pairs[:, 1] - 1)
        balanced.append(values)
        if keep_matrices:
            matrices[name] = (my, origin)
        log(f"denoised {name}: {len(pairs)} pairs")
    return (np.concatenate(bin1), np.concatenate(bin2),
            np.concatenate(balanced), matrices)


def _write_mcool_skeleton(f, genome: GenomeBins):
    """cooler layout resolutions/<res>/{bins,chroms} (ref :113-138) in an
    open ``h5py.File``."""
    import h5py
    grp = f.create_group("resolutions").create_group(str(genome.resolution))
    bins = grp.create_group("bins")
    chrom_idx, starts = [], []
    for c in range(genome.num_chroms):
        s, e = genome.chrom_range[c]
        chrom_idx += [c] * (e - s)
        starts += (np.arange(e - s, dtype=np.int64)
                   * genome.resolution).tolist()
    bins.create_dataset("chrom", data=np.asarray(chrom_idx))
    bins.create_dataset("start", data=np.asarray(starts))
    bins.create_dataset("end",
                        data=np.asarray(starts) + genome.resolution)
    chroms = grp.create_group("chroms")
    chroms.create_dataset(
        "name", data=[c.encode("utf8") for c in genome.chrom_names],
        dtype=h5py.special_dtype(vlen=str))
    return grp


def write_denoised_mcool(path: str, genome: GenomeBins, bin1: np.ndarray,
                         bin2: np.ndarray, balanced: np.ndarray) -> str:
    """The cooler-layout file the JAX package writes: bins, chroms, and the
    pixels (bin1_id, bin2_id, balanced)."""
    import h5py
    with h5py.File(path, "w") as f:
        grp = _write_mcool_skeleton(f, genome)
        pix = grp.create_group("pixels")
        pix.create_dataset("bin1_id", data=bin1)
        pix.create_dataset("bin2_id", data=bin2)
        pix.create_dataset("balanced", data=balanced)
    return path


def _heatmap(matrix: np.ndarray, path: str) -> None:
    """origin/denoise heatmap pngs (ref :194-228)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(5, 5))
    plt.subplots_adjust(left=0.0, right=1.0, top=1.0, bottom=0.0)
    ax = plt.gca()
    ax.imshow(matrix, cmap="Reds", vmin=0.0, vmax=1.0)
    ax.set_axis_off()
    plt.savefig(path, dpi=300)
    plt.close(fig)


def run_denoise(bundle_path: str, *, min_distance: int = 0,
                output_mcool: str = "denoised.mcool",
                plot_dir: Optional[str] = None,
                batch_size: int = 10_000, log=print, device="cuda") -> str:
    """Full denoise pass over every chromosome -> denoised.mcool
    (ref module body :90-236), scored on ``device``."""
    from matcha_tpu_torch.train.runtime import load_model_bundle
    params, dims, genome, frozen = load_model_bundle(bundle_path, device)
    intra_adj = np.load(os.path.join(bundle_path, "intra_adj.npy"))
    bin1, bin2, balanced, matrices = denoise_pixels(
        params, frozen, dims, genome, intra_adj, min_distance=min_distance,
        batch_size=batch_size, keep_matrices=bool(plot_dir), log=log)
    write_denoised_mcool(output_mcool, genome, bin1, bin2, balanced)
    if plot_dir:
        os.makedirs(plot_dir, exist_ok=True)
        for name, (my, origin) in matrices.items():
            _heatmap(my, os.path.join(plot_dir, f"{name}_denoise.png"))
            _heatmap(origin, os.path.join(plot_dir, f"{name}_origin.png"))
    return output_mcool


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="denoise contact maps")
    p.add_argument("-m", "--model", required=True,
                   help="model bundle dir (temp_dir/model2load)")
    p.add_argument("-o", "--output", default="denoised.mcool")
    p.add_argument("-d", "--min-distance", type=int, default=0)
    p.add_argument("-p", "--plot-dir", default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    a = p.parse_args(argv)
    run_denoise(a.model, min_distance=a.min_distance, output_mcool=a.output,
                plot_dir=a.plot_dir, device=a.device)


if __name__ == "__main__":
    main()
