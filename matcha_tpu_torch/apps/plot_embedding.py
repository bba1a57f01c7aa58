"""Embedding visualization app.

Port of ``matcha_tpu/apps/plot_embedding.py``: PCA(2) of the exported
embeddings coloured by subcompartment label, and the subcompartment-label
construction (ref: Code/process.py:178-226).  scikit-learn's PCA becomes
``pca_2d``: centring, then ``torch.linalg.svd`` and the first two
components.  matplotlib is imported only by the function that plots.

    python -m matcha_tpu_torch.apps.plot_embedding -e embeddings.npy -l labels.npy -o scatter.png [--device cpu]
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from matcha_tpu_torch.device import resolve_device
from matcha_tpu_torch.genome import GenomeBins

STATE_DICT = {"A1": 0, "A2": 1, "B1": 2, "B2": 3, "B3": 4}


def build_subcompartment_labels(bed_path: str, genome: GenomeBins,
                                fine_res: int = 100_000) -> np.ndarray:
    """Majority-vote per-bin subcompartment labels from a bed file
    (ref build_subcompartment_label :178-226): bed intervals at fine_res are
    binned into the coarse grid; a coarse bin takes the majority fine label
    when >= 60% of its fine bins agree (the reference's hard-coded ">= 6 of
    10" is 1 Mb-specific; this scales to any resolution), else -1.
    Returns (N,) labels for nodes 1..N."""
    import pandas as pd
    tab = pd.read_table(bed_path, sep="\t", header=None).iloc[:, :4]
    tab.columns = ["chrom", "start", "end", "label"]
    per_fine = max(genome.resolution // fine_res, 1)
    label_list = -np.ones((genome.node_num, per_fine))
    for row in tab.itertuples(index=False):
        label = STATE_DICT.get(row.label, -1)
        start = int(math.floor(row.start / fine_res))
        end = int(math.floor(row.end / fine_res))
        for j in range(start, end + 1):
            coarse = j // per_fine
            coord = coarse * genome.resolution
            if genome.has_chrom(row.chrom):
                c = genome.chrom_index(row.chrom)
                s, e = genome.chrom_range[c]
                node = s + coord // genome.resolution
                if node < e:
                    label_list[node, j % per_fine] = label
    majority = max(int(math.ceil(0.6 * per_fine)), 1)   # ref: 6 of 10
    final = np.full(genome.node_num, -1.0)
    for i, vec in enumerate(label_list):
        unique, count = np.unique(vec, return_counts=True)
        if count.max() >= majority:
            final[i] = unique[count.argmax()]
    return final[1:]


def pca_2d(vec: np.ndarray, device="cuda") -> np.ndarray:
    """(N, 2) float64 coordinates of the rows of ``vec`` on their first two
    principal components, computed in float64 on ``device``.

    Sign rule: each component is flipped so that its loading of largest
    magnitude is positive, the rule of scikit-learn's ``svd_flip`` on the
    components (1.5 and later); components are otherwise defined only up
    to sign."""
    x = torch.as_tensor(np.asarray(vec, np.float64)).to(resolve_device(device))
    xc = x - x.mean(dim=0, keepdim=True)
    _, _, vh = torch.linalg.svd(xc, full_matrices=False)
    comps = vh[:2]                                           # (2, d)
    lead = comps.abs().argmax(dim=1)
    comps = comps * torch.sign(comps[torch.arange(comps.shape[0]), lead]
                               )[:, None]
    return (xc @ comps.T).cpu().numpy()


def plot_embeddings(embeddings_path: str, labels_path: Optional[str] = None,
                    output_path: str = "scatter.png", device="cuda") -> str:
    """PCA scatter (ref plot_embedding.py:8-18); the PCA on ``device``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    vec = np.load(embeddings_path)
    if labels_path is not None:
        label = np.load(labels_path)
        vec = vec[label != -1]
        label = label[label != -1]
    else:
        label = np.zeros(len(vec))
    vec = pca_2d(vec, device)
    fig, ax = plt.subplots()
    for state in np.unique(label):
        m = label == state
        ax.scatter(vec[m, 0], vec[m, 1], s=30, alpha=1.0, linewidth=0,
                   label=f"State{int(state)}")
    ax.legend()
    fig.savefig(output_path)
    plt.close(fig)
    return output_path


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="plot embeddings")
    p.add_argument("-e", "--embeddings", default="embeddings.npy")
    p.add_argument("-l", "--labels", default=None)
    p.add_argument("-o", "--output", default="scatter.png")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu, where the PCA runs")
    a = p.parse_args(argv)
    plot_embeddings(a.embeddings, a.labels, a.output, device=a.device)


if __name__ == "__main__":
    main()
