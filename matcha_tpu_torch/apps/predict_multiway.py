"""Multi-way interaction predictor app.

Port of ``matcha_tpu/apps/predict_multiway.py``, same I/O: one candidate
interaction per line, tab-separated ``chrom:coord`` members; members on
excluded chromosomes are dropped, coordinates floored to bins, tuples
deduplicated and sorted, singletons skipped; the output is ``np.savetxt`` of
sigmoid probabilities.

    python -m matcha_tpu_torch.apps.predict_multiway -m <bundle> -i <in> -o <out>
"""

from __future__ import annotations

import numpy as np

from matcha_tpu_torch.apps.predict import predict_proba
from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.train.runtime import load_model_bundle


def parse_interaction_file(path: str, genome: GenomeBins) -> list:
    """-> list of sorted node-id lists."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            nodes = set()
            for info in parts:
                if not info:
                    continue
                chrom, _, coord = info.partition(":")
                if not genome.has_chrom(chrom):
                    continue
                nodes.add(genome.node_for(chrom, int(coord)))
            if len(nodes) > 1:
                out.append(sorted(nodes))
    return out


def run_predict_multiway(bundle_path: str, input_path: str,
                         output_path: str = "./output.txt",
                         batch_size: int = 10_000,
                         device="cuda") -> np.ndarray:
    params, dims, genome, frozen = load_model_bundle(bundle_path, device)
    samples = parse_interaction_file(input_path, genome)
    proba = predict_proba(params, frozen, dims, samples, batch_size)
    np.savetxt(output_path, proba)
    return proba


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="predict multi-way interactions")
    p.add_argument("-i", "--file", type=str, required=True)
    p.add_argument("-o", "--output", type=str, default="./output.txt")
    p.add_argument("-m", "--model", type=str, required=True,
                   help="model bundle dir (temp_dir/model2load)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    a = p.parse_args(argv)
    run_predict_multiway(a.model, a.file, a.output, device=a.device)


if __name__ == "__main__":
    main()
