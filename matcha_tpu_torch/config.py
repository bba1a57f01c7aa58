"""Config system.

A copy of ``matcha_tpu/config.py`` (the port imports nothing of the JAX
package): the same keys, names and defaults, and unknown keys are refused,
so every ``config.JSON`` the JAX package reads loads here unchanged.
API-parity with the reference's ``config.JSON`` + ``get_config()``
(ref: Code/utils.py:157-158, keys documented in Readme.md:28-43), with extra
framework knobs that default to reference behaviour.  The "auto" perf knobs
resolve per device in ``pipeline.resolve_perf``; ``use_pallas_attention``,
``prng_impl`` and ``compile_cache_dir`` are JAX settings, read and without
effect here.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence


@dataclasses.dataclass
class Config:
    # --- reference keys (Code/config.JSON:1-19) ---
    cluster_path: str = ""
    mcool_path: str = ""
    resolution: int = 1_000_000
    chrom_list: Sequence[str] = dataclasses.field(default_factory=list)
    chrom_size: str = ""               # chrom-sizes TSV path
    temp_dir: str = "./Temp"
    max_cluster_size: int = 25
    min_distance: int = 0
    kmer_size: Sequence[int] = (2, 3, 4, 5)   # JSON key "k-mer_size"
    min_freq_cutoff: int = 2
    quantile_cutoff_for_positive: float = 0.6
    quantile_cutoff_for_unlabel: float = 0.4
    embed_dim: int = 64

    # --- training defaults (hardcoded in ref Code/main.py:527-533,630,643,679) ---
    neg_num: int = 3
    batch_size: int = 96
    num_batch_per_iter: int = 1000
    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    n_head: int = 8
    stage1_epochs: int = 3
    stage2_epochs: int = 30
    stage1_alpha: float = 0.0
    stage1_beta: float = 1.0
    stage2_alpha: float = 1.0
    stage2_beta: float = 0.001
    seed: int = 0

    # --- framework knobs (no reference equivalent) ---
    # "auto" knobs resolve to the main path on an accelerator (bf16 compute
    # with f32 master params, merged token stream) and to the conservative
    # CPU defaults elsewhere (see pipeline.resolve_perf).
    table_dtype: str = "float32"       # frozen feature/target table dtype ("bfloat16" to halve HBM)
    compute_dtype: str = "auto"        # "auto" (bf16 on the card) | "float32" | "bfloat16"
    use_pallas_attention: str = "auto" # JAX only: "auto" | "on" | "off"
    token_stream: str = "auto"         # "auto" (merged on the card, hybrid on CPU) | "padded" | "merged" | "hybrid"
    propose_impl: str = "auto"         # sampler phase-1 proposal: "auto" | "xla" | "pallas"
    fuse_tail: str = "auto"            # fused per-token tail kernel: "auto" | "on" | "off"
    prng_impl: str = "auto"            # JAX only: "auto" | "rbg" | "threefry2x32"
    compile_cache_dir: str = "/tmp/matcha_jax_cache"  # JAX only
    max_neg_trials: int = 8            # parallel trial rounds (ref loop is unbounded; 8 = benched value)
    bloom_error_rate: float = 1e-3     # matches pybloom_live err in ref Code/utils.py:83-85
    mesh_data: int = 1                 # data-parallel axis size
    mesh_model: int = 1                # model-parallel (node-shard) axis size
    # reference-interop ragged edge_list.npy (a pickled object array; the
    # canonical artifact is the CSR pair edge_members/edge_offsets.npy).
    # "auto" skips the pickle above 2M clusters, where writing 10M+ Python
    # lists costs minutes and GBs for an artifact nothing downstream reads.
    ragged_edge_list: str = "auto"     # "auto" | "on" | "off"

    def __post_init__(self):
        self.chrom_list = list(self.chrom_list)
        self.kmer_size = [int(k) for k in self.kmer_size]

    @property
    def min_size(self) -> int:
        return int(min(self.kmer_size))

    @property
    def max_size(self) -> int:
        return int(max(self.kmer_size))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["k-mer_size"] = d.pop("kmer_size")
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        d = dict(d)
        if "k-mer_size" in d:
            d["kmer_size"] = d.pop("k-mer_size")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = {k: v for k, v in d.items() if k not in known}
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**d)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


def load_config(path: str | None = None) -> Config:
    """Load a config JSON.  Mirrors ``get_config()`` (ref Code/utils.py:157-158)
    which reads ``./config.JSON`` from the CWD when no path is given."""
    if path is None:
        path = os.path.join(os.getcwd(), "config.JSON")
    with open(path) as f:
        return Config.from_dict(json.load(f))
