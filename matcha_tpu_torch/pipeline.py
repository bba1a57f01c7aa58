"""End-to-end pipeline entry points and the CLI.

Port of ``matcha_tpu/pipeline.py``: library equivalents of the reference's
CLI scripts (ref Readme.md:45-64), each stage reading and writing the same
``temp_dir`` artifacts as the JAX package and the reference, so the stages
interoperate with theirs:

  run_process         <- python process.py        (ingest)
  run_generate_kmers  <- python generate_kmers.py (hyperedge generation)
  run_merge_kmers        (merge per-shard k-mer counts)
  run_train           <- python main.py           (two-stage training)
  run_pretrain           (walk + skip-gram node-embedding pretraining)

``python -m matcha_tpu_torch {process,kmers,kmers-merge,train,pretrain,all}
-c config.JSON [--walk-mode hyper|clique] [--device cuda|cpu]`` runs them
(``main``).  Training and pretraining run on the card unless ``--device
cpu`` is given; without a card ``cuda`` raises.  A config with
``mesh_data * mesh_model > 1`` trains on that mesh of ranks, one process
each: ``torchrun --nproc-per-node N -m matcha_tpu_torch train -c
config.JSON`` (NCCL on the cards, gloo with ``--device cpu``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from matcha_tpu_torch.config import Config, load_config
from matcha_tpu_torch.data.clusters import (clusters_to_list, load_edge_list,
                                            parse_clusters, save_edge_list)
from matcha_tpu_torch.data.kmers import (generate_kmers,
                                         generate_kmers_shard,
                                         merge_kmer_shards)
from matcha_tpu_torch.data.mcool import (load_contacts, parse_mcool_contacts,
                                         save_contacts)
from matcha_tpu_torch.data.store import HyperedgeStore
from matcha_tpu_torch.device import resolve_device
from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.models.hypersagnn import (ModelDims,
                                                build_frozen_tables,
                                                configure_fuse_tail,
                                                init_model)
from matcha_tpu_torch.sampler.bloom import build_bloom_dict
from matcha_tpu_torch.sampler.negative import ChromTable
from matcha_tpu_torch.train.logging import MetricsLogger
from matcha_tpu_torch.train.runtime import (Trainer, TrainSettings,
                                            save_model_bundle)
from matcha_tpu_torch.walks.pretrain import pretrain_node_embeddings

# "auto" resolutions of the perf knobs, the JAX package's values: on the card
# its accelerator default (the main path: bf16 compute with f32 master
# params, the merged token stream, the "xla" proposals, the unfused tail),
# on the CPU its conservative default
_AUTO_CUDA = {"compute_dtype": "bfloat16", "token_stream": "merged",
              "propose_impl": "xla", "fuse_tail": "off", "prng_impl": "rbg"}
_AUTO_CPU = {"compute_dtype": "float32", "token_stream": "hybrid",
             "propose_impl": "xla", "fuse_tail": "off",
             "prng_impl": "threefry2x32"}


def resolve_perf(config: Config, device="cuda", *, apply: bool = True
                 ) -> dict:
    """Resolve the config's "auto" perf knobs for ``device`` (the device the
    caller named: nothing probes for a card) and, with ``apply``, set the
    process-global fused-tail gate (``configure_fuse_tail``; under "auto" a
    MATCHA_FUSE_TAIL in the environment wins, as in the JAX package).

    ``use_pallas_attention`` is accepted and has no effect: on the card the
    model takes its attention kernel wherever the shape fits.  ``prng_impl``
    is resolved and ``compile_cache_dir`` read for parity; both set JAX's
    random generator and compile cache and have no effect here."""
    on_card = torch.device(device).type == "cuda"
    auto = _AUTO_CUDA if on_card else _AUTO_CPU
    r = {k: (auto[k] if getattr(config, k) == "auto" else getattr(config, k))
         for k in auto}
    if apply and (config.fuse_tail != "auto"
                  or "MATCHA_FUSE_TAIL" not in os.environ):
        configure_fuse_tail(r["fuse_tail"] == "on")
    return r


def run_process(config: Config) -> GenomeBins:
    """Ingest: genome binning + cluster parse + mcool contacts -> temp_dir."""
    genome = GenomeBins.from_chrom_sizes_file(
        config.chrom_size, config.chrom_list, config.resolution)
    genome.save(config.temp_dir)
    flat, offsets = parse_clusters(config.cluster_path, genome,
                                   config.max_cluster_size)
    save_edge_list(config.temp_dir, flat, offsets,
                   ragged=config.ragged_edge_list)
    intra, inter = parse_mcool_contacts(config.mcool_path, genome)
    save_contacts(config.temp_dir, intra, inter)
    return genome


def run_generate_kmers(config: Config, *, shard_index: Optional[int] = None,
                       shard_count: Optional[int] = None) -> Dict:
    """k-mer generation.  With ``shard_index``/``shard_count`` set, counts
    only that shard's clusters and writes partial counters — run one shard
    per host, then ``run_merge_kmers``."""
    flat, offsets = load_edge_list(config.temp_dir)
    if shard_index is not None and shard_count is None:
        raise ValueError("--shard-index requires --shard-count (otherwise "
                         "every host would run the FULL unsharded pass and "
                         "race on the final artifacts)")
    if shard_count is not None:
        return generate_kmers_shard(
            flat, offsets, config.kmer_size,
            max_cluster_size=config.max_cluster_size,
            min_distance=config.min_distance,
            shard_index=int(shard_index or 0), shard_count=int(shard_count),
            temp_dir=config.temp_dir)
    return generate_kmers(
        flat, offsets, config.kmer_size,
        max_cluster_size=config.max_cluster_size,
        min_distance=config.min_distance,
        min_freq_cutoff=config.min_freq_cutoff, temp_dir=config.temp_dir)


def run_merge_kmers(config: Config, *, shard_count: int) -> Dict:
    """Merge per-shard partial counters into the final artifacts."""
    return merge_kmer_shards(
        config.kmer_size, shard_count=int(shard_count),
        temp_dir=config.temp_dir, min_freq_cutoff=config.min_freq_cutoff)


def run_train(config: Config, device="cuda", *, log=print,
              stage1_epochs: Optional[int] = None,
              stage2_epochs: Optional[int] = None,
              embeddings_path: Optional[str] = None,
              resume: bool = False):
    """Two-stage training (ref Code/main.py module body :516-685) on
    ``device`` -> (the stage-2 Trainer, its history, the store).

    Writes ``temp_dir/model.chkpt`` (best-AUPRC checkpoint),
    ``resume_stage{1,2}`` (per-epoch resume snapshots),
    ``logs/metrics.jsonl``, the bundle ``model2load/`` and, one level above
    temp_dir, ``embeddings.npy``.  resume: continue from the resume
    snapshots (exact trajectory; a completed stage is skipped because its
    snapshot is at its last epoch).

    With ``mesh_data * mesh_model = W > 1`` the run must be one of W
    processes (``torchrun --nproc-per-node W``; WORLD_SIZE = W): each joins
    the run (``init_distributed``: NCCL on ``cuda:LOCAL_RANK``, gloo on the
    CPU), trains on the mesh, and only rank 0 logs and writes the files.
    Otherwise it raises: a mesh config never trains on one device in
    silence."""
    mesh = None
    n_mesh = int(config.mesh_data) * int(config.mesh_model)
    if n_mesh > 1:
        from matcha_tpu_torch.parallel.distributed import init_distributed
        from matcha_tpu_torch.parallel.mesh import make_mesh
        world = int(os.environ.get("WORLD_SIZE", "1") or 1)
        if world != n_mesh:
            raise RuntimeError(
                f"mesh_data * mesh_model = {n_mesh} needs a run of "
                f"{n_mesh} processes (WORLD_SIZE = {world}): start it with "
                f"torchrun --nproc-per-node {n_mesh} -m matcha_tpu_torch "
                "train -c config.JSON")
        local = init_distributed(device=torch.device(device).type)
        device = local if local is not None else device
        mesh = make_mesh(int(config.mesh_data), int(config.mesh_model))
        if mesh.rank != 0:
            log = _silent
    dev = resolve_device(device)
    temp_dir = config.temp_dir
    genome = GenomeBins.load(temp_dir)
    intra, inter = load_contacts(temp_dir)

    store = HyperedgeStore.from_temp_dir(
        temp_dir, config.kmer_size,
        quantile_cutoff_for_positive=config.quantile_cutoff_for_positive,
        quantile_cutoff_for_unlabel=config.quantile_cutoff_for_unlabel,
        neg_num=config.neg_num, seed=config.seed)
    log(f"train sizes: {store.train_sizes()}")

    perf = resolve_perf(config, dev)
    log(f"resolved perf: {perf}")
    dims = ModelDims(dim=config.embed_dim, n_head=config.n_head,
                     num_chroms=genome.num_chroms,
                     num_nodes=genome.num_nodes,
                     compute_dtype=perf["compute_dtype"])
    chrom_sizes = [int(e - s) for s, e in genome.chrom_range]
    params = init_model(torch.Generator().manual_seed(config.seed), dims,
                        chrom_sizes, device=dev)
    table_dt = (torch.bfloat16 if config.table_dtype == "bfloat16"
                else torch.float32)
    frozen = build_frozen_tables(genome, intra, inter, table_dtype=table_dt,
                                 device=dev)
    chrom_table = ChromTable.from_genome(genome, device=dev)
    ckpt = os.path.join(temp_dir, "model.chkpt")
    mlog = (MetricsLogger(os.path.join(temp_dir, "logs"), stdout=log)
            if mesh is None or mesh.rank == 0 else None)
    try:
        # ---- stage 1: reconstruction only (ref :637-643)
        s1 = TrainSettings(alpha=config.stage1_alpha,
                           beta=config.stage1_beta, neg_num=config.neg_num,
                           min_distance=config.min_distance,
                           max_trials=config.max_neg_trials,
                           learning_rate=config.learning_rate,
                           weight_decay=config.weight_decay,
                           token_stream=perf["token_stream"],
                           propose_impl=perf["propose_impl"])
        trainer = Trainer(params, frozen, dims, chrom_table, s1, blooms=None,
                          seed=config.seed, mesh=mesh)
        trainer.fit(store.train, store.test,
                    epochs=stage1_epochs if stage1_epochs is not None
                    else config.stage1_epochs,
                    batch_size=config.batch_size,
                    num_batch_per_iter=config.num_batch_per_iter,
                    checkpoint_path=ckpt, log=log, seed=config.seed,
                    metrics_logger=mlog, stage="stage1_recon",
                    resume_path=os.path.join(temp_dir, "resume_stage1"),
                    resume=resume)

        # ---- between stages: Bloom filters from the unlabeled set (ref
        # :646-667)
        blooms = build_bloom_dict(store.unlabeled,
                                  error_rate=config.bloom_error_rate,
                                  device=dev)
        log("built Bloom filters: "
            + str({k: f.m_bits for k, f in blooms.items()}))

        # ---- stage 2: classification (fresh AdamW, ref :671-679)
        s2 = s1._replace(alpha=config.stage2_alpha, beta=config.stage2_beta)
        trainer2 = Trainer(trainer.params, frozen, dims, chrom_table, s2,
                           blooms=blooms, seed=config.seed + 1, mesh=mesh)
        history = trainer2.fit(
            store.train, store.test,
            epochs=stage2_epochs if stage2_epochs is not None
            else config.stage2_epochs,
            batch_size=config.batch_size,
            num_batch_per_iter=config.num_batch_per_iter,
            checkpoint_path=ckpt, log=log, seed=config.seed + 1,
            metrics_logger=mlog, stage="stage2_classify",
            resume_path=os.path.join(temp_dir, "resume_stage2"),
            resume=resume)
    finally:
        if mlog is not None:
            mlog.close()

    # ---- export artifacts (ref :681-685)
    if embeddings_path is None:
        embeddings_path = os.path.join(os.path.dirname(
            os.path.abspath(temp_dir)), "embeddings.npy")
    trainer2.export_embeddings(embeddings_path)
    if mesh is None or mesh.rank == 0:
        save_model_bundle(os.path.join(temp_dir, "model2load"),
                          trainer2.params, dims, genome, intra, inter)
    return trainer2, history, store


def _silent(*args, **kwargs) -> None:
    """The log of a rank other than 0."""


def run_pretrain(config: Config, device="cuda", *, walk_mode: str = "hyper",
                 output: Optional[str] = None, log=print) -> np.ndarray:
    """Walk + skip-gram node-embedding pretraining over the parsed clusters
    (the legacy walk path, ref History_version/Code/main_SPRITE.py:640-765)
    on ``device``, with the JAX package's defaults (10 walks of 80 steps,
    window 10, 5 negatives, batch 4,096, 1 epoch).  Writes
    ``temp_dir/walk_embeddings.npy`` (N, embed_dim) f32; feed it to
    ``init_model(embedding_mode="table", table_init=...)``.  Logs the
    per-epoch losses and the phases' host-clock seconds."""
    dev = resolve_device(device)
    genome = GenomeBins.load(config.temp_dir)
    flat, offsets = load_edge_list(config.temp_dir)
    edges = clusters_to_list(flat, offsets)
    timings: dict = {}
    emb, losses = pretrain_node_embeddings(
        genome.num_nodes, edges, config.embed_dim, walk_mode=walk_mode,
        seed=config.seed, device=dev, timings=timings)
    log(f"skip-gram losses per epoch: {losses}")
    log(f"pretrain timings: {timings}")
    if output is None:
        output = os.path.join(config.temp_dir, "walk_embeddings.npy")
    np.save(output, emb)
    return emb


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(prog="matcha_tpu_torch",
                                description="MATCHA pipeline on PyTorch "
                                            "(NVIDIA GPU)")
    p.add_argument("stage",
                   choices=["process", "kmers", "kmers-merge", "train",
                            "pretrain", "all"])
    p.add_argument("-c", "--config", default=None, help="config.JSON path")
    p.add_argument("--walk-mode", choices=["hyper", "clique"],
                   default="hyper", help="pretrain: the random walks")
    p.add_argument("--device", default="cuda",
                   help="train and pretrain on this device: cuda (the "
                        "default; raises without a GPU) or cpu")
    p.add_argument("--shard-index", type=int, default=None,
                   help="kmers: this host's shard (0-based)")
    p.add_argument("--shard-count", type=int, default=None,
                   help="kmers/kmers-merge: total shards")
    p.add_argument("--resume", action="store_true",
                   help="train: continue from the per-epoch resume "
                        "snapshots in temp_dir (exact trajectory)")
    args = p.parse_args(argv)
    if (args.shard_index is not None or args.shard_count is not None) \
            and args.stage not in ("kmers", "kmers-merge"):
        # 'all' would write only partial counters then train against
        # missing/stale merged artifacts
        p.error("--shard-index/--shard-count apply only to the 'kmers' and "
                "'kmers-merge' stages")
    if args.stage == "kmers-merge" and args.shard_count is None:
        p.error("kmers-merge requires --shard-count")
    config = load_config(args.config)
    if args.stage in ("train", "pretrain", "all"):
        resolve_device(args.device)     # fail before the host stages run
    if args.stage in ("process", "all"):
        run_process(config)
    if args.stage in ("kmers", "all"):
        run_generate_kmers(config, shard_index=args.shard_index,
                           shard_count=args.shard_count)
    if args.stage == "kmers-merge":
        run_merge_kmers(config, shard_count=args.shard_count)
    if args.stage == "pretrain":
        run_pretrain(config, args.device, walk_mode=args.walk_mode)
    if args.stage in ("train", "all"):
        run_train(config, args.device, resume=args.resume)
