#!/usr/bin/env python3
"""Drive the PyTorch port's serving path, training step, Trainer.fit,
run_train (through the CLI), the apps on a bundle, the model's modes, the
walk pretraining and multi-rank training on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root, on a machine with a GPU

Phases, all in this process; any failure exits non-zero before the last line.
Wherever a phase checks the launch counts of a stage-2 step or eval batch
(the sampler against filters, k <= 6, on the card), K7 also launches once
per size and once more per phase-2 round the sampler ran; every training
step launches K8's keep, forward and backward once, and every eval, embeddings
export or scoring call one K8 forward (its encode of the node table):
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile every kernel from csrc/ with nvcc (sm_90a), one nvcc per
     source, all at once: K1 (attention forward), K2 (attention backward),
     K3 (scatter-add) and K4 (bincount), K5 (phase-1 proposals), K6 (the
     fused classifier tail, forward and backward), K7 (the sampler's chain),
     K8 (the node-table encode: keep bits, forward, backward).
  3. kernels vs plain: each kernel's wrapper against its plain PyTorch version
     on the card, over the shapes the main paths give it (f32 with TF32 off,
     and bf16), with the tolerances stated below; the Bloom hashes computed
     on the card against an independent numpy build, bit for bit; K5 bit for
     bit at k = 1..6, n = 6,144 and a ragged 1,001, T = 1, 5, 8, 16 and S =
     1, 2, T, and the sampler's "pallas" phase 1 (K5) against its "xla" one
     for one generator (the same negatives); the sampler on K7 against
     the eager chain at 2,048 and 96 positives per k = 2..5, "xla" and
     "pallas", hard_ratio 1 and 0.5 (negatives and counts bit for bit);
     K6 in eval and train mode (the same mask bits on both
     sides; bf16 takes the backward's tensor-core route), its backward's
     bits across two calls, and its masks' keep shares and seed
     determinism; K6's forward and backward at T = 114,688 / 1,000 / 65 / 3
     and the bf16 (tensor-core) forward's bits across two calls.  K1 and K2
     at every L = 2..8 with E not a multiple of a tile, both diag_mask
     settings, and their bf16 (tensor-core) routes' bits across two calls;
     K3 on skewed ids (Zipf, one row, a hub row holding half of T), ids
     outside [0, n), a 60,000-row table and d = 1, 48 and 1536, against its
     plain version and bit-equal across two calls; K4 on the same ids, and
     against torch.bincount on uniform, Zipf, hub and out-of-range ids at n
     = 3,068, 60,000 and 1,000,000 (both of its routes), its idx starting on
     and off a 16-byte boundary; K3 and K4 at the walk pretraining's SGNS
     shapes (f32, d = 64, n = 3,067 and the 100 kb table's 30,345, T =
     4,096 and 24,576 unigram-skewed ids: K3 1e-5, K4 exactly, each the same
     bits twice); the walks'
     co-occurrence scatter (plain torch) on 8,282 hyperedges of 2-25 nodes
     against scipy's CSR product (rtol 1e-6, atol 1e-7) and the same bits
     twice.
  4. serving end to end at full width: the hg38 1 Mb genome (23 chromosomes,
     3,067 nodes), random weights from a seed at dim 64 / 8 heads in bf16,
     saved as a bundle; run_predict_multiway over 20,000 candidates for each
     of k = 2..5 (batch 10,000).  The launch counts are zeroed just before
     and read just after; the probabilities are checked for range and
     against an f32 copy of the bundle on the CPU (the plain path) and on the
     card.
  5. serving times: run_predict_multiway wall and its stages (host clock,
     median of 3), a torch.profiler summary of the scoring stage, and K1 by
     CUDA events and its device time (profiler) beside its bound and its
     achieved TFLOP/s.
  6. training at full width, the configuration of the JAX package's bench.py
     (dim 64, 8 heads, bf16 compute with f32 master params, k = 2..5, 2,048
     positives per k, neg_num 3, Bloom filters from the buckets, alpha 1,
     beta 0.001, the "merged" token stream, the unfused tail and the "xla"
     proposals): Trainer -> pin_base_buckets -> train_epoch_indexed; one
     stage-1 step, then a warm-up epoch and a timed epoch of 10 stage-2
     steps.  The counts are zeroed just before the timed epoch and read just
     after: each step must launch K1 x3, K2 x3, K3 x1, K4 x1 and K7 x4, and
     K7 once more per phase-2 round the sampler ran (counted by wrapping
     the sampler's round loop, and equal to the step units' own ``rounds``
     and the epoch's ``launches.K7``).  Losses
     finite, params changed; a deterministic step (dropout off, the same
     negatives and recon chromosome) as f32 on the card against f32 on the
     CPU (the plain path), and as bf16 on the card.
  7. training times: the median step, hyperedges scored per second, the
     step's parts (host clock, synchronised after each, median of 5), the
     host synchronisations of one step (PyTorch's sync debug mode), a
     torch.profiler summary of one step (device busy and idle share), and
     K1 and K2 at L = 3, 4, 5, K3 (uniform, Zipf and hub ids) and K4 at
     their main-path shapes: CUDA events around the wrapper and the
     profiler's device time, beside their bounds, their plain versions, K1's
     and K2's achieved TFLOP/s and, for K3 and K4, the one PyTorch call that
     computes the same function (its device time too).
  8. Trainer.fit at full width on the opt-in kernels' path (the JAX
     package ships with both off, so phase 6 is the shipped path): phase
     6's configuration with the fused tail on (configure_fuse_tail) and
     propose_impl="pallas"; stage 1 (1 epoch of 10 steps, no filters), then
     stage 2 (3 epochs of 10 steps against the filters) with the mixed-size
     eval after each epoch (10,000 pooled test rows -> 4 batches of 2,048),
     the best-AUPRC checkpoint, a resume snapshot per epoch, the embedding
     export and a profile of epoch 1 (profile_dir).  The counts are zeroed
     just before stage 2 and read at the start of every epoch's training:
     each step must launch K1 x3, K2 x3, K3 x1, K4 x1, K5 x4, K6 forward
     and backward x1 and K7 x4, each eval batch K1 x1, K4 x1 (the recon
     loss's counts), K5 x4 and K7 x4, and K7 once more per phase-2 round.
     One resume snapshot an epoch and one embeddings file an epoch; one
     non-empty trace; the params after the fit are the best checkpoint's.
     The epoch walls (training part, eval dispatch, total) are printed.
     Losses finite, per-k metrics printed; then a fresh Trainer resumes
     from an epoch-1 snapshot and its epoch 2 must equal the uninterrupted
     epoch 2.
  9. times: K5 at each k and K6 forward / backward at the main-path shapes
     (CUDA events around the wrapper, and the kernels' device time from
     torch.profiler and K6's achieved TFLOP/s) beside their bounds and plain
     versions (and the unfused eager tail); K5 as the fit's sampler calls it
     (the dispatcher on the sampler's own arguments, by events); the
     stage-2 step with the fused tail on / off and the proposals "pallas" /
     "xla" (in turns; per route also a profiled step with its device
     operation count, its host synchronisations and the negatives alone),
     and the fit's epoch and eval walls; K7 beside K5 at 2,048 and 96
     positives per k = 2..5 (K7's phase 1 alone by events and device time,
     the bytes bound; the whole per-size sampler call, draws and rounds
     included, on K7 and, as the plain column, on the eager chain); K8 at
     the hg38 1 Mb and 100 kb encodes (f32 tables, bf16, dim 64): its keep,
     forward and backward by events and device time beside their bytes
     bounds, against the eager chain's forward and backward on the same
     draws (time and values).
 10. shapes the kernels do not take: a dim-16, 4-head model (f32, k = 2, 3,
     the hg38 genome) with the fused tail on; the counts are zeroed just
     before and read just after one Trainer.train_step ("xla" proposals:
     K3 and K4 once, K7 once per k and per round, K1, K2, K5 and K6
     never), one predict_proba (no K1) and one k = 7 sample_negatives with
     propose_impl="pallas", which must warn and launch no K5 and no K7; the
     same step with dropout off on fixed
     negatives against f32 on the CPU (1e-5 loss, 1e-4 grads), and the
     probabilities against the CPU's (1e-4).
 11. run_train through the CLI at full width: the hg38 genome, random
     contacts and an edge list of clusters drawn from multi-way templates,
     written with numpy only; `python -m matcha_tpu_torch kmers` in a
     subprocess, then the `train` stage through the same entry in this
     process (embed_dim 64, 8 heads, compute "auto", batch 2,048, 10 batches
     per epoch, 1 + 1 epochs).  "auto" must resolve to bf16 / merged /
     "xla" / fused tail off; the artifacts (bundle, embeddings, checkpoint,
     metrics log) must exist and the bundle must score candidates; the
     counts are zeroed just before the train stage and read just after: K1-
     K4 and K7 launched, K5 and K6 not.  Prints each stage's wall, the
     train sizes, whether the native parser and counter built, and which of
     h5py, scipy, matplotlib and pandas the machine has.
 12. denoise at full width on the serving bundle: the port's denoise
     computation (denoise_pixels, the closed form) over all 23 chromosomes
     at min_distance 0, the counts zeroed just before and read just after
     (no kernel may launch); the pixel count (sum of n_c (n_c + 1) / 2) and
     every value finite in [0, 1]; on chr1 the f32 pair probabilities on
     the card against the CPU's (1e-4) and the closed form against the
     forward over the explicit pairs, both bf16 on the card (3e-2); the
     pass's wall and its parts (tables and pair scores, normalisation,
     quantile transforms, the write); run_denoise to an .mcool and its
     layout where h5py is importable, else a line that says it was not run.
 13. outlier ranking: 2,000 of the serving candidates of each k = 3..5
     through generate_outliers (20 per edge) and outlier_hit_rate (top 3,
     batch 10,000), the counts zeroed just before and read just after (K1
     once per chunk, nothing else); rows per second; per-position scores
     f32 on the card against f32 on the CPU (1e-4) and bf16 on the card
     against it (3e-2 of the largest score).
 14. the model modes at the training step's shape (phase 6's problem, the
     shipped path), each with the counts zeroed just before and read just
     after: (a) a regress step (K1 x3, K2 x3, K4 x4, no K3: the padded
     forward gathers plainly) and Trainer.fit in the regress mode (one
     epoch of 10 steps, its per-k eval, a checkpoint); (b) an epoch of 10
     steps with the per-occurrence feature dropout (K1 x3, K2 x3 per step,
     no K3 or K4), the step's peak memory above what was held before it
     (below the 3.66 GB of the JAX package's gathered weights), and the
     step in f32 at dropout 0 on the card against the CPU (1e-5 loss, 1e-4
     gradients); (c) MATCHA_RECON_BF16, set between runs (never inside
     one): the first step's recon loss against the same step with the gate
     off (2e-2 relative), synchronised steps of a gate-off and a gate-on
     Trainer in turns (off, on, on, off; 12 each), and an epoch of 10 steps
     (K1 x3, K2 x3, K3 x1, K4 x1 per step).
 15. walk pretraining at full width, right after phase 11 and on its
     temp_dir (3,067 nodes, 8,282 clusters): `pretrain` through
     pipeline.main in this process with the JAX package's defaults
     (embed_dim 64, hypergraph walks, 10 walks of 80 steps, window 10, 5
     negatives, batch 4,096, 1 epoch), the counts zeroed just before and
     read just after: exactly 2 K3 and 2 K4 per minibatch and nothing else;
     walk_embeddings.npy (3,067, 64) and finite; the mean loss of the
     epoch's last tenth of minibatches below its first tenth's; one f32
     SGNS step with injected uniforms on the card against the CPU, on the
     run's first minibatch and on it with a hub row (every entry within
     its row's f32 rounding bound; the run's also within 1e-5 of each
     table's largest entry).  Prints the walk build's parts, the walk
     simulation, the pair building and the SGNS rate, the rate and the
     device's idle share over a profiled window of 50 minibatches, and K3
     and K4 at these shapes and into the 100 kb table's 30,345 rows
     (events, device time, bound, plain version, index_add_ /
     torch.bincount; for K3 also index_add_ from its own inputs, the
     zeroing and casts included, and each of its kernels' device time).
     Then a table-mode model initialised
     from the embeddings (init_model(embedding_mode="table", table_init=))
     trains a 10-step stage-2 epoch at phase 6's configuration, the counts
     zeroed just before and read just after: K1 x3, K2 x3, K3 x1 per step
     and no K4 (the recon loss is 0 in table mode).
 16. multi-rank training on the one card (parallel/): K1-K4 against their
     plain versions at one rank's shapes for W = 2 and 4 ranks; (a) a world
     of one on NCCL through init_distributed (the launcher's environment
     set here), a 1 x 1 mesh, phase 6's configuration: its step bit-equal
     to the no-mesh step on the same draws, and an OrbaxCheckpointer round
     trip of its params, AdamW state and generator, bit for bit; (b) the
     meshes 2 x 1, 1 x 2 and 2 x 2, their ranks spawned on gloo and sharing
     the card (NCCL refuses two ranks on one device), each rank building
     phase 6's problem from the seed: a deterministic f32 step (dropout off,
     fixed negatives and recon chromosome, TF32 off) whose gradients, summed
     over the ranks, must equal one rank's with n_shards = D within 1e-5 of
     each gradient's max; a warm-up and a timed bf16 epoch of 10 steps,
     the counts zeroed just before and read just after the timed one on
     every rank (K1 x3, K2 x3, K3 x1, K4 x1 per step), finite losses and the
     params equal across the ranks bit for bit; per rank the synchronised
     step, the gradient all-reduce (gloo through the host: not an NCCL
     number), the frozen tables' bytes (smaller on the model axis) and the
     peak memory; (c) on the 2 x 1 mesh a stage-2 fit of 2 epochs with the
     fused tail and the "pallas" proposals (K5, K6 on every rank, counts
     pinned with the eval batches') and "orbax" checkpoints, then a resume
     in fresh Trainers for one more epoch; (d) tensor parallelism: K1 and
     K2 against their plain versions at a tensor-parallel rank's shapes (4
     heads of 64, the data row's 8,192 / D edges, L = 3, 4, 5, bf16 and
     f32); in the ranks of the 1 x 2 and 2 x 2 meshes a tensor-parallel
     Trainer beside the data-parallel one: its f32 step against the
     data-parallel step on the same mesh (1e-5 of each gradient's max), a
     timed bf16 epoch with the counts pinned per rank (K1 x3, K2 x3, K3 x1,
     K4 x1 per step), finite losses, the whole params equal on every rank
     and each rank's blocks across its data group; per rank the
     synchronised step, the attention's collectives per step alone (gloo
     through the host: not NCCL numbers) and the peak memory, beside the
     data-parallel mesh's; (e) on the 1 x 2 mesh per-occurrence feature
     dropout: a timed bf16 epoch (K1 x3, K2 x3 per step, no K3 or K4),
     finite, the ranks' params equal, the peak memory per rank, and the f32
     step at rate 0 (the other dropouts the identity) against one rank with
     n_shards = D within 1e-5 of each gradient's max.
 17. (run after phase 14 and before phase 16, whose ranks share the card)
     the 100 kb all-genome configuration of the JAX package's
     scripts/bench_100kb.py at full width: hg38 chr1-22 + chrX at 100,000
     bp (30,344 nodes), dim 64, 8 heads, bf16 compute with f32 master
     params, frozen tables in bf16 drawn per chromosome from the seed as
     its build_frozen_synthetic draws them, 4 x 2,048 random sorted rows
     per k = 2..5 (duplicate nodes dropped), weights in [0.5, 1.5), Bloom
     filters from the buckets, alpha 1, beta 0.001, the knobs that
     resolve_perf gives on the card (merged, unfused tail, "xla").  The
     memory around the Trainer's pad of inter_z (2,491 zero columns); (a)
     prepare_device_epochs, a warm-up epoch and three timed
     train_epoch_device epochs of 10 steps, the counts zeroed just before
     and read just after each (K1 x3, K2 x3, K3 x1, K4 x1 per step),
     finite losses, every param moved; from saved params, AdamW state and
     generator state the device epoch against _launch_epoch on the
     permutations redrawn by hand, bit for bit; a deterministic f32 step
     (dropout off, the same negatives and recon chromosome, 512 positives
     per k, f32 tables on both sides) on the card against the CPU (1e-5
     loss, 1e-4 gradients, bf16 loss 2e-2); the synchronised step and a
     profiled one (device busy, idle share); K3 and K4 at T = 114,688, n
     = 30,345 and K1, K2 at the step's shapes (events, device time,
     bounds, index_add_ / torch.bincount); (b) Trainer.fit with
     device_epochs="on": 2 epochs of 10 steps with eval over 2,048 test
     rows per k (4 batches of 2,048), a checkpoint and the embedding
     export, the counts zeroed just before and read just after (each step
     as in (a), each eval batch K1 x1, K4 x1), the embeddings (30,344,
     64) and finite.  Prints the phase's wall.
 18. (run after phase 17, its tensors released, and before phase 16) a
     user's 100 kb all-genome run through the entry points, 30,344 nodes:
     (a) with numpy only, dense f32 (N, N) contacts written by
     save_contacts (intra banded per chromosome as the JAX package's
     scripts/bench_apps_100kb.py draws it, one all-zero bin per
     chromosome; inter sparse and symmetric, ~64 positive entries per row
     off its chromosome, some rows all zero and some with one entry) and
     phase 11's edge list; the free disk checked first (temp_dir and the
     bundle hold 4 x 3.68 GB: too little fails); (b) kmers (a subprocess)
     and train (pipeline.main) with phase 11's config and table_dtype
     "bfloat16": "auto" must resolve to bf16 / merged / xla / off, K1-K4
     launch and K5 / K6 not, the artifacts exist, the embeddings (30,344,
     64) and finite; (c) the bundle loaded once (f32 tables on the card;
     np.load and the table build timed apart, host and card memory), then
     denoise_pixels over the 23 chromosomes (a warm-up on the smallest,
     np.random.seed first, one timed pass and its parts, no kernel):
     exactly 23,607,738 finite pixels in [0, 1]; per chromosome the closed
     form vs the forward on 100,000 sampled pairs, bf16 on the card (3e-2);
     chr1's f32 pair probabilities card vs CPU on CPU copies of the same
     tables (1e-4); (d) run_predict_multiway on 20,000 queries per k = 2..5,
     each on one chromosome, its stages timed inside the call: K1 exactly
     6 times and nothing else, probabilities in (0, 1), 2,000 per k bf16
     card vs f32 CPU (3e-2); (e) outlier ranking as phase 13 on the loaded
     bundle and those queries: K1 once per chunk, per-position scores f32
     card vs CPU (1e-4).  Prints the phase's wall.
Then one JSON line of kernels, the card line, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import unittest.mock
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from matcha_tpu_torch import telemetry
from matcha_tpu_torch.apps.predict import predict_proba
from matcha_tpu_torch.apps.predict_multiway import (parse_interaction_file,
                                                    run_predict_multiway)
from matcha_tpu_torch.config import Config
from matcha_tpu_torch.data.batcher import BucketedBatcher
from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.kernels.build import build
from matcha_tpu_torch.models import hypersagnn as hs
from matcha_tpu_torch.models import modules
from matcha_tpu_torch.models.hypersagnn import (ModelDims,
                                                build_frozen_tables,
                                                configure_fuse_tail,
                                                encode_node_table,
                                                forward_buckets, init_model)
from matcha_tpu_torch.models.modules import (dropout, layer_norm, mha_init,
                                             pff, split_generator)
from matcha_tpu_torch.ops import fused_tail as ft
from matcha_tpu_torch.ops import node_encode as ne
from matcha_tpu_torch.ops import propose as tp
from matcha_tpu_torch.ops import sample_negatives as sn
from matcha_tpu_torch.ops import table_scatter as ts
from matcha_tpu_torch.ops.hyperedge_attention import (
    hyperedge_attention, hyperedge_attention_bwd_cuda,
    hyperedge_attention_bwd_plain, hyperedge_attention_cuda,
    hyperedge_attention_plain, pack_ln)
from matcha_tpu_torch.ops.incidence import PaddedIncidence, pair_cooccurrence
from matcha_tpu_torch.parallel.distributed import (free_port,
                                                   init_distributed, spawn)
from matcha_tpu_torch.parallel.mesh import (all_gather_blocks,
                                            block_span, frozen_nbytes,
                                            make_mesh, model_group_rows,
                                            rank_rows,
                                            reduce_scatter_blocks, tp_gather,
                                            using_active_mesh)
from matcha_tpu_torch.parallel.stream import shard_concat
from matcha_tpu_torch.pipeline import resolve_perf
from matcha_tpu_torch.sampler import bloom as tb
from matcha_tpu_torch.sampler.bloom import build_bloom_dict
from matcha_tpu_torch.sampler import negative as tn
from matcha_tpu_torch.sampler.negative import ChromTable, sample_negatives
from matcha_tpu_torch.train import runtime
from matcha_tpu_torch.train.checkpoint import OrbaxCheckpointer
from matcha_tpu_torch.train.runtime import (Trainer, TrainSettings,
                                            _bucket_bce_and_preds, _leaves,
                                            _sample_all_negatives, _tree_map,
                                            load_checkpoint,
                                            load_model_bundle,
                                            save_model_bundle)
from matcha_tpu_torch.walks import skipgram
from matcha_tpu_torch.walks.hyper import incidence_matrices

SEED = 0
HG38 = [248_956_422, 242_193_529, 198_295_559, 190_214_555, 181_538_259,
        170_805_979, 159_345_973, 145_138_636, 138_394_717, 133_797_422,
        135_086_622, 133_275_309, 114_364_328, 107_043_718, 101_991_189,
        90_338_345, 83_257_441, 80_373_285, 58_617_616, 64_444_167,
        46_709_983, 50_818_468, 156_040_895]          # chr1-22, chrX
HG38_NAMES = [f"chr{i + 1}" for i in range(22)] + ["chrX"]
DIM, N_HEAD = 64, 8
PER_K, KS, BATCH = 20_000, (2, 3, 4, 5), 10_000
CHECK_PER_K = 2_000
# published H100 SXM peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# K1 vs plain: f32 differs by summation order only; the bf16 (tensor-core)
# route rounds where the plain version rounds, so it differs by summation
# order and the rounding flips that causes, a few bf16 ulps of |y| <= ~2
TOL_KERNEL = {"float32": 1e-4, "bfloat16": 2e-2}
# probabilities: f32 card vs f32 CPU (summation order); bf16 card vs f32 CPU
# (bf16 rounding through the encode, next_w, attention and classifier)
TOL_PROBA_F32, TOL_PROBA_BF16 = 1e-4, 3e-2
# K2 vs autograd of the plain version, each gradient's max abs error
# relative to its largest entry: f32 by summation order; bf16 as K1 (the
# kernel rounds where the TPU kernel rounds, the plain version where the
# XLA oracle rounds)
TOL_K2 = {"float32": 1e-4, "bfloat16": 3e-2}
# training: positives per k (bench.py's BATCH), steps per epoch, positives
# per k of the deterministic card-vs-CPU step
TRAIN_KS, TRAIN_BATCH, TRAIN_STEPS, CHECK_BATCH = (2, 3, 4, 5), 2048, 10, 512
# Trainer.fit: stage-2 epochs, test rows per k (pooled 16,000; eval takes
# 10,000 -> 4 batches of 2,048)
FIT_EPOCHS, TEST_PER_K, EVAL_SAMPLES = 3, 4_000, 10_000
# K6 vs plain: both sides round at the same places and draw the same mask
# bits, so f32 differs by summation order (1e-4 relative to each output's
# max); in bf16 one rounding flip of an intermediate moves the rest of the
# chain by a bf16 ulp (2e-2 relative to each output's max, the scale floored
# at 1e-3 of the largest gradient, as in phase 6)
TOL_K6 = {"float32": 1e-4, "bfloat16": 2e-2}
# K8 (bf16) against the eager chain on the same draws: the output as K1's
# (the same roundings, sums in another order); each gradient within 3e-2 of
# its largest entry (the eager chain rounds dW1 and dW2 to bf16, K8 sums
# them in f32)
TOL_K8_OUT, TOL_K8_GRAD = 2e-2, 3e-2
# resume on the card: every kernel of the step is deterministic and the
# resumed Trainer replays the snapshot's generator state, so epoch 2 should
# repeat bit for bit; 1e-6 relative leaves room for a library reduction that
# chose another order
TOL_RESUME = 1e-6
# deterministic step: f32 card vs f32 CPU loss (relative) and grads
# (relative to each gradient's max); bf16 card vs f32 CPU loss (relative)
TOL_STEP_LOSS_F32, TOL_STEP_GRAD_F32, TOL_STEP_LOSS_BF16 = 1e-5, 1e-4, 2e-2
# run_train through the CLI: multi-way templates, batch, width
CLI_TEMPLATES, CLI_BATCH, CLI_DIM = 1_500, TRAIN_BATCH, DIM
# outlier ranking: corrupted copies per edge; per-position scores f32 card
# vs f32 CPU (summation order) and bf16 card vs f32 CPU, relative to the
# largest score (bf16 rounding through the model, as TOL_PROBA_BF16)
OUTLIER_PER_EDGE, TOL_SCORES_F32, TOL_SCORES_BF16 = 20, 1e-4, 3e-2
# per-occurrence step: the bytes of the (T, W, d) bf16 weight gather the JAX
# package builds at the step's 114,688 tokens and chr1's W = 249; the step's
# peak above what was held before it must stay below it
JAX_GATHERED_W1_BYTES = 4 * TRAIN_BATCH * sum(TRAIN_KS) * 249 * DIM * 2
# recon loss with bf16 decode operands vs the f32 decode, relative
TOL_RECON_BF16 = 2e-2
# walk pretraining at the hg38 1 Mb shape: the vocabulary (nodes), the SGNS
# minibatch, negatives per pair, the table width, and the K3 / K4 token
# counts of one minibatch (the centers; the contexts and negatives)
SGNS_V, SGNS_M, SGNS_NEG, SGNS_D = 3_067, 4_096, 5, 64
SGNS_T = (SGNS_M, SGNS_M * (1 + SGNS_NEG))
# K3 and K4 at the same minibatches into the 100 kb table's 30,345 rows (the
# pretraining a user runs at 100 kb)
SGNS_V_100KB = 30_345
# K3's two routes (csrc/table_scatter.cu), told apart by the kernels a call
# launched
K3_ROUTES = {"scatter_local_kernel": "local: one launch, each block a band of "
                                     "rows over all the ids",
             "band_count_kernel": "grid: band count, band scan, band place, "
                                  "row sort, sum, fixup (six launches)"}
# minibatches of the profiled SGNS window, and of the hg38-size random
# hypergraph the co-occurrence scatter is checked on (phase 11's cluster count)
SGNS_PROFILE_STEPS, COOC_EDGES = 50, 8_282
# SGNS step f32 card vs f32 CPU (f32 sums in another order): every entry
# within its row's f32 rounding bound (sgns_step_limits), and on the run's
# own pairs also within this share of each table's largest entry; the loss
# relative; the co-occurrence weights against scipy's
# float64 CSR product (the f32 rounding of 1/|e| and of the sums), as
# tests/test_walks.py holds the JAX package's
TOL_SGNS_STEP, TOL_COOC_RTOL, TOL_COOC_ATOL = 1e-5, 1e-6, 1e-7


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


@contextlib.contextmanager
def timed_calls(module, *names):
    """Within the block, each named function of ``module`` (a module
    global its callers look up at call time) is wrapped to add its
    host-clock seconds to the yielded dict, under its name."""
    spent = dict.fromkeys(names, 0.0)

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t0
        return call
    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(unittest.mock.patch.object(
                module, name, timed(name, getattr(module, name))))
        yield spent


def rss_gb() -> float:
    """This process's resident memory now (GB)."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 1e9


class HostMemory:
    """This process's resident memory over a with-block: a thread reads it
    every 10 ms and keeps the largest.  Beside it the process's peak since
    it started (``ru_maxrss``; Linux resets that counter only through
    /proc/self/clear_refs, which a container may refuse)."""

    def __enter__(self):
        self.start_gb = self.peak_gb = self.end_gb = rss_gb()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def _poll(self):
        while not self._stop.wait(0.01):
            self.peak_gb = max(self.peak_gb, rss_gb())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.end_gb = rss_gb()
        self.peak_gb = max(self.peak_gb, self.end_gb)

    def reading(self) -> dict:
        import resource
        peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return {"start_gb": self.start_gb, "peak_gb": self.peak_gb,
                "end_gb": self.end_gb, "process_peak_gb": peak_kb * 1e3 / 1e9}


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=3, iters=20, repeats=5) -> float:
    """Median over repeats of the mean time of ``iters`` calls, by CUDA
    events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def attention_work(E: int, L: int, dtype: str):
    """(operations, bytes) K1 needs for E edges of L tokens: the q/k/v and
    fc1 products, scores and a@v; x read once, y written once, the f32
    weights and LayerNorm params read once."""
    d, hd = DIM, N_HEAD * DIM
    flops = E * (2 * L * d * hd * 3 + 2 * L * hd * d + 4 * L * L * hd)
    xbytes = 2 if dtype == "bfloat16" else 4
    nbytes = 2 * E * L * d * xbytes + 4 * (4 * d * hd + 7 * d)
    return flops, nbytes


def bound_ms(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def attention_inputs(device, E, L, dtype, seed=SEED):
    """x like the encoder's input (tanh range) and the weights of one
    attention layer at full width, LayerNorm params perturbed off 1/0."""
    gen = torch.Generator().manual_seed(seed)
    p = mha_init(gen, N_HEAD, DIM, DIM, DIM, DIM)
    for name in ("ln_q", "ln_k", "ln_v"):
        p[name]["g"] = 1 + 0.1 * torch.randn(DIM, generator=gen)
        p[name]["b"] = 0.1 * torch.randn(DIM, generator=gen)
    x = torch.tanh(torch.randn((E, L, DIM), generator=gen))
    args = [pack_ln(p), p["wq"], p["wk"], p["wv"], p["fc1"]["w"],
            p["fc1"]["b"]]
    return (x.to(device, getattr(torch, dtype)),
            [a.to(device) for a in args])


def check_kernels(device) -> dict:
    """Phase 3: K1 against its plain version, both routes (bf16: tensor
    cores; f32: CUDA cores), at the main paths' shapes and at every L =
    2..8 with E not a multiple of any tile and both diag_mask settings; the
    bf16 route's bits across two calls.  -> the worst error per dtype."""
    cases = [(E, L, dt, True) for dt in ("float32", "bfloat16")
             for L in (3, 4, 5) for E in (10_000, 1_000, 37)]
    cases += [(1_000, 4, "float32", False), (1_000, 2, "bfloat16", False)]
    cases += [(997 + 3 * L, L, "bfloat16", diag) for L in range(2, 9)
              for diag in (True, False)]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for E, L, dt, diag in cases:
        x, args = attention_inputs(device, E, L, dt, seed=SEED + E + L)
        got = hyperedge_attention_cuda(x, *args, N_HEAD, diag)
        ref = hyperedge_attention_plain(x, *args, N_HEAD, diag)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        tol = TOL_KERNEL[dt]
        ok = (bool(torch.isfinite(got).all())
              and torch.allclose(got.float(), ref.float(), rtol=tol,
                                 atol=tol))
        print(f"K1 vs plain: E={E} L={L} {dt} diag_mask={diag} "
              f"max_abs_err={err:.3e} tol={tol} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail(f"K1 disagrees with its plain version at E={E} L={L} {dt}")
        worst[dt] = max(worst[dt], err)
    for E, L in ((8_192, 5), (10_000, 5), (8_192, 3)):
        x, args = attention_inputs(device, E, L, "bfloat16", seed=SEED + 5)
        a = hyperedge_attention_cuda(x, *args, N_HEAD, True)
        if not torch.equal(a, hyperedge_attention_cuda(x, *args, N_HEAD,
                                                       True)):
            fail(f"K1 (tensor-core route) is not deterministic at E={E} "
                 f"L={L}")
    print("K1 bf16 at E=8192 L=5, E=10000 L=5, E=8192 L=3: two calls give "
          "the same bits ok", flush=True)
    return worst


def attention_bwd_work(E: int, L: int, dtype: str):
    """(operations, bytes) K2 needs for E edges of L tokens: the forward's
    q/k/v products, scores and a@v recomputed, then g @ fw^T, gfw, g.v, the
    three attention grads, the three products back to x and the three
    weight grads; x and g read once, gx written once, the f32 weights and
    LayerNorm params read once and their grads written once."""
    d, hd = DIM, N_HEAD * DIM
    flops = E * (2 * L * d * hd * 11 + 12 * L * L * hd)
    xbytes = 2 if dtype == "bfloat16" else 4
    nbytes = 3 * E * L * d * xbytes + 2 * 4 * (4 * d * hd + 7 * d)
    return flops, nbytes


def rel_err(got, ref) -> float:
    """max |got - ref| relative to max |ref|."""
    ref = ref.float()
    return float((got.float() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))


def check_backward(device) -> dict:
    """K2 against autograd of the plain version; -> the worst gx abs error
    and the worst error relative to each gradient's max, per dtype."""
    cases = [(E, L, dt, True) for dt in ("float32", "bfloat16")
             for L in (3, 4, 5) for E in (8_192, 1_000, 37)]
    cases += [(1_000, 4, "float32", False), (1_000, 3, "bfloat16", False)]
    # every L the kernels take, E not a multiple of any tile, both masks
    cases += [(1_003, L, dt, L % 2 == 0) for L in (2, 6, 7, 8)
              for dt in ("float32", "bfloat16")]
    cases += [(997, L, "bfloat16", L % 2 == 1) for L in (2, 5, 8)]
    names = ["gx", "gln", "gwq", "gwk", "gwv", "gfw", "gfb"]
    worst = {dt: {"gx_abs": 0.0, "rel_to_max": 0.0}
             for dt in ("float32", "bfloat16")}
    for E, L, dt, diag in cases:
        x, args = attention_inputs(device, E, L, dt, seed=SEED + 7 * E + L)
        g = torch.randn(x.shape, generator=torch.Generator().manual_seed(E),
                        dtype=torch.float32).to(device, x.dtype)
        got = hyperedge_attention_bwd_cuda(x, *args, g, N_HEAD, diag)
        ref = hyperedge_attention_bwd_plain(x, *args, g, N_HEAD, diag)
        torch.cuda.synchronize()
        errs = {n: rel_err(a, b) for n, a, b in zip(names, got, ref)}
        ok = (all(bool(torch.isfinite(a).all()) for a in got)
              and max(errs.values()) <= TOL_K2[dt])
        gx_abs = float((got[0].float() - ref[0].float()).abs().max())
        print(f"K2 vs plain: E={E} L={L} {dt} diag_mask={diag} gx max_abs_err"
              f"={gx_abs:.3e} worst rel-to-max {max(errs, key=errs.get)}="
              f"{max(errs.values()):.3e} tol={TOL_K2[dt]} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"K2 disagrees with its plain version at E={E} L={L} {dt}: "
                 f"{errs}")
        worst[dt]["gx_abs"] = max(worst[dt]["gx_abs"], gx_abs)
        worst[dt]["rel_to_max"] = max(worst[dt]["rel_to_max"],
                                      max(errs.values()))
    x, args = attention_inputs(device, 8_192, 5, "bfloat16", seed=SEED + 9)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(9),
                    dtype=torch.float32).to(device, x.dtype)
    a = hyperedge_attention_bwd_cuda(x, *args, g, N_HEAD, True)
    b = hyperedge_attention_bwd_cuda(x, *args, g, N_HEAD, True)
    if not all(torch.equal(u, v) for u, v in zip(a, b)):
        fail("K2 (tensor-core route) is not deterministic")
    print("K2 bf16 at E=8192 L=5: two calls give the same bits ok",
          flush=True)
    return worst


def skewed_ids(kind: str, rng, T: int, n: int) -> np.ndarray:
    """Ids K3 must survive: uniform, Zipf (s = 1.1) over the rows in a
    random row order, all on one row, a hub row holding half of T, or a
    quarter of them outside [0, n)."""
    if kind == "zipf":
        p = 1.0 / np.arange(1, n + 1) ** 1.1
        ids = rng.permutation(n)[rng.choice(n, T, p=p / p.sum())]
    elif kind == "one_row":
        ids = np.full(T, n // 2)
    elif kind == "hub":
        ids = rng.integers(0, n, T)
        ids[rng.permutation(T)[:T // 2]] = 3
    elif kind == "out_of_range":
        ids = rng.integers(0, n, T)
        pick = rng.permutation(T)[:T // 4]
        ids[pick] = rng.choice([-1, -7, n, n + 5, 2 ** 31 - 1], len(pick))
    else:
        ids = rng.integers(0, n, T)
    return ids.astype(np.int32)


def check_scatter_skewed(device) -> float:
    """Phase 3: K3 against its plain version on skewed and out-of-range ids,
    at the step's shape and at table heights and widths the shared paths do
    not cover (n = 60,000; d = 1, 48, 1536).  g holds multiples of 1/4, so
    every sum is exact whatever the order (1e-5 is then a bound on a wrong
    or missing token); two calls on normal g give the same bits.  K4 against
    its plain version on the same ids, exactly.  -> the worst K3 error."""
    worst = 0.0
    cases = [(114_688, 3_068, 64, kind) for kind in
             ("zipf", "one_row", "hub", "out_of_range")]
    cases += [(5_000, 60_000, 64, "out_of_range"), (3_000, 300, 1, "hub"),
              (2_000, 300, 1_536, "zipf"), (4_097, 1_000, 48, "uniform")]
    for T, n, d, kind in cases:
        rng = np.random.default_rng(SEED + T + n + d)
        idx = torch.from_numpy(skewed_ids(kind, rng, T, n)).to(device)
        for dt in (torch.float32, torch.bfloat16):
            g = torch.from_numpy(rng.integers(-8, 9, (T, d)) / 4).to(device, dt)
            got = ts.scatter_add_cuda(g, idx, n)
            ref = ts.scatter_add_plain(g, idx, n)
            gn = torch.randn((T, d), generator=torch.Generator().manual_seed(T),
                             dtype=torch.float32).to(device, dt)
            same = torch.equal(ts.scatter_add_cuda(gn, idx, n),
                               ts.scatter_add_cuda(gn, idx, n))
            torch.cuda.synchronize()
            err = float((got - ref).abs().max()) if got.numel() else 0.0
            ok = same and torch.allclose(got, ref, rtol=1e-5, atol=1e-5)
            print(f"K3 vs plain: {kind} T={T} n={n} d={d} {dt} max_abs_err="
                  f"{err:.3e} tol=1e-05, same bits twice {same} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"K3 disagrees with its plain version ({kind}, T={T}, "
                     f"n={n}, d={d}, {dt})")
            worst = max(worst, err)
        if not torch.equal(ts.bincount_cuda(idx, n), ts.bincount_plain(idx, n)):
            fail(f"K4 disagrees with its plain version ({kind}, T={T}, n={n})")
    print("K4 vs plain on the same ids: exact ok", flush=True)
    return worst


def check_scatter_bincount(device) -> dict:
    """K3 against index_add_ (f32 sums, 1e-5) and K4 against bincount
    (exact), at the training step's shape, at 1 Mb (n = 3,068) and at 100
    kb (n = 30,345: K3's global-histogram route, K4's banded one), and a
    ragged one; -> worst K3 error."""
    worst = 0.0
    for T, n, dt in [(114_688, 3_068, torch.float32),
                     (114_688, 3_068, torch.bfloat16),
                     (114_688, 30_345, torch.float32),
                     (114_688, 30_345, torch.bfloat16),
                     (1_001, 300, torch.bfloat16)]:
        gen = torch.Generator().manual_seed(T + n)
        g = torch.randn((T, DIM), generator=gen).to(device, dt)
        idx = torch.randint(0, n, (T,), generator=gen,
                            dtype=torch.int32).to(device)
        got = ts.scatter_add_cuda(g, idx, n)
        ref = torch.zeros((n, DIM), device=device).index_add_(
            0, idx.long(), g.float())
        cnt = ts.bincount_cuda(idx, n)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = (torch.allclose(got, ref, rtol=1e-5, atol=1e-5)
              and torch.allclose(got, ts.scatter_add_plain(g, idx, n),
                                 rtol=1e-5, atol=1e-5)
              and torch.equal(got, ts.scatter_add_cuda(g, idx, n)))
        exact = torch.equal(cnt, torch.bincount(idx.long(),
                                                minlength=n).float())
        print(f"K3 vs index_add_ and plain: T={T} n={n} {dt} max_abs_err={err:.3e} "
              f"tol=1e-05 deterministic {'ok' if ok else 'FAIL'}; "
              f"K4 vs bincount exact {'ok' if exact else 'FAIL'}",
              flush=True)
        if not (ok and exact):
            fail(f"K3/K4 disagree with their plain versions at T={T}")
        worst = max(worst, err)
    return worst


def check_bincount(device):
    """Phase 3: K4 against torch.bincount of the ids in [0, n), exactly, on
    uniform, Zipf, hub and out-of-range ids at the step's T, for n = 3,068
    (a whole histogram per block), 60,000 and 1,000,000 (the cluster's
    shared histogram in bands, one and two passes), its idx starting on
    and 4 bytes off a 16-byte boundary."""
    for n in (3_068, 60_000, 1_000_000):
        for kind in ("uniform", "zipf", "hub", "out_of_range"):
            rng = np.random.default_rng(SEED + n + len(kind))
            idx = torch.from_numpy(skewed_ids(kind, rng, 114_688, n)).to(
                device)
            for ids in (idx, idx[1:]):
                keep = ids[(ids >= 0) & (ids < n)].long()
                if not torch.equal(ts.bincount_cuda(ids, n),
                                   torch.bincount(keep, minlength=n).float()):
                    fail(f"K4 differs from torch.bincount ({kind}, n={n}, "
                         f"T={ids.shape[0]})")
    print("K4 vs torch.bincount: uniform, Zipf, hub and out-of-range ids, n "
          "= 3,068 / 60,000 / 1,000,000, aligned and unaligned idx: exact ok",
          flush=True)


def sgns_ids(rng, T: int, V: int = SGNS_V) -> np.ndarray:
    """T node ids drawn as the SGNS step draws its negatives: from the
    unigram^0.75 of Zipf-by-rank visit counts (p_i ~ 1/i over the V nodes
    in a random order: at V = SGNS_V the busiest node takes ~4% of the
    draws)."""
    counts = (1.0 / rng.permutation(np.arange(1, V + 1))) ** 0.75
    cdf = np.cumsum(counts / counts.sum())
    return np.minimum(np.searchsorted(cdf, rng.random(T)),
                      V - 1).astype(np.int32)


def sgns_kernel_inputs(device, T: int, hub: bool = False, V: int = SGNS_V):
    """K3's and K4's inputs as one SGNS minibatch gives them: f32 update
    rows (T, 64) at the scale of the step's gradients and unigram-skewed
    ids (T,) into V rows.  ``hub`` puts half of the ids on row 3 and makes
    the rows multiples of 1/4, so every sum is exact in f32 whatever the
    order."""
    rng = np.random.default_rng(SEED + T)
    g = (rng.integers(-8, 9, (T, SGNS_D)) / 4 if hub
         else rng.standard_normal((T, SGNS_D)) * 0.01)
    ids = sgns_ids(rng, T, V)
    if hub:
        ids[rng.permutation(T)[:T // 2]] = 3
    return (torch.tensor(g, dtype=torch.float32, device=device),
            torch.from_numpy(ids).to(device))


def check_sgns_kernels(device) -> float:
    """Phase 3: K3 and K4 at the SGNS shapes (f32, d = 64, n = 3,067 rows and
    the 100 kb table's 30,345, T = 4,096 and 24,576 unigram-skewed ids, and
    the same with a hub row holding half of T) against their plain versions
    (K3 1e-5, K4 exactly), each the same bits across two calls.  -> the
    worst K3 error."""
    worst = 0.0
    for V in (SGNS_V, SGNS_V_100KB):
        for T in SGNS_T:
            for hub in (False, True):
                g, idx = sgns_kernel_inputs(device, T, hub, V)
                got = ts.scatter_add_cuda(g, idx, V)
                ref = ts.scatter_add_plain(g, idx, V)
                cnt = ts.bincount_cuda(idx, V)
                same = (torch.equal(got, ts.scatter_add_cuda(g, idx, V))
                        and torch.equal(cnt, ts.bincount_cuda(idx, V)))
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                exact = torch.equal(cnt, ts.bincount_plain(idx, V))
                ok = same and exact and torch.allclose(got, ref, rtol=1e-5,
                                                       atol=1e-5)
                ids = "hub" if hub else "unigram"
                print(f"K3 / K4 vs plain at the SGNS shape T={T} n={V} d="
                      f"{SGNS_D} f32, {ids} ids: K3 max_abs_err={err:.3e} "
                      f"tol=1e-05, K4 exact {exact}, same bits twice {same} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"K3 / K4 disagree with their plain versions at the "
                         f"SGNS shape T={T}, n={V} ({ids} ids)")
                worst = max(worst, err)
    return worst


def cooc_edges(rng):
    """COOC_EDGES hyperedges of 2-25 distinct members (0-based) over
    SGNS_V nodes: the hg38 1 Mb pretraining's size."""
    return [np.sort(rng.choice(SGNS_V, rng.integers(2, 26), replace=False))
            for _ in range(COOC_EDGES)]


def check_cooccurrence(device):
    """Phase 3: the walks' co-occurrence scatter (``pair_cooccurrence``,
    plain torch in sorted-key order) on the card: the same bits across two
    calls, and against scipy's CSR product VE_od @ EV_od with the diagonal
    dropped (rtol 1e-6, atol 1e-7)."""
    edges = cooc_edges(np.random.default_rng(SEED + 31))
    inc = PaddedIncidence.from_ragged([e + 1 for e in edges], device=device)
    w = torch.tensor([1.0 / len(e) for e in edges], dtype=torch.float32,
                     device=device)
    got = pair_cooccurrence(inc, w, SGNS_V)
    same = torch.equal(got, pair_cooccurrence(inc, w, SGNS_V))
    got = got.cpu().numpy()[1:, 1:]
    _, ev_od = incidence_matrices(SGNS_V, edges)
    ref = (ev_od.T @ ev_od).toarray()
    np.fill_diagonal(ref, 0.0)
    err = float(np.abs(got - ref).max())
    ok = same and np.allclose(got, ref, rtol=TOL_COOC_RTOL,
                              atol=TOL_COOC_ATOL)
    print(f"pair_cooccurrence on the card ({COOC_EDGES} edges, {SGNS_V} "
          f"nodes) vs scipy: max_abs_err={err:.3e} rtol={TOL_COOC_RTOL} "
          f"atol={TOL_COOC_ATOL}, same bits twice {same} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("pair_cooccurrence on the card disagrees with scipy or is not "
             "deterministic")


def np_hash_rows(rows: np.ndarray):
    """The JAX package's host hash (matcha_tpu/sampler/bloom.py:_hash_rows
    under numpy): uint32 arithmetic with wraparound, over the last axis."""
    def mix(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))

    rows = rows.astype(np.uint32)
    with np.errstate(over="ignore"):
        h1 = np.full(rows.shape[:-1], 2166136261, np.uint32)
        h2 = np.full(rows.shape[:-1], 0x9747B28C, np.uint32)
        for j in range(rows.shape[-1]):
            x = rows[..., j]
            h1 = mix(h1 ^ x) * np.uint32(16777619)
            h2 = mix(h2 ^ (x * np.uint32(2654435761))) * np.uint32(2246822519)
    return h1, h2 | np.uint32(1)


def check_bloom(device):
    """The Bloom hashes on the card (both axes) against numpy bit for bit,
    and the card's membership answers against the numpy bitset's."""
    rng = np.random.default_rng(SEED + 3)
    rows = np.sort(rng.integers(1, 3_068, (200_000, 5)), 1).astype(np.int32)
    h1n, h2n = np_hash_rows(rows)
    dev_rows = torch.from_numpy(rows).to(device)
    for axis, r in ((-1, dev_rows), (-2, dev_rows.T.contiguous())):
        h1, h2 = tb._hash_rows(r, axis=axis)
        if not (np.array_equal(h1.cpu().numpy().astype(np.uint32), h1n)
                and np.array_equal(h2.cpu().numpy().astype(np.uint32), h2n)):
            fail(f"Bloom hashes on the card differ from numpy (axis {axis})")
    f = tb.build_bloom(rows[:50_000], device=device)
    bits = f.bits.cpu().numpy().view(np.uint32)
    w = h1n % np.uint32(bits.shape[0])
    mask = ((np.uint32(1) << (h2n & np.uint32(31)))
            | (np.uint32(1) << ((h2n >> np.uint32(5)) & np.uint32(31))))
    want = (bits[w] & mask) == mask
    got = f.contains(dev_rows).cpu().numpy()
    if not (np.array_equal(got, want) and got[:50_000].all()):
        fail("Bloom membership on the card differs from the numpy bitset")
    print(f"Bloom: hashes of {len(rows)} rows (both axes) equal numpy bit "
          f"for bit; membership equals the numpy bitset "
          f"({int(got.sum())} hits)", flush=True)


def propose_inputs(device, k, n, seed, T=8):
    """Phase-1 inputs as the sampler builds them at full width, in its
    layout: orig (n, k) on the 3,067 nodes of hg38, change (n, k) bool with
    at least one corrupted position per row, chromosome-like [lo, hi)
    ranges, uniforms u (T, n, k) with the top one on the f32-rounding
    guard."""
    rng = np.random.default_rng(seed)
    orig = np.sort(rng.integers(1, 3_068, size=(n, k)), axis=1)
    change = rng.random((n, k)) < 0.5
    change[np.arange(n), rng.integers(0, k, n)] = True
    lo = rng.integers(1, 2_800, size=(n, k)).astype(np.float32)
    hi = lo + rng.integers(1, 250, size=(n, k)).astype(np.float32)
    u = rng.random((T, n, k), dtype=np.float32)
    u[0, :5, :] = np.nextafter(np.float32(1), np.float32(0))
    return [torch.tensor(a, device=device) for a in
            (orig.astype(np.int32), change, lo, hi, u)]


def sampler_problem(genome, device, seed, n_pos=TRAIN_BATCH, ks=TRAIN_KS):
    """A stage-2 step's sampler inputs at full width: 2,048 positives per k
    on hg38 with their Bloom filters, the chromosome table and the host
    chromosome bounds the Trainer hands the sampler."""
    table = ChromTable.from_genome(genome, device=device)
    bounds = tuple((int(s), int(e)) for s, e in genome.chrom_range)
    pos = {k: torch.from_numpy(e[:n_pos]).to(device) for k, (e, _) in
           random_buckets(genome, np.random.default_rng(seed), 4 * n_pos,
                          ks).items()}
    blooms = {k: tb.build_bloom(v.cpu().numpy(), device=device)
              for k, v in pos.items()}
    return table, bounds, pos, blooms


def check_propose(device, genome):
    """Phase 3: K5 against its plain version, bit for bit, at the sampler's
    shape (n = 2,048 x 3) and a ragged one (n = 1,001, a multiple of no
    block and of no lane group) for every k its networks cover, T = 1, 5,
    8, 16 and S = 1, 2, T; then the sampler with propose_impl "pallas" (K5)
    against "xla" for one generator at k = 2..5: the same negatives."""
    for k in range(1, 7):
        for n in (6_144, 1_001):
            for T in (1, 5, 8, 16):
                args = propose_inputs(device, k, n, SEED + 31 * k + n + T,
                                      T=T)
                for md, S in ((0, 1), (1, 2), (0, T)):
                    probe, has = tp.propose_phase1_cuda(
                        *args, min_distance=md, max_probes=S)
                    rp, rh = tp.propose_phase1_plain(*args, min_distance=md,
                                                     max_probes=S)
                    torch.cuda.synchronize()
                    if not (torch.equal(probe, rp) and torch.equal(has, rh)):
                        fail(f"K5 differs from its plain version at k={k} "
                             f"n={n} T={T} min_distance={md} S={S}")
    table, bounds, pos, blooms = sampler_problem(genome, device, SEED + 40)
    for k in TRAIN_KS:
        neg = {impl: sample_negatives(
            torch.Generator().manual_seed(SEED + k), pos[k], table, 0,
            blooms[k], max_probes=4 if k == 2 else 2, chrom_bounds=bounds,
            propose_impl=impl) for impl in ("xla", "pallas")}
        torch.cuda.synchronize()
        if not torch.equal(neg["xla"], neg["pallas"]):
            fail(f"the 'pallas' sampler (K5) differs from 'xla' at k={k}")
    print("K5 vs plain: k = 1..6, n = 6,144 and 1,001, T = 1, 5, 8, 16, S = "
          "1, 2, T: probe and has bit-equal ok; the 'pallas' sampler equals "
          "'xla' for one generator at k = 2..5", flush=True)


def sampled(seed, args, kw, eager=False):
    """sample_negatives_with_stats from a generator seeded ``seed``: on K7,
    or (eager=True) on the eager chain -> (negatives, counts, K7
    launches)."""
    real = tn._sample_k7
    if eager:
        tn._sample_k7 = tn._sample_eager
    before = sn.sample_negatives_cuda.launches
    try:
        neg, st = tn.sample_negatives_with_stats(
            torch.Generator().manual_seed(seed), *args, **kw)
        torch.cuda.synchronize()
    finally:
        tn._sample_k7 = real
    return (neg, [int(v) for v in st.values()],
            sn.sample_negatives_cuda.launches - before)


def check_k7(device, genome):
    """Phase 3: the sampler on K7 against the eager chain for one generator,
    bit for bit (negatives and counts), at the training cells' shapes (2,048
    and 96 positives per k = 2..5, 8 rounds, 4 / 2 probes, the Trainer's
    host bounds), "xla" (K7's phase 1) and "pallas" (K5, then K7's
    selection), hard_ratio 1 and 0.5."""
    for b in (TRAIN_BATCH, 96):
        table, bounds, pos, blooms = sampler_problem(genome, device,
                                                     SEED + 70 + b, n_pos=b)
        for k in TRAIN_KS:
            for impl in ("xla", "pallas"):
                for hard in (1.0, 0.5):
                    args = (pos[k], table, 0, blooms[k])
                    kw = dict(max_probes=4 if k == 2 else 2, hard_ratio=hard,
                              chrom_bounds=bounds, propose_impl=impl)
                    neg, st, n7 = sampled(SEED + k, args, kw)
                    ref, rst, _ = sampled(SEED + k, args, kw, eager=True)
                    if not (torch.equal(neg, ref) and st == rst) or n7 < 1:
                        fail(f"K7 differs from the eager chain at b={b} "
                             f"k={k} {impl} hard_ratio={hard}: counts {st} "
                             f"against {rst}, {n7} launches")
    print("K7 vs the eager chain: b = 2,048 and 96, k = 2..5, 'xla' and "
          "'pallas', hard_ratio 1 and 0.5: negatives and counts bit-equal "
          "ok", flush=True)


def time_k7(device, card) -> dict:
    """Phase 9: K7 beside K5 at the training cells' sampler shapes (2,048
    and 96 positives per k = 2..5, neg_num 3, T = 8, S = 4 / 2): K7's
    phase 1 by CUDA events around the wrapper and its device time by the
    profiler, K5 the same on inputs of its shapes, and the whole per-size
    sampler call (draws included) by events on K7 and, as the plain
    version, on the eager chain; K7 launches per call; the bound: the
    uniforms read and the negatives written at 3.35 TB/s."""
    out = {}
    for b in (TRAIN_BATCH, 96):
        table, bounds, pos, blooms = sampler_problem(
            hg38_genome(), device, SEED + 80 + b, n_pos=b)
        for k in TRAIN_KS:
            n, T, S = 3 * b, 8, 4 if k == 2 else 2
            p = pos[k].to(torch.int32).contiguous()
            gen = torch.Generator(device=device).manual_seed(SEED + k)
            u_count, u_rank = (torch.rand(shape, device=device,
                                          generator=gen)
                               for shape in ((n,), (n, k)))
            u = torch.rand((T, n, k), device=device, generator=gen)
            starts, ends = tn._bounds_on(bounds, device)

            def k7():
                return sn.sample_negatives_cuda(
                    p, 3, u_count, u_rank, None, u, starts=starts, ends=ends,
                    node2chrom=None, n_nodes=table.node2chrom.shape[0],
                    hard_ratio=1.0, bloom=blooms[k], min_distance=0,
                    max_probes=S)
            args5 = propose_inputs(device, k, n, seed=SEED + 90 + k)

            def k5():
                return tp.propose_phase1_cuda(*args5, min_distance=0,
                                              max_probes=S)
            args = (pos[k], table, 0, blooms[k])
            kw = dict(max_probes=S, chrom_bounds=bounds)
            _, _, launches = sampled(SEED + k, args, kw)
            real = tn._sample_k7

            def eager():
                tn._sample_k7 = tn._sample_eager
                try:
                    return tn.sample_negatives_with_stats(
                        torch.Generator().manual_seed(SEED + k), *args, **kw)
                finally:
                    tn._sample_k7 = real
            nbytes = 4 * (n + n * k + T * n * k) + 4 * b * k + 4 * n * k
            out[f"K7_b{b}_k{k}"] = {
                "b": b, "k": k, "n": n, "T": T, "S": S,
                "ms": cuda_ms(k7), "device_ms": device_ms_per_call(k7),
                "k5_ms": cuda_ms(k5), "k5_device_ms": device_ms_per_call(k5),
                "sampler_ms": cuda_ms(lambda: tn.sample_negatives_with_stats(
                    torch.Generator().manual_seed(SEED + k), *args, **kw),
                    iters=10),
                "plain_ms": cuda_ms(eager, iters=5),
                "launches_per_call": launches,
                "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
                "mbytes": nbytes / 1e6}
    for b in (TRAIN_BATCH, 96):
        rows = [out[f"K7_b{b}_k{k}"] for k in TRAIN_KS]
        out[f"step_b{b}"] = {key: sum(r[key] for r in rows) for key in
                             ("sampler_ms", "plain_ms", "launches_per_call")}
    print(json.dumps({"metric": "k7_sample_negatives", **out, "card": card}),
          flush=True)
    return out


def k8_case(device, label: str):
    """K8's inputs at one of time_k8's shapes, dim 64 -> (features, w1s,
    w2s, rows, first (each chromosome's first draw row), widths, draw
    (c -> chromosome c's draw, made anew from its own seed), batched)."""
    res = {"1mb": 1_000_000, "100kb": RES_100KB, "10kb": 10_000}[label]
    genome = GenomeBins(HG38_NAMES, HG38, res)
    widths = [int(e - s) for s, e in genome.chrom_range]
    C, W = len(widths), max(widths)
    batched = C * W * W * 4 <= (64 << 20)
    g = torch.Generator(device=device).manual_seed(SEED + 95)

    def uniform(*shape, scale=1.0):
        return (torch.rand(shape, device=device, generator=g) * 2
                - 1) * scale
    if label == "10kb":
        # model rank 3 of a 1 x 4 model axis: bf16 rows [3b, 4b) of each
        # table padded to 4b rows (pad rows zero, reading the draw's last
        # row), as train_10kb_m4_b96's last rank holds them
        spans = [block_span(n, 4, 3) for n in widths]
        rows = [hi - lo for lo, hi in spans]
        first = [lo for lo, _ in spans]
        feats = []
        for (lo, _), b, n in zip(spans, rows, widths):
            x = uniform(b, n).to(torch.bfloat16)
            x[max(0, n - lo):] = 0
            feats.append(x)
    else:
        rows, first = widths, [0] * C
        feats = [uniform(n, n) for n in widths]
    w1s = [uniform(n, DIM, scale=n ** -0.5).requires_grad_(True)
           for n in widths]
    w2s = [uniform(DIM, DIM, scale=DIM ** -0.5).requires_grad_(True)
           for _ in widths]

    def draw(c):
        gc = torch.Generator(device=device).manual_seed(SEED + 300 + c)
        if batched:
            return torch.rand((W, W), device=device, generator=gc)
        return torch.rand((widths[c], widths[c]), device=device,
                          generator=gc)
    return feats, w1s, w2s, rows, first, widths, draw, batched


def time_k8(device, card) -> dict:
    """Phase 9: K8 at the training cells' encode shapes, dim 64, bf16
    compute: hg38 at 1 Mb (23 chromosomes, one (C, W, W) draw) and at 100 kb
    (a draw per chromosome) on f32 tables, and at 10 kb the last rank of
    train_10kb_m4_b96's 1 x 4 model axis (bf16 rows offset by the rank,
    clipped to the draw's last row, the keep packed over several launches
    under KEEP_GROUP_BYTES).  The keep bits against ``pack_bits(keep_plain
    (...))`` bit for bit; the output and gradients against the plain version
    (the eager chain on the same draws: the keep test, the masked products
    and autograd's backward) within TOL_K8_OUT and TOL_K8_GRAD; the keep
    packing, the forward and the backward by CUDA events around their
    wrappers and their device time by the profiler, the plain version by
    events; the bound: the bytes each launch reads and writes at 3.35 TB/s.
    At 10 kb also the peak of the draws and bits held while the keep is
    packed, at KEEP_GROUP_BYTES and one launch a draw."""
    out = {}
    rate = 0.2
    for label in ("1mb", "100kb", "10kb"):
        feats, w1s, w2s, rows, first, widths, draw, batched = k8_case(
            device, label)
        C, W = len(widths), max(widths)
        plan = ne.plan(feats, w1s, w2s, torch.bfloat16,
                       [W] * C if batched else widths, first,
                       label != "10kb")

        def keep_streamed():
            """The step's order: each draw made, handed to Keep, let go."""
            k = ne.Keep(plan, rate)
            if batched:
                k.add(torch.stack([draw(c) for c in range(C)]))
            else:
                for c in range(C):
                    k.add(draw(c))
            return k.finish()
        peak = {}
        for group in (ne.KEEP_GROUP_BYTES, 0):
            real = ne.KEEP_GROUP_BYTES
            ne.KEEP_GROUP_BYTES = group
            try:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated(device)
                torch.cuda.reset_peak_memory_stats(device)
                n0 = ne.keep_cuda.launches
                got_bits = keep_streamed()
                torch.cuda.synchronize()
                peak[group] = (torch.cuda.max_memory_allocated(device)
                               - base, ne.keep_cuda.launches - n0)
            finally:
                ne.KEEP_GROUP_BYTES = real
            if group:
                bits, keep_launches = got_bits, peak[group][1]
            elif not torch.equal(got_bits, bits):
                fail(f"K8 at {label}: the keep bits differ between one "
                     f"launch a draw and KEEP_GROUP_BYTES groups")
        del got_bits
        keeps = []
        for c in range(C):
            kp = ne.keep_plain(draw(c), rows[c], first[c], widths[c], rate)
            f = plan.fields[c]
            o, n = int(f[ne.F_BITS]), int(f[ne.F_ROWS] * f[ne.F_WORDS])
            if not torch.equal(bits[o:o + n],
                               ne.pack_bits(kp).view(-1)):
                fail(f"K8 at {label}: chromosome {c}'s keep bits differ "
                     f"from pack_bits(keep_plain(...))")
            keeps.append(kp)
        draws = [torch.stack([draw(c) for c in range(C)])] if batched \
            else [draw(c) for c in range(C)]
        us = list(draws[0]) if batched else draws

        def keep():
            k = ne.Keep(plan, rate)
            for u in draws:
                k.add(u)
            return k.finish()
        _, t = ne.encode_fwd_cuda(plan, bits, rate, True)
        dh = torch.randn((plan.out_rows, DIM), device=device,
                         generator=torch.Generator(device=device)
                         .manual_seed(SEED + 96)).to(torch.bfloat16)

        def plain():
            ks = [ne.keep_plain(u, r, f0, n, rate)
                  for u, r, f0, n in zip(us, rows, first, widths)]
            h = ne.node_encode_plain(feats, w1s, w2s, torch.bfloat16, ks,
                                     rate, label != "10kb")
            return h, torch.autograd.grad(h, w1s + w2s, dh)
        h = ne.node_encode(plan, feats, bits, rate, w1s, w2s)
        got = torch.autograd.grad(h, w1s + w2s, dh)
        ref = ne.node_encode_plain(feats, w1s, w2s, torch.bfloat16, keeps,
                                   rate, label != "10kb")
        want = torch.autograd.grad(ref, w1s + w2s, dh)
        err = float((h - ref).detach().float().abs().max())
        gerr = max(float((a - b).abs().max()) / float(b.abs().max())
                   for a, b in zip(got, want))
        del keeps, h, got, ref, want
        esize = feats[0].element_size()
        x_bytes = sum(r * n * esize for r, n in zip(rows, widths))
        u_bytes = sum(r * n * 4 for r, n in zip(rows, widths))
        words = plan.n_words * 4
        rows_bytes = plan.t_rows * DIM * 2
        grad_bytes = plan.n_grad * 4
        bound = {"keep": (u_bytes + words) / PEAK_BYTES * 1e3,
                 "fwd": (x_bytes + words + plan.out_rows * DIM * 2
                         + rows_bytes) / PEAK_BYTES * 1e3,
                 "bwd": (x_bytes + words + plan.out_rows * DIM * 2
                         + rows_bytes + grad_bytes) / PEAK_BYTES * 1e3}
        calls = {"keep": keep,
                 "fwd": lambda: ne.encode_fwd_cuda(plan, bits, rate, True),
                 "bwd": lambda: ne.encode_bwd_cuda(plan, bits, rate, dh, t)}
        row = {"chromosomes": C, "nodes": plan.t_rows, "batched": batched,
               "table_dtype": str(feats[0].dtype).replace("torch.", ""),
               "first_rows": first[:3], "x_mbytes": x_bytes / 1e6,
               "draw_rows_mbytes": u_bytes / 1e6, "max_abs_err": err,
               "grad_err_rel_to_max": gerr, "bits_equal": True,
               "keep_launches": keep_launches,
               "keep_group_bytes": ne.KEEP_GROUP_BYTES,
               "keep_peak_gb": peak[ne.KEEP_GROUP_BYTES][0] / 1e9,
               "keep_peak_gb_one_launch_a_draw": peak[0][0] / 1e9,
               "plain_ms": cuda_ms(plain, iters=5),
               "plain_note": "the eager chain's keep test, forward and "
                             "backward on the same draws"}
        for name, fn in calls.items():
            row[f"{name}_ms"] = cuda_ms(fn)
            row[f"{name}_device_ms"] = device_ms_per_call(fn)
            row[f"{name}_bound_ms"] = bound[name]
        row["ms"] = sum(row[f"{n}_ms"] for n in calls)
        row["bound_ms"] = sum(bound.values())
        out[f"K8_{label}"] = row
        print(f"K8 at {label}: {json.dumps(row)}", flush=True)
        if err > TOL_K8_OUT or gerr > TOL_K8_GRAD:
            fail(f"K8 at {label} disagrees with the eager chain: output "
                 f"{err:.3e} (tol {TOL_K8_OUT}), gradients {gerr:.3e} of "
                 f"their largest entries (tol {TOL_K8_GRAD})")
        if label == "10kb" and keep_launches < 2:
            fail(f"K8 at 10 kb packed its keep in {keep_launches} launch: "
                 f"the split under KEEP_GROUP_BYTES went unchecked")
        del feats, w1s, w2s, draws, us, plan, bits, t, dh
        torch.cuda.empty_cache()
    print(json.dumps({"metric": "k8_node_encode", **out, "card": card}),
          flush=True)
    return out


def tail_inputs(device, T, dtype, seed):
    """y and h like the attention output and the static stream, and the
    tail's params at full width (d = 64) with LayerNorms off 1/0."""
    gen = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen) * scale + shift
    y = r(T, DIM).to(device, dtype)
    h = torch.tanh(r(T, DIM)).to(device, dtype)
    ln6 = torch.stack([r(DIM, scale=0.1, shift=s) for s in (1, 0) * 3])
    params = [ln6, r(DIM, DIM, scale=0.125), r(DIM, scale=0.1),
              r(DIM, DIM, scale=0.125), r(DIM, scale=0.1),
              r(DIM, 1, scale=0.3), r(1, scale=0.1)]
    return y, h, [p.to(device) for p in params]


def rel_errs(got, ref) -> list:
    """Each output's max abs error relative to its max |ref|, the scale
    floored at 1e-3 of the largest |ref| of all outputs."""
    top = max(float(r.float().abs().max()) for r in ref)
    return [float((a.float() - b.float()).abs().max())
            / max(float(b.float().abs().max()), 1e-3 * top)
            for a, b in zip(got, ref)]


def check_fused_tail(device) -> dict:
    """Phase 3: K6 forward and backward against the plain versions at the
    step's T = 114,688 and ragged T, f32 and bf16, eval and train mode;
    the bf16 backward's and forward's bits across two calls;
    -> the worst forward abs error and the worst gy abs error in bf16, and
    the worst relative error per dtype."""
    worst = {"fwd_abs_bf16": 0.0, "gy_abs_bf16": 0.0, "float32": 0.0,
             "bfloat16": 0.0}
    for T in (114_688, 1_000, 65, 3):
        for dt in ("float32", "bfloat16"):
            for train in (False, True):
                y, h, p = tail_inputs(device, T, getattr(torch, dt),
                                      SEED + T + len(dt))
                g = torch.randn((T, 1), generator=torch.Generator()
                                .manual_seed(T)).to(device)
                seed = 4242
                out = ft.fused_tail_fwd_cuda(y, h, *p, seed, 0.3, 0.4, train)
                ref = ft.fused_tail_plain(y, h, *p, seed, 0.3, 0.4, train)
                grads = ft.fused_tail_bwd_cuda(y, h, *p, g, seed, 0.3, 0.4,
                                               train)
                refs = ft.fused_tail_bwd_plain(y, h, *p, g, seed, 0.3, 0.4,
                                               train)
                torch.cuda.synchronize()
                errs = rel_errs([out, *grads], [ref, *refs])
                finite = all(bool(torch.isfinite(t).all())
                             for t in (out, *grads))
                ok = finite and max(errs) <= TOL_K6[dt]
                fwd_abs = float((out - ref).abs().max())
                gy_abs = float((grads[0].float() - refs[0].float()).abs()
                               .max())
                print(f"K6 vs plain: T={T} {dt} train={train} fwd max_abs_err"
                      f"={fwd_abs:.3e} gy max_abs_err={gy_abs:.3e} worst "
                      f"rel-to-max {max(errs):.3e} (output "
                      f"{int(np.argmax(errs))}) tol={TOL_K6[dt]} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"K6 disagrees with its plain version at T={T} {dt} "
                         f"train={train}: {errs}")
                worst[dt] = max(worst[dt], max(errs))
                if dt == "bfloat16":
                    worst["fwd_abs_bf16"] = max(worst["fwd_abs_bf16"],
                                                fwd_abs)
                    worst["gy_abs_bf16"] = max(worst["gy_abs_bf16"], gy_abs)
    for T, train in ((4_096, True), (114_688, False)):
        y, h, p = tail_inputs(device, T, torch.bfloat16, SEED + 9)
        g = torch.randn((T, 1), generator=torch.Generator().manual_seed(5)
                        ).to(device)
        a = ft.fused_tail_bwd_cuda(y, h, *p, g, 5, 0.3, 0.4, train)
        b = ft.fused_tail_bwd_cuda(y, h, *p, g, 5, 0.3, 0.4, train)
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            fail(f"K6 backward (tensor-core route) is not deterministic at "
                 f"T={T}")
    print("K6 backward bf16 at T=4096 (train) and T=114688 (eval): two calls "
          "give the same bits ok", flush=True)
    for T in (114_688, 65):
        y, h, p = tail_inputs(device, T, torch.bfloat16, SEED + 10)
        for train in (False, True):
            a = ft.fused_tail_fwd_cuda(y, h, *p, 5, 0.3, 0.4, train)
            if not torch.equal(a, ft.fused_tail_fwd_cuda(y, h, *p, 5, 0.3,
                                                         0.4, train)):
                fail(f"K6 forward (tensor-core route) is not deterministic "
                     f"at T={T} train={train}")
    print("K6 forward bf16 at T=114688 and T=65, eval and train: two calls "
          "give the same bits ok", flush=True)
    return worst


def check_tail_masks(device):
    """Phase 3: the K6 masks over 114,688 x 64 = 7.3M draws: keep shares,
    the same masks for the same seed (in the kernel: the same train-mode
    logits), other masks for seed + 1."""
    m0, m1 = ft.tail_masks(SEED + 77, 114_688, DIM, 0.3, 0.4, True, device)
    k0 = float((m0 > 0).float().mean())
    k1 = float((m1 > 0).float().mean())
    y, h, p = tail_inputs(device, 114_688, torch.bfloat16, SEED + 8)
    a = ft.fused_tail_fwd_cuda(y, h, *p, 77, 0.3, 0.4, True)
    same = torch.equal(a, ft.fused_tail_fwd_cuda(y, h, *p, 77, 0.3, 0.4,
                                                 True))
    other = not torch.equal(a, ft.fused_tail_fwd_cuda(y, h, *p, 78, 0.3,
                                                      0.4, True))
    ok = 0.69 <= k0 <= 0.71 and 0.59 <= k1 <= 0.61 and same and other
    print(f"K6 masks: keep share {k0:.5f} at rate 0.3, {k1:.5f} at rate 0.4 "
          f"over {m0.numel()} draws; same seed same logits {same}; seed + 1 "
          f"other logits {other} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the K6 masks fail their checks")


def hg38_genome():
    return GenomeBins(HG38_NAMES, HG38, 1_000_000)


def write_candidates(path, genome, rng):
    """PER_K candidates of each k, k distinct bins anywhere on the genome,
    written as tab-separated chrom:coord lines, k = 2 first."""
    n = genome.num_nodes
    lines = []
    for k in KS:
        rows = np.empty((0, k), np.int64)
        while len(rows) < PER_K:
            draw = rng.integers(1, n + 1, size=(PER_K, k))
            s = np.sort(draw, axis=1)
            rows = np.concatenate([rows, draw[(np.diff(s, axis=1) > 0)
                                              .all(axis=1)]])
        rows = rows[:PER_K]
        chrom = genome.node2chrom[rows]
        coord = ((rows - genome.chrom_range[chrom, 0]) * genome.resolution
                 + rng.integers(0, genome.resolution, size=rows.shape))
        names = np.asarray(genome.chrom_names)[chrom]
        for nm, co in zip(names, coord):
            lines.append("\t".join(f"{a}:{b}" for a, b in zip(nm, co)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def make_bundle(path, genome, device):
    """Random weights from a seed at full width, bf16 compute, as a bundle
    trained on the accelerator holds them."""
    rng = np.random.default_rng(SEED)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    intra = intra + intra.T
    inter = rng.random((n, n)).astype(np.float32)
    dims = ModelDims(dim=DIM, n_head=N_HEAD, num_chroms=genome.num_chroms,
                     num_nodes=n, compute_dtype="bfloat16",
                     use_pallas_attention=True)
    sizes = [int(e - s) for s, e in genome.chrom_range]
    params = init_model(torch.Generator().manual_seed(SEED), dims, sizes,
                        device=device)
    save_model_bundle(path, params, dims, genome, intra, inter)


def reference_proba(bundle, samples, device):
    """Probabilities of an f32 copy of the bundle on ``device``."""
    params, dims, _, frozen = load_model_bundle(bundle, device)
    return predict_proba(params, frozen, dims._replace(
        compute_dtype="float32"), samples, BATCH)


@contextlib.contextmanager
def predict_stages():
    """Within the block, the stages of ``run_predict_multiway`` calls:
    host-clock seconds of the bundle load (and of the table build inside
    it), the parse, the scoring (it ends in a copy to the host) and the
    write, filled into the yielded dict when the block ends."""
    from matcha_tpu_torch.apps import predict_multiway as pm
    stages = {}
    with timed_calls(pm, "load_model_bundle", "parse_interaction_file",
                     "predict_proba") as st, \
            timed_calls(runtime, "build_frozen_tables") as bf, \
            timed_calls(np, "savetxt") as wr:
        yield stages
    stages.update(load_bundle_s=st["load_model_bundle"],
                  build_frozen_tables_s=bf["build_frozen_tables"],
                  parse_s=st["parse_interaction_file"],
                  score_s=st["predict_proba"], write_s=wr["savetxt"])


def device_kernels(fn):
    """torch.profiler over one call of fn (after a warm call) -> [(kernel
    name, device us, launches)] and the call's wall us."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # user annotations (the optimizer's record_function ranges) span the
    # kernels launched inside them: counting them would count those twice
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)], wall_us


def device_profile(fn) -> dict:
    """torch.profiler over one call of fn (after a warm call): device time
    by kernel, the device's idle share of the call's wall time, and the
    kernel launches."""
    kernels, wall_us = device_kernels(fn)
    busy_us = sum(k[1] for k in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    return {"wall_ms_profiled": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3 if busy_us else "not measured",
            "device_idle_share": (1 - busy_us / wall_us) if busy_us
            else "not measured",
            "device_kernel_launches": sum(k[2] for k in kernels),
            "top_kernels": [{"name": n[:80], "ms": t / 1e3, "count": c}
                            for n, t, c in top]}


def device_ms_per_call(fn, iters=20):
    """Device time per call of fn from torch.profiler over ``iters`` calls:
    its kernels alone, without the host work of its wrapper (which CUDA
    events around a launch-bound call measure instead).  Each kernel's
    mean time times its launches per call (its launches over ``iters``,
    rounded up): late in a long process the profiler drops the first
    records of a trace, and a sum over the trace would read low.  "not
    measured" when the trace holds no kernel."""
    kernels, _ = device_kernels(lambda: [fn() for _ in range(iters)])
    if not any(c for _, _, c in kernels):
        return "not measured"
    return sum(t / c * math.ceil(c / iters)
               for _, t, c in kernels if c) / 1e3


def k3_timing(g, idx, n: int, ids: str) -> dict:
    """K3 on g (T, d) and idx into n rows: CUDA events around the wrapper,
    its device time with each of its kernels' share, its byte bound (each
    input read once, the output written once), its plain version, and two
    yardsticks on the device: index_add_ into a zeroed f32 buffer from a g
    already in f32 and int64 ids (the yardstick recorded since K3's first
    redesign), and the same function from K3's own inputs, the zeroing and
    the casts included."""
    T, d = g.shape
    idx64, g32 = idx.long(), g.float()
    acc = torch.zeros((n, d), device=g.device)

    def full():
        return torch.zeros((n, d), device=g.device).index_add_(
            0, idx.long(), g.float())
    parts = {}
    for _ in range(3):  # late in a long process a trace can come back empty
        kernels, _ = device_kernels(
            lambda: [ts.scatter_add_cuda(g, idx, n) for _ in range(20)])
        for name, t, c in kernels:
            if c:
                key = name.split("::", 1)[-1].split("(")[0].split("<")[0] or name
                parts[key] = parts.get(key, 0.0) + t / c * math.ceil(c / 20) / 1e3
        if parts:
            break
    return {"T": T, "n": n, "d": d, "dtype": str(g.dtype).split(".")[-1],
            "ids": ids,
            "ms": cuda_ms(lambda: ts.scatter_add_cuda(g, idx, n)),
            "device_ms": sum(parts.values()) if parts else "not measured",
            "device_kernels_ms": parts,
            "plain_ms": cuda_ms(lambda: ts.scatter_add_plain(g, idx, n)),
            "library_ms": cuda_ms(lambda: acc.index_add_(0, idx64, g32)),
            "library_device_ms": device_ms_per_call(
                lambda: acc.index_add_(0, idx64, g32)),
            "library": "torch.Tensor.index_add_",
            "library_full_ms": cuda_ms(full),
            "library_full_device_ms": device_ms_per_call(full),
            "library_full": "torch.zeros(n, d).index_add_(0, idx.long(), "
                            "g.float())",
            "bound_ms": (T * d * g.element_size() + T * 4 + n * d * 4)
            / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "k3_route": next((r for k, r in K3_ROUTES.items() if k in parts),
                             "not measured")}


def profile_scoring(params, frozen, dims, samples) -> dict:
    """torch.profiler over one predict_proba call."""
    return device_profile(
        lambda: predict_proba(params, frozen, dims, samples, BATCH))


# ----------------------------------------------------------------- training
_rounds_run = [0]          # the sampler's phase-2 rounds since the zero
_rounds_lock = threading.Lock()


def count_rounds():
    """Count every phase-2 round the sampler runs in this process, in any
    thread, into ``_rounds_run``: wraps ``sampler/negative.py:_rounds``
    (the loop both chains run; on the card each round is one K7 launch),
    once per process."""
    if getattr(tn._rounds, "counted", False):
        return
    real = tn._rounds

    def rounds(*args, **kw):
        for u in real(*args, **kw):
            with _rounds_lock:
                _rounds_run[0] += 1
            yield u
    rounds.counted = True
    tn._rounds = rounds


def launch_counts() -> dict:
    """Each kernel's launches, and ``rounds``: the sampler's phase-2
    rounds, since ``zero_launch_counts``."""
    return {"K1": hyperedge_attention.launches,
            "K2": hyperedge_attention_bwd_cuda.launches,
            "K3": ts.scatter_add.launches, "K4": ts.bincount.launches,
            "K5": tp.propose_phase1.launches,
            "K6_fwd": ft.fused_tail_fwd_cuda.launches,
            "K6_bwd": ft.fused_tail_bwd_cuda.launches,
            "K7": sn.sample_negatives_cuda.launches,
            "K8_fwd": ne.encode_fwd_cuda.launches,
            "K8_bwd": ne.encode_bwd_cuda.launches,
            "K8_keep": ne.keep_cuda.launches,
            "rounds": _rounds_run[0]}


def zero_launch_counts():
    count_rounds()
    hyperedge_attention.launches = 0
    hyperedge_attention_bwd_cuda.launches = 0
    ts.scatter_add.launches = 0
    ts.bincount.launches = 0
    tp.propose_phase1.launches = 0
    ft.fused_tail_fwd_cuda.launches = 0
    ft.fused_tail_bwd_cuda.launches = 0
    sn.sample_negatives_cuda.launches = 0
    ne.encode_fwd_cuda.launches = 0
    ne.encode_bwd_cuda.launches = 0
    ne.keep_cuda.launches = 0
    _rounds_run[0] = 0


def step_counts(fused: bool, pallas: bool, filters: bool = True) -> dict:
    """One training step's launches: K1 and K2 once per k >= 3, K3 and K4
    once, K5 once per k with the "pallas" proposals against filters, K6
    forward and backward once with the fused tail, K7 once per k against
    filters (stage 2) and once more per phase-2 round (``with_rounds``),
    K8's forward, backward and keep once (every feature-dropout draw of a
    step at 1 Mb and 100 kb fits one keep launch)."""
    n_attn = sum(1 for k in TRAIN_KS if k >= 3)
    return {"K1": n_attn, "K2": n_attn, "K3": 1, "K4": 1,
            "K5": len(TRAIN_KS) if pallas and filters else 0,
            "K6_fwd": int(fused), "K6_bwd": int(fused),
            "K7": len(TRAIN_KS) if filters else 0,
            "K8_fwd": 1, "K8_bwd": 1, "K8_keep": 1}


def with_rounds(want: dict, got: dict) -> dict:
    """``want`` (launches before the sampler's phase-2 rounds) plus the
    rounds ``got`` counted, each one more K7 launch."""
    return {**want, "K7": want["K7"] + got["rounds"],
            "rounds": got["rounds"]}


def check_counts(counts: dict, steps: int, what: str, filters: bool = True):
    """Phase 6's path: the unfused tail and the "xla" proposals."""
    want = with_rounds(scaled(step_counts(False, False, filters), steps),
                       counts)
    print(f"{what}: launches {counts} (expected {want})", flush=True)
    if counts != want:
        fail(f"{what} launched {counts}, expected {want}")


def set_fuse_tail(on: bool):
    """Set the fused-tail gate for the next phase.  The gate refuses to
    flip once read, so that one training run never mixes the two tails;
    each phase here builds its own Trainers, so the gate is cleared between
    phases (never inside a run) and set anew."""
    hs._FUSE_TAIL = None
    configure_fuse_tail(on)


def random_buckets(genome, rng, n_edges, ks=TRAIN_KS):
    """n_edges distinct-member hyperedges per k anywhere on the genome with
    quantile-like weights in [0.5, 1.5), as the JAX package's bench draws
    them."""
    n = genome.num_nodes
    out = {}
    for k in ks:
        e = np.sort(rng.choice(np.arange(1, n + 1), (n_edges * 2, k)), axis=1)
        e = e[(np.diff(e, axis=1) > 0).all(axis=1)][:n_edges]
        out[k] = (e.astype(np.int32),
                  rng.random(len(e)).astype(np.float32) + 0.5)
    return out


def train_problem(genome, device):
    """The full-width training configuration: bf16 compute, random contacts
    and weights from the seed, 20,000 hyperedges per k, Bloom filters built
    from the buckets."""
    rng = np.random.default_rng(SEED + 2)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    intra = intra + intra.T
    inter = rng.random((n, n)).astype(np.float32)
    dims = ModelDims(dim=DIM, n_head=N_HEAD, num_chroms=genome.num_chroms,
                     num_nodes=n, compute_dtype="bfloat16",
                     use_pallas_attention=True)
    sizes = [int(e - s) for s, e in genome.chrom_range]
    params = init_model(torch.Generator().manual_seed(SEED), dims, sizes,
                        device=device)
    frozen = build_frozen_tables(genome, intra, inter, device=device)
    buckets = random_buckets(genome, rng, max(4 * TRAIN_BATCH, 20_000))
    blooms = build_bloom_dict({k: v[0] for k, v in buckets.items()},
                              device=device)
    return dims, params, frozen, buckets, blooms, ChromTable.from_genome(
        genome, device=device)


def leaf_names(tree, prefix=""):
    """Dotted paths of the param tree's leaves, in ``_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def deterministic_step(params, frozen, dims, xs, batch, ws, r, device,
                       train_seed=None):
    """Loss and gradients of one step with dropout off on fixed negatives
    and recon chromosome r: the merged (per-k) forward, weighted BCE and
    recon, alpha 1, beta 0.001.  With ``train_seed`` the forward runs in
    train mode with a generator from that seed (the caller turns the
    dropouts off)."""
    p = _tree_map(lambda t: t.detach().to(device).clone().requires_grad_(True),
                  params)
    logits, recon = forward_buckets(
        p, frozen, dims, {k: v.to(device) for k, v in xs.items()},
        generator=(None if train_seed is None
                   else torch.Generator().manual_seed(train_seed)),
        train=train_seed is not None, return_recon=True,
        attention_mode="per-k", recon_chrom=r)
    bce, _ = _bucket_bce_and_preds(
        logits, {k: (e.to(device), w.to(device)) for k, (e, w) in
                 batch.items()}, {k: w.to(device) for k, w in ws.items()})
    loss = bce + 0.001 * recon
    loss.backward()
    grads = [torch.zeros_like(t) if t.grad is None else t.grad
             for t in _leaves(p)]
    return float(loss.detach()), [g.float().cpu() for g in grads]


def cpu_frozen(fz):
    return fz._replace(features=tuple(f.cpu() for f in fz.features),
                       attr_table=fz.attr_table.cpu(),
                       inter_z=fz.inter_z.cpu(),
                       chrom_of_node=fz.chrom_of_node.cpu(),
                       chrom_bounds=fz.chrom_bounds.cpu())


def identity_dropout(x, *args, **kwargs):
    return x


def check_deterministic_step(trainer, buckets, device, ks=TRAIN_KS,
                             train_seed=None,
                             what="deterministic step") -> dict:
    """The same step (dropout off, negatives sampled once on the card, the
    same r) as f32 on the card, f32 on the CPU (the plain path) and, for a
    bf16 Trainer, bf16 on the card.  With ``train_seed`` (the
    per-occurrence mode, which draws its feature dropout only in train
    mode) the step runs in train mode with the feature dropout at rate 0
    and the attention and feed-forward dropouts the identity, f32 only."""
    gen = torch.Generator().manual_seed(SEED + 4)
    batch, xs, ws = {}, {}, {}
    for k in ks:
        e, w = buckets[k]
        pos = torch.from_numpy(e[:CHECK_BATCH]).to(device)
        neg = sample_negatives(gen, pos, trainer.chrom_table, 0,
                               trainer.blooms[k], neg_num=3)
        batch[k] = (pos.cpu(), torch.from_numpy(w[:CHECK_BATCH]))
        xs[k] = torch.cat([pos, neg]).cpu()
        ws[k] = batch[k][1]
    fz = trainer.frozen
    f32 = trainer.dims._replace(compute_dtype="float32")
    if train_seed is not None:
        f32 = f32._replace(feature_dropout=0.0)
    r = min(5, trainer.dims.num_chroms - 1)
    with unittest.mock.patch.object(
            modules, "dropout",
            identity_dropout if train_seed is not None else modules.dropout):
        loss_cpu, g_cpu = deterministic_step(trainer.params, cpu_frozen(fz),
                                             f32, xs, batch, ws, r, "cpu",
                                             train_seed)
        loss_f32, g_f32 = deterministic_step(trainer.params, fz, f32, xs,
                                             batch, ws, r, device, train_seed)
    out = {"loss_cpu_f32": loss_cpu, "loss_card_f32": loss_f32,
           "loss_rel_err_f32": abs(loss_f32 - loss_cpu) / abs(loss_cpu),
           "positives_per_k": CHECK_BATCH, "recon_chrom": r}
    if trainer.dims.compute_dtype == "bfloat16" and train_seed is None:
        loss_bf16, _ = deterministic_step(trainer.params, fz, trainer.dims,
                                          xs, batch, ws, r, device)
        out["loss_card_bf16"] = loss_bf16
        out["loss_rel_err_bf16"] = abs(loss_bf16 - loss_cpu) / abs(loss_cpu)
    # each gradient's error relative to its largest entry, floored at 1e-3
    # of the largest entry of any gradient: some gradients are zero but for
    # rounding (the key LayerNorm's bias moves every key of an edge by one
    # vector, which adds a constant to each score row that the softmax
    # removes), and an error relative to their rounding noise means nothing
    top = max(float(b.abs().max()) for b in g_cpu)
    errs = {name: float((a - b).abs().max())
            / max(float(b.abs().max()), 1e-3 * top)
            for name, a, b in zip(leaf_names(trainer.params), g_f32, g_cpu)}
    worst = sorted(errs, key=errs.get, reverse=True)[:3]
    out["grad_rel_to_max_err_f32"] = errs[worst[0]]
    out["grad_worst_leaves"] = {n: errs[n] for n in worst}
    out["grad_floor"] = 1e-3 * top
    print(f"{what} vs f32 on the CPU: {json.dumps(out)} "
          f"(tol loss f32 {TOL_STEP_LOSS_F32}, grads f32 "
          f"{TOL_STEP_GRAD_F32}, loss bf16 {TOL_STEP_LOSS_BF16})",
          flush=True)
    if (out["loss_rel_err_f32"] > TOL_STEP_LOSS_F32
            or out["grad_rel_to_max_err_f32"] > TOL_STEP_GRAD_F32
            or out.get("loss_rel_err_bf16", 0.0) > TOL_STEP_LOSS_BF16):
        fail(f"the {what} on the card disagrees with the CPU")
    return out


def train_step_split(trainer, batch) -> dict:
    """Host-clock ms of each part of one stage-2 step (the calls
    ``Trainer.train_step`` makes, "merged" stream), synchronised after
    each; median of 5."""
    splits = []
    for _ in range(5):
        split, t0 = {}, time.perf_counter()

        def lap(name):
            nonlocal t0
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            split[name] = (t1 - t0) * 1e3
            t0 = t1

        g_tab, g_loss = split_generator(trainer.generator, 2)
        trainer.optimizer.zero_grad(set_to_none=False)
        table = encode_node_table(trainer.params, trainer.frozen, trainer.dims,
                                  generator=g_tab, train=True)
        lap("encode_ms")
        g_neg, g_fwd = split_generator(g_loss, 2)
        xs, ws, _ = _sample_all_negatives(trainer.chrom_table, trainer.blooms,
                                          trainer.settings, batch, g_neg)
        lap("negatives_ms")
        logits, recon = forward_buckets(
            trainer.params, trainer.frozen, trainer.dims, xs,
            generator=g_fwd, train=True, return_recon=True, node_table=table,
            attention_mode="per-k")
        bce, _ = _bucket_bce_and_preds(logits, batch, ws)
        loss = trainer.settings.alpha * bce + trainer.settings.beta * recon
        lap("forward_loss_ms")
        loss.backward()
        lap("backward_ms")
        trainer.optimizer.step()
        lap("adamw_ms")
        splits.append(split)
    return {k: statistics.median(s[k] for s in splits) for k in splits[0]}


def host_syncs(fn) -> int:
    """Host synchronisations with the card in one call of fn, counted by
    PyTorch's sync debug mode (a blocking copy from pageable memory, a
    tensor read on the host, ...)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def train_phase(genome, device, card) -> dict:
    """Phases 6 and 7: the training step at full width; -> the main path's
    launch counts and the step metrics."""
    t0 = time.perf_counter()
    dims, params, frozen, buckets, blooms, table = train_problem(genome,
                                                                 device)
    setup_s = time.perf_counter() - t0

    # stage 1: one step, no filters, alpha 0 / beta 1
    s1 = Trainer(params, frozen, dims, table,
                 TrainSettings(alpha=0.0, beta=1.0, token_stream="merged"),
                 seed=SEED)
    b1 = BucketedBatcher(buckets, TRAIN_BATCH, 1, seed=SEED)
    if not s1.pin_base_buckets(b1):
        fail("the stage-1 buckets do not fit the pin budget")
    zero_launch_counts()
    r1 = s1.train_epoch_indexed(b1)
    check_counts(launch_counts(), 1, "stage-1 step", filters=False)
    print(f"stage-1 step: {json.dumps(r1)}", flush=True)

    # stage 2: warm-up epoch, then the timed epoch (the main path's run)
    trainer = Trainer(s1.params, frozen, dims, table,
                      TrainSettings(alpha=1.0, beta=0.001, neg_num=3,
                                    max_trials=8, token_stream="merged"),
                      blooms=blooms, seed=SEED + 1)
    b2 = BucketedBatcher(buckets, TRAIN_BATCH, TRAIN_STEPS, seed=SEED)
    if not trainer.pin_base_buckets(b2):
        fail("the stage-2 buckets do not fit the pin budget")
    t0 = time.perf_counter()
    warm = trainer.train_epoch_indexed(b2)
    warm_s = time.perf_counter() - t0
    before = [t.detach().clone() for t in _leaves(trainer.params)]
    zero_launch_counts()
    timed = trainer.train_epoch_indexed(b2)
    counts = launch_counts()
    check_counts(counts, TRAIN_STEPS, f"timed epoch of {TRAIN_STEPS} steps")
    # the step units' own count of the rounds, and the epoch's K7 launches
    epoch = trainer.last_epoch
    unit_rounds = sum(u.counts.get("rounds", 0)
                      for u in telemetry.units("step") if u.parent == epoch.id)
    if unit_rounds != counts["rounds"] or \
            epoch.counts.get("launches.K7") != counts["K7"]:
        fail(f"the timed epoch's step units count {unit_rounds} rounds and "
             f"{epoch.counts.get('launches.K7')} K7 launches, the sampler "
             f"ran {counts['rounds']} rounds and K7 {counts['K7']} launches")
    for name, res in (("stage-1", r1), ("warm-up", warm), ("timed", timed)):
        if not (np.isfinite(res["bce"]) and np.isfinite(res["recon"])):
            fail(f"{name} epoch losses are not finite: {res}")
    moved = sum(not torch.equal(a, b)
                for a, b in zip(before, _leaves(trainer.params)))
    if moved != len(before):
        fail(f"only {moved} of {len(before)} parameters changed")
    print(f"stage-2 epochs: warm-up {json.dumps(warm)}; timed "
          f"{json.dumps(timed)}; {moved} of {len(before)} params changed",
          flush=True)

    step_check = check_deterministic_step(trainer, buckets, device)

    # per-step host-clock times, each step synchronised
    idx = np.random.default_rng(SEED + 5).permutation(
        len(buckets[2][0]))[:TRAIN_BATCH]
    batch = {k: (e[torch.as_tensor(idx, device=e.device)],
                 w[torch.as_tensor(idx, device=e.device)])
             for k, (e, w) in trainer._pinned.items()}
    steps = []
    for _ in range(10):
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    split = train_step_split(trainer, batch)
    syncs = host_syncs(lambda: trainer.train_step(batch))
    torch.cuda.reset_peak_memory_stats()
    trace = device_profile(lambda: trainer.train_step(batch))
    peak = torch.cuda.max_memory_allocated()
    per_step = len(TRAIN_KS) * TRAIN_BATCH * 4
    metrics = {
        "metric": "train_step_hyperedges_per_s",
        "value": timed["hyperedges_per_sec"],
        "epoch_s": timed["elapsed"], "steps": TRAIN_STEPS,
        "hyperedges_per_step": per_step,
        "median_step_ms_synced": statistics.median(steps) * 1e3,
        "step_ms_synced": [t * 1e3 for t in steps],
        "step_split_ms_synced": split, "host_syncs_per_step": syncs,
        "warmup_epoch_s": warm_s, "setup_s": setup_s,
        "peak_memory_gb": peak / 1e9,
        "fallback_bloom_rate": timed["fallback_bloom_rate"],
        "fallback_orig_rate": timed["fallback_orig_rate"],
        "card": card}
    print(json.dumps(metrics), flush=True)
    print(json.dumps({"metric": "train_step_profile", **trace,
                      "card": card}), flush=True)
    return {"counts": counts, "step_check": step_check,
            "problem": (dims, params, frozen, buckets, blooms, table)}


def time_training_kernels(device, card) -> dict:
    """K1, K2, K3 and K4 at the training step's shapes: CUDA events around
    the wrapper and the kernels' device time from torch.profiler, beside
    their bounds from these shapes, their plain versions and, for K3 and
    K4, the one PyTorch call that computes the same function (by events and
    on the device); K1's and K2's achieved TFLOP/s from their device time;
    K3 and K4 also on skewed ids (Zipf, a hub row holding half of T)."""
    out = time_attention_kernels(device)
    out.update(time_table_kernels(device, 4 * TRAIN_BATCH * sum(TRAIN_KS),
                                  3_068, ("uniform", "zipf", "hub")))
    print(json.dumps({"metric": "training_kernels", **out, "card": card}),
          flush=True)
    return out


def time_attention_kernels(device) -> dict:
    """K1 and K2 at the training step's shapes (8,192 edges per k, L = 3,
    4, 5, bf16): CUDA events around the wrapper and the device time from
    torch.profiler, beside their bounds, their plain versions and their
    achieved TFLOP/s.  -> {"K1_L<L>", "K2_L<L>"}."""
    out = {}
    E, dt = 4 * TRAIN_BATCH, "bfloat16"
    for L in (3, 4, 5):
        x, args = attention_inputs(device, E, L, dt)
        g = torch.randn(x.shape, device=device).to(x.dtype)

        def k2():
            return hyperedge_attention_bwd_cuda(x, *args, g, N_HEAD, True)

        def k1():
            return hyperedge_attention_cuda(x, *args, N_HEAD, True)
        flops, nbytes = attention_bwd_work(E, L, dt)
        b_ms, b_by = bound_ms(flops, nbytes, dt)
        dev_ms = device_ms_per_call(k2)
        out[f"K2_L{L}"] = {
            "E": E, "L": L, "dtype": dt, "ms": cuda_ms(k2),
            "device_ms": dev_ms,
            "plain_ms": cuda_ms(lambda: hyperedge_attention_bwd_plain(
                x, *args, g, N_HEAD, True)),
            "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
            "tflops_achieved": flops / (dev_ms * 1e-3) / 1e12
            if isinstance(dev_ms, float) else "not measured"}
        f1, n1 = attention_work(E, L, dt)
        b1, by1 = bound_ms(f1, n1, dt)
        dev1 = device_ms_per_call(k1)
        out[f"K1_L{L}"] = {
            "E": E, "L": L, "dtype": dt, "ms": cuda_ms(k1),
            "device_ms": dev1,
            "plain_ms": cuda_ms(lambda: hyperedge_attention_plain(
                x, *args, N_HEAD, True)),
            "bound_ms": b1, "bound_by": by1, "gflop": f1 / 1e9,
            "tflops_achieved": f1 / (dev1 * 1e-3) / 1e12
            if isinstance(dev1, float) else "not measured"}
    return out


def time_table_kernels(device, T: int, n: int, kinds) -> dict:
    """K3 on a bf16 (T, 64) cotangent and K4 on the same ids into n rows:
    CUDA events around the wrapper and the kernels' device time from
    torch.profiler, beside their byte bounds (each input read once, each
    output written once), their plain versions and the one PyTorch call
    that computes the same function (index_add_, torch.bincount; events and
    device time; for K3 also from its own inputs, k3_timing).  -> {"K3",
    "K4", "K3_<kind>", "K4_<kind>"} for the uniform and the skewed
    ``kinds`` of ids."""
    out = {}
    gen = torch.Generator().manual_seed(SEED + 6)
    g = torch.randn((T, DIM), generator=gen).to(device, torch.bfloat16)
    for kind in kinds:
        idx = torch.from_numpy(skewed_ids(
            kind, np.random.default_rng(SEED + 6), T, n)).to(device)
        idx64 = idx.long()
        name = "K3" if kind == "uniform" else f"K3_{kind}"
        out[name] = k3_timing(g, idx, n, kind)
        k4 = "K4" if kind == "uniform" else f"K4_{kind}"
        out[k4] = {
            "T": T, "n": n, "ids": kind,
            "ms": cuda_ms(lambda: ts.bincount_cuda(idx, n)),
            "device_ms": device_ms_per_call(
                lambda: ts.bincount_cuda(idx, n)),
            "plain_ms": cuda_ms(lambda: ts.bincount_plain(idx, n)),
            "library_ms": cuda_ms(lambda: torch.bincount(idx64,
                                                         minlength=n)),
            "library_device_ms": device_ms_per_call(
                lambda: torch.bincount(idx64, minlength=n)),
            "library": "torch.bincount",
            "bound_ms": (T * 4 + n * 4) / PEAK_BYTES * 1e3,
            "bound_by": "bytes"}
    return out


def scaled(counts: dict, n: int) -> dict:
    return {k: v * n for k, v in counts.items()}


def added(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def eval_counts(pallas: bool, filters: bool = True) -> dict:
    """One eval batch's launches: K1 once (the padded forward, L = 5), K4
    once (the recon loss's counts), K5 once per k with the "pallas"
    proposals against filters, K7 once per k against filters (and once
    more per phase-2 round: ``with_rounds``).  An eval encodes the node
    table once for all its batches (``with_encodes``)."""
    return {"K1": 1, "K2": 0, "K3": 0, "K4": 1,
            "K5": len(TRAIN_KS) if pallas and filters else 0, "K6_fwd": 0,
            "K6_bwd": 0, "K7": len(TRAIN_KS) if filters else 0,
            "K8_fwd": 0, "K8_bwd": 0, "K8_keep": 0}


def with_encodes(want: dict, n: int) -> dict:
    """``want`` plus n eval-mode encodes of the node table (an eval, an
    embeddings export, a scoring request): one K8 forward each."""
    return {**want, "K8_fwd": want["K8_fwd"] + n}


def counts_match(got: dict, want: dict) -> bool:
    """``got`` is ``want`` plus one K7 launch per phase-2 round it ran."""
    return got == with_rounds(want, got)


def same(a: dict, b: dict, keys=("bce", "recon")) -> float:
    """Largest relative difference of two epoch results' losses."""
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in keys)


def recorded_fit(trainer, buckets, test, tmp, log, **fit_kw) -> dict:
    """One stage-2 Trainer.fit of FIT_EPOCHS epochs with the best-AUPRC
    checkpoint, a resume snapshot per epoch, the embedding export and a
    profile of epoch 1.  Records the kind of every checkpoint / snapshot
    pickle and every embeddings file written, the launch counts and the
    host clock at the start of each epoch's training dispatch and at the
    end of the fit (so an epoch's window holds its training and its eval),
    and the host wall of each ``eval_epoch``.  The counts are zeroed just
    before the fit."""
    writes, embs, marks, eval_walls = [], [], [], []
    launch = trainer.train_epoch_indexed_launch

    def marked_launch(batcher):
        marks.append((time.perf_counter(), launch_counts()))
        return launch(batcher)
    trainer.train_epoch_indexed_launch = marked_launch
    ev = trainer.eval_epoch

    def timed_eval(*args, **kw):
        t = time.perf_counter()
        res = ev(*args, **kw)
        eval_walls.append(time.perf_counter() - t)
        return res
    trainer.eval_epoch = timed_eval
    write_real, save_real = runtime._write_checkpoint, np.save

    def write(path, *args):
        write_real(path, *args)
        writes.append(os.path.basename(path).split("_")[0])

    def save(path, arr, *args, **kw):
        embs.append(np.array(arr))
        save_real(path, arr, *args, **kw)
    prof = os.path.join(tmp, "profile")
    with unittest.mock.patch.object(runtime, "_write_checkpoint", write), \
            unittest.mock.patch.object(np, "save", save):
        zero_launch_counts()
        t0 = time.perf_counter()
        hist = trainer.fit(
            buckets, test, epochs=FIT_EPOCHS, log=log,
            checkpoint_path=os.path.join(tmp, "ckpt_fit.chkpt"),
            resume_path=os.path.join(tmp, "resume_fit.snap"),
            embeddings_path=os.path.join(tmp, "emb_fit.npy"),
            profile_dir=prof, **fit_kw)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        counts = launch_counts()
    traces = [os.path.join(prof, f) for f in os.listdir(prof)
              if f.endswith(".pt.trace.json")] if os.path.isdir(prof) else []
    ends = marks[1:] + [(t_end, counts)]
    return {"hist": hist, "writes": writes, "embs": embs,
            "epoch_counts": [{k: c1[k] - c0[k] for k in c0} for
                             (_, c0), (_, c1) in zip(marks, ends)],
            "epoch_wall_s": [t1 - t0_ for (t0_, _), (t1, _) in
                             zip(marks, ends)],
            "eval_wall_s": eval_walls, "fit_s": t_end - t0,
            "counts": counts,
            "trace_bytes": [os.path.getsize(f) for f in traces]}


def fit_phase(problem, genome, card) -> dict:
    """Phase 8: Trainer.fit at full width on the opt-in kernels' path, the
    fused tail and the "pallas" proposals: stage 1, then stage 2 with eval,
    checkpoints, resume snapshots, the embedding export and a profile of
    epoch 1; each epoch's launches and walls; the best checkpoint's reload;
    and a resume from the epoch-1 snapshot.  -> stage 2's launch counts and
    the results."""
    set_fuse_tail(True)
    dims, params, frozen, buckets, blooms, table = problem
    test = random_buckets(genome, np.random.default_rng(SEED + 12),
                          TEST_PER_K)
    common = dict(neg_num=3, max_trials=8, token_stream="merged",
                  propose_impl="pallas")
    fit_kw = dict(batch_size=TRAIN_BATCH, num_batch_per_iter=TRAIN_STEPS,
                  seed=SEED)
    n_eval = EVAL_SAMPLES // TRAIN_BATCH

    def log(msg):
        print(msg, flush=True)

    # stage 1: alpha 0 / beta 1, no filters
    s1 = Trainer(params, frozen, dims, table,
                 TrainSettings(alpha=0.0, beta=1.0, **common), seed=SEED)
    zero_launch_counts()
    t0 = time.perf_counter()
    h1 = s1.fit(buckets, test, epochs=1, log=log, **fit_kw)
    stage1_s = time.perf_counter() - t0
    got1 = launch_counts()
    want1 = with_rounds(with_encodes(added(
        scaled(step_counts(True, False, False), TRAIN_STEPS),
        scaled(eval_counts(False, False), n_eval)), 1), got1)
    print(f"fit stage 1: launches {got1} (expected {want1})", flush=True)
    if got1 != want1:
        fail(f"fit stage 1 launched {got1}, expected {want1}")
    p1 = _tree_map(lambda t: t.detach().clone(), s1.params)

    # stage 2 from the stage-1 params
    tmp = tempfile.mkdtemp()
    s2 = TrainSettings(alpha=1.0, beta=0.001, **common)
    want_epoch = added(scaled(step_counts(True, True), TRAIN_STEPS),
                       scaled(eval_counts(True), n_eval))
    trainer = Trainer(p1, frozen, dims, table, s2, blooms=blooms,
                      seed=SEED + 1)
    run = recorded_fit(trainer, buckets, test, tmp, log, **fit_kw)
    for i, got in enumerate(run["epoch_counts"]):
        # the eval's encode, and the next epoch's embeddings export (made
        # before its training launch, so in this epoch's window)
        want = with_rounds(with_encodes(want_epoch,
                                        1 + (i < FIT_EPOCHS - 1)), got)
        print(f"fit stage 2 epoch {i}: launches {got} (expected {want})",
              flush=True)
        if got != want:
            fail(f"fit stage-2 epoch {i} launched {got}, expected {want}")
    hist = run["hist"]
    if len(hist) != FIT_EPOCHS or len(run["epoch_counts"]) != FIT_EPOCHS:
        fail(f"fit ran {len(hist)} epochs, expected {FIT_EPOCHS}")
    if len(run["trace_bytes"]) != 1 or not run["trace_bytes"][0]:
        fail(f"fit profile_dir holds traces of {run['trace_bytes']} bytes, "
             f"expected one non-empty")
    for i, h in enumerate(h1 + hist):
        vals = [h[p][k] for p in ("train", "valid") for k in ("bce",
                                                              "recon")]
        if not np.isfinite(vals).all():
            fail(f"fit epoch results are not finite: {vals}")
        if set(h["valid"]["metrics"]) != {"all", *TRAIN_KS}:
            fail(f"fit valid metrics miss a size: {h['valid']['metrics']}")
    n_snaps = run["writes"].count("resume")
    print(f"fit: {len(run['writes'])} pickles, {n_snaps} resume snapshots, "
          f"{len(run['embs'])} embeddings files", flush=True)
    if n_snaps != FIT_EPOCHS or len(run["embs"]) != FIT_EPOCHS:
        fail(f"fit wrote {n_snaps} resume snapshots and "
             f"{len(run['embs'])} embeddings files, expected {FIT_EPOCHS}")
    best = load_checkpoint(os.path.join(tmp, "ckpt_fit.chkpt"), full=True,
                           device=_leaves(trainer.params)[0].device)
    if not all(torch.equal(a, b) for a, b in zip(
            _leaves(best["params"]), _leaves(trainer.params))):
        fail("the params after fit are not the best checkpoint's")
    emb_shape = run["embs"][-1].shape
    if emb_shape != (genome.num_nodes, DIM):
        fail(f"embeddings of shape {emb_shape}")

    # resume: a fresh Trainer from the same stage-1 params runs epochs 0-1
    # with snapshots, another resumes from the epoch-1 snapshot
    snap = os.path.join(tmp, "resume_b.snap")
    quiet = lambda msg: None                                   # noqa: E731
    hb = Trainer(p1, frozen, dims, table, s2, blooms=blooms,
                 seed=SEED + 1).fit(buckets, test, epochs=2, log=quiet,
                                    resume_path=snap, **fit_kw)
    hc = Trainer(p1, frozen, dims, table, s2, blooms=blooms,
                 seed=SEED + 1).fit(buckets, test, epochs=FIT_EPOCHS,
                                    log=quiet, resume_path=snap, resume=True,
                                    **fit_kw)
    diffs = {"epochs_0_1_rerun": max(same(a[p], b[p]) for a, b in
                                     zip(hist[:2], hb)
                                     for p in ("train", "valid")),
             "epoch_2_resumed": max(same(hist[2][p], hc[0][p])
                                    for p in ("train", "valid"))}
    shutil.rmtree(tmp)
    print(f"fit resume: {len(hc)} epoch run after the epoch-1 snapshot; "
          f"largest relative loss difference {json.dumps(diffs)} (tol "
          f"{TOL_RESUME})", flush=True)
    if len(hc) != 1 or max(diffs.values()) > TOL_RESUME:
        fail("the resumed epoch 2 differs from the uninterrupted one")

    result = {
        "metric": "fit_stage2", "epochs": FIT_EPOCHS,
        "steps_per_epoch": TRAIN_STEPS, "eval_batches": n_eval,
        "stage1_s": stage1_s, "fit_s": run["fit_s"],
        "epoch_wall_s": run["epoch_wall_s"],
        "train_elapsed_s": [h["train"]["elapsed"] for h in hist],
        "eval_wall_s": run["eval_wall_s"],
        "profile_trace_bytes": run["trace_bytes"],
        "train_hyperedges_per_s": [h["train"]["hyperedges_per_sec"]
                                   for h in hist],
        "fallback_bloom_rate": [h["train"]["fallback_bloom_rate"]
                                for h in hist],
        "fallback_orig_rate": [h["train"]["fallback_orig_rate"]
                               for h in hist],
        "valid": [{str(k): {m: v[m] for m in ("auroc", "auprc")}
                   for k, v in h["valid"]["metrics"].items()} for h in hist],
        "train": [{str(k): {m: v[m] for m in ("auroc", "auprc")}
                   for k, v in h["train"]["metrics"].items()} for h in hist],
        "best_epoch": best["epoch"], "resume": diffs, "card": card}
    print(json.dumps(result), flush=True)
    return {"counts": run["counts"], "result": result}


def k5_bytes(args, S: int, md: int) -> int:
    """Bytes K5 needs for this run's data: change whole, orig at the
    unchanged members, lo and hi at the changed members, u at the changed
    members for the rounds up to each row's S-th valid candidate (no round
    after it can change the result), probe and has written once."""
    orig, change, lo, hi, u = args
    n, k = orig.shape
    T = u.shape[0]
    need = torch.full((n,), T, device=orig.device)
    for t in range(T, S - 1, -1):        # the smallest t that finds S wins
        _, has = tp.propose_phase1_plain(orig, change, lo, hi, u[:t],
                                         min_distance=md, max_probes=S)
        need = torch.where(has[S - 1], torch.full_like(need, t), need)
    n_changed = change.sum(dim=1)
    n_changed_all = int(n_changed.sum())
    return (4 * (k * n - n_changed_all) + k * n + 4 * 2 * n_changed_all
            + 4 * int((n_changed * need).sum()) + S * k * n * 4 + S * n)


def k5_in_sampler(device) -> dict:
    """K5 as the fit's sampler calls it: one stage-2 step's sampler calls
    ("pallas", 2,048 positives per k = 2..5, neg_num 3, 8 rounds, 4 / 2
    probes) record the arguments they hand ``ops.propose.propose_phase1``;
    then that dispatcher is timed by CUDA events on those very arguments,
    so whatever the dispatcher does to the sampler's arrays (views,
    conversions, copies) is in the time; then one profiled pass over the
    four calls counts their device operations.  -> ms per k and per step,
    device operations and busy ms per step."""
    table, bounds, pos, blooms = sampler_problem(hg38_genome(), device,
                                                 SEED + 41)
    real = tp.propose_phase1
    calls = []

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)
    record.launches = real.launches
    tp.propose_phase1 = record
    try:
        for k in TRAIN_KS:
            sample_negatives(torch.Generator().manual_seed(SEED + k), pos[k],
                             table, 0, blooms[k], max_trials=8,
                             max_probes=4 if k == 2 else 2,
                             chrom_bounds=bounds, propose_impl="pallas")
    finally:
        tp.propose_phase1 = real
    if len(calls) != len(TRAIN_KS):
        fail(f"the sampler made {len(calls)} phase-1 calls, expected "
             f"{len(TRAIN_KS)}")
    ms = {f"k{k}": cuda_ms(lambda a=a, kw=kw: real(*a, **kw))
          for k, (a, kw) in zip(TRAIN_KS, calls)}
    prof = device_profile(lambda: [real(*a, **kw) for a, kw in calls])
    return {"ms": ms, "step_ms": sum(ms.values()),
            "device_ops_per_step": prof["device_kernel_launches"],
            "device_busy_ms_per_step": prof["device_busy_ms"],
            "arg_layouts": [[list(t.shape) for t in a] for a, _ in calls]}


def unfused_tail(y, h, params, gens, train=True):
    """The eager tail forward_buckets runs with the fused tail off: the
    attention output's dropout, pff_n1, the LayerNorms, (dyn - static)^2
    and the classifier."""
    ln6, w1, b1, w2, b2, wc, bc = params
    pn = {"layers": [{"w": w1, "b": b1}, {"w": w2, "b": b2}],
          "ln": {"g": ln6[0], "b": ln6[1]}}
    g_a, g_p = gens
    dyn = pff(pn, dropout(y, 0.3, train, g_a), residual=True, generator=g_p,
              drop_rate=0.4, train=train)
    out = (layer_norm({"g": ln6[2], "b": ln6[3]}, dyn)
           - layer_norm({"g": ln6[4], "b": ln6[5]}, h)) ** 2
    return pff({"layers": [{"w": wc, "b": bc}]}, out).to(torch.float32)


def time_new_kernels(device, card) -> dict:
    """Phase 9: K5 per k and K6 forward / backward by CUDA events at the
    main-path shapes, beside their bounds from this run's inputs and their
    plain versions; the unfused eager tail beside K6 as a finding."""
    out = {}
    for k in TRAIN_KS:
        n, S = TRAIN_BATCH * 3, 4 if k == 2 else 2
        args = propose_inputs(device, k, n, seed=SEED + 50 + k)
        nbytes = k5_bytes(args, S, 0)

        def k5():
            return tp.propose_phase1_cuda(*args, min_distance=0,
                                          max_probes=S)
        out[f"K5_k{k}"] = {
            "k": k, "n": n, "T": 8, "S": S, "ms": cuda_ms(k5),
            "device_ms": device_ms_per_call(k5),
            "plain_ms": cuda_ms(lambda: tp.propose_phase1_plain(
                *args, min_distance=0, max_probes=S), iters=5),
            "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "mbytes": nbytes / 1e6}
    out["K5_in_sampler"] = k5_in_sampler(device)
    T, d = 4 * TRAIN_BATCH * sum(TRAIN_KS), DIM
    y, h, p = tail_inputs(device, T, torch.bfloat16, SEED + 60)
    g = torch.randn((T, 1), device=device)
    param_bytes = 4 * (6 * d + 2 * d * d + 3 * d + 1)
    fwd_bytes = 2 * T * d * 2 + T * 4 + param_bytes
    bwd_bytes = 4 * T * d * 2 + T * 4 + 2 * param_bytes
    for name, fn, plain, nbytes, flops in (
            ("K6_fwd",
             lambda: ft.fused_tail_fwd_cuda(y, h, *p, 99, 0.3, 0.4, True),
             lambda: ft.fused_tail_plain(y, h, *p, 99, 0.3, 0.4, True),
             fwd_bytes, 4 * T * d * d),
            ("K6_fwd_eval",
             lambda: ft.fused_tail_fwd_cuda(y, h, *p, 99, 0.3, 0.4, False),
             lambda: ft.fused_tail_plain(y, h, *p, 99, 0.3, 0.4, False),
             fwd_bytes, 4 * T * d * d),
            ("K6_bwd",
             lambda: ft.fused_tail_bwd_cuda(y, h, *p, g, 99, 0.3, 0.4, True),
             lambda: ft.fused_tail_bwd_plain(y, h, *p, g, 99, 0.3, 0.4,
                                             True),
             bwd_bytes, 12 * T * d * d)):
        b_ms, b_by = bound_ms(flops, nbytes, "bfloat16")
        dev = device_ms_per_call(fn)
        out[name] = {"T": T, "d": d, "dtype": "bfloat16",
                     "train": not name.endswith("eval"),
                     "ms": cuda_ms(fn), "device_ms": dev,
                     "plain_ms": cuda_ms(plain, iters=5),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "mbytes": nbytes / 1e6, "gflop": flops / 1e9,
                     "tflops_achieved": flops / (dev * 1e-3) / 1e12
                     if isinstance(dev, float) else "not measured"}
    yg, hg = (t.clone().requires_grad_(True) for t in (y, h))
    pg = [t.clone().requires_grad_(True) for t in p]
    gen = torch.Generator().manual_seed(SEED)

    def unfused_step():
        unfused_tail(yg, hg, pg, split_generator(gen, 2)).backward(g)

    def fused_step():
        ft.fused_tail(yg, hg, *pg, 99, 0.3, 0.4, True).backward(g)
    out["tail_finding"] = {
        "T": T, "unfused_fwd_ms": cuda_ms(lambda: unfused_tail(
            y, h, p, split_generator(gen, 2)), iters=10),
        "unfused_fwd_bwd_ms": cuda_ms(unfused_step, iters=10),
        "fused_fwd_bwd_ms": cuda_ms(fused_step, iters=10)}
    print(json.dumps({"metric": "new_kernels", **out, "card": card}),
          flush=True)
    return out


def step_ab(problem, card) -> dict:
    """Phase 9: the stage-2 step (synchronised, host clock) with the fused
    tail on / off and the proposals "pallas" / "xla", in turns (ABCD DCBA),
    medians of 12 steps each."""
    dims, params, frozen, buckets, blooms, table = problem
    trainer = Trainer(params, frozen, dims, table,
                      TrainSettings(alpha=1.0, beta=0.001, neg_num=3,
                                    max_trials=8, token_stream="merged"),
                      blooms=blooms, seed=SEED + 3)
    dev = _leaves(trainer.params)[0].device
    idx = torch.as_tensor(np.random.default_rng(SEED + 7).permutation(
        len(buckets[2][0]))[:TRAIN_BATCH], device=dev)
    batch = {k: (torch.as_tensor(e, device=dev)[idx],
                 torch.as_tensor(w, device=dev)[idx])
             for k, (e, w) in buckets.items()}
    combos = [(True, "pallas"), (False, "pallas"), (True, "xla"),
              (False, "xla")]
    times = {c: [] for c in combos}
    for order in (combos, combos[::-1]):
        for fused, impl in order:
            set_fuse_tail(fused)
            trainer.settings = trainer.settings._replace(propose_impl=impl)
            trainer.train_step(batch)
            torch.cuda.synchronize()
            for _ in range(6):
                t0 = time.perf_counter()
                trainer.train_step(batch)
                torch.cuda.synchronize()
                times[(fused, impl)].append((time.perf_counter() - t0) * 1e3)
    set_fuse_tail(True)
    out = {f"{'fused' if f else 'unfused'}_tail_{impl}_ms":
           statistics.median(v) for (f, impl), v in times.items()}
    out["runs"] = {f"{'fused' if f else 'unfused'}_tail_{impl}": v
                   for (f, impl), v in times.items()}
    # where the two proposal routes differ, fused tail on: one profiled
    # step, the host synchronisations of one step, and the negatives alone
    # (all four sizes, synchronised, median of 6)
    for impl in ("pallas", "xla"):
        trainer.settings = trainer.settings._replace(propose_impl=impl)
        prof = device_profile(lambda: trainer.train_step(batch))
        neg_ms = []
        for _ in range(6):
            t0 = time.perf_counter()
            _sample_all_negatives(trainer.chrom_table, trainer.blooms,
                                  trainer.settings, batch,
                                  split_generator(trainer.generator, 1)[0])
            torch.cuda.synchronize()
            neg_ms.append((time.perf_counter() - t0) * 1e3)
        out[f"{impl}_detail"] = {
            "negatives_ms": statistics.median(neg_ms),
            "host_syncs_per_step": host_syncs(
                lambda: trainer.train_step(batch)),
            **{key: prof[key] for key in ("wall_ms_profiled",
                                          "device_busy_ms",
                                          "device_idle_share",
                                          "device_kernel_launches")}}
    for impl in ("pallas", "xla"):
        d = out[f"{impl}_detail"]
        print(f"profiled fused + '{impl}' step: {d['device_kernel_launches']}"
              f" device operations, device busy {d['device_busy_ms']} ms",
              flush=True)
    print(json.dumps({"metric": "stage2_step_ab", **out, "card": card}),
          flush=True)
    return out


def small_model_phase(genome, device, card) -> dict:
    """Phase 10: a model whose shapes the fixed-width kernels do not take
    (dim 16, 4 heads, k = 2, 3, f32) with the fused tail on.  One
    train_step ("xla" proposals), one predict_proba and one k = 7
    sample_negatives with propose_impl="pallas" on the card, each with the
    counts zeroed just before and read just after; the same step with
    dropout off against the CPU, and the probabilities against the
    CPU's."""
    set_fuse_tail(True)
    ks, dim, n_head = (2, 3), 16, 4
    rng = np.random.default_rng(SEED + 20)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    inter = rng.random((n, n)).astype(np.float32)
    dims = ModelDims(dim=dim, n_head=n_head, num_chroms=genome.num_chroms,
                     num_nodes=n, compute_dtype="float32")
    sizes = [int(e - s) for s, e in genome.chrom_range]
    params = init_model(torch.Generator().manual_seed(SEED), dims, sizes,
                        device=device)
    frozen = build_frozen_tables(genome, intra + intra.T, inter,
                                 device=device)
    buckets = random_buckets(genome, rng, 4 * TRAIN_BATCH, ks)
    blooms = build_bloom_dict({k: v[0] for k, v in buckets.items()},
                              device=device)
    table = ChromTable.from_genome(genome, device=device)
    trainer = Trainer(params, frozen, dims, table,
                      TrainSettings(alpha=1.0, beta=0.001, neg_num=3,
                                    max_trials=8, token_stream="merged",
                                    propose_impl="xla"),
                      blooms=blooms, seed=SEED + 21)
    batch = {k: (torch.from_numpy(e[:TRAIN_BATCH]).to(device),
                 torch.from_numpy(w[:TRAIN_BATCH]).to(device))
             for k, (e, w) in buckets.items()}
    never = ("K1", "K2", "K5", "K6_fwd", "K6_bwd")
    zero_launch_counts()
    aux = trainer.train_step(batch)
    torch.cuda.synchronize()
    step = launch_counts()
    want = {k: 0 for k in step}
    want.update(K3=1, K4=1, K7=len(ks), K8_fwd=1, K8_bwd=1, K8_keep=1)
    want = with_rounds(want, step)
    losses = [float(aux["bce"]), float(aux["recon"])]
    print(f"small model (dim {dim}, {n_head} heads, k = {list(ks)}): one "
          f"train_step launched {step} (expected {want}); bce, recon "
          f"{losses}", flush=True)
    if step != want or not np.isfinite(losses).all():
        fail(f"the dim-{dim} step launched {step} or lost finiteness")
    check = check_deterministic_step(trainer, buckets, device, ks)

    samples = [list(r) for k in ks for r in buckets[k][0][:CHECK_PER_K]]
    zero_launch_counts()
    p_card = predict_proba(params, frozen, dims, samples, BATCH)
    serve = launch_counts()
    p_cpu = predict_proba(_tree_map(lambda t: t.cpu(), params),
                          cpu_frozen(frozen), dims, samples, BATCH)
    err = float(np.abs(p_card - p_cpu).max())
    print(f"small model predict_proba of {len(samples)} candidates: "
          f"launches {serve}; vs the CPU max_abs_err={err:.3e} (tol "
          f"{TOL_PROBA_F32})", flush=True)
    if any(serve[k] for k in never) or not np.isfinite(p_card).all() \
            or err > TOL_PROBA_F32:
        fail("the dim-16 model's scoring disagrees with the CPU or "
             "launched a fixed-width kernel")

    wide = random_buckets(genome, rng, 512, (7,))[7][0]
    zero_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        neg = sample_negatives(torch.Generator().manual_seed(SEED + 22),
                               torch.from_numpy(wide).to(device), table, 0,
                               tb.build_bloom(wide, device=device),
                               propose_impl="pallas")
    k7 = launch_counts()
    warned = [str(w.message) for w in caught
              if "fell back to XLA" in str(w.message)]
    valid = bool((neg[:, 1:] > neg[:, :-1]).all())
    print(f"k = 7 sample_negatives with propose_impl='pallas': warned "
          f"{warned}; launches {k7}; {neg.shape[0]} sorted negatives "
          f"{valid}", flush=True)
    if not warned or k7["K5"] or k7["K7"] or not valid \
            or neg.shape != (3 * len(wide), 7):
        fail("the k = 7 'pallas' sampler call did not warn, launched K5 or "
             "K7 or gave invalid negatives")
    out = {"metric": "shapes_the_kernels_do_not_take", "dim": dim,
           "n_head": n_head, "ks": list(ks), "step_launches": step,
           "predict_launches": serve, "k7_sampler_launches": k7,
           "step_vs_cpu": check, "proba_max_abs_err": err, "card": card}
    print(json.dumps(out), flush=True)
    return out


# ------------------------------------------------------- run_train via CLI
def write_train_inputs(temp: str, genome, rng) -> int:
    """Phase 11's ``temp_dir``, with numpy only (no h5py): the genome
    (``GenomeBins.save``), random symmetric intra- and inter-chromosomal
    contact matrices and the edge list of ``write_clusters``.  -> the
    number of clusters."""
    from matcha_tpu_torch.data.mcool import save_contacts
    genome.save(temp)
    n = genome.num_nodes
    m = rng.random((n, n), dtype=np.float32)
    m = m + m.T
    same = genome.node2chrom[1:, None] == genome.node2chrom[None, 1:]
    save_contacts(temp, np.where(same, m, 0).astype(np.float32),
                  np.where(same, 0, m).astype(np.float32))
    return write_clusters(temp, genome, rng)


def write_clusters(temp: str, genome, rng) -> int:
    """An edge list of clusters of 2-25 nodes in ``temp``: 1,500 multi-way
    templates of 5-8 nodes on one chromosome each, every template drawn at
    least three times (twice whole, then whole or less one member), so
    every k = 2..5 keeps thousands of k-mers at min_freq_cutoff 2 with
    frequencies spread for the quantile weights, plus 300 clusters of 2-25
    nodes anywhere.  -> the number of clusters."""
    from matcha_tpu_torch.data.clusters import save_edge_list
    n = genome.num_nodes
    clusters = []
    for _ in range(CLI_TEMPLATES):
        s, e = genome.chrom_range[rng.integers(genome.num_chroms)]
        t = np.sort(rng.choice(np.arange(s, e), rng.integers(5, 9),
                               replace=False))
        for i in range(2 + int(rng.geometric(0.3))):
            clusters.append(t if i < 2 or rng.random() < 0.5 else
                            np.delete(t, rng.integers(len(t))))
    for _ in range(300):
        clusters.append(np.sort(rng.choice(np.arange(1, n + 1),
                                           rng.integers(2, 26),
                                           replace=False)))
    offsets = np.zeros(len(clusters) + 1, np.int64)
    np.cumsum([len(c) for c in clusters], out=offsets[1:])
    save_edge_list(temp, np.concatenate(clusters).astype(np.int32), offsets)
    return len(clusters)


def cli_train_phase(genome, card, tmp: str) -> dict:
    """Phase 11: ``run_train`` through the CLI on the card at full width.
    Writes the inputs (``write_train_inputs``) and a config.JSON
    (``write_cli_config``) under ``tmp``, runs the ``kmers`` and ``train``
    stages (``cli_kmers_and_train``); then scores candidates with the
    bundle it wrote.  -> the results, with the config's path ("config")."""
    out = {"metric": "run_train_cli", "card": card}
    temp = os.path.join(tmp, "temp")
    t0 = time.perf_counter()
    out["clusters"] = write_train_inputs(temp, genome,
                                         np.random.default_rng(SEED + 70))
    out["inputs_s"] = time.perf_counter() - t0
    cfg = write_cli_config(tmp, temp, genome)
    cli_kmers_and_train(cfg, tmp, temp, genome, out)
    inp = os.path.join(tmp, "candidates.txt")
    with open(inp, "w") as f:
        f.write("chr1:500000\tchr1:3500000\n"
                "chr2:1000000\tchr2:9000000\tchr2:20000000\n"
                "chr3:0\tchr3:4000000\tchr3:8000000\tchr3:9000000\n")
    proba = run_predict_multiway(os.path.join(temp, "model2load"), inp,
                                 os.path.join(tmp, "out.txt"),
                                 device="cuda")
    out["proba"] = [float(p) for p in proba]
    if proba.shape != (3,) or not ((proba > 0) & (proba < 1)).all():
        fail(f"the trained bundle scored {proba}")
    print(json.dumps(out), flush=True)
    return {**out, "config": cfg}


def write_cli_config(tmp: str, temp: str, genome, **extra) -> str:
    """Phase 11's config.JSON under ``tmp`` (k = 2..5, embed_dim 64, 8
    heads, compute "auto", batch 2,048, 10 batches per epoch, 1 + 1
    epochs), with ``extra`` keys on top.  -> its path."""
    cfg = os.path.join(tmp, "config.JSON")
    with open(cfg, "w") as f:
        json.dump({"temp_dir": temp, "resolution": genome.resolution,
                   "chrom_list": genome.chrom_names,
                   "max_cluster_size": 25,
                   "min_distance": 0, "k-mer_size": list(TRAIN_KS),
                   "min_freq_cutoff": 2, "embed_dim": CLI_DIM,
                   "n_head": N_HEAD, "batch_size": CLI_BATCH,
                   "num_batch_per_iter": TRAIN_STEPS,
                   "stage1_epochs": 1, "stage2_epochs": 1, **extra}, f)
    return cfg


def cli_kmers_and_train(cfg: str, tmp: str, temp: str, genome, out: dict,
                        device="cuda") -> None:
    """``python -m matcha_tpu_torch kmers`` in a subprocess, then the
    ``train`` stage through the same entry in this process
    (``pipeline.main``), the launch counts zeroed just before and read just
    after.  "auto" must resolve to bf16 / merged / xla / off, K1-K4 must
    launch and K5 / K6 not; the bundle, the (N, dim) finite embeddings, the
    checkpoint and the metrics log must exist.  Fills ``out`` with the
    stages' walls, the time ``run_train`` spent in
    ``build_frozen_tables``, the host memory over ``train`` and the
    launches."""
    import contextlib
    import importlib.util
    import io
    from matcha_tpu_torch import pipeline
    from matcha_tpu_torch.native import cluster_native, kmer_native
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "matcha_tpu_torch",
                          "kmers", "-c", cfg],
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600)
    out["kmers_s"] = time.perf_counter() - t0
    print(res.stdout.strip(), flush=True)
    if res.returncode != 0:
        fail(f"python -m matcha_tpu_torch kmers exited {res.returncode}:"
             f"\n{res.stderr[-3000:]}")
    out["native_parser"] = cluster_native.available()
    out["native_counter"] = kmer_native.available()
    out["modules"] = {m: importlib.util.find_spec(m) is not None
                      for m in ("h5py", "scipy", "matplotlib", "pandas")}

    hs._FUSE_TAIL = None          # an earlier phase set the gate; "auto"
    os.environ.pop("MATCHA_FUSE_TAIL", None)        # resets it
    log = io.StringIO()
    zero_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log), HostMemory() as mem, \
            timed_calls(pipeline, "build_frozen_tables") as spent:
        pipeline.main(["train", "-c", cfg, "--device", str(device)])
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["train_build_frozen_tables_s"] = spent["build_frozen_tables"]
    out["train_host_memory"] = mem.reading()
    out["launches"] = launch_counts()
    text = log.getvalue()
    print(text.strip(), flush=True)
    sizes = [ln for ln in text.splitlines()
             if ln.startswith("train sizes: ")]
    perf = [ln for ln in text.splitlines()
            if ln.startswith("resolved perf: ")]
    out["train_sizes"] = sizes[0][len("train sizes: "):] if sizes \
        else None
    want_perf = ("'compute_dtype': 'bfloat16'", "'token_stream': 'merged'",
                 "'propose_impl': 'xla'", "'fuse_tail': 'off'")
    if not perf or not all(w in perf[0] for w in want_perf):
        fail(f"run_train resolved {perf}, expected bf16 / merged / xla "
             f"/ off")
    emb_path = os.path.join(tmp, "embeddings.npy")
    missing = [p for p in (os.path.join(temp, "model2load", "params.pkl"),
                           emb_path, os.path.join(temp, "model.chkpt"),
                           os.path.join(temp, "logs", "metrics.jsonl"))
               if not os.path.exists(p)]
    if missing:
        fail(f"run_train did not write {missing}")
    emb = np.load(emb_path)
    out["embeddings_shape"] = list(emb.shape)
    if emb.shape != (genome.num_nodes, CLI_DIM) or not np.isfinite(
            emb).all():
        fail(f"run_train's embeddings: shape {emb.shape}, finite "
             f"{bool(np.isfinite(emb).all())}")
    launched = out["launches"]
    if not all(launched[k] for k in ("K1", "K2", "K3", "K4", "K7", "K8_fwd",
                                     "K8_bwd", "K8_keep")) or any(
            launched[k] for k in ("K5", "K6_fwd", "K6_bwd")):
        fail(f"run_train launched {launched}: expected K1-K4, K7 and K8, "
             f"and no K5 or K6 on the shipped path")


# ----------------------------------------------------- walk pretraining
def time_sgns_kernels(device) -> dict:
    """K3 and K4 at the SGNS shapes (f32, d = 64, n = 3,067 and the 100 kb
    table's 30,345 rows, T = 4,096 and 24,576 unigram-skewed ids): CUDA
    events around the wrapper and the kernels' device time from
    torch.profiler, beside their bounds (each input read once, the output
    written once), their plain versions and ``index_add_`` (both
    yardsticks, k3_timing) / ``torch.bincount`` (by events and on the
    device).  -> {"K3_T<T>", "K4_T<T>"} at n = 3,067 and {"K3_T<T>_n30345",
    "K4_T<T>_n30345"}."""
    out = {}
    for V in (SGNS_V, SGNS_V_100KB):
        sfx = "" if V == SGNS_V else f"_n{V}"
        for T in SGNS_T:
            g, idx = sgns_kernel_inputs(device, T, V=V)
            idx64 = idx.long()
            out[f"K3_T{T}{sfx}"] = k3_timing(g, idx, V, "unigram")
            out[f"K4_T{T}{sfx}"] = {
                "T": T, "n": V,
                "ms": cuda_ms(lambda: ts.bincount_cuda(idx, V)),
                "device_ms": device_ms_per_call(
                    lambda: ts.bincount_cuda(idx, V)),
                "plain_ms": cuda_ms(lambda: ts.bincount_plain(idx, V)),
                "library_ms": cuda_ms(lambda: torch.bincount(
                    idx64, minlength=V)),
                "library_device_ms": device_ms_per_call(
                    lambda: torch.bincount(idx64, minlength=V)),
                "library": "torch.bincount",
                "bound_ms": (T * 4 + V * 4) / PEAK_BYTES * 1e3,
                "bound_by": "bytes"}
    return out


def sgns_step_limits(emb_in, emb_out, centers, contexts, cdf, u, lr):
    """Per-entry limits on |card - CPU| of the two tables after one
    ``sgns_step`` from these (CPU) inputs: the sum of both sides' f32
    rounding bounds.  A row's update is lr * (sum of its c terms) / c; a
    term is g * v with |g| <= 1 and g from a d-term score, so each side is
    off by at most 2^-24 * (c + d + neg + 5) * (lr * A / c + |table|), A
    the row's sum of (1 + S_t) |v_t| over its terms, S_t the term's
    absolute score sum |v_in * v|.  A long sum (a hub row) gets a wider
    limit than a short one, whatever the table's largest entry."""
    a_in, a_out = emb_in.double().numpy(), emb_out.double().numpy()
    V, d = a_in.shape
    c, x = centers.long().numpy(), contexts.long().numpy()
    negs = np.minimum(np.searchsorted(cdf.numpy(), u.numpy()), V - 1)
    neg = negs.shape[1]
    v_in, v_pos, v_neg = a_in[c], a_out[x], a_out[negs]
    s_pos = 1 + np.abs(v_in * v_pos).sum(-1)                     # (m,)
    s_neg = 1 + np.abs(v_neg * v_in[:, None]).sum(-1)            # (m, neg)
    t_in = (s_pos[:, None] * np.abs(v_pos)
            + (s_neg[..., None] * np.abs(v_neg)).sum(1))
    t_out = np.concatenate([s_pos[:, None] * np.abs(v_in),
                            (s_neg[..., None] * np.abs(v_in)[:, None]
                             ).reshape(-1, d)])
    limits = []
    for table, idx, terms in ((a_in, c, t_in),
                              (a_out, np.concatenate([x, negs.reshape(-1)]),
                               t_out)):
        cnt = np.bincount(idx, minlength=V).astype(np.float64)[:, None]
        A = np.zeros((V, d))
        np.add.at(A, idx, terms)
        limits.append(2 * 2.0 ** -24 * (cnt + d + neg + 5)
                      * (lr * A / np.maximum(cnt, 1) + np.abs(table)))
    return limits


def sgns_step_check(pairs_b: np.ndarray, cdf: torch.Tensor, emb: np.ndarray,
                    device) -> dict:
    """One f32 SGNS step (``sgns_step``) on the card and on the CPU from the
    same tables (the pretrained input table, a random output table) and the
    same injected uniforms, over the first minibatch of the run's pairs and
    over the same minibatch with half of its centers and half of its
    contexts moved to one hub row.  -> per minibatch: the largest table
    difference over that entry's rounding limit (``sgns_step_limits``),
    over that table's largest entry, and the loss's relative difference."""
    rng = np.random.default_rng(SEED + 41)
    tables = [emb.astype(np.float32),
              (rng.standard_normal(emb.shape) * 0.01).astype(np.float32)]
    u = torch.from_numpy(rng.random((pairs_b.shape[1], SGNS_NEG)).astype(
        np.float32))
    out = {}
    for name in ("run", "hub"):
        ids = np.array(pairs_b[0], dtype=np.int32)               # (m, 2)
        if name == "hub":
            for col in (0, 1):
                ids[rng.permutation(len(ids))[:len(ids) // 2], col] = 3
        centers = torch.from_numpy(np.ascontiguousarray(ids[:, 0]))
        contexts = torch.from_numpy(np.ascontiguousarray(ids[:, 1]))
        cpu_in = [torch.from_numpy(a) for a in tables]
        limits = sgns_step_limits(*cpu_in, centers, contexts, cdf.cpu(), u,
                                  0.1)
        results = []
        for dev in (device, torch.device("cpu")):
            t = [torch.tensor(a, device=dev) for a in tables]
            loss = skipgram.sgns_step(t[0], t[1], centers.to(dev),
                                      contexts.to(dev), cdf.to(dev),
                                      u.to(dev), lr=0.1)
            results.append([x.cpu() for x in t] + [float(loss)])
        (a_in, a_out, a_loss), (b_in, b_out, b_loss) = results
        pairs = ((a_in, b_in, limits[0]), (a_out, b_out, limits[1]))
        out[name] = {
            "of_limit": max(float(((a - b).abs().double().numpy()
                                   / lim).max()) for a, b, lim in pairs),
            "of_max": max(float((a - b).abs().max()) / float(b.abs().max())
                          for a, b, _ in pairs),
            "loss": abs(a_loss - b_loss) / abs(b_loss)}
    return out


def pretrain_phase(problem, genome, card, cfg: str,
                   device=torch.device("cuda")) -> dict:
    """Phase 15: ``python -m matcha_tpu_torch pretrain`` in process
    (``pipeline.main``) on phase 11's ``temp_dir`` with the JAX package's
    defaults, the counts zeroed just before and read just after (2 K3 and 2
    K4 per minibatch, nothing else); the embeddings file, the loss's fall
    over the epoch, an SGNS step card vs CPU; the SGNS rate over a profiled
    window, K3 and K4 at these shapes; then a 10-step stage-2 epoch of a
    table-mode model initialised from the embeddings at phase 6's
    configuration, its launches pinned."""
    import contextlib
    import io
    from matcha_tpu_torch import pipeline
    with open(cfg) as f:
        temp = json.load(f)["temp_dir"]
    seen = {}
    chunked = skipgram.sgns_epoch_chunked
    pretrain = pipeline.pretrain_node_embeddings

    def keep(emb_in, emb_out, pairs_b, cdf, *args, **kw):
        seen.update(pairs_b=pairs_b, cdf=cdf)
        res = chunked(emb_in, emb_out, pairs_b, cdf, *args, **kw)
        seen["losses"] = res[2]
        return res

    def keep_timings(*args, **kw):
        seen["timings"] = kw["timings"]
        return pretrain(*args, **kw)
    log = io.StringIO()
    with unittest.mock.patch.object(skipgram, "sgns_epoch_chunked", keep), \
            unittest.mock.patch.object(pipeline, "pretrain_node_embeddings",
                                       keep_timings):
        zero_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            pipeline.main(["pretrain", "-c", cfg, "--device",
                           str(device)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    print(log.getvalue().strip(), flush=True)
    timings = seen["timings"]
    n_b = int(timings["minibatches"])
    want = {k: 0 for k in counts}
    want.update(K3=2 * n_b, K4=2 * n_b)
    print(f"pretrain: {n_b} minibatches of {SGNS_M} pairs, launches "
          f"{counts} (expected {want})", flush=True)
    if counts != want:
        fail(f"the pretraining launched {counts}, expected {want}")
    emb = np.load(os.path.join(temp, "walk_embeddings.npy"))
    if emb.shape != (genome.num_nodes, DIM) or not np.isfinite(emb).all():
        fail(f"walk_embeddings.npy of shape {emb.shape} or not finite")
    losses = seen["losses"].cpu().numpy()
    tenth = max(len(losses) // 10, 1)
    first, last = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    if not last < first:
        fail(f"the SGNS loss did not fall: first tenth {first}, last "
             f"{last}")
    err = sgns_step_check(seen["pairs_b"], seen["cdf"], emb, device)
    for name, e in err.items():
        ok = (e["of_limit"] <= 1.0 and e["loss"] <= TOL_SGNS_STEP
              and (name == "hub" or e["of_max"] <= TOL_SGNS_STEP))
        print(f"SGNS step f32 card vs CPU ({name} minibatch): "
              f"{e['of_limit']:.3e} of the entry's rounding limit (tol 1), "
              f"{e['of_max']:.3e} of each table's largest entry"
              f"{'' if name == 'hub' else f' (tol {TOL_SGNS_STEP})'}, loss "
              f"{e['loss']:.3e} relative (tol {TOL_SGNS_STEP}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"the SGNS step on the card disagrees with the CPU ({name} "
                 f"minibatch)")

    # the SGNS rate over a window of minibatches, synchronised, and the
    # device's idle share in it
    pairs = torch.from_numpy(np.asarray(
        seen["pairs_b"][:SGNS_PROFILE_STEPS], dtype=np.int32)).to(
        device).transpose(1, 2).contiguous()
    gen = torch.Generator(device=device).manual_seed(SEED)
    tables = [torch.tensor(emb, device=device),
              torch.zeros(emb.shape, device=device)]

    def window():
        return skipgram.sgns_epoch(*tables, pairs, seen["cdf"], gen,
                                   neg_num=SGNS_NEG, lr=0.1)
    window()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    trace = device_profile(window)
    n_pairs = SGNS_PROFILE_STEPS * SGNS_M
    kern = time_sgns_kernels(device)

    # a table-mode model from the embeddings, one stage-2 epoch
    set_fuse_tail(False)
    dims, _, frozen, buckets, blooms, table = problem
    sizes = [int(e - s) for s, e in genome.chrom_range]
    params = init_model(torch.Generator().manual_seed(SEED), dims, sizes,
                        embedding_mode="table", device=device,
                        table_init=emb)
    if not np.array_equal(params["embed"]["table"][1:].cpu().numpy(), emb):
        fail("the table-mode model's table is not the embeddings")
    tm = Trainer(params, frozen, dims, table,
                 TrainSettings(alpha=1.0, beta=0.001, neg_num=3, max_trials=8,
                               token_stream="merged"),
                 blooms=blooms, seed=SEED + 61)
    batcher = BucketedBatcher(buckets, TRAIN_BATCH, TRAIN_STEPS, seed=SEED)
    if not tm.pin_base_buckets(batcher):
        fail("the table-mode buckets do not fit the pin budget")
    n_attn = sum(1 for k in TRAIN_KS if k >= 3)
    want_tm = {k: 0 for k in counts}
    want_tm.update(K1=n_attn * TRAIN_STEPS, K2=n_attn * TRAIN_STEPS,
                   K3=TRAIN_STEPS, K7=len(TRAIN_KS) * TRAIN_STEPS)
    zero_launch_counts()
    res = tm.train_epoch_indexed(batcher)
    got_tm = launch_counts()
    want_tm = with_rounds(want_tm, got_tm)
    print(f"table-mode stage-2 epoch: launches {got_tm} (expected "
          f"{want_tm}), train bce {res['bce']:.4f} recon {res['recon']}",
          flush=True)
    if got_tm != want_tm:
        fail(f"the table-mode epoch launched {got_tm}, expected {want_tm}")
    if not np.isfinite(res["bce"]) or res["recon"] != 0.0:
        fail(f"the table-mode epoch gave bce {res['bce']}, recon "
             f"{res['recon']} (expected finite, 0)")

    out = {"metric": "pretrain", "pretrain_wall_s": wall,
           "timings": timings, "minibatches": n_b, "launches": counts,
           "sgns_pairs_per_s": timings["pairs"] / timings["sgns_s"],
           "loss_first_tenth": first, "loss_last_tenth": last,
           "sgns_step_card_vs_cpu": err,
           "window_minibatches": SGNS_PROFILE_STEPS,
           "window_wall_s": walls,
           "window_pairs_per_s": n_pairs / statistics.median(walls),
           "window_profile": trace, "kernels": kern,
           "table_mode_epoch": {"launches": got_tm,
                                "elapsed_s": res["elapsed"],
                                "hyperedges_per_s":
                                    res["hyperedges_per_sec"],
                                "bce": res["bce"]},
           "card": card}
    print(json.dumps(out), flush=True)
    return out


# --------------------------------------------- apps on the bundle, modes
@contextlib.contextmanager
def denoise_parts():
    """Within the block, the parts of ``denoise_pixels`` calls, summed over
    the chromosomes: host-clock seconds of building the pairs, of the node
    tables and pair scores (each chromosome's ends in a copy to the host),
    of the normalisations and of the three quantile transforms, filled into
    the yielded dict when the block ends."""
    from matcha_tpu_torch.apps import denoise_contact as dn
    parts = {}
    with timed_calls(dn, "generate_pair_wise", "chromosome_proba",
                     "normalise", "_quantile") as spent:
        yield parts
    parts.update(pairs_s=spent["generate_pair_wise"],
                 tables_pairwise_s=spent["chromosome_proba"],
                 normalise_s=spent["normalise"],
                 quantile_s=spent["_quantile"])


def denoise_phase(bundle, genome, device, card) -> dict:
    """Phase 12: the port's denoise computation over all 23 chromosomes on
    the card (closed form, min_distance 0), the counts zeroed just before
    and read just after (no kernel); the pixels' count and range; on chr1
    the card's f32 pair probabilities against the CPU's and the closed
    form against the forward over the explicit pairs (both bf16 on the
    card); the pass's wall and its parts; the .mcool write where h5py is
    importable."""
    import importlib.util
    from matcha_tpu_torch.apps import denoise_contact as dn
    from matcha_tpu_torch.apps.pairwise_fast import pairwise_proba_matrix
    t_phase = time.perf_counter()
    params, dims, _, frozen = load_model_bundle(bundle, device)
    intra = np.load(os.path.join(bundle, "intra_adj.npy"))
    np.random.seed(SEED + 30)
    dn.denoise_pixels(params, frozen, dims, genome, intra,
                      log=lambda *a: None)                   # warm-up
    zero_launch_counts()
    t0 = time.perf_counter()
    with denoise_parts() as parts:
        bin1, bin2, bal, _ = dn.denoise_pixels(params, frozen, dims, genome,
                                               intra, log=lambda *a: None)
    wall = time.perf_counter() - t0
    launched = launch_counts()
    bins = np.diff(genome.chrom_range, axis=1)[:, 0]
    want = int((bins * (bins + 1) // 2).sum())
    out = {"metric": "denoise_wall_s", "value": wall, "pixels": len(bal),
           "chromosomes": genome.num_chroms, "launches": launched,
           "parts_s": parts, "card": card}
    print(f"denoise: {len(bal)} pixels over {genome.num_chroms} chromosomes "
          f"in {wall:.3f} s (expected {want} pixels); launches {launched}",
          flush=True)
    if not (len(bin1) == len(bin2) == len(bal) == want):
        fail(f"denoise gave {len(bal)} pixels, expected {want}")
    if not np.isfinite(bal).all() or (bal < 0).any() or (bal > 1).any():
        fail("denoised values are not finite or outside [0, 1]")
    if launched["K8_fwd"] != genome.num_chroms or any(
            v for k, v in launched.items() if k != "K8_fwd"):
        fail(f"denoise launched {launched}: the closed form needs only the "
             f"node table's encode, one K8 forward per chromosome")

    f32 = dims._replace(compute_dtype="float32")
    p_card = pairwise_proba_matrix(params, frozen, f32, genome, 0)
    c_params, _, _, c_frozen = load_model_bundle(bundle, "cpu")
    p_cpu = pairwise_proba_matrix(c_params, c_frozen, f32, genome, 0)
    out["chr1_f32_card_vs_cpu_max_abs_err"] = float(np.abs(p_card
                                                           - p_cpu).max())
    pairs = dn.generate_pair_wise(genome, 0, 0)
    fast = dn.chromosome_proba(params, frozen, dims, genome, 0, pairs)
    zero_launch_counts()
    slow = dn.chromosome_proba(params, frozen, dims, genome, 0, pairs,
                               use_fast=False, batch_size=BATCH)
    out["chr1_forward_launches"] = launch_counts()
    out["chr1_pairs"] = len(pairs)
    out["chr1_closed_form_vs_forward_bf16_max_abs_err"] = float(
        np.abs(fast - slow).max())
    print(f"denoise chr1 ({len(pairs)} pairs): f32 card vs CPU "
          f"{out['chr1_f32_card_vs_cpu_max_abs_err']:.3e} (tol "
          f"{TOL_PROBA_F32}); closed form vs forward, bf16 on the card, "
          f"{out['chr1_closed_form_vs_forward_bf16_max_abs_err']:.3e} (tol "
          f"{TOL_PROBA_BF16})", flush=True)
    if (out["chr1_f32_card_vs_cpu_max_abs_err"] > TOL_PROBA_F32
            or out["chr1_closed_form_vs_forward_bf16_max_abs_err"]
            > TOL_PROBA_BF16):
        fail("the denoise pair probabilities disagree")
    if importlib.util.find_spec("h5py") is None:
        out["write_s"] = "not run"
        print("denoise: the .mcool write was not run on this machine: h5py "
              "is absent", flush=True)
    else:
        import h5py
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "denoised.mcool")
            t0 = time.perf_counter()
            dn.write_denoised_mcool(path, genome, bin1, bin2, bal)
            out["write_s"] = time.perf_counter() - t0
            dn.run_denoise(bundle, output_mcool=path, log=lambda *a: None,
                           device=device)
            with h5py.File(path) as f:
                grp = f["resolutions"][str(genome.resolution)]
                layout = (list(grp["chroms"]["name"].asstr())
                          == genome.chrom_names
                          and len(grp["bins"]["chrom"]) == genome.num_nodes
                          and len(grp["pixels"]["balanced"]) == want)
            if not layout:
                fail("run_denoise wrote a file of another layout")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(json.dumps(out), flush=True)
    return out


def outlier_phase(model, cpu_model, samples, genome, card,
                  metric="outlier_rows_per_s") -> dict:
    """Phase 13 (and 18 (e)): 2,000 of the candidates ``samples`` of each
    k = 3..5 through generate_outliers (20 per edge) and outlier_hit_rate
    (top 3, batch 10,000) on the card with ``model`` (params, dims, frozen
    of a loaded bundle), the counts zeroed just before and read just after:
    K1 once per chunk; per-position scores on the card (f32, bf16) against
    f32 on the CPU with ``cpu_model`` (params, frozen: the same on the
    CPU)."""
    from matcha_tpu_torch.apps.outlier import (generate_outliers,
                                               outlier_hit_rate,
                                               per_position_scores)
    t_phase = time.perf_counter()
    params, dims, frozen = model
    c_params, c_frozen = cpu_model
    f32 = dims._replace(compute_dtype="float32")
    rng = np.random.default_rng(SEED + 40)
    sets = {}
    t0 = time.perf_counter()
    for k in (3, 4, 5):
        edges = np.asarray([s_ for s_ in samples if len(s_) == k]
                           [:CHECK_PER_K], np.int32)
        known = {(a, b) for e in edges.tolist() for a in e for b in e
                 if a != b}
        sets[k] = generate_outliers(edges, known, genome.num_nodes, rng,
                                    per_edge=OUTLIER_PER_EDGE)
    gen_s = time.perf_counter() - t0
    for k, (x, _) in sets.items():       # warm-up
        per_position_scores(params, frozen, dims, x[:BATCH])
    zero_launch_counts()
    t0 = time.perf_counter()
    hits = {k: outlier_hit_rate(params, frozen, dims, x, pts, k=3,
                                batch_size=BATCH)
            for k, (x, pts) in sets.items()}
    wall = time.perf_counter() - t0
    launched = launch_counts()
    rows = sum(len(x) for x, _ in sets.values())
    want = {key: 0 for key in launched}
    want["K1"] = sum(-(-len(x) // BATCH) for x, _ in sets.values())
    want["K8_fwd"] = len(sets)          # one encode per scoring call
    out = {"metric": metric, "value": rows / wall,
           "rows": {k: len(x) for k, (x, _) in sets.items()},
           "wall_s": wall, "generate_s": gen_s,
           "hit_rate_top3": {k: [float(v) for v in h]
                             for k, h in hits.items()},
           "launches": launched, "batch_size": BATCH, "card": card}
    print(f"outlier_hit_rate over {rows} rows in {wall:.3f} s; launches "
          f"{launched} (expected {want})", flush=True)
    if launched != want:
        fail(f"outlier ranking launched {launched}, expected {want}")
    for h in hits.values():
        if not (np.isfinite(h).all() and (np.diff(h) >= 0).all()
                and 0 <= h[0] <= h[-1] <= 1):
            fail(f"outlier hit rates {hits}")
    errs = {}
    for k, (x, _) in sets.items():
        x = x[:CHECK_PER_K]
        ref = per_position_scores(c_params, c_frozen, f32, x)
        scale = float(np.abs(ref).max())
        errs[k] = {
            "f32_abs": float(np.abs(per_position_scores(
                params, frozen, f32, x) - ref).max()),
            "bf16_rel_to_max": float(np.abs(per_position_scores(
                params, frozen, dims, x) - ref).max()) / scale,
            "ref_max_abs": scale}
    out["scores_vs_cpu_f32"] = errs
    print(f"per-position scores vs f32 on the CPU: {json.dumps(errs)} (tol "
          f"f32 {TOL_SCORES_F32} abs, bf16 {TOL_SCORES_BF16} of the largest "
          f"score)", flush=True)
    if any(e["f32_abs"] > TOL_SCORES_F32
           or e["bf16_rel_to_max"] > TOL_SCORES_BF16 for e in errs.values()):
        fail("per-position scores on the card disagree with the CPU")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(json.dumps(out), flush=True)
    return out


def set_recon_bf16(on):
    """Set the MATCHA_RECON_BF16 gate for the next phase (None: read the
    environment again), as set_fuse_tail sets the fused-tail gate."""
    hs._RECON_BF16 = on


def synced_step_ms(trainer, batch, n=10) -> list:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def modes_phase(problem, genome, card) -> dict:
    """Phase 14, at the training step's shape (phase 6's problem, the
    shipped path): (a) Trainer.fit in the regress mode, one epoch of 10
    steps with its per-k eval and checkpoint; (b) 10 steps with the
    per-occurrence feature dropout, the step's peak memory, and the step in
    f32 at dropout 0 against the CPU; (c) 10 steps with MATCHA_RECON_BF16,
    its recon loss against the same step with the gate off.  Each with the
    counts zeroed just before and read just after."""
    dims, params, frozen, buckets, blooms, table = problem
    dev = _leaves(params)[0].device
    shipped = dict(alpha=1.0, beta=0.001, neg_num=3, max_trials=8,
                   token_stream="merged")
    batch = {k: (torch.as_tensor(e[:TRAIN_BATCH], device=dev),
                 torch.as_tensor(w[:TRAIN_BATCH], device=dev))
             for k, (e, w) in buckets.items()}
    n_attn = sum(1 for k in TRAIN_KS if k >= 3)
    none = {k: 0 for k in launch_counts()}
    out = {"metric": "modes", "card": card}

    # (a) regress
    t_phase = time.perf_counter()
    trainer = Trainer(params, frozen, dims, table,
                      TrainSettings(**shipped, task_mode="regress"),
                      blooms=blooms, seed=SEED + 51)
    trainer.train_step(batch)
    torch.cuda.synchronize()
    zero_launch_counts()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    step = launch_counts()
    want_step = {**none, "K1": n_attn, "K2": n_attn, "K4": len(TRAIN_KS),
                 "K7": len(TRAIN_KS), "K8_fwd": 1, "K8_bwd": 1,
                 "K8_keep": 1}
    test = random_buckets(genome, np.random.default_rng(SEED + 50),
                          TEST_PER_K)
    per_k = EVAL_SAMPLES // len(TRAIN_KS)
    n_eval = min(TEST_PER_K, per_k) // min(TRAIN_BATCH, TEST_PER_K, per_k)
    want_fit = {k: v * TRAIN_STEPS for k, v in want_step.items()}
    want_fit["K1"] += n_attn * n_eval
    want_fit["K4"] += len(TRAIN_KS) * n_eval
    want_fit["K7"] += len(TRAIN_KS) * n_eval
    want_fit = with_encodes(want_fit, 1)            # the eval's encode
    logs = []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "model.chkpt")
        zero_launch_counts()
        t0 = time.perf_counter()
        hist = trainer.fit(buckets, test, epochs=1, batch_size=TRAIN_BATCH,
                           num_batch_per_iter=TRAIN_STEPS,
                           checkpoint_path=ckpt, log=logs.append, seed=SEED)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit = launch_counts()
        written = os.path.exists(ckpt)
    want_step, want_fit = with_rounds(want_step, step), with_rounds(want_fit,
                                                                    fit)
    ev = hist[0]["valid"]
    sel = ev["metrics"].get(max(TRAIN_KS), {}).get("auprc", float("nan"))
    out["regress"] = {
        "step_launches": step, "fit_launches": fit, "eval_batches": n_eval,
        "fit_epoch_s": fit_s, "train_s": hist[0]["train"]["elapsed"],
        "train_bce": hist[0]["train"]["bce"], "valid_bce": ev["bce"],
        "valid_recon": ev["recon"], "checkpoint_written": written,
        "checkpoint_key": ("auprc" if np.isfinite(sel) else "-bce"),
        "checkpoint_key_value": sel if np.isfinite(sel) else -ev["bce"],
        "phase_wall_s": time.perf_counter() - t_phase}
    print("\n".join(logs), flush=True)
    print(f"regress: one step launched {step} (expected {want_step}); the "
          f"fit's epoch of {TRAIN_STEPS} steps and {n_eval} eval batches "
          f"{fit} (expected {want_fit}); {json.dumps(out['regress'])}",
          flush=True)
    if step != want_step or fit != want_fit:
        fail("the regress mode launched other counts")
    if not (written and np.isfinite(hist[0]["train"]["bce"])
            and np.isfinite(ev["bce"])):
        fail("the regress fit lost finiteness or wrote no checkpoint")

    # (b) per-occurrence feature dropout
    t_phase = time.perf_counter()
    occ = dims._replace(feature_dropout_mode="per_occurrence")
    trainer = Trainer(params, frozen, occ, table, TrainSettings(**shipped),
                      blooms=blooms, seed=SEED + 52)
    batcher = BucketedBatcher(buckets, TRAIN_BATCH, TRAIN_STEPS, seed=SEED)
    if not trainer.pin_base_buckets(batcher):
        fail("the buckets do not fit the pin budget")
    trainer.train_epoch_indexed(batcher)                      # warm-up
    zero_launch_counts()
    timed = trainer.train_epoch_indexed(batcher)
    epoch = launch_counts()
    want = with_rounds({**none, "K1": n_attn * TRAIN_STEPS,
                        "K2": n_attn * TRAIN_STEPS,
                        "K7": len(TRAIN_KS) * TRAIN_STEPS,
                        "K8_fwd": TRAIN_STEPS}, epoch)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    steps = synced_step_ms(trainer, batch)
    out["per_occurrence"] = {
        "epoch_launches": epoch, "epoch_s": timed["elapsed"],
        "bce": timed["bce"], "recon": timed["recon"],
        "median_step_ms_synced": statistics.median(steps),
        "step_ms_synced": steps, "memory_held_gb": held / 1e9,
        "step_peak_gb": peak / 1e9, "step_peak_above_held_gb":
        (peak - held) / 1e9, "limit_gb": JAX_GATHERED_W1_BYTES / 1e9}
    print(f"per-occurrence: an epoch of {TRAIN_STEPS} steps launched "
          f"{epoch} (expected {want}); step peak {peak / 1e9:.3f} GB, "
          f"{(peak - held) / 1e9:.3f} GB above the {held / 1e9:.3f} GB held "
          f"before it (limit {JAX_GATHERED_W1_BYTES / 1e9:.2f} GB, JAX's "
          f"gathered W1 alone)", flush=True)
    if epoch != want:
        fail("the per-occurrence step launched other counts")
    if peak - held >= JAX_GATHERED_W1_BYTES:
        fail("the per-occurrence step's peak reaches JAX's weight gather")
    if not (np.isfinite(timed["bce"]) and np.isfinite(timed["recon"])):
        fail("the per-occurrence epoch lost finiteness")
    out["per_occurrence"]["step_vs_cpu"] = check_deterministic_step(
        trainer, buckets, dev, train_seed=SEED + 53,
        what="per-occurrence step at dropout 0")
    out["per_occurrence"]["phase_wall_s"] = time.perf_counter() - t_phase

    # (c) MATCHA_RECON_BF16: the same first step with the gate off, then on;
    # synchronised steps of the two Trainers in turns (off, on, on, off),
    # the gate set between the blocks, so that no Trainer's run mixes them
    t_phase = time.perf_counter()
    set_recon_bf16(False)
    ref = Trainer(params, frozen, dims, table, TrainSettings(**shipped),
                  blooms=blooms, seed=SEED + 54)
    recon_off = float(ref.train_step(batch)["recon"])
    set_recon_bf16(True)
    trainer = Trainer(params, frozen, dims, table, TrainSettings(**shipped),
                      blooms=blooms, seed=SEED + 54)
    recon_on = float(trainer.train_step(batch)["recon"])
    off_ms, on_ms = [], []
    for gate in (False, True, True, False):
        set_recon_bf16(gate)
        (on_ms if gate else off_ms).extend(
            synced_step_ms(trainer if gate else ref, batch, 6))
    set_recon_bf16(True)
    batcher = BucketedBatcher(buckets, TRAIN_BATCH, TRAIN_STEPS, seed=SEED)
    if not trainer.pin_base_buckets(batcher):
        fail("the buckets do not fit the pin budget")
    zero_launch_counts()
    timed = trainer.train_epoch_indexed(batcher)
    epoch = launch_counts()
    set_recon_bf16(None)
    want = with_rounds(scaled(step_counts(False, False), TRAIN_STEPS), epoch)
    rel = abs(recon_on - recon_off) / abs(recon_off)
    out["recon_bf16"] = {
        "epoch_launches": epoch, "epoch_s": timed["elapsed"],
        "recon_gate_off": recon_off, "recon_gate_on": recon_on,
        "recon_rel_err": rel,
        "median_step_ms_synced_gate_off": statistics.median(off_ms),
        "median_step_ms_synced_gate_on": statistics.median(on_ms),
        "step_ms_synced_gate_off": off_ms, "step_ms_synced_gate_on": on_ms,
        "phase_wall_s": time.perf_counter() - t_phase}
    print(f"MATCHA_RECON_BF16: an epoch of {TRAIN_STEPS} steps launched "
          f"{epoch} (expected {want}); recon {recon_on} against {recon_off} "
          f"with the gate off, {rel:.3e} relative (tol {TOL_RECON_BF16})",
          flush=True)
    if epoch != want:
        fail("the recon-bf16 step launched other counts")
    if not rel <= TOL_RECON_BF16 or not np.isfinite(timed["recon"]):
        fail("the recon loss with bf16 decode operands disagrees")
    print(json.dumps(out), flush=True)
    return out


# ------------------------------------------------------------- phase 16
# multi-rank training on the one card: the meshes (data x model) whose
# ranks share it on gloo, the stage-2 fit of the 2 x 1 mesh, and the
# deterministic step's tolerance against one rank with n_shards = D (each
# gradient's max error relative to its largest entry, floored as phase 6
# floors it: the ranks' sums and K3's scatter run in another order)
MESH_SHAPES, MESH_FIT_EPOCHS, TOL_MESH_GRAD = ((2, 1), (1, 2), (2, 2)), 2, 1e-5
# (d) tensor parallelism runs on the meshes with a model axis; (e)
# per-occurrence feature dropout on this one; a mesh's ranks that have not
# finished after MESH_RANKS_LIMIT_S are killed and the phase fails
OCC_MESH, MESH_RANKS_LIMIT_S = (1, 2), 300


def check_rank_shapes(device) -> dict:
    """Phase 16: K1, K2, K3 and K4 against their plain versions at the
    shapes one rank of a mesh of W = 2 and 4 gives them (8,192 / W edges
    per k, L = 3, 4, 5, bf16; 114,688 / W tokens, n = 3,068) -> the worst
    errors."""
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    names = ["gx", "gln", "gwq", "gwk", "gwv", "gfw", "gfb"]
    for world in (2, 4):
        E = 4 * TRAIN_BATCH // world
        for L in (3, 4, 5):
            x, args = attention_inputs(device, E, L, "bfloat16",
                                       seed=SEED + 60 + world + L)
            y = hyperedge_attention_cuda(x, *args, N_HEAD, True)
            y_ref = hyperedge_attention_plain(x, *args, N_HEAD, True)
            g = torch.randn(x.shape, generator=torch.Generator().manual_seed(
                E + L), dtype=torch.float32).to(device, x.dtype)
            got = hyperedge_attention_bwd_cuda(x, *args, g, N_HEAD, True)
            ref = hyperedge_attention_bwd_plain(x, *args, g, N_HEAD, True)
            torch.cuda.synchronize()
            e1 = float((y.float() - y_ref.float()).abs().max())
            e2 = max(rel_err(a, b) for a, b in zip(got, ref))
            tol = TOL_KERNEL["bfloat16"]
            ok = (torch.allclose(y.float(), y_ref.float(), rtol=tol, atol=tol)
                  and e2 <= TOL_K2["bfloat16"])
            print(f"rank shapes (W={world}): K1 E={E} L={L} max_abs_err="
                  f"{e1:.3e} (tol {tol}), K2 worst rel-to-max {e2:.3e} (tol "
                  f"{TOL_K2['bfloat16']}) {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                fail(f"K1/K2 disagree with their plain versions at E={E}")
            worst["K1"] = max(worst["K1"], e1)
            worst["K2"] = max(worst["K2"], e2)
        T, n = 4 * TRAIN_BATCH * sum(TRAIN_KS) // world, 3_068
        gen = torch.Generator().manual_seed(SEED + 64 + world)
        g = torch.randn((T, DIM), generator=gen).to(device, torch.bfloat16)
        idx = torch.randint(0, n, (T,), generator=gen,
                            dtype=torch.int32).to(device)
        got = ts.scatter_add_cuda(g, idx, n)
        ref = ts.scatter_add_plain(g, idx, n)
        exact = torch.equal(ts.bincount_cuda(idx, n),
                            ts.bincount_plain(idx, n))
        torch.cuda.synchronize()
        e3 = float((got - ref).abs().max())
        ok = torch.allclose(got, ref, rtol=1e-5, atol=1e-5) and exact
        print(f"rank shapes (W={world}): K3 T={T} max_abs_err={e3:.3e} (tol "
              f"1e-05), K4 exact {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"K3/K4 disagree with their plain versions at T={T}")
        worst["K3"] = max(worst["K3"], e3)
    return worst


def check_tp_shapes(device) -> dict:
    """Phase 16 (d): K1 and K2 against their plain versions at the shapes
    one rank of a tensor-parallel mesh gives them: the 8 heads' weights cut
    into M = 2 blocks of 4 heads (block 0 with fc1's bias, block 1 with a
    zero bias, as the model ranks run them), the data row's rows (8,192 / D
    edges per k, D = 1, 2), L = 3, 4, 5, bf16 and f32 -> the worst errors
    per dtype."""
    worst = {dt: {"K1": 0.0, "K2": 0.0} for dt in ("bfloat16", "float32")}
    names = ["gx", "gln", "gwq", "gwk", "gwv", "gfw", "gfb"]
    heads = N_HEAD // 2
    hd = heads * DIM
    for n_data in (1, 2):
        E = 4 * TRAIN_BATCH // n_data
        for L in (3, 4, 5):
            for dt in ("bfloat16", "float32"):
                x, (ln, wq, wk, wv, fw, fb) = attention_inputs(
                    device, E, L, dt, seed=SEED + 80 + n_data + L)
                m = L % 2                         # one block per shape
                cut = [w[:, m * hd:(m + 1) * hd].contiguous()
                       for w in (wq, wk, wv)]
                args = [ln, *cut, fw[m * hd:(m + 1) * hd].contiguous(),
                        fb if m == 0 else torch.zeros_like(fb)]
                y = hyperedge_attention_cuda(x, *args, heads, True)
                y_ref = hyperedge_attention_plain(x, *args, heads, True)
                g = torch.randn(x.shape, generator=torch.Generator()
                                .manual_seed(E + L)).to(device, x.dtype)
                got = hyperedge_attention_bwd_cuda(x, *args, g, heads, True)
                ref = hyperedge_attention_bwd_plain(x, *args, g, heads, True)
                torch.cuda.synchronize()
                e1 = float((y.float() - y_ref.float()).abs().max())
                e2 = max(rel_err(a, b) for a, b in zip(got, ref))
                ok = (torch.allclose(y.float(), y_ref.float(),
                                     rtol=TOL_KERNEL[dt], atol=TOL_KERNEL[dt])
                      and e2 <= TOL_K2[dt])
                print(f"tensor-parallel shapes (D={n_data}, {heads} heads, "
                      f"block {m}): K1 E={E} L={L} {dt} max_abs_err="
                      f"{e1:.3e} (tol {TOL_KERNEL[dt]}), K2 worst "
                      f"rel-to-max {e2:.3e} (tol {TOL_K2[dt]}) "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"K1/K2 at {heads} heads disagree with their plain "
                         f"versions at E={E}, L={L}, {dt}")
                worst[dt]["K1"] = max(worst[dt]["K1"], e1)
                worst[dt]["K2"] = max(worst[dt]["K2"], e2)
    return worst


def mesh_step_inputs(problem, device) -> dict:
    """The deterministic step's fixed inputs: CHECK_BATCH positives per k,
    their negatives sampled once on the card, the recon chromosome."""
    dims, params, frozen, buckets, blooms, table = problem
    gen = torch.Generator().manual_seed(SEED + 61)
    out = {"r": min(5, dims.num_chroms - 1)}
    for k in TRAIN_KS:
        e, w = buckets[k]
        pos = torch.from_numpy(e[:CHECK_BATCH]).to(device)
        neg = sample_negatives(gen, pos, table, 0, blooms[k], neg_num=3)
        out[f"pos{k}"], out[f"w{k}"] = e[:CHECK_BATCH], w[:CHECK_BATCH]
        out[f"neg{k}"] = neg.cpu().numpy()
    return out


def mesh_step(trainer, inp, device, n_data: int, train: bool = False):
    """One step of ``trainer``'s params under its mesh with dropout off on
    the fixed inputs (the per-k forward, weighted BCE + 0.001 recon), the
    rows laid out for n_data shards and the gradients summed over the
    ranks -> (loss, whole gradients on the host; a tensor-parallel
    Trainer's blocks gathered over the model group).  ``train``: train
    mode with a generator (the per-occurrence embedding; the caller turns
    the dropouts off)."""
    xs = {k: shard_concat([torch.from_numpy(inp[f"pos{k}"]).to(device),
                           torch.from_numpy(inp[f"neg{k}"]).to(device)],
                          n_data) for k in TRAIN_KS}
    batch = {k: (torch.from_numpy(inp[f"pos{k}"]).to(device),
                 torch.from_numpy(inp[f"w{k}"]).to(device))
             for k in TRAIN_KS}
    world = 1 if trainer.mesh is None else trainer.mesh.size
    trainer.optimizer.zero_grad(set_to_none=False)
    with using_active_mesh(trainer.mesh):
        logits, recon = forward_buckets(
            trainer.params, trainer.frozen, trainer.dims, xs,
            return_recon=True, attention_mode="per-k",
            recon_chrom=int(inp["r"]), n_shards=n_data, train=train,
            generator=torch.Generator().manual_seed(SEED + 65)
            if train else None)
        bce, _ = _bucket_bce_and_preds(logits, batch,
                                       {k: b[1] for k, b in batch.items()},
                                       n_data)
        loss = bce + 0.001 * recon
        (loss / world).backward()
    trainer._sum_grads()
    axes = trainer._tp_axes or [None] * len(_leaves(trainer.params))
    return float(loss.detach()), [tp_gather(t.grad, a, trainer.mesh)
                                  .float().cpu() for t, a in
                                  zip(_leaves(trainer.params), axes)]


def shipped_settings(**kw) -> TrainSettings:
    """Phase 6's stage-2 settings (the shipped path)."""
    return TrainSettings(alpha=1.0, beta=0.001, neg_num=3, max_trials=8,
                         token_stream="merged", **kw)


def mesh_rank(rank, device, n_data, n_model, tmp, fit, sizes):
    """One rank of a phase-16 mesh (spawned; ``sizes`` overrides this
    module's size constants for a rehearsal and is empty on the card):
    the deterministic f32 step, a warm-up and a timed bf16 epoch of
    TRAIN_STEPS steps with the counts zeroed just before and read just
    after, synchronised steps and gradient all-reduces, and with ``fit``
    the stage-2 fit on the opt-in path with "orbax" checkpoints and a
    resume.  Writes its results to tmp/rank<r>.pt."""
    globals().update(sizes)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    mesh = make_mesh(n_data, n_model)
    genome = hg38_genome()
    problem = train_problem(genome, device)
    dims, params, frozen, buckets, blooms, table = problem
    inp = dict(np.load(os.path.join(tmp, "step_inputs.npz")))
    out = {"rank": rank}
    t32 = Trainer(params, frozen, dims._replace(compute_dtype="float32"),
                  table, shipped_settings(), blooms=blooms, seed=SEED + 1,
                  mesh=mesh)
    out["loss_f32"], out["grads_f32"] = mesh_step(t32, inp, device, n_data)
    del t32

    trainer = Trainer(params, frozen, dims, table, shipped_settings(),
                      blooms=blooms, seed=SEED + 1, mesh=mesh)
    out["frozen_bytes"] = frozen_nbytes(trainer.frozen)
    batcher = BucketedBatcher(buckets, TRAIN_BATCH, TRAIN_STEPS, seed=SEED)
    if not trainer.pin_base_buckets(batcher):
        fail("the buckets do not fit the pin budget")
    out["warm"] = trainer.train_epoch_indexed(batcher)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    out["timed"] = trainer.train_epoch_indexed(batcher)
    out["counts"] = launch_counts()
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else 0
    out["params"] = [t.detach().cpu() for t in _leaves(trainer.params)]
    idx = np.random.default_rng(SEED + 5).permutation(
        len(buckets[2][0]))[:TRAIN_BATCH]
    batch = {k: (e[torch.as_tensor(idx, device=e.device)],
                 w[torch.as_tensor(idx, device=e.device)])
             for k, (e, w) in trainer._pinned.items()}
    steps, reduces = [], []
    for _ in range(6):
        torch.distributed.barrier()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        sync()
        steps.append((time.perf_counter() - t0) * 1e3)
    for _ in range(10):
        torch.distributed.barrier()
        t0 = time.perf_counter()
        trainer._sum_grads()
        sync()
        reduces.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"], out["all_reduce_ms"] = steps, reduces
    out["grad_bytes"] = sum(t.numel() * 4 for t in _leaves(trainer.params))
    del trainer
    if n_model > 1:
        out["tp"] = tp_rank(mesh, device, n_data, problem, inp, batch)
    if (n_data, n_model) == OCC_MESH:
        out["occ"] = occ_rank(mesh, device, n_data, problem, inp)
    if fit:
        out["fit"] = mesh_fit(rank, mesh, genome, dims, params, frozen,
                              buckets, blooms, table, tmp)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def timed_epoch(trainer, buckets, on_card: bool) -> dict:
    """A warm-up and a timed epoch of TRAIN_STEPS indexed steps, the counts
    zeroed just before the timed one and read just after, and the peak
    memory over it."""
    batcher = BucketedBatcher(buckets, TRAIN_BATCH, TRAIN_STEPS, seed=SEED)
    if not trainer.pin_base_buckets(batcher):
        fail("the buckets do not fit the pin budget")
    warm = trainer.train_epoch_indexed(batcher)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    timed = trainer.train_epoch_indexed(batcher)
    return {"warm": warm, "timed": timed, "counts": launch_counts(),
            "peak_bytes": torch.cuda.max_memory_allocated() if on_card
            else 0}


def attention_collectives_ms(mesh, device, n=10) -> list:
    """Phase 16 (d): the attention's collectives of one tensor-parallel
    step alone, synchronised: for each k the rank's rows (bf16) gathered
    over its data row and reduce-scattered back, forward and backward (the
    backward's all-gather and reduce-scatter) -> ms per step, n times."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    xs = []
    for k in TRAIN_KS:
        rows = 4 * TRAIN_BATCH
        lo, hi = rank_rows(rows, mesh)
        xs.append((torch.randn((hi - lo, k, DIM), device=device).to(
            torch.bfloat16).requires_grad_(True),
            model_group_rows([rows], mesh)))
    out = []
    for _ in range(n + 2):
        torch.distributed.barrier()
        t0 = time.perf_counter()
        for x, sizes in xs:
            y = reduce_scatter_blocks(all_gather_blocks(
                x, sizes, mesh.model_group), sizes, mesh.model_group)
            y.float().sum().backward()
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out[2:]


def tp_rank(mesh, device, n_data, problem, inp, batch) -> dict:
    """Phase 16 (d), one rank of a mesh with a model axis, tensor-parallel
    (the attention weights' heads on the model axis): the f32 step on the
    fixed inputs (its whole gradients), a warm-up and a timed bf16 epoch
    (counts, peak memory, this rank's blocks and the whole params), the
    synchronised steps and the attention's collectives per step."""
    dims, params, frozen, buckets, blooms, table = problem
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t32 = Trainer(params, frozen, dims._replace(compute_dtype="float32"),
                  table, shipped_settings(), blooms=blooms, seed=SEED + 1,
                  mesh=mesh, tensor_parallel=True)
    out = {}
    out["loss_f32"], out["grads_f32"] = mesh_step(t32, inp, device, n_data)
    del t32
    trainer = Trainer(params, frozen, dims, table, shipped_settings(),
                      blooms=blooms, seed=SEED + 1, mesh=mesh,
                      tensor_parallel=True)
    out.update(timed_epoch(trainer, buckets, on_card))
    out["params"] = [t.detach().cpu() for t in _leaves(trainer.params)]
    out["whole"] = [t.detach().cpu()
                    for t in _leaves(trainer.whole_params())]
    out["held_shapes"] = [tuple(t.shape) for t in _leaves(trainer.params)]
    steps = []
    for _ in range(6):
        torch.distributed.barrier()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        sync()
        steps.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = steps
    out["collectives_ms"] = attention_collectives_ms(mesh, device)
    return out


def occ_rank(mesh, device, n_data, problem, inp) -> dict:
    """Phase 16 (e), one rank of OCC_MESH with per-occurrence feature
    dropout: a warm-up and a timed bf16 epoch (counts, peak memory, the
    params), and the f32 step in train mode with the feature dropout at
    rate 0 and the other dropouts the identity (its whole gradients)."""
    dims, params, frozen, buckets, blooms, table = problem
    occ = dims._replace(feature_dropout_mode="per_occurrence")
    trainer = Trainer(params, frozen, occ, table, shipped_settings(),
                      blooms=blooms, seed=SEED + 52, mesh=mesh)
    out = timed_epoch(trainer, buckets, device.type == "cuda")
    out["params"] = [t.detach().cpu() for t in _leaves(trainer.params)]
    del trainer
    f32 = occ._replace(compute_dtype="float32", feature_dropout=0.0)
    t32 = Trainer(params, frozen, f32, table, shipped_settings(),
                  blooms=blooms, seed=SEED + 1, mesh=mesh)
    with unittest.mock.patch.object(modules, "dropout", identity_dropout):
        out["loss_f32"], out["grads_f32"] = mesh_step(t32, inp, device,
                                                      n_data, train=True)
    return out


def mesh_fit(rank, mesh, genome, dims, params, frozen, buckets, blooms,
             table, tmp) -> dict:
    """Phase 16 (c): a stage-2 fit of MESH_FIT_EPOCHS epochs on the mesh
    with the fused tail and the "pallas" proposals (K5, K6 on every rank)
    and "orbax" checkpoints, the counts zeroed just before and read just
    after; then a fresh Trainer resumes from its resume directory for one
    more epoch."""
    set_fuse_tail(True)
    settings = shipped_settings(propose_impl="pallas")
    test = random_buckets(genome, np.random.default_rng(SEED + 62),
                          TEST_PER_K)
    log = print if rank == 0 else (lambda *a, **k: None)
    kw = dict(batch_size=TRAIN_BATCH, num_batch_per_iter=TRAIN_STEPS,
              checkpoint_path=os.path.join(tmp, "best"),
              resume_path=os.path.join(tmp, "resume"),
              checkpoint_format="orbax", log=log, seed=SEED)
    trainer = Trainer(params, frozen, dims, table, settings, blooms=blooms,
                      seed=SEED + 63, mesh=mesh)
    zero_launch_counts()
    t0 = time.perf_counter()
    hist = trainer.fit(buckets, test, epochs=MESH_FIT_EPOCHS, **kw)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    again = Trainer(params, frozen, dims, table, settings, blooms=blooms,
                    seed=SEED + 63, mesh=mesh)
    more = again.fit(buckets, test, epochs=MESH_FIT_EPOCHS + 1, resume=True,
                     **kw)
    set_fuse_tail(False)
    pick = lambda h: {"bce": h["train"]["bce"], "recon": h["train"]["recon"],
                      "valid_bce": h["valid"]["bce"]}
    return {"counts": counts, "wall_s": wall,
            "history": [pick(h) for h in hist],
            "resumed": [pick(h) for h in more],
            "params": [t.detach().cpu() for t in _leaves(trainer.params)]}


def world_of_one_phase(problem, card) -> dict:
    """Phase 16 (a): a world of one on NCCL through init_distributed (the
    launcher's environment, set here), a 1 x 1 mesh: its step equals the
    no-mesh step on the same draws bit for bit (the mesh's gradient
    all-reduce runs on NCCL), and an OrbaxCheckpointer round trip of its
    params, AdamW state and generator gives the same bits."""
    dims, params, frozen, buckets, blooms, table = problem
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
           "RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1"}
    os.environ.update(env)
    try:
        init_distributed()
        backend = str(torch.distributed.get_backend())
        mesh = make_mesh(1, 1)
        batch = {k: (torch.from_numpy(e[:TRAIN_BATCH]).cuda(),
                     torch.from_numpy(w[:TRAIN_BATCH]).cuda())
                 for k, (e, w) in buckets.items()}
        runs = {}
        for name, m in (("no_mesh", None), ("mesh_1x1", mesh)):
            t = Trainer(params, frozen, dims, table, shipped_settings(),
                        blooms=blooms, seed=SEED + 70, mesh=m)
            zero_launch_counts()
            aux = t.train_step(batch)
            torch.cuda.synchronize()
            runs[name] = (t, aux, launch_counts())
        (ta, aa, ca), (tb, ab, cb) = runs["no_mesh"], runs["mesh_1x1"]
        equal = (all(torch.equal(a, b) for a, b in
                     zip(_leaves(ta.params), _leaves(tb.params)))
                 and all(torch.equal(aa[k], ab[k]) for k in aa))
        with tempfile.TemporaryDirectory() as tmp:
            opt = runtime._adamw_state(tb.params, tb.optimizer)
            key = tb.generator.get_state().numpy()
            with OrbaxCheckpointer(tmp) as ck:
                ck.save(0, tb.params, opt, epoch=0, key=key, best=0.5)
                p, o, ep = ck.restore(like_params=tb.params,
                                      like_opt_state=opt)
                meta = ck.last_meta
        round_trip = (ep == 0 and meta["best"] == 0.5
                      and np.array_equal(np.asarray(meta["key"], np.uint8),
                                         key)
                      and all(torch.equal(a, b) for a, b in
                              zip(_leaves(tb.params), _leaves(p)))
                      and all(np.array_equal(np.asarray(a), np.asarray(b))
                              for a, b in zip(opt["exp_avg"] + opt["exp_avg_sq"],
                                              o["exp_avg"] + o["exp_avg_sq"])))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for name in env:
            os.environ.pop(name, None)
    out = {"backend": backend, "step_bit_equal": equal,
           "launches_no_mesh": ca, "launches_mesh_1x1": cb,
           "orbax_round_trip": round_trip}
    print(f"world of one ({backend}), mesh 1x1: {json.dumps(out)}",
          flush=True)
    if "nccl" not in backend:
        fail("the world of one did not take NCCL")
    if not equal or ca != cb:
        fail("the 1x1 mesh's step differs from the no-mesh step")
    if not round_trip:
        fail("the OrbaxCheckpointer round trip lost bits")
    return out


def grad_errors(got, ref, names) -> dict:
    """Each gradient's max error relative to its largest entry, floored at
    1e-3 of the largest entry of any gradient (as phase 6)."""
    top = max(float(b.abs().max()) for b in ref)
    return {n: float((a - b).abs().max()) / max(float(b.abs().max()),
                                                1e-3 * top)
            for n, a, b in zip(names, got, ref)}


def mesh_phase(problem, genome, card, sizes=None,
               device=torch.device("cuda")) -> dict:
    """Phase 16: (a) the world of one on NCCL; (b) the meshes 2 x 1, 1 x 2
    and 2 x 2 of ranks sharing the card on gloo: each rank's launches per
    step, the deterministic f32 step against one rank with n_shards = D,
    a bf16 epoch's params equal across the ranks, the step and all-reduce
    times, the frozen tables' bytes and the peak memory per rank; (c) the
    2 x 1 mesh's stage-2 fit on the opt-in path, "orbax" checkpoints and a
    resume; (d) on the meshes with a model axis, tensor parallelism
    (``tp_check``); (e) on OCC_MESH, per-occurrence feature dropout
    (``occ_check``).  ``sizes`` and ``device``: a rehearsal's smaller
    constants (passed to the ranks) and its device."""
    sizes = sizes or {}
    out = {"world_of_one": world_of_one_phase(problem, card)}
    dims, params, frozen, buckets, blooms, table = problem
    inp = mesh_step_inputs(problem, device)
    names = leaf_names(params)
    refs = {}
    for n_data in sorted({d for d, _ in MESH_SHAPES}):
        t = Trainer(params, frozen, dims._replace(compute_dtype="float32"),
                    table, shipped_settings(n_shards=n_data), blooms=blooms,
                    seed=SEED + 1)
        refs[n_data] = mesh_step(t, inp, device, n_data)
        whole = frozen_nbytes(t.frozen)      # one rank's, as a Trainer holds
        del t
    # (e)'s reference: one rank with n_shards = D, per-occurrence at rate 0
    occ32 = dims._replace(compute_dtype="float32",
                          feature_dropout_mode="per_occurrence",
                          feature_dropout=0.0)
    t = Trainer(params, frozen, occ32, table,
                shipped_settings(n_shards=OCC_MESH[0]), blooms=blooms,
                seed=SEED + 1)
    with unittest.mock.patch.object(modules, "dropout", identity_dropout):
        refs["occ"] = mesh_step(t, inp, device, OCC_MESH[0], train=True)
    del t
    want_step = {k: v * TRAIN_STEPS for k, v in
                 step_counts(False, False).items()}
    for n_data, n_model in MESH_SHAPES:
        world = n_data * n_model
        fit = (n_data, n_model) == (2, 1)
        with tempfile.TemporaryDirectory() as tmp:
            np.savez(os.path.join(tmp, "step_inputs.npz"), **inp)
            t0 = time.perf_counter()
            try:
                ctx = spawn(mesh_rank, world, n_data, n_model, tmp, fit,
                            sizes, backend="gloo", device=device.type,
                            join=False)
                while not ctx.join(timeout=5):
                    if time.perf_counter() - t0 > MESH_RANKS_LIMIT_S:
                        for proc in ctx.processes:
                            proc.kill()
                        fail(f"the {n_data}x{n_model} mesh's ranks did not "
                             f"finish within {MESH_RANKS_LIMIT_S} s")
            except Exception as e:          # noqa: BLE001 - a rank failed
                fail(f"a rank of the {n_data}x{n_model} mesh failed: {e}")
            wall = time.perf_counter() - t0
            ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                                weights_only=False) for r in range(world)]
        ref_loss, ref_grads = refs[n_data]
        cell = {"ranks": world, "wall_s": wall,
                "loss_f32_rel_err": max(abs(r["loss_f32"] - ref_loss)
                                        / abs(ref_loss) for r in ranks)}
        errs = [grad_errors(r["grads_f32"], ref_grads, names) for r in ranks]
        worst = max(max(e.values()) for e in errs)
        cell["grad_rel_to_max_err_f32"] = worst
        cell["launches_per_rank_epoch"] = [r["counts"] for r in ranks]
        cell["step_ms_per_rank"] = [statistics.median(r["step_ms"])
                                    for r in ranks]
        cell["all_reduce_ms_per_rank"] = [statistics.median(r["all_reduce_ms"])
                                          for r in ranks]
        cell["all_reduce_note"] = ("gloo through the host, one card; not an "
                                   "NCCL number")
        cell["grad_bytes"] = ranks[0]["grad_bytes"]
        cell["frozen_bytes_per_rank"] = [r["frozen_bytes"] for r in ranks]
        cell["frozen_bytes_unsharded"] = whole
        cell["peak_memory_gb_per_rank"] = [r["peak_bytes"] / 1e9
                                           for r in ranks]
        cell["timed_epoch"] = {k: ranks[0]["timed"][k] for k in
                               ("bce", "recon", "elapsed",
                                "hyperedges_per_sec")}
        same_params = all(torch.equal(a, b) for r in ranks[1:]
                          for a, b in zip(r["params"], ranks[0]["params"]))
        finite = all(np.isfinite(r[e][k]) for r in ranks
                     for e in ("warm", "timed") for k in ("bce", "recon"))
        cell["params_equal_across_ranks"] = same_params
        print(f"mesh {n_data}x{n_model}: {json.dumps(cell)} (expected "
              f"launches per rank {want_step}, K7 once more per round; "
              f"grad tol {TOL_MESH_GRAD})",
              flush=True)
        if not all(counts_match(r["counts"], want_step) for r in ranks):
            fail(f"a rank of the {n_data}x{n_model} mesh launched other "
                 "counts")
        if not worst <= TOL_MESH_GRAD or not cell["loss_f32_rel_err"] <= \
                TOL_MESH_GRAD:
            fail(f"the {n_data}x{n_model} mesh's step differs from one rank "
                 f"with n_shards = {n_data}")
        if not (same_params and finite):
            fail(f"the {n_data}x{n_model} mesh's epoch is not finite or its "
                 "ranks' params differ")
        if n_model > 1 and not all(
                b < cell["frozen_bytes_unsharded"]
                for b in cell["frozen_bytes_per_rank"]):
            fail("the model axis did not shard the frozen tables")
        if fit:
            cell["fit"] = mesh_fit_check(ranks)
        if n_model > 1:
            cell["tp"] = tp_check(ranks, cell, n_data, n_model, names,
                                  want_step)
        if (n_data, n_model) == OCC_MESH:
            cell["per_occurrence"] = occ_check(ranks, refs["occ"], names,
                                               want_step)
        out[f"{n_data}x{n_model}"] = cell
    print(json.dumps({"metric": "mesh_training", **out, "card": card}),
          flush=True)
    return out


def tp_check(ranks, dp, n_data, n_model, names, want_step) -> dict:
    """Phase 16 (d)'s checks on the ranks' results: each rank's f32
    tensor-parallel step against the data-parallel step on the same mesh
    (TOL_MESH_GRAD of each gradient's max), the launches of the timed
    epoch (as the data-parallel step's), finite losses, the whole params
    equal on every rank and each rank's blocks equal across its data group
    (the ranks of one model index); beside the data-parallel mesh's, the
    synchronised step, the attention's collectives per step and the peak
    memory per rank."""
    tps = [r["tp"] for r in ranks]
    errs = [grad_errors(t["grads_f32"], r["grads_f32"], names)
            for t, r in zip(tps, ranks)]
    worst = max(max(e.values()) for e in errs)
    loss_err = max(abs(t["loss_f32"] - r["loss_f32"]) / abs(r["loss_f32"])
                   for t, r in zip(tps, ranks))
    blocks = all(torch.equal(a, b) for i, t in enumerate(tps)
                 for a, b in zip(t["params"], tps[i % n_model]["params"]))
    whole = all(torch.equal(a, b) for t in tps[1:]
                for a, b in zip(t["whole"], tps[0]["whole"]))
    sharded = sum(a != b for a, b in zip(tps[0]["held_shapes"],
                                         [tuple(w.shape) for w in
                                          tps[0]["whole"]]))
    finite = all(np.isfinite(t[e][k]) for t in tps
                 for e in ("warm", "timed") for k in ("bce", "recon"))
    out = {"grad_rel_to_max_err_f32_vs_dp": worst,
           "loss_f32_rel_err_vs_dp": loss_err,
           "launches_per_rank_epoch": [t["counts"] for t in tps],
           "sharded_leaves": sharded,
           "step_ms_per_rank": [statistics.median(t["step_ms"]) for t in tps],
           "dp_step_ms_per_rank": dp["step_ms_per_rank"],
           "attention_collectives_ms_per_rank_step": [
               statistics.median(t["collectives_ms"]) for t in tps],
           "collectives_note": ("gloo through the host, one card; not an "
                                "NCCL number"),
           "peak_memory_gb_per_rank": [t["peak_bytes"] / 1e9 for t in tps],
           "dp_peak_memory_gb_per_rank": dp["peak_memory_gb_per_rank"],
           "timed_epoch": {k: tps[0]["timed"][k] for k in
                           ("bce", "recon", "elapsed",
                            "hyperedges_per_sec")},
           "blocks_equal_across_data_groups": blocks,
           "whole_params_equal_across_ranks": whole}
    print(f"mesh {n_data}x{n_model} tensor-parallel: {json.dumps(out)} "
          f"(expected launches per rank {want_step}, K7 once more per "
          f"round; grad tol "
          f"{TOL_MESH_GRAD})", flush=True)
    if not all(counts_match(t["counts"], want_step) for t in tps):
        fail(f"a rank of the tensor-parallel {n_data}x{n_model} mesh "
             "launched other counts")
    if not worst <= TOL_MESH_GRAD or not loss_err <= TOL_MESH_GRAD:
        fail(f"the tensor-parallel {n_data}x{n_model} step differs from the "
             "data-parallel one")
    if not (blocks and whole and finite and sharded == 4):
        fail(f"the tensor-parallel {n_data}x{n_model} epoch is not finite, "
             "its ranks' params differ, or the heads were not sharded")
    return out


def occ_check(ranks, ref, names, want_step) -> dict:
    """Phase 16 (e)'s checks on the ranks' results: the launches of the
    per-occurrence epoch (no K3 or K4), finite losses, the params equal on
    every rank, and the f32 step at rate 0 against one rank with n_shards
    = D (TOL_MESH_GRAD of each gradient's max); the peak memory per
    rank."""
    occ = [r["occ"] for r in ranks]
    want = {**want_step, "K3": 0, "K4": 0, "K8_bwd": 0, "K8_keep": 0}
    ref_loss, ref_grads = ref
    worst = max(max(grad_errors(o["grads_f32"], ref_grads, names).values())
                for o in occ)
    loss_err = max(abs(o["loss_f32"] - ref_loss) / abs(ref_loss) for o in occ)
    same = all(torch.equal(a, b) for o in occ[1:]
               for a, b in zip(o["params"], occ[0]["params"]))
    finite = all(np.isfinite(o[e][k]) for o in occ
                 for e in ("warm", "timed") for k in ("bce", "recon"))
    out = {"launches_per_rank_epoch": [o["counts"] for o in occ],
           "grad_rel_to_max_err_f32": worst, "loss_f32_rel_err": loss_err,
           "peak_memory_gb_per_rank": [o["peak_bytes"] / 1e9 for o in occ],
           "timed_epoch": {k: occ[0]["timed"][k] for k in
                           ("bce", "recon", "elapsed",
                            "hyperedges_per_sec")},
           "params_equal_across_ranks": same}
    print(f"mesh {OCC_MESH[0]}x{OCC_MESH[1]} per-occurrence: "
          f"{json.dumps(out)} (expected launches per rank {want}, K7 once "
          f"more per round; grad tol {TOL_MESH_GRAD})", flush=True)
    if not all(counts_match(o["counts"], want) for o in occ):
        fail("a rank of the per-occurrence mesh launched other counts")
    if not worst <= TOL_MESH_GRAD or not loss_err <= TOL_MESH_GRAD:
        fail("the per-occurrence mesh step differs from one rank with "
             "n_shards = D")
    if not (same and finite):
        fail("the per-occurrence mesh epoch is not finite or its ranks' "
             "params differ")
    return out


def mesh_fit_check(ranks) -> dict:
    """Phase 16 (c)'s checks on the ranks' results: the counts of every
    rank, finite histories, params equal across the ranks, the resume ran
    the one remaining epoch."""
    n_eval = EVAL_SAMPLES // TRAIN_BATCH
    want = with_encodes(added(scaled(step_counts(True, True),
                                     MESH_FIT_EPOCHS * TRAIN_STEPS),
                              scaled(eval_counts(True),
                                     MESH_FIT_EPOCHS * n_eval)),
                        MESH_FIT_EPOCHS)
    fits = [r["fit"] for r in ranks]
    out = {"launches_per_rank": [f["counts"] for f in fits],
           "expected": want, "wall_s": [f["wall_s"] for f in fits],
           "history": fits[0]["history"], "resumed": fits[0]["resumed"]}
    print(f"mesh 2x1 fit (fused tail, pallas, orbax): {json.dumps(out)}",
          flush=True)
    if not all(counts_match(f["counts"], want) for f in fits):
        fail("a rank of the mesh's fit launched other counts")
    if any(len(f["history"]) != MESH_FIT_EPOCHS or len(f["resumed"]) != 1
           for f in fits):
        fail("the mesh's fit or its resume ran other epochs")
    if not all(np.isfinite(v) for f in fits for h in f["history"] +
               f["resumed"] for v in h.values()):
        fail("the mesh's fit lost finiteness")
    if not all(torch.equal(a, b) for f in fits[1:]
               for a, b in zip(f["params"], fits[0]["params"])):
        fail("the mesh's fit left the ranks with other params")
    return out


# ------------------------------------------------------------- phase 17
# 100 kb all-genome: hg38 chr1-22 + chrX at 100,000 bp (30,344 nodes), the
# configuration of the JAX package's scripts/bench_100kb.py; epochs of 10
# steps (a user's ~1,000), three timed device-resident epochs, a fit of two
# epochs with eval over 2,048 test rows per k
RES_100KB, STEPS_100KB, TIMED_EPOCHS_100KB = 100_000, 10, 3
FIT_EPOCHS_100KB, TEST_PER_K_100KB, NODES_100KB = 2, 2_048, 30_344


def frozen_100kb_host(genome, seed=SEED):
    """scripts/bench_100kb.py:build_frozen_synthetic's tables as host f32
    arrays, drawn from one generator in its order: per chromosome a normal
    (w, w) block made symmetric and scaled by 1/sqrt(w), then a normal
    (N + 1, N) inter table; the one-hot chromosome + coordinate
    attributes.  Streamed per chromosome: no (N x N) f64 array."""
    rng = np.random.default_rng(seed)
    n = genome.num_nodes
    feats = []
    for c in range(genome.num_chroms):
        s, e = genome.chrom_range[c]
        w = e - s
        block = rng.standard_normal((w, w), dtype=np.float32)
        feats.append(((block + block.T) / np.sqrt(w)).astype(np.float32))
    inter = rng.standard_normal((n + 1, n), dtype=np.float32)
    attr = np.zeros((n + 1, genome.num_chroms + 1), np.float32)
    for c in range(genome.num_chroms):
        s, e = genome.chrom_range[c]
        attr[s:e, c] = 1.0
        attr[s:e, -1] = np.arange(e - s) / genome.bins_per_chrom[0]
    return feats, attr, inter


def frozen_on(host, genome, device, dtype):
    """The host tables of ``frozen_100kb_host`` on ``device``: features and
    inter_z in ``dtype``, as bench_100kb.py places them."""
    feats, attr, inter = host
    return hs.FrozenTables(
        features=tuple(torch.from_numpy(f).to(device, dtype) for f in feats),
        attr_table=torch.from_numpy(attr).to(device),
        inter_z=torch.from_numpy(inter).to(device, dtype),
        chrom_of_node=torch.from_numpy(
            genome.node2chrom.astype(np.int32)).to(device),
        chrom_bounds=torch.from_numpy(
            genome.chrom_range.astype(np.int32)).to(device))


def same_epoch_check(trainer) -> dict:
    """The device epoch is the indexed epoch's program on the rows drawn on
    the card: from saved params, AdamW state and generator state, one
    ``train_epoch_device``; then the same state restored, the permutations
    redrawn by hand (per k in sorted order a seed from the generator, a
    generator on the card, randperm cut to (steps, batch)) and
    ``_launch_epoch`` on those rows.  Both must be bit-equal."""
    params = [t.detach().clone() for t in _leaves(trainer.params)]
    opt = copy.deepcopy(trainer.optimizer.state_dict())
    state = trainer.generator.get_state()
    got = trainer.train_epoch_device()
    got_params = [t.detach().clone() for t in _leaves(trainer.params)]
    with torch.no_grad():
        for t, v in zip(_leaves(trainer.params), params):
            t.copy_(v)
    trainer.optimizer.load_state_dict(opt)
    trainer.generator.set_state(state)
    steps, batch = trainer._dev_shape
    stacked = {}
    for k in sorted(trainer._dev_buckets):
        e, w = trainer._dev_buckets[k]
        seed = int(torch.randint(0, 2 ** 62, (1,),
                                 generator=trainer.generator))
        gen = torch.Generator(device=e.device).manual_seed(seed)
        idx = torch.randperm(len(e), generator=gen, device=e.device)[
            :steps * batch].view(steps, batch)
        stacked[k] = (e[idx], w[idx])
    want = trainer._finish_indexed(trainer._launch_epoch(stacked))
    keys = ("bce", "recon", "metrics", "fallback_bloom_rate",
            "fallback_orig_rate")
    out = {"results_equal": all(got[k] == want[k] for k in keys),
           "params_equal": all(torch.equal(a, b) for a, b in
                               zip(got_params, _leaves(trainer.params)))}
    print(f"100 kb device epoch vs _launch_epoch on its rows: "
          f"{json.dumps(out)}", flush=True)
    if not all(out.values()):
        fail("the device-resident epoch differs from the indexed epoch on "
             "the same rows")
    return out


def hundred_kb_phase(card, device=torch.device("cuda")) -> dict:
    """Phase 17: the 100 kb all-genome configuration at full width on the
    shipped path (``resolve_perf`` on the card): (a) device-resident epochs
    (prepare_device_epochs, a warm-up epoch, three timed epochs with their
    launches pinned, the same-rows check), the card's f32 step against the
    CPU's, a profiled step, the memory around the Trainer's inter_z pad,
    and K1-K4 at this configuration's shapes; (b) Trainer.fit with
    device_epochs="on": 2 epochs of 10 steps with eval, a checkpoint and the
    embedding export.  -> launches and times for the kernels line."""
    t_phase = time.perf_counter()
    genome = GenomeBins(HG38_NAMES, HG38, RES_100KB)
    n = genome.num_nodes
    if n != NODES_100KB:
        fail(f"hg38 at 100 kb has {n} bins, expected {NODES_100KB}")
    hs._FUSE_TAIL = None          # resolve_perf sets the gate anew
    perf = resolve_perf(Config(), "cuda")
    shipped = {"compute_dtype": "bfloat16", "token_stream": "merged",
               "propose_impl": "xla", "fuse_tail": "off"}
    if any(perf[k] != v for k, v in shipped.items()):
        fail(f"resolve_perf on the card gave {perf}, expected {shipped}")
    dims = ModelDims(dim=DIM, n_head=N_HEAD, num_chroms=genome.num_chroms,
                     num_nodes=n, compute_dtype=perf["compute_dtype"],
                     use_pallas_attention=True)
    params = init_model(torch.Generator().manual_seed(SEED), dims,
                        [int(e - s) for s, e in genome.chrom_range],
                        device=device)
    t0 = time.perf_counter()
    host = frozen_100kb_host(genome)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frozen = frozen_on(host, genome, device, torch.bfloat16)
    torch.cuda.synchronize()
    transfer_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    buckets = {}
    for k in TRAIN_KS:
        e = np.sort(rng.choice(np.arange(1, n + 1), (4 * TRAIN_BATCH, k)),
                    axis=1)
        e = e[(np.diff(e, axis=1) > 0).all(axis=1)]
        buckets[k] = (e.astype(np.int32),
                      rng.random(len(e)).astype(np.float32) + 0.5)
    t0 = time.perf_counter()
    blooms = build_bloom_dict({k: v[0] for k, v in buckets.items()},
                              device=device)
    torch.cuda.synchronize()
    bloom_s = time.perf_counter() - t0
    settings = TrainSettings(alpha=1.0, beta=0.001,
                             token_stream=perf["token_stream"],
                             propose_impl=perf["propose_impl"])
    table = ChromTable.from_genome(genome, device=device)
    gb = 1e9
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(params, frozen, dims, table, settings, blooms=blooms,
                      seed=SEED)
    torch.cuda.synchronize()
    memory = {"held_before_trainer_gb": held / gb,
              "peak_during_trainer_gb": torch.cuda.max_memory_allocated()
              / gb,
              "held_after_trainer_gb": torch.cuda.memory_allocated() / gb}
    if trainer.frozen.inter_z.data_ptr() != frozen.inter_z.data_ptr():
        fail("100 kb: the Trainer copied the caller's inter_z")
    del frozen                 # the Trainer holds the same tables
    memory["inter_z_gb"] = host[2].size * 2 / gb
    print(f"100 kb set-up: {n} nodes, buckets "
          f"{ {k: len(v[0]) for k, v in buckets.items()} }, frozen build "
          f"{build_s:.3f} s (host f32), transfer {transfer_s:.3f} s (bf16), "
          f"Bloom filters {bloom_s:.3f} s; memory {json.dumps(memory)}",
          flush=True)

    # (a) device-resident epochs
    t0 = time.perf_counter()
    trainer.prepare_device_epochs(buckets, TRAIN_BATCH, STEPS_100KB)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = trainer.train_epoch_device()
    warm_s = time.perf_counter() - t0
    before = [t.detach().clone() for t in _leaves(trainer.params)]
    torch.cuda.reset_peak_memory_stats()
    timed = []
    for i in range(TIMED_EPOCHS_100KB):
        zero_launch_counts()
        timed.append(trainer.train_epoch_device())
        counts = launch_counts()
        check_counts(counts, STEPS_100KB, f"100 kb device epoch {i + 1}")
    memory["peak_timed_epochs_gb"] = torch.cuda.max_memory_allocated() / gb
    for res in [warm] + timed:
        if not (np.isfinite(res["bce"]) and np.isfinite(res["recon"])):
            fail(f"100 kb epoch losses are not finite: {res}")
    moved = sum(not torch.equal(a, b)
                for a, b in zip(before, _leaves(trainer.params)))
    if moved != len(before):
        fail(f"100 kb: only {moved} of {len(before)} parameters changed")
    step_ms = [r["elapsed"] / STEPS_100KB * 1e3 for r in timed]
    rates = [r["hyperedges_per_sec"] for r in timed]
    same_rows = same_epoch_check(trainer)

    # the card's f32 step against the CPU's, on f32 tables on both sides
    f32 = frozen_on(host, genome, device, torch.float32)
    view = types.SimpleNamespace(params=trainer.params, frozen=f32,
                                 dims=trainer.dims,
                                 chrom_table=trainer.chrom_table,
                                 blooms=trainer.blooms)
    t0 = time.perf_counter()
    step_check = check_deterministic_step(view, buckets, device,
                                          what="100 kb deterministic step")
    check_s = time.perf_counter() - t0
    del f32, view
    host = None

    batch = {k: (e[:TRAIN_BATCH], w[:TRAIN_BATCH])
             for k, (e, w) in trainer._dev_buckets.items()}
    synced = []
    for _ in range(10):
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        synced.append((time.perf_counter() - t0) * 1e3)
    trace = device_profile(lambda: trainer.train_step(batch))
    kernels = time_table_kernels(device, 4 * TRAIN_BATCH * sum(TRAIN_KS),
                                 n + 1, ("uniform",))
    kernels.update(time_attention_kernels(device))

    # (b) Trainer.fit with device_epochs="on"
    test = {k: (e[:TEST_PER_K_100KB], w[:TEST_PER_K_100KB])
            for k, (e, w) in buckets.items()}
    marks = []
    launch = trainer.train_epoch_indexed_launch

    def marked_launch(batcher):
        marks.append(time.perf_counter())
        return launch(batcher)
    trainer.train_epoch_indexed_launch = marked_launch
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "model.chkpt")
        emb_path = os.path.join(tmp, "embeddings.npy")
        zero_launch_counts()
        t0 = time.perf_counter()
        hist = trainer.fit(
            buckets, test, epochs=FIT_EPOCHS_100KB, batch_size=TRAIN_BATCH,
            num_batch_per_iter=STEPS_100KB, checkpoint_path=ckpt,
            embeddings_path=emb_path, seed=3, device_epochs="on",
            log=lambda m: print(f"100 kb fit: {m}", flush=True))
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        fit_counts = launch_counts()
        emb = np.load(emb_path)
        saved = load_checkpoint(ckpt, device="cpu")
    del trainer.train_epoch_indexed_launch
    eval_batches = (len(TRAIN_KS) * TEST_PER_K_100KB) // TRAIN_BATCH
    want = with_rounds(with_encodes(added(
        scaled(step_counts(False, False), FIT_EPOCHS_100KB * STEPS_100KB),
        scaled(eval_counts(False), FIT_EPOCHS_100KB * eval_batches)),
        2 * FIT_EPOCHS_100KB), fit_counts)
    print(f"100 kb fit launches {fit_counts} (expected {want})", flush=True)
    if fit_counts != want:
        fail(f"the 100 kb fit launched {fit_counts}, expected {want}")
    if emb.shape != (n, DIM) or not np.isfinite(emb).all():
        fail(f"100 kb embeddings: shape {emb.shape}, finite "
             f"{bool(np.isfinite(emb).all())}")
    if len(_leaves(saved)) != len(_leaves(trainer.params)):
        fail("the 100 kb checkpoint does not hold the param tree")
    for h in hist:
        if not np.isfinite(h["train"]["bce"]):
            fail(f"100 kb fit losses are not finite: {h['train']}")
    walls = [b - a for a, b in zip(marks, marks[1:] + [t_end])]
    fit = {"epoch_wall_s": walls,
           "train_s": [h["train"]["elapsed"] for h in hist],
           "train_hyperedges_per_s": [h["train"]["hyperedges_per_sec"]
                                      for h in hist],
           "valid_auprc": [h["valid"]["metrics"].get(max(TRAIN_KS), {})
                           .get("auprc") for h in hist],
           "fit_s": t_end - t0, "launches": fit_counts,
           "embeddings_shape": list(emb.shape)}
    wall = time.perf_counter() - t_phase
    metrics = {
        "metric": "train_step_hyperedges_per_s_100kb",
        "value": statistics.median(rates), "nodes": n,
        "hyperedges_per_s_epochs": rates,
        "median_step_ms": statistics.median(step_ms),
        "step_ms_epochs": step_ms,
        "median_step_ms_synced": statistics.median(synced),
        "prepare_s": prepare_s, "warmup_epoch_s": warm_s,
        "frozen_build_s": build_s, "frozen_transfer_s": transfer_s,
        "bloom_build_s": bloom_s, "memory": memory,
        "launches_per_epoch": counts, "same_rows": same_rows,
        "card_vs_cpu_check_s": check_s,
        "fallback_bloom_rate": timed[-1]["fallback_bloom_rate"],
        "fit": fit, "phase_wall_s": wall, "card": card}
    print(json.dumps(metrics), flush=True)
    print(json.dumps({"metric": "train_step_profile_100kb", **trace,
                      "card": card}), flush=True)
    print(json.dumps({"metric": "kernels_100kb", **kernels, "card": card}),
          flush=True)
    return {"counts": counts, "fit_counts": fit_counts, "kernels": kernels,
            "step_check": step_check, "wall_s": wall}


# ------------------------------------------------------------- phase 18
# a user's 100 kb all-genome run through the entry points: kmers and train
# through the CLI, then the apps on the bundle train writes.  Denoise scores
# every intra-chromosome pair at min_distance 0, sum over the chromosomes of
# n_c (n_c + 1) / 2 = 23,607,738 pixels (3,103,786 on chr1); the band of
# the intra contacts (diagonals 1..199, as scripts/bench_apps_100kb.py draws
# them); partners drawn per row of the inter contacts; pairs per chromosome
# of the closed-form vs forward check (the JAX script's default); queries
# per k of predict_multiway
PIXELS_100KB, INTRA_BAND, INTER_DRAWS = 23_607_738, 200, 32
DEV_SAMPLE_100KB, QUERIES_PER_K_100KB = 100_000, 20_000


def draw_contacts(genome, rng):
    """Dense f32 (N, N) contact matrices, drawn with numpy into one
    preallocated array each (never an (N, N) f64):
    * intra: per chromosome the banded block of
      scripts/bench_apps_100kb.py (diagonal ``off`` = 1..199 holds
      ``rng.random(w - off) / off``), made symmetric; one bin of each
      chromosome all zero, its row and column (a gap for denoise);
    * inter: symmetric, ``INTER_DRAWS`` partners drawn per row off its
      chromosome (about twice that many positive entries per row), values
      in [0.5, 1.5); then 1% of the rows all zero and 1% with one positive
      entry (at least one each), so build_frozen_tables' z-score loop takes
      each of its branches (no positive entry, one, several).
    -> (intra, inter)."""
    n = genome.num_nodes
    intra = np.zeros((n, n), np.float32)
    for c in range(genome.num_chroms):
        s, e = genome.chrom_range[c]
        w = int(e - s)
        block = np.zeros((w, w), np.float32)
        ii = np.arange(w)
        for off in range(1, min(w, INTRA_BAND)):
            block[ii[:-off], ii[:-off] + off] = (
                rng.random(w - off).astype(np.float32) / off)
        block = block + block.T
        gap = int(rng.integers(w))
        block[gap, :] = 0.0
        block[:, gap] = 0.0
        intra[s - 1:e - 1, s - 1:e - 1] = block
    chrom = genome.node2chrom[1:]
    rows = np.repeat(np.arange(n, dtype=np.int64), INTER_DRAWS)
    cols = rng.integers(0, n, rows.size)
    off = chrom[rows] != chrom[cols]
    lo = np.minimum(rows[off], cols[off])
    hi = np.maximum(rows[off], cols[off])
    key = np.unique(lo * n + hi)
    lo, hi = key // n, key % n
    val = (rng.random(len(key)) + 0.5).astype(np.float32)
    inter = np.zeros((n, n), np.float32)
    inter[lo, hi] = val
    inter[hi, lo] = val
    m = max(1, n // 100)
    special = rng.choice(n, 2 * m, replace=False)
    inter[special, :] = 0.0
    inter[:, special] = 0.0
    taken = set(special.tolist())
    for r in special[m:]:
        while True:
            j = int(rng.integers(n))
            if chrom[j] != chrom[r] and j not in taken:
                break
        inter[r, j] = inter[j, r] = np.float32(rng.random() + 0.5)
    return intra, inter


def write_chrom_queries(path, genome, rng, per_k):
    """``per_k`` queries of each k = 2..5 (k = 2 first), each k distinct
    bins of one chromosome drawn uniformly, written as the JAX package's
    scripts/bench_apps_100kb.py writes them (chrom:coord at the bin's
    middle, tab-separated)."""
    res = genome.resolution
    lines = []
    for k in KS:
        chroms = rng.integers(0, genome.num_chroms, per_k)
        for c in range(genome.num_chroms):
            m = int((chroms == c).sum())
            if not m:
                continue
            w = int(genome.chrom_range[c, 1] - genome.chrom_range[c, 0])
            bins = np.sort(np.argsort(rng.random((m, w)), axis=1)[:, :k],
                           axis=1)
            name = genome.chrom_names[c]
            lines += ["\t".join(f"{name}:{b * res + res // 2}" for b in row)
                      for row in bins.tolist()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def model_to(params, frozen, device):
    """Copies of ``params`` and ``frozen`` on ``device``."""
    return (hs._tree_to(params, device),
            hs.FrozenTables(*hs._tree_to(tuple(frozen), device)))


def denoise_100kb(params, frozen, dims, genome, intra, cpu_model,
                  device) -> dict:
    """Phase 18 (c): ``denoise_pixels`` over the 23 chromosomes (one timed
    pass after a warm-up on the smallest chromosome, ``np.random.seed``
    set first, the counts zeroed just before and read just after: no
    kernel), its parts timed inside that pass; the pixel count and range;
    per chromosome the closed form against the forward over
    ``DEV_SAMPLE_100KB`` sampled pairs (both bf16 on the card, as
    scripts/bench_apps_100kb.py checks them); on chr1 the card's f32 pair
    probabilities against the CPU's on ``cpu_model``; the .mcool write
    where h5py is importable."""
    import importlib.util
    from matcha_tpu_torch.apps import denoise_contact as dn
    from matcha_tpu_torch.apps.pairwise_fast import pairwise_proba_matrix
    bins = np.diff(genome.chrom_range, axis=1)[:, 0]
    np.random.seed(SEED + 30)
    dn.denoise_chromosome(params, frozen, dims, genome, intra,
                          int(np.argmin(bins)), 0)            # warm-up
    np.random.seed(SEED + 31)
    zero_launch_counts()
    t0 = time.perf_counter()
    with denoise_parts() as parts:
        bin1, bin2, bal, _ = dn.denoise_pixels(params, frozen, dims, genome,
                                               intra, log=lambda *a: None)
    wall = time.perf_counter() - t0
    launched = launch_counts()
    out = {"wall_s": wall, "pixels": len(bal), "launches": launched,
           "parts_s": parts}
    print(f"denoise 100 kb: {len(bal)} pixels over {genome.num_chroms} "
          f"chromosomes in {wall:.3f} s (expected {PIXELS_100KB}); parts "
          f"{json.dumps(out['parts_s'])}; launches {launched}", flush=True)
    if not (len(bin1) == len(bin2) == len(bal) == PIXELS_100KB):
        fail(f"denoise at 100 kb gave {len(bal)} pixels, expected "
             f"{PIXELS_100KB}")
    if not np.isfinite(bal).all() or (bal < 0).any() or (bal > 1).any():
        fail("denoised values at 100 kb are not finite or outside [0, 1]")
    if launched["K8_fwd"] != genome.num_chroms or any(
            v for k, v in launched.items() if k != "K8_fwd"):
        fail(f"denoise launched {launched}: the closed form needs only the "
             f"node table's encode, one K8 forward per chromosome")

    rng = np.random.default_rng(SEED + 91)
    devs = []
    zero_launch_counts()
    t0 = time.perf_counter()
    for c in range(genome.num_chroms):
        s = genome.chrom_range[c, 0]
        pairs = dn.generate_pair_wise(genome, c, 0)
        sample = pairs[rng.permutation(len(pairs))[:DEV_SAMPLE_100KB]]
        full = pairwise_proba_matrix(params, frozen, dims, genome, c)
        fwd = predict_proba(params, frozen, dims, sample, BATCH)
        devs.append(float(np.abs(full[sample[:, 0] - s, sample[:, 1] - s]
                                 - fwd).max()))
    out["deviation_s"] = time.perf_counter() - t0
    out["deviation_forward_launches"] = launch_counts()
    out["deviation_sample_per_chrom"] = DEV_SAMPLE_100KB
    out["closed_form_vs_forward_bf16_max_abs_err"] = max(devs)
    f32 = dims._replace(compute_dtype="float32")
    p_card = pairwise_proba_matrix(params, frozen, f32, genome, 0)
    p_cpu = pairwise_proba_matrix(*cpu_model, f32, genome, 0)
    out["chr1_f32_card_vs_cpu_max_abs_err"] = float(np.abs(p_card
                                                           - p_cpu).max())
    print(f"denoise 100 kb: closed form vs forward on {DEV_SAMPLE_100KB} "
          f"pairs per chromosome, bf16 on the card, {max(devs):.3e} (tol "
          f"{TOL_PROBA_BF16}); chr1 f32 card vs CPU "
          f"{out['chr1_f32_card_vs_cpu_max_abs_err']:.3e} (tol "
          f"{TOL_PROBA_F32})", flush=True)
    if (max(devs) > TOL_PROBA_BF16
            or out["chr1_f32_card_vs_cpu_max_abs_err"] > TOL_PROBA_F32):
        fail("the 100 kb denoise pair probabilities disagree")
    if importlib.util.find_spec("h5py") is None:
        out["write_s"] = "not run"
        print("denoise 100 kb: the .mcool write was not run on this "
              "machine: h5py is absent", flush=True)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            dn.write_denoised_mcool(os.path.join(tmp, "denoised.mcool"),
                                    genome, bin1, bin2, bal)
            out["write_s"] = time.perf_counter() - t0
    return out


def predict_multiway_100kb(bundle, qpath, genome, dims, cpu_model, tmp,
                           device) -> dict:
    """Phase 18 (d): ``run_predict_multiway`` through its entry point on
    the bundle, its stages timed inside the call, the counts zeroed just
    before and read just after (K1 once per chunk of k >= 3, nothing
    else); the probabilities' range; 2,000 queries per k bf16 on the card
    against f32 on the CPU (``cpu_model``).  -> the results, with the
    parsed queries ("samples")."""
    zero_launch_counts()
    t0 = time.perf_counter()
    with HostMemory() as mem, predict_stages() as stages:
        proba = run_predict_multiway(bundle, qpath,
                                     os.path.join(tmp, "output.txt"),
                                     batch_size=BATCH, device=str(device))
    wall = time.perf_counter() - t0
    launched = launch_counts()
    samples = parse_interaction_file(qpath, genome)
    sizes = np.asarray([len(s_) for s_ in samples])
    want = {key: 0 for key in launched}
    want["K1"] = sum(-(-int((sizes == k).sum()) // BATCH) for k in KS
                     if k >= 3)
    want["K8_fwd"] = 1                  # the request's one encode
    out = {"metric": "predict_multiway_hyperedges_per_s_100kb",
           "value": len(proba) / wall, "wall_s": wall,
           "candidates": len(proba),
           "stages_s": stages,
           "host_memory": mem.reading(), "launches": launched}
    print(f"predict_multiway 100 kb: {len(proba)} queries in {wall:.3f} s; "
          f"launches {launched} (expected {want})", flush=True)
    if launched != want:
        fail(f"predict_multiway at 100 kb launched {launched}, expected "
             f"{want}")
    if proba.shape != (len(KS) * QUERIES_PER_K_100KB,) or not (
            (proba > 0) & (proba < 1)).all():
        fail(f"predict_multiway at 100 kb: shape {proba.shape}, or "
             f"probabilities outside (0, 1)")
    pick = np.concatenate([i * QUERIES_PER_K_100KB + np.arange(CHECK_PER_K)
                           for i in range(len(KS))])
    c_params, c_frozen = cpu_model
    p_cpu = predict_proba(c_params, c_frozen,
                          dims._replace(compute_dtype="float32"),
                          [samples[i] for i in pick], BATCH)
    out["bf16_card_vs_f32_cpu_max_abs_err"] = float(
        np.abs(proba[pick] - p_cpu).max())
    print(f"predict_multiway 100 kb: bf16 card vs f32 CPU on {len(pick)} "
          f"queries {out['bf16_card_vs_f32_cpu_max_abs_err']:.3e} (tol "
          f"{TOL_PROBA_BF16})", flush=True)
    if out["bf16_card_vs_f32_cpu_max_abs_err"] > TOL_PROBA_BF16:
        fail("predict_multiway at 100 kb disagrees with the f32 CPU")
    return {**out, "samples": samples}


def apps_100kb_phase(card, device=torch.device("cuda")) -> dict:
    """Phase 18: a user's 100 kb all-genome run through the entry points
    (hg38 chr1-22 + chrX at 100,000 bp, 30,344 nodes): (a) the inputs,
    with numpy only (``draw_contacts``, phase 11's edge list); (b)
    ``kmers`` (a subprocess) and ``train`` (``pipeline.main``) through the
    CLI with phase 11's config and bf16 tables; (c) the bundle train wrote,
    loaded once (``load_model_bundle``: f32 tables on the card), and
    denoise over the 23 chromosomes; (d) ``run_predict_multiway`` through
    its entry point; (e) outlier ranking on the loaded bundle.  -> each
    stage's launches for the kernels line."""
    t_phase = time.perf_counter()
    genome = GenomeBins(HG38_NAMES, HG38, RES_100KB)
    n = genome.num_nodes
    bins = np.diff(genome.chrom_range, axis=1)[:, 0]
    if n != NODES_100KB or int((bins * (bins + 1) // 2).sum()) \
            != PIXELS_100KB:
        fail(f"hg38 at 100 kb has {n} bins and "
             f"{int((bins * (bins + 1) // 2).sum())} intra pairs, expected "
             f"{NODES_100KB} and {PIXELS_100KB}")
    on_card = device.type == "cuda"
    out = {"metric": "apps_100kb", "nodes": n, "card": card}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        out["card_memory_at_start_gb"] = torch.cuda.memory_allocated() / 1e9
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the inputs: temp_dir's two matrices and the bundle's two
        temp = os.path.join(tmp, "temp")
        need = 4 * 4 * n * n + 10 ** 9
        free = shutil.disk_usage(tmp).free
        out["disk_free_gb"], out["disk_needed_gb"] = free / 1e9, need / 1e9
        print(f"apps 100 kb: {free / 1e9:.1f} GB free under {tmp}, the "
              f"phase writes up to {need / 1e9:.1f} GB", flush=True)
        if free < need:
            fail(f"the 100 kb run needs {need / 1e9:.1f} GB of disk under "
                 f"{tmp}; {free / 1e9:.1f} GB are free")
        from matcha_tpu_torch.data.mcool import save_contacts
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED + 90)
        genome.save(temp)
        intra, inter = draw_contacts(genome, rng)
        save_contacts(temp, intra, inter)
        del intra, inter
        out["clusters"] = write_clusters(temp, genome, rng)
        out["inputs_s"] = time.perf_counter() - t0
        print(f"apps 100 kb: inputs written in {out['inputs_s']:.1f} s",
              flush=True)

        # (b) kmers and train through the CLI
        cfg = write_cli_config(tmp, temp, genome, table_dtype="bfloat16")
        cli_kmers_and_train(cfg, tmp, temp, genome, out, device)
        out["train_launches"] = out.pop("launches")
        print(f"apps 100 kb: kmers {out['kmers_s']:.1f} s, train "
              f"{out['train_s']:.1f} s (build_frozen_tables "
              f"{out['train_build_frozen_tables_s']:.1f} s), host memory "
              f"{json.dumps(out['train_host_memory'])}, launches "
              f"{out['train_launches']}", flush=True)
        bundle = os.path.join(temp, "model2load")

        # (c) the bundle loaded once; denoise
        t0 = time.perf_counter()
        with HostMemory() as mem, \
                timed_calls(runtime, "build_frozen_tables") as bf, \
                timed_calls(np, "load") as ld:
            params, dims, _, frozen = load_model_bundle(bundle, device)
        if on_card:
            torch.cuda.synchronize()
        out["load"] = {"wall_s": time.perf_counter() - t0,
                       "np_load_s": ld["load"],
                       "build_frozen_tables_s": bf["build_frozen_tables"],
                       "host_memory": mem.reading(),
                       "inter_z": [list(frozen.inter_z.shape),
                                   str(frozen.inter_z.dtype)]}
        if on_card:
            out["load"]["card_memory_gb"] = \
                torch.cuda.memory_allocated() / 1e9
        print(f"apps 100 kb: bundle loaded {json.dumps(out['load'])}",
              flush=True)
        if dims.compute_dtype != "bfloat16":
            fail(f"the 100 kb bundle holds compute_dtype "
                 f"{dims.compute_dtype}, expected train's bfloat16")
        t0 = time.perf_counter()
        cpu_model = model_to(params, frozen, "cpu")
        out["cpu_copy_s"] = time.perf_counter() - t0
        intra = np.load(os.path.join(bundle, "intra_adj.npy"))
        out["denoise"] = denoise_100kb(params, frozen, dims, genome, intra,
                                       cpu_model, device)
        del intra

        # (d) predict_multiway through its entry point
        qpath = os.path.join(tmp, "queries.txt")
        write_chrom_queries(qpath, genome, np.random.default_rng(SEED + 92),
                            QUERIES_PER_K_100KB)
        pmw = predict_multiway_100kb(bundle, qpath, genome, dims, cpu_model,
                                     tmp, device)
        samples = pmw.pop("samples")
        out["predict_multiway"] = pmw

        # (e) outlier ranking on the loaded bundle
        out["outlier"] = outlier_phase((params, dims, frozen), cpu_model,
                                       samples, genome, card,
                                       metric="outlier_rows_per_s_100kb")
        del params, frozen, cpu_model
    if on_card:
        out["card_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(json.dumps(out), flush=True)
    print(f"apps 100 kb: phase wall {out['phase_wall_s']:.1f} s", flush=True)
    return {"train": out["train_launches"],
            "denoise": out["denoise"]["launches"],
            "predict_multiway": pmw["launches"],
            "outlier": out["outlier"]["launches"],
            "wall_s": out["phase_wall_s"]}


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")

    # 1. device
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    built = build()
    print(f"build: {json.dumps(built)} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 3. kernels vs plain
    worst = check_kernels(device)
    worst_bwd = check_backward(device)
    worst_scatter = max(check_scatter_bincount(device),
                        check_scatter_skewed(device))
    check_bincount(device)
    worst_scatter = max(worst_scatter, check_sgns_kernels(device))
    check_cooccurrence(device)
    check_bloom(device)
    check_propose(device, hg38_genome())
    check_k7(device, hg38_genome())
    worst_tail = check_fused_tail(device)
    check_tail_masks(device)

    # 4. serving end to end, full width
    genome = hg38_genome()
    with tempfile.TemporaryDirectory() as tmp:
        bundle = os.path.join(tmp, "model2load")
        make_bundle(bundle, genome, device)
        inp = os.path.join(tmp, "candidates.txt")
        write_candidates(inp, genome, np.random.default_rng(SEED + 1))
        out = os.path.join(tmp, "output.txt")

        hyperedge_attention.launches = 0
        t0 = time.perf_counter()
        proba = run_predict_multiway(bundle, inp, out, batch_size=BATCH,
                                     device="cuda")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = hyperedge_attention.launches
        n_cand = PER_K * len(KS)
        n_attn = sum(-(-PER_K // BATCH) for k in KS if k >= 3)
        print(f"predict_multiway: {len(proba)} candidates in {first_s:.3f} s"
              f" (first call), K1 launches {launches}", flush=True)
        if launches != n_attn:
            fail(f"K1 launched {launches} times on the main path, "
                 f"expected {n_attn}")
        if proba.shape != (n_cand,) or not np.isfinite(proba).all():
            fail("probabilities are not finite or of the wrong shape")
        if not ((proba > 0) & (proba < 1)).all():
            fail("probabilities outside (0, 1)")

        samples = parse_interaction_file(inp, genome)
        pick = np.concatenate([i * PER_K + np.arange(CHECK_PER_K)
                               for i in range(len(KS))])
        subset = [samples[i] for i in pick]
        p_cpu = reference_proba(bundle, subset, "cpu")
        p_gpu = reference_proba(bundle, subset, "cuda")
        err_f32 = float(np.abs(p_gpu - p_cpu).max())
        err_bf16 = float(np.abs(proba[pick] - p_cpu).max())
        print(f"probabilities vs f32 on the CPU ({len(pick)} candidates): "
              f"f32 card {err_f32:.3e} (tol {TOL_PROBA_F32}), bf16 card "
              f"{err_bf16:.3e} (tol {TOL_PROBA_BF16})", flush=True)
        if err_f32 > TOL_PROBA_F32 or err_bf16 > TOL_PROBA_BF16:
            fail("probabilities disagree with the f32 CPU reference")

        # 5. serving times
        walls, splits = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            with predict_stages() as stages:
                run_predict_multiway(bundle, inp, out, batch_size=BATCH,
                                     device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            splits.append(stages)
        split = {k: statistics.median(s[k] for s in splits)
                 for k in splits[0]}
        params, dims, _, frozen = load_model_bundle(bundle, "cuda")
        trace = profile_scoring(params, frozen, dims, samples)
    wall = statistics.median(walls)
    print(json.dumps({
        "metric": "predict_multiway_hyperedges_per_s",
        "value": n_cand / wall, "wall_s": wall, "first_call_s": first_s,
        "predict_proba_hyperedges_per_s": n_cand / split["score_s"],
        "stages_s": split, "candidates": n_cand, "ks": list(KS),
        "batch_size": BATCH, "card": card}), flush=True)
    print(json.dumps({"metric": "predict_proba_profile", **trace,
                      "card": card}), flush=True)

    E, L, dt = BATCH, 5, "bfloat16"
    x, args = attention_inputs(device, E, L, dt)
    ms = cuda_ms(lambda: hyperedge_attention_cuda(x, *args, N_HEAD, True))
    k1_dev = device_ms_per_call(
        lambda: hyperedge_attention_cuda(x, *args, N_HEAD, True))
    plain_ms = cuda_ms(lambda: hyperedge_attention_plain(x, *args, N_HEAD,
                                                         True))
    flops, nbytes = attention_work(E, L, dt)
    b_ms, b_by = bound_ms(flops, nbytes, dt)
    print(json.dumps({
        "metric": "k1_hyperedge_attention_fwd", "E": E, "L": L, "dtype": dt,
        "ms": ms, "device_ms": k1_dev,
        "tflops_achieved": flops / (k1_dev * 1e-3) / 1e12
        if isinstance(k1_dev, float) else "not measured",
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        "launches_per_predict_multiway": launches, "library_ms": None,
        "library_note": "no single PyTorch call computes K1 (LN + q/k/v + "
                        "attention + fc1)", "card": card}), flush=True)

    # 6. training at full width, 7. training times (the unfused tail)
    set_fuse_tail(False)
    train = train_phase(genome, device, card)
    tk = time_training_kernels(device, card)

    # 8. Trainer.fit on the opt-in kernels' path; 9. its kernels' and
    # step's times
    fit = fit_phase(train["problem"], genome, card)
    counts = fit["counts"]
    nk = time_new_kernels(device, card)
    k7t = time_k7(device, card)
    k8t = time_k8(device, card)
    step_ab(train["problem"], card)

    # 10. shapes the kernels do not take
    small_model_phase(genome, device, card)

    # 11. run_train through the CLI, 15. the pretraining on its temp_dir
    with tempfile.TemporaryDirectory() as tmp:
        cli = cli_train_phase(genome, card, tmp)
        pre = pretrain_phase(train["problem"], genome, card, cli["config"])
    sg = pre["kernels"]

    # 12. denoise and 13. outlier ranking on the serving bundle
    with tempfile.TemporaryDirectory() as tmp:
        bundle = os.path.join(tmp, "model2load")
        make_bundle(bundle, genome, device)
        denoise_phase(bundle, genome, device, card)
        on_card = load_model_bundle(bundle, device)
        on_cpu = load_model_bundle(bundle, "cpu")
        outl = outlier_phase((on_card[0], on_card[1], on_card[3]),
                             (on_cpu[0], on_cpu[3]), samples, genome, card)
        del on_card, on_cpu

    # 14. the regress mode, per-occurrence feature dropout, MATCHA_RECON_BF16
    set_fuse_tail(False)
    modes = modes_phase(train["problem"], genome, card)
    regress = modes["regress"]["fit_launches"]
    occ = modes["per_occurrence"]["epoch_launches"]
    rbf = modes["recon_bf16"]["epoch_launches"]

    # 17. the 100 kb all-genome configuration (before phase 16, whose
    # spawned ranks share the card)
    set_fuse_tail(False)
    big = hundred_kb_phase(card)
    bk = big["kernels"]
    torch.cuda.empty_cache()

    # 18. a user's 100 kb run through the entry points: kmers and train
    # through the CLI, then the apps on the bundle it wrote
    apps = apps_100kb_phase(card)
    torch.cuda.empty_cache()

    # 16. multi-rank training on the one card
    check_rank_shapes(device)
    tp_worst = check_tp_shapes(device)
    set_fuse_tail(False)
    mesh = mesh_phase(train["problem"], genome, card)

    def per_step(counts):
        return {k: v // TRAIN_STEPS for k, v in counts.items()}
    mesh_counts = {f"{d}x{m}": per_step(
        mesh[f"{d}x{m}"]["launches_per_rank_epoch"][0])
        for d, m in MESH_SHAPES}
    tp_counts = {f"{d}x{m}": per_step(
        mesh[f"{d}x{m}"]["tp"]["launches_per_rank_epoch"][0])
        for d, m in MESH_SHAPES if m > 1}
    occ_counts = per_step(mesh["{}x{}".format(*OCC_MESH)]["per_occurrence"]
                          ["launches_per_rank_epoch"][0])
    mesh_fit_counts = mesh["2x1"]["fit"]["launches_per_rank"][0]

    def mesh_launches(name):
        out = {"launches_mesh_per_rank_step": {
            shape: c[name] for shape, c in mesh_counts.items()},
            "launches_mesh_fit_per_rank": mesh_fit_counts[name]}
        if name in ("K1", "K2", "K3", "K4"):
            out["launches_mesh_tp_per_rank_step"] = {
                shape: c[name] for shape, c in tp_counts.items()}
            out["launches_mesh_per_occurrence_per_rank_step"] = \
                occ_counts[name]
        out["launches_device_epoch_100kb"] = big["counts"][name]
        out["launches_fit_100kb"] = big["fit_counts"][name]
        out["launches_apps_100kb"] = {
            stage: apps[stage][name]
            for stage in ("train", "denoise", "predict_multiway", "outlier")}
        return out

    k2 = tk["K2_L5"]
    k5 = nk["K5_k5"]
    step_path = train["counts"]
    print(json.dumps({"kernels": [
        {"name": "hyperedge_attention_fwd", "route": "cuda",
         "source": "matcha_tpu_torch/csrc/hyperedge_attention_fwd.cu",
         "replaces": "matcha_tpu/ops/hyperedge_attention.py:454",
         "tc_route": "bf16 with <= 8 heads: wgmma, a cluster of one block "
                     "per head; f32: CUDA cores",
         "launches": counts["K1"], "launches_serving": launches,
         "launches_step_path": step_path["K1"],
         "launches_outlier": outl["launches"]["K1"],
         "launches_regress_fit": regress["K1"],
         "launches_per_occurrence_epoch": occ["K1"],
         "launches_recon_bf16_epoch": rbf["K1"],
         **mesh_launches("K1"),
         "device_ms": k1_dev,
         "device_ms_step_L345": [tk[f"K1_L{L}"]["device_ms"]
                                 for L in (3, 4, 5)],
         "tflops_achieved_step_L345": [tk[f"K1_L{L}"]["tflops_achieved"]
                                       for L in (3, 4, 5)],
         "max_abs_err": worst["bfloat16"],
         "max_abs_err_f32": worst["float32"],
         "max_abs_err_tp_4_heads": tp_worst["bfloat16"]["K1"],
         "max_abs_err_tp_4_heads_f32": tp_worst["float32"]["K1"],
         "at_100kb_step_L345": [bk[f"K1_L{L}"] for L in (3, 4, 5)],
         "ms": ms,
         "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": None},
        {"name": "hyperedge_attention_bwd", "route": "cuda",
         "source": "matcha_tpu_torch/csrc/hyperedge_attention_bwd.cu",
         "replaces": "matcha_tpu/ops/hyperedge_attention.py:672",
         "launches": counts["K2"], "launches_step_path": step_path["K2"],
         "launches_regress_fit": regress["K2"],
         "launches_per_occurrence_epoch": occ["K2"],
         "launches_recon_bf16_epoch": rbf["K2"],
         **mesh_launches("K2"),
         "max_abs_err": worst_bwd["bfloat16"]["gx_abs"],
         "max_err_rel_to_max": worst_bwd["bfloat16"]["rel_to_max"],
         "max_err_rel_to_max_f32": worst_bwd["float32"]["rel_to_max"],
         "max_err_rel_to_max_tp_4_heads": tp_worst["bfloat16"]["K2"],
         "max_err_rel_to_max_tp_4_heads_f32": tp_worst["float32"]["K2"],
         "at_100kb_step_L345": [bk[f"K2_L{L}"] for L in (3, 4, 5)],
         "ms": k2["ms"], "device_ms": k2["device_ms"],
         "tflops_achieved": k2["tflops_achieved"],
         "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None},
        {"name": "scatter_add", "route": "cuda",
         "source": "matcha_tpu_torch/csrc/table_scatter.cu",
         "replaces": "matcha_tpu/ops/table_scatter.py:62",
         "launches": counts["K3"], "launches_step_path": step_path["K3"],
         "launches_regress_fit": regress["K3"],
         "launches_per_occurrence_epoch": occ["K3"],
         "launches_recon_bf16_epoch": rbf["K3"],
         "launches_pretrain": pre["launches"]["K3"],
         **mesh_launches("K3"),
         "max_abs_err": worst_scatter,
         "ms": tk["K3"]["ms"], "device_ms": tk["K3"]["device_ms"],
         "plain_ms": tk["K3"]["plain_ms"],
         "bound_ms": tk["K3"]["bound_ms"], "bound_by": "bytes",
         "library_ms": tk["K3"]["library_ms"],
         "library_device_ms": tk["K3"]["library_device_ms"],
         "library_full_device_ms": tk["K3"]["library_full_device_ms"],
         "shapes": [{k: e[k] for k in (
             "T", "n", "dtype", "ids", "device_ms", "library_device_ms",
             "library_full_device_ms", "bound_ms", "k3_route")}
             for e in [tk["K3"], bk["K3"]] + [
                 sg[f"K3_T{T}{sfx}"] for sfx in ("", f"_n{SGNS_V_100KB}")
                 for T in SGNS_T]],
         "sgns": {f"T{T}": sg[f"K3_T{T}"] for T in SGNS_T},
         "sgns_100kb": {f"T{T}": sg[f"K3_T{T}_n{SGNS_V_100KB}"]
                        for T in SGNS_T},
         "at_100kb": bk["K3"]},
        {"name": "bincount", "route": "cuda",
         "source": "matcha_tpu_torch/csrc/table_scatter.cu",
         "replaces": "matcha_tpu/ops/table_scatter.py:112",
         "route_note": "one thread-block cluster: per-block histograms "
                       "summed through distributed shared memory (n <= "
                       "16,384), else one histogram banded over the blocks",
         "launches": counts["K4"], "launches_step_path": step_path["K4"],
         "launches_regress_fit": regress["K4"],
         "launches_per_occurrence_epoch": occ["K4"],
         "launches_recon_bf16_epoch": rbf["K4"],
         "launches_pretrain": pre["launches"]["K4"],
         **mesh_launches("K4"),
         "max_abs_err": 0.0,
         "ms": tk["K4"]["ms"], "device_ms": tk["K4"]["device_ms"],
         "plain_ms": tk["K4"]["plain_ms"],
         "bound_ms": tk["K4"]["bound_ms"], "bound_by": "bytes",
         "library_ms": tk["K4"]["library_ms"],
         "library_device_ms": tk["K4"]["library_device_ms"],
         "sgns": {f"T{T}": sg[f"K4_T{T}"] for T in SGNS_T},
         "at_100kb": bk["K4"]},
        {"name": "propose_phase1", "route": "cuda",
         "source": "matcha_tpu_torch/csrc/propose.cu",
         "replaces": "matcha_tpu/ops/propose.py:94",
         "launches": counts["K5"], "max_abs_err": 0.0,
         **mesh_launches("K5"),
         "ms": k5["ms"], "device_ms": k5["device_ms"],
         "in_sampler_ms_per_step": nk["K5_in_sampler"]["step_ms"],
         "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "fused_tail_fwd", "route": "cuda",
         "source": "matcha_tpu_torch/csrc/fused_tail.cu",
         "replaces": "matcha_tpu/ops/fused_tail.py:240",
         "tc_route": "bf16: wgmma, two blocks of two warpgroups per SM over "
                     "tiles of 64 tokens; f32: CUDA cores",
         "launches": counts["K6_fwd"],
         **mesh_launches("K6_fwd"),
         "tflops_achieved": nk["K6_fwd"]["tflops_achieved"],
         "device_ms_eval": nk["K6_fwd_eval"]["device_ms"],
         "max_abs_err": worst_tail["fwd_abs_bf16"],
         "max_err_rel_to_max_f32": worst_tail["float32"],
         "ms": nk["K6_fwd"]["ms"], "device_ms": nk["K6_fwd"]["device_ms"],
         "plain_ms": nk["K6_fwd"]["plain_ms"],
         "bound_ms": nk["K6_fwd"]["bound_ms"],
         "bound_by": nk["K6_fwd"]["bound_by"], "library_ms": None},
        {"name": "fused_tail_bwd", "route": "cuda",
         "source": "matcha_tpu_torch/csrc/fused_tail.cu",
         "replaces": "matcha_tpu/ops/fused_tail.py:258",
         "tc_route": "bf16: wgmma, two warpgroups per block over tiles of "
                     "64 tokens; f32: CUDA cores",
         "launches": counts["K6_bwd"],
         **mesh_launches("K6_bwd"),
         "tflops_achieved": nk["K6_bwd"]["tflops_achieved"],
         "max_abs_err": worst_tail["gy_abs_bf16"],
         "max_err_rel_to_max": worst_tail["bfloat16"],
         "ms": nk["K6_bwd"]["ms"], "device_ms": nk["K6_bwd"]["device_ms"],
         "plain_ms": nk["K6_bwd"]["plain_ms"],
         "bound_ms": nk["K6_bwd"]["bound_ms"],
         "bound_by": nk["K6_bwd"]["bound_by"], "library_ms": None},
        {"name": "sample_negatives", "route": "cuda",
         "source": "matcha_tpu_torch/csrc/sample_negatives.cu",
         "replaces": "none: the eager sampler chain "
                     "(matcha_tpu_torch/sampler/negative.py:_sample_eager)",
         "launches": counts["K7"], "launches_step_path": step_path["K7"],
         "rounds_step_path": step_path["rounds"],
         **mesh_launches("K7"), "max_abs_err": 0,
         "ms": k7t[f"K7_b{TRAIN_BATCH}_k5"]["ms"],
         "device_ms": k7t[f"K7_b{TRAIN_BATCH}_k5"]["device_ms"],
         "bound_ms": k7t[f"K7_b{TRAIN_BATCH}_k5"]["bound_ms"],
         "bound_by": "bytes",
         "sampler_ms": k7t[f"K7_b{TRAIN_BATCH}_k5"]["sampler_ms"],
         "plain_ms": k7t[f"K7_b{TRAIN_BATCH}_k5"]["plain_ms"],
         "ms_note": "ms / device_ms: phase 1 alone on uniforms drawn "
                    "before; sampler_ms against plain_ms: the whole "
                    "per-size call, draws and rounds included, on K7 and "
                    "on the eager chain",
         "library_ms": None},
        {"name": "node_encode", "route": "cuda",
         "source": "matcha_tpu_torch/csrc/node_encode.cu",
         "replaces": "none: the eager encode chain "
                     "(matcha_tpu_torch/models/hypersagnn.py:"
                     "encode_node_table)",
         "tc_route": "bf16: wgmma, one warpgroup per 64-row tile (forward) "
                     "or 64-column block (backward); f32: CUDA cores",
         "launches": counts["K8_fwd"], "launches_bwd": counts["K8_bwd"],
         "launches_keep": counts["K8_keep"],
         "launches_step_path": {k: step_path[k] for k in
                                ("K8_fwd", "K8_bwd", "K8_keep")},
         **mesh_launches("K8_fwd"),
         "max_abs_err": k8t["K8_100kb"]["max_abs_err"],
         "ms": k8t["K8_100kb"]["ms"], "plain_ms": k8t["K8_100kb"]["plain_ms"],
         "device_ms": {n: k8t["K8_100kb"][f"{n}_device_ms"]
                       for n in ("keep", "fwd", "bwd")},
         "bound_ms": k8t["K8_100kb"]["bound_ms"], "bound_by": "bytes",
         "at_10kb_rank": {key: k8t["K8_10kb"][key] for key in (
             "ms", "bound_ms", "plain_ms", "keep_ms", "keep_bound_ms",
             "fwd_ms", "fwd_bound_ms", "bwd_ms", "bwd_bound_ms",
             "keep_device_ms", "fwd_device_ms", "bwd_device_ms",
             "max_abs_err", "grad_err_rel_to_max", "bits_equal",
             "keep_launches")},
         "ms_note": "100 kb (and at_10kb_rank: train_10kb_m4_b96's last "
                    "model rank, bf16 rows): keep + forward + backward by "
                    "events; plain_ms the eager chain's keep test, forward "
                    "and backward",
         "library_ms": None}]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
