#!/usr/bin/env python3
"""Drive the PyTorch port's serving path and training step on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root, on a machine with a GPU

Phases, all in this process; any failure exits non-zero before the last line:
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile every kernel from csrc/ with nvcc (sm_90a), one nvcc per
     source, all at once: K1 (attention forward), K2 (attention backward),
     K3 (scatter-add) and K4 (bincount).
  3. kernels vs plain: each kernel's wrapper against its plain PyTorch version
     on the card, over the shapes the main paths give it (f32 with TF32 off,
     and bf16), with the tolerances stated below; the Bloom hashes computed
     on the card against an independent numpy build, bit for bit.
  4. serving end to end at full width: the hg38 1 Mb genome (23 chromosomes,
     3,067 nodes), random weights from a seed at dim 64 / 8 heads in bf16,
     saved as a bundle; run_predict_multiway over 20,000 candidates for each
     of k = 2..5 (batch 10,000).  The launch counts are zeroed just before
     and read just after; the probabilities are checked for range and
     against an f32 copy of the bundle on the CPU (the plain path) and on the
     card.
  5. serving times: run_predict_multiway wall and its stages (host clock,
     median of 3), a torch.profiler summary of the scoring stage, and K1 by
     CUDA events beside its bound.
  6. training at full width, the configuration of the JAX package's bench.py
     (dim 64, 8 heads, bf16 compute with f32 master params, k = 2..5, 2,048
     positives per k, neg_num 3, Bloom filters from the buckets, alpha 1,
     beta 0.001, the "merged" token stream): Trainer -> pin_base_buckets ->
     train_epoch_indexed; one stage-1 step, then a warm-up epoch and a timed
     epoch of 20 stage-2 steps.  The counts are zeroed just before the timed
     epoch and read just after: each step must launch K1 x3, K2 x3, K3 x1 and
     K4 x1.  Losses finite, params changed; a deterministic step (dropout
     off, the same negatives and recon chromosome) as f32 on the card against
     f32 on the CPU (the plain path), and as bf16 on the card.
  7. training times: the median step, hyperedges scored per second, the
     step's parts (host clock, synchronised after each, median of 5), the
     host synchronisations of one step (PyTorch's sync debug mode), a
     torch.profiler summary of one step, and K2, K3 and K4 by CUDA events at
     their main-path shapes beside their bounds, their plain versions and,
     for K3 and K4, the one PyTorch call that computes the same function.
Then one JSON line of kernels, the card line, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from matcha_tpu_torch.apps.predict import predict_proba
from matcha_tpu_torch.apps.predict_multiway import (parse_interaction_file,
                                                    run_predict_multiway)
from matcha_tpu_torch.data.batcher import BucketedBatcher
from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.kernels.build import build
from matcha_tpu_torch.models.hypersagnn import (ModelDims,
                                                build_frozen_tables,
                                                encode_node_table,
                                                forward_buckets, init_model)
from matcha_tpu_torch.models.modules import mha_init, split_generator
from matcha_tpu_torch.ops import table_scatter as ts
from matcha_tpu_torch.ops.hyperedge_attention import (
    hyperedge_attention, hyperedge_attention_bwd_cuda,
    hyperedge_attention_bwd_plain, hyperedge_attention_cuda,
    hyperedge_attention_plain, pack_ln)
from matcha_tpu_torch.sampler import bloom as tb
from matcha_tpu_torch.sampler.bloom import build_bloom_dict
from matcha_tpu_torch.sampler.negative import ChromTable, sample_negatives
from matcha_tpu_torch.train.runtime import (Trainer, TrainSettings,
                                            _bucket_bce_and_preds, _leaves,
                                            _sample_all_negatives, _tree_map,
                                            load_model_bundle,
                                            save_model_bundle)

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
# kernel vs plain: f32 differs by summation order only; bf16 rounds at other
# places (the kernel where the TPU kernel rounds: f32 weights and v; the
# plain version where the XLA oracle rounds), a few bf16 ulps of |y| <= ~2
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
TRAIN_KS, TRAIN_BATCH, TRAIN_STEPS, CHECK_BATCH = (2, 3, 4, 5), 2048, 20, 512
# deterministic step: f32 card vs f32 CPU loss (relative) and grads
# (relative to each gradient's max); bf16 card vs f32 CPU loss (relative)
TOL_STEP_LOSS_F32, TOL_STEP_GRAD_F32, TOL_STEP_LOSS_BF16 = 1e-5, 1e-4, 2e-2


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


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
    """Phase 3: K1 against its plain version; -> the worst error per dtype."""
    cases = [(E, L, dt, True) for dt in ("float32", "bfloat16")
             for L in (3, 4, 5) for E in (10_000, 1_000, 37)]
    cases += [(1_000, 4, "float32", False), (1_000, 2, "bfloat16", False)]
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
    return worst


def check_scatter_bincount(device) -> dict:
    """K3 against index_add_ (f32 sums, 1e-5) and K4 against bincount
    (exact), at the training step's shape and a ragged one; -> worst K3
    error."""
    worst = 0.0
    for T, n, dt in [(114_688, 3_068, torch.float32),
                     (114_688, 3_068, torch.bfloat16),
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
              and torch.equal(got, ts.scatter_add_cuda(g, idx, n)))
        exact = torch.equal(cnt, torch.bincount(idx.long(),
                                                minlength=n).float())
        print(f"K3 vs index_add_: T={T} n={n} {dt} max_abs_err={err:.3e} "
              f"tol=1e-05 deterministic {'ok' if ok else 'FAIL'}; "
              f"K4 vs bincount exact {'ok' if exact else 'FAIL'}",
              flush=True)
        if not (ok and exact):
            fail(f"K3/K4 disagree with their plain versions at T={T}")
        worst = max(worst, err)
    return worst


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


def stage_split(bundle, inp, out) -> dict:
    """Host-clock seconds of each stage of one run_predict_multiway call
    (the same four calls it makes), synchronised after each."""
    split, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        split[name] = t1 - t0
        t0 = t1

    params, dims, genome, frozen = load_model_bundle(bundle, "cuda")
    lap("load_bundle_s")
    samples = parse_interaction_file(inp, genome)
    lap("parse_s")
    proba = predict_proba(params, frozen, dims, samples, BATCH)
    lap("score_s")
    np.savetxt(out, proba)
    lap("write_s")
    return split


def device_profile(fn) -> dict:
    """torch.profiler over one call of fn (after a warm call): device time
    by kernel, the device's idle share of the call's wall time, and the
    kernel launches."""
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
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(k[1] for k in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    return {"wall_ms_profiled": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3 if busy_us else "not measured",
            "device_idle_share": (1 - busy_us / wall_us) if busy_us
            else "not measured",
            "device_kernel_launches": sum(k[2] for k in kernels),
            "top_kernels": [{"name": n[:80], "ms": t / 1e3, "count": c}
                            for n, t, c in top]}


def profile_scoring(params, frozen, dims, samples) -> dict:
    """torch.profiler over one predict_proba call."""
    return device_profile(
        lambda: predict_proba(params, frozen, dims, samples, BATCH))


# ----------------------------------------------------------------- training
def launch_counts() -> dict:
    return {"K1": hyperedge_attention.launches,
            "K2": hyperedge_attention_bwd_cuda.launches,
            "K3": ts.scatter_add.launches, "K4": ts.bincount.launches}


def zero_launch_counts():
    hyperedge_attention.launches = 0
    hyperedge_attention_bwd_cuda.launches = 0
    ts.scatter_add.launches = 0
    ts.bincount.launches = 0


def check_counts(counts: dict, steps: int, what: str):
    """Each step launches K1 and K2 once per k >= 3, K3 and K4 once."""
    n_attn = sum(1 for k in TRAIN_KS if k >= 3)
    want = {"K1": n_attn * steps, "K2": n_attn * steps, "K3": steps,
            "K4": steps}
    print(f"{what}: launches {counts} (expected {want})", flush=True)
    if counts != want:
        fail(f"{what} launched {counts}, expected {want}")


def random_buckets(genome, rng, n_edges):
    """n_edges distinct-member hyperedges per k anywhere on the genome with
    quantile-like weights in [0.5, 1.5), as the JAX package's bench draws
    them."""
    n = genome.num_nodes
    out = {}
    for k in TRAIN_KS:
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


def deterministic_step(params, frozen, dims, xs, batch, ws, r, device):
    """Loss and gradients of one step with dropout off on fixed negatives
    and recon chromosome r: the merged (per-k) forward, weighted BCE and
    recon, alpha 1, beta 0.001."""
    p = _tree_map(lambda t: t.detach().to(device).clone().requires_grad_(True),
                  params)
    logits, recon = forward_buckets(
        p, frozen, dims, {k: v.to(device) for k, v in xs.items()},
        return_recon=True, attention_mode="per-k", recon_chrom=r)
    bce, _ = _bucket_bce_and_preds(
        logits, {k: (e.to(device), w.to(device)) for k, (e, w) in
                 batch.items()}, {k: w.to(device) for k, w in ws.items()})
    loss = bce + 0.001 * recon
    loss.backward()
    grads = [torch.zeros_like(t) if t.grad is None else t.grad
             for t in _leaves(p)]
    return float(loss.detach()), [g.float().cpu() for g in grads]


def check_deterministic_step(trainer, buckets, device) -> dict:
    """The same step (dropout off, negatives sampled once on the card, the
    same r) as f32 on the card, f32 on the CPU (the plain path) and bf16 on
    the card."""
    gen = torch.Generator().manual_seed(SEED + 4)
    batch, xs, ws = {}, {}, {}
    for k in TRAIN_KS:
        e, w = buckets[k]
        pos = torch.from_numpy(e[:CHECK_BATCH]).to(device)
        neg = sample_negatives(gen, pos, trainer.chrom_table, 0,
                               trainer.blooms[k], neg_num=3)
        batch[k] = (pos.cpu(), torch.from_numpy(w[:CHECK_BATCH]))
        xs[k] = torch.cat([pos, neg]).cpu()
        ws[k] = batch[k][1]
    fz = trainer.frozen
    cpu_frozen = fz._replace(features=tuple(f.cpu() for f in fz.features),
                             attr_table=fz.attr_table.cpu(),
                             inter_z=fz.inter_z.cpu(),
                             chrom_of_node=fz.chrom_of_node.cpu(),
                             chrom_bounds=fz.chrom_bounds.cpu())
    f32 = trainer.dims._replace(compute_dtype="float32")
    r = min(5, trainer.dims.num_chroms - 1)
    loss_cpu, g_cpu = deterministic_step(trainer.params, cpu_frozen, f32, xs,
                                         batch, ws, r, "cpu")
    loss_f32, g_f32 = deterministic_step(trainer.params, fz, f32, xs, batch,
                                         ws, r, device)
    loss_bf16, _ = deterministic_step(trainer.params, fz, trainer.dims, xs,
                                      batch, ws, r, device)
    out = {"loss_cpu_f32": loss_cpu, "loss_card_f32": loss_f32,
           "loss_card_bf16": loss_bf16,
           "loss_rel_err_f32": abs(loss_f32 - loss_cpu) / abs(loss_cpu),
           "loss_rel_err_bf16": abs(loss_bf16 - loss_cpu) / abs(loss_cpu),
           "positives_per_k": CHECK_BATCH, "recon_chrom": r}
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
    print(f"deterministic step vs f32 on the CPU: {json.dumps(out)} "
          f"(tol loss f32 {TOL_STEP_LOSS_F32}, grads f32 "
          f"{TOL_STEP_GRAD_F32}, loss bf16 {TOL_STEP_LOSS_BF16})",
          flush=True)
    if (out["loss_rel_err_f32"] > TOL_STEP_LOSS_F32
            or out["grad_rel_to_max_err_f32"] > TOL_STEP_GRAD_F32
            or out["loss_rel_err_bf16"] > TOL_STEP_LOSS_BF16):
        fail("the training step on the card disagrees with the CPU")
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
    check_counts(launch_counts(), 1, "stage-1 step")
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
    return {"counts": counts, "step_check": step_check}


def time_training_kernels(device, card) -> dict:
    """K2, K3 and K4 by CUDA events at the training step's shapes, beside
    their bounds from these shapes, their plain versions and, for K3 and
    K4, the one PyTorch call that computes the same function."""
    out = {}
    E, dt = 4 * TRAIN_BATCH, "bfloat16"
    for L in (3, 4, 5):
        x, args = attention_inputs(device, E, L, dt)
        g = torch.randn(x.shape, device=device).to(x.dtype)
        ms = cuda_ms(lambda: hyperedge_attention_bwd_cuda(x, *args, g,
                                                          N_HEAD, True))
        plain = cuda_ms(lambda: hyperedge_attention_bwd_plain(
            x, *args, g, N_HEAD, True))
        b_ms, b_by = bound_ms(*attention_bwd_work(E, L, dt), dt)
        out[f"K2_L{L}"] = {"E": E, "L": L, "dtype": dt, "ms": ms,
                           "plain_ms": plain, "bound_ms": b_ms,
                           "bound_by": b_by}
    T, n = 4 * TRAIN_BATCH * sum(TRAIN_KS), 3_068
    gen = torch.Generator().manual_seed(SEED + 6)
    g = torch.randn((T, DIM), generator=gen).to(device, torch.bfloat16)
    idx = torch.randint(0, n, (T,), generator=gen,
                        dtype=torch.int32).to(device)
    g32, idx64 = g.float(), idx.long()
    acc = torch.zeros((n, DIM), device=device)
    k3_bytes = T * DIM * 2 + T * 4 + n * DIM * 4
    out["K3"] = {
        "T": T, "n": n, "d": DIM, "dtype": "bfloat16",
        "ms": cuda_ms(lambda: ts.scatter_add_cuda(g, idx, n)),
        "plain_ms": cuda_ms(lambda: ts.scatter_add_plain(g, idx, n)),
        "library_ms": cuda_ms(lambda: acc.index_add_(0, idx64, g32)),
        "library": "torch.Tensor.index_add_",
        "bound_ms": k3_bytes / PEAK_BYTES * 1e3, "bound_by": "bytes"}
    out["K4"] = {
        "T": T, "n": n,
        "ms": cuda_ms(lambda: ts.bincount_cuda(idx, n)),
        "plain_ms": cuda_ms(lambda: ts.bincount_plain(idx, n)),
        "library_ms": cuda_ms(lambda: torch.bincount(idx64, minlength=n)),
        "library": "torch.bincount",
        "bound_ms": (T * 4 + n * 4) / PEAK_BYTES * 1e3, "bound_by": "bytes"}
    print(json.dumps({"metric": "training_kernels", **out, "card": card}),
          flush=True)
    return out


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
    worst_scatter = check_scatter_bincount(device)
    check_bloom(device)

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
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run_predict_multiway(bundle, inp, out, batch_size=BATCH,
                                 device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        splits = [stage_split(bundle, inp, out) for _ in range(3)]
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
    plain_ms = cuda_ms(lambda: hyperedge_attention_plain(x, *args, N_HEAD,
                                                         True))
    flops, nbytes = attention_work(E, L, dt)
    b_ms, b_by = bound_ms(flops, nbytes, dt)
    print(json.dumps({
        "metric": "k1_hyperedge_attention_fwd", "E": E, "L": L, "dtype": dt,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        "launches_per_predict_multiway": launches, "library_ms": None,
        "library_note": "no single PyTorch call computes K1 (LN + q/k/v + "
                        "attention + fc1)", "card": card}), flush=True)

    # 6. training at full width, 7. training times
    train = train_phase(genome, device, card)
    tk = time_training_kernels(device, card)
    counts = train["counts"]

    k2 = tk["K2_L5"]
    print(json.dumps({"kernels": [
        {"name": "hyperedge_attention_fwd", "route": "cuda",
         "source": "matcha_tpu_torch/csrc/hyperedge_attention_fwd.cu",
         "replaces": "matcha_tpu/ops/hyperedge_attention.py:454",
         "launches": counts["K1"], "launches_serving": launches,
         "max_abs_err": worst["bfloat16"],
         "max_abs_err_f32": worst["float32"], "ms": ms,
         "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": None},
        {"name": "hyperedge_attention_bwd", "route": "cuda",
         "source": "matcha_tpu_torch/csrc/hyperedge_attention_bwd.cu",
         "replaces": "matcha_tpu/ops/hyperedge_attention.py:672",
         "launches": counts["K2"],
         "max_abs_err": worst_bwd["bfloat16"]["gx_abs"],
         "max_err_rel_to_max": worst_bwd["bfloat16"]["rel_to_max"],
         "max_err_rel_to_max_f32": worst_bwd["float32"]["rel_to_max"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None},
        {"name": "scatter_add", "route": "cuda",
         "source": "matcha_tpu_torch/csrc/table_scatter.cu",
         "replaces": "matcha_tpu/ops/table_scatter.py:62",
         "launches": counts["K3"], "max_abs_err": worst_scatter,
         "ms": tk["K3"]["ms"], "plain_ms": tk["K3"]["plain_ms"],
         "bound_ms": tk["K3"]["bound_ms"], "bound_by": "bytes",
         "library_ms": tk["K3"]["library_ms"]},
        {"name": "bincount", "route": "cuda",
         "source": "matcha_tpu_torch/csrc/table_scatter.cu",
         "replaces": "matcha_tpu/ops/table_scatter.py:112",
         "launches": counts["K4"], "max_abs_err": 0.0,
         "ms": tk["K4"]["ms"], "plain_ms": tk["K4"]["plain_ms"],
         "bound_ms": tk["K4"]["bound_ms"], "bound_by": "bytes",
         "library_ms": tk["K4"]["library_ms"]}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
