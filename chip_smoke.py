#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root, on a machine with a GPU

Phases, all in this process; any failure exits non-zero before the last line:
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile every kernel of the path from csrc/ with nvcc (sm_90a).
  3. kernels vs plain: each kernel's wrapper against its plain PyTorch version
     on the card, over the shapes the serving path gives it (f32 with TF32
     off, and bf16), with the tolerances stated below.
  4. end to end at full width: the hg38 1 Mb genome (23 chromosomes, 3,067
     nodes), random weights from a seed at dim 64 / 8 heads in bf16, saved as
     a bundle; run_predict_multiway over 20,000 candidates for each of
     k = 2..5 (batch 10,000).  The launch counts are zeroed just before and
     read just after; the probabilities are checked for range and against
     an f32 copy of the bundle on the CPU (the plain path) and on the card.
  5. times: run_predict_multiway wall and its stages (host clock, median of
     3), a torch.profiler summary of the scoring stage, and each kernel by
     CUDA events (median of repeats after warm-up) beside its bound from
     this run's shapes.
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

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from matcha_tpu_torch.apps.predict import predict_proba
from matcha_tpu_torch.apps.predict_multiway import (parse_interaction_file,
                                                    run_predict_multiway)
from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.kernels.build import build
from matcha_tpu_torch.models.hypersagnn import ModelDims, init_model
from matcha_tpu_torch.models.modules import mha_init
from matcha_tpu_torch.ops.hyperedge_attention import (
    hyperedge_attention, hyperedge_attention_cuda, hyperedge_attention_plain,
    pack_ln)
from matcha_tpu_torch.train.runtime import (load_model_bundle,
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


def profile_scoring(params, frozen, dims, samples) -> dict:
    """torch.profiler over one predict_proba call: device time by kernel
    and the device's idle share of the call's wall time."""
    predict_proba(params, frozen, dims, samples, BATCH)    # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict_proba(params, frozen, dims, samples, BATCH)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(k[1] for k in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    return {"wall_ms_profiled": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3 if busy_us else "not measured",
            "device_idle_share": (1 - busy_us / wall_us) if busy_us
            else "not measured",
            "top_kernels": [{"name": n[:80], "ms": t / 1e3, "count": c}
                            for n, t, c in top]}


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

    # 4. end to end, full width
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

        # 5. times
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

    print(json.dumps({"kernels": [{
        "name": "hyperedge_attention_fwd", "route": "cuda",
        "source": "matcha_tpu_torch/csrc/hyperedge_attention_fwd.cu",
        "replaces": "matcha_tpu/ops/hyperedge_attention.py:391",
        "launches": launches, "max_abs_err": worst["bfloat16"],
        "max_abs_err_f32": worst["float32"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
