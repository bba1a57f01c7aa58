"""The port's CUDA kernels against their plain PyTorch versions, on the card:
K1 (attention forward), K2 (its backward), K3 (scatter-add), K4 (bincount),
K5 (phase-1 proposals), K6 (the fused classifier tail, forward and
backward), K7 (the sampler's chain, against the eager chain bit for
bit) and K8 (the node-table encode, against the eager chain).

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The file
imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: f32 with TF32 off differs by summation order only (1e-4).  In
bf16 the kernels' tensor-core routes round product operands where the plain
versions round them, so the forward outputs differ by summation order and
the rounding flips it causes, a few bf16 ulps of values up to ~2 (atol =
rtol = 2e-2), and K2's gradients by up to 3e-2 of each one's largest entry.
K3 sums in f32 (1e-5); K4 counts exactly.  The last test drives a model
whose shapes the fixed-width kernels do not take (dim 16, k = 7 proposals)
through a training step, scoring and the sampler on the card: it launches
none of K1, K2, K5 and K6 and matches the same computation on the CPU.  A
scoring request, ragged and as an array, equals the per-candidate loop it
replaced bit for bit and makes one copy and one sync.  The
last three hold the closed-form pair scorer, a per-occurrence training step
and the recon decode with bf16 operands on the card against the CPU; then
a device-resident epoch against the indexed epoch on its rows, bit for
bit.  The walk pretraining's: K3 and K4 at the SGNS shapes, one SGNS step card
against CPU, and the co-occurrence scatter's determinism.  A bundle trained
through the CLI on phase 18's inputs at a small size, its denoise and
predict_multiway on the card against the CPU.  The last runs
only on a machine with several cards: meshes of one rank per card on NCCL
against one rank.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from matcha_tpu_torch.models.modules import mha_init
from matcha_tpu_torch.ops import fused_tail as tf
from matcha_tpu_torch.ops import hyperedge_attention as ta
from matcha_tpu_torch.ops import propose as tp
from matcha_tpu_torch.ops import table_scatter as ts

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, E, L, dtype, n_head=8, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = mha_init(gen, n_head, 64, 64, 64, 64)
    for name in ("ln_q", "ln_k", "ln_v"):
        p[name]["g"] = 1 + 0.1 * torch.randn(64, generator=gen)
        p[name]["b"] = 0.1 * torch.randn(64, generator=gen)
    x = np.tanh(np.random.default_rng(seed).standard_normal((E, L, 64)))
    args = [ta.pack_ln(p), p["wq"], p["wk"], p["wv"], p["fc1"]["w"],
            p["fc1"]["b"]]
    return (torch.tensor(x, dtype=dtype, device=device),
            [a.to(device) for a in args])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_head", [2, 4, 8])
@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("L", [2, 3, 4, 5, 6, 7, 8])
def test_kernel_matches_plain(cuda, dtype, n_head, diag, L):
    """Each L the kernel takes, E not a multiple of any tile (64 // L edges
    on the tensor-core route, bf16; 16 or 8 on the CUDA-core route, f32);
    4 heads is a tensor-parallel rank's block of 8 on a model axis of 2
    (a cluster of 4 blocks on the tensor-core route)."""
    E = 997 + 3 * L
    x, args = _inputs(cuda, E, L, dtype, n_head=n_head, seed=L)
    before = ta.hyperedge_attention.launches
    got = ta.hyperedge_attention(x, *args, n_head, diag)
    assert ta.hyperedge_attention.launches == before + 1
    ref = ta.hyperedge_attention_plain(x, *args, n_head, diag)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
def test_k1_is_deterministic(cuda):
    x, args = _inputs(cuda, 8192, 5, torch.bfloat16)
    a = ta.hyperedge_attention_cuda(x, *args, 8, True)
    assert torch.equal(a, ta.hyperedge_attention_cuda(x, *args, 8, True))


def _max_rel_err(got, ref):
    """max |got - ref| relative to max |ref|."""
    ref = ref.float()
    return float((got.float() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,L,diag", [(1037, 5, True), (37, 3, True),
                                      (500, 4, False), (64, 8, True)])
def test_k2_matches_plain_autograd(cuda, dtype, E, L, diag):
    x, args = _inputs(cuda, E, L, dtype)
    g = torch.tensor(np.random.default_rng(1).standard_normal(x.shape),
                     dtype=dtype, device=cuda)
    ins = [t.clone().requires_grad_(True) for t in [x] + args]
    before = ta.hyperedge_attention_bwd_cuda.launches
    ta.hyperedge_attention(*ins, 8, diag).backward(g)
    assert ta.hyperedge_attention_bwd_cuda.launches == before + 1
    ref = ta.hyperedge_attention_bwd_plain(x, *args, g, 8, diag)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    names = ["gx", "gln", "gwq", "gwk", "gwv", "gfw", "gfb"]
    for name, t, r in zip(names, ins, ref):
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape
        assert _max_rel_err(t.grad, r) <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("L", [2, 3, 4, 5, 6, 7, 8])
def test_k2_every_l_and_ragged_e(cuda, dtype, L, diag):
    """Each L the kernel takes, E not a multiple of any tile: bf16 (the
    tensor-core route) at 3e-2 and f32 (the CUDA-core route) at 1e-4 of each
    gradient's max."""
    E = 997 + 3 * L
    x, args = _inputs(cuda, E, L, dtype, seed=L)
    g = torch.tensor(np.random.default_rng(L).standard_normal(x.shape),
                     dtype=dtype, device=cuda)
    got = ta.hyperedge_attention_bwd_cuda(x, *args, g, 8, diag)
    ref = ta.hyperedge_attention_bwd_plain(x, *args, g, 8, diag)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    names = ["gx", "gln", "gwq", "gwk", "gwv", "gfw", "gfb"]
    for name, a, r in zip(names, got, ref):
        assert a.shape == r.shape and bool(torch.isfinite(a).all()), name
        assert _max_rel_err(a, r) <= tol, name


@pytest.mark.cuda
def test_k2_is_deterministic(cuda):
    x, args = _inputs(cuda, 3000, 5, torch.bfloat16)
    g = torch.randn(x.shape, device=cuda).to(torch.bfloat16)
    a = ta.hyperedge_attention_bwd_cuda(x, *args, g, 8, True)
    b = ta.hyperedge_attention_bwd_cuda(x, *args, g, 8, True)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


# K3's plan (csrc/table_scatter.cu): the 100 kb step, an SGNS minibatch at
# the 100 kb vocabulary, a table past the old one-chunk point, the old
# route boundary (6,144 rows), both sides of each limit of the one-launch
# local route (T <= 32,768 tokens, d <= 128, at most 1,024 rows for each of
# 132 blocks) and a table whose bands take several sort passes (more than
# 3,072 bands of 3,072 rows)
K3_PLAN_SHAPES = [(114_688, 30_345, 64), (4096, 30_345, 64),
                  (114_688, 600_000, 64), (114_688, 6144, 64),
                  (114_688, 6145, 64), (32_768, 3067, 64), (32_769, 3067, 64),
                  (2000, 300, 128), (2000, 300, 129), (4096, 135_168, 64),
                  (4096, 135_169, 64), (40_000, 9_500_000, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,n,d", [(114_688, 3068, 64), (1001, 300, 64),
                                   (3, 5, 16), (0, 7, 64), *K3_PLAN_SHAPES])
def test_k3_matches_index_add(cuda, dtype, T, n, d):
    rng = np.random.default_rng(T + n)
    g = torch.tensor(rng.standard_normal((T, d)), dtype=dtype, device=cuda)
    idx = torch.tensor(rng.integers(0, n, T), dtype=torch.int32, device=cuda)
    before = ts.scatter_add.launches
    got = ts.scatter_add(g, idx, n)
    assert ts.scatter_add.launches == before + 1
    ref = torch.zeros((n, d), device=cuda).index_add_(0, idx.long(),
                                                      g.float())
    assert got.dtype == torch.float32 and got.shape == (n, d)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ts.scatter_add(g, idx, n))   # deterministic


def skewed_ids(kind: str, rng, T: int, n: int) -> np.ndarray:
    """Zipf (s = 1.1) over the rows in a random row order, all on one row, a
    hub row holding half of T, ids in reverse order, or ids outside [0, n)
    mixed in; test_torch_table_scatter.py holds the plain versions against
    JAX on the same ids."""
    if kind == "zipf":
        p = 1.0 / np.arange(1, n + 1) ** 1.1
        ids = rng.permutation(n)[rng.choice(n, T, p=p / p.sum())]
    elif kind == "one_row":
        ids = np.full(T, n // 2)
    elif kind == "hub":
        ids = rng.integers(0, n, T)
        ids[rng.permutation(T)[:T // 2]] = 3
    elif kind == "reverse":
        ids = np.sort(rng.integers(0, n, T))[::-1].copy()
    else:                                  # "out_of_range"
        ids = rng.integers(0, n, T)
        pick = rng.permutation(T)[:T // 4]
        ids[pick] = rng.choice([-1, -7, n, n + 5, 2 ** 31 - 1, -2 ** 31],
                               len(pick))
    return ids.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["zipf", "one_row", "hub", "reverse",
                                  "out_of_range"])
@pytest.mark.parametrize("T,n,d", [(114_688, 3068, 64), (5000, 60_000, 64),
                                   (3000, 300, 1), (2000, 300, 1536),
                                   (4097, 1000, 48), *K3_PLAN_SHAPES])
def test_k3_skewed_and_out_of_range_ids(cuda, dtype, kind, T, n, d):
    """g in multiples of 1/4 makes every sum exact in f32, whatever the
    order, so the kernel meets the plain version (index_add_ with the
    out-of-range ids dropped) at 1e-5 even on a row of 114,688 tokens; with
    normal g, two calls give the same bits."""
    rng = np.random.default_rng(T + n + d)
    idx = torch.tensor(skewed_ids(kind, rng, T, n), device=cuda)
    g = torch.tensor(rng.integers(-8, 9, (T, d)) / 4, dtype=dtype,
                     device=cuda)
    before = ts.scatter_add.launches
    got = ts.scatter_add(g, idx, n)
    assert ts.scatter_add.launches == before + 1
    ref = ts.scatter_add_plain(g, idx, n)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    g = torch.tensor(rng.standard_normal((T, d)), dtype=dtype, device=cuda)
    assert torch.equal(ts.scatter_add(g, idx, n), ts.scatter_add(g, idx, n))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "zipf", "hub", "out_of_range"])
@pytest.mark.parametrize("T,n", [(114_688, 3068), (1001, 300), (0, 7),
                                 (5000, 60_000), (70_001, 1_000_000)])
def test_k4_matches_bincount(cuda, kind, T, n):
    """Both routes (a whole histogram per block up to 16,384 rows, the
    cluster's shared histogram in bands above, in two passes at a million
    rows), every id mix, odd T and an idx that starts off a 16-byte
    boundary: exactly torch.bincount's counts of the ids in [0, n)."""
    rng = np.random.default_rng(T + n)
    ids = (rng.integers(0, n, T).astype(np.int32) if kind == "uniform"
           else skewed_ids(kind, rng, T, n))
    idx = torch.tensor(ids, device=cuda)
    before = ts.bincount.launches
    got = ts.bincount(idx, n)
    assert ts.bincount.launches == before + 1
    keep = idx[(idx >= 0) & (idx < n)].long()
    assert torch.equal(got, torch.bincount(keep, minlength=n).float())
    if T > 1:
        shifted = idx[1:]                 # 4 bytes past the allocation
        keep = shifted[(shifted >= 0) & (shifted < n)].long()
        assert torch.equal(ts.bincount(shifted, n),
                           torch.bincount(keep, minlength=n).float())


@pytest.mark.cuda
def test_k4_is_one_launch(cuda):
    """One call is one kernel on the device (no memset, no second pass)."""
    from torch.profiler import ProfilerActivity, profile
    idx = torch.randint(0, 3068, (114_688,), dtype=torch.int32, device=cuda)
    ts.bincount(idx, 3068)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ts.bincount(idx, 3068)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1, [e.name for e in kernels]


@pytest.mark.cuda
def test_table_gather_backward_launches_k3(cuda):
    rng = np.random.default_rng(3)
    table = torch.tensor(rng.standard_normal((300, 64)), dtype=torch.bfloat16,
                         device=cuda, requires_grad=True)
    idx = torch.tensor(rng.integers(0, 300, 4096), device=cuda)
    w = torch.randn((4096, 64), device=cuda).to(torch.bfloat16)
    before = ts.scatter_add.launches
    (ts.table_gather(table, idx) * w).sum().backward()
    assert ts.scatter_add.launches == before + 1
    assert table.grad.dtype == torch.bfloat16
    ref = ts.scatter_add_plain(w, idx, 300)
    torch.testing.assert_close(table.grad.float(), ref, rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    x, args = _inputs(cuda, 16, 3, torch.float32)
    with pytest.raises(ValueError, match="L must be"):
        ta.hyperedge_attention_cuda(x[:, :1].contiguous(), *args, 8, True)
    with pytest.raises(ValueError, match="contiguous"):
        ta.hyperedge_attention_cuda(x.permute(1, 0, 2).contiguous()
                                    .permute(1, 0, 2), *args, 8, True)
    with pytest.raises(ValueError, match="float32"):
        ta.hyperedge_attention_cuda(x, args[0], args[1].half(), *args[2:], 8,
                                    True)


def _propose_inputs(device, k, n, T=8, seed=0):
    """The sampler's layout: orig (n, k) int32, change (n, k) bool, lo/hi
    (n, k) f32, u (T, n, k) f32, a few top uniforms on the f32 guard."""
    rng = np.random.default_rng(seed)
    orig = np.sort(rng.integers(1, 3000, size=(n, k)), axis=1)
    change = rng.random((n, k)) < 0.5
    change[np.arange(n), rng.integers(0, k, n)] = True
    lo = rng.integers(1, 1000, size=(n, k)).astype(np.float32)
    hi = lo + rng.integers(1, 2000, size=(n, k)).astype(np.float32)
    u = rng.random((T, n, k), dtype=np.float32)
    u[0, :7, :] = np.nextafter(np.float32(1), np.float32(0))   # the guard
    return [torch.tensor(a, device=device) for a in
            (orig.astype(np.int32), change, lo, hi, u)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("n", [6144, 1000, 37])
@pytest.mark.parametrize("T", [1, 5, 8, 16])
def test_k5_matches_plain_bit_for_bit(cuda, k, n, T):
    """Every k, ragged n (not a multiple of a block or of a lane group),
    T from one lane per row to 16, S = 1, 2, 4 and T."""
    args = _propose_inputs(cuda, k, n, T=T, seed=k * n + T)
    for md, S in [(0, 1), (0, 2), (1, 4), (3, T)]:
        before = tp.propose_phase1.launches
        probe, has = tp.propose_phase1(*args, min_distance=md, max_probes=S)
        assert tp.propose_phase1.launches == before + 1
        rp, rh = tp.propose_phase1_plain(*args, min_distance=md,
                                         max_probes=S)
        S = min(S, T)
        assert probe.shape == (S, n, k) and has.dtype == torch.bool
        assert torch.equal(probe, rp) and torch.equal(has, rh)


@pytest.mark.cuda
@pytest.mark.parametrize("hard_ratio", [1.0, 0.6])
def test_k5_sampler_pallas_equals_xla(cuda, hard_ratio):
    """On the card the "pallas" sampler (K5) gives the "xla" sampler's
    negatives and counts for one generator, at every k K5 takes."""
    from matcha_tpu_torch.genome import GenomeBins
    from matcha_tpu_torch.sampler import negative as tn
    from matcha_tpu_torch.sampler.bloom import build_bloom
    genome = GenomeBins(["chr1", "chr2", "chr3"],
                        [248_956_422, 242_193_529, 198_295_559], 1_000_000)
    table = tn.ChromTable.from_genome(genome, device=cuda)
    rng = np.random.default_rng(5)
    for k in range(2, 7):
        pos = np.sort(rng.integers(1, genome.num_nodes + 1, (4000, k)),
                      axis=1)
        pos = pos[(np.diff(pos, axis=1) > 0).all(axis=1)][:2048]
        bloom = build_bloom(pos, device=cuda)
        out = {}
        for impl in ("xla", "pallas"):
            before = tp.propose_phase1.launches
            neg, st = tn.sample_negatives_with_stats(
                torch.Generator().manual_seed(k), torch.tensor(pos,
                                                               device=cuda),
                table, 0, bloom, max_probes=4 if k == 2 else 2,
                hard_ratio=hard_ratio, propose_impl=impl)
            assert tp.propose_phase1.launches == before + (impl == "pallas")
            out[impl] = (neg, [int(v) for v in st.values()])
        assert torch.equal(out["xla"][0], out["pallas"][0]), k
        assert out["xla"][1] == out["pallas"][1], k


@pytest.mark.cuda
def test_k5_is_one_launch_and_one_allocation(cuda):
    """One call is one kernel on the device and one allocation (probe and
    has share it); a non-contiguous input raises instead of being copied."""
    from torch.profiler import ProfilerActivity, profile
    args = _propose_inputs(cuda, 5, 6144)
    tp.propose_phase1(*args, min_distance=0, max_probes=2)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tp.propose_phase1(*args, min_distance=0, max_probes=2)
        torch.cuda.synchronize()
    after = torch.cuda.memory_stats()["allocation.all.allocated"]
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1, [e.name for e in kernels]
    assert after - before == 1
    wide = torch.zeros((6, 6144), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match=r"float32 \(6144, 5\) on cuda:0 "
                                         r"\(contiguous: False\)"):
        tp.propose_phase1(args[0], args[1], wide[:5].T, args[3], args[4],
                          min_distance=0, max_probes=2)
    with pytest.raises(ValueError, match=r"True\), torch.int32 \(6144, 5\)"):
        tp.propose_phase1(args[0], args[1].to(torch.int32), *args[2:],
                          min_distance=0, max_probes=2)


# ------------------------------------------------ K7: the sampler's chain
def _k7_problem(device, k, b, seed=0, dense=False, blocked=True):
    """b distinct sorted positives of size k on three chromosomes of 60, 40
    and 30 nodes, their chromosome table and host bounds, and a Bloom
    filter: of the positives (sparse), or of 20,000 random rows at
    capacity 10 (dense: every bit set, every candidate a hit); blocked or
    classic."""
    from matcha_tpu_torch.genome import GenomeBins
    from matcha_tpu_torch.sampler import negative as tn
    from matcha_tpu_torch.sampler.bloom import build_bloom
    genome = GenomeBins(["chr1", "chr2", "chr3"],
                        [60_000_000, 40_000_000, 30_000_000], 1_000_000)
    rng = np.random.default_rng(seed)
    N = genome.num_nodes
    pos = np.sort(rng.integers(1, N + 1, (4 * b, k)), axis=1)
    pos = pos[(np.diff(pos, axis=1) > 0).all(axis=1)][:b].astype(np.int32)
    rows = np.sort(rng.integers(1, N + 1, (20_000, k)), axis=1) if dense \
        else pos
    bloom = build_bloom(rows, capacity=10 if dense else None,
                        error_rate=1e-3 if blocked else 1e-4, device=device)
    assert bloom.blocked == blocked
    return (torch.tensor(pos, device=device),
            tn.ChromTable.from_genome(genome, device=device),
            tuple((int(s), int(e)) for s, e in genome.chrom_range), bloom)


def _sampled(seed, *args, eager=False, **kw):
    """sample_negatives_with_stats from a generator seeded ``seed``, on K7
    or (eager=True) on the eager chain -> (negatives, counts, K7 launches,
    K5 launches, phase-2 rounds)."""
    from matcha_tpu_torch import telemetry
    from matcha_tpu_torch.ops import sample_negatives as sn
    from matcha_tpu_torch.sampler import negative as tn
    before = (sn.sample_negatives_cuda.launches, tp.propose_phase1.launches)
    with pytest.MonkeyPatch.context() as mp, telemetry.unit("step") as u:
        if eager:
            mp.setattr(tn, "_sample_k7", tn._sample_eager)
        neg, st = tn.sample_negatives_with_stats(
            torch.Generator().manual_seed(seed), *args, **kw)
        torch.cuda.synchronize()
    return (neg, [int(v) for v in st.values()],
            sn.sample_negatives_cuda.launches - before[0],
            tp.propose_phase1.launches - before[1], u.counts.get("rounds", 0))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("T,S", [(1, 1), (8, 2), (8, 4), (16, 8)])
def test_k7_equals_the_eager_chain_bit_for_bit(cuda, k, T, S):
    """K7 against the eager chain from one generator: the same negatives
    and counts, over blocked and classic filters, hard_ratio 1 and 0.5,
    min_distance 0 and 2, the Trainer's host bounds and the node2chrom
    gather, n = 6,144 and a ragged 2,049 (a multiple of no block); one K7
    launch plus one per phase-2 round, none on the eager side."""
    for blocked in (True, False):
        for b in (2048, 683):
            pos, table, bounds, bloom = _k7_problem(cuda, k, b, seed=k * T + b,
                                                    blocked=blocked)
            for hard in (1.0, 0.5):
                for md in (0, 2):
                    for cb in (bounds, None):
                        args = (pos, table, md, bloom)
                        kw = dict(max_trials=T, max_probes=S, hard_ratio=hard,
                                  chrom_bounds=cb)
                        seed = 1000 * k + 10 * T + S + md
                        neg, st, n7, _, rounds = _sampled(seed, *args, **kw)
                        ref, rst, e7, _, _ = _sampled(seed, *args, eager=True,
                                                      **kw)
                        what = (blocked, b, hard, md, cb is None)
                        assert torch.equal(neg, ref), what
                        assert st == rst and st[2] == 3 * b, what
                        assert n7 == 1 + rounds and e7 == 0, what


@pytest.mark.cuda
@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("k", [3, 4])
def test_k7_dense_filter_runs_every_round_and_both_fallbacks(cuda, k, impl,
                                                             blocked):
    """A filter that holds every candidate: no row is ever accepted, so all
    32 phase-2 rounds run (33 K7 launches); min_distance 12 leaves many
    rows no valid candidate (chr3's 30 nodes hold no valid row of 4), so
    rows fall back to their positive as well as to a Bloom hit; the eager
    chain agrees on all of it."""
    pos, table, bounds, bloom = _k7_problem(cuda, k, 683, seed=7, dense=True,
                                            blocked=blocked)
    args = (pos, table, 12, bloom)
    kw = dict(max_probes=2, chrom_bounds=bounds, propose_impl=impl)
    neg, st, n7, n5, rounds = _sampled(3, *args, **kw)
    ref, rst, _, _, ref_rounds = _sampled(3, *args, eager=True, **kw)
    assert torch.equal(neg, ref) and st == rst
    assert rounds == ref_rounds == 32 and n7 == 33
    assert n5 == (impl == "pallas")
    assert st[0] > 0 and st[1] > 0 and st[0] + st[1] == 3 * 683


@pytest.mark.cuda
@pytest.mark.parametrize("hard_ratio", [1.0, 0.6])
@pytest.mark.parametrize("dense", [False, True])
def test_k7_pallas_route_equals_xla(cuda, hard_ratio, dense):
    """propose_impl="pallas" on the card is K5 and then K7's selection: the
    same negatives and counts as "xla" (K7's phase 1) and the eager chain,
    at every k K5 takes."""
    for k in range(2, 7):
        pos, table, bounds, bloom = _k7_problem(cuda, k, 2048, seed=k,
                                                dense=dense)
        args = (pos, table, 0, bloom)
        kw = dict(max_probes=4 if k == 2 else 2, hard_ratio=hard_ratio,
                  chrom_bounds=bounds, extra_rounds=4)
        got = {impl: _sampled(k, *args, propose_impl=impl, **kw)
               for impl in ("xla", "pallas")}
        ref = _sampled(k, *args, eager=True, propose_impl="xla", **kw)
        for impl, (neg, st, n7, n5, rounds) in got.items():
            assert torch.equal(neg, ref[0]) and st == ref[1], (k, impl)
            assert n7 == 1 + rounds and n5 == (impl == "pallas"), (k, impl)


@pytest.mark.cuda
def test_k7_takes_no_k_above_6(cuda):
    """k = 7 is past the sorting networks: the eager chain runs and no K7
    (nor K5, with a warning for "pallas") is launched."""
    pos, table, bounds, bloom = _k7_problem(cuda, 7, 300)
    for impl in ("xla", "pallas"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            neg, st, n7, n5, _ = _sampled(4, pos, table, 0, bloom,
                                          chrom_bounds=bounds,
                                          propose_impl=impl)
        assert n7 == 0 and n5 == 0 and neg.shape == (900, 7)
        assert bool((neg[:, 1:] > neg[:, :-1]).all())


@pytest.mark.cuda
def test_k7_step_and_device_epoch_equal_the_eager_sampler(cuda, monkeypatch):
    """A training step and a device-resident epoch at dim 64 / 8 heads in
    bf16 give the same losses and parameters, bit for bit, whether the
    sampler runs on K7 or on the eager chain; the K7 side records
    ``launches.K7`` in its epoch, one per size and step plus the rounds."""
    from matcha_tpu_torch.models import hypersagnn as th
    from matcha_tpu_torch.ops import sample_negatives as sn
    from matcha_tpu_torch.sampler import negative as tn
    from matcha_tpu_torch.train import runtime as tr
    monkeypatch.setattr(th, "_FUSE_TAIL", False)
    _, dims, params, frozen, blooms, table, buckets = _small_problem(
        cuda, ks=(2, 3, 4), dim=64, n_head=8)
    dims = dims._replace(compute_dtype="bfloat16")
    settings = tr.TrainSettings(alpha=1.0, beta=0.001, token_stream="merged")
    batch = {k: (torch.tensor(e[:128], device=cuda),
                 torch.ones(128, device=cuda)) for k, e in buckets.items()}
    train = {k: (e[:50], np.ones(50, np.float32))
             for k, e in buckets.items()}
    out = {}
    for eager in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            if eager:
                mp.setattr(tn, "_sample_k7", tn._sample_eager)
            t = tr.Trainer(params, frozen, dims, table, settings,
                           blooms=blooms, seed=5)
            before = sn.sample_negatives_cuda.launches
            aux = t.train_step(batch)
            step_launches = sn.sample_negatives_cuda.launches - before
            t.prepare_device_epochs(train, 32, 3)
            got = t.train_epoch_device()
            out[eager] = (aux, step_launches, got, t)
    (aux, n7, got, a), (aux_e, e7, got_e, b) = out[False], out[True]
    assert n7 >= 3 and e7 == 0
    assert a.last_epoch.counts["launches.K7"] >= 9
    assert b.last_epoch.counts["launches.K7"] == 0
    for key in aux:
        assert torch.equal(aux[key], aux_e[key]), key
    for key in ("bce", "recon", "fallback_bloom_rate", "fallback_orig_rate",
                "metrics"):
        assert got[key] == got_e[key], key
    for x, y in zip(tr._leaves(a.params), tr._leaves(b.params)):
        assert torch.equal(x, y)


def _tail_inputs(device, T, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, shift=0.0, dt=torch.float32):
        return torch.tensor(rng.standard_normal(shape) * scale + shift,
                            dtype=dt, device=device)
    return [t(T, 64, dt=dtype), t(T, 64, dt=dtype),
            torch.stack([t(64, scale=0.1, shift=s) for s in
                         (1, 0, 1, 0, 1, 0)]),
            t(64, 64, scale=0.1), t(64, scale=0.1), t(64, 64, scale=0.1),
            t(64, scale=0.1), t(64, 1, scale=0.3), t(1, scale=0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("T", [114_688, 1000, 65, 3])
def test_k6_matches_plain(cuda, dtype, train, T):
    args = _tail_inputs(cuda, T, dtype, seed=T)
    g = torch.tensor(np.random.default_rng(1).standard_normal((T, 1)),
                     dtype=torch.float32, device=cuda)
    seed = 12345
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    before = tf.fused_tail_fwd_cuda.launches
    got = tf.fused_tail(*args, seed, 0.3, 0.4, train)
    assert tf.fused_tail_fwd_cuda.launches == before + 1
    ref = tf.fused_tail_plain(*args, seed, 0.3, 0.4, train)
    assert got.shape == (T, 1) and got.dtype == torch.float32
    assert _max_rel_err(got, ref) <= tol
    before = tf.fused_tail_bwd_cuda.launches
    grads = tf.fused_tail_bwd_cuda(*args, g, seed, 0.3, 0.4, train)
    assert tf.fused_tail_bwd_cuda.launches == before + 1
    refs = tf.fused_tail_bwd_plain(*args, g, seed, 0.3, 0.4, train)
    for i, (a, b) in enumerate(zip(grads, refs)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        assert _max_rel_err(a, b) <= tol, i


@pytest.mark.cuda
def test_k6_autograd_launches_the_backward_and_is_deterministic(cuda):
    args = _tail_inputs(cuda, 5000, torch.bfloat16, seed=3)
    ins = [a.clone().requires_grad_(True) for a in args]
    before = tf.fused_tail_bwd_cuda.launches
    tf.fused_tail(*ins, 7, 0.3, 0.4, True).sum().backward()
    assert tf.fused_tail_bwd_cuda.launches == before + 1
    g = torch.ones((5000, 1), device=cuda)
    a = tf.fused_tail_bwd_cuda(*args, g, 7, 0.3, 0.4, True)
    b = tf.fused_tail_bwd_cuda(*args, g, 7, 0.3, 0.4, True)
    for t, u, v in zip(ins, a, b):
        assert torch.equal(u, v)
        assert torch.equal(t.grad, u)


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True])
def test_k6_forward_is_deterministic(cuda, train):
    """The bf16 forward (the tensor-core route) gives the same bits on two
    calls, at the step's T and at a ragged one."""
    for T in (114_688, 65):
        args = _tail_inputs(cuda, T, torch.bfloat16, seed=T + 1)
        a = tf.fused_tail_fwd_cuda(*args, 21, 0.3, 0.4, train)
        assert torch.equal(a, tf.fused_tail_fwd_cuda(*args, 21, 0.3, 0.4,
                                                     train))


@pytest.mark.cuda
def test_k6_masks(cuda):
    """Keep shares over 7.3M draws; the same seed gives the same masks,
    another seed others (the train-mode forward differs)."""
    m0, m1 = tf.tail_masks(11, 114_688, 64, 0.3, 0.4, True, cuda)
    assert 0.69 <= float((m0 > 0).float().mean()) <= 0.71
    assert 0.59 <= float((m1 > 0).float().mean()) <= 0.61
    args = _tail_inputs(cuda, 4096, torch.float32, seed=4)
    a = tf.fused_tail(*args, 11, 0.3, 0.4, True)
    assert torch.equal(a, tf.fused_tail(*args, 11, 0.3, 0.4, True))
    assert not torch.equal(a, tf.fused_tail(*args, 12, 0.3, 0.4, True))


# hg38 at 1 Mb (chr1-22, X: one (C, W, W) draw), four 100 kb chromosomes
# (one draw each), and rank 3 of a 1 x 4 model axis of each (its padded
# block of rows, the last reading the clipped draw row)
K8_LAYOUTS = {
    "1mb": ([249, 243, 199, 191, 182, 171, 160, 146, 139, 134, 136, 134,
             115, 108, 102, 91, 84, 81, 59, 65, 47, 51, 157], True, None),
    "100kb": ([2491, 1353, 811, 467], False, None),
    "1mb_rank": ([249, 199, 65, 47, 157], True, (4, 3)),
    "100kb_rank": ([2491, 811, 467], False, (4, 3)),
}


def _k8_case(device, layout, dim, table_dtype, seed=0):
    """The tables, f32 weights (needing gradients), and the layout of the
    draws: (features, w1s, w2s, draw widths, first draw rows, whole,
    batched)."""
    sizes, batched, mesh = K8_LAYOUTS[layout]
    g = torch.Generator().manual_seed(seed)
    feats, w1s, w2s = [], [], []
    for n in sizes:
        f = torch.rand((n, n), generator=g) * 2 - 1
        if mesh is not None:
            m, i = mesh
            per = -(-n // m)
            f = torch.nn.functional.pad(f, (0, 0, 0, per * m - n))
            f = f[i * per:(i + 1) * per]
        feats.append(f.to(device, table_dtype).contiguous())
        w1s.append(((torch.rand((n, dim), generator=g) * 2 - 1)
                    / n ** 0.5).to(device).requires_grad_(True))
        w2s.append(((torch.rand((dim, dim), generator=g) * 2 - 1)
                    / dim ** 0.5).to(device).requires_grad_(True))
    W = max(sizes)
    first = 0 if mesh is None else mesh[1]
    return (feats, w1s, w2s, [W] * len(sizes) if batched else list(sizes),
            [first * f.shape[0] for f in feats], mesh is None, batched)


def _k8_draws(device, case, seed=1):
    feats, _, _, widths, _, _, batched = case
    g = torch.Generator(device=device).manual_seed(seed)
    if batched:
        return [torch.rand((len(feats), widths[0], widths[0]), device=device,
                           generator=g)]
    return [torch.rand((w, w), device=device, generator=g) for w in widths]


def _k8_counts():
    from matcha_tpu_torch.ops import node_encode as ne
    return (ne.keep_cuda.launches, ne.encode_fwd_cuda.launches,
            ne.encode_bwd_cuda.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(K8_LAYOUTS))
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [16, 64])
@pytest.mark.parametrize("train", [True, False])
def test_k8_matches_the_eager_chain(cuda, layout, cdt, dim, train):
    """K8 against the eager chain (``node_encode_plain``) on the same draws:
    the keep bits bit for bit; the forward and both gradients (through a
    fixed random projection) in f32 at 1e-4 (summation order), in bf16 at
    2e-2 of the output and 3e-2 of each gradient's largest entry (the eager
    chain rounds X~W1, dH W2^T, G and dW1, dW2 to bf16, K8 sums dW1, dW2 in
    f32; the forward's roundings are the same, its sums in another order).
    The rank layouts hold bf16 tables.  One keep launch (every draw under
    KEEP_GROUP_BYTES), one forward and one backward."""
    from matcha_tpu_torch.ops import node_encode as ne
    tdt = torch.bfloat16 if layout.endswith("rank") else torch.float32
    case = _k8_case(cuda, layout, dim, tdt)
    feats, w1s, w2s, widths, first, whole, batched = case
    rate = 0.2
    plan = ne.plan(feats, w1s, w2s, cdt, widths, first, whole)
    before = _k8_counts()
    bits, keeps = None, None
    if train:
        draws = _k8_draws(cuda, case)
        keep = ne.Keep(plan, rate)
        for u in draws:
            keep.add(u)
        bits = keep.finish()
        us = list(draws[0]) if batched else draws
        keeps = [ne.keep_plain(u, f.shape[0], r, f.shape[1], rate)
                 for u, f, r in zip(us, feats, first)]
        want_bits = torch.cat([ne.pack_bits(k).view(-1) for k in keeps])
        assert torch.equal(bits, want_bits)
    out = ne.node_encode(plan, feats, bits, rate, w1s, w2s)
    ref = ne.node_encode_plain(feats, w1s, w2s, cdt, keeps, rate, whole)
    assert out.dtype == cdt and out.shape == ref.shape
    tol = TOL[cdt]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    r = torch.randn(out.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    got = torch.autograd.grad((out.float() * r).sum(), w1s + w2s)
    want = torch.autograd.grad((ref.float() * r).sum(), w1s + w2s)
    gtol = 1e-4 if cdt == torch.float32 else 3e-2
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        err = float((a - b).abs().max())
        assert err <= gtol * float(b.abs().max()), (err, float(b.abs().max()))
    assert [a - b for a, b in zip(_k8_counts(), before)] == [int(train), 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_k8_reads_tables_that_start_at_any_element(cuda, tdt):
    """Feature tables that are views starting 1 to 7 elements past a
    16-byte boundary (K8 copies x in aligned 16-byte chunks and finds each
    row's first column in them) give what the same tables freshly
    allocated give, bit for bit, output and both gradients."""
    from matcha_tpu_torch.ops import node_encode as ne
    feats, w1s, w2s, widths, first, whole, _ = _k8_case(cuda, "100kb_rank",
                                                        64, tdt)
    shifted = []
    for c, f in enumerate(feats):
        buf = torch.empty(f.numel() + 8, dtype=tdt, device=cuda)
        v = buf[1 + c % 7:1 + c % 7 + f.numel()].view(f.shape)
        v.copy_(f)
        assert v.data_ptr() % 16
        shifted.append(v)
    runs = []
    for tables in (feats, shifted):
        plan = ne.plan(tables, w1s, w2s, torch.bfloat16, widths, first,
                       whole)
        keep = ne.Keep(plan, 0.2)
        for u in _k8_draws(cuda, (tables, w1s, w2s, widths, first, whole,
                                  False)):
            keep.add(u)
        out = ne.node_encode(plan, tables, keep.finish(), 0.2, w1s, w2s)
        runs.append([out] + list(torch.autograd.grad(out.float().sum(),
                                                     w1s + w2s)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_k8_is_deterministic_and_eval_saves_nothing(cuda):
    """Two runs give the same bits (no float atomics); under no_grad one
    forward launch, no backward."""
    from matcha_tpu_torch.ops import node_encode as ne
    case = _k8_case(cuda, "100kb", 64, torch.float32)
    feats, w1s, w2s, widths, first, whole, _ = case
    plan = ne.plan(feats, w1s, w2s, torch.bfloat16, widths, first, whole)
    runs = []
    for _ in range(2):
        keep = ne.Keep(plan, 0.2)
        for u in _k8_draws(cuda, case):
            keep.add(u)
        bits = keep.finish()
        out = ne.node_encode(plan, feats, bits, 0.2, w1s, w2s)
        runs.append([out] + list(torch.autograd.grad(out.float().sum(),
                                                     w1s + w2s)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    before = _k8_counts()
    with torch.no_grad():
        ne.node_encode(plan, feats, None, 0.2, w1s, w2s)
    assert [a - b for a, b in zip(_k8_counts(), before)] == [0, 1, 0]


@pytest.mark.cuda
def test_k8_is_one_launch_a_direction_in_the_encode(cuda, monkeypatch):
    """``encode_node_table`` on the card at 1 Mb (one batched draw) and on
    100 kb chromosomes (a draw each): one keep, one forward and one
    backward launch a training encode, whatever the chromosome count; the
    draws go through ``models.hypersagnn.rand`` and the table equals the
    eager chain's on them (bf16, 2e-2)."""
    from matcha_tpu_torch.models import hypersagnn as th
    from matcha_tpu_torch.ops import node_encode as ne
    orig = th.rand
    for layout in ("1mb", "100kb"):
        feats, w1s, w2s, widths, first, _, batched = _k8_case(
            cuda, layout, 64, torch.float32)
        dims = th.ModelDims(dim=64, n_head=8, num_chroms=len(feats),
                            num_nodes=sum(f.shape[0] for f in feats),
                            compute_dtype="bfloat16")
        params = {"embed": {"ae": [{"w1": a, "w2": b}
                                   for a, b in zip(w1s, w2s)]}}
        frozen = th.FrozenTables(tuple(feats), None, None, None, None)
        draws = []

        def rand(gen, shape, device, draws=draws):
            u = orig(gen, shape, device)
            draws.append(u)
            return u
        monkeypatch.setattr(th, "rand", rand)
        before = _k8_counts()
        h = th.encode_node_table(params, frozen, dims, train=True,
                                 generator=torch.Generator().manual_seed(4))
        h.float().sum().backward()
        assert [a - b for a, b in zip(_k8_counts(), before)] == [1, 1, 1]
        assert len(draws) == (1 if batched else len(feats))
        us = list(draws[0]) if batched else draws
        keeps = [ne.keep_plain(u, f.shape[0], 0, f.shape[1], 0.2)
                 for u, f in zip(us, feats)]
        ref = ne.node_encode_plain(feats, w1s, w2s, torch.bfloat16, keeps,
                                   0.2, True)
        torch.testing.assert_close(h.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)


def _small_problem(device, ks=(2, 3), dim=16, n_head=4, seed=0):
    """A width the fixed-width kernels do not take: dim 16, 4 heads, three
    short chromosomes, f32; params, frozen tables, Bloom filters and
    buckets on ``device``."""
    from matcha_tpu_torch.genome import GenomeBins
    from matcha_tpu_torch.models import hypersagnn as th
    from matcha_tpu_torch.sampler.bloom import build_bloom_dict
    from matcha_tpu_torch.sampler.negative import ChromTable
    rng = np.random.default_rng(seed)
    genome = GenomeBins(["chr1", "chr2", "chr3"],
                        [60_000_000, 40_000_000, 30_000_000], 1_000_000)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    inter = rng.random((n, n)).astype(np.float32)
    dims = th.ModelDims(dim=dim, n_head=n_head, num_chroms=3, num_nodes=n)
    sizes = [int(e - s) for s, e in genome.chrom_range]
    params = th.init_model(torch.Generator().manual_seed(seed), dims, sizes,
                           device=device)
    buckets = {}
    for k in ks:
        e = np.sort(rng.choice(np.arange(1, n + 1), (600, k)), axis=1)
        buckets[k] = e[(np.diff(e, axis=1) > 0).all(axis=1)][:256].astype(
            np.int32)
    return (genome, dims, params,
            th.build_frozen_tables(genome, intra + intra.T, inter,
                                   device=device),
            build_bloom_dict(buckets, device=device),
            ChromTable.from_genome(genome, device=device), buckets)


def _counts():
    return (ta.hyperedge_attention.launches,
            ta.hyperedge_attention_bwd_cuda.launches,
            ts.scatter_add.launches, ts.bincount.launches,
            tp.propose_phase1.launches, tf.fused_tail_fwd_cuda.launches,
            tf.fused_tail_bwd_cuda.launches)


@pytest.mark.cuda
def test_small_model_runs_without_the_fixed_width_kernels(cuda, monkeypatch):
    """Dim 16 with the fused tail on: a training step launches K3 and K4
    once and none of K1, K2, K5 and K6; the same step with dropout off on
    fixed negatives gives the CPU's loss (1e-5) and gradients (1e-4 of each
    one's largest entry, floored at 1e-3 of the largest of all) in f32;
    predict_proba gives the CPU's probabilities (1e-4); the "pallas"
    sampler at k = 7 warns and launches no K5."""
    from matcha_tpu_torch.apps.predict import predict_proba
    from matcha_tpu_torch.models import hypersagnn as th
    from matcha_tpu_torch.sampler import negative as tn
    from matcha_tpu_torch.sampler.bloom import build_bloom
    from matcha_tpu_torch.train import runtime as tr
    monkeypatch.setattr(th, "_FUSE_TAIL", True)
    genome, dims, params, frozen, blooms, table, buckets = _small_problem(
        cuda)
    trainer = tr.Trainer(params, frozen, dims, table,
                         tr.TrainSettings(alpha=1.0, beta=0.001,
                                          token_stream="merged",
                                          propose_impl="xla"),
                         blooms=blooms, seed=1)
    batch = {k: (torch.tensor(e[:128], device=cuda),
                 torch.ones(128, device=cuda)) for k, e in buckets.items()}
    before = _counts()
    aux = trainer.train_step(batch)
    torch.cuda.synchronize()
    got = [a - b for a, b in zip(_counts(), before)]
    assert got == [0, 0, 1, 1, 0, 0, 0], got
    assert np.isfinite(float(aux["bce"])) and np.isfinite(float(aux["recon"]))

    # the same step, deterministic, on the card and on the CPU
    gen = torch.Generator().manual_seed(2)
    xs = {k: torch.cat([pos, tn.sample_negatives(gen, pos, table, 0,
                                                 blooms[k], neg_num=3)]).cpu()
          for k, (pos, _) in batch.items()}
    cpu_frozen = frozen._replace(
        features=tuple(f.cpu() for f in frozen.features),
        attr_table=frozen.attr_table.cpu(), inter_z=frozen.inter_z.cpu(),
        chrom_of_node=frozen.chrom_of_node.cpu(),
        chrom_bounds=frozen.chrom_bounds.cpu())

    def step(device, fz):
        p = tr._tree_map(lambda t: t.detach().to(device).clone()
                         .requires_grad_(True), params)
        logits, recon = th.forward_buckets(
            p, fz, dims, {k: v.to(device) for k, v in xs.items()},
            return_recon=True, attention_mode="per-k", recon_chrom=1)
        bce, _ = tr._bucket_bce_and_preds(
            logits, {k: (pos.to(device), w.to(device))
                     for k, (pos, w) in batch.items()},
            {k: w.to(device) for k, (_, w) in batch.items()})
        loss = bce + 0.001 * recon
        loss.backward()
        return float(loss), [torch.zeros_like(t).cpu() if t.grad is None
                             else t.grad.cpu() for t in tr._leaves(p)]
    before = _counts()
    loss_card, g_card = step(cuda, frozen)
    got = [a - b for a, b in zip(_counts(), before)]
    assert got == [0, 0, 1, 1, 0, 0, 0], got
    loss_cpu, g_cpu = step("cpu", cpu_frozen)
    assert abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu)
    top = max(float(g.abs().max()) for g in g_cpu)
    for a, b in zip(g_card, g_cpu):
        scale = max(float(b.abs().max()), 1e-3 * top)
        assert float((a - b).abs().max()) <= 1e-4 * scale

    samples = [list(r) for k in buckets for r in buckets[k][:200].tolist()]
    before = _counts()
    p_card = predict_proba(params, frozen, dims, samples, 100)
    assert _counts()[0] == before[0]
    p_cpu = predict_proba(tr._tree_map(lambda t: t.cpu(), params),
                          cpu_frozen, dims, samples, 100)
    assert np.isfinite(p_card).all()
    np.testing.assert_allclose(p_card, p_cpu, rtol=0, atol=1e-4)

    rng = np.random.default_rng(3)
    wide = np.sort(rng.choice(np.arange(1, genome.num_nodes + 1), (64, 7)),
                   axis=1)
    wide = wide[(np.diff(wide, axis=1) > 0).all(axis=1)].astype(np.int32)
    before = tp.propose_phase1.launches
    with pytest.warns(UserWarning, match="fell back to XLA"):
        neg = tn.sample_negatives(torch.Generator().manual_seed(4),
                                  torch.tensor(wide, device=cuda), table, 0,
                                  build_bloom(wide, device=cuda),
                                  propose_impl="pallas")
    assert tp.propose_phase1.launches == before
    assert neg.shape == (3 * len(wide), 7)
    assert bool((neg[:, 1:] > neg[:, :-1]).all())


def _cpu_frozen(frozen):
    return frozen._replace(
        features=tuple(f.cpu() for f in frozen.features),
        attr_table=frozen.attr_table.cpu(), inter_z=frozen.inter_z.cpu(),
        chrom_of_node=frozen.chrom_of_node.cpu(),
        chrom_bounds=frozen.chrom_bounds.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dim,n_head", [(16, 4), (64, 8)])
def test_a_scoring_request_makes_one_copy_and_one_sync(cuda, dim, n_head):
    """A scoring request on the card, ragged lists of sizes 2..5 and a 2-D
    array of pairs, f32 (dim 16: no kernel; dim 64: K1): the logits equal
    the per-candidate loop's on the card bit for bit, the probabilities
    the CPU's (1e-4); the request makes one copy to the card (the count
    ``copies``) and one sync (``fetch``)."""
    from matcha_tpu_torch import telemetry
    from matcha_tpu_torch.apps import predict as pr
    from matcha_tpu_torch.train import runtime as tr
    from test_torch_predict_convert import plain_predict_logits
    genome, dims, params, frozen, _, _, buckets = _small_problem(
        cuda, ks=(2, 3, 4, 5), dim=dim, n_head=n_head)
    rows = [r for k in buckets for r in buckets[k][:150].tolist()]
    ragged = [rows[i]
              for i in np.random.default_rng(5).permutation(len(rows))]
    pairs = buckets[2][:200].astype(np.int64)
    cpu = (tr._tree_map(lambda t: t.cpu(), params), _cpu_frozen(frozen))
    for samples, route in ((ragged, "convert.ragged"),
                           (pairs, "convert.array")):
        telemetry.reset()
        got = pr.predict_logits(params, frozen, dims, samples, 64)
        req, = telemetry.units("request")
        assert req.counts == {route: 1, "copies": 1}
        assert req.syncs == {"fetch": 1}
        np.testing.assert_array_equal(
            got, plain_predict_logits(params, frozen, dims, samples, 64))
        np.testing.assert_allclose(
            pr.predict_proba(params, frozen, dims, samples, 64),
            pr.predict_proba(*cpu, dims, samples, 64), rtol=0, atol=1e-4)
    telemetry.reset()
    assert pr.predict_logits(params, frozen, dims, [], 64).shape == (0,)
    req, = telemetry.units("request")
    assert "copies" not in req.counts and req.syncs == {}


@pytest.mark.cuda
def test_pairwise_on_the_card_matches_the_cpu(cuda):
    """The closed-form pair scorer at dim 64 / 8 heads in f32: the card's
    probabilities against the CPU's (1e-4); no kernel launches."""
    from matcha_tpu_torch.apps.pairwise_fast import pairwise_proba_matrix
    from matcha_tpu_torch.train import runtime as tr
    genome, dims, params, frozen, _, _, _ = _small_problem(cuda, dim=64,
                                                           n_head=8)
    before = _counts()
    card = pairwise_proba_matrix(params, frozen, dims, genome, 0)
    assert _counts() == before
    cpu = pairwise_proba_matrix(tr._tree_map(lambda t: t.cpu(), params),
                                _cpu_frozen(frozen), dims, genome, 0)
    assert card.shape == (61, 61) and np.isfinite(card).all()
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_per_occurrence_step_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """The per-occurrence feature dropout at rate 0 in train mode (the
    attention and feed-forward dropouts the identity) at dim 64 / 8 heads
    in f32: loss (1e-5) and gradients (1e-4 of each one's largest entry,
    floored at 1e-3 of the largest of all) against the CPU; K1 and K2 once
    per k >= 3, no K3 (the per-token rows replace the gather) and no K4
    (the per-token recon takes no counts)."""
    from matcha_tpu_torch.models import hypersagnn as th
    from matcha_tpu_torch.models import modules as tm
    from matcha_tpu_torch.train import runtime as tr
    monkeypatch.setattr(tm, "dropout", lambda x, *a, **k: x)
    monkeypatch.setattr(th, "_FUSE_TAIL", False)
    ks = (2, 3, 4)
    _, dims, params, frozen, _, _, buckets = _small_problem(
        cuda, ks=ks, dim=64, n_head=8)
    dims = dims._replace(feature_dropout_mode="per_occurrence",
                         feature_dropout=0.0)
    xs = {k: torch.tensor(e[:128]) for k, e in buckets.items()}

    def step(device, fz):
        p = tr._tree_map(lambda t: t.detach().to(device).clone()
                         .requires_grad_(True), params)
        logits, recon = th.forward_buckets(
            p, fz, dims, {k: v.to(device) for k, v in xs.items()},
            generator=torch.Generator().manual_seed(3), train=True,
            return_recon=True, attention_mode="per-k", recon_chrom=1)
        loss = sum((lg ** 2).mean() for lg in logits.values()) + recon
        loss.backward()
        return float(loss.detach()), [
            torch.zeros_like(t).cpu() if t.grad is None else t.grad.cpu()
            for t in tr._leaves(p)]
    before = _counts()
    loss_card, g_card = step(cuda, frozen)
    got = [a - b for a, b in zip(_counts(), before)]
    assert got == [2, 2, 0, 0, 0, 0, 0], got
    loss_cpu, g_cpu = step("cpu", _cpu_frozen(frozen))
    assert abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu)
    top = max(float(g.abs().max()) for g in g_cpu)
    for a, b in zip(g_card, g_cpu):
        scale = max(float(b.abs().max()), 1e-3 * top)
        assert float((a - b).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_recon_bf16_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """The recon decode with bf16 operands (MATCHA_RECON_BF16): the card's
    loss against the CPU's (1e-5 relative: the same rounded operands, f32
    sums in another order) and against the f32 decode (2e-2)."""
    from matcha_tpu_torch.models import hypersagnn as th
    from matcha_tpu_torch.train import runtime as tr
    _, dims, params, frozen, _, _, _ = _small_problem(cuda, dim=64,
                                                      n_head=8)
    table = th.encode_node_table(params, frozen, dims).detach()
    x = torch.from_numpy(np.random.default_rng(5).integers(
        0, dims.num_nodes + 1, 20_000))
    got = {}
    for on in (True, False):
        monkeypatch.setattr(th, "_RECON_BF16", on)
        card = float(th.recon_loss_node(params, frozen, dims, x.to(cuda),
                                        table, 2))
        cpu = float(th.recon_loss_node(
            tr._tree_map(lambda t: t.cpu(), params), _cpu_frozen(frozen),
            dims, x, table.cpu(), 2))
        assert abs(card - cpu) <= 1e-5 * abs(cpu)
        got[on] = card
    assert got[True] != got[False]
    assert abs(got[True] - got[False]) <= 2e-2 * abs(got[False])


@pytest.mark.cuda
def test_device_epoch_equals_indexed_epoch_on_the_card(cuda, monkeypatch):
    """Device-resident epochs at dim 64 / 8 heads in bf16 (the unfused
    tail, "xla" proposals): the pinned buckets lie on the card, an epoch of
    3 steps launches K1 and K2 twice, K3 and K4 once per step, and from the
    same params, optimizer state and generator state it equals
    ``_launch_epoch`` on the permutations redrawn by hand on the card, bit
    for bit (every kernel of the step gives the same bits every call)."""
    from matcha_tpu_torch.models import hypersagnn as th
    from matcha_tpu_torch.train import runtime as tr
    monkeypatch.setattr(th, "_FUSE_TAIL", False)
    _, dims, params, frozen, blooms, table, buckets = _small_problem(
        cuda, ks=(2, 3, 4), dim=64, n_head=8)
    dims = dims._replace(compute_dtype="bfloat16")
    train = {k: (e[:50], np.ones(50, np.float32))
             for k, e in buckets.items()}
    steps, batch = 3, 32            # 96 rows: each bucket doubled to 100
    trainers = [tr.Trainer(params, frozen, dims, table,
                           tr.TrainSettings(alpha=1.0, beta=0.001,
                                            token_stream="merged"),
                           blooms=blooms, seed=5) for _ in range(2)]
    for t in trainers:
        t.prepare_device_epochs(train, batch, steps)
        assert all(e.device.type == cuda.type and len(e) == 100
                   for e, _ in t._dev_buckets.values())
    a, b = trainers
    state = a.generator.get_state()
    before = _counts()
    got = a.train_epoch_device()
    counts = [x - y for x, y in zip(_counts(), before)]
    assert counts == [2 * steps, 2 * steps, steps, steps, 0, 0, 0], counts
    b.generator.set_state(state)
    stacked = {}
    for k in sorted(b._dev_buckets):
        e, w = b._dev_buckets[k]
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=b.generator))
        gen = torch.Generator(device=cuda).manual_seed(seed)
        idx = torch.randperm(len(e), generator=gen, device=cuda)[
            :steps * batch].view(steps, batch)
        stacked[k] = (e[idx], w[idx])
    want = b._finish_indexed(b._launch_epoch(stacked))
    assert np.isfinite(got["bce"]) and np.isfinite(got["recon"])
    for key in ("bce", "recon", "fallback_bloom_rate", "fallback_orig_rate",
                "metrics"):
        assert got[key] == want[key], key
    for x, y in zip(tr._leaves(a.params), tr._leaves(b.params)):
        assert torch.equal(x, y)


# ------------------------------------------- walk pretraining: SGNS, cooc
def _sgns_problem(device, V=3067, d=64, m=4096, neg=5, seed=0, hub=False):
    """One SGNS minibatch at the hg38 1 Mb pretraining shape: tables as
    ``train_skipgram`` starts them (emb_out moved off zero), centers and
    contexts drawn from the unigram^0.75 of Zipf-by-rank visit counts (p_i
    ~ 1/i over the nodes in a random order: the busiest node takes ~4%
    of the draws), the uniforms of the negatives.  ``hub`` puts half of the
    centers and half of the contexts on row 3."""
    rng = np.random.default_rng(seed)
    counts = (1.0 / rng.permutation(np.arange(1, V + 1))) ** 0.75
    cdf = np.cumsum(counts / counts.sum()).astype(np.float32)

    def draw(n):
        ids = np.minimum(np.searchsorted(cdf, rng.random(n)), V - 1)
        if hub:
            ids[rng.permutation(n)[:n // 2]] = 3
        return ids.astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (t(((rng.random((V, d)) - 0.5) / d).astype(np.float32)),
            t((rng.standard_normal((V, d)) * 0.01).astype(np.float32)),
            t(draw(m)), t(draw(m)), t(cdf),
            t(rng.random((m, neg)).astype(np.float32)))


def _sgns_step_limits(emb_in, emb_out, centers, contexts, cdf, u, lr):
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


@pytest.mark.cuda
@pytest.mark.parametrize("hub", [False, True])
@pytest.mark.parametrize("T", [4096, 24_576])
def test_k3_k4_at_the_sgns_shapes(cuda, T, hub):
    """K3 and K4 as the SGNS step calls them (f32, d = 64, V = 3,067 rows;
    T = 4,096 centers or 4,096 contexts + 20,480 negatives), on
    unigram-skewed ids and on ids with a hub row holding half of T: K3 at
    1e-5 of its plain version and the same bits twice, K4 exactly and the
    same twice.  With the hub, g holds multiples of 1/4, so every sum is
    exact in f32 whatever the order and 1e-5 bounds a wrong or missing
    token even on the hub's row of T / 2 terms."""
    rng = np.random.default_rng(T)
    _, _, centers, _, cdf, _ = _sgns_problem(cuda, m=T, seed=T, hub=hub)
    g = (rng.integers(-8, 9, (T, 64)) / 4 if hub
         else rng.standard_normal((T, 64)) * 0.01)
    g = torch.tensor(g, dtype=torch.float32, device=cuda)
    before = (ts.scatter_add.launches, ts.bincount.launches)
    got = ts.scatter_add(g, centers, 3067)
    cnt = ts.bincount(centers, 3067)
    assert (ts.scatter_add.launches, ts.bincount.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, ts.scatter_add_plain(g, centers, 3067),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ts.scatter_add(g, centers, 3067))
    assert torch.equal(cnt, ts.bincount_plain(centers, 3067))
    assert torch.equal(cnt, ts.bincount(centers, 3067))


@pytest.mark.cuda
@pytest.mark.parametrize("hub", [False, True])
def test_sgns_step_on_the_card_matches_the_cpu(cuda, hub):
    """One f32 SGNS step with the same uniforms on the card and on the CPU
    (f32 sums in another order), on unigram-skewed ids and with a hub row
    holding half of the centers and contexts: every table entry within
    ``_sgns_step_limits`` (the f32 rounding bound of its own row's update),
    the loss at 1e-5 relative; two K3 and two K4 launches.  The unigram
    draw also keeps each table within 1e-5 of its largest entry."""
    from matcha_tpu_torch.walks.skipgram import sgns_step
    card = _sgns_problem(cuda, hub=hub)
    cpu = [t.to("cpu", copy=True) for t in card]
    limits = _sgns_step_limits(*cpu, lr=0.1)
    before = (ts.scatter_add.launches, ts.bincount.launches)
    loss_card = float(sgns_step(*card, lr=0.1))
    assert (ts.scatter_add.launches, ts.bincount.launches) == (
        before[0] + 2, before[1] + 2)
    loss_cpu = float(sgns_step(*cpu, lr=0.1))
    for a, b, lim in zip(card[:2], cpu[:2], limits):
        diff = (a.cpu() - b).abs().double().numpy()
        assert (diff <= lim).all(), float((diff / lim).max())
        if not hub:
            assert diff.max() <= 1e-5 * float(b.abs().max())
    assert abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu)


@pytest.mark.cuda
def test_pair_cooccurrence_is_deterministic_on_the_card(cuda):
    """8,282 hyperedges of 2-25 members over 3,067 nodes (the hg38 1 Mb
    pretraining's size): two calls give the same bits, and the CPU's sums
    agree at 1e-6 of the largest weight."""
    from matcha_tpu_torch.ops.incidence import (PaddedIncidence,
                                                pair_cooccurrence)
    rng = np.random.default_rng(0)
    edges = [np.sort(rng.choice(np.arange(1, 3068), rng.integers(2, 26),
                                replace=False)) for _ in range(8282)]
    inc = PaddedIncidence.from_ragged(edges, device=cuda)
    w = torch.tensor([1.0 / len(e) for e in edges], device=cuda)
    a = pair_cooccurrence(inc, w, 3067)
    b = pair_cooccurrence(inc, w, 3067)
    assert torch.equal(a, b)
    ref = pair_cooccurrence(PaddedIncidence(inc.members.cpu()), w.cpu(), 3067)
    assert float((a.cpu() - ref).abs().max()) <= 1e-6 * float(ref.max())


@pytest.mark.cuda
def test_bundle_apps_on_the_card_match_the_cpu(cuda, tmp_path):
    """A bundle that ``train`` wrote through the CLI on the CPU, on
    chip_smoke.py phase 18's inputs at a small size (4 chromosomes of
    41-130 bins at 10 kb, dim 64, 8 heads, f32), scored on the card and on
    the CPU: every chromosome's closed-form pair probabilities (1e-4) and
    denoise_pixels (np.random.seed before each side: the same pixels, the
    values 1e-4; no kernel), then run_predict_multiway (1e-4; on the card
    K1 once per chunk of k >= 3, nothing else)."""
    import contextlib
    import io
    import chip_smoke
    from matcha_tpu_torch import pipeline
    from matcha_tpu_torch.apps import denoise_contact as dn
    from matcha_tpu_torch.apps.pairwise_fast import pairwise_proba_matrix
    from matcha_tpu_torch.apps.predict_multiway import run_predict_multiway
    from matcha_tpu_torch.data.mcool import save_contacts
    from matcha_tpu_torch.genome import GenomeBins
    from matcha_tpu_torch.train.runtime import load_model_bundle
    genome = GenomeBins(["chr1", "chr2", "chr3", "chr4"],
                        [1_290_000, 900_000, 600_000, 400_000], 10_000)
    temp = str(tmp_path / "temp")
    genome.save(temp)
    save_contacts(temp, *chip_smoke.draw_contacts(
        genome, np.random.default_rng(11)))
    chip_smoke.write_clusters(temp, genome, np.random.default_rng(12))
    cfg = chip_smoke.write_cli_config(str(tmp_path), temp, genome,
                                      batch_size=64, num_batch_per_iter=2)
    with contextlib.redirect_stdout(io.StringIO()):
        pipeline.main(["kmers", "-c", cfg])
        pipeline.main(["train", "-c", cfg, "--device", "cpu"])
    bundle = os.path.join(temp, "model2load")
    intra = np.load(os.path.join(bundle, "intra_adj.npy"))
    proba, pixels = {}, {}
    for device in ("cuda", "cpu"):
        params, dims, g, frozen = load_model_bundle(bundle, device)
        assert (dims.dim, dims.n_head, dims.compute_dtype) == (
            64, 8, "float32")
        before = _counts()
        proba[device] = [pairwise_proba_matrix(params, frozen, dims, g, c)
                         for c in range(4)]
        np.random.seed(21)
        pixels[device] = dn.denoise_pixels(params, frozen, dims, g, intra,
                                           log=lambda *a: None)
        assert _counts() == before
    for a, b in zip(proba["cuda"], proba["cpu"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(pixels["cuda"][0], pixels["cpu"][0])
    np.testing.assert_array_equal(pixels["cuda"][1], pixels["cpu"][1])
    assert len(pixels["cuda"][2]) == 130 * 131 // 2 + 91 * 92 // 2 + \
        61 * 62 // 2 + 41 * 42 // 2
    np.testing.assert_allclose(pixels["cuda"][2], pixels["cpu"][2], rtol=0,
                               atol=1e-4)
    queries = str(tmp_path / "queries.txt")
    chip_smoke.write_chrom_queries(queries, genome,
                                   np.random.default_rng(13), per_k=150)
    before = _counts()
    card = run_predict_multiway(bundle, queries, str(tmp_path / "card.txt"),
                                batch_size=100, device="cuda")
    assert np.subtract(_counts(), before).tolist() == [6, 0, 0, 0, 0, 0, 0]
    cpu = run_predict_multiway(bundle, queries, str(tmp_path / "cpu.txt"),
                               batch_size=100, device="cpu")
    assert card.shape == (600,) and ((card > 0) & (card < 1)).all()
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-4)


def _cards_rank(rank, device, n_data, n_model, tensor_parallel=False):
    """One rank of ``test_mesh_on_several_cards`` (spawned, NCCL on the
    cards; gloo on the CPU for a rehearsal, where no kernel launches): a
    dim-64, 8-head model on three chromosomes, k = 2, 3, 4; with
    ``tensor_parallel`` the mesh's Trainers shard the attention weights'
    heads on the model axis (K1/K2 at 4 heads on a model axis of 2)."""
    from matcha_tpu_torch.data.batcher import BucketedBatcher
    from matcha_tpu_torch.genome import GenomeBins
    from matcha_tpu_torch.models import hypersagnn as th
    from matcha_tpu_torch.parallel import mesh as pm
    from matcha_tpu_torch.parallel.stream import shard_concat
    from matcha_tpu_torch.sampler.bloom import build_bloom_dict
    from matcha_tpu_torch.sampler.negative import ChromTable
    from matcha_tpu_torch.train import runtime as tr
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = pm.make_mesh(n_data, n_model)
    rng = np.random.default_rng(0)
    genome = GenomeBins(["chr1", "chr2", "chr3"],
                        [30_000_000, 22_000_000, 15_000_000], 1_000_000)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    inter = rng.random((n, n)).astype(np.float32)
    buckets = {}
    for k in (2, 3, 4):
        e = np.sort(rng.choice(np.arange(1, n + 1), (600, k)), axis=1)
        e = e[(np.diff(e, axis=1) > 0).all(axis=1)][:256].astype(np.int32)
        buckets[k] = (e, rng.random(len(e)).astype(np.float32) + 0.5)
    dims = th.ModelDims(dim=64, n_head=8, num_chroms=3, num_nodes=n)
    params = th.init_model(torch.Generator().manual_seed(0), dims,
                           [int(e - s) for s, e in genome.chrom_range],
                           device=device)
    frozen = th.build_frozen_tables(genome, intra + intra.T, inter,
                                    device=device)
    table = ChromTable.from_genome(genome, device=device)
    blooms = build_bloom_dict({k: v[0] for k, v in buckets.items()},
                              device=device)
    settings = tr.TrainSettings(alpha=1.0, beta=0.001, token_stream="merged")

    def step(mesh_, n_shards):
        """The f32 step with dropout off on fixed negatives (copies of the
        positives, shifted), the gradients summed over the ranks (the whole
        gradients: tensor-parallel blocks gathered)."""
        t = tr.Trainer(params, frozen, dims, table,
                       settings._replace(n_shards=n_shards), blooms,
                       mesh=mesh_, tensor_parallel=tensor_parallel)
        batch = {k: (torch.from_numpy(e[:64]).to(device),
                     torch.from_numpy(w[:64]).to(device))
                 for k, (e, w) in buckets.items()}
        xs = {k: shard_concat([p, torch.roll(p, 1, 0).repeat(3, 1)],
                              n_shards) for k, (p, _) in batch.items()}
        world = 1 if mesh_ is None else mesh_.size
        with pm.using_active_mesh(mesh_):
            logits, recon = th.forward_buckets(
                t.params, t.frozen, dims, xs, return_recon=True,
                attention_mode="per-k", recon_chrom=1, n_shards=n_shards)
            bce, _ = tr._bucket_bce_and_preds(
                logits, batch, {k: w for k, (_, w) in batch.items()},
                n_shards)
            ((bce + 0.001 * recon) / world).backward()
        t._sum_grads()
        axes = t._tp_axes or [None] * len(tr._leaves(t.params))
        return [pm.tp_gather(p.grad, a, mesh_).float().cpu()
                for p, a in zip(tr._leaves(t.params), axes)]

    before = (ta.hyperedge_attention.launches, ts.scatter_add.launches,
              ts.bincount.launches)
    got = step(mesh, n_data)
    if device.type == "cuda":        # K1 for k = 3, 4; K3 and K4 once
        assert (ta.hyperedge_attention.launches, ts.scatter_add.launches,
                ts.bincount.launches) == (before[0] + 2, before[1] + 1,
                                          before[2] + 1)
    ref = step(None, n_data)
    top = max(float(b.abs().max()) for b in ref)
    for a, b in zip(got, ref):
        err = float((a - b).abs().max())
        assert err <= 1e-5 * max(float(b.abs().max()), 1e-3 * top), err
    # a bf16 fit with "orbax" checkpoints; the ranks end on the same params
    fit = tr.Trainer(params, frozen, dims._replace(compute_dtype="bfloat16"),
                     table, settings, blooms, mesh=mesh,
                     tensor_parallel=tensor_parallel)
    ck = os.path.join(os.environ["MATCHA_CARDS_TMP"],
                      f"ck{n_data}x{n_model}{'tp' if tensor_parallel else ''}")
    hist = fit.fit(buckets, buckets, epochs=2, batch_size=64,
                   num_batch_per_iter=2, checkpoint_path=ck,
                   checkpoint_format="orbax", log=lambda *a: None)
    assert len(hist) == 2 and np.isfinite(hist[-1]["train"]["bce"])
    for tree, group, size in ((fit.whole_params(), mesh.world, mesh.size),
                              (fit.params, mesh.data_group, n_data)):
        flat = torch.cat([p.detach().reshape(-1).float()
                          for p in tr._leaves(tree)])
        every = pm.all_gather_rows(flat, group).reshape(size, -1)
        assert all(torch.equal(every[0], r) for r in every[1:])


@pytest.mark.cuda
def test_mesh_on_several_cards(cuda, tmp_path, monkeypatch):
    """On a machine with several cards: meshes of one rank per card on NCCL
    (all cards x 1, and with four cards 2 x 2): each rank launches K1-K4
    on its rows, the f32 step's gradients summed over the ranks equal one
    rank's with n_shards = D (1e-5 of each gradient's max, floored at 1e-3
    of the largest), and a bf16 fit with "orbax" checkpoints leaves every
    rank with the same params; then the mesh with a model axis again with
    tensor parallelism (its whole params equal on every rank, its blocks
    across each data group).  Skips with one card."""
    from matcha_tpu_torch.kernels.build import build
    from matcha_tpu_torch.parallel.distributed import spawn
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    build()                 # once here, not in every rank
    world = min(count, 4)
    monkeypatch.setenv("MATCHA_CARDS_TMP", str(tmp_path))
    for n_data, n_model in {(world, 1), (world // 2, 2)}:
        spawn(_cards_rank, world, n_data, n_model, backend=None,
              device="cuda")
    spawn(_cards_rank, world, world // 2, 2, True, backend=None,
          device="cuda")
