"""K7's wrapper and the sampler's dispatch to it, where there is no card.

The CPU takes the eager chain (``sampler/negative.py:_sample_eager``) and
launches nothing; K7's wrappers (``ops/sample_negatives.py``) refuse, before
the library is loaded, what the kernel does not take; the one allocation a
launch writes into is laid out without overlaps; the telemetry lists K7's
counter.  K7 itself is held against the eager chain on the card in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from matcha_tpu_torch import telemetry
from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.ops import sample_negatives as k7
from matcha_tpu_torch.sampler import negative as tn
from matcha_tpu_torch.sampler.bloom import build_bloom


def _problem(k, b=40, seed=0):
    genome = GenomeBins(["chr1", "chr2", "chr3"],
                        [60_000_000, 40_000_000, 30_000_000], 1_000_000)
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.integers(1, genome.num_nodes + 1, (4 * b, k)), axis=1)
    pos = pos[(np.diff(pos, axis=1) > 0).all(axis=1)][:b].astype(np.int32)
    bounds = tuple((int(s), int(e)) for s, e in genome.chrom_range)
    return (torch.from_numpy(pos), tn.ChromTable.from_genome(genome, "cpu"),
            build_bloom(pos, device="cpu"), bounds)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("k", [2, 3, 5, 6])
def test_cpu_takes_the_eager_chain(monkeypatch, k, impl):
    """A CPU tensor never reaches K7: the dispatcher's negatives and counts
    are the eager chain's, and no K7 launch is counted."""
    pos, table, bloom, bounds = _problem(k, seed=k)

    def refuse(*a, **kw):
        raise AssertionError("K7 on a CPU tensor")
    before = k7.sample_negatives_cuda.launches
    neg, st = tn.sample_negatives_with_stats(
        torch.Generator().manual_seed(k), pos, table, 2, bloom,
        max_probes=2, hard_ratio=0.5, chrom_bounds=bounds,
        propose_impl=impl)
    monkeypatch.setattr(tn, "_sample_k7", refuse)
    again, st2 = tn.sample_negatives_with_stats(
        torch.Generator().manual_seed(k), pos, table, 2, bloom,
        max_probes=2, hard_ratio=0.5, chrom_bounds=bounds,
        propose_impl=impl)
    ref, rst = tn._sample_eager(torch.Generator().manual_seed(k), pos, table,
                                2, bloom, 3, 8, 2, 0.5, 32, bounds, impl)
    assert k7.sample_negatives_cuda.launches == before
    assert torch.equal(neg, ref) and torch.equal(again, ref)
    assert [int(v) for v in st.values()] == [int(v) for v in rst.values()]
    assert [int(v) for v in st2.values()] == [int(v) for v in rst.values()]
    assert neg.shape == (3 * len(pos), k) and int(st["rows"]) == 3 * len(pos)


def _phase1_args(k=5, n_pos=16, T=8, neg_num=3, device="cpu"):
    """Phase-1 arguments of the shapes K7 takes (on the CPU here)."""
    n = n_pos * neg_num
    pos, table, bloom, _ = _problem(k, b=n_pos)
    return dict(
        positives=pos, neg_num=neg_num, u_count=torch.rand(n),
        u_rank=torch.rand(n, k), u_hard=None, u=torch.rand(T, n, k),
        starts=table.chrom_start, ends=table.chrom_end,
        node2chrom=table.node2chrom, n_nodes=table.node2chrom.shape[0],
        hard_ratio=1.0, bloom=bloom, min_distance=0, max_probes=2)


def _wide(a):
    """a with its last axis strided: the same values, not contiguous."""
    return torch.stack([a, a], dim=-1)[..., 0]


@pytest.mark.parametrize("change,match", [
    ({}, "takes CUDA tensors only"),
    ({"k": 7}, r"1 <= k <= 6"),
    ({"T": 17}, r"1 <= T <= 16"),
    ({"u": torch.float64}, r"u must be torch.float32"),
    ({"u": "strided"}, r"u must be contiguous"),
    ({"positives": torch.int64}, r"positives must be torch.int32"),
    ({"u_hard": (7, 1)}, r"u_hard must be \(48, 1\)"),
    ({"starts": "empty"}, r"at least one chromosome"),
])
def test_phase1_wrapper_refuses_before_loading(monkeypatch, change, match):
    """Every input K7's phase 1 does not take raises ValueError naming it,
    before the library is built or loaded; a CPU tensor always does."""
    def no_library():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(k7, "_library", no_library)
    kw = _phase1_args(k=change.get("k", 5), T=change.get("T", 8))
    if "u" in change:
        kw["u"] = (_wide(kw["u"]) if change["u"] == "strided"
                   else kw["u"].to(change["u"]))
    if "positives" in change:
        kw["positives"] = kw["positives"].to(change["positives"])
    if "u_hard" in change:
        kw["u_hard"] = torch.rand(change["u_hard"])
    if "starts" in change:
        kw["starts"] = kw["ends"] = torch.zeros(0, dtype=torch.int32)
    positives, neg_num = kw.pop("positives"), kw.pop("neg_num")
    args = [kw.pop(name) for name in ("u_count", "u_rank", "u_hard", "u")]
    before = k7.sample_negatives_cuda.launches
    with pytest.raises(ValueError, match=match):
        k7.sample_negatives_cuda(positives, neg_num, *args, **kw)
    assert k7.sample_negatives_cuda.launches == before


@pytest.mark.parametrize("what", ["select_dtype", "select_empty",
                                  "round_flags", "round_u"])
def test_select_and_round_wrappers_refuse_before_loading(monkeypatch, what):
    """K7's selection (from K5's output) and its phase-2 round refuse the
    same way: wrong dtypes or shapes, no probes, a CPU tensor."""
    def no_library():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(k7, "_library", no_library)
    kw = _phase1_args()
    pos, bloom = kw["positives"], kw["bloom"]
    n, k = 3 * pos.shape[0], pos.shape[1]
    change = torch.ones(n, k, dtype=torch.bool)
    lo, hi = torch.zeros(n, k), torch.full((n, k), 60.0)
    probe = torch.zeros(2, n, k, dtype=torch.int32)
    has = torch.ones(2, n, dtype=torch.bool)
    with pytest.raises(ValueError) as err:
        if what == "select_dtype":
            k7.select_cuda(pos, 3, change, lo, hi, probe,
                           has.to(torch.uint8), bloom=bloom)
        elif what == "select_empty":
            k7.select_cuda(pos, 3, change, lo, hi, probe[:0], has[:0],
                           bloom=bloom)
        else:
            neg, _, _, _, flags, counts = k7._alloc(n, k, "cpu", False)
            state = k7.State(neg, change, lo, hi,
                             flags.to(torch.int32) if what == "round_flags"
                             else flags, counts)
            u = torch.rand(n, k + (what == "round_u"))
            k7.round_cuda(state, pos, 3, u, bloom=bloom, min_distance=0)
    msg = str(err.value)
    assert "takes CUDA tensors only" in msg
    assert {"select_dtype": "has must be torch.bool",
            "select_empty": "probe must be (S, n, k), S >= 1",
            "round_flags": "flags must be torch.uint8",
            "round_u": f"u must be ({n}, {k})"}[what] in msg


@pytest.mark.parametrize("ranges", [True, False])
@pytest.mark.parametrize("n,k", [(0, 3), (1, 2), (37, 5), (6144, 5),
                                 (2049, 6)])
def test_alloc_lays_out_disjoint_views(n, k, ranges):
    """The one allocation of a launch: neg, lo, hi, counts, change and
    flags are contiguous views of their shapes and dtypes that do not
    overlap (each filled in turn keeps the others' values)."""
    views = [v for v in k7._alloc(n, k, "cpu", ranges) if v is not None]
    shapes = [(n, k)] + ([(n, k)] * 3 if ranges else []) + [(n,), (4,)]
    assert sorted(tuple(v.shape) for v in views) == sorted(shapes)
    assert all(v.is_contiguous() for v in views)
    base = views[0].untyped_storage().data_ptr()
    spans = sorted((v.data_ptr() - base,
                    v.data_ptr() - base + v.numel() * v.element_size())
                   for v in views if v.numel())
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans == [] or spans[-1][1] <= views[0].untyped_storage().nbytes()


def test_bounds_table_is_made_once_per_bounds():
    """The chromosome bounds go to the device once: a second call with
    equal bounds returns the same tensors, starts and ends as given."""
    bounds = ((1, 61), (61, 101), (101, 131))
    starts, ends = tn._bounds_on(bounds, torch.device("cpu"))
    again = tn._bounds_on(tuple(bounds), torch.device("cpu"))
    assert again[0] is starts and again[1] is ends
    assert starts.tolist() == [1, 61, 101] and ends.tolist() == [61, 101, 131]
    assert starts.dtype == ends.dtype == torch.int32


def test_kernel_launches_lists_k7():
    """The telemetry's launch counters include K7's, so every epoch
    records ``launches.K7``."""
    launches = telemetry.kernel_launches()
    assert launches["K7"] == k7.sample_negatives_cuda.launches
    names = list(launches)
    assert names[names.index("K6_bwd") + 1] == "K7"
