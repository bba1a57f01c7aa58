"""Batched on-device negative hyperedge sampler.

Port of ``matcha_tpu/sampler/negative.py``.  Per positive, ``neg_num``
negatives: the number of corrupted positions ~ Binomial(k, 1/2) truncated to
nonzero, positions chosen once per negative without replacement and held
fixed across retries; each retry resamples the chosen positions uniformly
within the same chromosome's node range; a candidate is accepted iff, after
sorting, every adjacent gap exceeds ``min_distance`` and it is not in the
size's Bloom filter.

Phase 1 proposes ``max_trials`` candidate rounds in parallel and Bloom-probes
only the first ``max_probes`` structurally valid ones per row; phase 2
re-proposes, one round at a time, only for the rows still unaccepted, for at
most ``extra_rounds`` rounds (the host tests once per round whether any row
is left, the condition of the JAX package's while loop: the telemetry sync
``round``; the rounds run are the count ``rounds``).  With no filter
(stage 1) negatives are copies of the positives.

Random draws come from explicit CPU ``torch.Generator``s (see
``models/modules.py``); the streams differ from jax.random's, so the port is
held to the JAX package exactly where the uniforms are injected (phase 1)
and by the same invariant and distribution tests elsewhere.

On a CUDA tensor with k <= 6 the chain after the uniform draws is K7
(``ops/sample_negatives.py``): one launch per size and one per phase-2
round, from the same draws of the same generators, with the eager chain's
negatives and counts bit for bit; the CPU and k > 6 run the eager chain.
``propose_impl="pallas"`` runs phase 1 through ``ops/propose.py`` (K5 on a
CUDA tensor, then K7's selection) on the same arrays and uniforms as the
"xla" branch, so the two branches give the same negatives bit for bit.
(The JAX package's "pallas" branch draws its uniforms feature-major, (T,
k, n): another draw from the same distribution.)  For k > 6, beyond K5's
sorting networks, it warns and takes the "xla" branch, as the JAX package
does.
"""

from __future__ import annotations

import math
import warnings
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from matcha_tpu_torch import telemetry
from matcha_tpu_torch.device import resolve_device, to_device
from matcha_tpu_torch.models.modules import rand, split_generator
from matcha_tpu_torch.sampler.bloom import DeviceBloomFilter


class ChromTable(NamedTuple):
    """Chromosome metadata for chromosome-constrained resampling.

    node2chrom: (N+1,) int32, chromosome index per node id (row 0 unused);
    chrom_start / chrom_end: (C,) int32, [start, end) node-id range."""
    node2chrom: torch.Tensor
    chrom_start: torch.Tensor
    chrom_end: torch.Tensor

    @classmethod
    def from_genome(cls, genome, device="cuda") -> "ChromTable":
        dev = resolve_device(device)
        return cls(
            node2chrom=torch.as_tensor(genome.node2chrom.astype(np.int32),
                                       device=dev),
            chrom_start=torch.as_tensor(
                genome.chrom_range[:, 0].astype(np.int32), device=dev),
            chrom_end=torch.as_tensor(
                genome.chrom_range[:, 1].astype(np.int32), device=dev))


@lru_cache(maxsize=None)
def _truncated_binomial_cdf(k: int) -> np.ndarray:
    """CDF of Binomial(k, 1/2) conditioned on > 0, over support 1..k."""
    pmf = np.array([math.comb(k, c) for c in range(k + 1)], dtype=np.float64)
    pmf = pmf / pmf.sum()
    pmf = pmf[1:] / (1.0 - pmf[0])
    return np.cumsum(pmf)


# optimal sorting networks (compare-exchange index pairs) for small widths
_SORT_NETS = {
    1: [],
    2: [(0, 1)],
    3: [(0, 2), (0, 1), (1, 2)],
    4: [(0, 2), (1, 3), (0, 1), (2, 3), (1, 2)],
    5: [(0, 3), (1, 4), (0, 2), (1, 3), (0, 1), (2, 4), (1, 2), (3, 4),
        (2, 3)],
    6: [(0, 5), (1, 3), (2, 4), (1, 2), (3, 4), (0, 3), (2, 5), (0, 1),
        (2, 3), (4, 5), (1, 2), (3, 4)],
}


def sort_small(x: torch.Tensor) -> torch.Tensor:
    """Sort the trailing axis (width <= 6) with a fixed sorting network."""
    k = x.shape[-1]
    if k not in _SORT_NETS:
        return torch.sort(x, dim=-1).values
    cols = list(x.unbind(-1))
    for i, j in _SORT_NETS[k]:
        cols[i], cols[j] = (torch.minimum(cols[i], cols[j]),
                            torch.maximum(cols[i], cols[j]))
    return torch.stack(cols, dim=-1)


def _first_accepted(probe, acc_stage):
    """First Bloom-accepted stage per row, in trial order.  probe: (S, n, k)
    per-stage candidates; acc_stage: (S, n).  Rows with no acceptance keep
    probe[0], the first structurally valid candidate.  -> (chosen,
    acc_found)."""
    acc_found = torch.zeros(acc_stage.shape[1:], dtype=torch.bool,
                            device=acc_stage.device)
    chosen = probe[0]
    for s in range(probe.shape[0]):
        take = ~acc_found & acc_stage[s]
        chosen = torch.where(take[:, None], probe[s], chosen)
        acc_found = acc_found | acc_stage[s]
    return chosen, acc_found


def _sample_change_mask(generator: torch.Generator, n: int, k: int,
                        device) -> torch.Tensor:
    """(n, k) bool mask with row-wise count ~ truncated Binomial(k, 1/2),
    positions uniform without replacement (ranks of iid uniforms, index
    tie-break)."""
    gc, gp = split_generator(generator, 2)
    cdf = to_device(_truncated_binomial_cdf(k).astype(np.float32), device)
    u = rand(gc, (n,), device)
    change_num = (u[:, None] > cdf).sum(dim=-1) + 1
    scores = rand(gp, (n, k), device)
    s_i, s_j = scores[:, :, None], scores[:, None, :]
    ar = torch.arange(k, device=device)
    less = (s_j < s_i) | ((s_j == s_i) & (ar[None, :] < ar[:, None]))
    return less.sum(dim=-1) < change_num[:, None]


def _draw(lo, hi, u):
    """lo + min(floor((hi-lo)*u), hi-lo-1) as int32: never hi itself, even
    where f32 rounding would give (hi-lo)*u == hi-lo."""
    return (lo + torch.minimum(torch.floor((hi - lo) * u),
                               hi - lo - 1.0)).to(torch.int32)


def _phase1_xla(orig, change, lo, hi, u, min_distance: int,
                max_probes: int):
    """Phase 1 with given uniforms: T rounds of candidates, sorted and
    gap-checked, and the s-th structurally valid one per row for s <
    max_probes (<= T).  orig/change (n, k), lo/hi (n, k) f32, u (T, n, k)
    f32 -> (probe (S, n, k) int32, zero where none; stage_has (S, n) bool)."""
    temp = sort_small(torch.where(change[None], _draw(lo[None], hi[None], u),
                                  orig[None]))                 # (T, n, k)
    ok = ((temp[..., 1:] - temp[..., :-1]) > min_distance).all(dim=-1)
    rank = torch.cumsum(ok.to(torch.int32), dim=0) - 1         # (T, n)
    probe, has = [], []
    for s in range(max_probes):
        m = ok & (rank == s)
        probe.append((temp * m[..., None]).sum(dim=0, dtype=torch.int32))
        has.append(m.any(dim=0))
    return torch.stack(probe), torch.stack(has)


def _chrom_range(orig, table: ChromTable, chrom_bounds):
    """Per-member [lo, hi) node range of its chromosome, f32.  With
    ``chrom_bounds`` (host constants) by comparing the ids against the
    range starts (node ids are contiguous per chromosome), else by gathers
    through the table."""
    if chrom_bounds is not None:
        bounds = to_device(np.asarray(chrom_bounds, np.int32),
                           orig.device)                        # (C, 2)
        c = (orig[..., None] >= bounds[1:, 0]).sum(dim=-1)     # chrom index
    else:
        c = table.node2chrom[orig.long()].long()
        bounds = torch.stack([table.chrom_start, table.chrom_end], dim=-1)
    return bounds[c, 0].float(), bounds[c, 1].float()


def _corruption(g_mask, g_hard, orig, table: ChromTable, hard_ratio: float,
                chrom_bounds):
    """The change mask (n, k) bool and the [lo, hi) ranges (n, k) f32 the
    corrupted members are drawn in: the chromosome's, or the whole node
    range for the rows the hard draw makes simple (all members corrupted)."""
    n, k = orig.shape
    dev = orig.device
    change = _sample_change_mask(g_mask, n, k, dev)
    lo, hi = _chrom_range(orig, table, chrom_bounds)
    if hard_ratio < 1.0:
        hard = rand(g_hard, (n, 1), dev) <= hard_ratio
        change = change | ~hard                      # simple: corrupt all
        lo = torch.where(hard, lo, torch.ones((), device=dev))
        hi = torch.where(hard, hi, torch.full(
            (), float(table.node2chrom.shape[0]), device=dev))
    return change, lo, hi


def _rounds(g_retry, extra_rounds: int, left, n: int, k: int, device):
    """The phase-2 rounds: while ``left()`` (the host's test, the sync
    ``round``) says rows are left, at most ``extra_rounds`` times, each
    round's (n, k) uniforms from its own child of ``g_retry``."""
    for _ in range(max(int(extra_rounds), 0)):
        with telemetry.sync("round"):
            go = left()
        if not go:
            return
        telemetry.count("rounds")
        g_retry, g_round = split_generator(g_retry, 2)
        yield rand(g_round, (n, k), device)


def _sample_eager(generator, positives, table: ChromTable, min_distance: int,
                  bloom: DeviceBloomFilter, neg_num: int, T: int, S: int,
                  hard_ratio: float, extra_rounds: int, chrom_bounds,
                  propose_impl: str):
    """The sampler's chain in eager PyTorch (every device, any k): the
    plain version of K7 (``ops/sample_negatives.py``)."""
    n, k = positives.shape[0] * neg_num, positives.shape[1]
    dev = positives.device
    orig = positives.to(torch.int32).repeat(neg_num, 1)
    g_mask, g_hard, g_trial, g_retry = split_generator(generator, 4)
    change, lo, hi = _corruption(g_mask, g_hard, orig, table, hard_ratio,
                                 chrom_bounds)
    if propose_impl == "pallas":
        from matcha_tpu_torch.ops.propose import propose_phase1 as phase1
    else:
        phase1 = _phase1_xla
    probe, stage_has = phase1(orig, change, lo, hi,
                              rand(g_trial, (T, n, k), dev),
                              min_distance=min_distance, max_probes=S)
    acc_stage = stage_has & ~bloom.contains(probe)               # (S, n)
    chosen, found = _first_accepted(probe, acc_stage)
    cur_ok = stage_has[0]        # a structurally valid trial exists

    for u in _rounds(g_retry, extra_rounds, lambda: bool((~found).any()),
                     n, k, dev):
        t = sort_small(torch.where(change, _draw(lo, hi, u), orig))
        ok_r = ((t[:, 1:] - t[:, :-1]) > min_distance).all(dim=-1)
        take = ~found & ok_r & ~bloom.contains(t)
        # a row with no valid candidate yet keeps its first valid one (even
        # a Bloom hit), so the final fallback is always valid
        take_ok = ~found & ~cur_ok & ok_r
        chosen = torch.where((take | take_ok)[:, None], t, chosen)
        cur_ok = cur_ok | (~found & ok_r)
        found = found | take

    use_orig = ~(found | cur_ok)
    neg = torch.where(use_orig[:, None], orig, chosen)
    stats = {
        "bloom_fallback": (~found & cur_ok).sum().to(torch.int32),
        "orig_fallback": use_orig.sum().to(torch.int32),
        "rows": torch.full((), n, dtype=torch.int32, device=dev),
    }
    return neg, stats


@lru_cache(maxsize=16)
def _bounds_on(chrom_bounds: tuple, device):
    """``chrom_bounds`` as (starts, ends), two (C,) int32 tensors on
    ``device``, made once per bounds and device."""
    table = torch.tensor(np.asarray(chrom_bounds, np.int32).T.copy(),
                         device=device)
    return table[0], table[1]


def _sample_k7(generator, positives, table: ChromTable, min_distance: int,
               bloom: DeviceBloomFilter, neg_num: int, T: int, S: int,
               hard_ratio: float, extra_rounds: int, chrom_bounds,
               propose_impl: str):
    """The sampler's chain on the card through K7: the same draws from the
    same generators as ``_sample_eager``, the chain after them one launch
    (phase 1; with "pallas" K5 then K7's selection) and one per phase-2
    round; the same negatives and counts bit for bit."""
    from matcha_tpu_torch.ops import sample_negatives as k7
    n, k = positives.shape[0] * neg_num, positives.shape[1]
    dev = positives.device
    pos = positives.to(torch.int32).contiguous()
    g_mask, g_hard, g_trial, g_retry = split_generator(generator, 4)
    if propose_impl == "pallas":
        from matcha_tpu_torch.ops.propose import propose_phase1
        orig = pos.repeat(neg_num, 1)
        change, lo, hi = (t.contiguous() for t in _corruption(
            g_mask, g_hard, orig, table, hard_ratio, chrom_bounds))
        probe, has = propose_phase1(orig, change, lo, hi,
                                    rand(g_trial, (T, n, k), dev),
                                    min_distance=min_distance, max_probes=S)
        state = k7.select_cuda(pos, neg_num, change, lo, hi, probe, has,
                               bloom=bloom)
    else:
        if chrom_bounds is None:
            starts, ends = table.chrom_start, table.chrom_end
            node2chrom = table.node2chrom
        else:
            starts, ends = _bounds_on(chrom_bounds, dev)
            node2chrom = None
        gc, gp = split_generator(g_mask, 2)
        state = k7.sample_negatives_cuda(
            pos, neg_num, rand(gc, (n,), dev), rand(gp, (n, k), dev),
            rand(g_hard, (n, 1), dev) if hard_ratio < 1.0 else None,
            rand(g_trial, (T, n, k), dev), starts=starts, ends=ends,
            node2chrom=node2chrom, n_nodes=table.node2chrom.shape[0],
            hard_ratio=hard_ratio, bloom=bloom, min_distance=min_distance,
            max_probes=S)
    for u in _rounds(g_retry, extra_rounds, lambda: int(state.counts[0]) > 0,
                     n, k, dev):
        k7.round_cuda(state, pos, neg_num, u, bloom=bloom,
                      min_distance=min_distance)
    return state.neg, {"bloom_fallback": state.counts[1],
                       "orig_fallback": state.counts[2],
                       "rows": state.counts[3]}


def sample_negatives_with_stats(
        generator: Optional[torch.Generator], positives: torch.Tensor,
        table: ChromTable, min_distance: int,
        bloom: Optional[DeviceBloomFilter], *, neg_num: int = 3,
        max_trials: int = 8, hard_ratio: float = 1.0, extra_rounds: int = 32,
        max_probes: Optional[int] = None,
        chrom_bounds: Optional[tuple] = None,
        propose_impl: str = "xla") -> Tuple[torch.Tensor, dict]:
    """Generate (B*neg_num, k) negatives for a (B, k) positive bucket.

    hard_ratio: fraction of negatives corrupted chromosome-constrained at
    the binomially chosen positions; the rest are wholly random hyperedges
    over the full node range.

    On a CUDA tensor with k <= 6 the chain after the uniform draws runs as
    K7 (``_sample_k7``), else eagerly (``_sample_eager``): the same
    negatives and counts from the same generator.

    -> (negatives, stats): ``bloom_fallback`` counts rows that ended on a
    structurally valid Bloom-hit candidate, ``orig_fallback`` rows that fell
    back to the positive itself, ``rows`` the rows sampled (0-d int32
    tensors on the positives' device)."""
    if propose_impl not in ("xla", "pallas"):
        raise ValueError(f"propose_impl must be 'xla' or 'pallas', "
                         f"got {propose_impl!r}")
    b, k = positives.shape
    n = b * neg_num
    dev = positives.device
    if bloom is None:
        # stage 1: no rejection sets, negatives == positives
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return positives.to(torch.int32).repeat(neg_num, 1), {
            "bloom_fallback": zero, "orig_fallback": zero,
            "rows": torch.full((), n, dtype=torch.int32, device=dev)}
    if generator is None:
        raise ValueError("sampling negatives against a filter needs a "
                         "generator")

    T = max(1, min(int(max_trials), 16))
    S = T if max_probes is None else max(1, min(int(max_probes), T))
    if propose_impl == "pallas" and k not in _SORT_NETS:
        # as the JAX package does: K5's sorting networks stop at k = 6
        warnings.warn(f"propose_impl='pallas' fell back to XLA (K5 takes "
                      f"k <= 6, got k={k})", stacklevel=2)
        propose_impl = "xla"
    # K7 takes what the sorting networks cover, and T <= 16 always
    chain = (_sample_k7 if dev.type == "cuda" and k in _SORT_NETS
             else _sample_eager)
    return chain(generator, positives, table, min_distance, bloom, neg_num,
                 T, S, hard_ratio, extra_rounds, chrom_bounds, propose_impl)


def sample_negatives(generator, positives, table, min_distance, bloom,
                     **kw) -> torch.Tensor:
    """``sample_negatives_with_stats`` without the counters."""
    return sample_negatives_with_stats(generator, positives, table,
                                       min_distance, bloom, **kw)[0]


def assemble_batch(positives: torch.Tensor, weights: torch.Tensor,
                   negatives: torch.Tensor):
    """pos + neg -> (x, y, w): y = 1 / 0, positive weight from the quantile
    pipeline, negative weight 1."""
    dev = positives.device
    x = torch.cat([positives, negatives], dim=0)
    y = torch.cat([torch.ones(positives.shape[0], device=dev),
                   torch.zeros(negatives.shape[0], device=dev)])[:, None]
    w = torch.cat([weights.reshape(-1).float(),
                   torch.ones(negatives.shape[0], device=dev)])[:, None]
    return x, y, w
