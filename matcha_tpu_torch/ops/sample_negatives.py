"""K7: one hyperedge size's negative sampling, after the uniform draws, as
one kernel launch (and one per phase-2 round).

The sampler (``sampler/negative.py``) draws its uniforms and then runs a
chain of about 210 eager PyTorch operations per size: the change mask, the
chromosome ranges, T proposal rounds through the sorting network, the
first S valid candidates, the Bloom filter's hash and probes, the first
accepted candidate and the fallbacks.  ``csrc/sample_negatives.cu``
computes the same chain on the same uniforms, with the same bits.  Its
entries, each a wrapper here:

  * ``sample_negatives_cuda`` — phase 1 for ``propose_impl="xla"``: the
    whole chain from the uniforms;
  * ``select_cuda`` — phase 1's choice for ``propose_impl="pallas"``, from
    K5's ``(probe, has)`` (``ops/propose.py``);
  * ``round_cuda`` — one phase-2 round, in place on the state the others
    return.

The plain version is the eager chain itself
(``sampler/negative.py:_sample_eager``), which every CPU tensor takes.
Each wrapper takes CUDA tensors only and raises, before the library is
loaded, on anything the kernel does not take (nothing is converted or
copied).  ``sample_negatives_cuda.launches`` counts every K7 launch, of all
three entries.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from matcha_tpu_torch.sampler.negative import _truncated_binomial_cdf

MAX_K, MAX_T = 6, 16    # the sorting networks; the proposal rounds


class State(NamedTuple):
    """What phase 1 leaves for the rounds and the caller: the negatives
    (n, k) int32; the change mask (n, k) bool and the ranges lo / hi (n, k)
    f32 the rounds draw in; a flag byte per row (1: a Bloom-accepted
    candidate, 2: a structurally valid one); and counts (4,) int32: rows
    not accepted, rows ending on a Bloom hit, rows ending on their
    positive, rows."""
    neg: torch.Tensor
    change: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    flags: torch.Tensor
    counts: torch.Tensor


@functools.lru_cache(maxsize=None)
def _library():
    """K7's ctypes entry points (built at first use)."""
    from matcha_tpu_torch.kernels.build import load_library
    lib = load_library("sample_negatives")
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    bloom = [p, u, u, i, i]
    lib.matcha_sample_phase1.argtypes = (
        [p, i, i, i, p, p, p, p, i, i, i, ctypes.POINTER(f), p, p, p, i, f, f]
        + bloom + [p] * 7)
    lib.matcha_sample_select.argtypes = [p, i, i, i, p, p, i] + bloom \
        + [p] * 4
    lib.matcha_sample_round.argtypes = [p, i, i, i, p, p, p, p, i] + bloom \
        + [p] * 4
    for fn in (lib.matcha_sample_phase1, lib.matcha_sample_select,
               lib.matcha_sample_round):
        fn.restype = ctypes.c_int
    lib.matcha_cuda_error_string.argtypes = [ctypes.c_int]
    lib.matcha_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _refuse(what: str, tensors: dict, problems: list):
    """Raise ValueError naming every problem and every tensor, if any."""
    if problems:
        raise ValueError(
            f"{what}: {'; '.join(problems)}; got " + ", ".join(
                f"{name} {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous: {t.is_contiguous()})"
                for name, t in tensors.items() if t is not None))


def _check(what: str, positives, neg_num: int, tensors: dict, specs: dict,
           bloom, extra=()):
    """The checks every entry shares: positives (b, k) int32 with 1 <= k <=
    6, each tensor of ``specs`` {name: (dtype, shape)} as stated, the Bloom
    bitset int32, all contiguous on one card."""
    problems = list(extra)
    dev = positives.device
    if positives.dim() != 2 or not 1 <= positives.shape[1] <= MAX_K:
        problems.append(f"positives must be (b, k) with 1 <= k <= {MAX_K}")
    if neg_num < 0:
        problems.append("neg_num must be >= 0")
    if dev.type != "cuda":
        problems.append("takes CUDA tensors only (the CPU takes the eager "
                        "chain)")
    tensors = {"positives": positives, **tensors, "bloom.bits": bloom.bits}
    specs = {"positives": (torch.int32, None), **specs,
             "bloom.bits": (torch.int32, None)}
    for name, t in tensors.items():
        if t is None:
            continue
        dtype, shape = specs[name]
        if t.dtype != dtype:
            problems.append(f"{name} must be {dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            problems.append(f"{name} must be {tuple(shape)}")
        if t.device != dev or not t.is_contiguous():
            problems.append(f"{name} must be contiguous on {dev}")
    if bloom.bits.numel() >= 2 ** 32 or bloom.m_bits < 1 \
            or (not bloom.blocked and bloom.m_bits >= 2 ** 32):
        problems.append("the Bloom bitset must index in 32 bits")
    _refuse(what, tensors, problems)


@functools.lru_cache(maxsize=None)
def _cdf(k: int):
    """The truncated-binomial CDF of size k as the kernel's float array."""
    return (ctypes.c_float * MAX_K)(
        *_truncated_binomial_cdf(k).astype(np.float32).tolist())


def _bloom_args(bloom):
    return (bloom.bits.data_ptr(), bloom.bits.numel(),
            0 if bloom.blocked else bloom.m_bits, bloom.n_hashes,
            int(bloom.blocked))


def _alloc(n: int, k: int, dev, ranges: bool):
    """One int32 allocation: neg (n, k), [lo, hi (n, k) f32,] counts (4,),
    then bytes: [change (n, k),] flags (n,)."""
    ints = (3 if ranges else 1) * n * k + 4
    nbytes = (n * k if ranges else 0) + n
    words = torch.empty((ints + (nbytes + 3) // 4,), dtype=torch.int32,
                        device=dev)
    neg = words[:n * k].view(n, k)
    lo = hi = change = None
    if ranges:
        f32 = words.view(torch.float32)
        lo = f32[n * k:2 * n * k].view(n, k)
        hi = f32[2 * n * k:3 * n * k].view(n, k)
    counts = words[ints - 4:ints]
    raw = words.view(torch.uint8)[4 * ints:4 * ints + nbytes]
    if ranges:
        change = raw[:n * k].view(torch.bool).view(n, k)
    flags = raw[nbytes - n:]
    return neg, change, lo, hi, flags, counts


def _launch(name: str, positives, neg_num: int, *args):
    """Call the entry ``name`` with the arguments every entry starts with
    (positives, b, neg_num, k), then ``args``, on the current stream."""
    entry = getattr(_library(), name)
    dev = positives.device
    b, k = positives.shape
    args = (positives.data_ptr(), b, neg_num, k, *args,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = entry(*args)
    else:
        with torch.cuda.device(dev):
            err = entry(*args)
    if err != 0:
        raise RuntimeError(
            "sample_negatives kernel launch failed: "
            f"{_library().matcha_cuda_error_string(err).decode()} "
            f"(cudaError {err})")
    sample_negatives_cuda.launches += int(b * neg_num > 0)


def sample_negatives_cuda(positives, neg_num: int, u_count, u_rank, u_hard,
                          u, *, starts, ends, node2chrom, n_nodes: int,
                          hard_ratio: float, bloom, min_distance: int,
                          max_probes: int) -> State:
    """Phase 1 of one size on the card (``propose_impl="xla"``).

    positives (b, k) int32; with n = b * neg_num the uniforms u_count (n,),
    u_rank (n, k), u_hard (n, 1) or None (hard_ratio 1: no whole-range
    rows) and u (T, n, k), f32; the chromosomes' first node ids ``starts``
    and ends ``ends`` (C,) int32, and ``node2chrom`` (n_nodes,) int32 to
    gather each member's chromosome, or None to count the starts it
    passes; the size's Bloom filter.  1 <= k <= 6, 1 <= T <= 16; S =
    max_probes clipped to [1, T]."""
    b, k = positives.shape[0], positives.shape[-1]
    n = b * neg_num
    T = u.shape[0] if u.dim() == 3 else 0
    S = max(1, min(int(max_probes), T))
    dev = positives.device
    C = starts.shape[0] if starts.dim() == 1 else 0
    extra = []
    if not 1 <= T <= MAX_T:
        extra.append(f"u must be (T, n, k) with 1 <= T <= {MAX_T}")
    if C < 1:
        extra.append("starts must hold at least one chromosome")
    _check("sample_negatives_cuda", positives, neg_num,
           {"u_count": u_count, "u_rank": u_rank, "u_hard": u_hard, "u": u,
            "starts": starts, "ends": ends, "node2chrom": node2chrom},
           {"u_count": (torch.float32, (n,)),
            "u_rank": (torch.float32, (n, k)),
            "u_hard": (torch.float32, (n, 1)),
            "u": (torch.float32, (T, n, k)),
            "starts": (torch.int32, (C,)), "ends": (torch.int32, (C,)),
            "node2chrom": (torch.int32, (n_nodes,))}, bloom, extra)
    neg, change, lo, hi, flags, counts = _alloc(n, k, dev, ranges=True)
    _launch("matcha_sample_phase1", positives, neg_num, u_count.data_ptr(),
            u_rank.data_ptr(), None if u_hard is None else u_hard.data_ptr(),
            u.data_ptr(), T, S, int(min_distance), _cdf(k), starts.data_ptr(),
            ends.data_ptr(),
            None if node2chrom is None else node2chrom.data_ptr(), C,
            float(hard_ratio), float(n_nodes), *_bloom_args(bloom),
            neg.data_ptr(), change.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            flags.data_ptr(), counts.data_ptr())
    return State(neg, change, lo, hi, flags, counts)


def select_cuda(positives, neg_num: int, change, lo, hi, probe, has, *,
                bloom) -> State:
    """Phase 1's choice on the card for ``propose_impl="pallas"``: from
    K5's probe (S, n, k) int32 and has (S, n) bool, the first
    Bloom-accepted candidate per row, else its first valid one, else its
    positive.  change (n, k) bool and lo / hi (n, k) f32, phase 1's inputs,
    are kept in the state for the rounds."""
    b, k = positives.shape[0], positives.shape[-1]
    n = b * neg_num
    S = probe.shape[0] if probe.dim() == 3 else 0
    dev = positives.device
    _check("select_cuda", positives, neg_num,
           {"change": change, "lo": lo, "hi": hi, "probe": probe,
            "has": has},
           {"change": (torch.bool, (n, k)), "lo": (torch.float32, (n, k)),
            "hi": (torch.float32, (n, k)),
            "probe": (torch.int32, (S, n, k)), "has": (torch.bool, (S, n))},
           bloom, [] if S >= 1 else ["probe must be (S, n, k), S >= 1"])
    neg, _, _, _, flags, counts = _alloc(n, k, dev, ranges=False)
    _launch("matcha_sample_select", positives, neg_num, probe.data_ptr(),
            has.data_ptr(), S, *_bloom_args(bloom), neg.data_ptr(),
            flags.data_ptr(), counts.data_ptr())
    return State(neg, change, lo, hi, flags, counts)


def round_cuda(state: State, positives, neg_num: int, u, *, bloom,
               min_distance: int) -> None:
    """One phase-2 round on the card, in place: the rows of ``state`` not
    yet accepted propose one candidate from u (n, k) f32; an accepted one
    is taken, and a row with no valid candidate yet keeps a valid Bloom
    hit.  ``state.counts`` is written anew."""
    b, k = positives.shape[0], positives.shape[-1]
    n = b * neg_num
    _check("round_cuda", positives, neg_num,
           {"u": u, "neg": state.neg, "change": state.change,
            "lo": state.lo, "hi": state.hi, "flags": state.flags,
            "counts": state.counts},
           {"u": (torch.float32, (n, k)), "neg": (torch.int32, (n, k)),
            "change": (torch.bool, (n, k)), "lo": (torch.float32, (n, k)),
            "hi": (torch.float32, (n, k)), "flags": (torch.uint8, (n,)),
            "counts": (torch.int32, (4,))}, bloom)
    _launch("matcha_sample_round", positives, neg_num,
            state.change.data_ptr(), state.lo.data_ptr(), state.hi.data_ptr(),
            u.data_ptr(), int(min_distance), *_bloom_args(bloom),
            state.neg.data_ptr(), state.flags.data_ptr(),
            state.counts.data_ptr())


sample_negatives_cuda.launches = 0
