"""Fused phase-1 negative proposals, feature-major.

Port of ``matcha_tpu/ops/propose.py``.  The sampler's phase 1 proposes T
candidate rounds per row: it resamples the corrupted positions uniformly in
their chromosome range, sorts each candidate with a k-wide sorting network,
checks the min-distance gaps, and keeps the first S structurally valid
candidates per row for the Bloom probes.  Three functions, as the other ops
have:

  * ``propose_phase1_plain`` — the plain PyTorch version, a copy of the JAX
    package's ``_phase1_body`` / ``propose_phase1_ref``;
  * ``propose_phase1_cuda`` — the wrapper of ``csrc/propose.cu`` (K5, the
    port of the TPU kernel ``_kernel`` behind ``propose_phase1``);
  * ``propose_phase1`` — the dispatcher: a CPU tensor takes the plain
    version, a CUDA tensor launches the kernel or raises.

Both are pure functions of the uniforms ``u``, so the kernel and the plain
version agree bit for bit.  The JAX gate ``supported_block`` (n divisible by
2048, 512 or 128) has no counterpart: the kernel masks its own ragged edge.
``propose_phase1.launches`` counts K5 launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from matcha_tpu_torch.sampler.negative import _SORT_NETS


def _shapes(orig_t, u, max_probes):
    k, n = orig_t.shape
    T = u.shape[0]
    return k, n, T, max(1, min(int(max_probes), T))


def propose_phase1_plain(orig_t, change_t, lo_t, hi_t, u, *,
                         min_distance: int, max_probes: int):
    """orig_t/change_t (k, n) int, lo_t/hi_t (k, n) f32, u (T, k, n) f32 ->
    (probe (S, k, n) int32, has (S, n) bool) with S = min(max_probes, T): the
    s-th structurally valid candidate per row in trial order (zeros where
    none exists) and whether it exists."""
    k, n, T, S = _shapes(orig_t, u, max_probes)
    orig = orig_t.to(torch.int32)
    change = change_t != 0
    lo, hi = lo_t.to(torch.float32), hi_t.to(torch.float32)
    width = hi - lo
    rank = torch.zeros((n,), dtype=torch.int32, device=orig.device)
    probe = torch.zeros((S, k, n), dtype=torch.int32, device=orig.device)
    has = torch.zeros((S, n), dtype=torch.bool, device=orig.device)
    for t in range(T):
        # f32-rounding guard: never land on hi itself
        cand = (lo + torch.minimum(torch.floor(width * u[t].float()),
                                   width - 1.0)).to(torch.int32)
        cols = list(torch.where(change, cand, orig).unbind(0))
        for i, j in _SORT_NETS[k]:
            cols[i], cols[j] = (torch.minimum(cols[i], cols[j]),
                                torch.maximum(cols[i], cols[j]))
        ok = torch.ones((n,), dtype=torch.bool, device=orig.device)
        for c in range(k - 1):
            ok = ok & (cols[c + 1] - cols[c] > min_distance)
        sorted_t = torch.stack(cols)                            # (k, n)
        for s in range(S):
            m = ok & (rank == s)
            probe[s] = torch.where(m, sorted_t, probe[s])
            has[s] = has[s] | m
        rank = rank + ok.to(torch.int32)
    return probe, has


@functools.lru_cache(maxsize=None)
def _lib():
    from matcha_tpu_torch.kernels.build import load_library
    lib = load_library("propose")
    lib.matcha_propose_phase1.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.matcha_propose_phase1.restype = ctypes.c_int
    lib.matcha_cuda_error_string.argtypes = [ctypes.c_int]
    lib.matcha_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"propose_phase1_cuda: {msg}")


def propose_phase1_cuda(orig_t, change_t, lo_t, hi_t, u, *,
                        min_distance: int, max_probes: int):
    """Launch K5 on ``torch.cuda.current_stream()``.  Takes orig_t/change_t
    (k, n) int32, lo_t/hi_t (k, n) f32 and u (T, k, n) f32 with 1 <= k <= 6
    and T >= 1, contiguous on one card.  Raises on anything else."""
    _check(orig_t.is_cuda, "orig_t must be a CUDA tensor")
    _check(orig_t.dim() == 2, f"orig_t must be (k, n), got "
                              f"{tuple(orig_t.shape)}")
    k, n = orig_t.shape
    _check(k in _SORT_NETS, f"k must be in 1..6, got {k}")
    _check(u.dim() == 3 and u.shape[1:] == (k, n) and u.shape[0] >= 1,
           f"u must be (T, {k}, {n}), got {tuple(u.shape)}")
    for name, t, dt in (("orig_t", orig_t, torch.int32),
                        ("change_t", change_t, torch.int32),
                        ("lo_t", lo_t, torch.float32),
                        ("hi_t", hi_t, torch.float32),
                        ("u", u, torch.float32)):
        _check(t.dtype == dt, f"{name} must be {dt}, got {t.dtype}")
        _check(t.device == orig_t.device, f"{name} must be on "
                                          f"{orig_t.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        if name != "u":
            _check(t.shape == (k, n), f"{name} must be ({k}, {n})")
    _, _, T, S = _shapes(orig_t, u, max_probes)
    probe = torch.empty((S, k, n), dtype=torch.int32, device=orig_t.device)
    has = torch.empty((S, n), dtype=torch.bool, device=orig_t.device)
    lib = _lib()
    with torch.cuda.device(orig_t.device):
        stream = torch.cuda.current_stream(orig_t.device).cuda_stream
        err = lib.matcha_propose_phase1(
            orig_t.data_ptr(), change_t.data_ptr(), lo_t.data_ptr(),
            hi_t.data_ptr(), u.data_ptr(), probe.data_ptr(), has.data_ptr(),
            k, n, T, S, int(min_distance), stream)
    if err != 0:
        raise RuntimeError("propose_phase1 kernel launch failed: "
                           f"{lib.matcha_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")
    propose_phase1.launches += 1
    return probe, has


def propose_phase1(orig_t, change_t, lo_t, hi_t, u, *, min_distance: int,
                   max_probes: int):
    """Feature-major phase-1 proposals (see ``propose_phase1_plain``)."""
    if orig_t.device.type == "cpu":
        return propose_phase1_plain(orig_t, change_t, lo_t, hi_t, u,
                                    min_distance=min_distance,
                                    max_probes=max_probes)
    if orig_t.device.type != "cuda":
        raise ValueError(f"propose_phase1: no kernel for {orig_t.device}")
    return propose_phase1_cuda(
        orig_t.to(torch.int32).contiguous(),
        change_t.to(torch.int32).contiguous(),
        lo_t.to(torch.float32).contiguous(),
        hi_t.to(torch.float32).contiguous(),
        u.to(torch.float32).contiguous(), min_distance=min_distance,
        max_probes=max_probes)


propose_phase1.launches = 0
