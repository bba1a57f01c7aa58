"""Fused phase-1 negative proposals, in the sampler's row-major layout.

Port of ``matcha_tpu/ops/propose.py``.  The sampler's phase 1 proposes T
candidate rounds per row: it resamples the corrupted positions uniformly in
their chromosome range, sorts each candidate with a k-wide sorting network,
checks the min-distance gaps, and keeps the first S structurally valid
candidates per row for the Bloom probes.  Three functions, as the other ops
have:

  * ``propose_phase1_plain`` — the plain PyTorch version, the JAX package's
    ``_phase1_body`` / ``propose_phase1_ref``: the sampler's own "xla" phase
    1 (``sampler/negative.py:_phase1_xla``) under this op's name;
  * ``propose_phase1_cuda`` — the wrapper of ``csrc/propose.cu`` (K5, the
    port of the TPU kernel ``_kernel`` behind ``propose_phase1``);
  * ``propose_phase1`` — the dispatcher: a CPU tensor takes the plain
    version, a CUDA tensor launches the kernel or raises.

The TPU kernel takes its inputs feature-major, (k, n) and (T, k, n), to put
the rows on the lanes; the card needs no such layout, so the port takes the
sampler's own arrays, (n, k) and (T, n, k), as its "xla" phase 1 does
(``sampler/negative.py:_phase1_xla``), and gives (S, n, k) / (S, n).  With
the same uniforms the two agree bit for bit: the sampler's "pallas" and
"xla" branches give the same negatives.  Both are pure functions of ``u``.
The JAX gate ``supported_block`` (n divisible by 2048, 512 or 128) has no
counterpart: the kernel masks its own ragged edge.
``propose_phase1.launches`` counts K5 launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from matcha_tpu_torch.sampler.negative import _SORT_NETS, _phase1_xla

MAX_ROUNDS = 32   # one round per lane of a warp


def _rows_rounds_probes(orig, u, max_probes):
    n, k = orig.shape
    T = u.shape[0]
    return n, k, T, max(1, min(int(max_probes), T))


def propose_phase1_plain(orig, change, lo, hi, u, *, min_distance: int,
                         max_probes: int):
    """orig/change (n, k) int or bool, lo/hi (n, k) f32, u (T, n, k) f32 ->
    (probe (S, n, k) int32, has (S, n) bool) with S = min(max_probes, T): the
    s-th structurally valid candidate per row in round order (zeros where
    none exists) and whether it exists."""
    _, _, _, S = _rows_rounds_probes(orig, u, max_probes)
    return _phase1_xla(orig.to(torch.int32), change != 0, lo.float(),
                       hi.float(), u.float(), min_distance, S)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The ctypes entry point of K5 (built at first use)."""
    from matcha_tpu_torch.kernels.build import load_library
    lib = load_library("propose")
    fn = lib.matcha_propose_phase1
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.matcha_cuda_error_string.argtypes = [ctypes.c_int]
    lib.matcha_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.matcha_cuda_error_string


_DTYPES = (torch.int32, torch.bool, torch.float32, torch.float32,
           torch.float32)


def propose_phase1_cuda(orig, change, lo, hi, u, *, min_distance: int,
                        max_probes: int):
    """Launch K5 on the current stream.  Takes orig (n, k) int32, change
    (n, k) bool, lo/hi (n, k) f32 and u (T, n, k) f32 with 1 <= k <= 6 and
    1 <= T <= 32, contiguous on one card; raises on anything else (nothing
    is converted or copied).  probe and has share one allocation."""
    ins = (orig, change, lo, hi, u)
    if not (orig.is_cuda and orig.dim() == 2 and u.dim() == 3):
        raise ValueError(f"propose_phase1_cuda: orig must be a CUDA (n, k) "
                         f"tensor and u (T, n, k), got {tuple(orig.shape)} "
                         f"on {orig.device} and {tuple(u.shape)}")
    n, k, T, S = _rows_rounds_probes(orig, u, max_probes)
    dev = orig.device
    if k not in _SORT_NETS or not 1 <= T <= MAX_ROUNDS \
            or u.shape[1:] != orig.shape \
            or not change.shape == lo.shape == hi.shape == orig.shape \
            or tuple(t.dtype for t in ins) != _DTYPES \
            or any(t.device != dev or not t.is_contiguous() for t in ins):
        raise ValueError(
            "propose_phase1_cuda: takes contiguous orig (n, k) int32, change "
            "(n, k) bool, lo / hi (n, k) float32 and u (T, n, k) float32 on "
            f"one card, 1 <= k <= 6, 1 <= T <= {MAX_ROUNDS}; got "
            + ", ".join(f"{t.dtype} {tuple(t.shape)} on {t.device} "
                        f"(contiguous: {t.is_contiguous()})" for t in ins))
    # one allocation of int32 words: probe, then has as bytes
    words = torch.empty((S * n * k + (S * n + 3) // 4,), dtype=torch.int32,
                        device=dev)
    probe = words.as_strided((S, n, k), (n * k, k, 1))
    has = words.view(torch.bool).as_strided((S, n), (n, 1), 4 * S * n * k)
    fn, error_string = _kernel()
    args = (orig.data_ptr(), change.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            u.data_ptr(), probe.data_ptr(), has.data_ptr(), k, n, T, S,
            int(min_distance))
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError("propose_phase1 kernel launch failed: "
                           f"{error_string(err).decode()} (cudaError {err})")
    propose_phase1.launches += 1
    return probe, has


def propose_phase1(orig, change, lo, hi, u, *, min_distance: int,
                   max_probes: int):
    """Phase-1 proposals (see ``propose_phase1_plain``): the plain version
    on the CPU, K5 on a CUDA tensor."""
    if orig.device.type == "cpu":
        return propose_phase1_plain(orig, change, lo, hi, u,
                                    min_distance=min_distance,
                                    max_probes=max_probes)
    if orig.device.type != "cuda":
        raise ValueError(f"propose_phase1: no kernel for {orig.device}")
    return propose_phase1_cuda(orig, change, lo, hi, u,
                               min_distance=min_distance,
                               max_probes=max_probes)


propose_phase1.launches = 0
