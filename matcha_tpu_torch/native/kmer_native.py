"""ctypes bindings for the native (C++) k-mer enumeration/counting kernel.

A copy of ``matcha_tpu/native/kmer_native.py`` (the port imports nothing of
the JAX package).  The reference implements this stage as a Python
``itertools.combinations`` loop fanned out over a process pool (ref:
Code/generate_kmers.py:100-132).  Here the hot loop is a multithreaded C++
kernel built from ``native/kmer_count.cpp`` at first use into ``_build/``
(``native/build.py``: with OpenMP, else without); the numpy path in
data/kmers.py is the fallback when it cannot be built.  This is host code,
not a device kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np

from matcha_tpu_torch.native.build import load_host_library


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    lib = load_host_library("kmer_count", [("-fopenmp",), ()])
    if lib is None:
        return None
    lib.matcha_count_kmers.restype = ctypes.c_int64
    lib.matcha_count_kmers.argtypes = [
        ctypes.POINTER(ctypes.c_int32),   # flat members
        ctypes.POINTER(ctypes.c_int64),   # offsets
        ctypes.c_int64,                   # num clusters
        ctypes.c_int32,                   # k
        ctypes.c_int32,                   # max_cluster_size
        ctypes.c_int32,                   # min_distance
        ctypes.POINTER(ctypes.c_void_p),  # out handle
    ]
    lib.matcha_kmer_result_fill.restype = None
    lib.matcha_kmer_result_fill.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),   # out kmers (N*k)
        ctypes.POINTER(ctypes.c_int64),   # out freqs (N)
    ]
    lib.matcha_kmer_result_free.restype = None
    lib.matcha_kmer_result_free.argtypes = [ctypes.c_void_p]
    return lib


MAX_K = 5                 # kmer_count.cpp kMaxK
MAX_NODE_ID = (1 << 25)   # pack() gives each member 25 bits of the key


def supported(k: int, flat) -> bool:
    """True if the native kernel can handle this (k, node-id range) —
    beyond these the packed 128-bit keys would corrupt silently (ids) or
    the kernel rejects (k); callers fall back to the numpy path."""
    return k <= MAX_K and (len(flat) == 0 or int(np.max(flat)) < MAX_NODE_ID)


def available() -> bool:
    """Whether the native counter built and loaded (else data/kmers.py
    counts with numpy)."""
    return _load() is not None


def count_kmers(flat: np.ndarray, offsets: np.ndarray, k: int,
                max_cluster_size: int, min_distance: int,
                ) -> Tuple[np.ndarray, np.ndarray]:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native k-mer counter is not available")
    flat = np.ascontiguousarray(flat, dtype=np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    handle = ctypes.c_void_p()
    n = lib.matcha_count_kmers(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(offsets) - 1),
        ctypes.c_int32(k), ctypes.c_int32(max_cluster_size),
        ctypes.c_int32(min_distance), ctypes.byref(handle))
    if n < 0:
        raise ValueError(f"native kmer kernel rejected k={k} (rc={n}); "
                         "callers should gate on supported(k, flat)")
    kmers = np.empty((n, k), dtype=np.int32)
    freqs = np.empty((n,), dtype=np.int64)
    lib.matcha_kmer_result_fill(
        handle,
        kmers.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    lib.matcha_kmer_result_free(handle)
    # already in canonical lexsorted order: the kernel's 128-bit packed keys
    # place v[0] in the most-significant bits and the merged runs are sorted
    # by key, which IS column-0-major lexicographic order
    return kmers, freqs
