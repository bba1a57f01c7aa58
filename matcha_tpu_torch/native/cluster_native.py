"""ctypes bindings for the native (C++) .clusters parser.

A copy of ``matcha_tpu/native/cluster_native.py`` (the port imports nothing
of the JAX package).  The reference parses cluster files with a per-line
Python loop (ref: Code/process.py:42-87) — ~1-2 MB/s per core, hours on real
4DN SPRITE inputs (tens of GB).  ``native/cluster_parse.cpp`` mmaps the file
and parses newline-aligned byte ranges across threads; it is built at first
use into ``_build/`` (``native/build.py``).  The Python path in
data/clusters.py is both the fallback and the correctness oracle.  This is
host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import numpy as np

from matcha_tpu_torch.native.build import load_host_library


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    lib = load_host_library("cluster_parse", [("-pthread",)])
    if lib is None:
        return None
    lib.matcha_parse_clusters.restype = ctypes.c_int32
    lib.matcha_parse_clusters.argtypes = [
        ctypes.c_char_p,                  # path
        ctypes.c_char_p,                  # chrom name blob
        ctypes.POINTER(ctypes.c_int32),   # chrom name lengths
        ctypes.c_int32,                   # n_chroms
        ctypes.POINTER(ctypes.c_int64),   # first_node per chrom
        ctypes.c_int64,                   # resolution
        ctypes.c_int32,                   # max_cluster_size
        ctypes.c_int32,                   # n_threads
        ctypes.POINTER(ctypes.c_void_p),  # out handle
    ]
    lib.matcha_cluster_result_sizes.restype = None
    lib.matcha_cluster_result_sizes.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64)]
    lib.matcha_cluster_result_fill.restype = None
    lib.matcha_cluster_result_fill.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64)]
    lib.matcha_cluster_result_free.restype = None
    lib.matcha_cluster_result_free.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """Whether the native parser built and loaded (else data/clusters.py
    parses line by line in Python)."""
    return _load() is not None


def parse_clusters(path: str, genome, max_cluster_size: int,
                   n_threads: Optional[int] = None,
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Native equivalent of data.clusters.parse_clusters."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native cluster parser is not available")
    names = list(genome.chrom_names)
    blob = "".join(names).encode()
    lens = np.asarray([len(n.encode()) for n in names], dtype=np.int32)
    first = np.ascontiguousarray(genome.chrom_range[:, 0], dtype=np.int64)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    handle = ctypes.c_void_p()
    rc = lib.matcha_parse_clusters(
        path.encode(), blob,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(names),
        first.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        int(genome.resolution), int(max_cluster_size), int(n_threads),
        ctypes.byref(handle))
    if rc == -4:
        raise ValueError(f"malformed coordinate in {path} (matches the "
                         "Python parser's int() ValueError)")
    if rc != 0:
        raise OSError(f"native cluster parse failed: rc={rc} path={path}")
    try:
        n_flat = ctypes.c_int64()
        n_clusters = ctypes.c_int64()
        lib.matcha_cluster_result_sizes(handle, ctypes.byref(n_flat),
                                        ctypes.byref(n_clusters))
        flat = np.empty(n_flat.value, dtype=np.int32)
        offsets = np.empty(n_clusters.value + 1, dtype=np.int64)
        lib.matcha_cluster_result_fill(
            handle, flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    finally:
        lib.matcha_cluster_result_free(handle)
    return flat, offsets
