"""k-mer (sub-hyperedge) enumeration and counting.

Semantics match the reference's ``generate_kmers.py`` (ref: Code/generate_kmers.py:8-145):
for each k, over all clusters with ``k <= |cluster| <= max_cluster_size``, count
every sorted k-subset of the cluster whose adjacent node-id gaps all exceed
``min_distance``; keep k-mers with total count >= ``min_freq_cutoff``.

(The reference anchors enumeration on the minimum member — ``combinations(members
> i + min_dis, k-1)`` per anchor ``i`` plus an adjacent-gap filter for k>2 —
which is exactly the "all adjacent gaps > min_distance" rule stated above, with
each k-subset counted once at its minimum element.)

The per-anchor Python ``itertools.combinations`` loop + process pool of the
reference becomes: group clusters by size, apply a precomputed combination
index template per (size, k) in one gather, filter gaps vectorized, and count
via lexsort + run-length encoding.  A multithreaded C++ kernel
(``native/kmer_count.cpp``, built with g++ at first use) is used when
available for the enumeration+count.

A copy of ``matcha_tpu/data/kmers.py`` on the port's own modules (the
port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from functools import lru_cache
from itertools import combinations
from typing import Dict, Tuple

import numpy as np


@lru_cache(maxsize=None)
def _comb_template(size: int, k: int) -> np.ndarray:
    """(C(size,k), k) int array of member-position combinations (ascending)."""
    return np.array(list(combinations(range(size), k)), dtype=np.int64)


def _count_rows(kmers: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Count duplicate rows: returns (unique_rows lexsorted, counts)."""
    if kmers.shape[0] == 0:
        return kmers, np.zeros((0,), dtype=np.int64)
    order = np.lexsort(kmers.T[::-1])
    sk = kmers[order]
    change = np.any(sk[1:] != sk[:-1], axis=1)
    first = np.flatnonzero(np.concatenate([[True], change]))
    counts = np.diff(np.concatenate([first, [sk.shape[0]]]))
    return sk[first], counts


def _pack_bits(parts, k: int) -> int:
    """Bits per member id so k ids pack into one u64 key (lexicographic
    order preserved), or 0 when they don't fit."""
    mx = 0
    for rows, _ in parts:
        if rows.shape[0]:
            mx = max(mx, int(rows.max()))
    bits = max(int(mx).bit_length(), 1)
    return bits if k * bits <= 64 else 0


def _pack_rows(rows: np.ndarray, bits: int) -> np.ndarray:
    out = np.zeros(rows.shape[0], np.uint64)
    for c in range(rows.shape[1]):
        out <<= np.uint64(bits)
        out |= rows[:, c].astype(np.uint64)
    return out


def _unpack_rows(keys: np.ndarray, k: int, bits: int) -> np.ndarray:
    rows = np.empty((keys.shape[0], k), np.int32)
    mask = np.uint64((1 << bits) - 1)
    for c in range(k - 1, -1, -1):
        rows[:, c] = (keys & mask).astype(np.int32)
        keys = keys >> np.uint64(bits)
    return rows


# row-count threshold above which the packed merge switches to the bucketed
# two-pass form (module-level so tests can force the bucketed path)
_BUCKET_MERGE_MIN = 1 << 25


def _merge_many(parts) -> Tuple[np.ndarray, np.ndarray]:
    """Merge a list of (unique_rows, counts) pairs (rows may overlap across
    pairs).  When the ids pack into u64 keys (k*bits <= 64 — true for every
    genome up to ~16M nodes at k=4 / 4096 nodes at k=5), one packed
    sort+reduceat replaces the per-pair (N, k) lexsorts: at 4DN scale
    (~10^9 rows) the lexsort path is hours, the packed path is minutes."""
    parts = [p for p in parts if p[0].shape[0]] or parts[:1]
    if len(parts) == 1:
        return parts[0]
    k = parts[0][0].shape[1]
    bits = _pack_bits(parts, k)
    if bits:
        packed = [_pack_rows(p[0], bits) for p in parts]
        total = sum(len(p) for p in packed)
        if total > _BUCKET_MERGE_MIN:
            # Bucketed two-pass merge: each part's keys are ascending
            # (lexsorted uniques), so bucket ranges come free via
            # searchsorted on the key's high bits; every bucket then
            # sorts a ~1/nb working set.  At 4DN scale (k=5: ~220M rows
            # over 4 shards) this cuts the merge peak RSS from the full
            # concatenated keys+counts+argsort (~24 GB measured) to the
            # per-bucket slice, and the smaller sorts are cache-resident.
            nb = 64
            shift = np.uint64(max(0, k * bits - 6))
            edges = (np.arange(1, nb, dtype=np.uint64) << shift)
            bounds = [np.searchsorted(pk, edges) for pk in packed]
            rows_out, cnt_out = [], []
            for b in range(nb):
                ks, cs = [], []
                for pk, (rws, cn), bd in zip(packed, parts, bounds):
                    s = 0 if b == 0 else bd[b - 1]
                    e = len(pk) if b == nb - 1 else bd[b]
                    if e > s:
                        ks.append(pk[s:e])
                        cs.append(cn[s:e])
                if not ks:
                    continue
                keys = np.concatenate(ks)
                cnt = np.concatenate(cs)
                order = np.argsort(keys, kind="stable")
                keys, cnt = keys[order], cnt[order]
                first = np.flatnonzero(
                    np.concatenate([[True], keys[1:] != keys[:-1]]))
                rows_out.append(_unpack_rows(keys[first], k, bits))
                cnt_out.append(np.add.reduceat(cnt, first))
            return (np.concatenate(rows_out),
                    np.concatenate(cnt_out))
        keys = np.concatenate(packed)
        cnt = np.concatenate([p[1] for p in parts])
        order = np.argsort(keys, kind="stable")
        keys, cnt = keys[order], cnt[order]
        first = np.flatnonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))
        return _unpack_rows(keys[first], k, bits), np.add.reduceat(cnt, first)
    rows = np.concatenate([p[0] for p in parts], axis=0)
    cnt = np.concatenate([p[1] for p in parts])
    order = np.lexsort(rows.T[::-1])
    rows, cnt = rows[order], cnt[order]
    change = np.any(rows[1:] != rows[:-1], axis=1)
    first = np.flatnonzero(np.concatenate([[True], change]))
    return rows[first], np.add.reduceat(cnt, first)


def _merge_counts(a: Tuple[np.ndarray, np.ndarray],
                  b: Tuple[np.ndarray, np.ndarray],
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge two (unique_rows, counts) pairs (rows may overlap)."""
    return _merge_many([a, b])


def count_kmers(flat: np.ndarray, offsets: np.ndarray, k: int,
                max_cluster_size: int, min_distance: int,
                chunk_kmers: int = 8_000_000,
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Count all gap-filtered sorted k-subsets over the cluster set.

    Args:
      flat, offsets: CSR cluster encoding (members sorted & distinct per cluster).
      chunk_kmers: approximate number of enumerated k-mers per processing chunk
        (bounds peak memory; counts are merged across chunks).

    Returns: (kmers (N, k) int32 lexsorted, freqs (N,) int64)
    """
    from matcha_tpu_torch.native import kmer_native
    if kmer_native.available() and kmer_native.supported(k, flat):
        return kmer_native.count_kmers(flat, offsets, k, max_cluster_size,
                                       min_distance)
    return _count_kmers_numpy(flat, offsets, k, max_cluster_size, min_distance,
                              chunk_kmers)


def _count_kmers_numpy(flat, offsets, k, max_cluster_size, min_distance,
                       chunk_kmers):
    sizes = np.diff(offsets)
    acc: Tuple[np.ndarray, np.ndarray] | None = None

    for s in range(k, max_cluster_size + 1):
        idx = np.flatnonzero(sizes == s)
        if idx.size == 0:
            continue
        # (M, s) matrix of member ids for all clusters of this size
        starts = offsets[idx]
        members = flat[starts[:, None] + np.arange(s)[None, :]]
        tmpl = _comb_template(s, k)                   # (C, k)
        per_cluster = tmpl.shape[0]
        clusters_per_chunk = max(1, chunk_kmers // max(per_cluster, 1))
        for lo in range(0, members.shape[0], clusters_per_chunk):
            block = members[lo:lo + clusters_per_chunk]
            kmers = block[:, tmpl]                    # (m, C, k)
            kmers = kmers.reshape(-1, k)
            gaps = np.diff(kmers, axis=1)
            ok = (gaps > min_distance).all(axis=1)
            kmers = np.ascontiguousarray(kmers[ok], dtype=np.int32)
            part = _count_rows(kmers)
            acc = part if acc is None else _merge_counts(acc, part)

    if acc is None:
        return (np.zeros((0, k), dtype=np.int32), np.zeros((0,), dtype=np.int64))
    return acc


def shard_clusters(flat: np.ndarray, offsets: np.ndarray,
                   shard_index: int, shard_count: int,
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """CSR subset of every ``shard_count``-th cluster from ``shard_index``.

    Round-robin over cluster order balances work across shards (cluster
    sizes are roughly exchangeable in SPRITE data); enumeration is
    embarrassingly parallel over clusters, so shards can run on different
    hosts and their partial counts merge exactly (DESIGN §8.4)."""
    if not (0 <= shard_index < shard_count):
        raise ValueError(f"shard_index {shard_index} not in [0, {shard_count})")
    sizes = np.diff(offsets)
    idx = np.arange(shard_index, sizes.size, shard_count)
    lens = sizes[idx]
    new_offsets = np.zeros(idx.size + 1, dtype=offsets.dtype)
    np.cumsum(lens, out=new_offsets[1:])
    if idx.size == 0:
        return flat[:0], new_offsets
    gather = (np.repeat(offsets[idx] - new_offsets[:-1], lens)
              + np.arange(int(lens.sum())))
    return flat[gather], new_offsets


def _shard_paths(temp_dir: str, k: int, shard_index: int, shard_count: int):
    tag = f"shard{shard_index}of{shard_count}"
    return (os.path.join(temp_dir, f"all_{k}_counter.{tag}.npy"),
            os.path.join(temp_dir, f"all_{k}_freq_counter.{tag}.npy"))


def _meta_path(kmer_path: str) -> str:
    return kmer_path[: -len(".npy")] + ".meta.npz"


def _write_partial_meta(kmer_path: str, kmers: np.ndarray) -> None:
    """Sidecar metadata for the streaming merge: row count, max member id,
    and the cumulative first-column histogram ``col0_cuts`` (cuts[v] = rows
    with col0 < v).  Rows are lexsorted, so any id_0 range maps to a
    contiguous row range via these cuts — the merge then never scans the
    (multi-GB) partial, it mmap-slices exactly the bucket it needs."""
    if kmers.shape[0] == 0:
        np.savez(_meta_path(kmer_path), n_rows=0, max_id=0,
                 col0_cuts=np.zeros(2, np.int64))
        return
    max_id = int(kmers.max())
    counts = np.bincount(kmers[:, 0], minlength=max_id + 1)
    cuts = np.zeros(max_id + 2, np.int64)
    np.cumsum(counts, out=cuts[1:])
    np.savez(_meta_path(kmer_path), n_rows=kmers.shape[0], max_id=max_id,
             col0_cuts=cuts)


def _partial_meta(kmer_path: str, chunk_rows: int = 8_000_000) -> dict:
    """Load (or reconstruct, for pre-metadata shards) a partial's merge
    metadata.  The fallback scans the mmap in bounded chunks and drops the
    pages afterwards (madvise DONTNEED) so peak RSS stays at the chunk."""
    mp = _meta_path(kmer_path)
    if os.path.exists(mp):
        with np.load(mp) as z:
            return {"n_rows": int(z["n_rows"]), "max_id": int(z["max_id"]),
                    "col0_cuts": z["col0_cuts"].copy()}
    mm = np.load(kmer_path, mmap_mode="r")
    n = mm.shape[0]
    max_id = 0
    counts = np.zeros(1, np.int64)
    for lo in range(0, n, chunk_rows):
        block = np.asarray(mm[lo:lo + chunk_rows])
        if block.size:
            max_id = max(max_id, int(block.max()))
            c = np.bincount(block[:, 0], minlength=max_id + 1)
            if c.size > counts.size:
                counts = np.concatenate(
                    [counts, np.zeros(c.size - counts.size, np.int64)])
            counts[: c.size] += c
    try:
        mm._mmap.madvise(__import__("mmap").MADV_DONTNEED)
    except (AttributeError, ValueError):
        pass
    del mm
    cuts = np.zeros(max_id + 2, np.int64)
    np.cumsum(counts[: max_id + 1], out=cuts[1:])
    return {"n_rows": n, "max_id": max_id, "col0_cuts": cuts}


def _merge_bucket(paths, k, lo_id, hi_id, bounds_lo, bounds_hi, bits,
                  min_freq_cutoff):
    """Merge one id_0-range bucket across all partials: mmap-slice each
    partial's contiguous [bounds_lo, bounds_hi) rows, pack to u64 keys,
    sort+reduceat, apply the freq cutoff (buckets are disjoint key ranges,
    so the global cutoff is exact per bucket).  Peak memory = the bucket's
    working set, not the concatenated partials."""
    ks, cs = [], []
    for (kp, fp), s, e in zip(paths, bounds_lo, bounds_hi):
        if e > s:
            rows_mm = np.load(kp, mmap_mode="r")
            cnt_mm = np.load(fp, mmap_mode="r")
            rows = np.asarray(rows_mm[s:e])
            cnt = np.asarray(cnt_mm[s:e]).astype(np.int64)
            del rows_mm, cnt_mm          # unmap: pages don't pile into RSS
            ks.append(_pack_rows(rows, bits))
            cs.append(cnt)
    if not ks:
        return (np.zeros((0, k), np.int32), np.zeros((0,), np.int64))
    keys = np.concatenate(ks)
    cnt = np.concatenate(cs)
    del ks, cs
    order = np.argsort(keys, kind="stable")
    keys, cnt = keys[order], cnt[order]
    del order
    first = np.flatnonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))
    keys = keys[first]
    cnt = np.add.reduceat(cnt, first)
    keep = cnt >= min_freq_cutoff
    return _unpack_rows(keys[keep], k, bits), cnt[keep]


def _merge_bucket_to_file(args):
    """Worker entry: merge one bucket and write the result to a temp pair
    (file handoff avoids pickling multi-GB arrays through the pool pipe)."""
    (paths, k, lo, hi, b_lo, b_hi, bits, cutoff, out_prefix) = args
    rows, cnt = _merge_bucket(paths, k, lo, hi, b_lo, b_hi, bits, cutoff)
    np.save(out_prefix + ".rows.npy", rows)
    np.save(out_prefix + ".cnt.npy", cnt)
    return rows.shape[0]


def merge_shard_files_streaming(paths, k: int, min_freq_cutoff: int, *,
                                n_buckets: int = 64, workers: int = 0,
                                temp_dir: str | None = None):
    """Bounded-memory merge of lexsorted per-shard partial counters.

    Streams the partials through ``n_buckets`` disjoint id_0-range buckets:
    per bucket, only that range's rows are mmap-sliced from each partial
    (located via the sidecar col0_cuts metadata — no full-file scan), so
    peak RSS is ~total_rows/n_buckets x 44 B instead of the full
    concatenated partials (the round-4 merge peaked at 21 GB at 4DN scale;
    this form stays under ~2 GB).  The freq cutoff applies per bucket
    (disjoint key ranges => exact), shrinking the accumulated output too.
    ``workers`` > 0 merges buckets in a process pool (buckets are
    independent; results hand off via temp files).  Output is bit-equal to
    the single-host generate_kmers artifacts (pinned in test_data.py).
    Replaces the reference's overnight 50-node-batch process pool
    (ref Code/generate_kmers.py:100-132) at multi-host scale."""
    metas = [_partial_meta(kp) for kp, _ in paths]
    total = sum(m["n_rows"] for m in metas)
    if total == 0:
        return (np.zeros((0, k), np.int32), np.zeros((0,), np.int64))
    max_id = max(m["max_id"] for m in metas)
    bits = max(int(max_id).bit_length(), 1)
    if k * bits > 64:
        # ids don't pack into u64 (k=5 beyond ~4096 nodes is fine: 12 bits
        # each; this needs >12-bit ids at k=5 AND >2^52 total) — fall back
        # to the in-memory lexsort merge
        parts = [(np.load(kp), np.load(fp).astype(np.int64))
                 for kp, fp in paths]
        rows, cnt = _merge_many(parts)
        keep = cnt >= min_freq_cutoff
        return rows[keep], cnt[keep]
    edges = np.linspace(0, max_id + 1, n_buckets + 1).astype(np.int64)
    edges = np.unique(edges)
    bounds = []
    for m in metas:
        cuts = m["col0_cuts"]
        e_cl = np.minimum(edges, m["max_id"] + 1)
        bounds.append(cuts[e_cl])
    tasks = []
    for b in range(len(edges) - 1):
        b_lo = [bd[b] for bd in bounds]
        b_hi = [bd[b + 1] for bd in bounds]
        if sum(b_hi) > sum(b_lo):
            tasks.append((b, edges[b], edges[b + 1], b_lo, b_hi))
    if workers and len(tasks) > 1 and temp_dir is not None:
        import tempfile
        from concurrent.futures import ProcessPoolExecutor
        with tempfile.TemporaryDirectory(dir=temp_dir) as td:
            argl = [(paths, k, lo, hi, b_lo, b_hi, bits, min_freq_cutoff,
                     os.path.join(td, f"bucket{b:04d}"))
                    for (b, lo, hi, b_lo, b_hi) in tasks]
            with ProcessPoolExecutor(max_workers=workers) as ex:
                list(ex.map(_merge_bucket_to_file, argl))
            rows_out = [np.load(os.path.join(td, f"bucket{b:04d}.rows.npy"))
                        for (b, *_rest) in tasks]
            cnt_out = [np.load(os.path.join(td, f"bucket{b:04d}.cnt.npy"))
                       for (b, *_rest) in tasks]
            return np.concatenate(rows_out), np.concatenate(cnt_out)
    rows_out, cnt_out = [], []
    for (b, lo, hi, b_lo, b_hi) in tasks:
        rows, cnt = _merge_bucket(paths, k, lo, hi, b_lo, b_hi, bits,
                                  min_freq_cutoff)
        rows_out.append(rows)
        cnt_out.append(cnt)
    return np.concatenate(rows_out), np.concatenate(cnt_out)


def generate_kmers_shard(flat: np.ndarray, offsets: np.ndarray, k_list, *,
                         max_cluster_size: int, min_distance: int,
                         shard_index: int, shard_count: int, temp_dir: str,
                         verbose: bool = True,
                         ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """One shard of a multi-host k-mer generation pass.

    Counts this shard's clusters only and writes PARTIAL counters
    (``all_<k>_counter.shard<i>of<n>.npy`` + int64 freq partials).  The
    ``min_freq_cutoff`` is NOT applied here — a k-mer below the cutoff in
    every shard can still clear it in total, so the cutoff is only correct
    after ``merge_kmer_shards``."""
    sflat, soffsets = shard_clusters(flat, offsets, shard_index, shard_count)
    os.makedirs(temp_dir, exist_ok=True)
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for k in k_list:
        kmers, freqs = count_kmers(sflat, soffsets, int(k), max_cluster_size,
                                   min_distance)
        out[int(k)] = (kmers, freqs)
        kp, fp = _shard_paths(temp_dir, int(k), shard_index, shard_count)
        np.save(kp, kmers)
        np.save(fp, freqs.astype(np.int64))
        _write_partial_meta(kp, kmers)   # streaming-merge sidecar
        if verbose:
            print(f"k={k} shard {shard_index}/{shard_count}: "
                  f"{len(freqs)} partial k-mers over "
                  f"{soffsets.size - 1} clusters")
    return out


def merge_kmer_shards(k_list, *, shard_count: int, temp_dir: str,
                      min_freq_cutoff: int, verbose: bool = True,
                      workers: int | None = None,
                      ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Merge per-shard partial counters into the final reference-layout
    artifacts (``all_<k>_counter.npy`` / ``all_<k>_freq_counter.npy``),
    applying ``min_freq_cutoff`` on the summed counts.  Streams the
    partials bucket-by-bucket (merge_shard_files_streaming) so peak RSS is
    bounded by one bucket's working set, not the concatenated shards.
    workers: process-parallel buckets (default MATCHA_MERGE_WORKERS or 0)."""
    if workers is None:
        workers = int(os.environ.get("MATCHA_MERGE_WORKERS", "0"))
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for k in k_list:
        k = int(k)
        paths = [_shard_paths(temp_dir, k, i, shard_count)
                 for i in range(shard_count)]
        kmers, freqs = merge_shard_files_streaming(
            paths, k, min_freq_cutoff, workers=workers, temp_dir=temp_dir)
        out[k] = (kmers, freqs)
        if verbose:
            hist = {c: int((freqs >= c).sum()) for c in range(2, 9)}
            print(f"k={k}: {len(freqs)} k-mers  freq>=c histogram {hist}")
        np.save(os.path.join(temp_dir, f"all_{k}_counter.npy"), kmers)
        np.save(os.path.join(temp_dir, f"all_{k}_freq_counter.npy"),
                freqs.astype(np.float32))
    return out


def generate_kmers(flat: np.ndarray, offsets: np.ndarray, k_list, *,
                   max_cluster_size: int, min_distance: int,
                   min_freq_cutoff: int, temp_dir: str | None = None,
                   verbose: bool = True,
                   ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Full k-mer generation pass; optionally writes reference-layout artifacts
    ``all_<k>_counter.npy`` / ``all_<k>_freq_counter.npy``
    (ref Code/generate_kmers.py:140-141)."""
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for k in k_list:
        kmers, freqs = count_kmers(flat, offsets, int(k), max_cluster_size,
                                   min_distance)
        keep = freqs >= min_freq_cutoff
        kmers, freqs = kmers[keep], freqs[keep]
        out[int(k)] = (kmers, freqs)
        if verbose:
            hist = {c: int((freqs >= c).sum()) for c in range(2, 9)}
            print(f"k={k}: {len(freqs)} k-mers  freq>=c histogram {hist}")
        if temp_dir is not None:
            os.makedirs(temp_dir, exist_ok=True)
            np.save(os.path.join(temp_dir, f"all_{k}_counter.npy"), kmers)
            np.save(os.path.join(temp_dir, f"all_{k}_freq_counter.npy"),
                    freqs.astype(np.float32))
    return out
