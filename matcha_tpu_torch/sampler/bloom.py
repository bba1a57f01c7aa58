"""Device-resident Bloom filter over hyperedges.

Port of ``matcha_tpu/sampler/bloom.py``: membership filters for the negative
sampler's rejection loop, one per hyperedge size, sized for
``capacity = 5*len(data)+1000`` at error rate 1e-3.  The filter is a 32-bit
bitset on the device.  Hashing is a murmur-finalised FNV-style accumulation
over the sorted node ids, with double hashing (h1 + i*h2 mod m) for the
per-hash indices.

The JAX package hashes in uint32.  PyTorch has no shift or remainder for
uint32 on the CPU, so the port hashes in int64 and masks to 32 bits after
every product: the low 32 bits of a product that wraps in int64 are those of
the uint32 product, so the hashes are the same bit for bit (held against the
numpy build in tests/test_torch_sampler.py).  The bitset's uint32 words are
stored as int32 and widened on read.  One hash function serves the host
build (on CPU tensors) and the query (on the filter's device).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from matcha_tpu_torch.device import resolve_device

_M32 = 0xFFFFFFFF
_FNV_PRIME1 = 16777619
_FNV_PRIME2 = 2246822519
_SEED1 = 2166136261
_SEED2 = 0x9747B28C
_GOLDEN = 2654435761


def _mix(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def _hash_rows(rows: torch.Tensor, axis: int = -1):
    """int rows -> (h1, h2) hash pair per row as int64 in [0, 2^32),
    accumulated over the k members along ``axis`` (-1: (..., N, k); -2:
    (..., k, N)).  The same bits as the JAX package's ``_hash_rows``."""
    rows = rows.to(torch.int64) & _M32
    if axis == -1:
        cols = rows.unbind(-1)
    elif axis == -2:
        cols = rows.unbind(-2)
    else:
        raise ValueError(f"axis must be -1 or -2, got {axis}")
    h1 = torch.full(cols[0].shape, _SEED1, dtype=torch.int64,
                    device=rows.device)
    h2 = torch.full(cols[0].shape, _SEED2, dtype=torch.int64,
                    device=rows.device)
    for x in cols:
        h1 = (_mix(h1 ^ x) * _FNV_PRIME1) & _M32
        h2 = (_mix(h2 ^ ((x * _GOLDEN) & _M32)) * _FNV_PRIME2) & _M32
    # odd step for double hashing, so all m residues are reachable
    return h1, h2 | 1


def _blocked_word_mask(h1, h2, n_words: int):
    """(word index, 2-bit mask) of the blocked layout."""
    w = h1 % n_words
    mask = (1 << (h2 & 31)) | (1 << ((h2 >> 5) & 31))
    return w, mask


@dataclasses.dataclass
class DeviceBloomFilter:
    """A single-size Bloom filter: the bitset (uint32 words stored as int32)
    and its geometry.  blocked=True puts both hash bits of a key in one
    word, so a query is one gather (see ``_geometry``)."""
    bits: torch.Tensor         # (m_bits // 32,) int32
    m_bits: int
    n_hashes: int
    blocked: bool = False

    def contains(self, rows: torch.Tensor) -> torch.Tensor:
        """Batched membership query: (..., N, k) ids -> (..., N) bool."""
        return self._contains_hashed(*_hash_rows(rows))

    def _word(self, i):
        return self.bits[i].to(torch.int64) & _M32

    def _contains_hashed(self, h1, h2):
        if self.blocked:
            w, mask = _blocked_word_mask(h1, h2, self.bits.shape[0])
            return (self._word(w) & mask) == mask
        hit = torch.ones(h1.shape, dtype=torch.bool, device=h1.device)
        for i in range(self.n_hashes):
            idx = ((h1 + i * h2) & _M32) % self.m_bits
            hit = hit & (((self._word(idx >> 5) >> (idx & 31)) & 1) == 1)
        return hit


def _geometry(capacity: int, error_rate: float,
              fast: bool = True) -> tuple[int, int, bool]:
    """Filter sizing -> (m_bits, n_hashes, blocked).

    fast=True: blocked layout, 128 bits per item with both bits of a key in
    one word; false-positive rate about 7.3e-4, within the 1e-3 target.
    fast=False: classic optimal-k sizing for the requested error rate."""
    if fast and error_rate >= 7.3e-4:
        m_bits = ((capacity * 128 + 31) // 32) * 32
        return m_bits, 2, True
    m_bits = int(math.ceil(-capacity * math.log(error_rate)
                           / (math.log(2) ** 2)))
    m_bits = ((m_bits + 31) // 32) * 32
    if m_bits >= (1 << 32):
        raise ValueError(
            f"bloom geometry overflows 32-bit indexing: capacity={capacity} "
            f"error_rate={error_rate} needs {m_bits} bits (>= 2^32); use "
            f"the blocked layout (error_rate >= 7.3e-4)")
    n_hashes = max(1, round(m_bits / capacity * math.log(2)))
    return m_bits, n_hashes, False


def build_bloom(rows: np.ndarray, capacity: Optional[int] = None,
                error_rate: float = 1e-3,
                device="cuda") -> DeviceBloomFilter:
    """Host build from (N, k) sorted hyperedge rows (numpy bitset), then one
    copy to ``device``.  Capacity default 5*N + 1000."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    n = rows.shape[0]
    if capacity is None:
        capacity = 5 * max(n, 1) + 1000
    m_bits, n_hashes, blocked = _geometry(capacity, error_rate)
    bits = np.zeros(m_bits // 32, dtype=np.uint32)
    if n:
        h1, h2 = (h.numpy().astype(np.uint64)
                  for h in _hash_rows(torch.from_numpy(rows)))
        if blocked:
            w = h1 % np.uint64(bits.shape[0])
            mask = ((np.uint64(1) << (h2 & np.uint64(31)))
                    | (np.uint64(1) << ((h2 >> np.uint64(5))
                                        & np.uint64(31))))
            np.bitwise_or.at(bits, w.astype(np.int64),
                             mask.astype(np.uint32))
        else:
            for i in range(n_hashes):
                idx = ((h1 + np.uint64(i) * h2) & np.uint64(_M32)) \
                    % np.uint64(m_bits)
                np.bitwise_or.at(
                    bits, (idx >> np.uint64(5)).astype(np.int64),
                    (np.uint64(1) << (idx & np.uint64(31))).astype(np.uint32))
    return DeviceBloomFilter(
        bits=torch.from_numpy(bits.view(np.int32)).to(resolve_device(device)),
        m_bits=m_bits, n_hashes=n_hashes, blocked=blocked)


def build_bloom_dict(unlabeled: Dict[int, np.ndarray],
                     error_rate: float = 1e-3,
                     device="cuda") -> Dict[int, DeviceBloomFilter]:
    """Per-size filters from the unlabeled k-mer sets, each sized by the
    total unlabeled count across sizes (the reference's capacity rule)."""
    total = sum(len(v) for v in unlabeled.values())
    capacity = 5 * max(total, 1) + 1000
    return {k: build_bloom(v, capacity=capacity, error_rate=error_rate,
                           device=device)
            for k, v in unlabeled.items()}
