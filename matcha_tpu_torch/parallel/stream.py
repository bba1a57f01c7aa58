"""Shard-major stream layout: concat and split along a batch axis that is
cut into ``ns`` contiguous blocks, one per data shard.

Port of ``matcha_tpu/parallel/stream.py``.  Each piece ``(n, ...)`` is
viewed as ``(ns, n / ns, ...)``, the pieces are concatenated along the
second axis and the result is flattened back: shard ``d``'s rows of every
piece then sit in the contiguous block ``d`` of the result, in the order
(shard, piece, local row).  ``shard_split`` with the same ``ns`` recovers
each piece in its original row order, so the pair is an exact inverse for
any ``ns``.  The training step lays its merged token stream out this way
with ``ns`` the mesh's data-axis size (``TrainSettings.n_shards``): a
single rank with ``n_shards = D`` draws its dropout masks over the same
layout as a mesh of D data shards, so the two train alike.
``stream_positions`` gives the position of any row of a piece in that
layout, which a rank uses to take its rows of a mask drawn for the whole
stream.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def divisible(sizes: Sequence[int], ns: int) -> bool:
    """True if every piece size splits evenly over ns > 1 shards (the
    precondition of the shard-major layout; callers take ns = 1 else)."""
    return ns > 1 and all(int(s) % ns == 0 for s in sizes)


def shard_concat(parts: List[torch.Tensor], ns: int,
                 axis: int = 0) -> torch.Tensor:
    """Concatenate along ``axis`` in the shard-major order (shard, piece,
    local row); ns <= 1 or one piece is the plain concatenation."""
    if ns <= 1 or len(parts) == 1:
        return torch.cat(parts, dim=axis)
    resh = []
    for p in parts:
        n = p.shape[axis]
        assert n % ns == 0, (n, ns)
        resh.append(p.reshape(p.shape[:axis] + (ns, n // ns)
                              + p.shape[axis + 1:]))
    out = torch.cat(resh, dim=axis + 1)
    tot = sum(int(p.shape[axis]) for p in parts)
    return out.reshape(out.shape[:axis] + (tot,) + out.shape[axis + 2:])


def shard_split(arr: torch.Tensor, ns: int, sizes: Sequence[int],
                axis: int = 0) -> List[torch.Tensor]:
    """The inverse of ``shard_concat``: the pieces of ``sizes`` rows, each
    in its original row order."""
    sizes = [int(n) for n in sizes]
    if ns <= 1 or len(sizes) == 1:
        return list(arr.split(sizes, dim=axis))
    tot = arr.shape[axis]
    assert tot % ns == 0, (tot, ns)
    a2 = arr.reshape(arr.shape[:axis] + (ns, tot // ns)
                     + arr.shape[axis + 1:])
    parts = []
    for n, piece in zip(sizes, a2.split([n // ns for n in sizes],
                                        dim=axis + 1)):
        assert n % ns == 0, (n, ns)
        parts.append(piece.reshape(arr.shape[:axis] + (n,)
                                   + arr.shape[axis + 1:]))
    return parts


def stream_positions(sizes: Sequence[int], ns: int,
                     spans: Sequence[Tuple[int, int]],
                     device=None) -> torch.Tensor:
    """Positions in ``shard_concat`` of pieces of ``sizes`` rows (ns as
    there) of the rows [lo, hi) of each piece, spans[j] = (lo, hi) for
    piece j, concatenated in piece order -> int64 (sum hi - lo,)."""
    sizes = [int(n) for n in sizes]
    if ns <= 1 or len(sizes) == 1:
        ns = 1
    block = sum(sizes) // ns
    out, before = [], 0
    for n, (lo, hi) in zip(sizes, spans):
        rows = torch.arange(int(lo), int(hi), dtype=torch.int64,
                            device=device)
        per = n // ns
        out.append((rows // per) * block + before + rows % per)
        before += per
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64,
                                                  device=device)
