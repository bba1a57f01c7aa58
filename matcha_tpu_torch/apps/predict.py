"""Shared batched inference over a trained model bundle.

Port of ``matcha_tpu/apps/predict.py``: inputs are bucketed by hyperedge
size (no padding) and scored in chunks of ``batch_size`` on the device of
the frozen tables.  Eager PyTorch does not recompile per shape, so the tail
chunk is not padded.  A call is one telemetry unit ``request`` with the
spans ``convert`` (bucketing by size in one vectorised pass, and the one
copy of every row to the device: the count ``copies``; the count
``convert.array`` or ``convert.ragged`` names the route the input took),
``encode``, ``forward`` (the chunks) and ``fetch`` (the one copy back: the
sync ``fetch``).
"""

from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from matcha_tpu_torch import telemetry
from matcha_tpu_torch.models.hypersagnn import (ModelDims, encode_node_table,
                                                forward)


def _group(samples, pinned: bool
           ) -> Tuple[List[Tuple[int, np.ndarray]], torch.Tensor]:
    """A request's candidates grouped by size -> (groups, host): groups
    ``[(k, input positions)]`` with the sizes in the order they first
    appear and each size's positions in input order; host every group's
    rows one after another in one flat int64 tensor (page-locked when
    ``pinned``).  A 2-D integer array is one size and is taken as it is;
    anything else is walked once for the lengths and once for the ids."""
    if (isinstance(samples, np.ndarray) and samples.ndim == 2
            and samples.dtype.kind in "iu"):
        telemetry.count("convert.array")
        n, k = samples.shape
        host = torch.empty(n * k, dtype=torch.int64, pin_memory=pinned)
        host.numpy().reshape(n, k)[...] = samples
        return ([(k, np.arange(n))] if n else []), host
    telemetry.count("convert.ragged")
    if not isinstance(samples, (list, tuple)):
        samples = list(samples)
    lens = np.fromiter(map(len, samples), np.int64, len(samples))
    flat = np.fromiter(itertools.chain.from_iterable(samples), np.int64,
                       int(lens.sum()))
    host = torch.empty(flat.size, dtype=torch.int64, pin_memory=pinned)
    groups = sorted(((int(k), np.flatnonzero(lens == k))
                     for k in np.flatnonzero(np.bincount(lens))),
                    key=lambda g: g[1][0])
    buf = host.numpy()
    if len(groups) == 1:
        buf[:] = flat
        return groups, host
    starts = np.cumsum(lens) - lens
    off = 0
    for k, idx in groups:
        buf[off:off + idx.size * k] = flat[
            (starts[idx, None] + np.arange(k)).reshape(-1)]
        off += idx.size * k
    return groups, host


def predict_logits(params, frozen, dims: ModelDims,
                   samples: Sequence[Sequence[int]],
                   batch_size: int = 10_000) -> np.ndarray:
    """Score a ragged list of hyperedges, or a 2-D integer array of one
    size -> (N,) raw f32 logits."""
    with telemetry.unit("request"), torch.inference_mode():
        device = frozen.attr_table.device
        with telemetry.span("convert"):
            groups, host = _group(samples, pinned=device.type == "cuda")
            if groups:
                # One copy of every row, not waited for.  The caching host
                # allocator hands this page-locked block to the next
                # request; that is safe because the sync "fetch" below
                # drains the stream, this copy with it, before the request
                # returns.
                rows = host.to(device, non_blocking=True)
                telemetry.count("copies")
        with telemetry.span("encode"):
            node_table = encode_node_table(params, frozen, dims)
        parts = []          # logits on the device, in the groups' order
        with telemetry.span("forward"):
            off = 0
            for k, idx in groups:
                arr = rows[off:off + idx.size * k].view(idx.size, k)
                off += idx.size * k
                for lo in range(0, idx.size, batch_size):
                    logits = forward(params, frozen, dims,
                                     arr[lo:lo + batch_size],
                                     node_table=node_table)
                    parts.append(logits.reshape(-1))
        with telemetry.span("fetch"):
            out = np.zeros(sum(idx.size for _, idx in groups),
                           dtype=np.float32)
            if parts:                    # one device -> host copy at the end
                with telemetry.sync("fetch"):
                    got = torch.cat(parts).cpu()
                out[np.concatenate([idx for _, idx in groups])] = got.numpy()
        return out


def predict_proba(params, frozen, dims, samples,
                  batch_size: int = 10_000) -> np.ndarray:
    logits = predict_logits(params, frozen, dims, samples, batch_size)
    return 1.0 / (1.0 + np.exp(-logits))
