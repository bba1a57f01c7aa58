"""Shared batched inference over a trained model bundle.

Port of ``matcha_tpu/apps/predict.py``: inputs are bucketed by hyperedge
size (no padding) and scored in chunks of ``batch_size`` on the device of
the frozen tables.  Eager PyTorch does not recompile per shape, so the tail
chunk is not padded.  A call is one telemetry unit ``request`` with the
spans ``convert`` (bucketing, list to tensor), ``encode``, ``forward`` (the
chunks, with their copies to the device: the syncs ``chunk``) and ``fetch``
(the one copy back: the sync ``fetch``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from matcha_tpu_torch import telemetry
from matcha_tpu_torch.models.hypersagnn import (ModelDims, encode_node_table,
                                                forward)


def predict_logits(params, frozen, dims: ModelDims,
                   samples: Sequence[Sequence[int]],
                   batch_size: int = 10_000) -> np.ndarray:
    """Score a ragged list of hyperedges -> (N,) raw f32 logits."""
    with telemetry.unit("request"), torch.inference_mode():
        with telemetry.span("convert"):
            samples = list(samples)
            out = np.zeros(len(samples), dtype=np.float32)
            device = frozen.attr_table.device
            by_size: Dict[int, List[int]] = {}
            for i, s in enumerate(samples):
                by_size.setdefault(len(s), []).append(i)
        parts = []          # (sample indices, logits on the device)
        with telemetry.span("encode"):
            node_table = encode_node_table(params, frozen, dims)
        for idx in by_size.values():
            with telemetry.span("convert"):
                arr = torch.as_tensor(np.asarray([samples[i] for i in idx],
                                                 dtype=np.int64))
            with telemetry.span("forward"):
                for lo in range(0, len(arr), batch_size):
                    with telemetry.sync("chunk"):
                        chunk = arr[lo:lo + batch_size].to(device)
                    logits = forward(params, frozen, dims, chunk,
                                     node_table=node_table)
                    parts.append((idx[lo:lo + batch_size],
                                  logits.reshape(-1)))
        with telemetry.span("fetch"):
            if parts:                    # one device -> host copy at the end
                with telemetry.sync("fetch"):
                    host = torch.cat([p[1] for p in parts]).cpu()
                out[np.concatenate([np.asarray(p[0]) for p in parts])] = (
                    host.numpy())
        return out


def predict_proba(params, frozen, dims, samples,
                  batch_size: int = 10_000) -> np.ndarray:
    logits = predict_logits(params, frozen, dims, samples, batch_size)
    return 1.0 / (1.0 + np.exp(-logits))
