"""Carry parameter trees between the JAX package and the port.

The JAX package's params are a nested dict/list of arrays in ``(in, out)``
layout, pickled as numpy arrays in a bundle's ``params.pkl``.  The port keeps
the same tree with tensors as leaves, so the conversion is leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from matcha_tpu_torch.device import resolve_device


def params_from_numpy(tree, device="cuda", dtype=torch.float32):
    """numpy param tree (as ``params.pkl`` holds it) -> the same tree of
    tensors of ``dtype`` on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return torch.tensor(np.asarray(node), dtype=dtype, device=dev)

    return conv(tree)


def params_to_numpy(tree):
    """The inverse: a tree of tensors -> the same tree of numpy arrays
    (bf16 leaves come back as f32)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
