"""Carry parameter trees and optimizer state between the JAX package and the
port.

The JAX package's params are a nested dict/list of arrays in ``(in, out)``
layout, pickled as numpy arrays in a bundle's ``params.pkl``.  The port keeps
the same tree with tensors as leaves, so the conversion is leaf by leaf.  A
JAX checkpoint may also hold an optax AdamW state, which ``load_pickle``
reads without optax (the machine with the card has none) and
``adamw_state_from_optax`` turns into the port's AdamW state.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch

from matcha_tpu_torch.device import resolve_device


def tree_leaves(tree) -> List:
    """The leaves of a param tree in the JAX package's order: dict keys
    sorted, list and tuple items in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


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


class ScaleByAdamState(NamedTuple):
    """What unpickles in place of optax's ``ScaleByAdamState``."""
    count: Any
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    """What unpickles in place of optax's ``EmptyState`` (the weight decay's
    and the learning rate's states in ``optax.adamw``'s chain)."""


_OPTAX_STATES = {"ScaleByAdamState": ScaleByAdamState,
                 "EmptyState": EmptyState}
_NUMPY_NAMES = {"_reconstruct", "ndarray", "dtype", "scalar"}


class _CheckpointUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays and scalars, Python containers and scalars,
    and optax's AdamW states as the stand-ins above; refuses every other
    class."""

    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if root == "optax" and name in _OPTAX_STATES:
            return _OPTAX_STATES[name]
        if root == "numpy" and (name in _NUMPY_NAMES
                                or module == "numpy.dtypes"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"a checkpoint may not hold {module}.{name}")


def load_pickle(f):
    """Unpickle a checkpoint written by either package from the open file
    ``f`` without importing optax or JAX."""
    return _CheckpointUnpickler(f).load()


def is_optax_adamw(state) -> bool:
    """Whether ``state`` is an unpickled ``optax.adamw`` state: the chain's
    tuple, led by the Adam moments."""
    return (isinstance(state, tuple) and len(state) > 0
            and isinstance(state[0], ScaleByAdamState))


def adamw_state_from_optax(count, mu, nu) -> Dict[str, list]:
    """optax's Adam moments (count, mu, nu: trees shaped like the params)
    -> the port's AdamW state: ``exp_avg``, ``exp_avg_sq`` (numpy arrays)
    and ``step`` (floats) per leaf in ``tree_leaves`` order.  optax's count
    is the number of updates taken, as torch's ``step``."""
    exp_avg = [np.asarray(a, np.float32) for a in tree_leaves(mu)]
    exp_avg_sq = [np.asarray(a, np.float32) for a in tree_leaves(nu)]
    return {"exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq,
            "step": [float(np.asarray(count))] * len(exp_avg)}
