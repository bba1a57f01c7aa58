"""Small utilities: parameter summaries and the clique-expansion adjacency.

Port of ``matcha_tpu/utils.py``.  The param tree is the port's nested dict /
list of tensors (the JAX package's tree with tensors as leaves), so the
summaries print what the JAX package prints for a tree carried across by
``interop``.  The profiler scope lives in ``telemetry`` (``profile_trace``).

The JAX module's ``enable_compile_cache`` (XLA's persistent executable
cache) and ``warm_loop_runtime`` (a first-loop initialisation of a remote TPU
runtime) have no counterpart here: eager PyTorch compiles no program per
shape, and the hand-written kernels are built once into ``_build/``
(``kernels/build.py``), where later runs find them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _leaf_shapes(tree, path=()):
    """(dotted path, shape) of every leaf, in the tree's own order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_shapes(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_shapes(v, path + (str(i),))
    else:
        yield ".".join(path), tuple(tree.shape)


def param_count(params) -> int:
    """Total trainable parameter count (the reference prints it at startup,
    ref Code/main.py:632-634)."""
    return sum(int(np.prod(s)) for _, s in _leaf_shapes(params))


def param_summary(params, max_depth: int = 3) -> str:
    """A table of the parameter counts grouped by the first ``max_depth``
    levels of the tree, and the total (ref History_version/Code/
    torchsummary.py)."""
    grouped: Dict[str, int] = {}
    for name, shape in _leaf_shapes(params):
        key = ".".join(name.split(".")[:max_depth])
        grouped[key] = grouped.get(key, 0) + int(np.prod(shape))
    width = max(len(k) for k in grouped) if grouped else 10
    lines = [f"{'module':<{width}}  params", "-" * (width + 10)]
    for k in sorted(grouped):
        lines.append(f"{k:<{width}}  {grouped[k]:,}")
    lines.append("-" * (width + 10))
    lines.append(f"{'total':<{width}}  {param_count(params):,}")
    return "\n".join(lines)


def edgelist_to_adjacency(flat: np.ndarray, offsets: np.ndarray,
                          num_nodes: int) -> np.ndarray:
    """Clique-expansion co-occurrence adjacency of the hyperedge list (ref
    edgelist2adj, Code/process.py:90-105): entry (i-1, j-1) counts the
    hyperedges holding both nodes i and j (i != j)."""
    adj = np.zeros((num_nodes, num_nodes))
    for a in range(len(offsets) - 1):
        e = flat[offsets[a]:offsets[a + 1]]
        i, j = np.meshgrid(e, e, indexing="ij")
        mask = i != j
        np.add.at(adj, (i[mask] - 1, j[mask] - 1), 1)
    return adj

