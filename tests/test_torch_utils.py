"""The port's utils against ``matcha_tpu/utils.py``: the parameter count and
summary of one model's tree (the JAX package's params, carried across with
``interop``) are equal strings and integers, and the clique-expansion
adjacency is bit-equal."""

import numpy as np
import pytest

import jax

from matcha_tpu import utils as ju
from matcha_tpu.models import hypersagnn as jh
from matcha_tpu_torch import utils as tu
from matcha_tpu_torch.interop import params_from_numpy


@pytest.mark.parametrize("mode", ["corrcoef-ae", "table"])
def test_param_count_and_summary_match_jax(mode):
    dims = jh.ModelDims(dim=16, n_head=4, num_chroms=3, num_nodes=40)
    jp = jh.init_model(jax.random.PRNGKey(0), dims, [12, 18, 10],
                       embedding_mode=mode)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert tu.param_count(tp) == ju.param_count(jp)
    for depth in (1, 2, 3):
        assert tu.param_summary(tp, depth) == ju.param_summary(jp, depth)


def test_edgelist_to_adjacency_matches_jax():
    rng = np.random.default_rng(0)
    edges = [np.sort(rng.choice(np.arange(1, 21), rng.integers(2, 6),
                                replace=False)) for _ in range(30)]
    flat = np.concatenate(edges).astype(np.int32)
    offsets = np.zeros(len(edges) + 1, np.int64)
    np.cumsum([len(e) for e in edges], out=offsets[1:])
    got = tu.edgelist_to_adjacency(flat, offsets, 20)
    np.testing.assert_array_equal(got,
                                  ju.edgelist_to_adjacency(flat, offsets, 20))
    assert got.dtype == np.float64
