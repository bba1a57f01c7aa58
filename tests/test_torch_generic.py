"""Generic (typed, non-genomic) hypergraphs in the port against
``matcha_tpu/data/generic.py``.

The numpy parts are copies, bit-equal (tolerance 0).  ``build_generic_problem``
builds the same node space, frozen tables and dims as the JAX package's; its
forward with the JAX params carried across matches the JAX forward at 1e-5
(f32 sums in another order), with and without a user attribute matrix; and
the port's problem trains a step and samples per-type negatives, as
``tests/test_generic.py::test_generic_problem_trains_and_samples`` holds the
JAX package's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from matcha_tpu.data import generic as jg
from matcha_tpu.models import hypersagnn as jh
from matcha_tpu_torch.data import generic as tg
from matcha_tpu_torch.interop import params_from_numpy
from matcha_tpu_torch.models import hypersagnn as th
from matcha_tpu_torch.sampler.bloom import build_bloom
from matcha_tpu_torch.sampler.negative import sample_negatives
from matcha_tpu_torch.train import runtime as tr


def _edges(rng, n_edges=60):
    edges = []
    for _ in range(n_edges):
        e = sorted({int(rng.integers(1, 13)), int(rng.integers(13, 33)),
                    int(rng.integers(1, 33))})
        edges.append(e)
    return edges


def test_copies_are_jax_bit_for_bit(tmp_path):
    a = tg.node_space_from_type_counts(["drug", "gene", "disease"],
                                       [10, 25, 7])
    b = jg.node_space_from_type_counts(["drug", "gene", "disease"],
                                       [10, 25, 7])
    assert a.num_nodes == b.num_nodes == 42
    np.testing.assert_array_equal(a.chrom_range, b.chrom_range)
    np.testing.assert_array_equal(a.node2chrom, b.node2chrom)
    with pytest.raises(ValueError, match="at least|>= 1"):
        tg.node_space_from_type_counts(["a", "b"], [3, 0])

    edges = _edges(np.random.default_rng(0))
    flat = np.concatenate(edges).astype(np.int32)
    offsets = np.zeros(len(edges) + 1, np.int64)
    np.cumsum([len(e) for e in edges], out=offsets[1:])
    space_t = tg.node_space_from_type_counts(["a", "b"], [12, 20])
    space_j = jg.node_space_from_type_counts(["a", "b"], [12, 20])
    for x, y in zip(tg.adjacency_features(space_t, flat, offsets),
                    jg.adjacency_features(space_j, flat, offsets)):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)

    packed = np.array([[3 * 1e7 + 5], [7 * 1e7 + 2], [1e7 + 9]])
    np.testing.assert_array_equal(tg.packed_coord_attributes(packed, 4),
                                  jg.packed_coord_attributes(packed, 4))
    with pytest.raises(ValueError, match="positive"):
        tg.packed_coord_attributes(np.zeros((3, 1)), n_first_type=2)

    path = str(tmp_path / "train_data.npz")
    np.savez(path, train_data=np.asarray(edges, dtype=object),
             nums_type=np.array([12, 20]))
    got, ref = tg.load_npz_dataset(path), jg.load_npz_dataset(path)
    assert got.keys() == ref.keys()
    np.testing.assert_array_equal(got["nums_type"], ref["nums_type"])


@pytest.mark.parametrize("attrs", [False, True])
def test_generic_problem_forward_matches_jax(attrs):
    rng = np.random.default_rng(1)
    edges = _edges(rng)
    attributes = (rng.standard_normal((32, 3)).astype(np.float32)
                  if attrs else None)
    kw = dict(dim=16, n_head=4, attributes=attributes)
    space_t, dims_t, params_t, frozen_t, table_t = tg.build_generic_problem(
        [12, 20], edges, seed=3, device="cpu", **kw)
    space_j, dims_j, params_j, frozen_j, table_j = jg.build_generic_problem(
        [12, 20], edges, seed=3, **kw)
    assert dims_t._asdict() == dims_j._asdict()
    assert dims_t.attr_dim == (3 if attrs else 0)
    for name in ("attr_table", "inter_z"):
        np.testing.assert_array_equal(
            getattr(frozen_t, name).float().numpy(),
            np.asarray(getattr(frozen_j, name), np.float32))
    for a, b in zip(frozen_t.features, frozen_j.features):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b))
    np.testing.assert_array_equal(table_t.node2chrom.numpy(),
                                  np.asarray(table_j.node2chrom))
    # the port's own params have JAX's tree and shapes
    shapes_t = [tuple(t.shape) for t in tr._leaves(params_t)]
    shapes_j = [tuple(x.shape) for x in jax.tree_util.tree_leaves(params_j)]
    assert shapes_t == shapes_j
    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j),
                                "cpu")
    x = np.asarray([e + [0] * (3 - len(e)) for e in edges[:16]], np.int32)
    got = th.forward(carried, frozen_t, dims_t, torch.from_numpy(x))
    ref = np.asarray(jh.forward(params_j, frozen_j, dims_j, jnp.asarray(x)))
    assert got.shape == (16, 1) and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_generic_problem_trains_and_samples():
    rng = np.random.default_rng(2)
    edges = []
    for _ in range(60):
        a, b = int(rng.integers(1, 13)), int(rng.integers(13, 33))
        edges.append(sorted({a, b}))
    space, dims, params, frozen, table = tg.build_generic_problem(
        [12, 20], edges, dim=16, n_head=4, device="cpu")
    x = torch.tensor(edges[:8], dtype=torch.int32)
    out, recon = th.forward(params, frozen, dims, x, return_recon=True,
                            generator=torch.Generator().manual_seed(0),
                            train=True)
    assert out.shape == (8, 1) and np.isfinite(out.detach().numpy()).all()
    assert np.isfinite(float(recon))
    # per-type negative sampling ranges: corrupted positions stay within
    # their node type
    pos = np.asarray(edges[:32], dtype=np.int32)
    neg = sample_negatives(torch.Generator().manual_seed(1),
                           torch.from_numpy(pos), table, 0,
                           build_bloom(pos, device="cpu"), neg_num=2).numpy()
    np.testing.assert_array_equal(
        np.sort(space.node2chrom[np.tile(pos, (2, 1))], 1),
        np.sort(space.node2chrom[neg], 1))
    # one training step moves the params
    t = tr.Trainer(params, frozen, dims, table,
                   tr.TrainSettings(alpha=1.0, beta=0.001, neg_num=2,
                                    max_trials=4), seed=0)
    before = [v.detach().clone() for v in tr._leaves(t.params)]
    aux = t.train_step({2: (torch.from_numpy(pos), torch.ones(32))})
    assert np.isfinite(float(aux["bce"]))
    assert any(not torch.equal(a, b) for a, b in
               zip(before, tr._leaves(t.params)))


def test_generic_problem_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.build_generic_problem([3, 3], [[1, 4]], dim=8, n_head=2)
