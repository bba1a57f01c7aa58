"""The port's models/hypersagnn.py against the JAX package's, in f32.

Parameters are drawn by JAX and carried across with params_from_numpy; the
frozen tables are built by each package from the same numpy contacts.
Tolerance rtol = atol = 2e-5 (summation order; JAX at "highest" precision).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from matcha_tpu.genome import GenomeBins
from matcha_tpu.models import hypersagnn as jh
from matcha_tpu_torch.interop import params_from_numpy
from matcha_tpu_torch.models import hypersagnn as th

TOL = dict(rtol=2e-5, atol=2e-5)


def _model(genome, rng, mode="corrcoef-ae", **dims_kw):
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    intra = intra + intra.T
    inter = rng.random((n, n)).astype(np.float32)
    kw = dict(dim=16, n_head=4, num_chroms=genome.num_chroms, num_nodes=n)
    kw.update(dims_kw)
    jdims = jh.ModelDims(**kw)
    tdims = th.ModelDims(**kw)
    chrom_sizes = [int(e - s) for s, e in genome.chrom_range]
    jp = jh.init_model(jax.random.PRNGKey(0), jdims, chrom_sizes,
                       embedding_mode=mode)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jf = jh.build_frozen_tables(genome, intra, inter)
    tf = th.build_frozen_tables(genome, intra, inter, device="cpu")
    return (jp, jf, jdims), (tp, tf, tdims)


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref, dtype=np.float32),
                               **(tol or TOL))


def _batch(rng, n, B=24, L=5):
    """Padded batch: rows of 2..L distinct node ids, 0-padded at the end."""
    x = np.zeros((B, L), np.int32)
    for b in range(B):
        k = int(rng.integers(2, L + 1))
        x[b, :k] = np.sort(rng.choice(np.arange(1, n + 1), k, replace=False))
    return x


def test_frozen_tables_match(tiny_genome, rng):
    (_, jf, _), (_, tf, _) = _model(tiny_genome, rng)
    for a, b in zip(tf.features, jf.features):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for name in ("attr_table", "inter_z", "chrom_of_node", "chrom_bounds"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                      np.asarray(getattr(jf, name)))


def test_encode_batched_branch(tiny_genome, rng):
    (jp, jf, jd), (tp, tf, td) = _model(tiny_genome, rng)
    got = th.encode_node_table(tp, tf, td)
    assert float(got[0].abs().max()) == 0.0
    _close(got, jh.encode_node_table(jp, jf, jd))


def test_encode_per_chromosome_branch(rng):
    """One chromosome fails the batched gate's len(feats) > 1."""
    genome = GenomeBins(["chr1"], [40_000_000], 1_000_000)
    (jp, jf, jd), (tp, tf, td) = _model(genome, rng)
    _close(th.encode_node_table(tp, tf, td),
           jh.encode_node_table(jp, jf, jd))


def test_encode_table_mode(tiny_genome, rng):
    (jp, jf, jd), (tp, tf, td) = _model(tiny_genome, rng, mode="table")
    # a nonzero row 0 in the stored table must still encode to zeros
    jp["embed"]["table"] = jp["embed"]["table"].at[0].set(1.0)
    tp["embed"]["table"][0] = 1.0
    got = th.encode_node_table(tp, tf, td)
    assert float(got[0].abs().max()) == 0.0
    _close(got, jh.encode_node_table(jp, jf, jd))


@pytest.mark.parametrize("diag", [True, False])
def test_forward_logits_and_positions(tiny_genome, rng, diag):
    (jp, jf, jd), (tp, tf, td) = _model(tiny_genome, rng, diag_mask=diag)
    x = _batch(rng, tiny_genome.num_nodes)
    lj, pj = jh.forward(jp, jf, jd, jnp.asarray(x), return_positions=True)
    lt, pt = th.forward(tp, tf, td, torch.from_numpy(x),
                        return_positions=True)
    assert lt.shape == (24, 1) and pt.shape == (24, 5)
    assert lt.dtype == torch.float32
    _close(lt, lj)
    _close(pt, pj)


@pytest.mark.parametrize("L", [2, 3, 4])
def test_forward_unpadded_sizes(tiny_genome, rng, L):
    (jp, jf, jd), (tp, tf, td) = _model(tiny_genome, rng)
    n = tiny_genome.num_nodes
    x = np.stack([np.sort(rng.choice(np.arange(1, n + 1), L, replace=False))
                  for _ in range(16)]).astype(np.int32)
    _close(th.forward(tp, tf, td, torch.from_numpy(x)),
           jh.forward(jp, jf, jd, jnp.asarray(x)))


def test_forward_given_node_table(tiny_genome, rng):
    (_, _, _), (tp, tf, td) = _model(tiny_genome, rng)
    x = torch.from_numpy(_batch(rng, tiny_genome.num_nodes))
    table = th.encode_node_table(tp, tf, td)
    torch.testing.assert_close(th.forward(tp, tf, td, x, node_table=table),
                               th.forward(tp, tf, td, x), rtol=0, atol=0)


def test_forward_bf16(tiny_genome, rng):
    """bf16 compute: the two packages round at other places inside the
    attention (see ops/hyperedge_attention.py), so 0.05 on the logits."""
    (jp, jf, jd), (tp, tf, td) = _model(tiny_genome, rng,
                                        compute_dtype="bfloat16")
    x = _batch(rng, tiny_genome.num_nodes)
    lt = th.forward(tp, tf, td, torch.from_numpy(x))
    assert lt.dtype == torch.float32
    _close(lt, jh.forward(jp, jf, jd, jnp.asarray(x)), rtol=0.05, atol=0.05)


def test_node_embeddings(tiny_genome, rng):
    (jp, jf, jd), (tp, tf, td) = _model(tiny_genome, rng)
    got = th.node_embeddings(tp, tf, td)
    assert got.shape == (tiny_genome.num_nodes, 16)
    _close(got, jh.node_embeddings(jp, jf, jd))


def test_training_paths_raise(tiny_genome, rng):
    """A recon loss with neither a generator nor a chromosome to draw r
    from raises, in either feature-dropout mode.  The per-occurrence mode
    itself runs in train mode, and its node table stays clean."""
    (_, _, _), (tp, tf, td) = _model(tiny_genome, rng)
    x = torch.from_numpy(_batch(rng, tiny_genome.num_nodes))
    gen = torch.Generator().manual_seed(0)
    occ = td._replace(feature_dropout_mode="per_occurrence")
    out, recon = th.forward(tp, tf, occ, x, train=True, generator=gen,
                            return_recon=True)
    assert torch.isfinite(out).all() and torch.isfinite(recon)
    assert torch.equal(th.encode_node_table(tp, tf, occ, train=True,
                                            generator=gen),
                       th.encode_node_table(tp, tf, td))
    with pytest.raises(ValueError, match="generator or r"):
        th.forward(tp, tf, td, x, return_recon=True)
    with pytest.raises(ValueError, match="generator or r"):
        th.forward(tp, tf, occ, x, train=True, return_recon=True)


@pytest.mark.parametrize("mode", ["corrcoef-ae", "table"])
def test_init_model_keys_and_shapes_match_jax(tiny_genome, mode):
    dims_kw = dict(dim=16, n_head=4, num_chroms=3,
                   num_nodes=tiny_genome.num_nodes)
    sizes = [int(e - s) for s, e in tiny_genome.chrom_range]
    jp = jh.init_model(jax.random.PRNGKey(0), jh.ModelDims(**dims_kw), sizes,
                       embedding_mode=mode)
    tp = th.init_model(torch.Generator().manual_seed(0),
                       th.ModelDims(**dims_kw), sizes, embedding_mode=mode,
                       device="cpu")
    shape = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), tp) == shape
    assert all(t.dtype == torch.float32
               for t in jax.tree_util.tree_leaves(tp))
    if mode == "table":
        assert float(tp["embed"]["table"][0].abs().max()) == 0.0
    # the distributions: attention projections Normal(0, sqrt(2/(2d)))
    wq = tp["encoder"]["mha"]["wq"]
    assert abs(float(wq.std()) - (2 / 32) ** 0.5) < 0.05
    w = tp["attr_nn"]["w"]
    assert float(w.abs().max()) <= 1 / 4 ** 0.5


def test_model_dims_fields_match_jax():
    assert th.ModelDims._fields == jh.ModelDims._fields
    assert th.ModelDims._field_defaults == jh.ModelDims._field_defaults
