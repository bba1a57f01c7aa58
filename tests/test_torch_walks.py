"""The port's walk pretraining pieces against the JAX package.

- Alias tables, clique walks and hypergraph walks (scipy weights) are copies:
  bit-equal to ``matcha_tpu/walks`` for one seed (tolerance 0).
- The incidence ops against ``matcha_tpu/ops/incidence.py`` on the same
  padded edges, at 1e-6 of each output's largest entry (f32 sums in another
  order).
- ``walks_to_pairs`` and ``unigram_table``: bit-equal.
- The SGNS step: 3 minibatches with the uniforms of the JAX step's own key
  stream injected, against ``_sgns_epoch`` (which reaches its TPU kernels'
  plain references on the CPU), tables and losses at 1e-5 of the tables'
  largest entry (f32 sums in another order).
- ``train_skipgram`` separates two communities, as
  ``tests/test_walks.py::test_skipgram_learns_community_structure`` holds
  the JAX package to (random streams differ, so only in behaviour).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from matcha_tpu.ops import incidence as ji
from matcha_tpu.walks import alias as ja
from matcha_tpu.walks import clique as jc
from matcha_tpu.walks import hyper as jhy
from matcha_tpu.walks import skipgram as jsg
from matcha_tpu_torch.ops import incidence as ti
from matcha_tpu_torch.walks import alias as ta
from matcha_tpu_torch.walks import clique as tc
from matcha_tpu_torch.walks import hyper as thy
from matcha_tpu_torch.walks import skipgram as tsg

HYPEREDGES = [[0, 1, 2], [1, 2, 3], [2, 3], [3, 4, 5], [0, 5], [1, 4, 5]]
N = 6


def _random_edges(seed, n, n_edges, k_lo=2, k_hi=6):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(n, size=rng.integers(k_lo, k_hi),
                              replace=False)) for _ in range(n_edges)]


# ------------------------------------------------------------------ walks
def test_alias_tables_and_draws_are_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    dists = [rng.dirichlet(np.ones(k)) for k in (3, 1, 7, 2)]
    values = [rng.integers(0, 100, len(d)) for d in dists]
    got = ta.build_alias_tables(dists, values)
    ref = ja.build_alias_tables(dists, values)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    ids = np.random.default_rng(1).integers(0, 4, 5000)
    np.testing.assert_array_equal(
        got.draw(ids, np.random.default_rng(2)),
        ref.draw(ids, np.random.default_rng(2)))


@pytest.mark.parametrize("p,q", [(2.0, 0.25), (0.5, 4.0)])
def test_clique_walks_are_jax_bit_for_bit(p, q):
    edges = _random_edges(3, 30, 60)
    kw = dict(p=p, q=q, num_walks=4, walk_length=12, seed=7)
    got = tc.clique_node2vec_walks(30, edges, **kw)
    ref = jc.clique_node2vec_walks(30, edges, **kw)
    assert got.shape == (30 * 4, 12)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", ["hand", "random"])
def test_hypergraph_walks_are_jax_bit_for_bit(case):
    n, edges = ((N, HYPEREDGES) if case == "hand"
                else (40, _random_edges(9, 40, 120)))
    kw = dict(num_walks=5, walk_length=10, seed=5, weight_backend="scipy")
    got = thy.hypergraph_walks(n, edges, device="cpu", **kw)
    ref = jhy.hypergraph_walks(n, edges, **kw)
    np.testing.assert_array_equal(got, ref)
    # the device backend (on the CPU here) gives the same walks
    dev = thy.hypergraph_walks(n, edges, device="cpu",
                               **{**kw, "weight_backend": "device"})
    np.testing.assert_array_equal(dev, got)


def test_walk_timings_are_recorded():
    timings = {}
    thy.hypergraph_walks(N, HYPEREDGES, num_walks=2, walk_length=4,
                         timings=timings, device="cpu")
    assert set(timings) == {"incidence_s", "cooccurrence_s", "first_order_s",
                            "second_order_s", "w_nnz", "simulate_s"}
    assert timings["w_nnz"] > 0


def test_device_cooccurrence_matches_scipy_and_jax():
    for n, edges in [(N, HYPEREDGES), (40, _random_edges(9, 40, 120))]:
        got = thy.cooccurrence_csr(n, edges, backend="device",
                                   device="cpu").toarray()
        sp = thy.cooccurrence_csr(n, edges, backend="scipy").toarray()
        ref = jhy.cooccurrence_csr(n, edges, backend="device").toarray()
        np.testing.assert_allclose(got, sp, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------- incidence ops
@pytest.fixture(scope="module")
def incidence():
    """Ragged 1-based edges of 2-7 members padded to k_max = 9 (two pad
    columns beyond the largest edge), node features with a zero row 0."""
    rng = np.random.default_rng(4)
    n, d = 50, 8
    edges = [np.sort(rng.choice(np.arange(1, n + 1), rng.integers(2, 8),
                                replace=False)) for _ in range(90)]
    feats = rng.standard_normal((n + 1, d)).astype(np.float32)
    feats[0] = 0.0
    w = rng.random(len(edges)).astype(np.float32)
    y = rng.standard_normal((len(edges), d)).astype(np.float32)
    return dict(n=n, edges=edges, feats=feats, w=w, y=y,
                t=ti.PaddedIncidence.from_ragged(edges, k_max=9,
                                                 device="cpu"),
                j=ji.PaddedIncidence.from_ragged(edges, k_max=9))


def test_padded_incidence_layouts(incidence):
    edges = incidence["edges"]
    flat = np.concatenate(edges).astype(np.int32)
    offsets = np.zeros(len(edges) + 1, np.int64)
    np.cumsum([len(e) for e in edges], out=offsets[1:])
    got = ti.PaddedIncidence.from_csr(flat, offsets, k_max=9, device="cpu")
    np.testing.assert_array_equal(got.members.numpy(),
                                  np.asarray(incidence["j"].members))
    np.testing.assert_array_equal(incidence["t"].members.numpy(),
                                  np.asarray(incidence["j"].members))
    np.testing.assert_array_equal(incidence["t"].mask.numpy(),
                                  np.asarray(incidence["j"].mask))
    assert incidence["t"].members.dtype == torch.int32


def test_incidence_ops_match_jax(incidence):
    c = incidence
    feats_t, feats_j = torch.from_numpy(c["feats"]), jnp.asarray(c["feats"])
    w_t, w_j = torch.from_numpy(c["w"]), jnp.asarray(c["w"])
    y_t, y_j = torch.from_numpy(c["y"]), jnp.asarray(c["y"])
    pairs = [
        (ti.edge_gather_sum(c["t"], feats_t, w_t),
         ji.edge_gather_sum(c["j"], feats_j, w_j)),
        (ti.edge_gather_sum(c["t"], feats_t),
         ji.edge_gather_sum(c["j"], feats_j)),
        (ti.node_scatter_add(c["t"], y_t, c["n"]),
         ji.node_scatter_add(c["j"], y_j, c["n"])),
        (ti.pair_cooccurrence(c["t"], w_t, c["n"]),
         ji.pair_cooccurrence(c["j"], w_j, c["n"])),
        (ti.edge_sddmm(c["t"], feats_t), ji.edge_sddmm(c["j"], feats_j)),
    ]
    for got, ref in pairs:
        ref = np.asarray(ref)
        assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())
    cooc = pairs[3][0].numpy()
    assert (cooc[0] == 0).all() and (cooc[:, 0] == 0).all()
    assert (np.diag(cooc) == 0).all() and (cooc == cooc.T).all()


# -------------------------------------------------------------- skip-gram
def test_walks_to_pairs_and_unigram_table_are_jax_bit_for_bit():
    walks = np.random.default_rng(0).integers(0, 25, (40, 15))
    for window in (1, 3, 20):
        got = tsg.walks_to_pairs(walks, window, np.random.default_rng(6))
        ref = jsg.walks_to_pairs(walks, window, np.random.default_rng(6))
        np.testing.assert_array_equal(got, ref)
    for vocab in (25, 30):
        np.testing.assert_array_equal(tsg.unigram_table(walks, vocab),
                                      jsg.unigram_table(walks, vocab))
    # no walk visits: the uniform table
    np.testing.assert_array_equal(
        tsg.unigram_table(np.zeros((0, 3), np.int64), 4),
        jsg.unigram_table(np.zeros((0, 3), np.int64), 4))


def test_sgns_epoch_matches_jax_with_its_uniforms():
    """Three minibatches of 64 pairs, V = 50, d = 16, 5 negatives, from
    tables of the JAX init; the uniforms are the JAX step's own draws."""
    rng = np.random.default_rng(3)
    V, d, m, neg, lr, B = 50, 16, 64, 5, 0.1, 3
    walks = rng.integers(0, V, (60, 12))
    pairs_b = tsg.walks_to_pairs(walks, 4, rng)[:B * m].reshape(B, m, 2)
    emb_in = ((rng.random((V, d)) - 0.5) / d).astype(np.float32)
    emb_out = (rng.standard_normal((V, d)) * 0.05).astype(np.float32)
    cdf = np.cumsum(tsg.unigram_table(walks, V))
    key = jax.random.PRNGKey(11)
    ref_in, ref_out, ref_ls = jsg._sgns_epoch(
        jnp.asarray(emb_in), jnp.asarray(emb_out),
        jnp.asarray(pairs_b.astype(np.int32)), jnp.asarray(cdf), key,
        neg_num=neg, lr=lr)
    us, k = [], key
    for _ in range(B):
        k, kn = jax.random.split(k)
        us.append(np.asarray(jax.random.uniform(kn, (m, neg))))
    t_in, t_out = torch.from_numpy(emb_in.copy()), torch.from_numpy(
        emb_out.copy())
    pairs = torch.from_numpy(pairs_b.astype(np.int32)).transpose(
        1, 2).contiguous()
    losses = tsg.sgns_epoch(t_in, t_out, pairs, torch.from_numpy(cdf), None,
                            neg_num=neg, lr=lr,
                            uniforms=torch.from_numpy(np.stack(us)))
    scale = max(np.abs(np.asarray(ref_in)).max(),
                np.abs(np.asarray(ref_out)).max())
    np.testing.assert_allclose(t_in.numpy(), np.asarray(ref_in), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(ref_out), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_ls),
                               rtol=1e-5, atol=0)
    assert not np.allclose(t_in.numpy(), emb_in)       # the step moved


def test_negatives_are_the_compare_count():
    """searchsorted(cdf, u) (side left) is #{j : cdf[j] < u}, clamped to
    V - 1, including u beyond the cdf's last value."""
    rng = np.random.default_rng(2)
    cdf = np.cumsum(tsg.unigram_table(rng.integers(0, 30, (20, 10)), 33))
    u = rng.random((400, 5)).astype(np.float32)
    u[0, 0] = 1.0
    u[1, 1] = cdf[4]                         # a tie goes to its own index
    got = torch.searchsorted(torch.from_numpy(cdf), torch.from_numpy(u),
                             out_int32=True).clamp_(max=32).numpy()
    ref = np.minimum((u[..., None] > cdf).sum(-1), 32)
    np.testing.assert_array_equal(got, ref)


def test_host_corpus_epoch_equals_the_device_epoch():
    """``sgns_epoch_chunked`` over a host (B, m, 2) corpus is ``sgns_epoch``
    over the same pairs laid out (B, 2, m), with the same generator: the
    same tables and losses bit for bit."""
    rng = np.random.default_rng(5)
    V, d, m = 20, 8, 32
    walks = rng.integers(0, V, (30, 10))
    pairs_b = tsg.walks_to_pairs(walks, 3, rng)[:5 * m].reshape(5, m, 2)
    cdf = torch.from_numpy(np.cumsum(tsg.unigram_table(walks, V)))
    init = torch.from_numpy(((rng.random((V, d)) - 0.5) / d).astype(
        np.float32))
    a, b = init.clone(), torch.zeros((V, d))
    got = tsg.sgns_epoch_chunked(a, b, pairs_b, cdf,
                                 torch.Generator().manual_seed(3), lr=0.1)
    c, e = init.clone(), torch.zeros((V, d))
    pairs = torch.from_numpy(pairs_b.astype(np.int32)).transpose(
        1, 2).contiguous()
    ls = tsg.sgns_epoch(c, e, pairs, cdf, torch.Generator().manual_seed(3),
                        lr=0.1)
    for x, y in zip(got, (c, e, ls)):
        assert torch.equal(x, y)
    assert ls.shape == (5,)
    assert not torch.equal(c, init)


def test_skipgram_learns_community_structure():
    rng = np.random.default_rng(0)
    vocab = 20
    comm = np.arange(vocab) // 10
    walks = []
    for _ in range(400):
        members = np.flatnonzero(comm == rng.integers(0, 2))
        walks.append(rng.choice(members, 20))
    walks = np.asarray(walks)
    timings = {}
    emb, losses = tsg.train_skipgram(walks, vocab, 16, window=3, epochs=6,
                                     batch=512, seed=0, device="cpu",
                                     timings=timings)
    assert emb.shape == (vocab, 16) and emb.dtype == np.float32
    assert losses[-1] < losses[0]
    emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    sims = emb @ emb.T
    same = sims[comm[:, None] == comm[None, :]].mean()
    diff = sims[comm[:, None] != comm[None, :]].mean()
    assert same > diff + 0.2, (same, diff)
    assert timings["pairs"] > 0 and timings["minibatches"] >= 6


def test_skipgram_init_is_jax_bit_for_bit():
    """epochs=0 returns the initial input table: the JAX package's draw."""
    walks = np.random.default_rng(1).integers(0, 12, (10, 6))
    got, ls = tsg.train_skipgram(walks, 12, 8, epochs=0, seed=4,
                                 device="cpu")
    ref, _ = jsg.train_skipgram(walks, 12, 8, epochs=0, seed=4)
    np.testing.assert_array_equal(got, ref)
    assert ls.shape == (0,)


def test_skipgram_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsg.train_skipgram(np.zeros((2, 3), np.int64), 3, 4)
