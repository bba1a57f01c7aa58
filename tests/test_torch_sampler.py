"""The port's Bloom filter and negative sampler against the JAX package.

Hashes, bitsets and membership are held bit for bit against the JAX
package's numpy and jnp paths; phase 1 of the sampler, given the same
uniforms, exactly against ops/propose.py:propose_phase1_ref.  The rest of
the sampler draws from another random stream than jax.random, so it is held
to the invariant and distribution tests of tests/test_sampler.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from matcha_tpu.genome import GenomeBins
from matcha_tpu.ops.propose import propose_phase1_ref
from matcha_tpu.sampler import bloom as jb
from matcha_tpu_torch.sampler import bloom as tb
from matcha_tpu_torch.sampler import negative as tn


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ----------------------------------------------------------------- bloom
@pytest.mark.parametrize("axis", [-1, -2])
def test_hash_rows_bit_for_bit(rng, axis):
    rows = rng.integers(1, 2 ** 31 - 1, size=(100, 4)).astype(np.int32)
    if axis == -2:
        rows = np.ascontiguousarray(rows.T)
    with np.errstate(over="ignore"):
        h1n, h2n = jb._hash_rows(rows, np, axis=axis)
    h1j, h2j = jb._hash_rows(jnp.asarray(rows), jnp, axis=axis)
    h1t, h2t = tb._hash_rows(torch.from_numpy(rows), axis=axis)
    for t, n_, j in ((h1t, h1n, h1j), (h2t, h2n, h2j)):
        np.testing.assert_array_equal(t.numpy().astype(np.uint32), n_)
        np.testing.assert_array_equal(t.numpy().astype(np.uint32),
                                      np.asarray(j))


@pytest.mark.parametrize("error_rate", [1e-3, 1e-4])
def test_build_bloom_bits_match_jax(rng, error_rate):
    """error_rate 1e-3: the blocked layout; 1e-4: the classic layout."""
    rows = np.sort(rng.integers(1, 10_000, (3000, 3)), 1).astype(np.int32)
    jf = jb.build_bloom(rows, error_rate=error_rate)
    tf = tb.build_bloom(rows, error_rate=error_rate, device="cpu")
    assert (tf.m_bits, tf.n_hashes, tf.blocked) == (jf.m_bits, jf.n_hashes,
                                                    jf.blocked)
    assert tf.blocked == (error_rate == 1e-3)
    np.testing.assert_array_equal(tf.bits.numpy().view(np.uint32),
                                  np.asarray(jf.bits))


@pytest.mark.parametrize("error_rate", [1e-3, 1e-4])
def test_contains_matches_jax(rng, error_rate):
    rows = np.sort(rng.integers(1, 2_000, (2000, 3)), 1).astype(np.int32)
    probes = np.sort(rng.integers(1, 2_000, (5000, 3)), 1).astype(np.int32)
    probes[:1000] = rows[:1000]
    jf = jb.build_bloom(rows, error_rate=error_rate)
    tf = tb.build_bloom(rows, error_rate=error_rate, device="cpu")
    got = tf.contains(torch.from_numpy(probes)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jf.contains(
        jnp.asarray(probes))))
    assert got[:1000].all()                     # no false negatives


def test_bloom_empty_and_dict(rng):
    f = tb.build_bloom(np.zeros((0, 2), np.int32), device="cpu")
    assert not f.contains(torch.tensor([[1, 2], [3, 4]])).any()
    unl = {2: np.sort(rng.integers(1, 1000, (500, 2)), 1).astype(np.int32),
           3: np.sort(rng.integers(1, 1000, (300, 3)), 1).astype(np.int32)}
    tfs = tb.build_bloom_dict(unl, device="cpu")
    jfs = jb.build_bloom_dict(unl)
    assert set(tfs) == {2, 3}
    for k in unl:
        np.testing.assert_array_equal(tfs[k].bits.numpy().view(np.uint32),
                                      np.asarray(jfs[k].bits))
        assert tfs[k].contains(torch.from_numpy(unl[k])).all()


# ------------------------------------------------------------- negatives
@pytest.fixture(scope="module")
def table():
    g = GenomeBins(["chr1", "chr2", "chr3"],
                   [49_500_000, 30_200_000, 19_999_999], 1_000_000)
    return g, tn.ChromTable.from_genome(g, device="cpu")


def _random_positives(g, rng, b, k, min_dis=0):
    out = []
    while len(out) < b:
        nodes = np.sort(rng.integers(1, g.node_num, size=k))
        if (np.diff(nodes) > min_dis).all():
            out.append(nodes)
    return np.asarray(out, dtype=np.int32)


@pytest.mark.parametrize("k,S,min_dis", [(3, 2, 0), (5, 2, 1), (2, 4, 0)])
def test_phase1_matches_propose_ref_exactly(table, rng, k, S, min_dis):
    g, tab = table
    pos = torch.from_numpy(_random_positives(g, rng, 40, k, min_dis))
    orig = pos.repeat(3, 1)
    n, T = orig.shape[0], 8
    change = tn._sample_change_mask(_gen(1), n, k, "cpu")
    lo, hi = tn._chrom_range(orig, tab, None)
    u = rng.random((T, n, k)).astype(np.float32)
    probe, has = tn._phase1_xla(orig, change, lo, hi, torch.from_numpy(u),
                                min_dis, S)
    ref_p, ref_h = propose_phase1_ref(
        jnp.asarray(orig.numpy().T), jnp.asarray(change.numpy().T),
        jnp.asarray(lo.numpy().T), jnp.asarray(hi.numpy().T),
        jnp.asarray(u.transpose(0, 2, 1)), min_distance=min_dis,
        max_probes=S)
    np.testing.assert_array_equal(probe.numpy().transpose(0, 2, 1),
                                  np.asarray(ref_p))
    np.testing.assert_array_equal(has.numpy(), np.asarray(ref_h))


def test_stage1_negatives_are_copies(table, rng):
    g, tab = table
    pos = _random_positives(g, rng, 8, 3)
    neg, st = tn.sample_negatives_with_stats(None, torch.from_numpy(pos),
                                             tab, 0, None, neg_num=3)
    np.testing.assert_array_equal(neg.numpy(), np.tile(pos, (3, 1)))
    assert int(st["rows"]) == 24 and int(st["orig_fallback"]) == 0


@pytest.mark.parametrize("k,min_dis", [(2, 0), (3, 2), (5, 1)])
def test_negative_constraints(table, rng, k, min_dis):
    g, tab = table
    pos = _random_positives(g, rng, 64, k, min_dis)
    bloom = tb.build_bloom(pos, device="cpu")
    neg = tn.sample_negatives(_gen(1), torch.from_numpy(pos), tab, min_dis,
                              bloom, neg_num=3).numpy()
    assert neg.shape == (64 * 3, k)
    assert (np.diff(neg, axis=1) > min_dis).all()
    assert (neg >= 1).all() and (neg < g.node_num).all()
    pos_set = set(map(tuple, pos.tolist()))
    assert sum(tuple(r) in pos_set for r in neg.tolist()) == 0


def test_negative_chromosome_preserved(table, rng):
    g, tab = table
    pos = _random_positives(g, rng, 128, 3)
    bloom = tb.build_bloom(pos, device="cpu")
    neg = tn.sample_negatives(_gen(2), torch.from_numpy(pos), tab, 0, bloom,
                              neg_num=1).numpy()
    np.testing.assert_array_equal(np.sort(g.node2chrom[pos], axis=1),
                                  np.sort(g.node2chrom[neg], axis=1))


def test_negatives_actually_corrupt(table, rng):
    g, tab = table
    pos = _random_positives(g, rng, 256, 3)
    bloom = tb.build_bloom(pos, device="cpu")
    neg = tn.sample_negatives(_gen(3), torch.from_numpy(pos), tab, 0, bloom,
                              neg_num=1).numpy()
    assert (neg != pos).any(axis=1).all()
    # truncated Binomial(3, 1/2): mean 1.714 changed positions
    assert 1.2 < (neg != pos).sum(axis=1).mean() < 2.3


def test_change_mask_distribution():
    k = 4
    m = tn._sample_change_mask(_gen(0), 20_000, k, "cpu").numpy()
    counts = m.sum(axis=1)
    assert counts.min() >= 1
    freq = np.bincount(counts, minlength=k + 1)[1:] / len(counts)
    np.testing.assert_allclose(freq, [4 / 15, 6 / 15, 4 / 15, 1 / 15],
                               atol=0.02)
    col = m.mean(axis=0)
    np.testing.assert_allclose(col, col.mean(), atol=0.02)


def test_fallback_telemetry_dense_bloom(rng):
    """A 50%-dense unlabeled set of chromosome-constrained pairs: with T = 3
    and no re-trial the Bloom-hit fallback is measurable; with the defaults
    (T = 8 + re-trial) it is driven to ~0, and the counters see both."""
    g = GenomeBins(["chr1"], [248_000_000], 1_000_000)
    tab = tn.ChromTable.from_genome(g, device="cpu")
    n = g.num_nodes
    ii, jj = np.triu_indices(n, k=1)
    pairs = np.stack([ii + 1, jj + 1], axis=1).astype(np.int32)
    unlabeled = pairs[rng.random(len(pairs)) < 0.5]
    bloom = tb.build_bloom(unlabeled, device="cpu")
    pos = torch.from_numpy(unlabeled[rng.permutation(len(unlabeled))[:2048]])
    _, st_old = tn.sample_negatives_with_stats(_gen(0), pos, tab, 0, bloom,
                                               neg_num=3, max_trials=3,
                                               extra_rounds=0)
    assert int(st_old["bloom_fallback"]) / int(st_old["rows"]) > 1e-3
    neg, st = tn.sample_negatives_with_stats(_gen(0), pos, tab, 0, bloom,
                                             neg_num=3)
    assert int(st["bloom_fallback"]) / int(st["rows"]) <= 1e-4
    assert int(st["orig_fallback"]) == 0
    member = set(map(tuple, unlabeled.tolist()))
    dup = sum(tuple(r) in member for r in neg.numpy().tolist())
    assert dup <= int(st["bloom_fallback"])


def test_chrom_bounds_path_matches_gather_path(table, rng):
    g, tab = table
    pos = torch.from_numpy(_random_positives(g, rng, 64, 3))
    bloom = tb.build_bloom_dict({3: pos.numpy()}, device="cpu")[3]
    bounds = tuple((int(s), int(e)) for s, e in g.chrom_range)
    a = tn.sample_negatives(_gen(7), pos, tab, 0, bloom)
    b = tn.sample_negatives(_gen(7), pos, tab, 0, bloom, chrom_bounds=bounds)
    assert torch.equal(a, b)


def test_negatives_stay_in_table(table):
    g, tab = table
    rng = np.random.default_rng(5)
    pos = torch.from_numpy(_random_positives(g, rng, 256, 2))
    bloom = tb.build_bloom_dict({2: pos.numpy()}, device="cpu")[2]
    for seed in range(4):
        neg = tn.sample_negatives(_gen(seed), pos, tab, 0, bloom,
                                  neg_num=3, hard_ratio=0.5)
        assert int(neg.max()) < g.node_num and int(neg.min()) >= 1


def test_range_draw_never_reaches_hi():
    u_max = np.nextafter(np.float32(1.0), np.float32(0.0))
    for span in [2, 3, 5, 4096, 4097, 30011, 1 << 20]:
        lo = torch.tensor([10.0])
        got = tn._draw(lo, lo + span, torch.tensor([u_max]))
        assert int(got) < 10 + span


def test_propose_pallas_takes_k5_up_to_k6_and_unknown_impl_raises(table,
                                                                   rng):
    """propose_impl="pallas" takes K5's phase 1 for k <= 6 (any row count)
    and gives sorted negatives; an unknown propose_impl raises.  Beyond k = 6
    see test_propose_pallas_beyond_k6_warns_and_takes_xla."""
    g, tab = table
    pos = torch.from_numpy(_random_positives(g, rng, 8, 3))
    bloom = tb.build_bloom(pos.numpy(), device="cpu")
    neg = tn.sample_negatives(_gen(0), pos, tab, 0, bloom,
                              propose_impl="pallas")
    assert neg.shape == (24, 3) and (np.diff(neg.numpy(), axis=1) > 0).all()
    with pytest.raises(ValueError, match="propose_impl"):
        tn.sample_negatives(_gen(0), pos, tab, 0, bloom, propose_impl="x")


@pytest.mark.parametrize("k", [7, 9])
def test_propose_pallas_beyond_k6_warns_and_takes_xla(table, rng, k):
    """k > 6 with propose_impl="pallas" warns with the JAX package's words
    and gives exactly the "xla" branch's negatives for the same generator:
    valid (sorted, gaps above min_distance, on the positive's chromosomes,
    inside the table) and none of them a positive."""
    g, tab = table
    pos = _random_positives(g, rng, 32, k, 1)
    bloom = tb.build_bloom(pos, device="cpu")
    with pytest.warns(UserWarning, match="fell back to XLA"):
        neg = tn.sample_negatives(_gen(3), torch.from_numpy(pos), tab, 1,
                                  bloom, propose_impl="pallas")
    ref = tn.sample_negatives(_gen(3), torch.from_numpy(pos), tab, 1, bloom,
                              propose_impl="xla")
    assert torch.equal(neg, ref)
    neg = neg.numpy()
    assert neg.shape == (32 * 3, k) and (np.diff(neg, axis=1) > 1).all()
    assert (neg >= 1).all() and (neg < g.node_num).all()
    np.testing.assert_array_equal(np.sort(g.node2chrom[np.tile(pos, (3, 1))],
                                          axis=1),
                                  np.sort(g.node2chrom[neg], axis=1))
    pos_set = set(map(tuple, pos.tolist()))
    assert not any(tuple(r) in pos_set for r in neg.tolist())


def test_assemble_batch(table, rng):
    g, _ = table
    pos = torch.from_numpy(_random_positives(g, rng, 4, 2))
    w = torch.tensor([2.0, 3.0, 4.0, 5.0])
    x, y, ww = tn.assemble_batch(pos, w, pos.repeat(3, 1))
    assert x.shape == (16, 2) and y.shape == (16, 1) and ww.shape == (16, 1)
    assert y.reshape(-1).tolist() == [1] * 4 + [0] * 12
    assert ww.reshape(-1).tolist() == [2, 3, 4, 5] + [1] * 12
