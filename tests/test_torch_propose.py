"""The port's phase-1 proposals (K5's plain version) and the sampler's
propose_impl="pallas" branch against the JAX package.

The port takes the sampler's row-major arrays, (n, k) and (T, n, k); JAX's
kernel takes them feature-major, so the inputs go to JAX transposed and its
outputs come back transposed.  The plain version is held bit for bit
against JAX's propose_phase1 (its Pallas kernel in interpret mode) and
propose_phase1_ref on the same inputs: both are pure functions of the
uniforms.  The sampler's two branches draw the same uniforms and give the
same negatives; they are held to the invariants of tests/test_propose.py
too.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from matcha_tpu.genome import GenomeBins
from matcha_tpu.ops.propose import propose_phase1, propose_phase1_ref
from matcha_tpu_torch.ops import propose as tp
from matcha_tpu_torch.sampler import bloom as tb
from matcha_tpu_torch.sampler import negative as tn


def _inputs(rng, k, n, n_nodes=96, T=8):
    """orig (n, k) int32, change (n, k) bool, lo/hi (n, k) f32, u (T, n, k)
    f32, the top uniform of a few rows on the f32-rounding guard."""
    orig = np.sort(rng.integers(1, n_nodes, size=(n, k)), axis=1)
    change = rng.random((n, k)) < 0.5
    change[np.arange(n), rng.integers(0, k, n)] = True   # >= 1 corrupted
    lo = rng.integers(1, 20, size=(n, k)).astype(np.float32)
    hi = lo + rng.integers(1, n_nodes, size=(n, k)).astype(np.float32)
    u = rng.random((T, n, k), dtype=np.float32)
    u[0, :3, :] = np.nextafter(np.float32(1), np.float32(0))  # the hi guard
    return [orig.astype(np.int32), change, lo, hi, u]


def _feature_major(args):
    orig, change, lo, hi, u = args
    return [jnp.asarray(a) for a in (orig.T, change.T.astype(np.int32), lo.T,
                                     hi.T, u.transpose(0, 2, 1))]


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("n", [128, 2048])
def test_plain_matches_jax_bit_for_bit(rng, k, n):
    args = _inputs(rng, k, n)
    for md, S in [(0, 2), (1, 4), (2, 8)]:
        probe, has = tp.propose_phase1(*map(torch.from_numpy, args),
                                       min_distance=md, max_probes=S)
        assert probe.shape == (S, n, k) and has.shape == (S, n)
        probe = probe.numpy().transpose(0, 2, 1)                 # (S, k, n)
        ref_p, ref_h = propose_phase1_ref(*_feature_major(args),
                                          min_distance=md, max_probes=S)
        np.testing.assert_array_equal(probe, np.asarray(ref_p))
        np.testing.assert_array_equal(has.numpy(), np.asarray(ref_h))
        if S == 2:
            ker_p, ker_h = propose_phase1(*_feature_major(args),
                                          min_distance=md, max_probes=S,
                                          interpret=True)
            np.testing.assert_array_equal(probe, np.asarray(ker_p))
            np.testing.assert_array_equal(has.numpy(), np.asarray(ker_h))


def test_plain_takes_a_ragged_row_count(rng):
    """No block-width gate: any n, the same rows as a 128-multiple run."""
    args = _inputs(rng, 3, 200)
    full = tp.propose_phase1(*map(torch.from_numpy, args), min_distance=0,
                             max_probes=3)
    part = tp.propose_phase1(*[torch.from_numpy(a[..., :77, :].copy())
                               for a in args], min_distance=0, max_probes=3)
    assert torch.equal(part[0], full[0][:, :77])
    assert torch.equal(part[1], full[1][:, :77])


@pytest.fixture(scope="module")
def table():
    genome = GenomeBins(["chr1", "chr2"], [60_000_000, 40_000_000],
                        1_000_000)
    return genome, tn.ChromTable.from_genome(genome, device="cpu")


@pytest.mark.parametrize("md", [0, 2])
def test_sampler_pallas_constraints(table, rng, md):
    """Negatives sorted, gap-respecting, on the positives' chromosomes, not
    in the filter unless counted as a fallback; any row count (n = 102)."""
    genome, ct = table
    pos = np.sort(rng.integers(1, genome.num_nodes // 2, size=(400, 3)),
                  axis=1)
    pos = pos[np.all(np.diff(pos, axis=1) > md, axis=1)][:34]
    bloom = tb.build_bloom(pos, device="cpu")
    neg, st = tn.sample_negatives_with_stats(
        torch.Generator().manual_seed(7), torch.from_numpy(pos), ct, md,
        bloom, neg_num=3, propose_impl="pallas")
    neg = neg.numpy()
    assert neg.shape == (102, 3) and int(st["rows"]) == 102
    assert (np.diff(neg, axis=1) > md).all()
    np.testing.assert_array_equal(genome.node2chrom[neg],
                                  genome.node2chrom[np.tile(pos, (3, 1))])
    assert int(st["orig_fallback"]) == 0
    hits = int(bloom.contains(torch.from_numpy(neg)).sum())
    assert hits <= int(st["bloom_fallback"])


def test_sampler_pallas_matches_xla_distribution(table, rng):
    """The two branches share the change-mask draw; their corruption rates
    and the spread of the resampled ids agree within the noise of 2,048
    rows."""
    genome, ct = table
    pos = np.sort(rng.integers(1, genome.num_nodes, size=(2000, 2)), axis=1)
    pos = pos[np.diff(pos, axis=1)[:, 0] > 0][:1024]
    bloom = tb.build_bloom(pos, device="cpu")
    stats = {}
    for impl in ("xla", "pallas"):
        neg = tn.sample_negatives(torch.Generator().manual_seed(3),
                                  torch.from_numpy(pos), ct, 0, bloom,
                                  neg_num=2, propose_impl=impl).numpy()
        changed = neg != np.tile(pos, (2, 1))
        stats[impl] = (changed.mean(), neg[changed].mean() / genome.num_nodes)
    assert abs(stats["xla"][0] - stats["pallas"][0]) < 0.04, stats
    assert abs(stats["xla"][1] - stats["pallas"][1]) < 0.04, stats


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("hard_ratio", [1.0, 0.6])
@pytest.mark.parametrize("md", [0, 2])
def test_sampler_pallas_equals_xla(table, rng, k, hard_ratio, md):
    """One generator, both phase-1 routes: the same uniforms, so the same
    negatives and the same fallback counts, bit for bit (a small filter
    over the positives plus random rows makes some probes hit)."""
    genome, ct = table
    pos = np.sort(rng.integers(1, genome.num_nodes + 1, size=(600, k)),
                  axis=1)
    pos = pos[np.all(np.diff(pos, axis=1) > md, axis=1)][:150]
    extra = np.sort(rng.integers(1, genome.num_nodes + 1, size=(3000, k)),
                    axis=1)
    bloom = tb.build_bloom(np.concatenate([pos, extra]), device="cpu")
    out = {}
    for impl in ("xla", "pallas"):
        neg, st = tn.sample_negatives_with_stats(
            torch.Generator().manual_seed(11), torch.from_numpy(pos), ct, md,
            bloom, neg_num=3, max_probes=2, hard_ratio=hard_ratio,
            propose_impl=impl)
        out[impl] = (neg, {name: int(v) for name, v in st.items()})
    assert torch.equal(out["xla"][0], out["pallas"][0])
    assert out["xla"][1] == out["pallas"][1]
    assert out["xla"][1]["rows"] == 3 * len(pos)
