"""The port's merged-bucket forward, recon loss and train mode against the
JAX package, in f32.

Parameters are drawn by JAX and carried across with params_from_numpy; the
frozen tables are built by each package from the same numpy contacts.
Tolerances: logits rtol 1e-5, atol 1e-6 (as tests/test_forward_buckets.py
holds the JAX merged forward to its per-bucket one); recon 1e-4 relative;
gradients rtol 1e-4, atol 1e-5.  Dropout draws differ between the two
frameworks' random streams, so train mode is checked by its statistics and
by replaying the port's own draws.
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
from matcha_tpu_torch.models import modules as tm
from matcha_tpu_torch.train.runtime import _leaves


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(2)
    genome = GenomeBins(["chr1", "chr2"], [24_000_000, 15_000_000], 1_000_000)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    intra = intra + intra.T
    inter = rng.random((n, n)).astype(np.float32)
    kw = dict(dim=16, n_head=4, num_chroms=2, num_nodes=n)
    chrom_sizes = [int(e - s) for s, e in genome.chrom_range]
    jp = jh.init_model(jax.random.PRNGKey(0), jh.ModelDims(**kw), chrom_sizes)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jf = jh.build_frozen_tables(genome, intra, inter)
    tf = th.build_frozen_tables(genome, intra, inter, device="cpu")
    xs = {}
    for k in (2, 3, 5):
        xs[k] = np.stack([np.sort(rng.choice(np.arange(1, n + 1), k,
                                             replace=False))
                          for _ in range(11)]).astype(np.int32)
    return (jp, jf, jh.ModelDims(**kw)), (tp, tf, th.ModelDims(**kw)), xs


def _jxs(xs):
    return {k: jnp.asarray(v) for k, v in xs.items()}


def _txs(xs):
    return {k: torch.from_numpy(v) for k, v in xs.items()}


def _pad_inter_z(jf, tf):
    """inter_z with f_max zero columns, as both Trainers pad it."""
    f_max = max(int(f.shape[1]) for f in jf.features)
    return (jf._replace(inter_z=jnp.pad(jf.inter_z, ((0, 0), (0, f_max)))),
            tf._replace(inter_z=torch.nn.functional.pad(tf.inter_z,
                                                        (0, f_max))))


@pytest.mark.parametrize("mode", ["per-k", "pad-max"])
def test_logits_match_jax(setup, mode):
    (jp, jf, jd), (tp, tf, td), xs = setup
    ref = jh.forward_buckets(jp, jf, jd, _jxs(xs), attention_mode=mode)
    got = th.forward_buckets(tp, tf, td, _txs(xs), attention_mode=mode)
    assert sorted(got) == sorted(ref)
    for k in xs:
        assert got[k].shape == (11, 1) and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=f"k={k}")


@pytest.mark.parametrize("padded_inter_z", [False, True])
def test_recon_loss_node_matches_jax_for_every_r(setup, padded_inter_z):
    """Both target branches: the clipped column gather (raw inter_z) and
    the contiguous slice (inter_z with the Trainer's pad columns)."""
    (jp, jf, jd), (tp, tf, td), _ = setup
    if padded_inter_z:
        jf, tf = _pad_inter_z(jf, tf)
    rng = np.random.default_rng(9)
    flat = rng.integers(0, td.num_nodes + 1, size=300).astype(np.int32)
    jt = jh.encode_node_table(jp, jf, jd)
    tt = th.encode_node_table(tp, tf, td)
    for r in range(td.num_chroms):
        ref = float(jh.recon_loss_node(jp, jf, jd, jnp.asarray(flat), jt, r))
        got = float(th.recon_loss_node(tp, tf, td, torch.from_numpy(flat),
                                       tt, r))
        assert abs(got - ref) <= 1e-4 * max(1.0, abs(ref)), (r, got, ref)


def test_recon_node_matches_token_oracle(setup):
    """The per-node recon equals the per-token oracle of both packages for
    every chromosome, with repeated ids and pad tokens."""
    (jp, jf, jd), (tp, tf, td), _ = setup
    rng = np.random.default_rng(4)
    flat = rng.integers(0, td.num_nodes + 1, size=300).astype(np.int32)
    tt = th.encode_node_table(tp, tf, td)
    jt = jh.encode_node_table(jp, jf, jd)
    tflat = torch.from_numpy(flat)
    for r in range(td.num_chroms):
        node = float(th.recon_loss_node(tp, tf, td, tflat, tt, r))
        tok = float(th.recon_loss_with_chrom(tp, tf, td, tflat,
                                             tt[tflat.long()], r))
        ref = float(jh.recon_loss_with_chrom(jp, jf, jd, jnp.asarray(flat),
                                             jt[jnp.asarray(flat)], r))
        assert abs(tok - ref) <= 1e-4 * max(1.0, abs(ref)), (r, tok, ref)
        assert abs(node - tok) <= 1e-4 * max(1.0, abs(tok)), (r, node, tok)


@pytest.mark.parametrize("mode", ["per-k", "pad-max"])
def test_grads_match_jax(setup, mode):
    """Gradients of sum(logits^2) + recon (r = 1) reach every parameter as
    jax.grad gives them (the gather's gradient is table_gather's)."""
    (jp, jf, jd), (tp, tf, td), xs = setup

    def jloss(p):
        out = jh.forward_buckets(p, jf, jd, _jxs(xs), attention_mode=mode)
        flat = jnp.concatenate([jnp.asarray(xs[k]).reshape(-1)
                                for k in sorted(xs)])
        rec = jh.recon_loss_node(p, jf, jd, flat,
                                 jh.encode_node_table(p, jf, jd), 1)
        return sum(jnp.sum(v ** 2) for v in out.values()) + rec

    ref = jax.jit(jax.grad(jloss))(jp)
    tp = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    out, rec = th.forward_buckets(tp, tf, td, _txs(xs), attention_mode=mode,
                                  return_recon=True, recon_chrom=1)
    (sum((v ** 2).sum() for v in out.values()) + rec).backward()
    # a leaf autograd never reached (the decoder of chromosome 0) is zero
    got = jax.tree_util.tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, tp)
    assert len(jax.tree_util.tree_leaves(got)) == len(
        jax.tree_util.tree_leaves(ref))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_feature_dropout_mask_and_statistics(setup):
    """Train-mode encode draws one keep mask at the pad-independent shape
    (C, W, W) with keep rate 1 - feature_dropout, and scales kept entries by
    1 / (1 - rate): replaying the port's draw reproduces its table."""
    (_, _, _), (tp, tf, td), _ = setup
    gen = torch.Generator().manual_seed(11)
    replay = torch.Generator().set_state(gen.get_state())
    got = th.encode_node_table(tp, tf, td, generator=gen, train=True)
    feats = tf.features
    W = max(f.shape[1] for f in feats)
    rate = td.feature_dropout
    keep = tm.rand(replay, (len(feats), W, W), "cpu") < 1.0 - rate
    assert abs(float(keep.float().mean()) - (1 - rate)) < 0.03
    rows = []
    for c, f in enumerate(feats):
        w = f.shape[1]
        x = torch.where(keep[c, :w, :w], f / (1 - rate), torch.zeros(()))
        ae = tp["embed"]["ae"][c]
        rows.append(torch.tanh(x @ ae["w1"]) @ ae["w2"])
    ref = torch.cat([torch.zeros((1, td.dim))] + rows)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    eval_table = th.encode_node_table(tp, tf, td)
    assert not torch.allclose(got, eval_table)


@pytest.mark.parametrize("rate", [0.3, 0.4])
def test_dropout_keep_rate_and_scale(rate):
    """The attention output's (0.3) and pff_n1's (0.4) inverted dropout:
    keep rate 1 - rate, kept values scaled by exactly 1 / (1 - rate)."""
    x = torch.ones((200, 64))
    out = tm.dropout(x, rate, train=True,
                     generator=torch.Generator().manual_seed(5))
    kept = out != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.01
    assert torch.equal(out[kept], torch.full_like(out[kept], 1 / (1 - rate)))


def test_train_mode_is_seeded_and_differs_from_eval(setup):
    (_, _, _), (tp, tf, td), xs = setup

    def run(seed):
        return th.forward_buckets(
            tp, tf, td, _txs(xs), train=True, return_recon=True,
            generator=torch.Generator().manual_seed(seed),
            attention_mode="pad-max")

    (a, ra), (b, rb), (c, _) = run(3), run(3), run(4)
    ev = th.forward_buckets(tp, tf, td, _txs(xs))
    for k in xs:
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k])
        assert not torch.allclose(a[k], ev[k])
    assert float(ra) == float(rb) and np.isfinite(float(ra))
    assert all(t.dtype == torch.float32 for t in _leaves(tp))


@pytest.mark.parametrize("mode", ["per-k", "pad-max"])
def test_fused_tail_on_at_dim_16_takes_the_unfused_chain(setup, monkeypatch,
                                                         mode):
    """With the fused tail switched on, a width the kernel does not take
    (16) runs the unfused chain, as the JAX package's gate does, and its
    logits match JAX's forward_buckets in eval mode."""
    (jp, jf, jd), (tp, tf, td), xs = setup
    assert td.dim != 64
    monkeypatch.setattr(th, "_FUSE_TAIL", True)

    def refuse(*a, **k):
        raise AssertionError("reached the fused tail")
    monkeypatch.setattr(th, "fused_tail", refuse)
    ref = jh.forward_buckets(jp, jf, jd, _jxs(xs), attention_mode=mode)
    got = th.forward_buckets(tp, tf, td, _txs(xs), attention_mode=mode)
    for k in xs:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=f"k={k}")
