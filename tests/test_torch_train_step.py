"""The port's training step against the JAX package, in f32.

One step from the same params, batch and negatives, with dropout off and the
same recon chromosome r: the loss, its bce and recon parts and every
parameter gradient are held against jax.value_and_grad of the JAX package's
own step loss (stage-1 copies as negatives) and of the same JAX pieces (a
JAX-sampled set of negatives fed to both); one AdamW update from the same
gradients against optax.adamw (1e-6 absolute), and a second one after the
port resumes from a JAX snapshot with its optax state.  The port's batcher
gives the JAX package's index stream, and a few CPU epochs train.
"""

import collections
import pickle
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from matcha_tpu.data.batcher import BucketedBatcher as JBatcher
from matcha_tpu.genome import GenomeBins
from matcha_tpu.models import hypersagnn as jh
from matcha_tpu.sampler.bloom import build_bloom_dict as jbuild
from matcha_tpu.sampler.negative import ChromTable as JTable
from matcha_tpu.sampler.negative import sample_negatives as jsample
from matcha_tpu.train import runtime as jr
from matcha_tpu_torch.data.batcher import BucketedBatcher as TBatcher
from matcha_tpu_torch.interop import params_from_numpy
from matcha_tpu_torch.models import hypersagnn as th
from matcha_tpu_torch.sampler.bloom import build_bloom_dict as tbuild
from matcha_tpu_torch.sampler.negative import ChromTable as TTable
from matcha_tpu_torch.train import runtime as tr

TOL = dict(rtol=1e-4, atol=1e-5)
KS = (2, 3, 4)


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(6)
    genome = GenomeBins(["chr1", "chr2", "chr3"],
                        [30_000_000, 20_000_000, 15_000_000], 1_000_000)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    intra = intra + intra.T
    inter = rng.random((n, n)).astype(np.float32)
    kw = dict(dim=16, n_head=4, num_chroms=3, num_nodes=n)
    sizes = [int(e - s) for s, e in genome.chrom_range]
    jp = jh.init_model(jax.random.PRNGKey(0), jh.ModelDims(**kw), sizes)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    buckets = {}
    for k in KS:
        e = np.sort(rng.choice(np.arange(1, n + 1), (80, k)), axis=1)
        e = e[(np.diff(e, axis=1) > 0).all(axis=1)][:24].astype(np.int32)
        buckets[k] = (e, (rng.random(len(e)) + 0.5).astype(np.float32))
    batch = {k: (e[:12], w[:12]) for k, (e, w) in buckets.items()}
    return {
        "genome": genome, "buckets": buckets, "batch": batch,
        "j": (jp, jh.build_frozen_tables(genome, intra, inter),
              jh.ModelDims(**kw), JTable.from_genome(genome)),
        "t": (tp, th.build_frozen_tables(genome, intra, inter, device="cpu"),
              th.ModelDims(**kw), TTable.from_genome(genome, device="cpu")),
    }


def _recon_chrom(key, n_chroms):
    """The r the JAX step draws from its loss key: key -> (key, k_neg,
    k_fwd); k_fwd -> (key, k_tab, k_rec, k_enc); r = randint(k_rec)."""
    k_fwd = jax.random.split(key, 3)[2]
    k_rec = jax.random.split(k_fwd, 4)[2]
    return int(jax.random.randint(k_rec, (), 0, n_chroms))


def _requiring_grad(tp):
    return tr._tree_map(lambda t: t.clone().requires_grad_(True), tp)


def _grads(tp):
    """The port's grads in the JAX tree's leaf order; a leaf autograd never
    reached (an unused recon decoder) is zero."""
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: np.zeros(tuple(t.shape), np.float32) if t.grad is None
        else t.grad.numpy(), tp))


def _assert_step_matches(jloss, jaux, jgrads, tloss, taux, tp):
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    for name in ("bce", "recon"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   **TOL, err_msg=name)
    np.testing.assert_allclose(taux["pred"].detach().numpy(),
                               np.asarray(jaux["pred"]), **TOL)
    ref = jax.tree_util.tree_leaves(jgrads)
    got = _grads(tp)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("stream", ["merged", "hybrid", "padded"])
def test_stage1_step_matches_jax(prob, stream):
    """The whole step loss (negatives: copies of the positives)."""
    jp, jf, jd, jt = prob["j"]
    tp, tf, td, tt = prob["t"]
    js = jr.TrainSettings(alpha=1.0, beta=0.5, token_stream=stream)
    ts = tr.TrainSettings(alpha=1.0, beta=0.5, token_stream=stream)
    key = jax.random.PRNGKey(3)
    jbatch = {k: (jnp.asarray(e), jnp.asarray(w))
              for k, (e, w) in prob["batch"].items()}

    def jloss(p):
        nt = jh.encode_node_table(p, jf, jd, train=False)
        return jr.batch_loss(p, jf, jd, jt, None, js, jbatch, key, nt, False)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tp = _requiring_grad(tp)
    tbatch = {k: (torch.from_numpy(e), torch.from_numpy(w))
              for k, (e, w) in prob["batch"].items()}
    nt = th.encode_node_table(tp, tf, td, train=False)
    tl, taux = tr.batch_loss(tp, tf, td, tt, None, ts, tbatch,
                             torch.Generator().manual_seed(0), nt, False,
                             recon_chrom=_recon_chrom(key, td.num_chroms))
    tl.backward()
    _assert_step_matches(jl, jaux, jg, tl, taux, tp)


def test_step_on_jax_sampled_negatives_matches_jax(prob):
    """Negatives sampled by the JAX package against Bloom filters, fed to
    both: the merged (per-k) forward + weighted BCE + recon."""
    jp, jf, jd, jt = prob["j"]
    tp, tf, td, _ = prob["t"]
    blooms = jbuild({k: e for k, (e, _) in prob["buckets"].items()})
    xs, ws = {}, {}
    for i, (k, (e, w)) in enumerate(sorted(prob["batch"].items())):
        neg = jsample(jax.random.PRNGKey(10 + i), jnp.asarray(e), jt, 0,
                      blooms[k], neg_num=3)
        xs[k] = np.concatenate([e, np.asarray(neg)])
        ws[k] = w
    kf = jax.random.PRNGKey(8)
    r = int(jax.random.randint(jax.random.split(kf, 4)[2], (), 0,
                               jd.num_chroms))
    jbatch = {k: (jnp.asarray(e), jnp.asarray(w))
              for k, (e, w) in prob["batch"].items()}

    def jloss(p):
        logits, recon = jh.forward_buckets(
            p, jf, jd, {k: jnp.asarray(v) for k, v in xs.items()}, key=kf,
            return_recon=True, attention_mode="per-k")
        bce, preds = jr._bucket_bce_and_preds(
            logits, jbatch, {k: jnp.asarray(v) for k, v in ws.items()})
        return bce + 0.5 * recon, {"bce": bce, "recon": recon,
                                   "pred": preds}

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tp = _requiring_grad(tp)
    logits, recon = th.forward_buckets(
        tp, tf, td, {k: torch.from_numpy(v) for k, v in xs.items()},
        return_recon=True, attention_mode="per-k", recon_chrom=r)
    tbatch = {k: (torch.from_numpy(e), torch.from_numpy(w))
              for k, (e, w) in prob["batch"].items()}
    bce, preds = tr._bucket_bce_and_preds(
        logits, tbatch, {k: torch.from_numpy(v) for k, v in ws.items()})
    tl = bce + 0.5 * recon
    tl.backward()
    _assert_step_matches(jl, jaux, jg, tl,
                         {"bce": bce, "recon": recon, "pred": preds}, tp)


def test_adamw_update_matches_optax(prob):
    """One AdamW step from the same params and gradients."""
    jp = prob["j"][0]
    tp = _requiring_grad(prob["t"][0])
    s = tr.TrainSettings(alpha=1.0, beta=0.001, learning_rate=3e-3)
    rng = np.random.default_rng(1)
    jg = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32), jp)
    for t, g in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t, tp)),
            jax.tree_util.tree_leaves(jg)):
        t.grad = torch.tensor(np.asarray(g))
    opt = tr.make_optimizer(tp, s)
    opt.step()
    jopt = jr.make_optimizer(jr.TrainSettings(alpha=1.0, beta=0.001,
                                              learning_rate=3e-3))
    ref = jax.jit(lambda g, p: optax.apply_updates(
        p, jopt.update(g, jopt.init(p), p)[0]))(jg, jp)
    for a, b in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t.detach().numpy(), tp)),
            jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)


def test_jax_checkpoint_with_adamw_state_resumes_in_port(prob, tmp_path,
                                                         monkeypatch):
    """JAX takes one optax.adamw step and saves a snapshot (params, optax
    state, epoch, its PRNG key).  The port reads it with optax and JAX
    unimportable, a Trainer resumes from it (params, AdamW moments and
    step; its own generator, unchanged), and one more step from the same
    gradients agrees with optax's second step (1e-6 absolute)."""
    jp = prob["j"][0]
    tp, tf, td, tt = prob["t"]
    js = jr.TrainSettings(alpha=1.0, beta=0.001, learning_rate=3e-3)
    rng = np.random.default_rng(2)
    g1, g2 = (jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32), jp)
        for _ in range(2))
    jopt = jr.make_optimizer(js)
    upd, st = jopt.update(g1, jopt.init(jp), jp)
    p1 = optax.apply_updates(jp, upd)
    path = str(tmp_path / "resume.chkpt")
    jr.save_checkpoint(path, p1, st, epoch=0, key=jax.random.PRNGKey(5),
                       best=0.25)
    upd, _ = jopt.update(g2, st, p1)
    p2 = optax.apply_updates(p1, upd)

    trainer = tr.Trainer(tp, tf, td, tt,
                         tr.TrainSettings(alpha=1.0, beta=0.001,
                                          learning_rate=3e-3), seed=4)
    fresh = trainer.generator.get_state()
    with monkeypatch.context() as m:
        for name in [n for n in sys.modules
                     if n.split(".")[0] in ("optax", "jax")]:
            m.setitem(sys.modules, name, None)
        snap = trainer._load_resume(path)
    assert snap["epoch"] == 0 and snap["best"] == 0.25 and snap["key"] is None
    assert snap["opt_state"]["step"] == [1.0] * len(tr._leaves(tp))
    assert torch.equal(trainer.generator.get_state(), fresh)
    for a, b in zip(jax.tree_util.tree_leaves(p1),
                    tr._leaves(trainer.params)):
        np.testing.assert_array_equal(b.detach().numpy(), np.asarray(a))
    for t, g in zip(tr._leaves(trainer.params),
                    jax.tree_util.tree_leaves(g2)):
        t.grad = torch.tensor(np.asarray(g))
    trainer.optimizer.step()
    for a, b in zip(tr._leaves(trainer.params),
                    jax.tree_util.tree_leaves(p2)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-6)


def test_load_checkpoint_refuses_other_classes(tmp_path):
    """Only numpy arrays and scalars, Python values and optax's AdamW
    states unpickle; anything else is refused before it is built."""
    path = str(tmp_path / "odd.chkpt")
    with open(path, "wb") as f:
        pickle.dump({"params": {"w": np.ones(2, np.float32)},
                     "opt_state": collections.OrderedDict(a=1)}, f)
    with pytest.raises(pickle.UnpicklingError, match="OrderedDict"):
        tr.load_checkpoint(path, device="cpu")


def test_batcher_index_stream_matches_jax(prob):
    buckets = {k: (e[:10 + 3 * i], w[:10 + 3 * i]) for i, (k, (e, w))
               in enumerate(sorted(prob["buckets"].items()))}
    jb = JBatcher(buckets, batch_size=4, num_batch_per_iter=5, seed=3)
    tb = TBatcher(buckets, batch_size=4, num_batch_per_iter=5, seed=3)
    assert tb.base_nbytes() == jb.base_nbytes()
    for epoch in range(4):
        ji, ti = jb.next_epoch_indices(), tb.next_epoch_indices()
        for k in ji:
            np.testing.assert_array_equal(ti[k], ji[k])
        je, te = jb.next_epoch(), tb.next_epoch()
        for k in je:
            np.testing.assert_array_equal(te[k][0], je[k][0])
            np.testing.assert_array_equal(te[k][1], je[k][1])


def test_labels_for_batch_match_jax(prob):
    batch = prob["batch"]
    s = tr.TrainSettings(alpha=1.0, beta=0.001)
    y, size = tr.labels_for_batch(batch, s)
    jy, jsize = jr.labels_for_batch(batch, jr.TrainSettings(alpha=1.0,
                                                            beta=0.001))
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(size, jsize)


def test_indexed_epochs_train_on_cpu(prob):
    """A stage-1 epoch, then three stage-2 steps against Bloom filters:
    finite losses, every parameter moves, the caller's inter_z and the host
    chromosome bounds are in place."""
    tp, tf, td, tt = prob["t"]
    td = td._replace(compute_dtype="float32")
    blooms = tbuild({k: e for k, (e, _) in prob["buckets"].items()},
                    device="cpu")
    batcher = TBatcher(prob["buckets"], batch_size=8, num_batch_per_iter=3,
                       seed=0)
    s1 = tr.Trainer(tp, tf, td, tt, tr.TrainSettings(alpha=0.0, beta=1.0))
    assert s1.pin_base_buckets(batcher)
    r1 = s1.train_epoch_indexed(batcher)
    assert r1["fallback_orig_rate"] == 0.0 and np.isfinite(r1["recon"])
    trainer = tr.Trainer(s1.params, tf, td, tt,
                         tr.TrainSettings(alpha=1.0, beta=0.001,
                                          token_stream="merged"),
                         blooms=blooms, seed=1)
    # the caller's inter_z, kept without a copy or pad columns
    assert trainer.frozen.inter_z.data_ptr() == tf.inter_z.data_ptr()
    assert trainer.frozen.inter_z.shape == tf.inter_z.shape
    assert trainer.settings.chrom_bounds == tuple(
        (int(s), int(e)) for s, e in prob["genome"].chrom_range)
    before = [t.detach().clone() for t in tr._leaves(trainer.params)]
    assert trainer.pin_base_buckets(batcher)
    res = trainer.train_epoch_indexed(batcher)
    assert set(res) == {"bce", "recon", "metrics", "fallback_bloom_rate",
                        "fallback_orig_rate", "elapsed",
                        "hyperedges_per_sec"}
    assert set(res["metrics"]) == {"all", *KS}
    assert np.isfinite(res["bce"]) and np.isfinite(res["recon"])
    assert res["hyperedges_per_sec"] > 0
    after = tr._leaves(trainer.params)
    assert all(not torch.equal(a, b) for a, b in zip(before, after))
    assert not trainer.pin_base_buckets(batcher, budget_bytes=1)
