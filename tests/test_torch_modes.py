"""The port's regress task mode, per-occurrence feature dropout and
MATCHA_RECON_BF16 gate against the JAX package, on the CPU in f32.

Where a step samples negatives, both sides get the same deterministic
stand-in for the sampler (each positive row shifted by a fixed offset,
``_shifted``), so the two frameworks score the same rows; the recon
chromosome the JAX step draws from its key is injected on the port's side.
Where train-mode dropout would draw different masks in the two frameworks,
the attention and feed-forward dropouts are replaced by the identity on
both sides ("dropout 0"); the feature dropout runs at rate 0.  Tolerances:
loss, aux and gradients rtol 1e-4 / atol 1e-5 (summation order), the
per-occurrence embedding 1e-5, the recon decode with bf16 operands 1e-4
relative (the two sides round the same operands and accumulate in f32).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from matcha_tpu.genome import GenomeBins
from matcha_tpu.models import hypersagnn as jh
from matcha_tpu.models import modules as jm
from matcha_tpu.sampler.negative import ChromTable as JTable
from matcha_tpu.train import runtime as jr
from matcha_tpu_torch.data.batcher import BucketedBatcher as TBatcher
from matcha_tpu_torch.interop import params_from_numpy
from matcha_tpu_torch.models import hypersagnn as th
from matcha_tpu_torch.models import modules as tm
from matcha_tpu_torch.sampler.negative import ChromTable as TTable
from matcha_tpu_torch.train import runtime as tr

TOL = dict(rtol=1e-4, atol=1e-5)
KS = (2, 3, 4)
SHIFT = 7


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(11)
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
    return {
        "genome": genome, "buckets": buckets, "n": n,
        "batch": {k: (e[:12], w[:12]) for k, (e, w) in buckets.items()},
        "j": (jp, jh.build_frozen_tables(genome, intra, inter),
              jh.ModelDims(**kw), JTable.from_genome(genome)),
        "t": (tp, th.build_frozen_tables(genome, intra, inter, device="cpu"),
              th.ModelDims(**kw), TTable.from_genome(genome, device="cpu")),
    }


def _shifted(n):
    """A deterministic sampler stand-in for both frameworks: the
    negatives are the positives tiled neg_num times with every id moved by
    SHIFT (mod n, in 1..n)."""
    def jax_side(key, pos, table, min_distance, bloom, *, neg_num=3, **_):
        neg = (jnp.tile(pos, (neg_num, 1)) - 1 + SHIFT) % n + 1
        z = jnp.zeros((), jnp.int32)
        return neg.astype(jnp.int32), {
            "bloom_fallback": z, "orig_fallback": z,
            "rows": jnp.asarray(neg.shape[0], jnp.int32)}

    def torch_side(gen, pos, table, min_distance, bloom, *, neg_num=3, **_):
        neg = (pos.long().repeat(neg_num, 1) - 1 + SHIFT) % n + 1
        z = torch.zeros((), dtype=torch.int32, device=pos.device)
        return neg.to(torch.int32), {
            "bloom_fallback": z, "orig_fallback": z,
            "rows": torch.tensor(neg.shape[0], dtype=torch.int32)}
    return jax_side, torch_side


def _requiring_grad(tp):
    return tr._tree_map(lambda t: t.clone().requires_grad_(True), tp)


def _assert_grads_match(tp, jgrads):
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: np.zeros(tuple(t.shape), np.float32) if t.grad is None
        else t.grad.numpy(), tp))
    ref = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def _regress_recon_chroms(key, ks, n_chroms):
    """The r each bucket of the JAX regress step draws: per k in order,
    key -> (key, k_neg, k_fwd); forward splits k_fwd into (_, k_tab, k_rec,
    k_enc); r = randint(k_rec)."""
    rs = []
    for _ in ks:
        key, _, k_fwd = jax.random.split(key, 3)
        k_rec = jax.random.split(k_fwd, 4)[2]
        rs.append(int(jax.random.randint(k_rec, (), 0, n_chroms)))
    return rs


def _inject_recon_chroms(monkeypatch, rs):
    """The port's regress step calls ``forward`` once per bucket in k
    order: hand each call its bucket's r."""
    it = iter(rs)
    orig = tr.forward

    def fwd(*a, **kw):
        kw["recon_chrom"] = next(it)
        return orig(*a, **kw)
    monkeypatch.setattr(tr, "forward", fwd)


# ------------------------------------------------------------------ regress
@pytest.mark.parametrize("train", [False, True])
def test_regress_step_matches_jax(prob, monkeypatch, train):
    """The regress branch of batch_loss (a padded forward per k, softplus
    MSE, sigmoid(pos - neg) predictions, recon per bucket): loss, bce,
    recon, predictions and every gradient.  In train mode the dropouts are
    the identity on both sides."""
    jp, jf, jd, jt = prob["j"]
    tp, tf, td, tt = prob["t"]
    jfake, tfake = _shifted(prob["n"])
    monkeypatch.setattr(jr, "sample_negatives_with_stats", jfake)
    monkeypatch.setattr(tr, "sample_negatives_with_stats", tfake)
    if train:
        monkeypatch.setattr(jm, "dropout", lambda key, x, rate, train: x)
        monkeypatch.setattr(tm, "dropout", lambda x, *a, **k: x)
        jd = jd._replace(feature_dropout=0.0)
        td = td._replace(feature_dropout=0.0)
    js = jr.TrainSettings(alpha=1.0, beta=0.5, neg_num=2, task_mode="regress")
    ts_ = tr.TrainSettings(alpha=1.0, beta=0.5, neg_num=2,
                           task_mode="regress")
    key = jax.random.PRNGKey(5)
    jbatch = {k: (jnp.asarray(e), jnp.asarray(w))
              for k, (e, w) in prob["batch"].items()}

    def jloss(p):
        nt = jh.encode_node_table(p, jf, jd, train=False)
        return jr.batch_loss(p, jf, jd, jt, None, js, jbatch, key, nt, train)

    (jl, jaux), jg = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jp)
    _inject_recon_chroms(monkeypatch,
                         _regress_recon_chroms(key, KS, td.num_chroms))
    tp = _requiring_grad(tp)
    tbatch = {k: (torch.from_numpy(e), torch.from_numpy(w))
              for k, (e, w) in prob["batch"].items()}
    nt = th.encode_node_table(tp, tf, td, train=False)
    tl, taux = tr.batch_loss(tp, tf, td, tt, None, ts_, tbatch,
                             torch.Generator().manual_seed(0), nt, train)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    for name in ("bce", "recon", "pred"):
        np.testing.assert_allclose(taux[name].detach().numpy(),
                                   np.asarray(jaux[name]), **TOL,
                                   err_msg=name)
    assert taux["pred"].shape == (sum(12 for _ in KS),)
    _assert_grads_match(tp, jg)


def test_regress_eval_epoch_matches_jax(prob, monkeypatch):
    """The per-k eval of the regress mode: the same rows per size from the
    seed, the same batch plan, bce and per-size metrics (1e-5; AUROC is
    NaN on both sides, every label being 1).  The recon chromosome is each
    framework's own draw, so recon is only held finite."""
    jp, jf, jd, jt = prob["j"]
    tp, tf, td, tt = prob["t"]
    jfake, tfake = _shifted(prob["n"])
    monkeypatch.setattr(jr, "sample_negatives_with_stats", jfake)
    monkeypatch.setattr(tr, "sample_negatives_with_stats", tfake)
    kw = dict(alpha=1.0, beta=0.001, neg_num=2, task_mode="regress")
    test = {k: v for k, v in prob["buckets"].items()}
    test[4] = (test[4][0][:5], test[4][1][:5])     # shrinks its batch to 5
    jt_ = jr.Trainer(jp, jf, jd, jt, jr.TrainSettings(**kw))
    tt_ = tr.Trainer(tp, tf, td, tt, tr.TrainSettings(**kw))
    for bs, max_samples in ((8, 60), (4, 1000)):
        jev = jt_.eval_epoch(test, batch_size=bs, max_samples=max_samples,
                             seed=3)
        tev = tt_.eval_epoch(test, batch_size=bs, max_samples=max_samples,
                             seed=3)
        np.testing.assert_allclose(tev["bce"], jev["bce"], rtol=1e-5)
        assert np.isfinite(tev["recon"])
        assert set(tev["metrics"]) == set(jev["metrics"]) == {"all", *KS}
        for g, m in jev["metrics"].items():
            assert tev["metrics"][g]["n"] == m["n"]
            for name in ("auroc", "auprc", "acc"):
                np.testing.assert_allclose(tev["metrics"][g][name], m[name],
                                           rtol=1e-5, err_msg=f"{g} {name}")


def test_regress_fit_checkpoints(prob, tmp_path):
    """A regress fit on the CPU trains, evaluates per k and writes its
    checkpoint (tests/test_eval_edge_cases.py:43)."""
    tp, tf, td, tt = prob["t"]
    trainer = tr.Trainer(tp, tf, td, tt,
                         tr.TrainSettings(alpha=1.0, beta=0.0, neg_num=1,
                                          task_mode="regress"))
    ckpt = str(tmp_path / "model.chkpt")
    logs = []
    hist = trainer.fit({2: prob["buckets"][2]}, {2: prob["buckets"][2]},
                       epochs=1, batch_size=8, num_batch_per_iter=2,
                       checkpoint_path=ckpt, log=logs.append)
    assert os.path.exists(ckpt)
    assert np.isfinite(hist[0]["train"]["bce"])
    assert np.isnan(hist[0]["valid"]["metrics"][2]["auroc"])


def test_regress_nan_auprc_checkpoints_on_loss(prob, tmp_path):
    """With a NaN AUPRC the checkpoint follows -bce from a -inf floor, so
    the best-loss epoch is the one written (tests/test_eval_edge_cases.py:
    59): the eval is replaced by one that returns NaN metrics."""
    tp, tf, td, tt = prob["t"]
    trainer = tr.Trainer(tp, tf, td, tt,
                         tr.TrainSettings(alpha=1.0, beta=0.0, neg_num=1,
                                          task_mode="regress"))
    nan_m = {"auroc": float("nan"), "auprc": float("nan"), "acc": 0.0}
    bces = iter([0.9, 0.3, 0.5])

    def fake_eval(*a, **k):
        return {"metrics": {2: dict(nan_m), "all": dict(nan_m)},
                "bce": next(bces), "recon": 0.0}

    trainer.eval_epoch = fake_eval
    ckpt = str(tmp_path / "model.chkpt")
    trainer.fit({2: prob["buckets"][2]}, {2: prob["buckets"][2]}, epochs=3,
                batch_size=8, num_batch_per_iter=2, checkpoint_path=ckpt,
                log=lambda *_: None)
    assert tr.load_checkpoint(ckpt, full=True, device="cpu")["epoch"] == 1


# ------------------------------------------------------------ per_occurrence
def _occ(dims, rate):
    return dims._replace(feature_dropout_mode="per_occurrence",
                         feature_dropout=rate)


def test_per_occurrence_embed_matches_jax(prob):
    """At rate 0 the per-chromosome grouping computes JAX's gathered-weight
    einsum: every token's row, pads (id 0) exactly zero."""
    jp, jf, jd, _ = prob["j"]
    tp, tf, td, _ = prob["t"]
    flat = np.random.default_rng(2).integers(0, prob["n"] + 1, 200)
    flat[::9] = 0
    ref = np.asarray(jh._per_occurrence_embed(
        jp, jf, _occ(jd, 0.0), jnp.asarray(flat, jnp.int32),
        jax.random.PRNGKey(1)))
    got = th._per_occurrence_embed(tp, tf, _occ(td, 0.0),
                                   torch.from_numpy(flat),
                                   torch.Generator().manual_seed(1))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert (got[torch.from_numpy(flat == 0)] == 0).all()


@pytest.mark.parametrize("mode", ["per-k", "pad-max"])
def test_per_occurrence_train_step_at_dropout_0_matches_jax(prob, monkeypatch,
                                                            mode):
    """forward_buckets in train mode with the per-occurrence embedding
    (rate 0, the other dropouts the identity on both sides): logits, the
    per-token recon and every gradient against JAX."""
    monkeypatch.setattr(jm, "dropout", lambda key, x, rate, train: x)
    monkeypatch.setattr(tm, "dropout", lambda x, *a, **k: x)
    jp, jf, jd, _ = prob["j"]
    tp, tf, td, _ = prob["t"]
    jd, td = _occ(jd, 0.0), _occ(td, 0.0)
    xs = {k: e for k, (e, _) in prob["batch"].items()}
    key = jax.random.PRNGKey(8)
    r = int(jax.random.randint(jax.random.split(key, 4)[2], (), 0,
                               jd.num_chroms))

    def jloss(p):
        logits, recon = jh.forward_buckets(
            p, jf, jd, {k: jnp.asarray(v) for k, v in xs.items()}, key=key,
            train=True, return_recon=True, attention_mode=mode)
        return sum(jnp.mean(lg ** 2) for lg in logits.values()) + recon, \
            (logits, recon)

    (jl, (jlog, jrec)), jg = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jp)
    tp = _requiring_grad(tp)
    logits, recon = th.forward_buckets(
        tp, tf, td, {k: torch.from_numpy(v) for k, v in xs.items()},
        generator=torch.Generator().manual_seed(0), train=True,
        return_recon=True, attention_mode=mode, recon_chrom=r)
    tl = sum((lg ** 2).mean() for lg in logits.values()) + recon
    tl.backward()
    np.testing.assert_allclose(float(recon.detach()), float(jrec), **TOL)
    for k in xs:
        np.testing.assert_allclose(logits[k].detach().numpy(),
                                   np.asarray(jlog[k]), **TOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    _assert_grads_match(tp, jg)


def test_per_occurrence_forward_at_dropout_0_matches_jax(prob, monkeypatch):
    """The padded forward's per-occurrence branch (pads in the batch) and
    its per-token recon against JAX."""
    monkeypatch.setattr(jm, "dropout", lambda key, x, rate, train: x)
    monkeypatch.setattr(tm, "dropout", lambda x, *a, **k: x)
    jp, jf, jd, _ = prob["j"]
    tp, tf, td, _ = prob["t"]
    x = np.asarray([[1, 5, 9, 12], [2, 4, 6, 0], [30, 40, 50, 0]], np.int32)
    key = jax.random.PRNGKey(4)
    r = int(jax.random.randint(jax.random.split(key, 4)[2], (), 0,
                               jd.num_chroms))
    jout, jrec = jh.forward(jp, jf, _occ(jd, 0.0), jnp.asarray(x), key=key,
                            train=True, return_recon=True)
    tout, trec = th.forward(tp, tf, _occ(td, 0.0), torch.from_numpy(x),
                            generator=torch.Generator().manual_seed(0),
                            train=True, return_recon=True, recon_chrom=r)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(trec), float(jrec), **TOL)


def test_per_occurrence_eval_is_the_per_node_path(prob):
    """Eval has no dropout: the mode changes nothing there, bit for bit,
    and its table stays clean even when encoded in train mode."""
    tp, tf, td, _ = prob["t"]
    x = torch.from_numpy(np.random.default_rng(1).integers(
        1, prob["n"], (16, 3)).astype(np.int32))
    assert torch.equal(th.forward(tp, tf, td, x),
                       th.forward(tp, tf, _occ(td, 0.2), x))
    xs = {3: x, 2: x[:, :2]}
    a = th.forward_buckets(tp, tf, td, xs)
    b = th.forward_buckets(tp, tf, _occ(td, 0.2), xs)
    assert all(torch.equal(a[k], b[k]) for k in xs)
    assert torch.equal(
        th.encode_node_table(tp, tf, td, train=False),
        th.encode_node_table(tp, tf, _occ(td, 0.2), train=True,
                             generator=torch.Generator().manual_seed(0)))


def test_per_occurrence_draws_per_occurrence(prob, monkeypatch):
    """At rate 0.5 two occurrences of one node get different masks; the
    mask is one (T, W_max) draw in stream order, as JAX's, and the keep
    share of the entries the tokens use (each real token's row, its
    chromosome's W_c columns) is within 3 sigma of 0.5; pad rows are
    zero."""
    tp, tf, td, _ = prob["t"]
    draws = []
    orig = th.rand

    def rand(gen, shape, device):
        u = orig(gen, shape, device)
        draws.append(u)
        return u
    monkeypatch.setattr(th, "rand", rand)
    flat = torch.full((64,), prob["n"] // 2, dtype=torch.int64)
    flat[::8] = 0
    emb = th._per_occurrence_embed(tp, tf, _occ(td, 0.5), flat,
                                   torch.Generator().manual_seed(3))
    real = emb[flat != 0]
    assert np.unique(real.numpy().round(6), axis=0).shape[0] > 1
    assert (emb[flat == 0] == 0).all()
    assert len(draws) == 1 and tuple(draws[0].shape) == (
        64, max(f.shape[1] for f in tf.features))
    keep = (draws[0][flat != 0, :tf.features[1].shape[1]] < 0.5).reshape(
        -1).float()
    assert keep.numel() == 56 * tf.features[1].shape[1]
    sigma = (0.25 / keep.numel()) ** 0.5
    assert abs(float(keep.mean()) - 0.5) <= 3 * sigma


def test_per_occurrence_gradients_flow_and_trainer_steps(prob):
    """The AE weights take gradient through the per-token path
    (tests/test_feature_dropout.py:100), and a Trainer trains in the mode."""
    tp, tf, td, tt = prob["t"]
    occ = _occ(td, 0.2)
    p = _requiring_grad(tp)
    xs = {3: torch.from_numpy(prob["batch"][3][0])}
    logits, recon = th.forward_buckets(
        p, tf, occ, xs, generator=torch.Generator().manual_seed(5),
        train=True, return_recon=True)
    (logits[3].mean() + recon).backward()
    assert all(torch.isfinite(t.grad).all() for t in tr._leaves(p)
               if t.grad is not None)
    assert float(p["embed"]["ae"][0]["w1"].grad.abs().max()) > 0

    trainer = tr.Trainer(tp, tf, occ, tt,
                         tr.TrainSettings(alpha=1.0, beta=0.5,
                                          token_stream="merged"))
    batcher = TBatcher(prob["buckets"], batch_size=8, num_batch_per_iter=2,
                       seed=0)
    before = [t.detach().clone() for t in tr._leaves(trainer.params)]
    res = trainer.train_epoch(batcher)
    assert np.isfinite(res["bce"]) and np.isfinite(res["recon"])
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tr._leaves(trainer.params)))


# --------------------------------------------------------- MATCHA_RECON_BF16
def test_recon_bf16_matches_jax(prob, monkeypatch):
    """recon_loss_node with the decode's operands in bf16 on both sides
    (1e-4 relative), and it differs from the f32 decode."""
    jp, jf, jd, _ = prob["j"]
    tp, tf, td, _ = prob["t"]
    table = np.asarray(jh.encode_node_table(jp, jf, jd))
    x = np.random.default_rng(4).integers(0, prob["n"] + 1, 300)
    got = {}
    for on in (False, True):
        monkeypatch.setattr(jh, "_RECON_BF16", on)
        monkeypatch.setattr(th, "_RECON_BF16", on)
        ref = float(jh.recon_loss_node(jp, jf, jd, jnp.asarray(x),
                                       jnp.asarray(table), 1))
        got[on] = float(th.recon_loss_node(tp, tf, td, torch.from_numpy(x),
                                           torch.from_numpy(table), 1))
        np.testing.assert_allclose(got[on], ref, rtol=1e-4)
    assert got[True] != got[False]


def test_recon_bf16_gate_is_read_once(monkeypatch):
    monkeypatch.setattr(th, "_RECON_BF16", None)
    monkeypatch.setenv("MATCHA_RECON_BF16", "1")
    assert th._recon_decode_bf16()
    monkeypatch.setenv("MATCHA_RECON_BF16", "0")
    assert th._recon_decode_bf16()
