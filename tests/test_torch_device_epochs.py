"""The port's device-resident epochs against the JAX package's.

``Trainer.prepare_device_epochs`` pins the same arrays as JAX's (a small
bucket doubled until it covers an epoch), ``train_epoch_device`` runs and
advances the state on every token stream, it is ``_launch_epoch`` on the
rows its permutations pick (bit for bit), the rows JAX's
``device_epoch_fn`` draws give the JAX step's losses and gradients through
the port (f32, dropout off, JAX-sampled negatives, 1e-4 / 1e-5 as
tests/test_torch_train_step.py), and it refuses a mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.models import hypersagnn as jh
from matcha_tpu.sampler.bloom import build_bloom_dict as jbuild
from matcha_tpu.sampler.negative import sample_negatives as jsample
from matcha_tpu.train import runtime as jr
from matcha_tpu_torch.models import hypersagnn as th
from matcha_tpu_torch.parallel.mesh import make_mesh
from matcha_tpu_torch.sampler.bloom import build_bloom_dict as tbuild
from matcha_tpu_torch.train import runtime as tr

from test_torch_train_step import (KS, _assert_step_matches,  # noqa: F401
                                   _requiring_grad, prob)

BATCH, STEPS = 4, 5
# rows per k: 24 covers an epoch's 20, 17 is doubled once, 10 once to 20
ROWS = {2: 24, 3: 17, 4: 10}


def _buckets(prob):
    return {k: (e[:ROWS[k]], w[:ROWS[k]])
            for k, (e, w) in prob["buckets"].items()}


def _trainer(prob, stream="merged", seed=0, mesh=None):
    tp, tf, td, tt = prob["t"]
    blooms = tbuild({k: e for k, (e, _) in prob["buckets"].items()},
                    device="cpu")
    return tr.Trainer(tp, tf, td._replace(compute_dtype="float32"), tt,
                      tr.TrainSettings(alpha=1.0, beta=0.001,
                                       token_stream=stream),
                      blooms=blooms, seed=seed, mesh=mesh)


def _jax_trainer(prob):
    jp, jf, jd, jt = prob["j"]
    blooms = jbuild({k: e for k, (e, _) in prob["buckets"].items()})
    return jr.Trainer(jp, jf, jd, jt,
                      jr.TrainSettings(alpha=1.0, beta=0.001,
                                       token_stream="merged"),
                      blooms=blooms)


def test_pinned_buckets_equal_jax(prob):
    """int32 edges and f32 weights, each bucket doubled until it covers
    STEPS x BATCH rows, bit for bit as JAX pins them; an empty bucket is
    refused on both sides."""
    jt = _jax_trainer(prob)
    jt.prepare_device_epochs(_buckets(prob), BATCH, STEPS)
    t = _trainer(prob)
    t.prepare_device_epochs(_buckets(prob), BATCH, STEPS)
    assert sorted(t._dev_buckets) == sorted(jt._dev_buckets) == list(KS)
    for k in KS:
        (te, tw), (je, jw) = t._dev_buckets[k], jt._dev_buckets[k]
        assert te.dtype == torch.int32 and tw.dtype == torch.float32
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert [len(t._dev_buckets[k][0]) for k in KS] == [24, 34, 20]
    empty = {**_buckets(prob), 3: (np.zeros((0, 3), np.int32),
                                   np.zeros(0, np.float32))}
    with pytest.raises(ValueError, match="empty bucket for k=3"):
        t.prepare_device_epochs(empty, BATCH, STEPS)
    with pytest.raises(ValueError, match="empty bucket for k=3"):
        jt.prepare_device_epochs(empty, BATCH, STEPS)


@pytest.mark.parametrize("stream", ["merged", "hybrid", "padded"])
def test_train_epoch_device_runs_and_advances(prob, stream):
    """Two epochs on each token stream: finite losses and metrics, the
    indexed epoch's result keys, the params and the generator move."""
    t = _trainer(prob, stream)
    t.prepare_device_epochs(_buckets(prob), BATCH, STEPS)
    for _ in range(2):
        before = [p.detach().clone() for p in tr._leaves(t.params)]
        state = t.generator.get_state()
        r = t.train_epoch_device()
        assert set(r) == {"bce", "recon", "metrics", "fallback_bloom_rate",
                          "fallback_orig_rate", "elapsed",
                          "hyperedges_per_sec"}
        assert np.isfinite(r["bce"]) and np.isfinite(r["recon"])
        assert 0.0 <= r["metrics"]["all"]["auroc"] <= 1.0
        assert set(r["metrics"]) == {"all", *KS}
        assert r["fallback_bloom_rate"] >= 0.0
        assert r["hyperedges_per_sec"] > 0
        assert not torch.equal(state, t.generator.get_state())
        after = tr._leaves(t.params)
        assert all(not torch.equal(a, b) for a, b in zip(before, after))


def test_device_epoch_is_the_indexed_epoch_on_its_rows(prob):
    """From the same params, optimizer state and generator state, the
    device epoch equals ``_launch_epoch`` on the permutations redrawn by
    hand (per k in sorted order: a seed from the generator, a generator on
    the buckets' device, randperm, cut to (steps, batch)), bit for bit."""
    a, b = _trainer(prob, seed=3), _trainer(prob, seed=3)
    a.prepare_device_epochs(_buckets(prob), BATCH, STEPS)
    b.prepare_device_epochs(_buckets(prob), BATCH, STEPS)
    state = a.generator.get_state()
    got = a.train_epoch_device()
    b.generator.set_state(state)
    stacked = {}
    for k in sorted(b._dev_buckets):
        e, w = b._dev_buckets[k]
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=b.generator))
        gen = torch.Generator(device=e.device).manual_seed(seed)
        idx = torch.randperm(len(e), generator=gen)[:STEPS * BATCH].view(
            STEPS, BATCH)
        stacked[k] = (e[idx], w[idx])
    want = b._finish_indexed(b._launch_epoch(stacked))
    for key in ("bce", "recon", "fallback_bloom_rate", "fallback_orig_rate"):
        assert got[key] == want[key], key
    assert got["metrics"] == want["metrics"]
    for x, y in zip(tr._leaves(a.params), tr._leaves(b.params)):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_rows_jax_draws_give_the_jax_step_through_the_port(prob):
    """JAX's device_epoch_fn draws, recomputed outside its jit (one key
    split per k in sorted order, a permutation of the pinned bucket cut to
    (steps, batch)): its carried key after an epoch is the one left after
    those splits; the port's pinned buckets gathered at those rows are
    JAX's rows; and on every step's rows the port's loss, bce, recon,
    predictions and gradients match the JAX step's (f32, dropout off,
    JAX-sampled negatives, the same recon chromosome; 1e-4 / 1e-5).  Both
    epochs' results have the same keys."""
    jp, jf, jd, jt = prob["j"]
    tp, tf, td, _ = prob["t"]
    jtr = _jax_trainer(prob)
    jtr.prepare_device_epochs(_buckets(prob), BATCH, STEPS)
    key = jtr.state.key
    idxs = {}
    for k in sorted(jtr._dev_buckets):
        key, kp = jax.random.split(key)
        n = jtr._dev_buckets[k][0].shape[0]
        idxs[k] = np.array(jax.random.permutation(kp, n)[
            :STEPS * BATCH].reshape(STEPS, BATCH))
    key = np.asarray(key)
    jres = jtr.train_epoch_device()
    for _ in range(STEPS):      # each step splits the carried key in three
        key = jax.random.split(key, 3)[0]
    np.testing.assert_array_equal(np.asarray(jtr.state.key),
                                  np.asarray(key))
    t = _trainer(prob)
    t.prepare_device_epochs(_buckets(prob), BATCH, STEPS)
    tres = t.train_epoch_device()
    assert set(tres) == set(jres)

    blooms = jbuild({k: e for k, (e, _) in prob["buckets"].items()})
    kf = jax.random.PRNGKey(8)
    r = int(jax.random.randint(jax.random.split(kf, 4)[2], (), 0,
                               jd.num_chroms))

    def jloss(p, xs, batch, ws):
        logits, recon = jh.forward_buckets(
            p, jf, jd, xs, key=kf, return_recon=True,
            attention_mode="per-k")
        bce, preds = jr._bucket_bce_and_preds(logits, batch, ws)
        return bce + 0.5 * recon, {"bce": bce, "recon": recon,
                                   "pred": preds}

    jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    for s in range(STEPS):
        xs, batch = {}, {}
        for i, k in enumerate(sorted(idxs)):
            te, tw = t._dev_buckets[k]
            je, jw = jtr._dev_buckets[k]
            rows = torch.from_numpy(idxs[k][s]).long()
            e, w = te[rows], tw[rows]
            np.testing.assert_array_equal(e.numpy(),
                                          np.asarray(je[idxs[k][s]]))
            np.testing.assert_array_equal(w.numpy(),
                                          np.asarray(jw[idxs[k][s]]))
            neg = jsample(jax.random.PRNGKey(100 * s + i),
                          jnp.asarray(e.numpy()), jt, 0, blooms[k],
                          neg_num=3)
            xs[k] = np.concatenate([e.numpy(), np.asarray(neg)])
            batch[k] = (e, w)
        (jl, jaux), jg = jgrad(
            jp, {k: jnp.asarray(v) for k, v in xs.items()},
            {k: (jnp.asarray(e.numpy()), jnp.asarray(w.numpy()))
             for k, (e, w) in batch.items()},
            {k: jnp.asarray(w.numpy()) for k, (_, w) in batch.items()})
        p = _requiring_grad(tp)
        logits, recon = th.forward_buckets(
            p, tf, td, {k: torch.from_numpy(v) for k, v in xs.items()},
            return_recon=True, attention_mode="per-k", recon_chrom=r)
        bce, preds = tr._bucket_bce_and_preds(
            logits, batch, {k: w for k, (_, w) in batch.items()})
        tl = bce + 0.5 * recon
        tl.backward()
        _assert_step_matches(jl, jaux, jg, tl,
                             {"bce": bce, "recon": recon, "pred": preds}, p)


def test_device_epochs_refuse_a_mesh(prob):
    """Single-device only, as in the JAX package (which asserts it); an
    epoch before the buckets are pinned raises too."""
    t = _trainer(prob, mesh=make_mesh(1, 1))
    with pytest.raises(RuntimeError, match="single-device"):
        t.prepare_device_epochs(_buckets(prob), BATCH, STEPS)
    with pytest.raises(RuntimeError, match="prepare_device_epochs"):
        t.train_epoch_device()
