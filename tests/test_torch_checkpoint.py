"""The port's stand-in for the JAX package's orbax checkpointer
(``matcha_tpu_torch/train/checkpoint.py``, on torch.distributed.checkpoint):
the counterparts of tests/test_checkpoint.py — the round trip with the
optimizer state and the epoch, ``max_to_keep``, the restore into given
trees, ``Trainer.fit(checkpoint_format="orbax")``'s best reload, and a
mid-stage resume that continues the uninterrupted run exactly in both
formats (losses 1e-6, recon 1e-5, params and AdamW moments rtol 1e-6 /
atol 1e-7, as there)."""

import numpy as np
import pytest
import torch

from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.models.hypersagnn import (ModelDims,
                                                build_frozen_tables,
                                                init_model)
from matcha_tpu_torch.sampler.bloom import build_bloom_dict
from matcha_tpu_torch.sampler.negative import ChromTable
from matcha_tpu_torch.train import runtime as tr
from matcha_tpu_torch.train.checkpoint import OrbaxCheckpointer


def _leaves(tree):
    return [t.detach().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t) for t in tr._leaves(tree)]


def _small_problem(seed=5):
    rng = np.random.default_rng(seed)
    genome = GenomeBins(["chr1", "chr2"], [20_000_000, 14_000_000], 1_000_000)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    intra = intra + intra.T
    inter = rng.random((n, n)).astype(np.float32)
    dims = ModelDims(dim=8, n_head=2, num_chroms=2, num_nodes=n)
    chrom_sizes = [int(e - s) for s, e in genome.chrom_range]
    params = init_model(torch.Generator().manual_seed(0), dims, chrom_sizes,
                        device="cpu")
    frozen = build_frozen_tables(genome, intra, inter, device="cpu")
    buckets = {}
    for k in (2, 3):
        e = np.stack([np.sort(rng.choice(np.arange(1, n + 1), k,
                                         replace=False))
                      for _ in range(24)]).astype(np.int32)
        buckets[k] = (e, np.ones(len(e), np.float32))
    blooms = build_bloom_dict({k: v[0] for k, v in buckets.items()},
                              device="cpu")
    return genome, dims, params, frozen, buckets, blooms


def _trainer(prob, settings=None):
    genome, dims, params, frozen, _, blooms = prob
    return tr.Trainer(params, frozen, dims,
                      ChromTable.from_genome(genome, device="cpu"),
                      settings or tr.TrainSettings(alpha=1.0, beta=0.001),
                      blooms=blooms)


def test_roundtrip_with_opt_state_and_epoch(tmp_path):
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3),
              "layers": [{"g": torch.full((2,), 2.0)}]}
    opt = torch.optim.AdamW(tr._leaves(params), lr=1e-3)
    opt_state = tr._adamw_state(params, opt)
    opt_state["step"] = [3.0, 3.0, 3.0]
    key = torch.Generator().manual_seed(4).get_state().numpy()
    with OrbaxCheckpointer(str(tmp_path / "ckpt")) as ckpt:
        ckpt.save(0, params, opt_state, epoch=7, key=key, best=0.25)
        ckpt.wait()
        p2, o2, ep = ckpt.restore(like_params=params,
                                  like_opt_state=opt_state)
        meta = ckpt.last_meta
    assert ep == 7
    for a, b in zip(_leaves(params), _leaves(p2)):
        np.testing.assert_array_equal(a, b)
    for name in ("exp_avg", "exp_avg_sq"):
        for a, b in zip(opt_state[name], o2[name]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert o2["step"] == [3.0, 3.0, 3.0]
    np.testing.assert_array_equal(np.asarray(meta["key"], np.uint8), key)
    assert meta["best"] == 0.25 and meta["epoch"] == 7


def test_max_to_keep_retains_latest(tmp_path):
    with OrbaxCheckpointer(str(tmp_path / "c")) as ckpt:
        ckpt.save(0, {"w": torch.zeros(2)})
        ckpt.save(3, {"w": torch.full((2,), 3.0)})
        ckpt.wait()
        assert ckpt.latest_step() == 3
        p, o, ep = ckpt.restore()
        assert o is None and ep is None
        np.testing.assert_allclose(p["w"].numpy(), 3.0)
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == ["3"]
    with OrbaxCheckpointer(str(tmp_path / "c"), max_to_keep=2,
                           async_save=False) as ckpt:
        ckpt.save(5, {"w": torch.full((2,), 5.0)})
        assert ckpt.latest_step() == 5
        np.testing.assert_allclose(ckpt.restore(step=3)[0]["w"].numpy(), 3.0)
    with pytest.raises(FileNotFoundError):
        OrbaxCheckpointer(str(tmp_path / "empty")).restore()


def test_restore_follows_the_given_trees(tmp_path):
    """like_params gives the restored leaves' structure, dtype and device
    (the counterpart of the JAX test's sharded restore); without it the
    leaves come back on the host."""
    params = {"t": torch.arange(8.0), "h": torch.ones(2, dtype=torch.bfloat16)}
    with OrbaxCheckpointer(str(tmp_path / "s")) as ckpt:
        ckpt.save(0, params)
        like = {"t": torch.zeros(8), "h": torch.zeros(2, dtype=torch.bfloat16)}
        p2, _, _ = ckpt.restore(like_params=like)
        p3, _, _ = ckpt.restore()
    assert p2["h"].dtype == torch.bfloat16 and p3["h"].dtype == torch.bfloat16
    np.testing.assert_allclose(p2["t"].numpy(), np.arange(8.0))
    assert p3["t"].device.type == "cpu"


def test_fit_orbax_best_reload(tmp_path):
    """Trainer.fit(checkpoint_format='orbax') saves on improvement and
    reloads the best checkpoint at the end of the stage."""
    prob = _small_problem()
    buckets = prob[4]
    trainer = _trainer(prob)
    ckpt_dir = tmp_path / "orbax_ckpt"
    hist = trainer.fit(buckets, buckets, epochs=2, batch_size=8,
                       num_batch_per_iter=2, checkpoint_path=str(ckpt_dir),
                       checkpoint_format="orbax", log=lambda *_: None)
    assert len(hist) == 2
    assert ckpt_dir.exists() and any(ckpt_dir.iterdir())
    with OrbaxCheckpointer(str(ckpt_dir)) as ckpt:
        saved, _, _ = ckpt.restore()
    for a, b in zip(_leaves(saved), _leaves(trainer.params)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fmt", ["pickle", "orbax"])
def test_resume_mid_stage_exact(tmp_path, fmt):
    """Stop after epoch 1, restore in a fresh Trainer, continue: the losses,
    the final params and AdamW's moments equal the uninterrupted run's."""
    prob = _small_problem()
    buckets = prob[4]
    kw = dict(epochs=4, batch_size=8, num_batch_per_iter=2,
              checkpoint_format=fmt, log=lambda *_: None)
    ta = _trainer(prob)
    hist_a = ta.fit(buckets, buckets, resume_path=str(tmp_path / "resA"),
                    **kw)
    pb = str(tmp_path / "resB")
    _trainer(prob).fit(buckets, buckets, resume_path=pb, **dict(kw, epochs=2))
    tb = _trainer(prob)
    hist_b = tb.fit(buckets, buckets, resume_path=pb, resume=True, **kw)
    assert len(hist_b) == 2
    for a, b in zip(hist_a[2:], hist_b):
        assert abs(a["train"]["bce"] - b["train"]["bce"]) < 1e-6
        assert abs(a["train"]["recon"] - b["train"]["recon"]) < 1e-5
        assert abs(a["valid"]["bce"] - b["valid"]["bce"]) < 1e-6
    for x, y in zip(_leaves(ta.params), _leaves(tb.params)):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)
    sa = tr._adamw_state(ta.params, ta.optimizer)
    sb = tr._adamw_state(tb.params, tb.optimizer)
    for name in ("exp_avg", "exp_avg_sq"):
        for x, y in zip(sa[name], sb[name]):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)
    assert sa["step"] == sb["step"]
