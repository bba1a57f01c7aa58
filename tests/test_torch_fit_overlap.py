"""The port's overlapped Trainer.fit pipeline against its serial loop.

The overlapped fit (MATCHA_FIT_OVERLAP, default on for indexed epochs)
dispatches every device operation in the serial order and moves only the
host work of epoch N (fetches, logging, checkpoint and resume pickles, the
embeddings file) onto a worker thread while epoch N+1 runs, so its results
must equal the serial loop's bit for bit (tolerance 0): the history's
losses, metrics and sampler rates, the final params, the best checkpoint,
each resume snapshot and each embeddings file, as
``tests/test_indexed_epochs.py::test_fit_overlap_matches_serial_indexed``
holds the JAX package's.  The params come from the JAX package's
``init_model`` carried across, as in ``test_torch_fit.py``.  Also: the
pinned eval equals ``eval_epoch`` bit for bit, a resume from an overlapped
snapshot equals the uninterrupted run, a failing write in the worker raises
out of ``fit``, and ``profile_dir`` writes a trace of epoch 1.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax

from matcha_tpu.genome import GenomeBins
from matcha_tpu.models import hypersagnn as jh
from matcha_tpu_torch.interop import params_from_numpy
from matcha_tpu_torch.models import hypersagnn as th
from matcha_tpu_torch.sampler.bloom import build_bloom_dict
from matcha_tpu_torch.sampler.negative import ChromTable
from matcha_tpu_torch.train import runtime as tr

SETTINGS = dict(alpha=1.0, beta=0.001, neg_num=2, max_trials=4,
                extra_rounds=4, token_stream="merged")
FIT = dict(batch_size=8, num_batch_per_iter=2, log=lambda *_: None, seed=2)


def _buckets(rng, n, n_edges, ks):
    out = {}
    for k in ks:
        e = np.stack([np.sort(rng.choice(np.arange(1, n + 1), k,
                                         replace=False))
                      for _ in range(n_edges)]).astype(np.int32)
        out[k] = (e, rng.random(n_edges).astype(np.float32) + 0.5)
    return out


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(21)
    genome = GenomeBins(["chr1", "chr2"], [20_000_000, 14_000_000],
                        1_000_000)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    intra = intra + intra.T
    inter = rng.random((n, n)).astype(np.float32)
    kw = dict(dim=16, n_head=4, num_chroms=2, num_nodes=n)
    sizes = [int(e - s) for s, e in genome.chrom_range]
    jp = jh.init_model(jax.random.PRNGKey(0), jh.ModelDims(**kw), sizes)
    train_b = _buckets(rng, n, 60, (2, 3))
    test_b = _buckets(rng, n, 16, (2, 3, 4))
    return {"genome": genome, "train": train_b, "test": test_b,
            "params": params_from_numpy(
                jax.tree_util.tree_map(np.asarray, jp), "cpu"),
            "frozen": th.build_frozen_tables(genome, intra, inter,
                                             device="cpu"),
            "dims": th.ModelDims(**kw),
            "table": ChromTable.from_genome(genome, device="cpu"),
            "blooms": build_bloom_dict(
                {k: v[0] for k, v in {**test_b, **train_b}.items()},
                device="cpu")}


def _trainer(p, seed=2):
    return tr.Trainer(p["params"], p["frozen"], p["dims"], p["table"],
                      tr.TrainSettings(**SETTINGS), blooms=p["blooms"],
                      seed=seed)


def _np(tree):
    return [t.detach().numpy() for t in tr._leaves(tree)]


def _same_tree(a, b):
    """Two pickled checkpoint values hold the same values and types."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _run(p, tmp_path, monkeypatch, overlap, epochs=3):
    """A 3-epoch fit with a checkpoint, resume snapshots and embeddings;
    every embeddings file written is kept (np.save is wrapped)."""
    monkeypatch.setenv("MATCHA_FIT_OVERLAP", "1" if overlap else "0")
    tag = "ov" if overlap else "ser"
    embs = []
    real_save = np.save

    def keep(path, arr, *a, **kw):
        embs.append(np.array(arr))
        real_save(path, arr, *a, **kw)
    snaps = []
    real_write = tr._write_checkpoint

    def keep_ckpt(path, *args):
        real_write(path, *args)
        snaps.append((os.path.basename(path), _load(path)))
    monkeypatch.setattr(tr.np, "save", keep)
    monkeypatch.setattr(tr, "_write_checkpoint", keep_ckpt)
    t = _trainer(p)
    hist = t.fit(p["train"], p["test"], epochs=epochs,
                 checkpoint_path=str(tmp_path / f"ck_{tag}.pkl"),
                 resume_path=str(tmp_path / f"resume_{tag}.snap"),
                 embeddings_path=str(tmp_path / f"emb_{tag}.npy"), **FIT)
    monkeypatch.setattr(tr.np, "save", real_save)
    monkeypatch.setattr(tr, "_write_checkpoint", real_write)
    return t, hist, embs, snaps


def test_overlapped_fit_equals_serial_bit_for_bit(problem, tmp_path,
                                                  monkeypatch):
    t_s, h_s, e_s, c_s = _run(problem, tmp_path, monkeypatch, False)
    t_o, h_o, e_o, c_o = _run(problem, tmp_path, monkeypatch, True)
    assert len(h_s) == len(h_o) == 3
    for a, b in zip(h_s, h_o):
        for part in ("train", "valid"):
            for key in ("bce", "recon", "metrics", "fallback_bloom_rate",
                        "fallback_orig_rate"):
                assert a[part][key] == b[part][key], (part, key)
    for a, b in zip(_np(t_s.params), _np(t_o.params)):
        np.testing.assert_array_equal(a, b)
    # every checkpoint and resume snapshot, in the order written
    assert [n.split("_")[0] for n, _ in c_s] == \
        [n.split("_")[0] for n, _ in c_o]
    assert sum(n.startswith("resume") for n, _ in c_o) == 3
    for (_, a), (_, b) in zip(c_s, c_o):
        _same_tree(a, b)
    _same_tree(_load(tmp_path / "ck_ser.pkl"), _load(tmp_path / "ck_ov.pkl"))
    # the embeddings files: the params at the start of epochs 0, 1, 2
    assert len(e_s) == len(e_o) == 3
    for a, b in zip(e_s, e_o):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert t_s.generator.get_state().equal(t_o.generator.get_state())


def test_pinned_eval_equals_eval_epoch(problem):
    """The pool on the device and the per-epoch index draw give
    eval_epoch's result bit for bit, from two Trainers in one state."""
    a, b = _trainer(problem), _trainer(problem)
    for seed in (0, 5):
        ref = a.eval_epoch(problem["test"], batch_size=10, seed=seed)
        pinned = b._pin_eval_pool(problem["test"], 10)
        got = b._finish_eval(b.eval_epoch_pinned_launch(pinned, seed=seed))
        assert got == ref
        assert set(got["metrics"]) == {"all", 2, 3, 4}
    assert a.generator.get_state().equal(b.generator.get_state())
    empty = {2: (np.zeros((0, 2), np.int32), np.zeros(0, np.float32))}
    assert b._pin_eval_pool(empty, 10) is None
    assert np.isnan(b._finish_eval(None)["bce"])


def test_resume_from_an_overlapped_snapshot(problem, tmp_path, monkeypatch):
    """Overlapped epochs 0-1 with snapshots, then a fresh Trainer resumes:
    its epochs 2-3 equal the uninterrupted overlapped run's."""
    monkeypatch.setenv("MATCHA_FIT_OVERLAP", "1")
    full = _trainer(problem)
    h_full = full.fit(problem["train"], problem["test"], epochs=4, **FIT)
    snap = str(tmp_path / "b.snap")
    _trainer(problem).fit(problem["train"], problem["test"], epochs=2,
                          resume_path=snap, **FIT)
    resumed = _trainer(problem)
    h_res = resumed.fit(problem["train"], problem["test"], epochs=4,
                        resume_path=snap, resume=True, **FIT)
    assert len(h_res) == 2
    for a, b in zip(h_full[2:], h_res):
        for part in ("train", "valid"):
            for key in ("bce", "recon", "metrics"):
                assert a[part][key] == b[part][key]
    for a, b in zip(_np(full.params), _np(resumed.params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("overlap", [True, False])
def test_a_failing_checkpoint_write_raises_out_of_fit(problem, tmp_path,
                                                      monkeypatch, overlap):
    """The checkpoint's directory cannot be made (a file stands there): the
    write fails on the worker thread (or in the serial loop) and fit raises
    it; the log lines of the epochs before the failure keep their order."""
    monkeypatch.setenv("MATCHA_FIT_OVERLAP", "1" if overlap else "0")
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    lines = []
    with pytest.raises(OSError):
        _trainer(problem).fit(problem["train"], problem["test"], epochs=3,
                              checkpoint_path=str(blocker / "ck.pkl"),
                              **{**FIT, "log": lines.append})
    assert len(lines) == 2
    assert lines[0].startswith("[epoch 0] train bce")
    assert lines[1].startswith("[epoch 0] valid bce")


@pytest.mark.parametrize("overlap", [True, False])
def test_profile_dir_traces_epoch_one(problem, tmp_path, monkeypatch,
                                      overlap):
    """One trace per run, and it holds epoch 1's eval as well as its
    training whether or not the epochs overlap (the eval dispatch is marked
    with a span here)."""
    monkeypatch.setenv("MATCHA_FIT_OVERLAP", "1" if overlap else "0")
    launch_eval = tr.Trainer._launch_eval

    def marked(self, *args, **kw):
        with torch.profiler.record_function("eval_dispatch"):
            return launch_eval(self, *args, **kw)
    monkeypatch.setattr(tr.Trainer, "_launch_eval", marked)
    lines = []
    prof = tmp_path / "prof"
    _trainer(problem).fit(problem["train"], problem["test"], epochs=2,
                          profile_dir=str(prof),
                          **{**FIT, "log": lines.append})
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    assert os.path.getsize(prof / traces[0]) > 0
    text = (prof / traces[0]).read_text()
    assert "eval_dispatch" in text
    assert [ln.split("]")[0] for ln in lines] == [
        "[epoch 0", "[epoch 0", "[epoch 1", "[epoch 1"]


def test_log_lines_keep_the_serial_order(problem, monkeypatch):
    lines = {}
    for overlap in (False, True):
        monkeypatch.setenv("MATCHA_FIT_OVERLAP", "1" if overlap else "0")
        got = []
        _trainer(problem).fit(problem["train"], problem["test"], epochs=3,
                              **{**FIT, "log": got.append})
        # the rate and elapsed time are host clocks; the rest must agree
        lines[overlap] = [ln.split(" (")[0] for ln in got]
    assert lines[True] == lines[False]
    assert len(lines[True]) == 6


def test_regress_and_host_epochs_stay_serial(problem, monkeypatch):
    """The gate: the regress mode and the host batcher path take the serial
    loop (no pinned eval pool is made), as in the JAX package."""
    monkeypatch.setenv("MATCHA_FIT_OVERLAP", "1")
    calls = []
    for kw, fit_kw in ((dict(task_mode="regress"), {}),
                       ({}, dict(device_epochs="off"))):
        t = tr.Trainer(problem["params"], problem["frozen"], problem["dims"],
                       problem["table"],
                       tr.TrainSettings(**{**SETTINGS, **kw}),
                       blooms=problem["blooms"], seed=2)
        monkeypatch.setattr(t, "_pin_eval_pool",
                            lambda *a, **k: calls.append(1))
        hist = t.fit(problem["train"], problem["test"], epochs=1,
                     **{**FIT, **fit_kw})
        assert len(hist) == 1 and np.isfinite(hist[0]["train"]["bce"])
    assert calls == []
