"""The port's metrics, eval, checkpoints and Trainer.fit against the JAX
package and scikit-learn.

Metrics: scikit-learn's roc_auc_score / average_precision_score at 1e-6
(the port sums in float64) and JAX's _group_metrics_device (f32 sums) at
1e-5.  eval_epoch with stage-1 semantics (negatives are copies, so no random
draw enters the predictions) on the same params and rows: predictions and
bce at 1e-5.  Checkpoints: a port checkpoint's params load in JAX's
load_checkpoint, and a JAX checkpoint written without an optimizer state
loads in the port.  fit: the empty-bucket drop, the best-AUPRC checkpoint and
its reload, the checkpoints, resume snapshots and embeddings file it
writes, a failing write raised out of it, a profile of epoch 1, its log
order, a resumed stage equal bit for bit to the uninterrupted one, and the
indexed and host epoch paths on one trajectory.  Last, a two-stage fit of
each package from the same params on a learnable problem (hyperedges of
nearby bins): their random streams differ, so the final validation AUROC of
the largest k is held to within 0.15 of JAX's, both above 0.75.
"""

import json
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from sklearn.metrics import average_precision_score, roc_auc_score

from matcha_tpu.genome import GenomeBins
from matcha_tpu.models import hypersagnn as jh
from matcha_tpu.sampler.bloom import build_bloom_dict as jbuild
from matcha_tpu.sampler.negative import ChromTable as JTable
from matcha_tpu.train import metrics as jm
from matcha_tpu.train import runtime as jr
from matcha_tpu_torch.interop import params_from_numpy
from matcha_tpu_torch.models import hypersagnn as th
from matcha_tpu_torch.sampler.bloom import build_bloom_dict as tbuild
from matcha_tpu_torch.sampler.negative import ChromTable as TTable
from matcha_tpu_torch.train import metrics as tm
from matcha_tpu_torch.train import runtime as tr
from matcha_tpu_torch.train.logging import MetricsLogger


# ----------------------------------------------------------------- metrics
def _metric_case(case):
    rng = np.random.default_rng(0)
    m = 1536
    if case == "one_class":
        return np.ones(m, np.float32), rng.random(m).astype(np.float32)
    y = (rng.random(m) < 0.3).astype(np.float32)
    if case == "ties":
        return y, rng.choice([0.0, 0.25, 0.5, 0.75, 1.0], m).astype(
            np.float32)
    return y, rng.random(m).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "ties", "one_class"])
def test_group_metrics_match_sklearn_and_jax(case):
    y, p = _metric_case(case)
    got = tm._group_metrics_device(torch.from_numpy(p),
                                   torch.from_numpy(y)).numpy()
    ref_j = np.asarray(jm._group_metrics_device(jnp.asarray(p),
                                                jnp.asarray(y)))
    assert got[3] == y.sum() == ref_j[3]
    assert got[2] == pytest.approx(((p >= 0.5) == (y > 0.5)).mean(),
                                   abs=1e-12)
    if case == "one_class":
        assert np.isnan(got[0]) and np.isnan(ref_j[0])
        assert not np.isnan(got[1])   # AP is defined with positives
    else:
        assert got[0] == pytest.approx(roc_auc_score(y, p), abs=1e-6)
        assert got[0] == pytest.approx(ref_j[0], abs=1e-5)
    assert got[1] == pytest.approx(average_precision_score(y, p), abs=1e-6)
    assert got[1] == pytest.approx(ref_j[1], abs=1e-5)


def test_size_stratified_metrics_match_jax():
    """Per-size groups over several steps: the port's device function and
    its host form against the JAX package's scikit-learn path."""
    rng = np.random.default_rng(1)
    P = 512
    y = np.concatenate([np.ones(P // 4), np.zeros(3 * P // 4)])
    sizes = np.tile(np.repeat([2, 3, 4, 5], P // 16), 4)
    preds = rng.random((3, P)).astype(np.float32)
    ref = jm.size_stratified_metrics(np.tile(y, 3), preds.reshape(-1),
                                     np.tile(sizes, 3))
    fn = tm.device_metrics_fn(y, sizes)
    dev = tm.metrics_from_device(fn(torch.from_numpy(preds)), fn.group_sizes,
                                 3)
    host = tm.size_stratified_metrics(np.tile(y, 3),
                                      torch.from_numpy(preds.reshape(-1)),
                                      np.tile(sizes, 3))
    for got in (dev, host):
        assert set(got) == set(ref)
        for g in ref:
            for key in ("auroc", "auprc", "acc"):
                assert got[g][key] == pytest.approx(ref[g][key], abs=1e-6)
            assert got[g]["n"] == ref[g]["n"]
    assert tm.format_metrics(host)[1] == jm.format_metrics(ref)[1]
    assert tm.format_metrics({}) == ("n/a",) * 3


# ------------------------------------------------------------------ logger
def test_logger_writes_jsonl(tmp_path):
    mlog = MetricsLogger(str(tmp_path))
    train = {"bce": 0.5, "recon": 1.0, "hyperedges_per_sec": 1234.0,
             "metrics": {"all": {"auroc": 0.9, "auprc": 0.8, "acc": 0.7}}}
    valid = {"bce": 0.6, "recon": 1.1,
             "metrics": {"all": {"auroc": 0.85, "auprc": 0.75, "acc": 0.65}}}
    mlog.log_epoch("stage2", 0, train, valid)
    mlog.log_epoch("stage2", 1, train, valid)
    mlog.close()
    lines = (tmp_path / "metrics.jsonl").read_text().strip().split("\n")
    assert len(lines) == 2
    rec = json.loads(lines[0])
    assert rec["stage"] == "stage2" and rec["train_bce"] == 0.5
    assert rec["valid_metrics"]["all"]["auroc"] == 0.85


def test_logger_passes_lines_through():
    msgs = []
    mlog = MetricsLogger(None, stdout=msgs.append)
    mlog("hello")
    assert msgs == ["hello"]
    mlog.log_epoch("s", 0, {"bce": 1, "recon": 1, "metrics": {}},
                   {"bce": 1, "recon": 1, "metrics": {}})   # no file: no-op
    mlog.close()


def test_logger_writes_the_host_split(small, tmp_path):
    """Each epoch's record holds its host time per step by span, its syncs
    (one per size and phase-2 round in a step; one per size for the
    epoch's indices and its one fetch, over its steps), its sampler rounds
    and its kernel launches per step (none on the CPU)."""
    mlog = MetricsLogger(str(tmp_path))
    _trainer(small).fit(small["train"], small["test"], epochs=2,
                        metrics_logger=mlog, **FIT)
    mlog.close()
    recs = [json.loads(ln) for ln in
            (tmp_path / "metrics.jsonl").read_text().strip().split("\n")]
    assert [r["epoch"] for r in recs] == [0, 1]
    for rec in recs:
        host = rec["host"]
        assert host["steps"] == FIT["num_batch_per_iter"]
        assert set(host["ms_per_step"]) == {
            "optimizer", "encode", "sample", "forward", "recon", "loss",
            "backward", "recon_backward", "epoch"}
        assert all(v > 0 for v in host["ms_per_step"].values())
        ks = len(small["train"])
        assert host["syncs_per_step"] == pytest.approx(
            ks + host["rounds_per_step"] + (ks + 1) / host["steps"])
        assert host["sync_wait_ms_per_step"] > 0
        assert host["launches_per_step"] == {
            k: 0.0 for k in ("K1", "K2", "K3", "K4", "K5", "K6_fwd",
                             "K6_bwd", "K7", "K8_fwd", "K8_bwd", "K8_keep")}


# --------------------------------------------------------------- the setup
def _buckets(rng, n, n_edges, ks):
    out = {}
    for k in ks:
        e = np.stack([np.sort(rng.choice(np.arange(1, n + 1), k,
                                         replace=False))
                      for _ in range(n_edges)]).astype(np.int32)
        out[k] = (e, rng.random(n_edges).astype(np.float32) + 0.5)
    return out


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(11)
    genome = GenomeBins(["chr1", "chr2"], [20_000_000, 14_000_000], 1_000_000)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    intra = intra + intra.T
    inter = rng.random((n, n)).astype(np.float32)
    kw = dict(dim=16, n_head=4, num_chroms=2, num_nodes=n)
    sizes = [int(e - s) for s, e in genome.chrom_range]
    jp = jh.init_model(jax.random.PRNGKey(0), jh.ModelDims(**kw), sizes)
    train_b = _buckets(rng, n, 60, (2, 3))
    test_b = _buckets(rng, n, 16, (2, 3, 4))
    return {
        "genome": genome, "train": train_b, "test": test_b,
        "j": (jp, jh.build_frozen_tables(genome, intra, inter),
              jh.ModelDims(**kw), JTable.from_genome(genome)),
        "t": (params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu"),
              th.build_frozen_tables(genome, intra, inter, device="cpu"),
              th.ModelDims(**kw), TTable.from_genome(genome, device="cpu")),
        "blooms": tbuild({k: v[0] for k, v in {**test_b, **train_b}.items()},
                         device="cpu"),
    }


SETTINGS = dict(alpha=1.0, beta=0.001, neg_num=2, max_trials=4,
                extra_rounds=4)
FIT = dict(batch_size=8, num_batch_per_iter=2, log=lambda *_: None, seed=2)


def _trainer(small, blooms=True, **kw):
    tp, tf, td, tt = small["t"]
    return tr.Trainer(tp, tf, td, tt, tr.TrainSettings(**SETTINGS, **kw),
                      blooms=small["blooms"] if blooms else None, seed=2)


def _leaves_np(tree):
    return [t.detach().numpy() for t in tr._leaves(tree)]


# -------------------------------------------------------------------- eval
def test_eval_epoch_matches_jax(small):
    """Stage-1 eval (no filters) of the same params on the same rows: every
    row padded to the largest k, scored with its copies as negatives."""
    jp, jf, jd, jt = small["j"]
    js = jr.Trainer(jp, jf, jd, jt, jr.TrainSettings(**SETTINGS))
    ts = _trainer(small, blooms=False)
    idx = np.random.default_rng(3).permutation(48)
    kw = dict(batch_size=10, max_samples=40, indices=idx, return_pred=True)
    ref = js.eval_epoch(small["test"], **kw)
    got = ts.eval_epoch(small["test"], **kw)
    assert got["pred"].shape == ref["pred"].shape == (4 * 10 * 3,)
    np.testing.assert_allclose(got["pred"], ref["pred"], rtol=1e-5,
                               atol=1e-5)
    assert got["bce"] == pytest.approx(ref["bce"], rel=1e-5, abs=1e-5)
    assert set(got["metrics"]) == set(ref["metrics"]) == {"all", 2, 3, 4}
    for g in ref["metrics"]:
        assert got["metrics"][g]["n"] == ref["metrics"][g]["n"]
    empty = ts.eval_epoch({2: (np.zeros((0, 2), np.int32), np.zeros(0))})
    assert empty["metrics"] == {} and np.isnan(empty["bce"])


# ------------------------------------------------------------- checkpoints
def _plain_types(node):
    if isinstance(node, dict):
        return all(_plain_types(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return all(_plain_types(v) for v in node)
    return node is None or isinstance(node, (np.ndarray, int, float, str))


def test_port_checkpoint_params_load_in_jax(small, tmp_path):
    t = _trainer(small)
    t.fit(small["train"], small["test"], epochs=1, **FIT)
    path = str(tmp_path / "model.chkpt")
    tr.save_checkpoint(path, t.params, t.optimizer, 0, t.generator, 0.5)
    with open(path, "rb") as f:
        raw = pickle.load(f)
    assert _plain_types(raw)
    assert len(raw["opt_state"]["exp_avg"]) == len(tr._leaves(t.params))
    assert raw["opt_state"]["step"][0] == 2.0
    ref = jr.load_checkpoint(path)
    for a, b in zip(jax.tree_util.tree_leaves(ref), _leaves_np(t.params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_jax_checkpoint_without_optimizer_loads_in_port(small, tmp_path):
    jp = small["j"][0]
    path = str(tmp_path / "jax.chkpt")
    jr.save_checkpoint(path, jp, epoch=3)
    got = tr.load_checkpoint(path, full=True, device="cpu")
    assert got["epoch"] == 3 and got["opt_state"] is None
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    _leaves_np(got["params"])):
        np.testing.assert_array_equal(np.asarray(a), b)


# --------------------------------------------------------------------- fit
def test_fit_drops_empty_buckets_and_reloads_the_best(small, tmp_path):
    lines = []
    t = _trainer(small)
    ck, emb = str(tmp_path / "best.chkpt"), str(tmp_path / "emb.npy")
    buckets = {**small["train"], 4: (np.zeros((0, 4), np.int32),
                                     np.zeros(0, np.float32))}
    hist = t.fit(buckets, small["test"], epochs=3, checkpoint_path=ck,
                 embeddings_path=emb, **{**FIT, "log": lines.append})
    assert lines[0] == "dropping empty train buckets: k=[4]"
    assert len(hist) == 3 and sum("valid bce" in s for s in lines) == 3
    aupr = [h["valid"]["metrics"][3]["auprc"] for h in hist]
    best = max(i for i in range(3) if aupr[i] >= max(aupr[:i + 1]))
    saved = tr.load_checkpoint(ck, full=True, device="cpu")
    assert saved["epoch"] == best
    for a, b in zip(_leaves_np(saved["params"]), _leaves_np(t.params)):
        np.testing.assert_array_equal(a, b)
    assert np.load(emb).shape == (small["genome"].num_nodes, 16)
    with pytest.raises(ValueError, match="checkpoint_format"):
        t.fit(buckets, small["test"], epochs=1, checkpoint_path=ck,
              checkpoint_format="zarr", **FIT)
    # "orbax" (the torch.distributed.checkpoint stand-in) takes a directory
    from matcha_tpu_torch.train.checkpoint import OrbaxCheckpointer
    d = str(tmp_path / "orbax")
    t.fit(buckets, small["test"], epochs=1, checkpoint_path=d,
          checkpoint_format="orbax", **FIT)
    assert OrbaxCheckpointer(d).latest_step() == 0


def test_resume_mid_stage_is_exact(small, tmp_path):
    """Stop after epoch 1, resume in a fresh Trainer: epochs 2 and 3 equal
    the uninterrupted run's bit for bit (params, AdamW state, generator and
    batcher ring all restored)."""
    full = _trainer(small)
    hist_a = full.fit(small["train"], small["test"], epochs=4,
                      resume_path=str(tmp_path / "a.snap"), **FIT)
    snap = str(tmp_path / "b.snap")
    _trainer(small).fit(small["train"], small["test"], epochs=2,
                        resume_path=snap, **FIT)
    resumed = _trainer(small)
    hist_b = resumed.fit(small["train"], small["test"], epochs=4,
                         resume_path=snap, resume=True, **FIT)
    assert len(hist_b) == 2
    for a, b in zip(hist_a[2:], hist_b):
        for part in ("train", "valid"):
            assert a[part]["bce"] == b[part]["bce"]
            assert a[part]["recon"] == b[part]["recon"]
            assert a[part]["metrics"] == b[part]["metrics"]
    for a, b in zip(_leaves_np(full.params), _leaves_np(resumed.params)):
        np.testing.assert_array_equal(a, b)
    sa, sb = full.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i in sa["state"]:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][i][key], sb["state"][i][key])


@pytest.mark.parametrize("which", ["checkpoint", "resume"])
def test_fit_checkpoint_and_snapshot_hold_the_epoch_state(small, tmp_path,
                                                          monkeypatch,
                                                          which):
    """Every pickle fit writes, read back through
    ``load_checkpoint(full=True)`` as it is written, holds the Trainer's
    params, AdamW moments and step counts at that epoch; a resume snapshot
    every epoch with the generator's state and the best AUPRC so far, a
    checkpoint the epochs that reach the best, with neither.  The resume
    case writes checkpoints too, so that it has a best to record."""
    t = _trainer(small)
    paths = {"checkpoint_path": str(tmp_path / "checkpoint.pkl")}
    if which == "resume":
        paths["resume_path"] = str(tmp_path / "resume.pkl")
    seen = []
    write = tr._write_checkpoint

    def write_and_check(p, *args):
        write(p, *args)
        if p != paths[f"{which}_path"]:
            return
        got = tr.load_checkpoint(p, full=True, device="cpu")
        for a, b in zip(_leaves_np(got["params"]), _leaves_np(t.params)):
            np.testing.assert_array_equal(a, b)
        opt = got["opt_state"]
        for i, leaf in enumerate(tr._leaves(t.params)):
            st = t.optimizer.state[leaf]
            np.testing.assert_array_equal(opt["exp_avg"][i],
                                          st["exp_avg"].numpy())
            np.testing.assert_array_equal(opt["exp_avg_sq"][i],
                                          st["exp_avg_sq"].numpy())
            assert opt["step"][i] == float(st["step"]) == \
                (got["epoch"] + 1) * FIT["num_batch_per_iter"]
        if which == "resume":
            np.testing.assert_array_equal(got["key"],
                                          t.generator.get_state().numpy())
        else:
            assert got["key"] is None and got["best"] is None
        seen.append((got["epoch"], got["best"]))
    monkeypatch.setattr(tr, "_write_checkpoint", write_and_check)
    hist = t.fit(small["train"], small["test"], epochs=3, **paths, **FIT)
    aupr = [h["valid"]["metrics"][3]["auprc"] for h in hist]
    best = np.maximum.accumulate(aupr)
    if which == "resume":
        assert seen == [(e, pytest.approx(best[e])) for e in range(3)]
    else:
        assert seen == [(e, None) for e in range(3) if aupr[e] >= best[e]]


def test_fit_writes_the_epoch_start_embeddings(small, tmp_path):
    """The embeddings file of a 3-epoch fit holds the node embeddings of
    the params at the start of its last epoch: those of a 2-epoch fit of
    the same Trainer state and seed."""
    emb = str(tmp_path / "emb.npy")
    _trainer(small).fit(small["train"], small["test"], epochs=3,
                        embeddings_path=emb, **FIT)
    two = _trainer(small)
    two.fit(small["train"], small["test"], epochs=2, **FIT)
    want = two.export_embeddings(str(tmp_path / "want.npy"))
    got = np.load(emb)
    assert got.dtype == np.float32
    assert got.shape == (small["genome"].num_nodes, 16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["checkpoint", "resume", "embeddings"])
def test_a_failing_checkpoint_write_raises_out_of_fit(small, tmp_path,
                                                      which):
    """The file's directory cannot be made (a file stands there): the
    write fails and fit raises it; the log lines of the epochs before the
    failure keep their order (the embeddings are written at the top of
    epoch 0, the checkpoint and the snapshot at its end)."""
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    lines = []
    with pytest.raises(OSError):
        _trainer(small).fit(small["train"], small["test"], epochs=3,
                            **{f"{which}_path": str(blocker / "f.pkl")},
                            **{**FIT, "log": lines.append})
    if which == "embeddings":
        assert lines == []
    else:
        assert len(lines) == 2
        assert lines[0].startswith("[epoch 0] train bce")
        assert lines[1].startswith("[epoch 0] valid bce")


def test_profile_dir_traces_epoch_one(small, tmp_path, monkeypatch):
    """One trace per run, and it holds epoch 1's eval as well as its
    training (the eval dispatch is marked with a span here)."""
    launch_eval = tr.Trainer._launch_eval

    def marked(self, *args, **kw):
        with torch.profiler.record_function("eval_dispatch"):
            return launch_eval(self, *args, **kw)
    monkeypatch.setattr(tr.Trainer, "_launch_eval", marked)
    lines = []
    prof = tmp_path / "prof"
    _trainer(small).fit(small["train"], small["test"], epochs=2,
                        profile_dir=str(prof),
                        **{**FIT, "log": lines.append})
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    assert os.path.getsize(prof / traces[0]) > 0
    text = (prof / traces[0]).read_text()
    assert "eval_dispatch" in text
    assert [ln.split("]")[0] for ln in lines] == [
        "[epoch 0", "[epoch 0", "[epoch 1", "[epoch 1"]


def test_log_lines_keep_the_serial_order(small):
    """Each epoch logs its training line, then its validation line."""
    got = []
    _trainer(small).fit(small["train"], small["test"], epochs=3,
                        **{**FIT, "log": got.append})
    assert [ln.split(" bce")[0] for ln in got] == [
        f"[epoch {e}] {part}" for e in range(3)
        for part in ("train", "valid")]


def test_indexed_and_host_epochs_share_one_trajectory(small):
    runs = {}
    for mode in ("off", "on"):
        t = _trainer(small, token_stream="merged")
        runs[mode] = (t.fit(small["train"], small["test"], epochs=2,
                            device_epochs=mode, **FIT), t)
    (h_host, t_host), (h_idx, t_idx) = runs["off"], runs["on"]
    for a, b in zip(_leaves_np(t_host.params), _leaves_np(t_idx.params)):
        np.testing.assert_array_equal(a, b)
    for eh, ei in zip(h_host, h_idx):
        assert eh["train"]["bce"] == ei["train"]["bce"]
        assert eh["train"]["metrics"] == ei["train"]["metrics"]
        assert eh["valid"]["metrics"] == ei["valid"]["metrics"]


def test_two_stage_fit_learns_as_jax_does(monkeypatch):
    """Stage 1 (recon only) then stage 2 against the filters, each package
    from the same initial params.  The port runs this slice's path on the
    CPU: the Pallas-route proposals and the fused tail in train mode."""
    rng = np.random.default_rng(0)
    genome = GenomeBins(["chr1", "chr2"], [40_000_000, 30_000_000], 1_000_000)
    n = genome.num_nodes
    pos = np.arange(n)
    intra = (np.exp(-np.abs(pos[:, None] - pos[None]) / 3.0)
             + 0.05 * rng.random((n, n))).astype(np.float32)
    intra = intra + intra.T
    inter = rng.random((n, n)).astype(np.float32)

    def near(n_edges):
        out = {}
        for k in (2, 3):
            rows = []
            for _ in range(n_edges):
                s, e = genome.chrom_range[rng.integers(0, 2)]
                a = rng.integers(s, e - 5)
                rows.append(np.sort(rng.choice(np.arange(a, a + 5), k,
                                               replace=False)))
            out[k] = (np.asarray(rows, np.int32),
                      rng.random(n_edges).astype(np.float32) + 0.5)
        return out
    train_b, test_b = near(200), near(64)
    kw = dict(dim=16, n_head=4, num_chroms=2, num_nodes=n)
    sizes = [int(e - s) for s, e in genome.chrom_range]
    jp = jh.init_model(jax.random.PRNGKey(0), jh.ModelDims(**kw), sizes)
    common = dict(neg_num=2, max_trials=4, extra_rounds=4,
                  token_stream="merged", learning_rate=3e-3)
    fit = dict(batch_size=16, num_batch_per_iter=8, log=lambda *_: None)

    def two_stages(pkg, trainer, params, frozen, dims, table, blooms, **s):
        t1 = trainer(params, frozen, dims, table, pkg.TrainSettings(
            alpha=0.0, beta=1.0, **common, **s), seed=2)
        t1.fit(train_b, test_b, epochs=1, seed=2, **fit)
        p1 = t1.params if pkg is tr else t1.state.params
        t2 = trainer(p1, frozen, dims, table, pkg.TrainSettings(
            alpha=1.0, beta=0.001, **common, **s), blooms=blooms, seed=3)
        return t2.fit(train_b, test_b, epochs=4, seed=3, **fit)

    ref = two_stages(jr, jr.Trainer, jp,
                     jh.build_frozen_tables(genome, intra, inter),
                     jh.ModelDims(**kw), JTable.from_genome(genome),
                     jbuild({k: v[0] for k, v in train_b.items()}))
    monkeypatch.setattr(th, "_FUSE_TAIL", True)
    got = two_stages(tr, tr.Trainer,
                     params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                              jp), "cpu"),
                     th.build_frozen_tables(genome, intra, inter,
                                            device="cpu"),
                     th.ModelDims(**kw), TTable.from_genome(genome,
                                                            device="cpu"),
                     tbuild({k: v[0] for k, v in train_b.items()},
                            device="cpu"), propose_impl="pallas")
    a_ref = ref[-1]["valid"]["metrics"][3]["auroc"]
    a_got = got[-1]["valid"]["metrics"][3]["auroc"]
    assert a_ref > 0.75 and a_got > 0.75, (a_got, a_ref)
    assert abs(a_got - a_ref) <= 0.15, (a_got, a_ref)
