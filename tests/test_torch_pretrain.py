"""Walk pretraining end to end in the port, against the JAX package where
the draws agree.

- ``init_model(embedding_mode="table", table_init=...)`` gives the JAX
  package's table exactly (tolerance 0).
- The table-mode forward and ``forward_buckets`` (with their recon, 0 in
  table mode) of the JAX params carried across match the JAX package's at
  1e-5 (f32 sums in another order), and a table-mode stage-2 epoch trains on
  the CPU.
- ``pretrain_node_embeddings`` in both walk modes on the CPU: the shapes of
  ``tests/test_pretrain.py`` and a falling SGNS loss (random streams differ
  from JAX's, so only in behaviour).
- ``python -m matcha_tpu_torch pretrain --device cpu`` on the verify
  skill's fixture writes ``walk_embeddings.npy``; without a card the default
  ``cuda`` raises.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from matcha_tpu.models import hypersagnn as jh
from matcha_tpu_torch import pipeline as tpipe
from matcha_tpu_torch.data.clusters import save_edge_list
from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.interop import params_from_numpy
from matcha_tpu_torch.models import hypersagnn as th
from matcha_tpu_torch.sampler.bloom import build_bloom_dict
from matcha_tpu_torch.sampler.negative import ChromTable
from matcha_tpu_torch.train import runtime as tr
from matcha_tpu_torch.walks.pretrain import pretrain_node_embeddings

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from synth import make_synthetic_dataset  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _two_communities(rng, n, n_edges=300):
    comm = rng.integers(0, 2, n + 1)
    edges = []
    for _ in range(n_edges):
        members = np.flatnonzero(comm[1:] == rng.integers(0, 2)) + 1
        if len(members) >= 3:
            edges.append(sorted(rng.choice(members, 3, replace=False)))
    return edges


@pytest.fixture(scope="module")
def table_problem():
    rng = np.random.default_rng(0)
    genome = GenomeBins(["chr1", "chr2"], [19_000_000, 11_000_000],
                        1_000_000)
    n = genome.num_nodes
    emb = rng.standard_normal((n, 16)).astype(np.float32) * 0.1
    kw = dict(dim=16, n_head=4, num_chroms=2, num_nodes=n)
    sizes = [int(e - s) for s, e in genome.chrom_range]
    intra = rng.random((n, n)).astype(np.float32)
    inter = rng.random((n, n)).astype(np.float32)
    jp = jh.init_model(jax.random.PRNGKey(0), jh.ModelDims(**kw), sizes,
                       embedding_mode="table", table_init=emb)
    return dict(genome=genome, n=n, emb=emb, kw=kw, sizes=sizes, jp=jp,
                jf=jh.build_frozen_tables(genome, intra + intra.T, inter),
                tf=th.build_frozen_tables(genome, intra + intra.T, inter,
                                          device="cpu"))


def test_init_model_table_init_is_jax_exactly(table_problem):
    p = table_problem
    got = th.init_model(torch.Generator().manual_seed(0),
                        th.ModelDims(**p["kw"]), p["sizes"],
                        embedding_mode="table", device="cpu",
                        table_init=p["emb"].astype(np.float64))
    table = got["embed"]["table"]
    assert table.dtype == torch.float32 and table.shape == (p["n"] + 1, 16)
    np.testing.assert_array_equal(table.numpy(),
                                  np.asarray(p["jp"]["embed"]["table"]))
    assert (table[0] == 0).all()
    # without table_init: N(0, 0.02^2) draws, row 0 zero
    drawn = th.init_model(torch.Generator().manual_seed(0),
                          th.ModelDims(**p["kw"]), p["sizes"],
                          embedding_mode="table", device="cpu")
    t = drawn["embed"]["table"]
    assert (t[0] == 0).all() and 0.01 < float(t[1:].std()) < 0.03


def test_table_mode_forward_matches_jax(table_problem):
    p = table_problem
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, p["jp"]),
                           "cpu")
    td, jd = th.ModelDims(**p["kw"]), jh.ModelDims(**p["kw"])
    rng = np.random.default_rng(1)
    x = np.stack([np.sort(rng.choice(np.arange(1, p["n"] + 1), 4,
                                     replace=False)) for _ in range(24)])
    x[:6, 3] = 0                                         # padded rows
    got = th.forward(tp, p["tf"], td, torch.from_numpy(x.astype(np.int32)))
    ref = np.asarray(jh.forward(p["jp"], p["jf"], jd,
                                jnp.asarray(x, jnp.int32)))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    xs = {k: np.stack([np.sort(rng.choice(np.arange(1, p["n"] + 1), k,
                                          replace=False))
                       for _ in range(12)]).astype(np.int32)
          for k in (2, 3)}
    lg_t, rec_t = th.forward_buckets(
        tp, p["tf"], td, {k: torch.from_numpy(v) for k, v in xs.items()},
        return_recon=True, generator=torch.Generator().manual_seed(0))
    lg_j, rec_j = jh.forward_buckets(
        p["jp"], p["jf"], jd, {k: jnp.asarray(v) for k, v in xs.items()},
        return_recon=True, key=jax.random.PRNGKey(0))
    assert float(rec_t) == float(rec_j) == 0.0
    for k in xs:
        np.testing.assert_allclose(lg_t[k].numpy(), np.asarray(lg_j[k]),
                                   rtol=1e-5, atol=1e-5)


def test_table_mode_trains_a_stage2_epoch(table_problem):
    p = table_problem
    rng = np.random.default_rng(2)
    buckets = {k: (np.stack([np.sort(rng.choice(np.arange(1, p["n"] + 1), k,
                                                replace=False))
                             for _ in range(40)]).astype(np.int32),
                   np.ones(40, np.float32)) for k in (2, 3)}
    params = th.init_model(torch.Generator().manual_seed(0),
                           th.ModelDims(**p["kw"]), p["sizes"],
                           embedding_mode="table", device="cpu",
                           table_init=p["emb"])
    t = tr.Trainer(params, p["tf"], th.ModelDims(**p["kw"]),
                   ChromTable.from_genome(p["genome"], device="cpu"),
                   tr.TrainSettings(alpha=1.0, beta=0.001, neg_num=2,
                                    max_trials=4, token_stream="merged"),
                   blooms=build_bloom_dict({k: v[0]
                                            for k, v in buckets.items()},
                                           device="cpu"), seed=0)
    before = t.params["embed"]["table"].detach().clone()
    hist = t.fit(buckets, buckets, epochs=1, batch_size=8,
                 num_batch_per_iter=3, log=lambda *_: None)
    assert np.isfinite(hist[0]["train"]["bce"])
    assert hist[0]["train"]["recon"] == 0.0
    assert not torch.equal(before, t.params["embed"]["table"])


@pytest.mark.parametrize("mode", ["hyper", "clique"])
def test_pretrain_node_embeddings_on_the_cpu(mode):
    rng = np.random.default_rng(0)
    n = 20
    edges = _two_communities(rng, n)
    timings = {}
    emb, losses = pretrain_node_embeddings(
        n, edges, dim=16, walk_mode=mode, num_walks=5, walk_length=10,
        window=3, epochs=2, seed=0, device="cpu", timings=timings)
    assert emb.shape == (n, 16) and np.isfinite(emb).all()
    assert losses.shape == (2,) and losses[-1] < losses[0]
    assert "sgns_s" in timings and ("simulate_s" in timings) == (
        mode == "hyper")


def test_cli_pretrain_on_the_cpu_writes_walk_embeddings(tmp_path):
    """The verify skill's fixture (two chromosomes, 3,000 planted clusters)
    parsed by the port's process stage, then ``pretrain --device cpu`` in
    a subprocess with the JAX package's defaults."""
    genome = GenomeBins(["chr1", "chr2"], [30_000_000, 20_000_000],
                        1_000_000)
    cl, _ = make_synthetic_dataset(tmp_path, genome,
                                   np.random.default_rng(3),
                                   n_clusters=3000)
    from matcha_tpu_torch.data.clusters import parse_clusters
    temp = tmp_path / "temp"
    genome.save(str(temp))
    save_edge_list(str(temp), *parse_clusters(cl, genome, 25))
    cfg = tmp_path / "config.JSON"
    cfg.write_text(json.dumps({"temp_dir": str(temp), "embed_dim": 16,
                               "resolution": 1_000_000,
                               "chrom_list": ["chr1", "chr2"]}))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "matcha_tpu_torch",
                          "pretrain", "-c", str(cfg), "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    emb = np.load(temp / "walk_embeddings.npy")
    assert emb.shape == (genome.num_nodes, 16) and emb.dtype == np.float32
    assert np.isfinite(emb).all()
    assert "skip-gram losses per epoch: [" in res.stdout
    assert "pretrain timings: {" in res.stdout


def test_cli_pretrain_on_cuda_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "config.JSON"
    cfg.write_text(json.dumps({"temp_dir": str(tmp_path / "temp")}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.main(["pretrain", "-c", str(cfg)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_node_embeddings(4, [[1, 2], [2, 3]], 4)
