"""The port's config, host data path, store, resolve_perf, run_train and
CLI against the JAX package.

The quantile transform is held to scikit-learn's QuantileTransformer
exactly (up to 10,000 rows, and above with one RandomState given to both);
the cluster parser, the k-mer counter (native and numpy paths), the mcool
reader and the store to the JAX package's on the fixture of
tests/synth.py: equal arrays.  The CLI runs the verify fixture end to end
on the CPU in a subprocess, and its train sizes equal the JAX store's on
the artifacts it wrote.
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sklearn.preprocessing import QuantileTransformer

from matcha_tpu.data import clusters as jcl
from matcha_tpu.data import kmers as jkm
from matcha_tpu.data import mcool as jmc
from matcha_tpu.data.store import HyperedgeStore as JaxStore
from matcha_tpu.genome import GenomeBins as JaxGenome
from matcha_tpu.models import hypersagnn as jh
from matcha_tpu_torch import pipeline as tpipe
from matcha_tpu_torch.config import Config, load_config
from matcha_tpu_torch.data import clusters as tcl
from matcha_tpu_torch.data import kmers as tkm
from matcha_tpu_torch.data import mcool as tmc
from matcha_tpu_torch.data.store import HyperedgeStore, quantile_transform
from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.models import hypersagnn as th
from matcha_tpu_torch.native import kmer_native

from synth import make_synthetic_dataset, write_chrom_sizes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHROMS, SIZES = ["chr1", "chr2"], [30_000_000, 20_000_000]


def _sklearn(x, random_state=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # n_quantiles > n_samples
        qt = QuantileTransformer(n_quantiles=1000,
                                 output_distribution="uniform",
                                 random_state=random_state)
        return qt.fit_transform(x.reshape(-1, 1)).reshape(-1)


@pytest.mark.parametrize("n", [1, 7, 999, 1000, 10_000, 25_000])
def test_quantile_transform_matches_sklearn(n):
    """Ties (integer counts), a constant column and a heavy tail; above
    10,000 rows both draw the subsample from RandomState(0)."""
    rng = np.random.default_rng(n)
    cols = [rng.integers(2, 40, n), np.full(n, 3.0),
            rng.pareto(1.5, n) + 2.0]
    for x in (c.astype(np.float32) for c in cols):
        if n > 10_000:
            got = quantile_transform(x, np.random.RandomState(0))
            want = _sklearn(x, np.random.RandomState(0))
        else:
            got, want = quantile_transform(x), _sklearn(x)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """The verify fixture (two chromosomes, 3,000 planted clusters) with its
    config; the JAX package's process + kmers artifacts in jax_temp."""
    tmp = tmp_path_factory.mktemp("pipeline")
    genome = GenomeBins(CHROMS, SIZES, 1_000_000)
    cl, mc = make_synthetic_dataset(tmp, genome, np.random.default_rng(3),
                                    n_clusters=3000)
    cfg = {"cluster_path": cl, "mcool_path": mc, "resolution": 1_000_000,
           "chrom_list": CHROMS, "chrom_size": write_chrom_sizes(tmp, genome),
           "temp_dir": str(tmp / "temp"), "max_cluster_size": 25,
           "min_distance": 0, "k-mer_size": [2, 3], "min_freq_cutoff": 2,
           "quantile_cutoff_for_positive": 0.6,
           "quantile_cutoff_for_unlabel": 0.4, "embed_dim": 16,
           "batch_size": 32, "num_batch_per_iter": 20, "stage1_epochs": 1,
           "stage2_epochs": 2}
    (tmp / "config.JSON").write_text(json.dumps(cfg))
    jg = JaxGenome(CHROMS, SIZES, 1_000_000)
    jax_temp = str(tmp / "jax_temp")
    flat, offsets = jcl.parse_clusters(cl, jg, 25)
    jcl.save_edge_list(jax_temp, flat, offsets)
    jmc.save_contacts(jax_temp, *jmc.parse_mcool_contacts(mc, jg))
    jkm.generate_kmers(flat, offsets, [2, 3], max_cluster_size=25,
                       min_distance=0, min_freq_cutoff=2, temp_dir=jax_temp,
                       verbose=False)
    return tmp, cfg, genome, jg, jax_temp


def test_config_loads_every_key_and_refuses_unknown_ones(fixture):
    tmp, cfg, *_ = fixture
    c = load_config(str(tmp / "config.JSON"))
    assert c.kmer_size == [2, 3] and c.embed_dim == 16
    assert c.to_dict().keys() == Config().to_dict().keys()
    with pytest.raises(ValueError, match="unknown config keys"):
        Config.from_dict({**cfg, "not_a_key": 1})


@pytest.mark.parametrize("native", [True, False])
def test_parse_clusters_matches_jax(fixture, native):
    """The native parser (built into _build/) and the Python lines path."""
    tmp, cfg, genome, jg, _ = fixture
    want = jcl._parse_lines(open(cfg["cluster_path"]), jg, 25)
    if native:
        from matcha_tpu_torch.native import cluster_native
        assert cluster_native.available()
        got = tcl.parse_clusters(cfg["cluster_path"], genome, 25)
    else:
        got = tcl._parse_lines(open(cfg["cluster_path"]), genome, 25)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("native", [True, False])
def test_generate_kmers_matches_jax(fixture, native, monkeypatch, tmp_path):
    tmp, cfg, genome, jg, jax_temp = fixture
    if native:
        assert kmer_native.available()
    else:
        monkeypatch.setattr(kmer_native, "available", lambda: False)
    flat, offsets = jcl.load_edge_list(jax_temp)
    got = tkm.generate_kmers(flat, offsets, [2, 3], max_cluster_size=25,
                             min_distance=1, min_freq_cutoff=2,
                             temp_dir=str(tmp_path), verbose=False)
    want = jkm.generate_kmers(flat, offsets, [2, 3], max_cluster_size=25,
                              min_distance=1, min_freq_cutoff=2,
                              verbose=False)
    for k in (2, 3):
        assert len(got[k][0]) > 20
        np.testing.assert_array_equal(got[k][0], want[k][0])
        np.testing.assert_array_equal(got[k][1], want[k][1])
        np.testing.assert_array_equal(
            np.load(tmp_path / f"all_{k}_freq_counter.npy"),
            want[k][1].astype(np.float32))


def test_parse_mcool_contacts_matches_jax(fixture):
    tmp, cfg, genome, jg, jax_temp = fixture
    intra, inter = tmc.parse_mcool_contacts(cfg["mcool_path"], genome)
    for a, b in zip((intra, inter), jmc.load_contacts(jax_temp)):
        assert a.dtype == np.float32 and a.any()
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 5])
def test_store_matches_jax(fixture, seed):
    """Weights, splits and unlabeled sets equal the JAX store's (every k
    has fewer than 10,000 k-mers here, so neither side subsamples)."""
    *_, jax_temp = fixture
    kw = dict(quantile_cutoff_for_positive=0.6,
              quantile_cutoff_for_unlabel=0.4, neg_num=3, seed=seed)
    got = HyperedgeStore.from_temp_dir(jax_temp, [2, 3], **kw)
    want = JaxStore.from_temp_dir(jax_temp, [2, 3], **kw)
    assert got.train_sizes() == want.train_sizes()
    for k in (2, 3):
        for split in ("train", "test"):
            for a, b in zip(getattr(got, split)[k], getattr(want, split)[k]):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.unlabeled[k], want.unlabeled[k])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_save_round_trip(fixture, tmp_path, writer):
    """Both stores built by ``from_temp_dir`` from the same k-mer files;
    one package's ``save`` writes, and its files (the same names as the
    other's ``save`` writes) hold the other package's buckets, array for
    array with their dtypes."""
    *_, jax_temp = fixture
    kw = dict(quantile_cutoff_for_positive=0.6,
              quantile_cutoff_for_unlabel=0.4, neg_num=3, seed=2)
    port = HyperedgeStore.from_temp_dir(jax_temp, [2, 3], **kw)
    jax_store = JaxStore.from_temp_dir(jax_temp, [2, 3], **kw)
    src, other = (port, jax_store) if writer == "port" else (jax_store, port)
    out, ref = tmp_path / "written", tmp_path / "reference"
    src.save(str(out))
    other.save(str(ref))
    assert sorted(os.listdir(out)) == sorted(os.listdir(ref))
    for k in (2, 3):
        for split in ("train", "test"):
            e, w = getattr(other, split)[k]
            for name, want in (("edges", e), ("weights", w)):
                got = np.load(out / f"{split}_{k}_{name}.npy")
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
        got = np.load(out / f"unlabeled_{k}_edges.npy")
        assert got.dtype == other.unlabeled[k].dtype
        np.testing.assert_array_equal(got, other.unlabeled[k])


def test_store_subsample_is_seeded():
    """Above 10,000 k-mers of one size the quantiles come from a subsample
    that the store draws from its seed: two stores of one seed agree."""
    rng = np.random.default_rng(1)
    data = {2: (rng.integers(1, 500, (12_000, 2)),
                rng.integers(2, 60, 12_000).astype(np.float32))}
    kw = dict(quantile_cutoff_for_positive=0.6,
              quantile_cutoff_for_unlabel=0.4, neg_num=3, seed=4)
    a, b = HyperedgeStore(data, **kw), HyperedgeStore(data, **kw)
    np.testing.assert_array_equal(a.train[2][1], b.train[2][1])
    np.testing.assert_array_equal(a.unlabeled[2], b.unlabeled[2])


def test_build_frozen_tables_bf16_matches_jax(fixture):
    *_, jax_temp = fixture
    genome = GenomeBins(CHROMS, SIZES, 1_000_000)
    intra, inter = jmc.load_contacts(jax_temp)
    got = th.build_frozen_tables(genome, intra, inter,
                                 table_dtype=torch.bfloat16, device="cpu")
    want = jh.build_frozen_tables(JaxGenome(CHROMS, SIZES, 1_000_000), intra,
                                  inter, table_dtype=jnp.bfloat16)
    pairs = list(zip(got.features, want.features)) + [
        (got.inter_z, want.inter_z), (got.attr_table, want.attr_table)]
    for a, b in pairs:
        b = np.asarray(b)
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(a.float().numpy(),
                                      b.astype(np.float32))


@pytest.mark.parametrize("device,want", [
    ("cpu", ("float32", "hybrid", "xla", "off")),
    ("cuda", ("bfloat16", "merged", "xla", "off")),
    ("cuda:0", ("bfloat16", "merged", "xla", "off"))])
def test_resolve_perf_auto_follows_the_named_device(device, want):
    """No card is needed: resolve_perf follows the device it is given."""
    r = tpipe.resolve_perf(Config(), device, apply=False)
    assert (r["compute_dtype"], r["token_stream"], r["propose_impl"],
            r["fuse_tail"]) == want


def test_resolve_perf_explicit_values_win():
    c = Config(compute_dtype="float32", token_stream="padded",
               propose_impl="pallas", fuse_tail="on",
               use_pallas_attention="off")
    for device in ("cpu", "cuda"):
        r = tpipe.resolve_perf(c, device, apply=False)
        assert (r["compute_dtype"], r["token_stream"], r["propose_impl"],
                r["fuse_tail"]) == ("float32", "padded", "pallas", "on")
        assert "use_pallas_attention" not in r   # accepted, no effect


@pytest.mark.parametrize("fuse_tail,env,want", [
    ("auto", None, False), ("auto", "1", True), ("off", "1", False),
    ("on", None, True)])
def test_resolve_perf_fuse_tail_precedence(monkeypatch, fuse_tail, env,
                                           want):
    """Under "auto" a MATCHA_FUSE_TAIL in the environment wins (read at the
    first forward); an explicit config value wins over the environment."""
    monkeypatch.setattr(th, "_FUSE_TAIL", None)
    if env is None:
        monkeypatch.delenv("MATCHA_FUSE_TAIL", raising=False)
    else:
        monkeypatch.setenv("MATCHA_FUSE_TAIL", env)
    tpipe.resolve_perf(Config(fuse_tail=fuse_tail), "cpu")
    assert th._fuse_tail_enabled() is want


def test_pin_budget_and_device_epochs_from_the_environment(monkeypatch):
    """MATCHA_PIN_BUDGET_MB sets pin_base_buckets' budget and
    MATCHA_DEVICE_EPOCHS overrides fit's "auto", as in the JAX package."""
    from matcha_tpu_torch.data.batcher import BucketedBatcher
    from matcha_tpu_torch.sampler.negative import ChromTable
    from matcha_tpu_torch.train import runtime as tr
    genome = GenomeBins(CHROMS, SIZES, 1_000_000)
    dims = th.ModelDims(dim=16, n_head=4, num_chroms=2,
                        num_nodes=genome.num_nodes)
    n = genome.num_nodes
    frozen = th.build_frozen_tables(genome, np.eye(n, dtype=np.float32),
                                    np.zeros((n, n), np.float32),
                                    device="cpu")
    params = th.init_model(torch.Generator().manual_seed(0), dims,
                           [int(e - s) for s, e in genome.chrom_range],
                           device="cpu")
    trainer = tr.Trainer(params, frozen, dims,
                         ChromTable.from_genome(genome, device="cpu"),
                         tr.TrainSettings(alpha=0.0, beta=1.0))
    edges = np.sort(np.random.default_rng(0).choice(
        np.arange(1, n + 1), (64, 2)), axis=1).astype(np.int32)
    batcher = BucketedBatcher({2: (edges, np.ones(64, np.float32))}, 8, 2)
    monkeypatch.setenv("MATCHA_PIN_BUDGET_MB", "0")
    assert not trainer.pin_base_buckets(batcher)
    monkeypatch.delenv("MATCHA_PIN_BUDGET_MB")
    assert trainer.pin_base_buckets(batcher)
    monkeypatch.setenv("MATCHA_DEVICE_EPOCHS", "sometimes")
    with pytest.raises(ValueError, match="device_epochs"):
        trainer.fit({2: (edges, np.ones(64, np.float32))}, {}, epochs=1)


def test_cli_all_on_the_cpu_matches_the_jax_store(fixture):
    """python -m matcha_tpu_torch all -c config.JSON --device cpu: exits 0,
    writes the artifacts, and its train sizes equal the JAX store's on the
    k-mer artifacts it wrote."""
    tmp, cfg, *_ = fixture
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "matcha_tpu_torch", "all",
                          "-c", str(tmp / "config.JSON"), "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    temp = tmp / "temp"
    for path in ("model2load/params.pkl", "model2load/meta.pkl",
                 "model.chkpt", "resume_stage2", "logs/metrics.jsonl",
                 "all_3_counter.npy", "intra_adj.npy"):
        assert (temp / path).exists(), path
    n_nodes = GenomeBins(CHROMS, SIZES, 1_000_000).num_nodes
    assert np.load(tmp / "embeddings.npy").shape == (n_nodes, 16)
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("train sizes: ")]
    want = JaxStore.from_temp_dir(str(temp), [2, 3],
                                  quantile_cutoff_for_positive=0.6,
                                  quantile_cutoff_for_unlabel=0.4,
                                  neg_num=3).train_sizes()
    assert lines == [f"train sizes: {want}"]
    assert "'compute_dtype': 'float32'" in res.stdout
    epochs = [json.loads(ln) for ln in
              (temp / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [e["stage"] for e in epochs] == ["stage1_recon"] + [
        "stage2_classify"] * 2


def test_cli_train_on_cuda_raises_without_a_card(fixture, monkeypatch):
    tmp, *_ = fixture
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.main(["train", "-c", str(tmp / "config.JSON")])
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        tpipe.run_train(Config(mesh_data=2), "cpu")
