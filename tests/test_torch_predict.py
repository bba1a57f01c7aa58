"""The port's serving path against the JAX package: bundles, interop and
predict_multiway, on the CPU (device="cpu").

Probabilities agree to atol 1e-5 in f32 (summation order only)."""

import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from matcha_tpu.apps import predict_multiway as jpm
from matcha_tpu.genome import GenomeBins
from matcha_tpu.models import hypersagnn as jh
from matcha_tpu.train import runtime as jrt
from matcha_tpu_torch.apps import predict_multiway as tpm
from matcha_tpu_torch.genome import GenomeBins as TGenomeBins
from matcha_tpu_torch.interop import params_from_numpy, params_to_numpy
from matcha_tpu_torch.models import hypersagnn as th
from matcha_tpu_torch.train import runtime as trt

# the small bundle of tests/test_apps.py
CHROMS, SIZES, RES = ["chr1", "chr2"], [14_000_000, 9_000_000], 1_000_000
APPS_LINES = ("chr1:500000\tchr1:3500000\n"
              "chr1:100000\tchr2:200000\tchr2:5000000\n"
              "chrUn:5\tchr1:0\n"
              "chr1:0\tchr1:999999\tchr1:2000001\n")


@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bundle")
    rng = np.random.default_rng(5)
    genome = GenomeBins(CHROMS, SIZES, RES)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    intra = intra + intra.T
    inter = rng.random((n, n)).astype(np.float32)
    dims = jh.ModelDims(dim=16, n_head=4, num_chroms=2, num_nodes=n)
    sizes = [int(e - s) for s, e in genome.chrom_range]
    params = jh.init_model(jax.random.PRNGKey(0), dims, sizes)
    path = str(tmp / "model2load")
    jrt.save_model_bundle(path, params, dims, genome, intra, inter)
    return path, genome


def _mixed_lines(genome, rng, per_k=7):
    """Candidates of k = 2..5 distinct bins over both chromosomes."""
    lines = []
    n = genome.num_nodes
    for k in (2, 3, 4, 5):
        for _ in range(per_k):
            nodes = rng.choice(np.arange(1, n + 1), k, replace=False)
            members = []
            for v in nodes:
                c = int(genome.node2chrom[v])
                b = int(v - genome.chrom_range[c, 0])
                members.append(f"{genome.chrom_names[c]}:{b * RES + 123}")
            lines.append("\t".join(members))
    rng.shuffle(lines)
    return "\n".join(lines) + "\n"


def test_predict_multiway_matches_jax(jax_bundle, tmp_path):
    path, genome = jax_bundle
    inp = tmp_path / "input.txt"
    inp.write_text(APPS_LINES + _mixed_lines(genome,
                                             np.random.default_rng(7)))
    ref = jpm.run_predict_multiway(path, str(inp), str(tmp_path / "j.txt"),
                                   batch_size=8)
    out = tmp_path / "t.txt"
    got = tpm.run_predict_multiway(path, str(inp), str(out), batch_size=8,
                                   device="cpu")
    assert got.shape == ref.shape == (3 + 28,)
    assert ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.loadtxt(out), got, atol=1e-6)


def test_parse_interaction_file_matches_jax(jax_bundle, tmp_path):
    _, genome = jax_bundle
    inp = tmp_path / "input.txt"
    inp.write_text(APPS_LINES + _mixed_lines(genome,
                                             np.random.default_rng(3)))
    tgenome = TGenomeBins(CHROMS, SIZES, RES)
    got = tpm.parse_interaction_file(str(inp), tgenome)
    assert got == jpm.parse_interaction_file(str(inp), genome)
    assert len(got[:3]) == 3 and got[2] == [1, 3]


def test_cli_main(jax_bundle, tmp_path):
    path, _ = jax_bundle
    inp = tmp_path / "input.txt"
    inp.write_text(APPS_LINES)
    out = tmp_path / "out.txt"
    tpm.main(["-m", path, "-i", str(inp), "-o", str(out), "--device", "cpu"])
    proba = np.loadtxt(out)
    assert proba.shape == (3,) and ((proba > 0) & (proba < 1)).all()


def test_port_bundle_loads_in_jax(tmp_path):
    """A bundle the port writes loads in JAX and scores the same logits."""
    rng = np.random.default_rng(11)
    genome = TGenomeBins(["chr1", "chr2", "chr3"],
                         [12_000_000, 8_000_000, 5_000_000], RES)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    intra = intra + intra.T
    inter = rng.random((n, n)).astype(np.float32)
    dims = th.ModelDims(dim=16, n_head=4, num_chroms=3, num_nodes=n)
    sizes = [int(e - s) for s, e in genome.chrom_range]
    params = th.init_model(torch.Generator().manual_seed(3), dims, sizes,
                           device="cpu")
    path = str(tmp_path / "model2load")
    trt.save_model_bundle(path, params, dims, genome, intra, inter)

    jp, jd, jg, jf = jrt.load_model_bundle(path)
    assert jd._asdict() == dims._asdict()
    assert jg.chrom_names == genome.chrom_names
    x = np.stack([np.sort(rng.choice(np.arange(1, n + 1), 4, replace=False))
                  for _ in range(12)]).astype(np.int32)
    tp2, td2, _, tf2 = trt.load_model_bundle(path, device="cpu")
    got = th.forward(tp2, tf2, td2, torch.from_numpy(x))
    ref = jh.forward(jp, jf, jd, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_params_roundtrip_is_exact(jax_bundle):
    path, _ = jax_bundle
    with open(f"{path}/params.pkl", "rb") as f:
        tree = pickle.load(f)
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_default_device_raises_without_gpu(jax_bundle, tmp_path,
                                           monkeypatch):
    path, _ = jax_bundle
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inp = tmp_path / "input.txt"
    inp.write_text(APPS_LINES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpm.run_predict_multiway(path, str(inp), str(tmp_path / "o.txt"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.init_model(torch.Generator(), th.ModelDims(dim=16, n_head=4),
                      [5, 6])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.zeros((2, 2), np.float32)})
