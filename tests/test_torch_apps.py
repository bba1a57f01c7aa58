"""The port's apps on a trained bundle against the JAX package's, on the CPU
in f32: the closed-form pair scorer, denoising (its chromosome pass, the
.mcool file and the heatmaps), outlier ranking, the frequency-band files,
the legacy node filter and contact ingest, the subcompartment labels, the
embedding PCA, and the apps' command lines.

One bundle, written by the JAX package with its own random weights, is
loaded by both.  Tolerances: logits 1e-5 against JAX's closed form and
1e-4 / 1e-5 against the port's own forward (tests/test_pairwise_fast.py);
denoised values 1e-5, with ``np.random.seed`` set before each side so
that the quantile transforms' subsamples (one chromosome has more than
10,000 values) draw the same rows: on each package's own scores for the
large chromosome, on the same scores for both (see
test_denoise_chromosome_on_each_scorer_matches_jax); per-position scores
1e-5; the PCA coordinates
1e-4 against scikit-learn's, up to the sign of each component; the rest
exactly.
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

import jax
import torch

from matcha_tpu.apps import analysis_bands as j_bands
from matcha_tpu.apps import denoise_contact as j_dn
from matcha_tpu.apps import outlier as j_out
from matcha_tpu.apps import pairwise_fast as j_pw
from matcha_tpu.apps import plot_embedding as j_plot
from matcha_tpu.data import legacy as j_legacy
from matcha_tpu.genome import GenomeBins as JGenome
from matcha_tpu.models.hypersagnn import (ModelDims, build_frozen_tables,
                                          init_model)
from matcha_tpu.train.runtime import save_model_bundle
from matcha_tpu_torch.apps import analysis_bands as t_bands
from matcha_tpu_torch.apps import denoise_contact as t_dn
from matcha_tpu_torch.apps import outlier as t_out
from matcha_tpu_torch.apps import pairwise_fast as t_pw
from matcha_tpu_torch.apps import plot_embedding as t_plot
from matcha_tpu_torch.apps.predict import (predict_logits,
                                           predict_proba)
from matcha_tpu_torch.data import legacy as t_legacy
from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.train.runtime import load_model_bundle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """chr1 of 111 bins (12,321 matrix values: the quantile transform
    subsamples) and chr2 of 41 bins (1,681 values).  Below 1,000 values
    (32 bins) the transform would be a rank transform, under which the two
    mirror entries of a pair, equal but for the rounding of their two
    normalisations, can trade ranks between the frameworks."""
    tmp = tmp_path_factory.mktemp("bundle")
    rng = np.random.default_rng(5)
    genome = JGenome(["chr1", "chr2"], [110_000_000, 40_000_000], 1_000_000)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    intra = intra + intra.T
    intra[3, :] = 0.0                   # a gap row and column on chr1
    intra[:, 3] = 0.0
    inter = rng.random((n, n)).astype(np.float32)
    dims = ModelDims(dim=16, n_head=4, num_chroms=2, num_nodes=n)
    sizes = [int(e - s) for s, e in genome.chrom_range]
    params = init_model(jax.random.PRNGKey(0), dims, sizes)
    path = str(tmp / "model2load")
    save_model_bundle(path, params, dims, genome, intra, inter)
    j = (params, build_frozen_tables(genome, intra, inter), dims)
    t_params, t_dims, t_genome, t_frozen = load_model_bundle(path, "cpu")
    return {"path": path, "genome": genome, "intra": intra, "j": j,
            "t": (t_params, t_frozen, t_dims), "t_genome": t_genome}


# ------------------------------------------------------------- pairwise_fast
def test_pairwise_logits_match_jax_and_the_forward(bundle):
    nodes = np.arange(100, 119)
    ref = np.asarray(j_pw.pairwise_logits(*bundle["j"], nodes))
    got = t_pw.pairwise_logits(*bundle["t"], nodes)
    assert got.dtype == torch.float32 and got.shape == (19, 19)
    got = got.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # the port's own forward on the explicit pairs, the diagonal included
    pairs = [[int(nodes[i]), int(nodes[j])] for i in range(len(nodes))
             for j in range(i, len(nodes))]
    fwd = predict_logits(*bundle["t"], pairs, batch_size=64)
    idx = [(i, j) for i in range(len(nodes)) for j in range(i, len(nodes))]
    np.testing.assert_allclose([got[i, j] for i, j in idx], fwd, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got, got.T, rtol=1e-5, atol=1e-6)
    proba = t_pw.pairwise_proba_matrix(*bundle["t"], bundle["t_genome"], 1)
    assert proba.dtype == np.float64 and proba.shape == (41, 41)
    np.testing.assert_allclose(
        proba, j_pw.pairwise_proba_matrix(*bundle["j"], bundle["genome"], 1),
        rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------- denoise_contact
@pytest.mark.parametrize("cid, min_dis", [(0, 0), (1, 2), (1, 41)])
def test_generate_pair_wise_and_proba2matrix_match_jax(bundle, cid, min_dis):
    got = t_dn.generate_pair_wise(bundle["t_genome"], cid, min_dis)
    ref = j_dn.generate_pair_wise(bundle["genome"], cid, min_dis)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype
    if len(got):
        proba = np.random.default_rng(cid).random(len(got)).astype("float32")
        np.testing.assert_array_equal(t_dn.proba2matrix(got, proba),
                                      j_dn.proba2matrix(ref, proba))


def _denoise_both(bundle, cid, min_dis, use_fast, seed=17):
    """denoise_chromosome of both packages, np.random.seed(seed) before
    each -> (JAX's outputs, the port's)."""
    outs = []
    for pkg, genome, model in ((j_dn, bundle["genome"], bundle["j"]),
                               (t_dn, bundle["t_genome"], bundle["t"])):
        np.random.seed(seed)
        outs.append(pkg.denoise_chromosome(*model, genome, bundle["intra"],
                                           cid, min_dis, batch_size=2_000,
                                           use_fast=use_fast))
    return outs


def _port_scores_for_jax(bundle, monkeypatch):
    """JAX's denoise scores with the port's scorers (both routes)."""
    port_proba = {c: t_pw.pairwise_proba_matrix(*bundle["t"],
                                                bundle["t_genome"], c)
                  for c in range(2)}
    monkeypatch.setattr(j_pw, "pairwise_proba_matrix",
                        lambda params, frozen, dims, genome, c:
                        port_proba[c])
    monkeypatch.setattr(j_dn, "predict_proba",
                        lambda params, frozen, dims, pairs, batch_size:
                        predict_proba(*bundle["t"], pairs, batch_size))


@pytest.mark.parametrize("cid, use_fast, min_dis", [(0, True, 0),
                                                    (1, True, 2),
                                                    (1, False, 0)])
def test_denoise_chromosome_matches_jax(bundle, monkeypatch, cid, use_fast,
                                        min_dis):
    """The chain after scoring (normalisations, gaps, three quantile
    transforms, the pixels) on the same probabilities: 1e-5."""
    _port_scores_for_jax(bundle, monkeypatch)
    (jp, *jm), (tp, *tm) = _denoise_both(bundle, cid, min_dis, use_fast)
    np.testing.assert_array_equal(tp, jp)
    for a, b in zip(tm, jm):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_fast", [True, False])
def test_denoise_chromosome_on_each_scorer_matches_jax(bundle, use_fast):
    """Each package on its own scorer, on chr1 (12,321 values): 1e-5.  The
    scores differ by ~1e-7, and the quantile transform multiplies that by
    its slope, 1/999 over the gap between neighbouring quantiles; on the
    41-bin chr2 (1,681 values between 0.03 and 0.07 before normalisation)
    that gap is small enough to move a value by up to 1e-3, so there the
    chain is held on the same probabilities (above)."""
    (jp, *jm), (tp, *tm) = _denoise_both(bundle, 0, 0, use_fast)
    np.testing.assert_array_equal(tp, jp)
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_run_denoise_mcool_matches_jax(bundle, tmp_path, monkeypatch):
    """The two .mcool files dataset for dataset; the port's heatmaps.  The
    JAX pass scores with the port's closed form (held to JAX's above), so
    the two files come from the same probabilities (see
    test_denoise_chromosome_on_each_scorer_matches_jax)."""
    _port_scores_for_jax(bundle, monkeypatch)
    files = {}
    for name, run in (("jax", j_dn.run_denoise), ("port", t_dn.run_denoise)):
        kw = {"device": "cpu"} if name == "port" else {}
        np.random.seed(23)
        files[name] = run(bundle["path"], min_distance=1,
                          output_mcool=str(tmp_path / f"{name}.mcool"),
                          plot_dir=str(tmp_path / f"plots_{name}"),
                          batch_size=500, log=lambda *a: None, **kw)
    with h5py.File(files["jax"]) as fj, h5py.File(files["port"]) as ft:
        names = []
        fj.visit(names.append)
        got = []
        ft.visit(got.append)
        assert sorted(got) == sorted(names)
        for n in names:
            if isinstance(fj[n], h5py.Dataset):
                a, b = ft[n][()], fj[n][()]
                assert a.dtype == b.dtype and a.shape == b.shape, n
                if n.endswith("balanced"):
                    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
                else:
                    np.testing.assert_array_equal(a, b)
        bal = ft["resolutions/1000000/pixels/balanced"][()]
        assert np.isfinite(bal).all() and (bal >= 0).all() \
            and (bal <= 1).all()
    for chrom in ("chr1", "chr2"):
        for kind in ("denoise", "origin"):
            assert (tmp_path / "plots_port" / f"{chrom}_{kind}.png").exists()


def test_denoise_skips_a_chromosome_shorter_than_the_gap(bundle):
    logs = []
    bin1, bin2, bal, mats = t_dn.denoise_pixels(
        *bundle["t"], bundle["t_genome"], bundle["intra"], min_distance=41,
        keep_matrices=True, log=logs.append)
    assert any(line.startswith("skipping chr2") for line in logs)
    assert len(bin1) == len(bin2) == len(bal) == 70 * 71 // 2
    assert list(mats) == ["chr1"] and mats["chr1"][0].shape == (111, 111)


# ------------------------------------------------------------------- outlier
def test_per_position_scores_match_jax(bundle):
    x = np.asarray([[1, 5, 9, 12], [2, 4, 6, 0], [111, 113, 119, 0]] * 5,
                   np.int32)
    ref = j_out.per_position_scores(*bundle["j"], x)
    for bs in (10_000, 4):
        got = t_out.per_position_scores(*bundle["t"], x, batch_size=bs)
        assert got.shape == x.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        t_out.rank_outliers(*bundle["t"], x, k=3),
        j_out.rank_outliers(*bundle["j"], x, k=3))


def test_generate_outliers_and_hit_rate_match_jax(bundle):
    edges = np.asarray([[1, 5, 9], [2, 6, 11], [3, 8, 14], [20, 40, 60]],
                       np.int32)
    pairs = {(a, b) for e in edges for a in e for b in e if a != b}
    n = bundle["genome"].num_nodes
    ji, jpts = j_out.generate_outliers(edges, pairs, n,
                                       np.random.default_rng(9), per_edge=6)
    ti, tpts = t_out.generate_outliers(edges, pairs, n,
                                       np.random.default_rng(9), per_edge=6)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tpts, jpts)
    assert ti.dtype == ji.dtype and len(ti) > 0
    hit = t_out.outlier_hit_rate(*bundle["t"], ti, tpts, k=3, batch_size=7)
    np.testing.assert_allclose(
        hit, j_out.outlier_hit_rate(*bundle["j"], ji, jpts, k=3))
    assert hit.shape == (3,) and (np.diff(hit) >= 0).all()


# ------------------------------------------------------------ analysis_bands
def test_frequency_band_files_match_jax(tmp_path):
    rng = np.random.default_rng(42)
    clusters = []
    for _ in range(300):
        nodes = sorted({int(rng.integers(1, 120))
                        for _ in range(int(rng.integers(3, 12)))})
        if len(nodes) >= 3:
            clusters.append(nodes)
    flat = np.concatenate([np.asarray(c) for c in clusters]).astype(np.int32)
    offsets = np.zeros(len(clusters) + 1, dtype=np.int64)
    np.cumsum([len(c) for c in clusters], out=offsets[1:])
    for size in (3, 4):
        ref = j_bands.build_frequency_band_files(
            flat, offsets, size, str(tmp_path / "jax"), verbose=False)
        got = t_bands.build_frequency_band_files(
            flat, offsets, size, str(tmp_path / "port"), verbose=False)
        assert list(got) == list(ref)
        for band in ref:
            np.testing.assert_array_equal(got[band], ref[band])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert "upper_3.npy" in names and "2_3_4.npy" in names
    for name in names:
        a = np.load(tmp_path / "port" / name)
        b = np.load(tmp_path / "jax" / name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------------- legacy
def _clusters(rng, n):
    popular = rng.permutation(np.arange(1, n + 1))[:n // 2]
    edges = []
    for _ in range(1500):
        e = sorted(set(rng.choice(popular, int(rng.integers(2, 6)),
                                  replace=False).tolist()))
        if len(e) >= 2:
            edges.append(e)
    for _ in range(n * 25):
        edges.append(sorted(rng.choice(np.arange(1, n + 1), 2,
                                       replace=False).tolist()))
    for _ in range(30):
        edges.append(sorted(rng.choice(np.arange(1, n + 1), 30,
                                       replace=False).tolist()))
    flat = np.concatenate([np.asarray(e) for e in edges]).astype(np.int32)
    offsets = np.zeros(len(edges) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in edges], out=offsets[1:])
    return flat, offsets


@pytest.mark.parametrize("case", ["mixed", "trailing_empty"])
def test_filter_low_frequency_nodes_matches_jax(case):
    """The cases of tests/test_legacy_features.py: heavy-tailed usage
    around the cutoff with oversized clusters, and empty clusters in the
    CSR, the last one at the end."""
    if case == "mixed":
        genome = GenomeBins(["chr1", "chr2", "chr3"],
                            [40_000_000, 25_000_000, 18_000_000], 1_000_000)
        flat, offsets = _clusters(np.random.default_rng(42),
                                  genome.num_nodes)
        chrom_range, kw = genome.chrom_range, {}
    else:
        flat = np.array([1, 2, 1, 2, 1, 2], dtype=np.int32)
        offsets = np.array([0, 2, 2, 4, 6, 6], dtype=np.int64)
        chrom_range = np.array([[1, 3]], dtype=np.int64)
        kw = dict(min_freq=2, freq_count_cap=100)
    got = t_legacy.filter_low_frequency_nodes(flat, offsets, chrom_range,
                                              **kw)
    ref = j_legacy.filter_low_frequency_nodes(flat, offsets, chrom_range,
                                              **kw)
    for field in ("flat", "offsets", "chrom_range", "node2newnode",
                  "survived", "node_freq"):
        a, b = getattr(got, field), getattr(ref, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.new_node_num == ref.new_node_num
    if case == "mixed":
        assert t_legacy.remap_node_dicts(
            got, genome.node2bin_dict(), genome.node2chrom_dict()) == \
            j_legacy.remap_node_dicts(ref, genome.node2bin_dict(),
                                      genome.node2chrom_dict())


def test_parse_contact_pairs_matches_jax(tmp_path):
    """Rows off the chromosome list, NaN weights, starts off a bin or past
    the chromosome's end, negative starts, the diagonal's 2w, and
    bare-numeric chromosome names."""
    rng = np.random.default_rng(42)
    lines = ["chrom1\tstart1\tchrom2\tstart2\tbalanced"]
    for _ in range(300):
        w = float(rng.standard_normal()) if rng.random() >= 0.1 else np.nan
        lines.append(f"{rng.choice(['chr1', 'chr2', 'chrX'])}\t"
                     f"{int(rng.integers(-1, 8)) * 500_000}\t"
                     f"{rng.choice(['chr1', 'chr2'])}\t"
                     f"{int(rng.integers(0, 8)) * 1_000_000}\t{w}")
    lines.append("chr1\t1000000\tchr1\t1000000\t2.5")
    path = tmp_path / "contacts.txt"
    path.write_text("\n".join(lines) + "\n")
    num = tmp_path / "num.txt"
    num.write_text("chrom1\tstart1\tchrom2\tstart2\tbalanced\n"
                   "1\t0\t1\t2000000\t1.5\n")
    for p, names in ((path, ["chr1", "chr2"]), (num, ["1", "2"])):
        got = t_legacy.parse_contact_pairs(
            str(p), GenomeBins(names, [5_000_000, 3_000_000], 1_000_000))
        ref = j_legacy.parse_contact_pairs(
            str(p), JGenome(names, [5_000_000, 3_000_000], 1_000_000))
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got[0][0, 2] == 1.5


# ------------------------------------------------------------ plot_embedding
def test_subcompartment_labels_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    rows = []
    for chrom, size in (("chr1", 12_000_000), ("chr2", 7_000_000),
                        ("chr9", 3_000_000)):
        start = 0
        while start < size:
            end = start + int(rng.integers(1, 15)) * 100_000
            label = rng.choice(["A1", "A2", "B1", "B2", "B3", "NA"])
            rows.append(f"{chrom}\t{start}\t{end}\t{label}")
            start = end
    bed = tmp_path / "sub.bed"
    bed.write_text("\n".join(rows) + "\n")
    names, sizes = ["chr1", "chr2"], [12_000_000, 7_000_000]
    got = t_plot.build_subcompartment_labels(
        str(bed), GenomeBins(names, sizes, 1_000_000))
    ref = j_plot.build_subcompartment_labels(
        str(bed), JGenome(names, sizes, 1_000_000))
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (21,) and (got >= 0).any() and (got == -1).any()


@pytest.mark.parametrize("shape", [(50, 16), (300, 64), (7, 3)])
def test_pca_matches_sklearn_up_to_sign(shape):
    """Each coordinate column equals scikit-learn's PCA(2) up to the sign
    of its component (1e-4); the port's sign rule holds: each component's
    largest-magnitude loading is positive."""
    from sklearn.decomposition import PCA
    rng = np.random.default_rng(shape[0])
    vec = (rng.standard_normal(shape) * np.linspace(3, 0.5, shape[1])
           ).astype(np.float32)
    got = t_plot.pca_2d(vec, device="cpu")
    ref = PCA(n_components=2).fit_transform(vec)
    assert got.shape == ref.shape == (shape[0], 2)
    for c in range(2):
        sign = np.sign(np.dot(got[:, c], ref[:, c]))
        np.testing.assert_allclose(sign * got[:, c], ref[:, c], rtol=1e-4,
                                   atol=1e-4)
    centred = vec.astype(np.float64) - vec.mean(axis=0)
    loadings, *_ = np.linalg.lstsq(got, centred, rcond=None)    # (2, d)
    for row in loadings:
        assert row[np.argmax(np.abs(row))] > 0


# ---------------------------------------------------------------- the CLIs
def _cli(module, *args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_clis_run_on_a_tiny_bundle(bundle, tmp_path):
    """python -m matcha_tpu_torch.apps.{denoise_contact, analysis_bands,
    plot_embedding}, with --device cpu where the app takes a device; without
    it the denoise CLI raises here (no GPU)."""
    out = tmp_path / "denoised.mcool"
    res = _cli("matcha_tpu_torch.apps.denoise_contact", "-m", bundle["path"],
               "-o", str(out), "-d", "1", "-p", str(tmp_path / "plots"),
               "--device", "cpu", cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert "denoised chr1: 6105 pairs" in res.stdout
    with h5py.File(out) as f:
        assert len(f["resolutions/1000000/pixels/balanced"]) == \
            111 * 110 // 2 + 41 * 40 // 2
    assert (tmp_path / "plots" / "chr2_denoise.png").exists()
    if not torch.cuda.is_available():
        res = _cli("matcha_tpu_torch.apps.denoise_contact", "-m",
                   bundle["path"], "-o", str(tmp_path / "x.mcool"),
                   cwd=tmp_path)
        assert res.returncode != 0 and "no CUDA device" in res.stderr

    temp = tmp_path / "temp"
    temp.mkdir()
    rng = np.random.default_rng(1)
    clusters = [np.sort(rng.choice(np.arange(1, 100), int(rng.integers(3, 10)),
                                   replace=False)) for _ in range(200)]
    np.save(temp / "edge_members.npy",
            np.concatenate(clusters).astype(np.int32))
    offsets = np.zeros(len(clusters) + 1, np.int64)
    np.cumsum([len(c) for c in clusters], out=offsets[1:])
    np.save(temp / "edge_offsets.npy", offsets)
    cfg = tmp_path / "config.JSON"
    cfg.write_text('{"temp_dir": "%s"}' % temp)
    res = _cli("matcha_tpu_torch.apps.analysis_bands", "-c", str(cfg), "-s",
               "3", cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert (temp / "upper_3.npy").exists() and "band [2,3)" in res.stdout

    np.save(tmp_path / "emb.npy",
            rng.standard_normal((40, 16)).astype(np.float32))
    np.save(tmp_path / "lab.npy", rng.integers(-1, 5, 40).astype(float))
    res = _cli("matcha_tpu_torch.apps.plot_embedding", "-e",
               str(tmp_path / "emb.npy"), "-l", str(tmp_path / "lab.npy"),
               "-o", str(tmp_path / "scatter.png"), "--device", "cpu",
               cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert (tmp_path / "scatter.png").exists()
