"""A user's run through the port's entry points against the JAX package, on
the CPU at a small size: ``kmers`` and ``train`` through the CLI, then the
apps on the bundle ``train`` writes (``chip_smoke.py`` phase 18 at 100 kb,
here 4 chromosomes of 41-130 bins at 10 kb, dim 16, 4 heads).

The contacts are drawn by the phase's own rules (``chip_smoke.
draw_contacts``): banded intra blocks with one all-zero bin per chromosome,
sparse symmetric inter contacts with all-zero rows and rows of one
positive entry; the edge list is phase 11's (``chip_smoke.write_clusters``).

Tolerances: the frozen tables f32 1e-6 (the same numpy on both sides) and
equal after the bf16 cast; the closed forms' pair probabilities 1e-6;
denoised values 1e-5 on the same pair probabilities, with
``np.random.seed`` set before each side (the quantile transforms'
subsamples draw the same rows), and the pixels exactly; predict_multiway's
probabilities 1e-5; the closed-form pair scorer against the forward on
sampled pairs, f32, 1e-5.
"""

import contextlib
import io
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import chip_smoke
from matcha_tpu.apps import denoise_contact as j_dn
from matcha_tpu.apps import predict as j_predict
from matcha_tpu.apps import predict_multiway as j_pm
from matcha_tpu.genome import GenomeBins as JGenome
from matcha_tpu.models import hypersagnn as jh
from matcha_tpu.train import runtime as j_runtime
from matcha_tpu_torch import pipeline as tpipe
from matcha_tpu_torch.apps import denoise_contact as t_dn
from matcha_tpu_torch.apps.pairwise_fast import pairwise_proba_matrix
from matcha_tpu_torch.apps.predict import predict_proba
from matcha_tpu_torch.apps.predict_multiway import run_predict_multiway
from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.models import hypersagnn as th
from matcha_tpu_torch.native import kmer_native
from matcha_tpu_torch.train.runtime import load_model_bundle

NAMES = ["chr1", "chr2", "chr3", "chr4"]
SIZES = [1_290_000, 900_000, 600_000, 400_000]    # 130, 91, 61, 41 bins
RES = 10_000


def _contacts(seed=11):
    genome = GenomeBins(NAMES, SIZES, RES)
    return genome, *chip_smoke.draw_contacts(genome,
                                             np.random.default_rng(seed))


def test_contacts_follow_the_phase_rules():
    """Each branch the phase means to reach is there: banded symmetric
    intra blocks with one all-zero bin per chromosome and nothing between
    chromosomes; symmetric inter contacts off the chromosome only, with
    all-zero rows, rows of one positive entry and rows of several."""
    genome, intra, inter = _contacts()
    assert [int(e - s) for s, e in genome.chrom_range] == [130, 91, 61, 41]
    assert intra.dtype == inter.dtype == np.float32
    np.testing.assert_array_equal(intra, intra.T)
    np.testing.assert_array_equal(inter, inter.T)
    chrom = genome.node2chrom[1:]
    same = chrom[:, None] == chrom[None, :]
    assert not intra[~same].any() and not inter[same].any()
    i, j = np.nonzero(intra)
    assert (i != j).all()
    assert np.abs(i - j).max() == min(130, chip_smoke.INTRA_BAND) - 1
    zero_rows = np.flatnonzero(~intra.any(axis=1))
    assert sorted(chrom[zero_rows].tolist()) == [0, 1, 2, 3]
    positives = (inter > 0).sum(axis=1)
    assert (positives == 0).any() and (positives == 1).any()
    assert np.median(positives) > chip_smoke.INTER_DRAWS


def test_queries_are_k_distinct_bins_of_one_chromosome(tmp_path):
    genome = GenomeBins(NAMES, SIZES, RES)
    path = str(tmp_path / "queries.txt")
    chip_smoke.write_chrom_queries(path, genome, np.random.default_rng(2),
                                   per_k=300)
    from matcha_tpu_torch.apps.predict_multiway import parse_interaction_file
    samples = parse_interaction_file(path, genome)
    sizes = [len(s) for s in samples]
    assert sizes == sorted(sizes) and len(samples) == 4 * 300
    assert {k: sizes.count(k) for k in (2, 3, 4, 5)} == dict.fromkeys(
        (2, 3, 4, 5), 300)
    for s in samples:
        assert len(set(genome.node2chrom[s].tolist())) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_frozen_tables_matches_jax_on_the_phase_contacts(dtype):
    genome, intra, inter = _contacts()
    got = th.build_frozen_tables(genome, intra, inter,
                                 table_dtype=getattr(torch, dtype),
                                 device="cpu")
    want = jh.build_frozen_tables(JGenome(NAMES, SIZES, RES), intra, inter,
                                  table_dtype=getattr(jnp, dtype))
    pairs = list(zip(got.features, want.features)) + [
        (got.inter_z, want.inter_z), (got.attr_table, want.attr_table)]
    for a, b in pairs:
        b = np.asarray(b)
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        if dtype == "float32":
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(a.float().numpy(),
                                          b.astype(np.float32))
    # the z-score loop reached rows of no, one and several positive entries
    z = got.inter_z.float().numpy()[1:]
    positives = (inter > 0).sum(axis=1)
    assert not z[positives == 0].any() and not z[positives == 1].any()
    assert np.abs(z[positives > 1]).max() > 0


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's CLI on the CPU: ``kmers`` through the native helper,
    ``train`` with 1 + 1 epochs of 2 batches (dim 16, 4 heads), on the
    phase's inputs.  -> (tmp, the bundle's path, the queries' path, the
    train stage's output)."""
    assert kmer_native.available()
    tmp = str(tmp_path_factory.mktemp("bundle_apps"))
    temp = os.path.join(tmp, "temp")
    genome, intra, inter = _contacts()
    genome.save(temp)
    from matcha_tpu_torch.data.mcool import save_contacts
    save_contacts(temp, intra, inter)
    chip_smoke.write_clusters(temp, genome, np.random.default_rng(12))
    cfg = chip_smoke.write_cli_config(tmp, temp, genome, embed_dim=16,
                                      n_head=4, batch_size=64,
                                      num_batch_per_iter=2)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        tpipe.main(["kmers", "-c", cfg])
        tpipe.main(["train", "-c", cfg, "--device", "cpu"])
    queries = os.path.join(tmp, "queries.txt")
    chip_smoke.write_chrom_queries(queries, genome,
                                   np.random.default_rng(13), per_k=150)
    return tmp, os.path.join(temp, "model2load"), queries, log.getvalue()


def test_train_writes_a_bundle_both_packages_load(trained):
    tmp, bundle, _, text = trained
    assert "train sizes: " in text and "built Bloom filters" in text
    for name in ("params.pkl", "meta.pkl", "intra_adj.npy", "inter_adj.npy"):
        assert os.path.exists(os.path.join(bundle, name)), name
    assert np.load(os.path.join(tmp, "embeddings.npy")).shape == (323, 16)
    t_params, t_dims, t_genome, t_frozen = load_model_bundle(bundle, "cpu")
    j_params, j_dims, j_genome, j_frozen = j_runtime.load_model_bundle(bundle)
    assert t_dims._asdict() == j_dims._asdict()
    assert (t_dims.dim, t_dims.n_head, t_dims.num_nodes) == (16, 4, 323)
    assert t_genome.chrom_names == j_genome.chrom_names == NAMES
    tables = list(zip(t_frozen.features, j_frozen.features)) + [
        (t_frozen.inter_z, j_frozen.inter_z),
        (t_frozen.attr_table, j_frozen.attr_table)]
    for a, b in tables:
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_denoise_on_the_trained_bundle_matches_jax(trained, monkeypatch):
    """The port's denoise_pixels over the 4 chromosomes against JAX's
    denoise_chromosome per chromosome, concatenated, each on its own load
    of the bundle.  The pair probabilities of the two closed forms are held
    at 1e-6 (they differ by f32 rounding, ~2e-7); the chain after them is
    held on the same probabilities (JAX's chain scores with the port's
    closed form), because the quantile transform multiplies a score's
    rounding by its slope, 1/999 over the gap between neighbouring
    quantiles: on each package's own scores a few pixels of each
    chromosome move by up to ~6e-5."""
    from matcha_tpu.apps import pairwise_fast as j_pw
    _, bundle, _, _ = trained
    t_params, t_dims, t_genome, t_frozen = load_model_bundle(bundle, "cpu")
    j_params, j_dims, j_genome, j_frozen = j_runtime.load_model_bundle(bundle)
    port = {c: pairwise_proba_matrix(t_params, t_frozen, t_dims, t_genome, c)
            for c in range(4)}
    for c in range(4):
        np.testing.assert_allclose(
            port[c], j_pw.pairwise_proba_matrix(j_params, j_frozen, j_dims,
                                                j_genome, c),
            rtol=0, atol=1e-6)
    intra = np.load(os.path.join(bundle, "intra_adj.npy"))
    np.random.seed(21)
    bin1, bin2, bal, _ = t_dn.denoise_pixels(t_params, t_frozen, t_dims,
                                             t_genome, intra,
                                             log=lambda *a: None)
    monkeypatch.setattr(j_pw, "pairwise_proba_matrix",
                        lambda params, frozen, dims, genome, c: port[c])
    np.random.seed(21)
    ref = [j_dn.denoise_chromosome(j_params, j_frozen, j_dims, j_genome,
                                   intra, c, 0) for c in range(4)]
    bins = np.asarray([130, 91, 61, 41])
    assert len(bal) == int((bins * (bins + 1) // 2).sum())
    np.testing.assert_array_equal(
        bin1, np.concatenate([r[0][:, 0] - 1 for r in ref]))
    np.testing.assert_array_equal(
        bin2, np.concatenate([r[0][:, 1] - 1 for r in ref]))
    np.testing.assert_allclose(bal, np.concatenate([r[4] for r in ref]),
                               rtol=1e-5, atol=1e-5)
    assert np.isfinite(bal).all() and bal.min() >= 0 and bal.max() <= 1


def test_predict_multiway_on_the_trained_bundle_matches_jax(trained):
    tmp, bundle, queries, _ = trained
    got = run_predict_multiway(bundle, queries,
                               os.path.join(tmp, "output.txt"),
                               batch_size=100, device="cpu")
    j_params, j_dims, j_genome, j_frozen = j_runtime.load_model_bundle(bundle)
    samples = j_pm.parse_interaction_file(queries, j_genome)
    want = j_predict.predict_proba(j_params, j_frozen, j_dims, samples,
                                   batch_size=100)
    assert got.shape == (4 * 150,) and ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.loadtxt(os.path.join(tmp, "output.txt")),
                               got, rtol=1e-6)


def test_closed_form_matches_the_forward_on_sampled_pairs(trained):
    """The phase's deviation check, f32 on the CPU: per chromosome the
    closed-form pair probabilities against the forward over sampled
    pairs."""
    _, bundle, _, _ = trained
    params, dims, genome, frozen = load_model_bundle(bundle, "cpu")
    rng = np.random.default_rng(14)
    for c in range(genome.num_chroms):
        s = genome.chrom_range[c, 0]
        pairs = t_dn.generate_pair_wise(genome, c, 0)
        sample = pairs[rng.permutation(len(pairs))[:500]]
        full = pairwise_proba_matrix(params, frozen, dims, genome, c)
        fwd = predict_proba(params, frozen, dims, sample, 200)
        np.testing.assert_allclose(full[sample[:, 0] - s, sample[:, 1] - s],
                                   fwd, rtol=0, atol=1e-5)
