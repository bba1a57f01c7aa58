"""The port's fused classifier tail (K6's plain forward and backward) and the
fused-tail gate of forward_buckets against the JAX package.

Eval mode: the forward and every gradient against JAX's fused_tail (its
Pallas kernels in interpret mode) and against the unfused XLA chain built
from the JAX package's modules, in f32 (forward rtol = atol = 1e-5; gradients
1e-4 relative to each gradient's largest entry: summation order only).  bf16
against the f32 reference within 2e-2 of the largest logit (bf16 keeps 8
bits; the chain rounds five times).  Train mode: JAX cannot draw the TPU
kernel's dropout on the CPU, so the port's own masks (a pure function of the
seed) are fed to a reference composed of JAX's layer_norm and linear, and
the gradients are held against its jax.vjp.  The mask transform is
bit-equal to JAX's bits_to_mask on the same bits.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from matcha_tpu.genome import GenomeBins
from matcha_tpu.models import hypersagnn as jh
from matcha_tpu.models.modules import layer_norm, linear, pff
from matcha_tpu.ops.fused_tail import bits_to_mask as j_bits_to_mask
from matcha_tpu.ops.fused_tail import fused_tail as j_fused_tail
from matcha_tpu_torch.interop import params_from_numpy
from matcha_tpu_torch.models import hypersagnn as th
from matcha_tpu_torch.ops import fused_tail as ft

D = 64
SEED = jnp.zeros((), jnp.int32)


def _params(rng):
    def a(*shape, scale=0.1, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    def ln():
        return {"g": a(D, shift=1.0), "b": a(D)}
    pn = {"layers": [{"w": a(D, D), "b": a(D)}, {"w": a(D, D), "b": a(D)}],
          "ln": ln()}
    return pn, ln(), ln(), {"w": a(D, 1, scale=0.3), "b": a(1)}


def _flat(pn, ln_dyn, ln_st, cl):
    """fused_tail's parameter arguments (numpy) from the JAX trees."""
    ln6 = np.stack([pn["ln"]["g"], pn["ln"]["b"], ln_dyn["g"], ln_dyn["b"],
                    ln_st["g"], ln_st["b"]])
    return [ln6, pn["layers"][0]["w"], pn["layers"][0]["b"],
            pn["layers"][1]["w"], pn["layers"][1]["b"], cl["w"], cl["b"]]


def _xla_chain(y, h, pn, ln_dyn, ln_st, cl):
    dyn = pff(pn, y, residual=True)                     # eval: no dropout
    out = (layer_norm(ln_dyn, dyn) - layer_norm(ln_st, h)) ** 2
    return (out @ cl["w"] + cl["b"]).astype(jnp.float32)


def _masked_chain(y, h, pn, ln_dyn, ln_st, cl, m0, m1):
    """The train-mode tail with explicit masks, from JAX's modules."""
    d0 = y * m0
    hd = jnp.tanh(linear(pn["layers"][0], d0)) * m1
    o = linear(pn["layers"][1], hd) + d0
    dyn = layer_norm(pn["ln"], o)
    out = (layer_norm(ln_dyn, dyn) - layer_norm(ln_st, h)) ** 2
    return out @ cl["w"] + cl["b"]


def _tree_to_flat_grads(g_pn, g_dyn, g_st, g_cl):
    return _flat(*jax.tree_util.tree_map(np.asarray, (g_pn, g_dyn, g_st,
                                                      g_cl)))


def _port_grads(y, h, flat, g, seed, train):
    ins = [torch.tensor(a, requires_grad=True) for a in [y, h, *flat]]
    out = ft.fused_tail(*ins, seed, 0.3, 0.4, train)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ins]


def _assert_grads(got, ref):
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        b = np.asarray(b)
        assert a.shape == b.shape, i
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-6),
                                   err_msg=f"grad {i}")


def _port_grads_bf16(y, h, flat, g):
    """The port's eval-mode forward and grads with y and h in bf16."""
    ins = [torch.from_numpy(a).to(torch.bfloat16) for a in (y, h)]
    ins = [t.requires_grad_(True) for t in ins + [torch.tensor(a) for a in
                                                  flat]]
    out = ft.fused_tail(*ins, 0, 0.3, 0.4, False)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.float().numpy() for t in ins]


@pytest.mark.parametrize("oracle", ["pallas", "xla_chain", "pallas_bf16"])
def test_eval_forward_and_grads_match_jax(rng, oracle):
    """f32 at 1e-5 (forward) and 1e-4 of each gradient's max; pallas_bf16:
    y and h in bf16 on both sides, the plain version (the yardstick of K6's
    bf16 route on the card) against JAX's kernels in interpret mode, which
    round at the same places, at 2e-2 of the largest logit and of each
    gradient's max (a rounding flip moves the rest of the chain by a bf16
    ulp, as the card's tolerance allows)."""
    T = 512
    y = rng.standard_normal((T, D)).astype(np.float32)
    h = rng.standard_normal((T, D)).astype(np.float32)
    g = rng.standard_normal((T, 1)).astype(np.float32)
    trees = _params(rng)
    flat = _flat(*trees)
    if oracle == "pallas_bf16":
        got, grads = _port_grads_bf16(y, h, flat, g)
        jin = [jnp.asarray(a).astype(jnp.bfloat16) for a in (y, h)]
        ref, vjp = jax.vjp(lambda *a: j_fused_tail(*a, SEED, 0.3, 0.4, False),
                           *jin, *map(jnp.asarray, flat))
        ref_grads = [np.asarray(r, dtype=np.float32)
                     for r in vjp(jnp.asarray(g))]
        ref = np.asarray(ref)
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()
        for i, (a, b) in enumerate(zip(grads, ref_grads)):
            assert a.shape == b.shape, i
            assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max(), i
        return
    got, grads = _port_grads(y, h, flat, g, 0, False)
    if oracle == "pallas":
        ref, vjp = jax.vjp(lambda *a: j_fused_tail(*a, SEED, 0.3, 0.4, False),
                           *map(jnp.asarray, [y, h, *flat]))
        ref_grads = vjp(jnp.asarray(g))
    else:
        ref, vjp = jax.vjp(_xla_chain, jnp.asarray(y), jnp.asarray(h),
                           *trees)
        gy, gh, *gt = vjp(jnp.asarray(g))
        ref_grads = [gy, gh, *_tree_to_flat_grads(*gt)]
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    _assert_grads(grads, ref_grads)


def test_bf16_eval_close_to_f32(rng):
    T = 512
    y = torch.randn((T, D), generator=torch.Generator().manual_seed(1))
    h = torch.randn((T, D), generator=torch.Generator().manual_seed(2))
    y, h = y.bfloat16(), h.bfloat16()
    flat = _flat(*_params(rng))
    got = ft.fused_tail(y, h, *map(torch.from_numpy, flat), 0, 0.3, 0.4,
                        False)
    ref = np.asarray(j_fused_tail(jnp.asarray(y.float().numpy()),
                                  jnp.asarray(h.float().numpy()),
                                  *map(jnp.asarray, flat), SEED, 0.3, 0.4,
                                  False))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 2e-2 * np.abs(ref).max()


def test_train_mode_matches_jax_with_the_same_masks(rng):
    T, seed = 300, 977
    y = rng.standard_normal((T, D)).astype(np.float32)
    h = rng.standard_normal((T, D)).astype(np.float32)
    g = rng.standard_normal((T, 1)).astype(np.float32)
    trees = _params(rng)
    got, grads = _port_grads(y, h, _flat(*trees), g, seed, True)
    m0, m1 = (m.numpy() for m in ft.tail_masks(seed, T, D, 0.3, 0.4, True,
                                                "cpu"))
    assert set(np.unique(m0)) == {0.0, np.float32(1 / 0.7)}
    ref, vjp = jax.vjp(lambda y, h, *p: _masked_chain(y, h, *p, m0, m1),
                       jnp.asarray(y), jnp.asarray(h), *trees)
    gy, gh, *gt = vjp(jnp.asarray(g))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    _assert_grads(grads, [gy, gh, *_tree_to_flat_grads(*gt)])


def test_masks(rng):
    """bits_to_mask bit-equal to JAX's; keep shares; the same seed gives the
    same masks and the next seed others; the backward regenerates the
    forward's (its input grad is zero exactly where m0 dropped)."""
    bits = rng.integers(0, 1 << 32, size=1 << 16,
                        dtype=np.uint64).astype(np.uint32)
    for rate in (0.3, 0.4):
        np.testing.assert_array_equal(
            ft.bits_to_mask(torch.from_numpy(bits.astype(np.int64)),
                            rate).numpy(),
            np.asarray(j_bits_to_mask(jnp.asarray(bits), rate)))
    m0, m1 = ft.tail_masks(5, 32_768, D, 0.3, 0.4, True, "cpu")
    assert 0.69 <= float((m0 > 0).float().mean()) <= 0.71
    assert 0.59 <= float((m1 > 0).float().mean()) <= 0.61
    assert torch.equal(m0, ft.tail_masks(5, 32_768, D, 0.3, 0.4, True,
                                         "cpu")[0])
    assert not torch.equal(m0, ft.tail_masks(6, 32_768, D, 0.3, 0.4, True,
                                             "cpu")[0])
    T = 64
    flat = _flat(*_params(rng))
    y = rng.standard_normal((T, D)).astype(np.float32)
    _, grads = _port_grads(y, y.copy(), flat, np.ones((T, 1), np.float32),
                           5, True)
    np.testing.assert_array_equal(grads[0] == 0, m0.numpy()[:T] == 0)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(4)
    genome = GenomeBins(["chr1", "chr2"], [30_000_000, 20_000_000], 1_000_000)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    intra = intra + intra.T
    inter = rng.random((n, n)).astype(np.float32)
    kw = dict(dim=D, n_head=4, num_chroms=2, num_nodes=n)
    sizes = [int(e - s) for s, e in genome.chrom_range]
    jd = jh.ModelDims(**kw, use_pallas_attention=True)
    jp = jh.init_model(jax.random.PRNGKey(0), jd, sizes)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    # T = 2 * 128 + 3 * 256 = 1,024 tokens: JAX's fused gate needs T % 512
    xs = {}
    for k, m in ((2, 128), (3, 256)):
        xs[k] = np.stack([np.sort(rng.choice(np.arange(1, n + 1), k,
                                             replace=False))
                          for _ in range(m)]).astype(np.int32)
    return ((jp, jh.build_frozen_tables(genome, intra, inter), jd),
            (tp, th.build_frozen_tables(genome, intra, inter, device="cpu"),
             th.ModelDims(**kw)), xs)


@pytest.mark.parametrize("mode", ["per-k", "pad-max"])
def test_forward_buckets_gate_matches_jax(problem, monkeypatch, mode):
    (jp, jf, jd), (tp, tf, td), xs = problem
    monkeypatch.setattr(jh, "_FUSE_TAIL", True)
    monkeypatch.setattr(th, "_FUSE_TAIL", True)
    ref = jh.forward_buckets(jp, jf, jd, {k: jnp.asarray(v)
                                          for k, v in xs.items()},
                             attention_mode=mode)
    got = th.forward_buckets(tp, tf, td, {k: torch.from_numpy(v)
                                          for k, v in xs.items()},
                             attention_mode=mode)
    for k in xs:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=f"k={k}")


def test_gate_trains_on_cpu_and_refuses_a_flip(problem, monkeypatch):
    """Train mode runs on the CPU (the plain version has masks; JAX's gate
    leaves the CPU out); the gate, once read, cannot flip."""
    _, (tp, tf, td), xs = problem
    monkeypatch.setattr(th, "_FUSE_TAIL", None)
    monkeypatch.setenv("MATCHA_FUSE_TAIL", "1")
    assert th._fuse_tail_enabled()
    th.configure_fuse_tail(True)
    with pytest.raises(RuntimeError, match="fuse_tail"):
        th.configure_fuse_tail(False)
    p = {**tp, "pff_classifier": {"layers": [
        {k: v.clone().requires_grad_(True) for k, v in
         tp["pff_classifier"]["layers"][0].items()}]}}
    txs = {k: torch.from_numpy(v) for k, v in xs.items()}
    a = th.forward_buckets(p, tf, td, txs, train=True,
                           generator=torch.Generator().manual_seed(1))
    b = th.forward_buckets(p, tf, td, txs, train=True,
                           generator=torch.Generator().manual_seed(2))
    assert not torch.equal(a[3], b[3])
    sum(v.sum() for v in a.values()).backward()
    w = p["pff_classifier"]["layers"][0]["w"]
    assert w.grad is not None and bool(torch.isfinite(w.grad).all())
