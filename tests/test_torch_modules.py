"""The port's models/modules.py against the JAX package's, in f32.

Same parameters (drawn by JAX, carried across with params_from_numpy) and
the same numpy inputs go through both.  The JAX side runs matmuls at
"highest" precision (conftest.py); the port runs plain f32 on the CPU.
Tolerance rtol = atol = 2e-5, as tests/test_pallas_attention.py uses: the
two sides sum in different orders.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from matcha_tpu.models import modules as jm
from matcha_tpu_torch.interop import params_from_numpy
from matcha_tpu_torch.models import modules as tm

TOL = dict(rtol=2e-5, atol=2e-5)
D, H = 32, 4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tree):
    return params_from_numpy(_np_tree(tree), device="cpu")


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def test_tanh(rng):
    x = rng.standard_normal((5, 7)).astype(np.float32)
    _close(tm.tanh(torch.from_numpy(x)), jm.tanh(jnp.asarray(x)))


@pytest.mark.parametrize("use_bias", [True, False])
def test_linear(rng, use_bias):
    p = jm.linear_init(jax.random.PRNGKey(1), 24, 16, use_bias)
    x = rng.standard_normal((6, 24)).astype(np.float32)
    _close(tm.linear(_port(p), torch.from_numpy(x)),
           jm.linear(p, jnp.asarray(x)))


def test_layer_norm(rng):
    p = {"g": jnp.asarray(rng.standard_normal(D), jnp.float32),
         "b": jnp.asarray(rng.standard_normal(D), jnp.float32)}
    x = (3.0 + 2.0 * rng.standard_normal((4, 5, D))).astype(np.float32)
    _close(tm.layer_norm(_port(p), torch.from_numpy(x)),
           jm.layer_norm(p, jnp.asarray(x)))


def test_layer_norm_bf16_keeps_dtype(rng):
    p = tm.layer_norm_init(D)
    x = torch.from_numpy(rng.standard_normal((3, D)).astype(np.float32))
    assert tm.layer_norm(p, x.to(torch.bfloat16)).dtype == torch.bfloat16


def test_feed_forward(rng):
    p = jm.feed_forward_init(jax.random.PRNGKey(2), [D, 20, 12])
    x = rng.standard_normal((9, D)).astype(np.float32)
    _close(tm.feed_forward(_port(p), torch.from_numpy(x)),
           jm.feed_forward(p, jnp.asarray(x)))


@pytest.mark.parametrize("dims,residual,ln", [
    ([D, D, D], True, True),      # encoder pff_n1: residual + LayerNorm
    ([D, D, D], False, True),
    ([D, 1], False, False),       # classifier: in != out, no residual/LN
])
def test_pff(rng, dims, residual, ln):
    p = jm.pff_init(jax.random.PRNGKey(3), dims, layer_norm_flag=ln)
    x = rng.standard_normal((4, 3, D)).astype(np.float32)
    _close(tm.pff(_port(p), torch.from_numpy(x), residual=residual),
           jm.pff(p, jnp.asarray(x), residual=residual))


def test_dropout_eval_is_identity(rng):
    """Eval, rate 0 and a missing generator (the JAX package's None key)
    are identities; train-mode statistics are in
    test_torch_forward_buckets.py."""
    x = torch.from_numpy(rng.standard_normal((4, D)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    assert tm.dropout(x, 0.3, train=False, generator=gen) is x
    assert tm.dropout(x, 0.0, train=True, generator=gen) is x
    assert tm.dropout(x, 0.3, train=True) is x


def _mha(rng, L, E=12):
    p = jm.mha_init(jax.random.PRNGKey(4), H, D, D, D, D)
    # non-trivial LayerNorm params so the packed rows are all exercised
    for name in ("ln_q", "ln_k", "ln_v"):
        p[name] = {"g": jnp.asarray(1 + 0.1 * rng.standard_normal(D),
                                    jnp.float32),
                   "b": jnp.asarray(0.1 * rng.standard_normal(D),
                                    jnp.float32)}
    x = rng.standard_normal((E, L, D)).astype(np.float32)
    return p, x


def test_mha_dynamic_k2_closed_form(rng):
    p, x = _mha(rng, 2)
    _close(tm.mha_dynamic(_port(p), torch.from_numpy(x), H, D, D),
           jm.mha_dynamic(p, jnp.asarray(x), H, D, D))


@pytest.mark.parametrize("L", [2, 3, 4, 5])
@pytest.mark.parametrize("diag", [True, False])
def test_mha_dynamic(rng, L, diag):
    p, x = _mha(rng, L)
    _close(tm.mha_dynamic(_port(p), torch.from_numpy(x), H, D, D,
                          diag_mask=diag),
           jm.mha_dynamic(p, jnp.asarray(x), H, D, D, diag_mask=diag))


def test_init_shapes_match_jax():
    gen = torch.Generator().manual_seed(0)
    got = tm.encoder_layer_init(gen, H, D, D, D, D)
    ref = jm.encoder_layer_init(jax.random.PRNGKey(0), H, D, D, D, D)
    shapes_t = jax.tree_util.tree_map(lambda t: tuple(t.shape), got)
    shapes_j = jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)
    assert shapes_t == shapes_j


@pytest.mark.parametrize("L", [2, 4])
def test_encoder_layer(rng, L):
    p = jm.encoder_layer_init(jax.random.PRNGKey(5), H, D, D, D, D)
    x = np.tanh(rng.standard_normal((10, L, D))).astype(np.float32)
    npm = np.ones((10, L, 1), np.float32)
    npm[:3, -1] = 0.0                            # padded tail positions
    dyn_t, st_t = tm.encoder_layer(_port(p), torch.from_numpy(x),
                                   torch.from_numpy(npm), H, D, D)
    dyn_j, st_j = jm.encoder_layer(p, jnp.asarray(x), jnp.asarray(npm),
                                   H, D, D)
    _close(dyn_t, dyn_j)
    _close(st_t, st_j)


@pytest.mark.parametrize("d,L,dk,h", [(16, 3, 16, 4), (64, 9, 64, 2),
                                      (64, 4, 32, 2)])
def test_mha_dynamic_shapes_the_kernel_does_not_take(rng, monkeypatch, d, L,
                                                     dk, h):
    """Width 16, L = 9 (past MAX_L) and heads of 32 route to the port's copy
    of the JAX package's own formulation, never to the fused attention (so
    a CUDA tensor launches no kernel): forward and gradients (of x and every
    weight) against JAX's mha_dynamic, f32, 1e-5."""
    jp = jm.mha_init(jax.random.PRNGKey(6), h, d, dk, dk, d)
    for name in ("ln_q", "ln_k", "ln_v"):
        jp[name] = {"g": jnp.asarray(1 + 0.1 * rng.standard_normal(d),
                                     jnp.float32),
                    "b": jnp.asarray(0.1 * rng.standard_normal(d),
                                     jnp.float32)}
    x = rng.standard_normal((7, L, d)).astype(np.float32)
    w = rng.standard_normal((7, L, d)).astype(np.float32)

    def refuse(*a, **k):
        raise AssertionError("reached the fused attention")
    monkeypatch.setattr(tm, "hyperedge_attention", refuse)

    def jloss(p, xx):
        return jnp.sum(jm.mha_dynamic(p, xx, h, dk, dk) * w)
    ref_y = jm.mha_dynamic(jp, jnp.asarray(x), h, dk, dk)
    ref_gp, ref_gx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True),
                                _port(jp))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tm.mha_dynamic(tp, tx, h, dk, dk)
    (got * torch.from_numpy(w)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    _close(got, ref_y, **tol)
    _close(tx.grad, ref_gx, **tol)
    for a, b in zip(jax.tree_util.tree_leaves(tp),
                    jax.tree_util.tree_leaves(ref_gp)):
        _close(a.grad, b, **tol)


def test_mha_dynamic_takes_the_kernel_where_it_fits(rng, monkeypatch):
    """d = dk = 64 with 2 <= L <= 8 goes to the fused attention (the kernel
    on a CUDA tensor); k = 2 with the diagonal masked keeps its closed
    form."""
    p = tm.mha_init(torch.Generator().manual_seed(0), 2, 64, 64, 64, 64)
    calls = []
    real = tm.hyperedge_attention

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(tm, "hyperedge_attention", spy)
    for L in (2, 3, 8):
        x = torch.from_numpy(rng.standard_normal((5, L, 64)).astype(
            np.float32))
        tm.mha_dynamic(p, x, 2, 64, 64)
        tm.mha_dynamic(p, x, 2, 64, 64, diag_mask=False)
    assert calls == [(5, 2, 64), (5, 3, 64), (5, 3, 64), (5, 8, 64),
                     (5, 8, 64)]
