"""The port's fused hyperedge attention against the JAX package.

hyperedge_attention_plain is held against the XLA oracle _fwd_xla and the
two Pallas layouts run in interpret mode, as tests/test_pallas_attention.py
runs them on the CPU.  f32 tolerance rtol = atol = 2e-5 (summation order);
bf16 at 0.05, as tests/test_pallas_attention.py::test_bf16 uses.  The CUDA
kernel is held against the plain version on the card, in test_torch_cuda.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from matcha_tpu.models.modules import mha_init
from matcha_tpu.ops.hyperedge_attention import (_fwd_pallas, _fwd_pallas_fm,
                                                _fwd_xla, _pack_ln)
from matcha_tpu_torch.ops import hyperedge_attention as ta

D, H = 32, 4
TOL = dict(rtol=2e-5, atol=2e-5)


def _setup(rng, E, L, d=D, n_head=H):
    p = mha_init(jax.random.PRNGKey(0), n_head, d, d, d, d)
    # non-trivial LayerNorm params so every packed row matters
    for name in ("ln_q", "ln_k", "ln_v"):
        p[name] = {"g": jnp.asarray(1 + 0.1 * rng.standard_normal(d),
                                    jnp.float32),
                   "b": jnp.asarray(0.1 * rng.standard_normal(d),
                                    jnp.float32)}
    x = rng.standard_normal((E, L, d)).astype(np.float32)
    jargs = (_pack_ln(p), p["wq"], p["wk"], p["wv"], p["fc1"]["w"],
             p["fc1"]["b"])
    targs = tuple(torch.tensor(np.asarray(a)) for a in jargs)
    return x, jargs, targs


@pytest.mark.parametrize("L", [3, 4, 5])
@pytest.mark.parametrize("diag", [True, False])
def test_plain_matches_xla(rng, L, diag):
    x, jargs, targs = _setup(rng, 48, L)
    ref = _fwd_xla(jnp.asarray(x), *jargs, n_head=H, diag_mask=diag)
    got = ta.hyperedge_attention_plain(torch.from_numpy(x), *targs, H, diag)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("L", [3, 4, 5])
def test_plain_matches_pallas_fm(rng, L):
    x, jargs, targs = _setup(rng, 64, L)
    ref = _fwd_pallas_fm(jnp.asarray(x), *jargs, n_head=H, diag_mask=True,
                         interpret=True)
    got = ta.hyperedge_attention_plain(torch.from_numpy(x), *targs, H, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("L,diag", [(3, True), (5, False)])
def test_plain_matches_pallas_lane_major(rng, L, diag):
    x, jargs, targs = _setup(rng, 32, L)
    ref = _fwd_pallas(jnp.asarray(x), *jargs, n_head=H, diag_mask=diag,
                      interpret=True)
    got = ta.hyperedge_attention_plain(torch.from_numpy(x), *targs, H, diag)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_plain_ragged_edges(rng):
    """E = 37: no block-size assumption in the plain version."""
    x, jargs, targs = _setup(rng, 37, 5)
    ref = _fwd_xla(jnp.asarray(x), *jargs, n_head=H, diag_mask=True)
    got = ta.hyperedge_attention_plain(torch.from_numpy(x), *targs, H, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_plain_bf16(rng):
    x, jargs, targs = _setup(rng, 64, 4)
    ref = _fwd_xla(jnp.asarray(x).astype(jnp.bfloat16), *jargs, n_head=H,
                   diag_mask=True)
    got = ta.hyperedge_attention_plain(
        torch.from_numpy(x).to(torch.bfloat16), *targs, H, True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, dtype=np.float32),
                               rtol=0.05, atol=0.05)


def test_pack_ln_matches_jax(rng):
    p = mha_init(jax.random.PRNGKey(1), H, D, D, D, D)
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), p)
    np.testing.assert_array_equal(ta.pack_ln(tp).numpy(),
                                  np.asarray(_pack_ln(p)))


def test_dispatcher_on_cpu_takes_plain_and_never_launches(rng):
    x, _, targs = _setup(rng, 37, 3)
    before = ta.hyperedge_attention.launches
    got = ta.hyperedge_attention(torch.from_numpy(x), *targs, H, True)
    ref = ta.hyperedge_attention_plain(torch.from_numpy(x), *targs, H, True)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert ta.hyperedge_attention.launches == before


def test_cuda_wrapper_refuses_cpu_tensors(rng):
    x, _, targs = _setup(rng, 8, 3, d=64, n_head=2)
    with pytest.raises(ValueError, match="CUDA"):
        ta.hyperedge_attention_cuda(torch.from_numpy(x), *targs, 2, True)
