"""The backward of the port's fused hyperedge attention against the JAX
package.

Autograd of hyperedge_attention_plain is held against jax.vjp of the XLA
oracle _fwd_xla (the JAX package's own non-Pallas backward) and against the
two Pallas backward kernels run in interpret mode, as
tests/test_pallas_attention.py runs them on the CPU.  Shapes are those of
that file (D = 32, H = 4).  f32 tolerance against the oracle: rtol = 1e-4,
atol = 1e-5 (summation order).  Against the Pallas kernels: the tolerance
that file holds them to against the same oracle (rtol = 5e-4, atol = 5e-5),
since the weight grads sum E*L terms of magnitude ~10 in another order
(measured: one gfw entry of 4,096 differs by 1.4e-5 from the fm kernel).
The CUDA kernel K2 is held against the plain version on the card, in
test_torch_cuda.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from matcha_tpu.models.modules import mha_init
from matcha_tpu.ops.hyperedge_attention import (_bwd_pallas, _bwd_pallas_fm,
                                                _fwd_xla, _pack_ln)
from matcha_tpu_torch.ops import hyperedge_attention as ta

D, H = 32, 4
TOL = {"xla": dict(rtol=1e-4, atol=1e-5),
       "pallas": dict(rtol=5e-4, atol=5e-5),
       "pallas_fm": dict(rtol=5e-4, atol=5e-5)}
NAMES = ["gx", "gln", "gwq", "gwk", "gwv", "gfw", "gfb"]


def _setup(rng, E, L):
    p = mha_init(jax.random.PRNGKey(0), H, D, D, D, D)
    for name in ("ln_q", "ln_k", "ln_v"):
        p[name] = {"g": jnp.asarray(1 + 0.1 * rng.standard_normal(D),
                                    jnp.float32),
                   "b": jnp.asarray(0.1 * rng.standard_normal(D),
                                    jnp.float32)}
    x = rng.standard_normal((E, L, D)).astype(np.float32)
    g = rng.standard_normal((E, L, D)).astype(np.float32)
    jargs = (_pack_ln(p), p["wq"], p["wk"], p["wv"], p["fc1"]["w"],
             p["fc1"]["b"])
    targs = tuple(torch.tensor(np.asarray(a)) for a in jargs)
    return x, g, jargs, targs


def _jax_reference(which, x, g, jargs, diag):
    x, g = jnp.asarray(x), jnp.asarray(g)
    if which == "xla":
        _, vjp = jax.vjp(lambda *a: _fwd_xla(*a, n_head=H, diag_mask=diag),
                         x, *jargs)
        return vjp(g)
    bwd = _bwd_pallas if which == "pallas" else _bwd_pallas_fm
    return bwd(x, *jargs, g, n_head=H, diag_mask=diag, interpret=True)


@pytest.mark.parametrize("which", ["xla", "pallas", "pallas_fm"])
@pytest.mark.parametrize("L", [3, 5])
@pytest.mark.parametrize("diag", [True, False])
def test_plain_backward_matches_jax(rng, which, L, diag):
    x, g, jargs, targs = _setup(rng, 64, L)
    ref = _jax_reference(which, x, g, jargs, diag)
    got = ta.hyperedge_attention_bwd_plain(torch.from_numpy(x), *targs,
                                           torch.from_numpy(g), H, diag)
    for name, a, b in zip(NAMES, got, ref):
        assert a.shape == tuple(b.shape), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL[which])


def test_dispatcher_backward_on_cpu_is_plain_autograd(rng):
    """A CPU tensor's backward is autograd of the plain version; K2's
    launch count does not move."""
    x, g, _, targs = _setup(rng, 37, 4)
    ins = [torch.from_numpy(x).requires_grad_(True)] + [
        t.clone().requires_grad_(True) for t in targs]
    before = ta.hyperedge_attention_bwd_cuda.launches
    ta.hyperedge_attention(*ins, H, True).backward(torch.from_numpy(g))
    assert ta.hyperedge_attention_bwd_cuda.launches == before
    ref = ta.hyperedge_attention_bwd_plain(torch.from_numpy(x), *targs,
                                           torch.from_numpy(g), H, True)
    for name, t, r in zip(NAMES, ins, ref):
        torch.testing.assert_close(t.grad, r, rtol=0, atol=0, msg=name)


def test_plain_backward_bf16(rng):
    """bf16: the two frameworks round at other places; 0.05 of each
    gradient's largest entry."""
    x, g, jargs, targs = _setup(rng, 64, 4)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda *a: _fwd_xla(*a, n_head=H, diag_mask=True),
                     xb, *jargs)
    ref = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    got = ta.hyperedge_attention_bwd_plain(
        torch.from_numpy(x).to(torch.bfloat16), *targs,
        torch.from_numpy(g).to(torch.bfloat16), H, True)
    assert got[0].dtype == torch.bfloat16
    for name, a, b in zip(NAMES, got, ref):
        b = np.asarray(b, dtype=np.float32)
        err = np.abs(a.float().numpy() - b).max() / np.abs(b).max()
        assert err < 0.05, (name, err)


def test_bwd_cuda_wrapper_refuses_cpu_tensors(rng):
    x, g, _, targs = _setup(rng, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        ta.hyperedge_attention_bwd_cuda(torch.from_numpy(x), *targs,
                                        torch.from_numpy(g), H, True)
