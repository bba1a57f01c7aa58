"""The port's node-table gather gradient (scatter-add) and token bincount
against the JAX package.

The plain versions are held against the Pallas kernels in interpret mode and
the XLA .at[].add oracle (f32, 1e-5; the bincount exactly), and table_gather's
gradient against the JAX table_gather VJP, including its cast back to the
cotangent's dtype.  Ids outside [0, n_rows) are dropped, as the Pallas
kernels drop them; skewed ids (Zipf, one row, a hub row, reversed) and
such ids are held against the Pallas kernels with exact sums.  The CUDA
kernels K3 and K4 are held against the plain versions on the card, in
test_torch_cuda.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from matcha_tpu.ops.table_scatter import (bincount_f32, scatter_add_matmul,
                                          table_gather)
from matcha_tpu_torch.ops import table_scatter as ts
from test_torch_cuda import skewed_ids


@pytest.mark.parametrize("oracle", ["pallas", "at_add"])
@pytest.mark.parametrize("T,N", [(1024, 300), (512, 128), (640, 3068),
                                 (2048, 30_345)])
def test_scatter_plain_matches_jax(rng, oracle, T, N):
    d = 64
    g = rng.standard_normal((T, d)).astype(np.float32)
    idx = rng.integers(0, N, T).astype(np.int32)
    if oracle == "pallas":
        ref = scatter_add_matmul(jnp.asarray(g), jnp.asarray(idx), N,
                                 interpret=True)
    else:
        ref = jnp.zeros((N, d)).at[jnp.asarray(idx)].add(jnp.asarray(g))
    got = ts.scatter_add_plain(torch.from_numpy(g), torch.from_numpy(idx), N)
    assert got.dtype == torch.float32 and got.shape == (N, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_table_gather_grad_matches_jax_vjp(rng, dtype):
    T, N, d = 768, 200, 32
    w = rng.standard_normal((T, d)).astype(np.float32)
    idx = rng.integers(0, N, T).astype(np.int32)
    table = rng.standard_normal((N, d)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(t):
        return jnp.sum(jnp.sin(table_gather(t, jnp.asarray(idx)).astype(
            jnp.float32)) * w)

    ref = jax.grad(loss)(jnp.asarray(table).astype(jdt))
    tt = torch.from_numpy(table).to(tdt).requires_grad_(True)
    (torch.sin(ts.table_gather(tt, torch.from_numpy(idx)).float())
     * torch.from_numpy(w)).sum().backward()
    assert tt.grad.dtype == tdt and ref.dtype == jdt
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(tt.grad.float().numpy(),
                               np.asarray(ref, dtype=np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("T,N", [(1024, 300), (640, 3068), (512, 64)])
def test_bincount_plain_matches_pallas(rng, T, N):
    idx = rng.integers(0, N, T).astype(np.int32)
    ref = bincount_f32(jnp.asarray(idx), N, interpret=True)
    got = ts.bincount_plain(torch.from_numpy(idx), N)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


KINDS = ["zipf", "one_row", "hub", "reverse", "out_of_range"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("T,N", [(1024, 300), (640, 3068)])
def test_scatter_plain_matches_pallas_on_skewed_and_out_of_range_ids(
        rng, kind, T, N):
    """The Pallas kernel (interpret mode) drops ids outside [0, N); so does
    the plain version.  g holds multiples of 1/4, so every sum is exact in
    f32 and a token wrongly kept or dropped shows."""
    g = (rng.integers(-8, 9, (T, 64)) / 4).astype(np.float32)
    idx = skewed_ids(kind, rng, T, N)
    ref = scatter_add_matmul(jnp.asarray(g), jnp.asarray(idx), N,
                             interpret=True)
    got = ts.scatter_add_plain(torch.from_numpy(g), torch.from_numpy(idx), N)
    assert got.shape == (N, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("T,N", [(1024, 300), (640, 3068)])
def test_bincount_plain_matches_pallas_on_skewed_and_out_of_range_ids(
        rng, kind, T, N):
    idx = skewed_ids(kind, rng, T, N)
    ref = bincount_f32(jnp.asarray(idx), N, interpret=True)
    got = ts.bincount_plain(torch.from_numpy(idx), N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    valid = (idx >= 0) & (idx < N)
    assert float(got.sum()) == valid.sum()


@pytest.mark.parametrize("bad", [5, 6, 1 << 20])
def test_table_gather_grad_drops_out_of_range_id_like_jax_vjp(rng, bad):
    """An id >= n_rows adds nothing to the table's gradient, as in
    ``jax.vjp`` of table_gather (JAX's forward clamps such an id; torch's
    indexing refuses it, so the backward is called directly).  A negative
    id is left out here: JAX's CPU ``.at[].add`` route wraps it around."""
    N, T = 5, 64
    idx = rng.integers(0, N, T).astype(np.int32)
    idx[::7] = bad
    g = (rng.integers(-8, 9, (T, 16)) / 4).astype(np.float32)
    table = rng.standard_normal((N, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: table_gather(t, jnp.asarray(idx)),
                     jnp.asarray(table))
    (ref,) = vjp(jnp.asarray(g))
    ctx = SimpleNamespace(saved_tensors=(torch.from_numpy(idx),), n_rows=N)
    got, _ = ts._TableGather.backward(ctx, torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (N, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_dispatchers_on_cpu_take_plain_and_never_launch(rng):
    g = torch.from_numpy(rng.standard_normal((100, 8)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 10, 100).astype(np.int32))
    before = (ts.scatter_add.launches, ts.bincount.launches)
    torch.testing.assert_close(ts.scatter_add(g, idx, 10),
                               ts.scatter_add_plain(g, idx, 10), rtol=0,
                               atol=0)
    assert torch.equal(ts.bincount(idx, 10), ts.bincount_plain(idx, 10))
    assert (ts.scatter_add.launches, ts.bincount.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    g = torch.zeros((4, 8))
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ts.scatter_add_cuda(g, idx, 3)
    with pytest.raises(ValueError, match="CUDA"):
        ts.bincount_cuda(idx, 3)
