"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The file
imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: f32 with TF32 off differs by summation order only (1e-4).  In
bf16 the kernel rounds where the TPU kernel rounds (f32 weights, v kept in
f32) and the plain version where the XLA oracle rounds, so the two differ by
a few bf16 ulps of outputs up to ~2 (atol = rtol = 2e-2).
"""

import numpy as np
import pytest
import torch

from matcha_tpu_torch.models.modules import mha_init
from matcha_tpu_torch.ops import hyperedge_attention as ta

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, E, L, dtype, n_head=8, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = mha_init(gen, n_head, 64, 64, 64, 64)
    for name in ("ln_q", "ln_k", "ln_v"):
        p[name]["g"] = 1 + 0.1 * torch.randn(64, generator=gen)
        p[name]["b"] = 0.1 * torch.randn(64, generator=gen)
    x = np.tanh(np.random.default_rng(seed).standard_normal((E, L, 64)))
    args = [ta.pack_ln(p), p["wq"], p["wk"], p["wv"], p["fc1"]["w"],
            p["fc1"]["b"]]
    return (torch.tensor(x, dtype=dtype, device=device),
            [a.to(device) for a in args])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,L,diag", [(1037, 5, True), (37, 3, True),
                                      (500, 4, False), (64, 8, True)])
def test_kernel_matches_plain(cuda, dtype, E, L, diag):
    x, args = _inputs(cuda, E, L, dtype)
    before = ta.hyperedge_attention.launches
    got = ta.hyperedge_attention(x, *args, 8, diag)
    assert ta.hyperedge_attention.launches == before + 1
    ref = ta.hyperedge_attention_plain(x, *args, 8, diag)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
def test_backward_names_k2(cuda):
    x, args = _inputs(cuda, 16, 3, torch.float32)
    x.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="K2"):
        ta.hyperedge_attention(x, *args, 8, True).sum().backward()


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    x, args = _inputs(cuda, 16, 3, torch.float32)
    with pytest.raises(ValueError, match="L must be"):
        ta.hyperedge_attention_cuda(x[:, :1].contiguous(), *args, 8, True)
    with pytest.raises(ValueError, match="contiguous"):
        ta.hyperedge_attention_cuda(x.permute(1, 0, 2).contiguous()
                                    .permute(1, 0, 2), *args, 8, True)
    with pytest.raises(ValueError, match="float32"):
        ta.hyperedge_attention_cuda(x, args[0], args[1].half(), *args[2:], 8,
                                    True)
