"""Fused Hyper-SAGNN hyperedge attention: LN -> q/k/v -> diag-masked softmax
attention -> fc1, for x of shape (E, L, d).

Port of ``matcha_tpu/ops/hyperedge_attention.py`` (forward only).  Three
functions:

  * ``hyperedge_attention_plain`` — the plain PyTorch version.  It follows
    the JAX package's XLA oracle ``_fwd_xla``: q, k, v and the attention
    weights are rounded to x's dtype, scores and the a@v sums run in f32.
  * ``hyperedge_attention_cuda`` — the wrapper of the hand-written Hopper
    kernel ``csrc/hyperedge_attention_fwd.cu`` (the port of the TPU kernel
    ``_fwd_kernel_fm`` and its lane-major twin ``_fwd_kernel``).  It rounds
    where the TPU kernel rounds: q and k to x's dtype, v kept in f32, the
    attention output to x's dtype before fc1, and the output.  In bf16 the
    two therefore differ by a few bf16 ulps (tolerance 2e-2 on the card).
  * ``hyperedge_attention`` — the dispatcher.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises.  No fallback.

``hyperedge_attention.launches`` counts kernel launches: the wrapper adds one
where it launches the kernel and nowhere else.

Semantics match ``models.modules.mha_dynamic``, including the reference's
never-applied key-pad mask: the softmax runs over all L positions with only
the diagonal masked (-1e32).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

D_MODEL = 64      # the kernel's model width d
D_HEAD = 64       # the kernel's per-head width dk
MAX_L = 8         # the kernel's largest hyperedge size


def pack_ln(p) -> torch.Tensor:
    """(6, d) f32 rows [q.g, q.b, k.g, k.b, v.g, v.b]."""
    return torch.stack([p["ln_q"]["g"], p["ln_q"]["b"],
                        p["ln_k"]["g"], p["ln_k"]["b"],
                        p["ln_v"]["g"], p["ln_v"]["b"]]).to(torch.float32)


def _ln(x, g, b, eps=1e-5):
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


def hyperedge_attention_plain(x, ln, wq, wk, wv, fw, fb, n_head: int,
                              diag_mask: bool = True):
    """Plain PyTorch version (the oracle ``_fwd_xla``).  x: (E, L, d);
    ln: (6, d); wq/wk/wv: (d, h*dk); fw: (h*dk, d); fb: (d,) -> (E, L, d)."""
    E, L, d = x.shape
    dk = wq.shape[1] // n_head
    dt = x.dtype
    x2 = x.reshape(E * L, d)

    def heads(t):
        return t.reshape(E, L, n_head, dk).transpose(1, 2)   # (E, h, L, dk)

    q = heads(_ln(x2, ln[0], ln[1]) @ wq.to(dt))
    k = heads(_ln(x2, ln[2], ln[3]) @ wk.to(dt))
    v = heads(_ln(x2, ln[4], ln[5]) @ wv.to(dt))
    s = torch.einsum("ehqd,ehkd->ehqk", q.float(), k.float()) / math.sqrt(dk)
    if diag_mask:
        eye = torch.eye(L, dtype=torch.bool, device=x.device)
        s = s.masked_fill(eye, -1e32)
    a = torch.softmax(s, dim=-1).to(dt)
    o = torch.einsum("ehqk,ehkd->ehqd", a.float(), v.float()).to(dt)
    o = o.transpose(1, 2).reshape(E * L, n_head * dk)
    y = o @ fw.to(dt) + fb.to(dt)
    return y.reshape(E, L, d)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from matcha_tpu_torch.kernels.build import load_library
    lib = load_library("hyperedge_attention_fwd")
    fn = lib.matcha_hyperedge_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.matcha_cuda_error_string.argtypes = [ctypes.c_int]
    lib.matcha_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.matcha_cuda_error_string


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"hyperedge_attention_cuda: {msg}")


def hyperedge_attention_cuda(x, ln, wq, wk, wv, fw, fb, n_head: int,
                             diag_mask: bool = True):
    """Launch the Hopper kernel on ``torch.cuda.current_stream()``.

    Takes x (E, L, 64) in f32 or bf16 with 2 <= L <= 8, ln (6, 64), wq/wk/wv
    (64, n_head*64), fw (n_head*64, 64) and fb (64,), all f32 (the master
    params, as the TPU kernel reads them), contiguous and on x's device.
    Raises on anything else."""
    _check(x.is_cuda, "x must be a CUDA tensor")
    _check(x.dtype in (torch.float32, torch.bfloat16),
           f"x must be float32 or bfloat16, got {x.dtype}")
    _check(x.dim() == 3 and x.shape[2] == D_MODEL,
           f"x must be (E, L, {D_MODEL}), got {tuple(x.shape)}")
    E, L, d = x.shape
    _check(2 <= L <= MAX_L, f"L must be in [2, {MAX_L}], got {L}")
    hd = n_head * D_HEAD
    shapes = {"ln": (ln, (6, d)), "wq": (wq, (d, hd)), "wk": (wk, (d, hd)),
              "wv": (wv, (d, hd)), "fw": (fw, (hd, d)), "fb": (fb, (d,))}
    for name, (t, shape) in shapes.items():
        _check(tuple(t.shape) == shape,
               f"{name} must be {shape}, got {tuple(t.shape)}")
        _check(t.dtype == torch.float32, f"{name} must be float32")
        _check(t.device == x.device, f"{name} must be on {x.device}")
    for name, t in [("x", x)] + [(n, t) for n, (t, _) in shapes.items()]:
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    out = torch.empty_like(x)
    fn, err_str = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), ln.data_ptr(), wq.data_ptr(), wk.data_ptr(),
                 wv.data_ptr(), fw.data_ptr(), fb.data_ptr(), out.data_ptr(),
                 E, L, n_head, int(diag_mask),
                 int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError("hyperedge_attention_fwd kernel launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    hyperedge_attention.launches += 1
    return out


class _FusedAttention(torch.autograd.Function):
    """The CUDA forward; its backward (the TPU kernel K2) is not ported yet."""

    @staticmethod
    def forward(ctx, x, ln, wq, wk, wv, fw, fb, n_head, diag_mask):
        return hyperedge_attention_cuda(x, ln, wq, wk, wv, fw, fb, n_head,
                                        diag_mask)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the backward of the fused hyperedge attention (K2: "
            "matcha_tpu/ops/hyperedge_attention.py:_bwd_kernel_fm) is not "
            "ported to CUDA yet")


def hyperedge_attention(x, ln, wq, wk, wv, fw, fb, n_head: int,
                        diag_mask: bool = True):
    """Fused LN -> qkv -> diag-masked attention -> fc1 -> (E, L, d).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (any E: the kernel masks its own ragged tail) or raises."""
    if x.device.type == "cpu":
        return hyperedge_attention_plain(x, ln, wq, wk, wv, fw, fb, n_head,
                                         diag_mask)
    if x.device.type != "cuda":
        raise ValueError(f"hyperedge_attention: no kernel for {x.device}")
    return _FusedAttention.apply(x, ln, wq, wk, wv, fw, fb, n_head,
                                 diag_mask)


hyperedge_attention.launches = 0
