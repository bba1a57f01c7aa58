"""Fused Hyper-SAGNN hyperedge attention: LN -> q/k/v -> diag-masked softmax
attention -> fc1, for x of shape (E, L, d).

Port of ``matcha_tpu/ops/hyperedge_attention.py``.  The forward has three
functions:

  * ``hyperedge_attention_plain`` — the plain PyTorch version.  It follows
    the JAX package's XLA oracle ``_fwd_xla``: q, k, v and the attention
    weights are rounded to x's dtype, scores and the a@v sums run in f32.
  * ``hyperedge_attention_cuda`` — the wrapper of the hand-written Hopper
    kernel ``csrc/hyperedge_attention_fwd.cu`` (K1, the port of the TPU
    kernel ``_fwd_kernel_fm`` and its lane-major twin ``_fwd_kernel``).  It
    has two routes, chosen inside the kernel's entry point: bf16 with at
    most 8 heads runs every 64-wide product on the tensor cores and rounds
    where the plain version rounds (the weights, q, k, v, a and the
    attention output in bf16, f32 sums); f32 runs them as f32 FMAs on the
    CUDA cores and rounds where the TPU kernel rounds.  In bf16 the kernel
    and the plain version differ by summation order, a few bf16 ulps at
    most (tolerance 2e-2 on the card).
  * ``hyperedge_attention`` — the dispatcher.  A CPU tensor takes the plain
    version (its backward is autograd of it); a CUDA tensor launches the
    kernel or raises.  No fallback.

The backward has two: ``hyperedge_attention_bwd_plain`` (autograd of the
plain version, the counterpart of ``jax.vjp(_fwd_xla)``) and
``hyperedge_attention_bwd_cuda``, the wrapper of
``csrc/hyperedge_attention_bwd.cu`` (K2, the port of ``_bwd_kernel_fm`` /
``_bwd_kernel``), which ``_FusedAttention.backward`` launches for a CUDA
tensor.  K2 has two routes: bf16 (the training step's dtype) runs its 64-wide
products on the tensor cores, rounding the weights to bf16 where the plain
version rounds them; f32 runs them as f32 FMAs on the CUDA cores.

``hyperedge_attention.launches`` counts K1 launches and
``hyperedge_attention_bwd_cuda.launches`` K2 launches: each wrapper adds one
where it launches its kernel and nowhere else.

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
    bf16 with n_head <= 8 takes the tensor-core kernel (a cluster of one
    block per head, the heads' partials summed in rank order), everything
    else the CUDA-core kernel.  Raises on anything else."""
    _check_attention_args(x, ln, wq, wk, wv, fw, fb, n_head)
    E, L, d = x.shape
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


def hyperedge_attention_bwd_plain(x, ln, wq, wk, wv, fw, fb, g,
                                  n_head: int, diag_mask: bool = True):
    """Plain backward: autograd of ``hyperedge_attention_plain`` (the
    counterpart of ``jax.vjp(_fwd_xla)``) -> (gx, gln, gwq, gwk, gwv, gfw,
    gfb), each in its input's dtype."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (x, ln, wq, wk, wv, fw, fb)]
        y = hyperedge_attention_plain(*ins, n_head, diag_mask)
        return torch.autograd.grad(y, ins, g)


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    from matcha_tpu_torch.kernels.build import load_library
    lib = load_library("hyperedge_attention_bwd")
    lib.matcha_hyperedge_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.matcha_hyperedge_attention_bwd.restype = ctypes.c_int
    lib.matcha_hyperedge_attention_bwd_slices.argtypes = [ctypes.c_int] * 4
    lib.matcha_hyperedge_attention_bwd_slices.restype = ctypes.c_int
    lib.matcha_hyperedge_attention_bwd_slice_floats.argtypes = [ctypes.c_int]
    lib.matcha_hyperedge_attention_bwd_slice_floats.restype = (
        ctypes.c_longlong)
    lib.matcha_cuda_error_string.argtypes = [ctypes.c_int]
    lib.matcha_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_takes(x, wq, wk, wv, fw, n_head: int) -> bool:
    """Whether K1 and K2 take these shapes: x (E, L, D_MODEL) with
    2 <= L <= MAX_L, wq/wk/wv (D_MODEL, n_head * D_HEAD) and fw
    (n_head * D_HEAD, D_MODEL).  Shapes only, never the batch."""
    hd = n_head * D_HEAD
    return (x.dim() == 3 and x.shape[2] == D_MODEL
            and 2 <= x.shape[1] <= MAX_L
            and all(tuple(w.shape) == (D_MODEL, hd) for w in (wq, wk, wv))
            and tuple(fw.shape) == (hd, D_MODEL))


def _check_attention_args(x, ln, wq, wk, wv, fw, fb, n_head):
    """The argument checks both kernels share; -> hd = n_head * 64."""
    _check(x.is_cuda, "x must be a CUDA tensor")
    _check(x.dtype in (torch.float32, torch.bfloat16),
           f"x must be float32 or bfloat16, got {x.dtype}")
    _check(kernel_takes(x, wq, wk, wv, fw, n_head),
           f"x must be (E, L, {D_MODEL}) and L must be in [2, {MAX_L}], "
           f"wq/wk/wv ({D_MODEL}, n_head*{D_HEAD}), fw (n_head*{D_HEAD}, "
           f"{D_MODEL}); got x {tuple(x.shape)}, wq {tuple(wq.shape)}, wk "
           f"{tuple(wk.shape)}, wv {tuple(wv.shape)}, fw {tuple(fw.shape)} "
           f"with n_head {n_head}")
    d = D_MODEL
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
    return hd


def hyperedge_attention_bwd_cuda(x, ln, wq, wk, wv, fw, fb, g, n_head: int,
                                 diag_mask: bool = True):
    """Launch the backward kernel (K2) on ``torch.cuda.current_stream()``.

    Takes the forward's arguments (as ``hyperedge_attention_cuda`` checks
    them) and g, the cotangent of its output, of x's shape, dtype and
    device, contiguous.  -> (gx in x's dtype, gln, gwq, gwk, gwv, gfw, gfb in
    f32).  bf16 with n_head <= 8 takes the tensor-core kernel (a cluster of
    one block per head; its products in bf16 with f32 sums), f32 the
    CUDA-core kernel (f32 products).  The weight grads are summed
    deterministically: each persistent block (CUDA-core route) or cluster
    (tensor-core route) writes its own scratch slice and a second kernel
    sums the slices in order."""
    hd = _check_attention_args(x, ln, wq, wk, wv, fw, fb, n_head)
    _check(g.shape == x.shape and g.dtype == x.dtype
           and g.device == x.device,
           f"g must match x ({tuple(x.shape)}, {x.dtype}), got "
           f"{tuple(g.shape)}, {g.dtype}")
    _check(g.is_contiguous(), "g must be contiguous")
    if g.data_ptr() % 16:      # the kernels copy rows of g in 16-byte pieces
        g = g.clone()
    E, L, d = x.shape
    lib = _bwd_lib()
    is_bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        n_slices = lib.matcha_hyperedge_attention_bwd_slices(E, L, n_head,
                                                             is_bf16)
        if n_slices <= 0:
            raise RuntimeError("hyperedge_attention_bwd: no launch "
                               f"configuration fits the card ({n_slices})")
        n = lib.matcha_hyperedge_attention_bwd_slice_floats(n_head)
        gx = torch.empty_like(x)
        scratch = torch.empty((n_slices, n), dtype=torch.float32,
                              device=x.device)
        grads = torch.empty((n,), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.matcha_hyperedge_attention_bwd(
            x.data_ptr(), ln.data_ptr(), wq.data_ptr(), wk.data_ptr(),
            wv.data_ptr(), fw.data_ptr(), g.data_ptr(), gx.data_ptr(),
            scratch.data_ptr(), grads.data_ptr(), E, L, n_head,
            int(diag_mask), is_bf16, n_slices, stream)
    if err != 0:
        raise RuntimeError("hyperedge_attention_bwd kernel launch failed: "
                           f"{lib.matcha_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")
    hyperedge_attention_bwd_cuda.launches += 1
    w = d * hd
    gwq, gwk, gwv, gfw, gln, gfb = torch.split(grads, [w, w, w, w, 6 * d, d])
    return (gx, gln.view(6, d), gwq.view(d, hd), gwk.view(d, hd),
            gwv.view(d, hd), gfw.view(hd, d), gfb)


hyperedge_attention_bwd_cuda.launches = 0


class _FusedAttention(torch.autograd.Function):
    """The CUDA forward (K1) whose backward is the CUDA backward (K2).  The
    inputs are saved and the forward recomputed inside K2, as the JAX
    package's custom VJP does (``_vjp_fwd`` / ``_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, x, ln, wq, wk, wv, fw, fb, n_head, diag_mask):
        ctx.save_for_backward(x, ln, wq, wk, wv, fw, fb)
        ctx.n_head, ctx.diag_mask = n_head, diag_mask
        return hyperedge_attention_cuda(x, ln, wq, wk, wv, fw, fb, n_head,
                                        diag_mask)

    @staticmethod
    def backward(ctx, g):
        grads = hyperedge_attention_bwd_cuda(*ctx.saved_tensors,
                                             g.contiguous(), ctx.n_head,
                                             ctx.diag_mask)
        return (*grads, None, None)


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
