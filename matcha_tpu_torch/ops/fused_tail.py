"""Fused classifier tail: dropout -> pff_n1 -> LayerNorms -> (dyn - static)^2
-> classifier, over the merged token stream, forward and backward.

Port of ``matcha_tpu/ops/fused_tail.py``.  Per token, from the attention
output y and the static stream h (both (T, d) in the compute dtype):

    d0  = y * m0                        (dropout 0.3, rounded to y's dtype)
    h1  = tanh(d0 @ w1 + b1)            (f32)
    hd  = h1 * m1                       (dropout 0.4, rounded)
    o   = hd @ w2 + b2 + d0             (rounded)
    dynamic = LN_dynamic(LN_pff_n1(o)), static = LN_static(h)
    pp  = sum((dynamic - static)^2 * wc) + bc      (f32, from the f32 diff)

rounded where the JAX package's ``_stage_fwd`` rounds, with f32 LayerNorm
statistics and f32 sums.  Functions:

  * ``fused_tail_plain`` / ``fused_tail_bwd_plain`` — the plain PyTorch
    versions; the backward is written out in the math of the TPU kernel
    ``_bwd_kernel`` (the forward recomputed, operands rounded where it
    rounds), not taken from autograd;
  * ``fused_tail_fwd_cuda`` / ``fused_tail_bwd_cuda`` — the wrappers of
    ``csrc/fused_tail.cu`` (K6, the ports of ``_ft_fwd`` / ``_ft_bwd``);
  * ``fused_tail`` — an autograd Function: a CPU tensor takes the plain
    versions, a CUDA tensor launches the kernels or raises.

``fused_tail_fwd_cuda.launches`` and ``fused_tail_bwd_cuda.launches`` count
the two kernels' launches.

Dropout masks.  The TPU kernel draws its bits from the TPU's own generator
(seeded with seed + block), which nothing else reproduces.  Here the bits of
token t, feature c in mask stream s (0: the attention output, 1: the hidden
layer) are ``fmix32(key_s + (t * d + c) * 0x9E3779B9)`` with ``key_s =
fmix32(seed ^ salt_s)`` (the murmur3 finalizer of the Bloom filter's hash):
a counter-based generator that the kernels and the plain version compute bit
for bit, independent of any tile size, so the backward regenerates the
forward's masks and the two can be compared in train mode.  The bits become
a mask as ``bits_to_mask`` does in the JAX package: top 24 bits -> u in
[0, 1), keep iff u >= rate, scaled by 1 / (1 - rate).  The noise differs
from the JAX package's; its distribution is the same.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from matcha_tpu_torch.sampler.bloom import _M32, _mix

D = 64                         # the kernels' model width
_EPS = 1e-5
_GOLDEN = 0x9E3779B9
_SALT = (0x3C6EF372, 0xA54FF53A)   # mask streams 0 (rate r0) and 1 (rate r1)


def pack_ln6(ln_pff, ln_dyn, ln_st) -> torch.Tensor:
    """The (6, d) f32 LayerNorm stack in the row order the kernels index
    (pff_n1 ln g/b, ln_dynamic g/b, ln_static g/b): the only place that
    order is defined."""
    return torch.stack([ln_pff["g"], ln_pff["b"], ln_dyn["g"], ln_dyn["b"],
                        ln_st["g"], ln_st["b"]]).to(torch.float32)


def _fmix32(x: int) -> int:
    """murmur3 finalizer on a Python int (the host side of ``_mix``)."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def stream_key(seed: int, stream: int) -> int:
    """The 32-bit key of mask stream 0 or 1 for ``seed``."""
    return _fmix32((int(seed) ^ _SALT[stream]) & _M32)


def dropout_bits(seed: int, stream: int, T: int, d: int,
                 device) -> torch.Tensor:
    """(T, d) int64 tensor of the 32-bit random words of one mask stream."""
    idx = torch.arange(T * d, dtype=torch.int64, device=device).reshape(T, d)
    return _mix((stream_key(seed, stream) + idx * _GOLDEN) & _M32)


def bits_to_mask(bits: torch.Tensor, rate: float) -> torch.Tensor:
    """uint32 random words (held in int64, or uint32) -> the inverted-dropout
    keep mask in f32: top 24 bits -> u in [0, 1), keep iff u >= rate, scaled
    by 1 / (1 - rate)."""
    u = (bits.to(torch.int64) >> 8).to(torch.float32) * (1.0 / (1 << 24))
    rate32 = torch.tensor(rate, dtype=torch.float32, device=bits.device)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32,
                         device=bits.device)
    return torch.where(u >= rate32, scale, torch.zeros_like(scale))


def tail_masks(seed: int, T: int, d: int, r0: float, r1: float, train: bool,
               device) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(m0, m1) f32 (T, d) masks of the two dropouts, None where a dropout
    is off (eval mode or rate 0)."""
    m0 = (bits_to_mask(dropout_bits(seed, 0, T, d, device), r0)
          if train and r0 > 0.0 else None)
    m1 = (bits_to_mask(dropout_bits(seed, 1, T, d, device), r1)
          if train and r1 > 0.0 else None)
    return m0, m1


def _ln_fwd(x, g, b):
    """LayerNorm over features with f32 statistics -> (out in x's dtype,
    xhat f32, 1/sigma f32)."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    inv = torch.rsqrt(var + _EPS)
    xhat = (x32 - mu) * inv
    return (xhat * g + b).to(x.dtype), xhat, inv


def _ln_bwd(g_out, xhat, inv, g):
    """Upstream grad (f32), xhat, 1/sigma and the scale -> (g_x f32, g_scale,
    g_bias) summed over tokens."""
    gx = g_out * g
    g_x = inv * (gx - gx.mean(dim=-1, keepdim=True)
                 - xhat * (gx * xhat).mean(dim=-1, keepdim=True))
    return g_x, (g_out * xhat).sum(dim=0), g_out.sum(dim=0)


def _stage_fwd(y, h, ln6, w1, b1, w2, b2, m0, m1):
    """The fused chain over all tokens; every intermediate the backward
    needs.  Products take the rounded operands in f32 (exact products, f32
    sums), as the TPU kernel's f32-accumulating dots do."""
    dt = y.dtype
    d0 = (y.float() * m0).to(dt) if m0 is not None else y
    h1 = torch.tanh(d0.float() @ w1.to(dt).float() + b1.float())
    hd = (h1 * m1).to(dt) if m1 is not None else h1.to(dt)
    o = (hd.float() @ w2.to(dt).float() + b2.float() + d0.float()).to(dt)
    dyn, xo, inv_o = _ln_fwd(o, ln6[0], ln6[1])
    dynamic, xd, inv_d = _ln_fwd(dyn, ln6[2], ln6[3])
    static, xs, inv_s = _ln_fwd(h, ln6[4], ln6[5])
    diff = dynamic.float() - static.float()
    return d0, h1, hd, xo, inv_o, xd, inv_d, xs, inv_s, diff


def fused_tail_plain(y, h, ln6, w1, b1, w2, b2, wc, bc, seed: int,
                     r0: float, r1: float, train: bool) -> torch.Tensor:
    """Plain forward -> (T, 1) f32 per-position logits.  y, h (T, d) in the
    compute dtype; ln6 (6, d), w1/w2 (d, d), b1/b2 (d,), wc (d, 1), bc (1,)
    f32."""
    T, d = y.shape
    m0, m1 = tail_masks(seed, T, d, r0, r1, train, y.device)
    diff = _stage_fwd(y, h, ln6, w1, b1, w2, b2, m0, m1)[-1]
    return ((diff * diff * wc.float().reshape(1, d)).sum(dim=-1, keepdim=True)
            + bc.float())


def fused_tail_bwd_plain(y, h, ln6, w1, b1, w2, b2, wc, bc, g, seed: int,
                         r0: float, r1: float, train: bool):
    """Plain backward for the cotangent g (T, 1) of the logits, in the math
    of the TPU kernel ``_bwd_kernel`` -> (gy, gh in their inputs' dtypes;
    gln (6, d), gw1, gb1, gw2, gb2, gwc, gbc in their params' shapes and
    dtypes), the param grads summed over tokens in f32."""
    T, d = y.shape
    dt = y.dtype
    m0, m1 = tail_masks(seed, T, d, r0, r1, train, y.device)
    (d0, h1, hd, xo, inv_o, xd, inv_d, xs, inv_s,
     diff) = _stage_fwd(y, h, ln6, w1, b1, w2, b2, m0, m1)
    g = g.float().reshape(T, 1)
    g_out = g * wc.float().reshape(1, d)
    gwc = ((diff * diff).to(dt).float() * g).sum(dim=0)
    gbc = g.sum(dim=0)
    g_diff = 2.0 * diff * g_out
    g_dyn, g_gd, g_bd = _ln_bwd(g_diff, xd, inv_d, ln6[2])
    g_h, g_gs, g_bs = _ln_bwd(-g_diff, xs, inv_s, ln6[4])
    g_o, g_gp, g_bp = _ln_bwd(g_dyn, xo, inv_o, ln6[0])
    g_o_dt = g_o.to(dt).float()
    g_hd = g_o_dt @ w2.to(dt).float().T
    gw2 = hd.float().T @ g_o_dt
    gb2 = g_o.sum(dim=0)
    g_h1 = g_hd * m1 if m1 is not None else g_hd
    g_a1 = g_h1 * (1.0 - h1 * h1)
    g_a1_dt = g_a1.to(dt).float()
    g_d0 = g_a1_dt @ w1.to(dt).float().T + g_o                  # residual
    gw1 = d0.float().T @ g_a1_dt
    gb1 = g_a1.sum(dim=0)
    g_y = g_d0 * m0 if m0 is not None else g_d0
    gln = torch.stack([g_gp, g_bp, g_gd, g_bd, g_gs, g_bs])
    return (g_y.to(y.dtype), g_h.to(h.dtype), gln, gw1.to(w1.dtype),
            gb1.to(b1.dtype), gw2.to(w2.dtype), gb2.to(b2.dtype),
            gwc.reshape(wc.shape).to(wc.dtype), gbc.to(bc.dtype))


# ------------------------------------------------------------------ kernels
@functools.lru_cache(maxsize=None)
def _lib():
    from matcha_tpu_torch.kernels.build import load_library
    lib = load_library("fused_tail")
    tail = [ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_int, ctypes.c_int] + [ctypes.c_float] * 4
    lib.matcha_fused_tail_fwd.argtypes = (
        [ctypes.c_void_p] * 10 + tail + [ctypes.c_void_p])
    lib.matcha_fused_tail_fwd.restype = ctypes.c_int
    lib.matcha_fused_tail_bwd.argtypes = (
        [ctypes.c_void_p] * 14 + tail + [ctypes.c_int, ctypes.c_void_p])
    lib.matcha_fused_tail_bwd.restype = ctypes.c_int
    lib.matcha_fused_tail_bwd_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.matcha_fused_tail_bwd_blocks.restype = ctypes.c_int
    lib.matcha_fused_tail_bwd_slice_floats.argtypes = []
    lib.matcha_fused_tail_bwd_slice_floats.restype = ctypes.c_int
    lib.matcha_cuda_error_string.argtypes = [ctypes.c_int]
    lib.matcha_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"fused_tail: {msg}")


def _check_args(y, h, ln6, w1, b1, w2, b2, wc, bc):
    _check(y.is_cuda, "y must be a CUDA tensor")
    _check(y.dtype in (torch.float32, torch.bfloat16),
           f"y must be float32 or bfloat16, got {y.dtype}")
    _check(y.dim() == 2 and y.shape[1] == D,
           f"y must be (T, {D}), got {tuple(y.shape)}")
    _check(h.shape == y.shape and h.dtype == y.dtype,
           f"h must match y ({tuple(y.shape)}, {y.dtype}), got "
           f"{tuple(h.shape)}, {h.dtype}")
    params = {"ln6": (ln6, 6 * D), "w1": (w1, D * D), "b1": (b1, D),
              "w2": (w2, D * D), "b2": (b2, D), "wc": (wc, D), "bc": (bc, 1)}
    for name, (t, numel) in params.items():
        _check(t.numel() == numel, f"{name} must hold {numel} values, got "
                                   f"{tuple(t.shape)}")
        _check(t.dtype == torch.float32, f"{name} must be float32")
    for name, t in [("y", y), ("h", h)] + [(n, t) for n, (t, _) in
                                           params.items()]:
        _check(t.device == y.device, f"{name} must be on {y.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")


def _mask_args(seed, r0, r1, train):
    use0, use1 = bool(train and r0 > 0.0), bool(train and r1 > 0.0)
    return (stream_key(seed, 0), stream_key(seed, 1), int(use0), int(use1),
            float(r0), float(r1), 1.0 / (1.0 - r0) if use0 else 1.0,
            1.0 / (1.0 - r1) if use1 else 1.0)


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def fused_tail_fwd_cuda(y, h, ln6, w1, b1, w2, b2, wc, bc, seed: int,
                        r0: float, r1: float, train: bool) -> torch.Tensor:
    """Launch the K6 forward on ``torch.cuda.current_stream()``: y, h
    (T, 64) f32 or bf16 of one dtype; ln6 (6, 64), w1/w2 (64, 64), b1/b2
    (64,), wc (64 values), bc (1,) f32; all contiguous on y's card ->
    (T, 1) f32.  bf16 takes the tensor-core kernel (its two products in
    bf16 with f32 sums, rounded where the plain version rounds), f32 the
    CUDA-core kernel.  Raises on anything else."""
    _check_args(y, h, ln6, w1, b1, w2, b2, wc, bc)
    T = y.shape[0]
    pp = torch.empty((T, 1), dtype=torch.float32, device=y.device)
    lib = _lib()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.matcha_fused_tail_fwd(
            *_ptrs(y, h, ln6, w1, b1, w2, b2, wc, bc, pp), T,
            int(y.dtype == torch.bfloat16), *_mask_args(seed, r0, r1, train),
            stream)
    if err != 0:
        raise RuntimeError("fused_tail_fwd kernel launch failed: "
                           f"{lib.matcha_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")
    fused_tail_fwd_cuda.launches += 1
    return pp


def fused_tail_bwd_cuda(y, h, ln6, w1, b1, w2, b2, wc, bc, g, seed: int,
                        r0: float, r1: float, train: bool):
    """Launch the K6 backward on ``torch.cuda.current_stream()``: the
    forward's arguments (checked as ``fused_tail_fwd_cuda`` checks them) and
    g, the (T, 1) cotangent of the logits -> the grads of
    ``fused_tail_bwd_plain``.  bf16 takes the tensor-core kernel (its
    products in bf16 with f32 sums, rounded where the plain version rounds),
    f32 the CUDA-core kernel.  The param grads are summed deterministically:
    each block of the persistent grid adds its tokens' partials in a fixed
    order into its own scratch slice, and a second kernel sums the slices
    in block order."""
    _check_args(y, h, ln6, w1, b1, w2, b2, wc, bc)
    T = y.shape[0]
    g = g.reshape(-1).to(torch.float32).contiguous()
    _check(g.shape == (T,) and g.device == y.device,
           f"g must hold {T} values on {y.device}")
    lib = _lib()
    is_bf16 = int(y.dtype == torch.bfloat16)
    with torch.cuda.device(y.device):
        n_blocks = lib.matcha_fused_tail_bwd_blocks(T, is_bf16)
        n = lib.matcha_fused_tail_bwd_slice_floats()
        gy, gh = torch.empty_like(y), torch.empty_like(h)
        scratch = torch.empty((n_blocks, n), dtype=torch.float32,
                              device=y.device)
        grads = torch.empty((n,), dtype=torch.float32, device=y.device)
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.matcha_fused_tail_bwd(
            *_ptrs(y, h, ln6, w1, b1, w2, b2, wc, bc, g, gy, gh, scratch,
                   grads), T, is_bf16, *_mask_args(seed, r0, r1, train),
            n_blocks, stream)
    if err != 0:
        raise RuntimeError("fused_tail_bwd kernel launch failed: "
                           f"{lib.matcha_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")
    fused_tail_bwd_cuda.launches += 1
    gw1, gw2, gln, gb1, gb2, gwc, gbc = torch.split(
        grads, [D * D, D * D, 6 * D, D, D, D, 1])
    return (gy, gh, gln.view(6, D), gw1.view(w1.shape), gb1.view(b1.shape),
            gw2.view(w2.shape), gb2.view(b2.shape), gwc.view(wc.shape),
            gbc.view(bc.shape))


fused_tail_fwd_cuda.launches = 0
fused_tail_bwd_cuda.launches = 0


class _FusedTail(torch.autograd.Function):
    """The forward whose backward recomputes it (``_ft_fwd`` /
    ``_ft_bwd``): kernels on a CUDA tensor, the plain versions on a CPU
    tensor.  The seed, rates and mode carry no gradient."""

    @staticmethod
    def forward(ctx, y, h, ln6, w1, b1, w2, b2, wc, bc, seed, r0, r1, train):
        ctx.save_for_backward(y, h, ln6, w1, b1, w2, b2, wc, bc)
        ctx.consts = (seed, r0, r1, train)
        fwd = fused_tail_fwd_cuda if y.is_cuda else fused_tail_plain
        return fwd(y, h, ln6, w1, b1, w2, b2, wc, bc, seed, r0, r1, train)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        bwd = fused_tail_bwd_cuda if saved[0].is_cuda else fused_tail_bwd_plain
        grads = bwd(*saved, g, *ctx.consts)
        return (*grads, None, None, None, None)


def fused_tail(y, h, ln6, w1, b1, w2, b2, wc, bc, seed: int, r0: float,
               r1: float, train: bool) -> torch.Tensor:
    """(T, 1) f32 per-position classifier logits from the attention output
    y (before its dropout) and the static stream h, differentiable in every
    tensor argument.  A CPU tensor takes the plain versions; a CUDA tensor
    launches the kernels (any T: they mask their ragged edge) or raises."""
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_tail: no kernel for {y.device}")
    return _FusedTail.apply(y.contiguous(), h.contiguous(), ln6.contiguous(),
                            w1.contiguous(), b1.contiguous(),
                            w2.contiguous(), b2.contiguous(),
                            wc.contiguous(), bc.contiguous(), int(seed),
                            float(r0), float(r1), bool(train))


SHARD_SEED_STRIDE = 1 << 20


def fused_tail_sharded(y, h, ln6, w1, b1, w2, b2, wc, bc, seed: int,
                       r0: float, r1: float, train: bool,
                       mesh) -> torch.Tensor:
    """``fused_tail`` of this rank's token block under a mesh (the
    counterpart of the JAX package's ``fused_tail_sharded``).  The mask
    rule is the JAX package's: the seed is offset by the rank's data index
    times 2^20 (the data index only, also on a mixed mesh: the model ranks
    of one data row draw the same counter stream), and the counters run
    over the rank's local token index.  The weights' gradients are summed
    over the ranks by the Trainer's one gradient all-reduce."""
    return fused_tail(y, h, ln6, w1, b1, w2, b2, wc, bc,
                      int(seed) + int(mesh.data_index) * SHARD_SEED_STRIDE,
                      r0, r1, train)
