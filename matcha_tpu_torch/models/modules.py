"""Functional neural-net building blocks on tensors (eval mode).

Port of ``matcha_tpu/models/modules.py``.  Parameters are plain nested dicts
of tensors in the JAX ``(in, out)`` layout, so ``x @ w`` compares like with
like; applies are plain functions.  All activations are tanh and LayerNorm
eps is 1e-5 with f32 statistics.  Weights follow the activation dtype (bf16
compute keeps f32 master params; the casts are no-ops in full f32).

Initializers draw from an explicit ``torch.Generator`` with the same
distributions as the JAX package (the numbers differ: the two frameworks'
random streams are not the same):
  * linear: U(±1/sqrt(fan_in)) for weight and bias
  * attention projections: Normal(0, sqrt(2/(d_model+d_k)))
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from matcha_tpu_torch.ops.hyperedge_attention import (hyperedge_attention,
                                                      pack_ln)

Params = Dict


def tanh(x):
    return torch.tanh(x)


# ------------------------------------------------------------------ linear
def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                use_bias: bool = True) -> Params:
    bound = 1.0 / math.sqrt(in_dim)
    p = {"w": _uniform(gen, (in_dim, out_dim), bound)}
    if use_bias:
        p["b"] = _uniform(gen, (out_dim,), bound)
    return p


def linear(p: Params, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def normal_init(gen: torch.Generator, in_dim: int, out_dim: int,
                std: float) -> torch.Tensor:
    return std * torch.randn((in_dim, out_dim), generator=gen)


# --------------------------------------------------------------- layernorm
def layer_norm_init(dim: int) -> Params:
    return {"g": torch.ones(dim), "b": torch.zeros(dim)}


def layer_norm(p: Params, x, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.to(torch.float32)            # stats in f32 even in bf16 compute
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]).to(dt)


# ----------------------------------------------------------------- dropout
def dropout(x, rate: float, train: bool = False):
    """Inverted dropout; eval mode only in this slice of the port."""
    if not train or rate <= 0.0:
        return x
    raise NotImplementedError("train-mode dropout comes with the training "
                              "slice of the port")


# ------------------------------------------------------- feed-forward MLPs
def feed_forward_init(gen: torch.Generator, dims: Sequence[int],
                      use_bias: bool = True) -> Params:
    return {"layers": [linear_init(gen, dims[i], dims[i + 1], use_bias)
                       for i in range(len(dims) - 1)]}


def feed_forward(p: Params, x):
    layers = p["layers"]
    for lp in layers[:-1]:
        x = tanh(linear(lp, x))
    return linear(layers[-1], x)


def pff_init(gen: torch.Generator, dims: Sequence[int], use_bias: bool = True,
             layer_norm_flag: bool = False) -> Params:
    p = feed_forward_init(gen, dims, use_bias)
    if layer_norm_flag:
        p["ln"] = layer_norm_init(dims[-1])
    return p


def pff(p: Params, x, *, residual: bool = False):
    """tanh-MLP, then (iff dims[0] == dims[-1]) residual add and LayerNorm."""
    out = x
    layers = p["layers"]
    for lp in layers[:-1]:
        out = tanh(linear(lp, out))
    out = linear(layers[-1], out)
    if layers[0]["w"].shape[0] == layers[-1]["w"].shape[1]:
        if residual:
            out = out + x
        if "ln" in p:
            out = layer_norm(p["ln"], out)
    return out


# ------------------------------------------------- static/dynamic attention
def mha_init(gen: torch.Generator, n_head: int, d_model: int, d_k: int,
             d_v: int, input_dim: int) -> Params:
    std_qk = math.sqrt(2.0 / (d_model + d_k))
    std_v = math.sqrt(2.0 / (d_model + d_v))
    return {
        "ln_q": layer_norm_init(input_dim),
        "ln_k": layer_norm_init(input_dim),
        "ln_v": layer_norm_init(input_dim),
        "wq": normal_init(gen, input_dim, n_head * d_k, std_qk),
        "wk": normal_init(gen, input_dim, n_head * d_k, std_qk),
        "wv": normal_init(gen, input_dim, n_head * d_v, std_v),
        "fc1": linear_init(gen, n_head * d_v, d_model),
    }


def mha_dynamic(p: Params, x, n_head: int, d_k: int, d_v: int, *,
                diag_mask: bool = True):
    """Self-excluding (diag-masked) self-attention over one hyperedge.

    Pads take part as keys and values: the reference never applies its
    key-pad mask (see ``matcha_tpu/models/modules.py:mha_dynamic``).
    k=2 with the diagonal masked has a closed form and never reaches the
    kernel; every other shape goes to the fused hyperedge attention, which
    on a CUDA tensor launches the Hopper kernel for any batch size."""
    if diag_mask and x.shape[1] == 2:
        # each row of the softmax has one unmasked key: weight 1 on the other
        # member, so the output is fc1(v_other)
        v = layer_norm(p["ln_v"], x) @ p["wv"].to(x.dtype)
        return linear(p["fc1"], v.flip(1))
    return hyperedge_attention(x, pack_ln(p), p["wq"], p["wk"], p["wv"],
                               p["fc1"]["w"], p["fc1"]["b"], n_head,
                               diag_mask)


def encoder_layer_init(gen: torch.Generator, n_head: int, d_model: int,
                       d_k: int, d_v: int, bottle_neck: int) -> Params:
    return {
        "mha": mha_init(gen, n_head, d_model, d_k, d_v, bottle_neck),
        "pff_n1": pff_init(gen, [d_model, d_model, d_model],
                           layer_norm_flag=True),
    }


def encoder_layer(p: Params, x, non_pad_mask, n_head: int, d_k: int,
                  d_v: int, *, diag_mask: bool = True):
    """Returns (dynamic, static); static is the unmodified input, as in the
    reference (Code/Modules.py:611-617).  Eval mode: dropouts are no-ops."""
    dyn = mha_dynamic(p["mha"], x, n_head, d_k, d_v, diag_mask=diag_mask)
    dyn = pff(p["pff_n1"], dyn * non_pad_mask, residual=True) * non_pad_mask
    return dyn, x
