"""Functional neural-net building blocks on tensors.

Port of ``matcha_tpu/models/modules.py``.  Parameters are plain nested dicts
of tensors in the JAX ``(in, out)`` layout, so ``x @ w`` compares like with
like; applies are plain functions.  All activations are tanh and LayerNorm
eps is 1e-5 with f32 statistics.  Weights follow the activation dtype (bf16
compute keeps f32 master params; the casts are no-ops in full f32).

Randomness comes from explicit CPU ``torch.Generator``s, the counterpart of
JAX keys: ``split_generator`` derives independent child generators (as
``jax.random.split`` derives keys), and a dropout draws its mask on the
tensor's device from a seed taken from its generator, so no draw ever waits
on the device.  A ``None`` generator disables dropout, as a ``None`` key does
in the JAX package.  Initializers draw with the same distributions as the
JAX package (the numbers differ: the two frameworks' random streams are not
the same):
  * linear: U(±1/sqrt(fan_in)) for weight and bias
  * attention projections: Normal(0, sqrt(2/(d_model+d_k)))
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from matcha_tpu_torch.ops.hyperedge_attention import (hyperedge_attention,
                                                      kernel_takes, pack_ln)
from matcha_tpu_torch.parallel.mesh import (active_data_mesh,
                                            all_gather_blocks,
                                            reduce_scatter_blocks)

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
def split_generator(gen: Optional[torch.Generator],
                    n: int) -> List[Optional[torch.Generator]]:
    """n independent CPU child generators seeded from ``gen`` (the
    counterpart of ``jax.random.split``); ``None`` gives n ``None``s."""
    if gen is None:
        return [None] * n
    seeds = torch.randint(0, 2 ** 62, (n,), generator=gen).tolist()
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def rand(gen: torch.Generator, shape, device) -> torch.Tensor:
    """U[0, 1) f32 of ``shape`` drawn on ``device`` by a generator there,
    seeded from the CPU generator ``gen``."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    return torch.rand(shape, device=device,
                      generator=torch.Generator(device=device).manual_seed(
                          seed))


def dropout(x, rate: float, train: bool = False,
            generator: Optional[torch.Generator] = None, rows=None):
    """Inverted dropout (torch semantics).  No-op in eval, at rate 0, or
    without a generator.

    rows: (n, index) when x holds some rows of a tensor of n rows (a rank's
    rows under a mesh): the mask is drawn for all n rows, as the whole
    tensor would draw it, and x takes its rows' ``mask[index]`` (index a
    slice or an int64 tensor)."""
    if not train or generator is None or rate <= 0.0:
        return x
    if rows is None:
        keep = rand(generator, x.shape, x.device) < 1.0 - rate
    else:
        n, index = rows
        keep = (rand(generator, (int(n),) + tuple(x.shape[1:]), x.device)
                < 1.0 - rate)[index]
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


# ------------------------------------------------------- feed-forward MLPs
def feed_forward_init(gen: torch.Generator, dims: Sequence[int],
                      use_bias: bool = True) -> Params:
    return {"layers": [linear_init(gen, dims[i], dims[i + 1], use_bias)
                       for i in range(len(dims) - 1)]}


def feed_forward(p: Params, x, *, generator=None, drop_rate: float = 0.0,
                 train: bool = False):
    layers = p["layers"]
    for lp in layers[:-1]:
        x = tanh(linear(lp, x))
        if drop_rate > 0.0:
            generator, gd = split_generator(generator, 2)
            x = dropout(x, drop_rate, train, gd)
    return linear(layers[-1], x)


def pff_init(gen: torch.Generator, dims: Sequence[int], use_bias: bool = True,
             layer_norm_flag: bool = False) -> Params:
    p = feed_forward_init(gen, dims, use_bias)
    if layer_norm_flag:
        p["ln"] = layer_norm_init(dims[-1])
    return p


def pff(p: Params, x, *, residual: bool = False, generator=None,
        drop_rate: float = 0.0, train: bool = False, drop_rows=None):
    """tanh-MLP with dropout between layers, then (iff dims[0] == dims[-1])
    residual add and LayerNorm.  drop_rows: ``dropout``'s rows."""
    out = x
    layers = p["layers"]
    for lp in layers[:-1]:
        out = tanh(linear(lp, out))
        generator, gd = split_generator(generator, 2)
        out = dropout(out, drop_rate, train, gd, drop_rows)
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


def _attention_flat(p: Params, x, n_head: int, d_k: int, d_v: int,
                    diag_mask: bool):
    """The JAX package's own formulation for shapes the kernel does not
    take (``matcha_tpu/models/modules.py:mha_dynamic``): flat projections
    over the (b*L, d) token stream, scores as f32 products summed in f32, an
    f32 softmax, and the a.v sum in f32 rounded to x's dtype.  Autograd
    gives its backward."""
    b, L, _ = x.shape
    xf = x.reshape(b * L, x.shape[-1])
    q = (layer_norm(p["ln_q"], xf) @ p["wq"].to(x.dtype)).reshape(
        b, L, n_head, d_k)
    k = (layer_norm(p["ln_k"], xf) @ p["wk"].to(x.dtype)).reshape(
        b, L, n_head, d_k)
    v = (layer_norm(p["ln_v"], xf) @ p["wv"].to(x.dtype)).reshape(
        b, L, n_head, d_v)
    inv_temp = 1.0 / math.sqrt(d_k)
    pos = torch.arange(L, device=x.device)
    outs = []
    for qp in range(L):
        # scores of query position qp against all keys: (b, L, H)
        s = (q[:, qp:qp + 1].float() * k.float()).sum(dim=-1) * inv_temp
        if diag_mask:
            s = s.masked_fill((pos == qp)[None, :, None], -1e32)
        prob = torch.softmax(s, dim=1)
        outs.append((prob[..., None] * v.float()).sum(dim=1)
                    .to(x.dtype))                              # (b, H, d_v)
    out = torch.stack(outs, dim=1).reshape(b * L, n_head * d_v)
    return linear(p["fc1"], out).reshape(b, L, -1)


def mha_fused(p: Params, x, n_head: int, diag_mask: bool, mesh=None):
    """The fused hyperedge attention (K1 forward, K2 backward on a CUDA
    tensor).  Under a mesh (``parallel.mesh``) x holds this rank's rows of
    the edges (``rank_rows``), which go through the kernels; the weights
    are replicated, and their gradients are summed over the ranks by the
    Trainer's one gradient all-reduce, as the JAX package's shard_map
    transpose sums them over its kernel axes.  Under tensor parallelism x
    holds the rank's data row's rows and the weights its block of the
    heads (``mha_dynamic``); n_head is then the block's head count."""
    del mesh     # the rows are the rank's already; see the docstring
    return hyperedge_attention(x, pack_ln(p), p["wq"], p["wk"], p["wv"],
                               p["fc1"]["w"], p["fc1"]["b"], n_head,
                               diag_mask)


def _head_block(p: Params, n_head: int, d_k: int, mesh) -> int:
    """The number of heads this rank's attention weights hold: n_head, or
    n_head / M where they hold one model rank's block of the heads (the
    tensor-parallel placement, ``parallel.mesh.replicate_params``)."""
    held = p["wq"].shape[1] // d_k
    m = 1 if mesh is None else mesh.shape["model"]
    if held != n_head and held * m != n_head:
        raise ValueError(f"the attention weights hold {held} of {n_head} "
                         f"heads under a model axis of {m}")
    return held


def _attention(p: Params, x, n_head: int, d_k: int, d_v: int,
               diag_mask: bool):
    """The attention on the heads the weights hold: the k = 2 closed form,
    the fused kernels where they take the shape, else the JAX package's
    formulation."""
    if diag_mask and x.shape[1] == 2:
        # each row of the softmax has one unmasked key: weight 1 on the other
        # member, so the output is fc1(v_other)
        v = layer_norm(p["ln_v"], x) @ p["wv"].to(x.dtype)
        return linear(p["fc1"], v.flip(1))
    if kernel_takes(x, p["wq"], p["wk"], p["wv"], p["fc1"]["w"], n_head):
        return mha_fused(p, x, n_head, diag_mask, active_data_mesh())
    return _attention_flat(p, x, n_head, d_k, d_v, diag_mask)


def mha_dynamic(p: Params, x, n_head: int, d_k: int, d_v: int, *,
                diag_mask: bool = True, generator=None,
                drop_rate: float = 0.0, train: bool = False, drop_rows=None,
                group_rows=None):
    """Self-excluding (diag-masked) self-attention over one hyperedge.

    Pads take part as keys and values: the reference never applies its
    key-pad mask (see ``matcha_tpu/models/modules.py:mha_dynamic``).
    k=2 with the diagonal masked has a closed form and never reaches the
    kernel.  Every other shape the kernel takes (``kernel_takes``) goes to
    the fused hyperedge attention, which on a CUDA tensor launches the
    Hopper kernel for any batch size; the rest goes to the JAX package's
    own formulation (``_attention_flat``) on either device, as the JAX
    package routes it.  The output takes dropout ``drop_rate`` in train
    mode (drop_rows: ``dropout``'s rows).

    Tensor parallelism: when the weights hold one model rank's block of
    the heads (``_head_block``), x holds this rank's rows and
    ``group_rows`` the row counts of its data row's M ranks
    (``parallel.mesh.model_group_rows``).  The data row's rows are
    gathered over the model group, the rank's heads run on all of them by
    the same routes (K1/K2 at the block's head count), fc1's bias is added
    at model rank 0 only, and a reduce-scatter sums the heads' partials
    back onto the rank's own rows."""
    mesh = active_data_mesh()
    held = _head_block(p, n_head, d_k, mesh)
    if held == n_head:
        out = _attention(p, x, n_head, d_k, d_v, diag_mask)
    else:
        if group_rows is None:
            raise ValueError("mha_dynamic: head-sharded weights need the "
                             "data row's row counts (group_rows)")
        xd = all_gather_blocks(x, group_rows, mesh.model_group)
        if mesh.model_index:
            p = {**p, "fc1": {"w": p["fc1"]["w"],
                              "b": torch.zeros_like(p["fc1"]["b"])}}
        out = reduce_scatter_blocks(_attention(p, xd, held, d_k, d_v,
                                               diag_mask),
                                    group_rows, mesh.model_group)
    return dropout(out, drop_rate, train, generator, drop_rows)


def encoder_layer_init(gen: torch.Generator, n_head: int, d_model: int,
                       d_k: int, d_v: int, bottle_neck: int) -> Params:
    return {
        "mha": mha_init(gen, n_head, d_model, d_k, d_v, bottle_neck),
        "pff_n1": pff_init(gen, [d_model, d_model, d_model],
                           layer_norm_flag=True),
    }


def encoder_layer(p: Params, x, non_pad_mask, n_head: int, d_k: int,
                  d_v: int, *, diag_mask: bool = True, generator=None,
                  train: bool = False, drop_rows=None, group_rows=None):
    """Returns (dynamic, static); static is the unmodified input, as in the
    reference (Code/Modules.py:611-617).  Dropouts: 0.3 after attention fc1,
    0.4 inside pff_n1 (drop_rows: ``dropout``'s rows of x's batch;
    group_rows: ``mha_dynamic``'s)."""
    ga, gp = split_generator(generator, 2)
    dyn = mha_dynamic(p["mha"], x, n_head, d_k, d_v, diag_mask=diag_mask,
                      generator=ga, drop_rate=0.3, train=train,
                      drop_rows=drop_rows, group_rows=group_rows)
    dyn = pff(p["pff_n1"], dyn * non_pad_mask, residual=True, generator=gp,
              drop_rate=0.4, train=train,
              drop_rows=drop_rows) * non_pad_mask
    return dyn, x
