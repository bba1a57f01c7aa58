"""The ("data", "model") mesh on ``torch.distributed``: one process per
rank, the placement rules, the active-mesh scope and the collectives the
model uses.

Port of ``matcha_tpu/parallel/mesh.py``.  JAX runs one SPMD program over a
device mesh; here each rank is a process (``torchrun``, or
``torch.multiprocessing.spawn`` in tests).  A ``D x M`` mesh is ``D * M``
ranks laid out data-major: rank ``r`` has data index ``r // M`` and model
index ``r % M``.  Each data row (the M ranks of one data index) shares a
model-axis process group; each model column a data-axis group.

Placement, as in the JAX package:
  * params replicated on every rank (``replicate_params``); the Megatron
    sharding of the attention weights (``tensor_parallel``) is not ported;
  * the big frozen node-axis tables, the per-chromosome ``features`` and
    ``inter_z``, zero-padded to a multiple of M rows
    (``pad_frozen_for_mesh``) and row-sharded on the model axis: each rank
    holds only its block of rows (``shard_frozen``);
  * every rank holds the whole batch (the data pipeline is deterministic
    and seeded alike) and computes its block of rows of every bucket
    (``rank_rows``): the batch axis is cut over the data and model axes
    jointly, as the JAX package's kernel wrappers cut it.

How the gradient is summed.  Every rank computes the whole step's loss from
the whole-batch logits and recon loss, which reach it through autograd
all-gathers (``all_gather_rows``); the backward of an all-gather sums the
cotangent over its group, so each rank's own rows receive the gradient of
every rank's copy of the loss.  The Trainer scales its loss by 1 / W and
sums the flat gradient over the world once (``all_reduce_sum``) before
AdamW: each parameter's gradient is then the whole loss's, summed exactly
once (``train/runtime.py``, ``Trainer.train_step``).

The active mesh.  Model code consults ``active_data_mesh()``; the Trainer
scopes its mesh to each of its calls with ``using_active_mesh``, so a
second Trainer (or none) never changes what another runs.  A 1 x 1 mesh is
no mesh.

Collectives on gloo.  Where a group's backend is gloo and the tensor lies
on a card (several ranks sharing one card, where NCCL refuses two ranks on
one device), a collective copies that tensor through host memory and warns
once per collective that it does so.
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Mesh:
    """A ``n_data x n_model`` mesh of ranks: ``shape`` ({"data": D,
    "model": M}), this rank's ``rank``, ``data_index`` and ``model_index``,
    and its groups: ``world`` (every rank of the mesh), ``model_group``
    (its data row) and ``data_group`` (its model column); a group is None
    when no process group is initialized (a world of one)."""

    def __init__(self, n_data: int, n_model: int):
        self.shape = {"data": int(n_data), "model": int(n_model)}
        self.size = self.shape["data"] * self.shape["model"]
        self.distributed = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if self.distributed else 1
        assert self.size == world, (
            f"mesh {n_data}x{n_model} != {world} ranks")
        self.rank = dist.get_rank() if self.distributed else 0
        self.data_index, self.model_index = divmod(self.rank, int(n_model))
        self.world = self.model_group = self.data_group = None
        if self.distributed:
            self.world = dist.group.WORLD
            # every rank creates every group, in one order (new_group is
            # collective over the world), and keeps those it belongs to
            for d in range(int(n_data)):
                g = dist.new_group([d * int(n_model) + m
                                    for m in range(int(n_model))])
                if d == self.data_index:
                    self.model_group = g
            for m in range(int(n_model)):
                g = dist.new_group([d * int(n_model) + m
                                    for d in range(int(n_data))])
                if m == self.model_index:
                    self.data_group = g

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"data_index={self.data_index}, "
                f"model_index={self.model_index})")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The mesh over every rank of the initialized world (a world of one
    without a process group); ``n_data`` defaults to world / n_model."""
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if n_data is None:
        n_data = world // int(n_model)
    return Mesh(int(n_data), int(n_model))


# ------------------------------------------------------------- collectives
_WARNED: set = set()


def _staged(t: torch.Tensor, group, name: str) -> bool:
    """Whether a collective of ``t`` on ``group`` goes through host memory
    (a card's tensor on a gloo group); warns the first time per name."""
    if not t.is_cuda or "nccl" in str(dist.get_backend(group)):
        return False
    if name not in _WARNED:
        _WARNED.add(name)
        warnings.warn(f"gloo {name} of a CUDA tensor: staged through host "
                      "memory", stacklevel=3)
    return True


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """In-place SUM of ``t`` over ``group`` (no autograd); a no-op without
    a group."""
    if group is None:
        return t
    if _staged(t, group, "all_reduce"):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        dist.all_reduce(host, group=group)
        t.copy_(host, non_blocking=True)
    else:
        dist.all_reduce(t, group=group)
    return t


class _DenseGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: the
    backward of an all-gather is a reduce-scatter, which NCCL runs only on
    a contiguous tensor, and autograd may hand it an expanded one (the
    gradient of a mean)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _gather_fn():
    import torch.distributed._functional_collectives as fc
    fn = getattr(fc, "all_gather_single_autograd", None)
    return fn if fn is not None else fc.all_gather_tensor_autograd


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every group rank's ``t`` (one shape on all), concatenated along dim 0
    in group-rank order; autograd-aware: its backward sums the cotangent
    over the group and gives each rank its block.  The identity for a
    group of one."""
    if _group_size(group) == 1:
        return t
    src = t.contiguous()
    staged = _staged(src, group, "all_gather")
    if staged:
        src = src.cpu()
    out = _gather_fn()(src, 0, group)
    if hasattr(out, "wait"):
        out = out.wait()
    out = _DenseGrad.apply(out)
    return out.to(t.device) if staged else out


def all_gather_blocks(t: torch.Tensor, sizes: Sequence[int],
                      group) -> torch.Tensor:
    """``all_gather_rows`` of blocks of unequal row counts: rank i of the
    group holds ``sizes[i]`` rows; each block is padded to the largest
    and the padding dropped after the gather."""
    sizes = [int(s) for s in sizes]
    if len(sizes) == 1:
        return t
    top = max(sizes)
    pad = torch.nn.functional.pad(
        t, (0,) * (2 * (t.dim() - 1)) + (0, top - t.shape[0]))
    out = all_gather_rows(pad, group)
    return torch.cat([out[i * top:i * top + s] for i, s in enumerate(sizes)])


# ---------------------------------------------------------------- placement
def rank_span(n: int, parts: int, index: int) -> Tuple[int, int]:
    """Block ``index`` of ``n`` rows cut into ``parts`` contiguous blocks
    (unequal by at most one row)."""
    return (index * int(n)) // parts, ((index + 1) * int(n)) // parts


def rank_rows(n: int, mesh: Mesh) -> Tuple[int, int]:
    """This rank's block [lo, hi) of a batch of ``n`` rows: the batch axis
    cut over the data and model axes jointly (the rank's index in the
    data-major layout), nested in the data shard's block when n divides."""
    return rank_span(n, mesh.size, mesh.rank)


def rank_sizes(n: int, mesh: Mesh) -> List[int]:
    """Every rank's row count of a batch of ``n`` rows, in rank order."""
    return [hi - lo for lo, hi in (rank_span(n, mesh.size, r)
                                   for r in range(mesh.size))]


def replicate_params(params: Dict, mesh: Mesh, tensor_parallel: bool = False
                     ) -> Dict:
    """Parameter placement: replicated.  The leaves are broadcast from rank
    0 (as one flat buffer) so every rank starts from the same values.
    ``tensor_parallel`` (the JAX package's Megatron sharding of wq, wk, wv
    and fc1) is not ported."""
    if tensor_parallel:
        raise NotImplementedError(
            "tensor_parallel=True (Megatron sharding of the attention "
            "weights on the model axis) is not ported yet: the next slice "
            "(ROADMAP.md, Queue 1 item 7)")
    if mesh.world is None or mesh.size == 1:
        return params
    from matcha_tpu_torch.train.runtime import _leaves
    leaves = _leaves(params)
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1).float() for t in leaves])
        if _staged(flat, mesh.world, "all_reduce"):
            host = flat.cpu()
            dist.broadcast(host, 0, group=mesh.world)
            flat.copy_(host)
        else:
            dist.broadcast(flat, 0, group=mesh.world)
        for t, v in zip(leaves, flat.split([t.numel() for t in leaves])):
            t.copy_(v.view(t.shape))
    return params


def _pad_rows(a: torch.Tensor, m: int) -> torch.Tensor:
    extra = (-a.shape[0]) % m
    if extra == 0:
        return a
    return torch.cat([a, torch.zeros((extra,) + tuple(a.shape[1:]),
                                     dtype=a.dtype, device=a.device)])


def pad_frozen_for_mesh(frozen, mesh: Mesh):
    """Zero-pad the row counts of the row-sharded tables to a multiple of
    the model axis (the encode drops the pad rows; node ids never reach the
    pad rows of inter_z)."""
    m = mesh.shape["model"]
    return frozen._replace(
        features=tuple(_pad_rows(f, m) for f in frozen.features),
        inter_z=_pad_rows(frozen.inter_z, m))


def shard_frozen(frozen, mesh: Mesh):
    """Row-shard the padded features and inter_z on the model axis: this
    rank keeps block ``model_index`` of each (a copy, so the whole table
    can be freed).  attr_table, chrom_of_node and chrom_bounds stay
    replicated."""
    m, i = mesh.shape["model"], mesh.model_index
    if m == 1:
        return frozen
    frozen = pad_frozen_for_mesh(frozen, mesh)

    def block(a):
        n = a.shape[0] // m
        return a[i * n:(i + 1) * n].clone()

    return frozen._replace(features=tuple(block(f) for f in frozen.features),
                           inter_z=block(frozen.inter_z))


def frozen_nbytes(frozen) -> int:
    """Bytes this rank holds of the frozen tables."""
    ts = list(frozen.features) + [frozen.attr_table, frozen.inter_z,
                                  frozen.chrom_of_node, frozen.chrom_bounds]
    return sum(t.numel() * t.element_size() for t in ts)


# ------------------------------------------------------------- active mesh
_ACTIVE_MESH: Optional[Mesh] = None


@contextmanager
def using_active_mesh(mesh: Optional[Mesh]):
    """Install ``mesh`` as the active mesh for the duration of a call;
    restores the previous value on exit."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield
    finally:
        _ACTIVE_MESH = prev


def active_data_mesh() -> Optional[Mesh]:
    """The mesh the model's sharded call sites run under, or None (no mesh,
    or a mesh of one rank)."""
    m = _ACTIVE_MESH
    if m is None or m.size <= 1:
        return None
    return m


def kernel_axes(mesh: Mesh) -> tuple:
    """The mesh axes a kernel's batch dimension is cut over."""
    return tuple(a for a in ("data", "model")
                 if int(mesh.shape.get(a, 1)) > 1) or ("data",)


def kernel_batch_factor(mesh: Optional[Mesh]) -> int:
    """Number of blocks the kernels' batch axis is cut into."""
    if mesh is None:
        return 1
    n = 1
    for a in kernel_axes(mesh):
        n *= int(mesh.shape[a])
    return n
