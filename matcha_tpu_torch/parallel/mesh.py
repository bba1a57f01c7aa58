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
  * params replicated on every rank (``replicate_params``); with
    ``tensor_parallel`` the Megatron sharding of the attention weights on
    the model axis (JAX's ``param_sharding`` rule, ``tp_axis``): wq, wk and
    wv keep block ``model_index`` of their columns (heads), fc1's weight
    the same block of its rows;
  * the big frozen node-axis tables, the per-chromosome ``features`` and
    ``inter_z``, zero-padded to a multiple of M rows
    (``pad_frozen_for_mesh``) and row-sharded on the model axis: each rank
    holds only its block of rows (``shard_frozen``);
  * every rank holds the whole batch (the data pipeline is deterministic
    and seeded alike) and computes its block of rows of every bucket
    (``rank_rows``): the batch axis is cut over the data and model axes
    jointly, as the JAX package's kernel wrappers cut it.  Under tensor
    parallelism only the attention differs: the ranks of a data row gather
    their rows (``all_gather_blocks``), each runs its heads on all of them,
    and a reduce-scatter (``reduce_scatter_blocks``) sums the heads' fc1
    partials back onto each rank's own rows (``models/modules.py``).

How the gradient is summed.  Every rank computes the whole step's loss from
the whole-batch logits and recon loss, which reach it through autograd
all-gathers (``all_gather_rows``); the backward of an all-gather sums the
cotangent over its group, so each rank's own rows receive the gradient of
every rank's copy of the loss.  The Trainer scales its loss by 1 / W and
sums the flat gradient over the world once (``all_reduce_sum``) before
AdamW: each parameter's gradient is then the whole loss's, summed exactly
once (``train/runtime.py``, ``Trainer.train_step``).  Under tensor
parallelism the same holds per shard: a rank's own rows carry the whole
loss's cotangent, the reduce-scatter's backward (an all-gather over the
model group) hands each head block the cotangent of its data row's rows,
so a head-sharded leaf's gradient on a rank is that data row's share,
exactly once; it is summed over the data group only (the ranks that hold
the same block), and the replicated leaves over the world as before.
AdamW is elementwise, so stepping the blocks equals stepping whole leaves.

The active mesh.  Model code consults ``active_data_mesh()``; the Trainer
scopes its mesh to each of its calls with ``using_active_mesh``, so a
second Trainer (or none) never changes what another runs.  A 1 x 1 mesh is
no mesh.

Tables already cut.  A caller that cannot hold a whole table (hg38 at 10
kb: a 198.9 GB bfloat16 ``inter_z``) builds only its rank's block of rows,
the rows ``frozen_row_blocks`` names, and hands the Trainer those blocks
(``holds_rank_blocks`` tells them from whole tables); the rows are those
``shard_frozen`` would have kept.

Collectives on gloo.  Where a group's backend is gloo and the tensor lies
on a card (several ranks sharing one card, where NCCL refuses two ranks on
one device), a collective copies that tensor through host memory and warns
once per collective that it does so.

Tracing.  Each collective is a ``telemetry`` span ``collective.<op>``
(``all_gather``, ``reduce_scatter``, ``all_reduce``) with the counts
``collective.<op>`` (calls) and ``collective_bytes.<op>`` (the bytes of the
collective's whole buffer on this rank: an all-gather's output, a
reduce-scatter's input, an all-reduce's tensor).  A collective that
autograd will run in the backward, on its own thread where no unit is open,
is counted when the forward records it, from the shapes; its span opens in
the backward without counts.
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from matcha_tpu_torch import telemetry


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


def _nccl(t: torch.Tensor, group) -> bool:
    return t.is_cuda and "nccl" in str(dist.get_backend(group))


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _counted(op: str, nbytes: int) -> None:
    """Counts one collective ``op`` of ``nbytes`` in the open unit."""
    telemetry.count(f"collective.{op}")
    telemetry.count(f"collective_bytes.{op}", int(nbytes))


def _sum_into(t: torch.Tensor, group) -> torch.Tensor:
    if _staged(t, group, "all_reduce"):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        dist.all_reduce(host, group=group)
        t.copy_(host, non_blocking=True)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """In-place SUM of ``t`` over ``group`` (no autograd); a no-op without
    a group."""
    if group is None:
        return t
    _counted("all_reduce", _nbytes(t))
    with telemetry.span("collective.all_reduce"):
        return _sum_into(t, group)


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


class _StagedGather(torch.autograd.Function):
    """``all_gather_rows`` of a card's tensor on a gloo group, through host
    memory; the backward sums the cotangent over the group (an all-reduce
    in f32, staged) and keeps this rank's block.  Its input and output lie
    on the card, so its backward runs on the card's autograd thread, as
    every other staged collective's does: backward collectives on the
    host's thread could reach a group in another order on each rank."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.rows = group, t.shape[0]
        out = _gather_fn()(t.contiguous().cpu(), 0, group)
        if hasattr(out, "wait"):
            out = out.wait()
        return out.to(t.device)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        with telemetry.span("collective.all_reduce"):
            total = _sum_into(g.to(torch.float32, copy=True), ctx.group)
        return (total[i * ctx.rows:(i + 1) * ctx.rows].to(g.dtype),
                None)


def _gather(src: torch.Tensor, group, staged: bool) -> torch.Tensor:
    if staged:
        return _StagedGather.apply(src, group)
    out = _gather_fn()(src, 0, group)
    if hasattr(out, "wait"):
        out = out.wait()
    return _DenseGrad.apply(out)


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every group rank's ``t`` (one shape on all), concatenated along dim 0
    in group-rank order; autograd-aware: its backward sums the cotangent
    over the group and gives each rank its block.  The identity for a
    group of one."""
    if _group_size(group) == 1:
        return t
    src = t.contiguous()
    staged = _staged(src, group, "all_gather")
    whole = _nbytes(src) * _group_size(group)
    _counted("all_gather", whole)
    if src.requires_grad and torch.is_grad_enabled():
        # the backward: a reduce-scatter of the cotangent (staged: an f32
        # all-reduce of the whole cotangent)
        if staged:
            _counted("all_reduce", 4 * src.numel() * _group_size(group))
        else:
            _counted("reduce_scatter", whole)
    with telemetry.span("collective.all_gather"):
        return _gather(src, group, staged)


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


class _ReduceScatter(torch.autograd.Function):
    """Sum over ``group`` of equal-sized blocks, each rank keeping block
    ``index``; the backward is the all-gather of the blocks' cotangents.
    NCCL runs a reduce-scatter of a card's tensor; other backends an
    all-reduce in f32 and a slice (gloo's reduce-scatter is not in every
    torch release).  Its backward runs on its tensor's autograd thread, as
    ``_StagedGather``'s does."""

    @staticmethod
    def forward(ctx, t, group, index: int):
        ctx.group = group
        n = _group_size(group)
        top = t.shape[0] // n
        src = t.contiguous()
        if _nccl(src, group):
            out = torch.empty((top,) + tuple(src.shape[1:]), dtype=src.dtype,
                              device=src.device)
            dist.reduce_scatter_tensor(out, src, group=group)
            return out
        total = _sum_into(src.to(torch.float32, copy=True), group)
        return total[index * top:(index + 1) * top].to(src.dtype)

    @staticmethod
    def backward(ctx, g):
        src = g.contiguous()
        with telemetry.span("collective.all_gather"):
            out = _gather(src, ctx.group,
                          _staged(src, ctx.group, "all_gather"))
        return out, None, None


def reduce_scatter_blocks(t: torch.Tensor, sizes: Sequence[int],
                          group) -> torch.Tensor:
    """The inverse layout of ``all_gather_blocks``, summed: ``t`` holds the
    group's blocks of ``sizes[i]`` rows one after another (every rank the
    same layout); the blocks are summed over the group and this rank keeps
    its own, ``sizes[group rank]`` rows.  Autograd-aware: the backward
    all-gathers the blocks' cotangents, so each rank's ``t`` gets the
    cotangent of every block.  The identity for a group of one."""
    sizes = [int(s) for s in sizes]
    if len(sizes) == 1:
        return t
    top = max(sizes)
    widths = (0,) * (2 * (t.dim() - 1))
    pad = torch.cat([torch.nn.functional.pad(b, widths + (0, top - b.shape[0]))
                     for b in t.split(sizes)])
    index = dist.get_rank(group)
    # NCCL reduce-scatters the blocks; other backends all-reduce them in f32
    nccl = _nccl(pad, group)
    op = "reduce_scatter" if nccl else "all_reduce"
    _counted(op, _nbytes(pad) if nccl else 4 * pad.numel())
    if pad.requires_grad and torch.is_grad_enabled():
        _counted("all_gather", _nbytes(pad))   # the backward's
    with telemetry.span(f"collective.{op}"):
        out = _ReduceScatter.apply(pad, group, index)
    return out[:sizes[index]]


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


def tp_axis(path: Sequence) -> Optional[int]:
    """The tensor-parallel rule of JAX's ``param_sharding`` for the leaf at
    ``path`` (its keys from the root): 1 (columns, the heads) for wq, wk
    and wv, 0 (rows) for fc1's weight, None (replicated) for every other
    leaf."""
    if path and path[-1] in ("wq", "wk", "wv"):
        return 1
    if "fc1" in path and path[-1] == "w":
        return 0
    return None


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tp_axes(params: Dict) -> List[Optional[int]]:
    """``tp_axis`` of every leaf, in ``train.runtime._leaves`` order."""
    from matcha_tpu_torch.train.runtime import _leaves
    return _leaves(_map_with_path(lambda p, _: tp_axis(p), params))


def tp_block(t: torch.Tensor, axis: Optional[int], mesh: Mesh
             ) -> torch.Tensor:
    """This rank's block of a whole leaf along ``axis`` (block
    ``model_index`` of M), as a contiguous copy; ``t`` itself for a
    replicated leaf (axis None)."""
    if axis is None:
        return t
    n = t.shape[axis] // mesh.shape["model"]
    return t.narrow(axis, mesh.model_index * n, n).contiguous()


def tp_gather(t: torch.Tensor, axis: Optional[int], mesh: Mesh
              ) -> torch.Tensor:
    """The whole leaf from every model rank's block along ``axis`` (no
    autograd; a collective over the model group); ``t`` itself for a
    replicated leaf."""
    if axis is None:
        return t
    with torch.no_grad():
        rows = t.detach().movedim(axis, 0).contiguous()
        whole = all_gather_rows(rows, mesh.model_group)
        return whole.movedim(0, axis).contiguous()


def replicate_params(params: Dict, mesh: Mesh, tensor_parallel: bool = False,
                     n_head: int = 0) -> Dict:
    """Parameter placement -> the placed tree.  The leaves are broadcast
    from rank 0 (as one flat buffer) so every rank starts from the same
    values.  With ``tensor_parallel`` on a model axis M > 1 the sharded
    leaves (``tp_axis``) are replaced by this rank's blocks (``tp_block``;
    each requires grad as its leaf did); ``n_head`` must split into M
    whole blocks of heads (ValueError otherwise).  Without a model axis
    tensor parallelism is the replicated placement, as in the JAX
    package."""
    tp = tensor_parallel and mesh.shape["model"] > 1
    if tp and n_head % mesh.shape["model"]:
        raise ValueError(f"tensor_parallel: {n_head} heads do not split "
                         f"over a model axis of {mesh.shape['model']}")
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
    if not tp:
        return params
    return _map_with_path(
        lambda p, t: t if tp_axis(p) is None else tp_block(
            t.detach(), tp_axis(p), mesh).requires_grad_(t.requires_grad),
        params)


def model_group_rows(ns: Sequence[int], mesh: Mesh) -> List[int]:
    """The row counts of the M ranks of this rank's data row (model order)
    in a layout of pieces of ``ns`` rows each cut by ``rank_rows``: rank j
    of the row holds ``sum(rank_span(n, W, d * M + j))`` rows."""
    m = mesh.shape["model"]
    out = []
    for j in range(m):
        r = mesh.data_index * m + j
        out.append(sum(hi - lo for lo, hi in (rank_span(n, mesh.size, r)
                                              for n in ns)))
    return out


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


def block_span(n: int, m: int, index: int) -> Tuple[int, int]:
    """Rows [lo, hi) of block ``index`` of a table of ``n`` rows zero-padded
    to a multiple of ``m`` and cut into ``m`` equal blocks; rows at or
    past ``n`` are the pad."""
    b = -(-int(n) // int(m))
    return index * b, (index + 1) * b


def frozen_row_blocks(widths: Sequence[int], n_ids: int, n_model: int,
                      model_index: int) -> Dict:
    """The padded row range of model rank ``model_index``'s block of each
    row-sharded table, as ``shard_frozen`` keeps it: {"features": [(lo,
    hi) of chromosome c's (widths[c], widths[c]) table], "inter_z": (lo,
    hi) of the (n_ids, ...) table}.  A caller that builds only its block
    fills rows [lo, min(hi, n)) and leaves the rest of the hi - lo rows
    zero."""
    return {"features": [block_span(w, n_model, model_index)
                         for w in widths],
            "inter_z": block_span(n_ids, n_model, model_index)}


def holds_rank_blocks(frozen, mesh: Optional[Mesh]) -> bool:
    """Whether ``frozen`` holds this rank's blocks of the row-sharded
    tables (``frozen_row_blocks``) rather than whole tables: ``inter_z``
    has fewer rows than there are node ids (``chrom_of_node``).  Raises
    when the tables are cut but not into this mesh's blocks."""
    n_ids = int(frozen.chrom_of_node.shape[0])
    if int(frozen.inter_z.shape[0]) == n_ids:
        return False
    m = 1 if mesh is None else mesh.shape["model"]
    want = frozen_row_blocks([int(f.shape[1]) for f in frozen.features],
                             n_ids, m, 0 if mesh is None else
                             mesh.model_index)
    got = ([int(f.shape[0]) for f in frozen.features],
           int(frozen.inter_z.shape[0]))
    if m == 1 or got != ([hi - lo for lo, hi in want["features"]],
                         want["inter_z"][1] - want["inter_z"][0]):
        raise ValueError(
            f"the frozen tables hold {got[1]} rows of inter_z for {n_ids} "
            f"node ids and {got[0]} feature rows: not the blocks of a model "
            f"axis of {m} (parallel.mesh.frozen_row_blocks)")
    return True


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
        lo, hi = block_span(a.shape[0], m, i)
        return a[lo:hi].clone()

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
