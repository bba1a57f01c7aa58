"""Node-table gather with a hand-written scatter-add gradient, and the token
bincount.

Port of ``matcha_tpu/ops/table_scatter.py``.  The training step gathers
(T, d) rows of the combined node table for its merged token stream; the
gather's gradient is a scatter-add of the (T, d) cotangent back into the
(n_rows, d) table (K3), and the recon loss weights every node by its token
count (K4).  Both have three functions, as the attention has:

  * ``scatter_add_plain`` / ``bincount_plain`` — the plain PyTorch versions;
  * ``scatter_add_cuda`` / ``bincount_cuda`` — the wrappers of the kernels in
    ``csrc/table_scatter.cu`` (ports of the TPU kernels ``_scatter_kernel``
    and ``_count_kernel``);
  * ``scatter_add`` / ``bincount`` — the dispatchers: a CPU tensor takes the
    plain version, a CUDA tensor launches the kernel or raises.

Each dispatcher's ``launches`` counts kernel launches.  The JAX package's
TPU gate ``SCATTER_MATMUL_MAX_ROWS`` (a crossover for the TPU's matrix unit)
has no counterpart: the CUDA kernel takes every table height.
"""

from __future__ import annotations

import ctypes
import functools

import torch


def _in_range(idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """idx as int64 with every id outside [0, n_rows) sent to the extra row
    n_rows, which the callers discard: the TPU kernels' one-hot compare
    matches no row for such an id, so it adds nothing."""
    idx = idx.reshape(-1).long()
    return torch.where((idx >= 0) & (idx < n_rows), idx,
                       torch.full_like(idx, n_rows))


def scatter_add_plain(g: torch.Tensor, idx: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """sum_t onehot(idx[t]) x g[t]: (T, d), (T,) -> (n_rows, d) f32; ids
    outside [0, n_rows) are dropped."""
    out = torch.zeros((n_rows + 1, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, _in_range(idx, n_rows), g.float())[:n_rows]


def bincount_plain(idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Token counts per id: (T,) -> (n_rows,) f32; ids outside [0, n_rows)
    are dropped."""
    return torch.bincount(_in_range(idx, n_rows),
                          minlength=n_rows + 1)[:n_rows].float()


@functools.lru_cache(maxsize=None)
def _lib():
    from matcha_tpu_torch.kernels.build import load_library
    lib = load_library("table_scatter")
    lib.matcha_scatter_add.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.matcha_scatter_add.restype = ctypes.c_int
    lib.matcha_scatter_add_scratch_bytes.argtypes = [ctypes.c_int] * 3
    lib.matcha_scatter_add_scratch_bytes.restype = ctypes.c_longlong
    lib.matcha_bincount.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.matcha_bincount.restype = ctypes.c_int
    lib.matcha_cuda_error_string.argtypes = [ctypes.c_int]
    lib.matcha_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond: bool, msg, *args):
    """Raise ValueError(msg.format(*args)) unless cond; the message is built
    only on failure, so a passing check costs no formatting."""
    if not cond:
        raise ValueError("table_scatter: " + msg.format(*args))


def _check_idx(idx: torch.Tensor, device):
    _check(idx.is_cuda and idx.device == device,
           "idx must be a CUDA tensor on {}", device)
    _check(idx.dtype == torch.int32, "idx must be int32, got {}", idx.dtype)
    _check(idx.is_contiguous(), "idx must be contiguous")


def _raise_on(err: int, name: str):
    if err != 0:
        msg = _lib().matcha_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} "
                           f"(cudaError {err})")


def scatter_add_cuda(g: torch.Tensor, idx: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """Launch K3 on ``torch.cuda.current_stream()``: g (T, d) f32 or bf16
    with d <= 1536, idx (T,) int32, both contiguous on one card -> (n_rows,
    d) f32; ids outside [0, n_rows) are dropped.  The kernel groups the
    tokens by row (a stable counting sort) and sums each row in a fixed
    order, so the result is the same bits on every call.  One call runs one
    CUDA kernel (small T: each block takes a band of rows over all the ids)
    or six (a sort by band, then by row, and sums over pieces) and counts as
    one launch of K3.  Raises on anything else."""
    _check(g.is_cuda, "g must be a CUDA tensor")
    _check(g.dtype in (torch.float32, torch.bfloat16),
           "g must be float32 or bfloat16, got {}", g.dtype)
    _check(g.dim() == 2 and 1 <= g.shape[1] <= 1536,
           "g must be (T, d) with 1 <= d <= 1536, got {}", tuple(g.shape))
    _check(g.is_contiguous(), "g must be contiguous")
    _check_idx(idx, g.device)
    _check(idx.shape == (g.shape[0],), "idx must be ({},), got {}",
           g.shape[0], tuple(idx.shape))
    _check(n_rows >= 1, "n_rows must be >= 1, got {}", n_rows)
    T, d = g.shape
    lib = _lib()
    # one allocation: out, then the kernel's scratch (16-byte aligned)
    n_out = -(-n_rows * d // 4) * 4
    n_scr = lib.matcha_scatter_add_scratch_bytes(T, d, n_rows) // 4
    buf = torch.empty((n_out + n_scr,), dtype=torch.float32, device=g.device)
    out, scratch = buf[:n_rows * d].view(n_rows, d), buf[n_out:]
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.matcha_scatter_add(g.data_ptr(), idx.data_ptr(),
                                     out.data_ptr(), scratch.data_ptr(), T, d,
                                     n_rows, int(g.dtype == torch.bfloat16),
                                     stream)
    _raise_on(err, "scatter_add")
    scatter_add.launches += 1
    return out


def bincount_cuda(idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Launch K4 on ``torch.cuda.current_stream()``: idx (T,) int32,
    contiguous -> (n_rows,) f32 counts, ids outside [0, n_rows) dropped.
    One device launch (a thread-block cluster) writes every count; the
    output is the only allocation.  Raises on anything else."""
    _check(idx.is_cuda, "idx must be a CUDA tensor")
    _check_idx(idx, idx.device)
    _check(idx.dim() == 1, "idx must be 1-D, got {}", tuple(idx.shape))
    _check(n_rows >= 1, "n_rows must be >= 1, got {}", n_rows)
    out = torch.empty((n_rows,), dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        err = _lib().matcha_bincount(idx.data_ptr(), out.data_ptr(),
                                     idx.shape[0], n_rows, stream)
    _raise_on(err, "bincount")
    bincount.launches += 1
    return out


def _dispatch(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (plain version); raises on any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {t.device}")
    return True


def scatter_add(g: torch.Tensor, idx: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """(T, d), (T,) -> (n_rows, d) f32 sums of the g rows per id."""
    if not _dispatch(g, "scatter_add"):
        return scatter_add_plain(g, idx, n_rows)
    return scatter_add_cuda(g.contiguous(), idx.to(torch.int32).contiguous(),
                            n_rows)


def bincount(idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(...) ids -> (n_rows,) f32 token counts."""
    if not _dispatch(idx, "bincount"):
        return bincount_plain(idx, n_rows)
    return bincount_cuda(idx.reshape(-1).to(torch.int32).contiguous(),
                         n_rows)


scatter_add.launches = 0
bincount.launches = 0


class _TableGather(torch.autograd.Function):
    """table[idx] whose gradient is K3, cast back to the cotangent's dtype
    (the cast of ``matcha_tpu/ops/table_scatter.py:_tg_bwd``)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx.long()]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return scatter_add(g, idx, ctx.n_rows).to(g.dtype), None


def table_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with the scatter-add gradient of K3."""
    return _TableGather.apply(table, idx)


def table_gather_sharded(table: torch.Tensor, idx: torch.Tensor,
                         mesh) -> torch.Tensor:
    """``table_gather`` of this rank's token block ``idx`` under a mesh
    (``parallel.mesh``; the counterpart of the JAX package's shard_map
    over its kernel axes): K3 scatters this rank's cotangent rows in the
    backward.  The table is replicated; its gradient's sum over the ranks
    is the Trainer's one gradient all-reduce (the table reaches the params
    linearly), as the JAX package's shard_map transpose sums it."""
    del mesh     # the ids are the rank's block already
    return table_gather(table, idx)


def bincount_sharded(idx: torch.Tensor, n_rows: int, mesh) -> torch.Tensor:
    """Token counts of the whole step under a mesh: K4 on this rank's token
    block ``idx``, then a SUM over every rank of the mesh (the JAX
    package's ``psum`` over its kernel axes), so the recon weights see the
    global counts."""
    from matcha_tpu_torch.parallel.mesh import all_reduce_sum
    return all_reduce_sum(bincount(idx, n_rows), mesh.world)
