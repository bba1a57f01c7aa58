"""Joining a multi-process run, and feeding and gathering host data.

Port of ``matcha_tpu/parallel/distributed.py`` on ``torch.distributed``.
A run is one process per rank, started by ``torchrun`` (which sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``):

    from matcha_tpu_torch.parallel.distributed import (global_mesh,
                                                       init_distributed)
    init_distributed()                  # reads torchrun's environment
    mesh = global_mesh(n_model=1)       # ("data", "model") over all ranks
    trainer = Trainer(..., mesh=mesh)

A single process (no ``WORLD_SIZE`` above 1) needs no process group:
``init_distributed`` is a no-op there and the mesh is a world of one.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from matcha_tpu_torch.parallel.mesh import (Mesh, all_gather_blocks, make_mesh,
                                            rank_span)


def _env_world() -> int:
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def init_distributed(backend: Optional[str] = None,
                     device: Optional[str] = None) -> Optional[torch.device]:
    """Join the run that torchrun's environment describes -> this rank's
    device (``cuda:LOCAL_RANK`` on the card, the CPU for ``device="cpu"``),
    or None for a single process that no launcher started (no ``RANK`` and
    ``MASTER_ADDR``, ``WORLD_SIZE`` at most 1), where this is a no-op.  A
    launched world of one joins a process group of one.

    backend: None picks NCCL (with gloo for host tensors) when the run
    trains on the card and gloo when it trains on the CPU; ``device``
    ("cuda" or "cpu", default "cuda" when a card is present) says which.

    Raises when a cluster was asked for (``WORLD_SIZE`` above 1) and could
    not be joined, or when a process group of another size is already
    initialized: a rank never trains alone in silence."""
    world = _env_world()
    if dist.is_available() and dist.is_initialized():
        if world > 1 and dist.get_world_size() != world:
            raise RuntimeError(
                f"init_distributed: a process group of world size "
                f"{dist.get_world_size()} is already initialized; the run "
                f"of WORLD_SIZE={world} cannot be joined (call "
                "init_distributed first)")
        return None
    if world <= 1 and not ("RANK" in os.environ
                           and "MASTER_ADDR" in os.environ):
        return None
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    on_card = torch.device(device).type == "cuda"
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if on_card else "gloo"
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    dev = torch.device("cpu")
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: device='cuda' but no CUDA "
                               "device is available")
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=world)
    except Exception as e:           # noqa: BLE001 - any failure to join
        raise RuntimeError(
            f"init_distributed: could not join the run of WORLD_SIZE="
            f"{world} (MASTER_ADDR={os.environ.get('MASTER_ADDR')}, "
            f"MASTER_PORT={os.environ.get('MASTER_PORT')}): {e}") from e
    return dev


def global_mesh(n_model: int = 1) -> Mesh:
    """The ("data", "model") mesh over every rank of the run."""
    return make_mesh(n_model=n_model)


def put_global(x, mesh: Mesh, device=None) -> torch.Tensor:
    """This rank's contiguous block (``rank_span`` over every rank of the
    mesh, data-major) of the host array ``x`` along axis 0, on ``device``:
    every process holds the same host value and places only its block."""
    x = np.asarray(x)
    lo, hi = rank_span(x.shape[0], mesh.size, mesh.rank)
    return torch.as_tensor(x[lo:hi]).to(device or "cpu")


def replicate_to_host(t: torch.Tensor, mesh: Mesh,
                      n_rows: Optional[int] = None) -> np.ndarray:
    """The whole array whose block (``put_global``'s) each rank holds,
    gathered to every rank -> host numpy.  n_rows: the whole array's row
    count (default: the blocks are equal, mesh.size * this block's)."""
    if n_rows is None:
        n_rows = t.shape[0] * mesh.size
    sizes = [hi - lo for lo, hi in (rank_span(n_rows, mesh.size, r)
                                    for r in range(mesh.size))]
    with torch.no_grad():
        if mesh.world is None or mesh.size == 1:
            out = t
        else:
            out = all_gather_blocks(t, sizes, mesh.world)
    return out.detach().cpu().numpy()


def free_port() -> int:
    """A free TCP port on localhost."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(rank: int, fn, world: int, port: int, backend: str,
             device: str, args) -> None:
    os.environ.update({"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                       "RANK": str(rank), "LOCAL_RANK": str(rank),
                       "WORLD_SIZE": str(world)})
    dev = init_distributed(backend=backend, device=device)
    try:
        fn(rank, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, backend: str = "gloo",
          device: str = "cpu", join: bool = True):
    """Run ``fn(rank, device, *args)`` in ``world`` new processes joined
    on ``backend`` at a free localhost port (the way tests and a
    one-machine check start a run without torchrun).  Several ranks may
    share one card on gloo (``device="cuda"``: every rank takes
    ``cuda:rank % count``).  Raises if a rank fails; with ``join=False``
    returns the process context, whose ``join()`` does."""
    import torch.multiprocessing as mp
    return mp.start_processes(
        _spawned, args=(fn, world, free_port(), backend, device, args),
        nprocs=world, join=join, start_method="spawn")
