"""Step checkpoints on ``torch.distributed.checkpoint``, the port's stand-in
for the JAX package's orbax checkpointer (``matcha_tpu/train/checkpoint.py``).

The class keeps the JAX class's name and surface, so a caller's code (and
``Trainer.fit(checkpoint_format="orbax")``) carries over: ``save(step,
params, opt_state, epoch, key, best)``, ``restore(step, like_params,
like_opt_state)``, ``last_meta``, ``latest_step``, ``wait``, ``close``,
``max_to_keep`` and the context manager.  The files are not orbax's, and
neither package reads the other's.

Layout: ``directory/<step>/state/`` is a ``torch.distributed.checkpoint``
directory holding the params (and the optimizer state) as flat tensors;
``directory/<step>/meta.json`` holds the epoch, the Trainer generator's
state (in place of JAX's key; a list of bytes), the running best and the
trees' structure.  A step counts once its ``state/.metadata`` exists.
Under a process group every rank calls ``save`` and ``restore`` (the
checkpoint library plans the write together; a tensor every rank holds the
same is written once); rank 0 writes the meta and removes old steps.
With ``async_save`` a save returns once the tensors are staged to host
memory and the files are written in the background; the next save,
``wait``, ``restore`` or ``close`` joins it.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _rank0() -> bool:
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _flatten(tree, path: str, out: Dict[str, torch.Tensor]):
    """tree (dicts, lists, tensors, numpy arrays, Python numbers) -> the
    JSON skeleton of its structure; the leaves go into ``out`` under their
    "/"-joined paths (a number as a 0-d float64 tensor)."""
    if isinstance(tree, dict):
        return {"dict": {k: _flatten(v, f"{path}/{k}", out)
                         for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"list": [_flatten(v, f"{path}/{i}", out)
                         for i, v in enumerate(tree)]}
    if isinstance(tree, (int, float)):
        out[path] = torch.tensor(float(tree), dtype=torch.float64)
        return {"float": path}
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(tree))
    out[path] = t.detach()
    return {"tensor": path}


def _unflatten(skel, flat: Dict[str, torch.Tensor]):
    if "dict" in skel:
        return {k: _unflatten(v, flat) for k, v in skel["dict"].items()}
    if "list" in skel:
        return [_unflatten(v, flat) for v in skel["list"]]
    if "float" in skel:
        return float(flat[skel["float"]])
    return flat[skel["tensor"]]


def _quiet(fn, *args, **kwargs):
    """Call a checkpoint-library function without its warning that a single
    process (no process group) saves or loads alone."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*single process.*")
        return fn(*args, **kwargs)


class OrbaxCheckpointer:
    """Numbered checkpoints of {params, opt_state, meta} in ``directory``,
    keeping the newest ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 1,
                 async_save: bool = True):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        self.async_save = bool(async_save)
        self.last_meta: Dict[str, Any] = {}
        self._pending = None
        os.makedirs(self.directory, exist_ok=True)
        # the checkpoint library's own gloo group (every rank builds the
        # checkpointer): a background write never shares a group with the
        # training step's collectives
        self._pg = (dist.new_group(backend="gloo")
                    if dist.is_available() and dist.is_initialized()
                    else None)

    def _barrier(self) -> None:
        if self._pg is not None:
            dist.barrier(group=self._pg)

    def _state_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)), "state")

    # ------------------------------------------------------------------ save
    def save(self, step: int, params: Any, opt_state: Any = None,
             epoch: Optional[int] = None, key: Any = None,
             best: Optional[float] = None) -> None:
        """Save (params, opt_state, epoch[, key, best]) under ``step``; with
        ``async_save`` the files are written in the background.  key: the
        Trainer generator's state (uint8), for an exact resume."""
        self.wait()
        flat: Dict[str, torch.Tensor] = {}
        meta: Dict[str, Any] = {
            "epoch": -1 if epoch is None else int(epoch),
            "params": _flatten(params, "params", flat)}
        if opt_state is not None:
            meta["opt_state"] = _flatten(opt_state, "opt_state", flat)
        if key is not None:
            meta["key"] = np.asarray(key, np.uint8).tolist()
        if best is not None:
            meta["best"] = float(best)
        if self.async_save:
            # the caller goes on updating its tensors in place
            flat = {k: v.clone() for k, v in flat.items()}
        step_dir = os.path.join(self.directory, str(int(step)))
        if _rank0():
            if os.path.exists(step_dir):
                shutil.rmtree(step_dir)
            os.makedirs(step_dir)
            with open(os.path.join(step_dir, "meta.json"), "w") as f:
                json.dump(meta, f)
        self._barrier()
        import torch.distributed.checkpoint as dcp
        if self.async_save:
            self._pending = _quiet(dcp.async_save, flat,
                                   checkpoint_id=self._state_dir(step),
                                   process_group=self._pg)
        else:
            _quiet(dcp.save, flat, checkpoint_id=self._state_dir(step),
                   process_group=self._pg)
            self._collect()

    # --------------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None, like_params: Any = None,
                like_opt_state: Any = None
                ) -> Tuple[Any, Any, Optional[int]]:
        """-> (params, opt_state, epoch) of ``step`` (default the latest).
        ``like_*`` trees give the leaves' devices and dtypes; without
        them the tensors come back on the host.  The optimizer state is
        read only when ``like_opt_state`` is given and the step has one;
        ``last_meta`` then holds the step's meta (epoch, key, best)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        with open(os.path.join(self.directory, str(int(step)),
                               "meta.json")) as f:
            meta = json.load(f)
        from torch.distributed.checkpoint import FileSystemReader
        stored = FileSystemReader(
            self._state_dir(step)).read_metadata().state_dict_metadata
        names = ["params"]
        if like_opt_state is not None and "opt_state" in meta:
            names.append("opt_state")
        flat: Dict[str, torch.Tensor] = {}
        for name, like in zip(names, (like_params, like_opt_state)):
            got: Dict[str, torch.Tensor] = {}
            if like is not None:
                _flatten(like, name, got)
            for path in _paths(meta[name]):
                if path in got:
                    flat[path] = torch.empty_like(got[path])
                else:
                    md = stored[path]
                    flat[path] = torch.empty(tuple(md.size),
                                             dtype=md.properties.dtype)
        import torch.distributed.checkpoint as dcp
        _quiet(dcp.load, flat, checkpoint_id=self._state_dir(step),
               process_group=self._pg)
        self.last_meta = {k: v for k, v in meta.items()
                          if k not in ("params", "opt_state")}
        params = _unflatten(meta["params"], flat)
        opt = (_unflatten(meta["opt_state"], flat)
               if "opt_state" in names else None)
        epoch = meta.get("epoch", -1)
        return params, opt, None if epoch == -1 else epoch

    # ------------------------------------------------------------- lifecycle
    def _steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(os.path.join(
                    self._state_dir(int(name)), ".metadata")):
                out.append(int(name))
        return sorted(out)

    def _collect(self) -> None:
        """Remove all but the newest ``max_to_keep`` finished steps (rank
        0)."""
        if not _rank0():
            return
        for step in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(step)),
                          ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self._steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Join a save still being written, then drop the old steps."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None
            self._collect()
        self._barrier()

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _paths(skel):
    if "dict" in skel:
        return [p for v in skel["dict"].values() for p in _paths(v)]
    if "list" in skel:
        return [p for v in skel["list"] for p in _paths(v)]
    return [skel.get("float", skel.get("tensor"))]
