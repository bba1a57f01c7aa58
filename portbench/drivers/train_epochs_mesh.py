"""``train_epochs`` on a mesh of ranks, one process per chip: the cell's
configuration names the mesh (``"mesh": {"data": D, "model": M}``).

Rank 0 is this process; ranks 1 .. W - 1 are started with the ``spawn``
method and joined in one ``torch.distributed`` process group (NCCL for the
cards' tensors, gloo for the host's; on the CPU, gloo alone) with a
timeout.  A watchdog thread here ends the run when a rank exits before its
end, and each rank ends itself when this process goes, so that a fault
ends the run instead of hanging it.

Every rank draws its inputs from the seed: its own blocks of rows of the
frozen tables (``parallel.mesh.frozen_row_blocks``; keyed by blocks of
``ROWS`` rows, so that a seed gives the same rows at any rank count, in
``core/inputs.py``'s distributions) and, exactly as ``core/inputs.py``
draws them, the weights, the positives and the attribute table.  It builds
the Trainer on the mesh from those blocks, runs ``train_epochs``' set-up
epoch and its window (its functions, imported), and the output check.  A
program that cannot take a rank's blocks fails here before any rank starts.

The window: rank 0 runs ``train_epochs.window`` with the cell's seconds
(and the trace); before each of its epochs it tells the other ranks to run
one more, and after its window that there is none, so every rank stops at
the same epoch.  Rank 0 returns the window, its traced records and the
largest rank's peak memory; each rank's peak and frozen bytes go to
standard error.  ``flops_per_unit`` is the whole step's model FLOPs over
the W chips, so that ``mfu_pct.train`` reads a share of the W chips' peak.

The traced records add, from rank 0's profiled stretch: the device seconds
of the communication kernels (``collective_s``), of the kernels launched
inside the program's ``matcha:recon`` and ``matcha:recon_backward`` ranges
(``recon_device_s``), and the shapes of the recon loss's calls there
(``recon_calls``: the rows of rank 0's block that carry weight, the rows
it decodes, the drawn chromosome's width).

The output check: the first ``check_steps`` steps are recorded on every
rank as ``train_epochs`` records them, but a feature-dropout draw, which at
10 kb is 4.7e9 uniforms a step, is kept as the rank's rows' packed keep
bits (``reference/blocked.py:RankKeep``).  The reference
(``reference/blocked.py``) follows those steps on every rank's blocks; rank
0 compares.
"""

from __future__ import annotations

import datetime
import gc
import json
import math
import os
import sys
import tempfile
import threading
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from portbench.core import inputs as I
from portbench.core.probes import Recorder
from portbench.core.trace import DEVICE_CATS, LAUNCH_CATS, Stretch, parse
from portbench.reference import blocked as B
from portbench.reference import judge as J
from portbench.reference.layout import layout

ROWS = 1024                 # the rows of one keyed draw of a table
TIMEOUT_S = 600             # of every collective of the process group
NCCL_PREFIX = "nccl"        # the communication kernels' names
RECON_RANGES = ("matcha:recon", "matcha:recon_backward")


def _drivers():
    # the single-card driver, whose set-up pieces, window and check this
    # one reuses
    import portbench.drivers.train_epochs as TE
    return TE


# ------------------------------------------------------------------ inputs
def _generator(device, seed: int, *keys: int) -> torch.Generator:
    s = np.random.SeedSequence([int(seed) % 2**63, *keys])
    return torch.Generator(device=device).manual_seed(
        int(s.generate_state(2, np.uint32).view(np.uint64)[0] >> 1))


def _rows_of(out: torch.Tensor, lo: int, n: int, width: int, draw) -> None:
    """Fills out[: n] with rows lo .. lo + n of a table whose row blocks
    [j ROWS, (j + 1) ROWS) are ``draw(j, rows)`` -> (rows, width)."""
    j = lo // ROWS
    while j * ROWS < lo + n:
        a, b = j * ROWS, (j + 1) * ROWS
        got = draw(j, b - a)
        s, e = max(a, lo), min(b, lo + n)
        out[s - lo:e - lo, :width] = got[s - a:e - a]
        j += 1


def rank_tables(lay, table_dtype, device, seed: int, blocks: Dict):
    """This rank's blocks of the feature tables and of inter_z (with the
    f_max zero pad columns), and the whole small tables, as
    ``core/inputs.py:make_tables`` would make them, the large ones keyed by
    row blocks: features uniform in [-1, 1] with ones on the diagonal,
    inter_z standard normal with row 0 zero."""
    N, C = lay.n_nodes, lay.n_chroms
    feats = []
    for c, ((lo, hi), b) in enumerate(zip(blocks["features"], lay.bins)):
        out = torch.zeros((hi - lo, b), dtype=table_dtype, device=device)
        n = max(0, min(hi, b) - lo)

        def draw(j, rows, c=c, b=b):
            rows = min(rows, b - j * ROWS)
            u = torch.rand((rows, b), generator=_generator(
                device, seed, 11, c, j), device=device)
            return u.mul_(2.0).sub_(1.0).to(table_dtype)
        _rows_of(out, lo, n, b, draw)
        ids = torch.arange(lo, lo + n, device=device)
        out[ids - lo, ids] = 1.0
        feats.append(out)
    lo, hi = blocks["inter_z"]
    inter = torch.zeros((hi - lo, N + lay.f_max), dtype=table_dtype,
                        device=device)

    def draw_z(j, rows):
        rows = min(rows, N + 1 - j * ROWS)
        return torch.randn((rows, N), generator=_generator(
            device, seed, 12, j), device=device, dtype=table_dtype)
    _rows_of(inter, lo, max(0, min(hi, N + 1) - lo), N, draw_z)
    if lo == 0:
        inter[0].zero_()
    chrom = torch.as_tensor(lay.chrom_of_node(), device=device)
    first = torch.as_tensor(np.asarray(lay.starts), device=device)
    attr = torch.zeros((N + 1, C + 1), device=device)
    ids = torch.arange(1, N + 1, device=device)
    attr[ids, chrom[1:]] = 1.0
    attr[ids, C] = (ids - first[chrom[1:]]).float() / float(lay.bins[0])
    bounds = torch.as_tensor(
        np.stack([lay.starts, np.add(lay.starts, lay.bins)], axis=1)
        .astype(np.int32), device=device)
    return I.Tables(tuple(feats), attr, inter, chrom.to(torch.int32), bounds)


# ------------------------------------------------------------- recording
class MeshRecorder(Recorder):
    """``Recorder``, keeping each feature-dropout draw (the first C draws of
    a step, (n_c, n_c) each) as this rank's rows' ``RankKeep``."""

    def __init__(self, trainer, params0, n: int, lay, blocks: Dict,
                 rate: float):
        super().__init__(trainer, params0, n)
        self.lay, self.blocks, self.rate = lay, blocks, rate

    def install(self) -> "MeshRecorder":
        from matcha_tpu_torch.models import hypersagnn, modules
        rand = modules.rand
        super().install()
        bins = self.lay.bins

        def rec_rand(gen, shape, device):
            u = rand(gen, shape, device)
            draws = self._cur["draws"]
            c = len(draws)
            if c < len(bins) and tuple(shape) == (bins[c], bins[c]):
                lo, hi = self.blocks["features"][c]
                draws.append(B.RankKeep(u, (min(lo, bins[c]),
                                            min(hi, bins[c])), self.rate))
            else:
                draws.append(u.clone())
            return u

        self._patch.set(modules, "rand", rec_rand)
        self._patch.set(hypersagnn, "rand", rec_rand)
        return self


# -------------------------------------------------------------- the trace
class MeshStretch(Stretch):
    """``Stretch`` whose reading adds the communication kernels' and the
    recon ranges' device seconds."""

    def read(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        out = parse(events)
        out.update(device_extras(events))
        out["window_s"] = self.window_s
        return out


def device_extras(events: List[dict]) -> dict:
    """{"collective_s": device seconds of the kernels named ``nccl...``,
    "recon_device_s": of the device operations launched inside a
    ``RECON_RANGES`` range (on the host thread that launched them)}."""
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    ranges: Dict[int, list] = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name") in RECON_RANGES):
            ranges.setdefault(e["tid"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    coll = recon = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        dur = float(e["dur"]) / 1e6
        if str(e.get("name", "")).startswith(NCCL_PREFIX):
            coll += dur
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None and any(
                s <= float(launch["ts"]) <= t
                for s, t in ranges.get(launch["tid"], ())):
            recon += dur
    return {"collective_s": coll, "recon_device_s": recon}


class _ReconCalls:
    """The recon loss's calls while a stretch is profiled
    (``work/recon.py``): the rows of rank 0's block that carry weight (the
    step's nodes off the drawn chromosome r, whose token count
    ``recon_loss_node`` weights), the rows it decodes, and r's width.  The
    step's token counts are kept by reference and read after the stretch,
    so the recording launches nothing inside it."""

    def __init__(self, lay, lo: int, hi: int, d: int, elem: int):
        self.lay, self.lo, self.hi, self.d, self.elem = lay, lo, hi, d, elem
        self._held: List[tuple] = []
        self._r = None
        self.on = False

    def install(self):
        from matcha_tpu_torch.models import hypersagnn
        self._mod = hypersagnn
        self._old = {n: getattr(hypersagnn, n)
                     for n in ("recon_loss_node", "bincount_sharded")}

        def recon_loss_node(params, frozen, dims, x_flat, node_table, r):
            self._r = r
            try:
                return self._old["recon_loss_node"](
                    params, frozen, dims, x_flat, node_table, r)
            finally:
                self._r = None

        def bincount_sharded(*args, **kwargs):
            # the step's token counts over every rank of the mesh
            cnt = self._old["bincount_sharded"](*args, **kwargs)
            if self.on and self._r is not None:
                self._held.append((cnt, self._r))
            return cnt
        hypersagnn.recon_loss_node = recon_loss_node
        hypersagnn.bincount_sharded = bincount_sharded
        return self

    def remove(self):
        for n, f in self._old.items():
            setattr(self._mod, n, f)

    @property
    def calls(self) -> List[dict]:
        chrom = torch.as_tensor(self.lay.chrom_of_node())
        out = []
        for cnt, r in self._held:
            cnt = cnt.detach().cpu()
            ids = torch.arange(self.lo, min(self.hi, cnt.shape[0]))
            weighted = (cnt[ids] > 0) & (chrom[ids] != r) & (ids != 0)
            out.append({"rows": int(weighted.sum()),
                        "decoded": self.hi - self.lo,
                        "width": self.lay.bins[r], "d": self.d,
                        "elem": self.elem, "dtype": "float32"})
        return out


# -------------------------------------------------------------- the ranks
class _Stop(Exception):
    """The window of a rank but 0 is over: rank 0 ran its last epoch."""


def _epochs_in_step(trainer, rank: int):
    """Wraps ``trainer.train_epoch_indexed`` so that every rank runs the
    epochs rank 0 runs (a flag broadcast on the host before each)."""
    run = trainer.train_epoch_indexed
    flag = torch.zeros(1, dtype=torch.int32)

    def epoch(batcher):
        if rank == 0:
            flag.fill_(1)
        dist.broadcast(flag, 0)
        if int(flag) == 0:
            raise _Stop
        return run(batcher)
    trainer.train_epoch_indexed = epoch

    def stop():
        del trainer.train_epoch_indexed
        if rank == 0:
            flag.fill_(0)
            dist.broadcast(flag, 0)
    return stop


def _say(rank: int, msg: str) -> None:
    print(f"rank {rank}: {msg}", file=sys.stderr, flush=True)


def setup(cell: dict, seed: int, device, mesh) -> dict:
    from matcha_tpu_torch.data.batcher import BucketedBatcher
    from matcha_tpu_torch.models.hypersagnn import (FrozenTables,
                                                    configure_fuse_tail)
    from matcha_tpu_torch.parallel.mesh import (frozen_nbytes,
                                                frozen_row_blocks)
    from matcha_tpu_torch.sampler.bloom import build_bloom_dict
    from matcha_tpu_torch.sampler.negative import ChromTable
    from matcha_tpu_torch.train.runtime import Trainer
    TE = _drivers()
    cfg, tr = cell["config"], cell["traffic"]
    model = cfg["model"]
    rank = mesh.rank
    clock = I.Clock() if rank == 0 else None
    lay = layout(cfg)
    genome = TE.program_genome(cfg, lay)
    blocks = frozen_row_blocks(lay.bins, lay.n_nodes + 1,
                               mesh.shape["model"], mesh.model_index)
    tables = rank_tables(lay, I.dtype_of(model["table_dtype"]), device, seed,
                         blocks)
    params0 = I.make_params(lay, model, device, seed)
    pos = I.positives(lay, model["kmer_size"], int(cfg["positives_per_k"]),
                      seed)
    if clock:
        clock.lap("inputs")
    configure_fuse_tail(model["fuse_tail"] == "on")
    blooms = build_bloom_dict({k: e for k, (e, _) in pos.items()},
                              error_rate=float(model["bloom_error_rate"]),
                              device=device)
    if clock:
        clock.lap("filters")
    trainer = Trainer(params0, FrozenTables(*tables), TE.dims_of(model, lay),
                      ChromTable.from_genome(genome, device=device),
                      TE.program_settings(model), blooms=blooms, seed=seed,
                      mesh=mesh)
    held = frozen_nbytes(trainer.frozen)
    _say(rank, f"frozen bytes {held} (inter_z rows {tuple(blocks['inter_z'])}"
         f" of {lay.n_nodes + 1})")
    batcher = BucketedBatcher(pos, int(tr["batch_size"]),
                              int(tr["steps_per_epoch"]), seed=seed)
    if not trainer.pin_base_buckets(batcher):
        raise RuntimeError("the buckets do not fit the pin budget")
    if clock:
        clock.lap("trainer")
    rec = MeshRecorder(trainer, params0, int(tr["check_steps"]), lay, blocks,
                       float(model["dropout_feature"])).install()
    try:
        trainer.train_epoch_indexed(batcher)
    finally:
        rec.remove()
    rec.to_host()
    if clock:
        clock.lap("warm epoch")
    return {"lay": lay, "tables": tables, "params0": params0, "pos": pos,
            "trainer": trainer, "batcher": batcher, "rec": rec,
            "blocks": blocks, "frozen_bytes": held}


def window(st: dict, cell: dict, seconds: float, trace: bool, mesh) -> dict:
    TE = _drivers()
    rank, trainer = mesh.rank, st["trainer"]
    stop = _epochs_in_step(trainer, rank)
    if rank:
        try:
            TE.window(st, cell, math.inf, False)
        except _Stop:
            pass
        stop()
        return {}
    calls = None
    if trace:
        lay = st["lay"]
        lo, hi = st["blocks"]["inter_z"]
        calls = _ReconCalls(lay, lo, max(lo, min(hi, lay.n_nodes + 1)),
                            int(cell["config"]["model"]["d_model"]),
                            st["tables"].inter_z.element_size()).install()

        class Traced(MeshStretch):
            def start(self):
                super().start()
                calls.on = True

            def stop(self):
                calls.on = False
                super().stop()
        TE.Stretch = Traced
    try:
        out = TE.window(st, cell, seconds, trace)
    finally:
        stop()
        TE.Stretch = Stretch
        if calls is not None:
            calls.remove()
    if trace:
        rec = out["records"]
        rec["flops_per_unit"] /= mesh.size
        rec["recon_calls"] = calls.calls
    return out


def judge_inputs(st: dict, model: dict, rank: int) -> List[str]:
    """Each rank judges its rows of the feature draws; rank 0 also the
    rows, the negatives and the other uniforms (``train_epochs``)."""
    TE = _drivers()
    bad = []
    for i, s in enumerate(st["rec"].steps):
        for u in s["draws"]:
            if isinstance(u, B.RankKeep):
                bad += [f"rank {rank} step {i + 1}: {m}" for m in u.check()]
    if rank:
        return bad
    rows = [{**s, "draws": [u for u in s["draws"]
                            if not isinstance(u, B.RankKeep)]}
            for s in st["rec"].steps]
    return bad + TE.judge_inputs({**st, "rec": SimpleNamespace(steps=rows)},
                                 model)


def check(st: dict, cell: dict, device, mesh, calibrate: bool) -> dict:
    """Every rank calls it (the reference's collectives); rank 0's return
    holds the gaps, and with ``calibrate`` the control's and the planted
    faults': half the batch, the state left unchanged, and the exchange
    between the ranks left out (the reference's gradient all-reduces
    skipped, so each rank steps on its own part of the gradient)."""
    TE = _drivers()
    model = cell["config"]["model"]
    bad = judge_inputs(st, model, mesh.rank)
    got = [None] * mesh.size
    dist.all_gather_object(got, bad)
    bad = [m for part in got for m in part]
    out = {"inputs": bad, "gaps": {}}
    if bad:
        return out
    steps = TE.reference_steps(st)
    args = (st["params0"], st["tables"], st["lay"], model, steps,
            st["blocks"])
    ref = B.follow(*args, device=device)
    shapes = TE.step_shapes(st)
    prog = TE.program_readings(st, model)
    out["gaps"] = J.train_gaps(prog, ref, shapes)
    if calibrate:
        ctl = B.follow(*args, rounding="fp8", device=device)
        half = B.follow(*args, device=device, half_batch=True)
        alone = B.follow(*args, device=device, exchange=False)
        out["control"] = J.train_gaps(ctl, ref, shapes)
        out["raw"] = {name: {k: v for k, v in r.items() if k != "pred"}
                      for name, r in (("prog", prog), ("ref", ref),
                                      ("control", ctl), ("half_batch", half))}
        still = {n: 0.0 for n in ref["change"]}
        out["faults"] = {"half_batch": J.train_gaps(half, ref, shapes),
                         "exchange_left_out": J.train_gaps(alone, ref,
                                                           shapes),
                         "state_unchanged": J.train_gaps(
                             {**ref, "grad_norms": [still], "change": still},
                             ref, shapes)}
    return out


def _peak(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def rank_runs(rank: int, world: int, port: int, on_card: bool, cell: dict,
              seeds: List[int], seconds: float, trace: bool,
              calibrate: bool) -> List[dict]:
    """One rank's whole run: joins the process group, then per seed the
    set-up, the window, the check; rank 0's results."""
    from matcha_tpu_torch.parallel.mesh import make_mesh
    TE = _drivers()
    device = torch.device("cuda", rank) if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        "cpu:gloo,cuda:nccl" if on_card else "gloo",
        init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    shape = cell["config"]["mesh"]
    mesh = make_mesh(int(shape["data"]), int(shape["model"]))
    outs = []
    try:
        for seed in seeds:
            st = setup(cell, seed, device, mesh)
            dist.barrier()
            setup_done = time.perf_counter()
            win = ({"attempted": 0, "failed": 0, "e2e": {}, "launches": {},
                    "unit": "step"} if calibrate else
                   window(st, cell, seconds, trace, mesh))
            peaks = [None] * world
            dist.all_gather_object(peaks, (_peak(device), st["frozen_bytes"]))
            # the recorder's hold on the Trainer goes too, so the check
            # runs with the Trainer freed and the next seed's tables fit
            st["rec"].trainer = None
            TE.free_program(st)
            t0 = time.perf_counter()
            got = check(st, cell, device, mesh, calibrate)
            if rank == 0:
                for r, (p, f) in enumerate(peaks):
                    _say(r, f"peak memory {p} bytes, frozen {f} bytes")
                outs.append({**win, "setup_done": setup_done,
                             "memory_peak_bytes": max(p for p, _ in peaks),
                             "rank_peak_bytes": [p for p, _ in peaks],
                             "check": got,
                             "check_s": time.perf_counter() - t0})
            del st
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return outs


def _rank_main(rank, world, port, on_card, cell, seeds, seconds, trace,
               calibrate, parent) -> None:
    """A spawned rank: ends itself if the process that started it goes."""
    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(3)
    threading.Thread(target=watch, daemon=True).start()
    rank_runs(rank, world, port, on_card, cell, seeds, seconds, trace,
              calibrate)


def run_seeds(cell: dict, seeds: List[int], seconds: float, trace: bool,
              device, calibrate: bool = False) -> List[dict]:
    """Starts the ranks, runs rank 0 here -> its result per seed."""
    # the program's rank-block path: a program without it fails here
    from matcha_tpu_torch.parallel.mesh import frozen_row_blocks  # noqa: F401
    from matcha_tpu_torch.parallel.distributed import free_port
    import torch.multiprocessing as mp
    shape = cell["config"]["mesh"]
    world = int(shape["data"]) * int(shape["model"])
    on_card = device.type == "cuda"
    if on_card and torch.cuda.device_count() < world:
        raise RuntimeError(f"the mesh needs {world} cards, "
                           f"{torch.cuda.device_count()} found")
    port = free_port()
    ctx = mp.get_context("spawn")
    # the ranks import this file by its package path
    import portbench.drivers.train_epochs_mesh as me
    procs = [ctx.Process(target=me._rank_main, daemon=True,
                         args=(r, world, port, on_card, cell, seeds,
                               seconds, trace, calibrate, os.getpid()))
             for r in range(1, world)]
    for p in procs:
        p.start()
    done = threading.Event()

    def watchdog():
        while not done.wait(0.5):
            for r, p in enumerate(procs, 1):
                if p.exitcode not in (None, 0):
                    _say(r, f"exited with {p.exitcode}: ending the run")
                    for q in procs:
                        q.kill()
                    os._exit(3)
    threading.Thread(target=watchdog, daemon=True).start()
    try:
        outs = rank_runs(0, world, port, on_card, cell, seeds, seconds,
                         trace, calibrate)
        for p in procs:
            p.join(TIMEOUT_S)
    finally:
        done.set()
        for p in procs:
            if p.is_alive():
                p.kill()
    return outs


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        calibrate: bool = False) -> dict:
    return run_seeds(cell, [seed], seconds, trace, device, calibrate)[0]
