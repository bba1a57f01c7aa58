"""Stage-2 training epochs as ``Trainer.fit``'s training part runs them on
one card: ``pin_base_buckets``, then ``train_epoch_indexed`` (the epoch's
launch and its one fetch) back to back; no eval, no checkpoint.

Set-up builds the kernels, draws the inputs from the seed, builds the
Bloom filters and the Trainer, and runs one whole epoch, whose first
``check_steps`` steps are recorded for the output check (``Recorder``).
The window starts before the first timed epoch is launched and ends when
the first epoch ending at or after ``seconds`` has been fetched;
``train_hyperedges_per_s`` is every hyperedge scored in it (positives and
negatives) over its length.  An epoch whose loss is not finite counts its
steps as failed and its hyperedges as not scored.

With ``trace`` the probes are on for the window and torch.profiler runs over
``profile_steps`` steps from window step ``profile_from``; the epochs that
hold none of those steps give the untraced time a step takes.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import torch

from portbench.core import inputs as I
from portbench.core.probes import (Probes, Recorder, launch_counts,
                                   launches_per)
from portbench.core.trace import Stretch
from portbench.reference import follow as F
from portbench.reference import judge as J
from portbench.reference.layout import layout


def program_settings(model: dict):
    from matcha_tpu_torch.train.runtime import TrainSettings
    return TrainSettings(
        alpha=float(model["alpha"]), beta=float(model["beta"]),
        neg_num=int(model["neg_num"]),
        min_distance=int(model["min_distance"]),
        max_trials=int(model["max_neg_trials"]),
        learning_rate=float(model["learning_rate"]),
        weight_decay=float(model["weight_decay"]),
        token_stream=model["token_stream"],
        propose_impl=model["propose_impl"])


def dims_of(model: dict, lay):
    from matcha_tpu_torch.models.hypersagnn import ModelDims
    return ModelDims(dim=int(model["d_model"]), n_head=int(model["n_head"]),
                     num_chroms=lay.n_chroms, num_nodes=lay.n_nodes,
                     compute_dtype=model["compute_dtype"],
                     feature_dropout=float(model["dropout_feature"]))


def program_genome(cfg: dict, lay):
    from matcha_tpu_torch.genome import GenomeBins
    g = cfg["genome"]
    genome = GenomeBins(g["chrom_names"], g["chrom_sizes"], g["resolution"])
    if genome.num_nodes != lay.n_nodes:
        raise RuntimeError(f"the program bins {genome.num_nodes} nodes, "
                           f"the layout {lay.n_nodes}")
    return genome


def hyperedges_per_step(traffic: dict, model: dict) -> int:
    return (int(traffic["batch_size"]) * (1 + int(model["neg_num"]))
            * len(model["kmer_size"]))


def step_flops(lay, model: dict, traffic: dict) -> float:
    from portbench.core.registry import load_module
    rows = {int(k): int(traffic["batch_size"]) * (1 + int(model["neg_num"]))
            for k in model["kmer_size"]}
    hd = int(model["n_head"]) * int(model["d_k"])
    return load_module("work", "model").step_flops(
        lay.bins, int(model["d_model"]), hd, rows, train=True)


def setup(cell: dict, seed: int, device):
    from matcha_tpu_torch.data.batcher import BucketedBatcher
    from matcha_tpu_torch.models.hypersagnn import (FrozenTables,
                                                    configure_fuse_tail)
    from matcha_tpu_torch.sampler.bloom import build_bloom_dict
    from matcha_tpu_torch.sampler.negative import ChromTable
    from matcha_tpu_torch.train.runtime import Trainer
    cfg, tr = cell["config"], cell["traffic"]
    model = cfg["model"]
    clock = I.Clock()
    lay = layout(cfg)
    genome = program_genome(cfg, lay)
    tables = I.make_tables(lay, I.dtype_of(model["table_dtype"]), device,
                           seed)
    params0 = I.make_params(lay, model, device, seed)
    pos = I.positives(lay, model["kmer_size"], int(cfg["positives_per_k"]),
                      seed)
    clock.lap("inputs")
    configure_fuse_tail(model["fuse_tail"] == "on")
    blooms = build_bloom_dict({k: e for k, (e, _) in pos.items()},
                              error_rate=float(model["bloom_error_rate"]),
                              device=device)
    clock.lap("filters")
    trainer = Trainer(params0, FrozenTables(*tables), dims_of(model, lay),
                      ChromTable.from_genome(genome, device=device),
                      program_settings(model), blooms=blooms, seed=seed)
    batcher = BucketedBatcher(pos, int(tr["batch_size"]),
                              int(tr["steps_per_epoch"]), seed=seed)
    if not trainer.pin_base_buckets(batcher):
        raise RuntimeError("the buckets do not fit the pin budget")
    clock.lap("trainer")
    rec = Recorder(trainer, params0, int(tr["check_steps"])).install()
    try:
        trainer.train_epoch_indexed(batcher)
    finally:
        rec.remove()
    rec.to_host()
    clock.lap("warm epoch")
    return {"lay": lay, "tables": tables, "params0": params0, "pos": pos,
            "trainer": trainer, "batcher": batcher, "rec": rec}


def window(st: dict, cell: dict, seconds: float, trace: bool) -> dict:
    tr, model = cell["traffic"], cell["config"]["model"]
    trainer, batcher = st["trainer"], st["batcher"]
    per_step = hyperedges_per_step(tr, model)
    probes = Probes().install() if trace else None
    stretch = Stretch() if trace else None
    first, n_prof = int(tr["profile_from"]), int(tr["profile_steps"])
    count = {"steps": 0}
    if trace:
        step = trainer.train_step

        def traced_step(batch):
            i = count["steps"]
            if i == first:
                stretch.start()
            with torch.profiler.record_function(f"portbench:step:{i}"):
                out = step(batch)
            count["steps"] = i + 1
            if i == first + n_prof - 1:
                stretch.stop()
            return out
        trainer.train_step = traced_step
    steps = failed = 0
    epochs = []
    n = int(tr["steps_per_epoch"])
    counts = launch_counts()
    t0 = time.perf_counter()
    try:
        while True:
            te = time.perf_counter()
            res = trainer.train_epoch_indexed(batcher)
            epochs.append(time.perf_counter() - te)
            steps += n
            if not (math.isfinite(res["bce"]) and math.isfinite(res["recon"])):
                failed += n
            if time.perf_counter() - t0 >= seconds:
                break
    finally:
        window_s = time.perf_counter() - t0
        if probes is not None:
            probes.remove()
            del trainer.train_step
    print("epoch seconds: " + " ".join(f"{e:.3f}" for e in epochs),
          file=sys.stderr)
    out = {"attempted": steps, "failed": failed, "window_s": window_s,
           "launches": launches_per(counts, steps), "unit": "step",
           "e2e": {"train_hyperedges_per_s":
                   (steps - failed) * per_step / window_s}}
    if trace:
        rec = {"kind": "train", "units": 0}
        if stretch.window_s is not None:
            rec = stretch.read()
            rec["units"] = n_prof
            rec["kind"] = "train"
        in_prof = set(range(first, first + n_prof))
        outside = [s for i, s in enumerate(probes.sampler_s)
                   if i not in in_prof]
        rec["sampler_ms_per_step"] = (1e3 * sum(outside) / len(outside)
                                      if outside else None)
        plain = [t for j, t in enumerate(epochs)
                 if (j + 1) * n <= first or j * n >= first + n_prof]
        rec["unit_s"] = sum(plain) / (n * len(plain)) if plain else None
        rec["calls"] = dict(probes.calls)
        rec["flops_per_unit"] = step_flops(st["lay"], model, tr)
        rec["dtype"] = model["compute_dtype"]
        out["records"] = rec
    return out


def program_readings(st: dict, model: dict) -> dict:
    rec = st["rec"]
    a, b = float(model["alpha"]), float(model["beta"])
    return {"loss": [a * s["bce"] + b * s["recon"] for s in rec.steps],
            "bce": [s["bce"] for s in rec.steps],
            "recon": [s["recon"] for s in rec.steps],
            "pred": [s["pred"] for s in rec.steps],
            "grad_norms": [rec.first_grad], "change": rec.change}


def step_shapes(st: dict) -> list:
    return [{"rows": {k: int(v.shape[0]) for k, v in s["xs"].items()},
             "n_pos": s["n_pos"], "ws": s["ws"]} for s in st["rec"].steps]


def free_program(st: dict) -> None:
    for key in ("trainer", "batcher"):
        st.pop(key, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def judge_inputs(st: dict, model: dict) -> list:
    lay = st["lay"]
    pos_index = {k: dict(zip(map(tuple, e.tolist()), w.tolist()))
                 for k, (e, w) in st["pos"].items()}
    chrom = lay.chrom_of_node()
    bad = []
    for i, s in enumerate(st["rec"].steps):
        bad += [f"step {i + 1}: {m}" for m in
                J.check_rows({"xs": {k: v.numpy() for k, v in
                                     s["xs"].items()},
                              "n_pos": s["n_pos"], "ws": s["ws"],
                              "fallback": s["fallback"]},
                             pos_index, chrom, int(model["neg_num"]))]
        bad += [f"step {i + 1}: {m}" for m in J.check_uniforms(s["draws"])]
        if "r" not in s:
            bad.append(f"step {i + 1}: no recon chromosome was drawn")
    return bad


def reference_steps(st: dict) -> list:
    return [{"xs": s["xs"], "n_pos": s["n_pos"], "ws": s["ws"],
             "draws": s["draws"], "r": s["r"]} for s in st["rec"].steps]


def check(st: dict, cell: dict, device, calibrate: bool = False) -> dict:
    """-> {"inputs": [faults found in the draws], "gaps": {number: value}}
    and, with ``calibrate``, the control's and the faults' gaps."""
    model = cell["config"]["model"]
    bad = judge_inputs(st, model)
    out = {"inputs": bad, "gaps": {}}
    if bad:
        return out
    steps = reference_steps(st)
    args = (st["params0"], st["tables"], st["lay"], model, steps)
    try:
        ref = F.follow(*args, device=device)
    except F.DrawMismatch as e:
        out["inputs"].append(f"draws: {e}")
        return out
    shapes = step_shapes(st)
    prog = program_readings(st, model)
    out["gaps"] = J.train_gaps(prog, ref, shapes)
    if calibrate:
        ctl = F.follow(*args, rounding="fp8", device=device)
        half = F.follow(*args, device=device, half_batch=True)
        out["control"] = J.train_gaps(ctl, ref, shapes)
        out["raw"] = {name: {k: v for k, v in r.items() if k != "pred"}
                      for name, r in (("prog", prog), ("ref", ref),
                                      ("control", ctl), ("half_batch", half))}
        still = {n: 0.0 for n in ref["change"]}
        out["faults"] = {"half_batch": J.train_gaps(half, ref, shapes),
                         "state_unchanged": J.train_gaps(
                             {**ref, "grad_norms": [still], "change": still},
                             ref, shapes)}
    return out


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        calibrate: bool = False) -> dict:
    st = setup(cell, seed, device)
    setup_done = time.perf_counter()
    win = (window(st, cell, seconds, trace) if not calibrate
           else {"attempted": 0, "failed": 0, "e2e": {}, "launches": {},
                 "unit": "step"})
    peak = (torch.cuda.max_memory_allocated()
            if torch.cuda.is_available() else 0)
    free_program(st)
    t0 = time.perf_counter()
    got = check(st, cell, device, calibrate)
    return {**win, "setup_done": setup_done, "memory_peak_bytes": peak,
            "check": got, "check_s": time.perf_counter() - t0}
