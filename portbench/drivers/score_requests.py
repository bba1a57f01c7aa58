"""Closed-loop scoring requests with one caller: each request is one
``apps.predict.predict_proba(params, frozen, dims, samples, batch_size)``
call on a request of the pool, cycled in order; its latency runs from the
call to the returned array.

Set-up builds the kernels, draws the tables, the weights and a pool of
distinct requests from the seed, and scores ``warm_requests`` requests.  The
window starts before the first timed request and ends when the first request
ending at or after ``seconds`` returns; ``score_hyperedges_per_s`` is every
candidate scored in it over its length.  A request that raises counts as
failed and its candidates as not scored.  The output check compares every
answer of ``check_requests`` requests of the window with the reference's:
a sample drawn from the seed as the window runs (a reservoir), so that the
window keeps only the answers it will check.

With ``trace`` the probes are on and torch.profiler runs over
``profile_requests`` requests from window request ``profile_from``; the
requests outside that stretch give the untraced time a request takes and
the 95th percentile of their latencies (a request's latency runs from the
call to the returned array).
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import numpy as np
import torch

from portbench.core import inputs as I
from portbench.core.probes import Probes, launch_counts, launches_per
from portbench.core.trace import Stretch
from portbench.reference import follow as F
from portbench.reference.layout import layout


def request_flops(lay, model: dict, traffic: dict) -> float:
    from portbench.core.registry import load_module
    rows = {int(k): int(traffic["per_k"]) for k in model["kmer_size"]}
    hd = int(model["n_head"]) * int(model["d_k"])
    return load_module("work", "model").step_flops(
        lay.bins, int(model["d_model"]), hd, rows, train=False)


def setup(cell: dict, seed: int, device):
    from matcha_tpu_torch.apps.predict import predict_proba
    from matcha_tpu_torch.models.hypersagnn import (FrozenTables, ModelDims,
                                                    configure_fuse_tail)
    cfg, tr = cell["config"], cell["traffic"]
    model = cfg["model"]
    clock = I.Clock()
    lay = layout(cfg)
    tables = I.make_tables(lay, I.dtype_of(model["table_dtype"]), device,
                           seed)
    params = I.make_params(lay, model, device, seed)
    pool = I.requests(lay, model["kmer_size"], int(tr["per_k"]),
                      int(tr["pool"]), seed)
    clock.lap("inputs")
    configure_fuse_tail(model["fuse_tail"] == "on")
    dims = ModelDims(dim=int(model["d_model"]), n_head=int(model["n_head"]),
                     num_chroms=lay.n_chroms, num_nodes=lay.n_nodes,
                     compute_dtype=model["compute_dtype"])
    frozen = FrozenTables(*tables)

    def call(samples):
        return predict_proba(params, frozen, dims, samples,
                             batch_size=int(tr["batch_size"]))
    for i in range(int(tr["warm_requests"])):
        call(pool[i % len(pool)])
    clock.lap("warm requests")
    return {"lay": lay, "tables": tables, "params": params, "pool": pool,
            "call": call}


class Reservoir:
    """A uniform sample of ``k`` of the window's answers, drawn from the seed
    while the window runs (Algorithm R): ``kept`` maps a request's index in
    the window to its answer."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = np.random.default_rng([int(seed) % 2**63, 5])
        self.kept: dict = {}

    def offer(self, i: int, answer) -> None:
        if i < self.k:
            self.kept[i] = answer
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            del self.kept[sorted(self.kept)[j]]
            self.kept[i] = answer


def window(st: dict, cell: dict, seconds: float, trace: bool,
           seed: int) -> dict:
    tr, model = cell["traffic"], cell["config"]["model"]
    pool, call = st["pool"], st["call"]
    probes = Probes().install() if trace else None
    stretch = Stretch() if trace else None
    first, n_prof = int(tr["profile_from"]), int(tr["profile_requests"])
    kept = Reservoir(int(tr["check_requests"]), seed)
    lat, failed, cands = [], 0, 0
    counts = launch_counts()
    t0 = time.perf_counter()
    try:
        while True:
            i = len(lat)
            if trace and i == first:
                stretch.start()
            samples = pool[i % len(pool)]
            s = time.perf_counter()
            try:
                p = call(samples)
            except Exception as e:          # a failed request is counted
                p, failed = None, failed + 1
                print(f"request {i} failed: {e!r}", file=sys.stderr,
                      flush=True)
            e = time.perf_counter()
            if trace and i == first + n_prof - 1:
                stretch.stop()
            lat.append(e - s)
            kept.offer(i, p)
            if p is not None:
                cands += len(samples)
            if e - t0 >= seconds:
                break
    finally:
        window_s = time.perf_counter() - t0
        if probes is not None:
            probes.remove()
    out = {"attempted": len(lat), "failed": failed, "window_s": window_s,
           "launches": launches_per(counts, len(lat)), "unit": "request",
           "answers": kept.kept,
           "e2e": {"score_hyperedges_per_s": cands / window_s}}
    if trace:
        rec = {"kind": "score", "units": 0}
        if stretch.window_s is not None:
            rec = stretch.read()
            rec["units"] = n_prof
            rec["kind"] = "score"
        outside = [x for j, x in enumerate(lat)
                   if not first <= j < first + n_prof]
        rec["unit_s"] = sum(outside) / len(outside) if outside else None
        rec["request_ms_p95"] = (
            statistics.quantiles([x * 1e3 for x in outside], n=20)[18]
            if len(outside) > 1 else None)
        rec["calls"] = dict(probes.calls)
        rec["flops_per_unit"] = request_flops(st["lay"], model, tr)
        rec["dtype"] = model["compute_dtype"]
        out["records"] = rec
    return out


def reference_proba(st: dict, model: dict, samples, rounding="float32"):
    by_k = {}
    for j, s in enumerate(samples):
        by_k.setdefault(len(s), []).append(j)
    dev = st["tables"].attr_table.device
    xs = {k: torch.as_tensor(np.asarray([samples[j] for j in idx]),
                             device=dev) for k, idx in by_k.items()}
    got = F.score(st["params"], st["tables"], xs, int(model["n_head"]),
                  rounding)
    out = np.zeros(len(samples))
    for k, idx in by_k.items():
        out[idx] = got[k].double().cpu().numpy()
    return out


def check(st: dict, cell: dict, answers: dict, calibrate: bool = False
          ) -> dict:
    """Compares every answer of the requests ``answers`` kept (window index
    -> answer) with the reference's."""
    model = cell["config"]["model"]
    pool = st["pool"]
    picked = sorted(answers)
    bad, gap, ctl = [], 0.0, 0.0
    for i in picked:
        samples = pool[i % len(pool)]
        got = answers[i]
        if got is None or np.shape(got) != (len(samples),):
            bad.append(f"request {i}: no answer of {len(samples)} values")
            continue
        ref = reference_proba(st, model, samples)
        gap = max(gap, float(np.max(np.abs(np.asarray(got, np.float64)
                                           - ref))))
        if calibrate:
            low = reference_proba(st, model, samples, "fp8")
            ctl = max(ctl, float(np.max(np.abs(low - ref))))
    out = {"inputs": bad, "gaps": {"proba_gap": gap}, "checked": picked}
    if calibrate:
        out["control"] = {"proba_gap": ctl}
    return out


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        calibrate: bool = False) -> dict:
    st = setup(cell, seed, device)
    setup_done = time.perf_counter()
    win = window(st, cell, seconds, trace, seed)
    peak = (torch.cuda.max_memory_allocated()
            if torch.cuda.is_available() else 0)
    st.pop("call")
    gc.collect()
    answers = win.pop("answers")
    t0 = time.perf_counter()
    got = check(st, cell, answers, calibrate)
    return {**win, "setup_done": setup_done, "memory_peak_bytes": peak,
            "check": got, "check_s": time.perf_counter() - t0}
