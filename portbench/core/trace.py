"""Device-side readings of a profiled stretch, and the card's peaks.

``Stretch`` runs torch.profiler (CPU and CUDA activities) over a stretch of
the window that starts and ends on a synchronised device, and reads its
Chrome trace: the device's busy time as the union of its kernel, memcpy and
memset intervals (the measure of ``chip_smoke.py:device_profile``, taken as
a union so that nothing is counted twice), the number of device operations,
the device time of every operation launched inside each ``portbench:``
range (matched through the launch's correlation id to the host thread and
time it was launched at), the operations that took most time, and the
longest idle gaps by what the host was doing when each began.

The peaks are the H100 SXM's published dense rates (as
``chip_smoke.py:PEAK_FLOPS`` / ``PEAK_BYTES``), and ``bound_s`` is
``chip_smoke.py:bound_ms`` in seconds.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE = "portbench:"


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


class Stretch:
    def __init__(self):
        self.prof = None
        self.window_s: Optional[float] = None
        self._t0 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        _sync()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        _sync()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)

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
        out["window_s"] = self.window_s
        return out


def _union(iv: List[tuple]) -> List[tuple]:
    merged: List[list] = []
    for s, e in sorted(iv):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def _innermost(starts, spans, t):
    """The span (start, end, name) with the latest start <= t that holds
    t, looking back over at most 400 spans; None if none does."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 400, -1), -1):
        s, e, name = spans[j]
        if e >= t:
            return name
    return None


def parse(events: List[dict]) -> dict:
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    ranges = defaultdict(list)
    host = defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        if e.get("cat") == "user_annotation" and e["name"].startswith(RANGE):
            ranges[e["tid"]].append(span)
        elif e.get("cat") == "cpu_op":
            host[e["tid"]].append(span)
    for d in (ranges, host):
        for tid in d:
            d[tid].sort()
    starts = {tid: [s[0] for s in v] for tid, v in ranges.items()}

    per_range: Dict[str, float] = defaultdict(float)
    per_name: Dict[str, float] = defaultdict(float)
    iv = []
    for e in dev:
        s, dur = float(e["ts"]), float(e["dur"])
        iv.append((s, s + dur))
        per_name[e["name"][:100]] += dur / 1e6
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None or launch["tid"] not in ranges:
            continue
        name = _innermost(starts[launch["tid"]], ranges[launch["tid"]],
                          float(launch["ts"]))
        if name is not None:
            per_range[name] += dur / 1e6
    busy = _union(iv)
    main = max(host, key=lambda t: len(host[t])) if host else None
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:200]
    idle: Dict[str, float] = defaultdict(float)
    if main is not None:
        h_starts = [s[0] for s in host[main]]
        r_starts = starts.get(main, [])
        for length, t in gaps:
            op = (_innermost(h_starts, host[main], t)
                  or "python (no torch op)")
            rng = (_innermost(r_starts, ranges[main], t)
                   if main in ranges else None)
            label = op if rng is None else f"{rng.split(':')[1]} / {op}"
            idle[label] += length / 1e6
    top = sorted(per_name.items(), key=lambda x: -x[1])[:10]
    return {"busy_s": sum(e - s for s, e in busy) / 1e6,
            "device_ops": len(dev),
            "ranges": dict(per_range),
            "device_ops_top": [[n, t] for n, t in top],
            "idle_gaps": [[n, t] for n, t in
                          sorted(idle.items(), key=lambda x: -x[1])[:10]]}
