"""Host-side tracing of the port: units of work, spans, host
synchronisations and counts, and the profiler scope.

A unit is one training ``step``, one ``epoch`` or one scoring ``request``
(``unit(kind)``).  Each keeps, in a ``Unit``, the host seconds of the spans
opened inside it (``span(name)``: total and self time, a span's self time
leaving out the spans and syncs nested in it), the host synchronisations it
made (``sync(name)``: how many, and the seconds the host spent in them) and
plain counts (``count(name, n)``).  A span, sync or count goes to the
innermost open unit of its thread; outside a unit only a span's ``into``
dict receives it.  A unit opened inside another carries the outer one's id
as ``parent``, and the outer unit counts it in ``children`` and its
seconds in ``child_s``.  Each kind keeps its recent units, oldest first, in
a bounded deque (``units(kind)``).

When a ``torch.profiler`` is running, every unit, span and sync also opens
``record_function("matcha:<kind or name>")`` (syncs ``matcha:sync:<name>``),
so it lies in the profiler's trace on the kernels' timeline, and the units
open at that moment are marked ``profiled``.  Otherwise a span costs two
``perf_counter`` calls and a few dict updates: it places no device work and
no synchronisation on the path.

``profile_trace(log_dir)`` is a profiler scope that writes one Chrome trace.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
from time import perf_counter
from typing import Dict, List, Optional

import torch

# recent units kept per kind
KEEP = {"step": 256, "request": 256, "epoch": 16}

_rings = {kind: collections.deque(maxlen=n) for kind, n in KEEP.items()}
_ids = itertools.count(1)
_local = threading.local()
_profiling = torch._C._autograd._profiler_enabled


class Unit:
    """One unit of work and what was recorded inside it (seconds are host
    ``perf_counter`` seconds; ``index`` is the owner's number for it, e.g.
    a Trainer's epoch number, or None)."""
    __slots__ = ("id", "kind", "index", "parent", "profiled", "start",
                 "seconds", "spans", "self_s", "syncs", "sync_s", "counts",
                 "children", "child_s")

    def __init__(self, kind: str, index: Optional[int],
                 parent: Optional[int]):
        self.id = next(_ids)
        self.kind, self.index, self.parent = kind, index, parent
        self.profiled = False
        self.start = self.seconds = 0.0
        self.spans: Dict[str, float] = {}
        self.self_s: Dict[str, float] = {}
        self.syncs: Dict[str, int] = {}
        self.sync_s: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.children, self.child_s = 0, 0.0

    def own_s(self) -> float:
        """Seconds outside the units nested in this one."""
        return self.seconds - self.child_s


def _state():
    st = _local.__dict__
    if "units" not in st:
        st["units"], st["spans"] = [], []
    return st


def _mark_profiled(units: List[Unit]) -> None:
    for u in units:
        u.profiled = True


def _range(label: str, units: List[Unit]):
    """An entered ``record_function(label)`` while a profiler runs (the open
    units are marked profiled), else None."""
    if not _profiling():
        return None
    _mark_profiled(units)
    rf = torch.profiler.record_function(label)
    rf.__enter__()
    return rf


class _UnitScope:
    __slots__ = ("kind", "index", "u", "rf", "units")

    def __init__(self, kind: str, index: Optional[int]):
        self.kind, self.index = kind, index

    def __enter__(self) -> Unit:
        self.units = units = _state()["units"]
        u = Unit(self.kind, self.index, units[-1].id if units else None)
        units.append(u)
        self.u = u
        self.rf = _range(f"matcha:{self.kind}", units)
        u.start = perf_counter()
        return u

    def __exit__(self, *exc):
        u = self.u
        u.seconds = perf_counter() - u.start
        units = self.units
        if _profiling():
            _mark_profiled(units)
        units.pop()
        if units:
            units[-1].children += 1
            units[-1].child_s += u.seconds
        _rings[u.kind].append(u)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _SpanScope:
    __slots__ = ("name", "into", "rf", "t0", "inner", "st")

    def __init__(self, name: str, into: Optional[dict]):
        self.name, self.into = name, into

    def _label(self) -> str:
        return f"matcha:{self.name}"

    def __enter__(self):
        self.st = st = _state()
        self.rf = _range(self._label(), st["units"])
        self.inner = 0.0
        st["spans"].append(self)
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        dt = perf_counter() - self.t0
        st = self.st
        spans = st["spans"]
        spans.pop()
        if spans:
            spans[-1].inner += dt
        if st["units"]:
            self._record(st["units"][-1], dt)
        if self.into is not None:
            key = f"{self.name}_s"
            self.into[key] = self.into.get(key, 0.0) + dt
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False

    def _record(self, u: Unit, dt: float) -> None:
        n = self.name
        u.spans[n] = u.spans.get(n, 0.0) + dt
        u.self_s[n] = u.self_s.get(n, 0.0) + dt - self.inner


class _SyncScope(_SpanScope):
    __slots__ = ()

    def _label(self) -> str:
        return f"matcha:sync:{self.name}"

    def _record(self, u: Unit, dt: float) -> None:
        n = self.name
        u.syncs[n] = u.syncs.get(n, 0) + 1
        u.sync_s[n] = u.sync_s.get(n, 0.0) + dt


def unit(kind: str, index: Optional[int] = None) -> _UnitScope:
    """``with unit("step") as u:`` records the work inside as one unit of
    ``kind`` ("step", "epoch" or "request")."""
    return _UnitScope(kind, index)


def span(name: str, into: Optional[dict] = None) -> _SpanScope:
    """``with span(name):`` adds the host seconds inside to the open unit
    under ``name`` (and to ``into[name + "_s"]`` when a dict is given)."""
    return _SpanScope(name, into)


def sync(name: str) -> _SyncScope:
    """``with sync(name):`` around one place where the host waits on the
    device: counts it and the host seconds it took in the open unit."""
    return _SyncScope(name, None)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the open unit's count ``name``."""
    units = _state()["units"]
    if units:
        c = units[-1].counts
        c[name] = c.get(name, 0) + n


def units(kind: str) -> List[Unit]:
    """The recent units of ``kind``, oldest first."""
    return list(_rings[kind])


def reset() -> None:
    """Forget every recorded unit."""
    for ring in _rings.values():
        ring.clear()


def kernel_launches() -> Dict[str, int]:
    """The hand-written kernels' own launch counters (each wrapper adds one
    where it launches its kernel)."""
    from matcha_tpu_torch.ops import fused_tail as ft
    from matcha_tpu_torch.ops import hyperedge_attention as ha
    from matcha_tpu_torch.ops import node_encode as ne
    from matcha_tpu_torch.ops import propose as pp
    from matcha_tpu_torch.ops import sample_negatives as sn
    from matcha_tpu_torch.ops import table_scatter as ts
    return {"K1": ha.hyperedge_attention.launches,
            "K2": ha.hyperedge_attention_bwd_cuda.launches,
            "K3": ts.scatter_add.launches, "K4": ts.bincount.launches,
            "K5": pp.propose_phase1.launches,
            "K6_fwd": ft.fused_tail_fwd_cuda.launches,
            "K6_bwd": ft.fused_tail_bwd_cuda.launches,
            "K7": sn.sample_negatives_cuda.launches,
            "K8_fwd": ne.encode_fwd_cuda.launches,
            "K8_bwd": ne.encode_bwd_cuda.launches,
            "K8_keep": ne.keep_cuda.launches}


def epoch_split(epoch: Unit) -> Dict:
    """A training epoch's host time per step: the mean ms of each span over
    its steps still kept (the last ``KEEP["step"]``) and, as ``epoch``, the
    epoch's own ms (outside its steps) over its steps; the syncs and the
    ms waited in them per step (the steps' mean plus the epoch's own share);
    the sampler's phase-2 rounds per step; and the kernel launches per step
    (the epoch's ``launches.<kernel>`` counts)."""
    n = max(epoch.children, 1)
    steps = [u for u in _rings["step"] if u.parent == epoch.id]
    m = max(len(steps), 1)
    ms: Dict[str, float] = {}
    for u in steps:
        for name, s in u.spans.items():
            ms[name] = ms.get(name, 0.0) + 1e3 * s / m
    ms["epoch"] = 1e3 * epoch.own_s() / n
    syncs = (sum(sum(u.syncs.values()) for u in steps) / m
             + sum(epoch.syncs.values()) / n)
    wait = (sum(sum(u.sync_s.values()) for u in steps) / m
            + sum(epoch.sync_s.values()) / n)
    return {"steps": epoch.children, "ms_per_step": ms,
            "syncs_per_step": syncs, "sync_wait_ms_per_step": 1e3 * wait,
            "rounds_per_step": sum(u.counts.get("rounds", 0)
                                   for u in steps) / m,
            "launches_per_step": {
                name[len("launches."):]: c / n
                for name, c in epoch.counts.items()
                if name.startswith("launches.")}}


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """A ``torch.profiler`` scope (host and, where a card is present, device
    activity) that writes one Chrome trace,
    ``<host>_<pid>.<time>.pt.trace.json`` (TensorBoard's layout), under
    ``log_dir`` when it ends; a no-op for ``None``."""
    if log_dir is None:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
