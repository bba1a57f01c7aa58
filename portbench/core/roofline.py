"""Shares the per-layer readers compute from a traced run's records."""

from __future__ import annotations

from typing import Optional

from portbench.core import registry
from portbench.core.trace import PEAK_FLOPS, bound_s


def share(records: dict, op: str, kind: str) -> Optional[float]:
    """% of the op's least time (its work function's operations and bytes
    at the peaks) over the device time of what it launched, summed over the
    op's calls in the profiled stretch; None when the run is not of
    ``kind`` or no call of the op launched anything there."""
    if records.get("kind") != kind or "ranges" not in records:
        return None
    work = registry.load_module("work", op).work
    least = device = 0.0
    for call in records["calls"].get(op, []):
        t = records["ranges"].get(f"portbench:{op}:{call['i']}")
        if not t:
            continue
        flops, nbytes = work(call)
        least += bound_s(flops, nbytes, call["dtype"])
        device += t
    return 100.0 * least / device if device > 0 else None


def idle_pct(records: dict, kind: str) -> Optional[float]:
    """% of an untraced unit's time (``unit_s``, the window's units outside
    the profiled stretch) in which the device was not busy, with the busy
    time per unit from the stretch: kernel times do not grow with the
    profiler's host work, the stretch's wall time does."""
    if (records.get("kind") != kind or not records.get("busy_s")
            or not records.get("unit_s") or not records.get("units")):
        return None
    busy = records["busy_s"] / records["units"]
    return 100.0 * (1.0 - busy / records["unit_s"])


def mfu_pct(records: dict, kind: str) -> Optional[float]:
    """Model FLOPs of a unit over an untraced unit's time, over the peak."""
    if records.get("kind") != kind or not records.get("unit_s"):
        return None
    return (100.0 * records["flops_per_unit"] / records["unit_s"]
            / PEAK_FLOPS[records["dtype"]])


def overhead(records: dict) -> Optional[float]:
    """The profiled stretch's wall time per unit over an untraced unit's."""
    if not records.get("unit_s") or not records.get("units"):
        return None
    return records["window_s"] / records["units"] / records["unit_s"]


def ops_per_unit(records: dict, kind: str) -> Optional[float]:
    if records.get("kind") != kind or not records.get("device_ops"):
        return None
    return records["device_ops"] / records["units"]
