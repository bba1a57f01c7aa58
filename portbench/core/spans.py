"""Readings of the program's own telemetry (``matcha_tpu_torch.telemetry``):
the units of work the program recorded in this process, with their host
spans, synchronisations and counts.

Step and request metrics are means over the last ``LAST`` units that ran
with no profiler (the profiled stretch ends long before a window does);
epoch metrics are medians over the epochs that ran with no profiler,
leaving out the Trainer's first (set-up's warm epoch).  A program without
the telemetry module reads as nothing.
"""

from __future__ import annotations

import statistics
from typing import Callable, List, Optional

LAST = 128
KIND = {"step": "train", "epoch": "train", "request": "score"}


def units(records: dict, unit: str) -> Optional[List]:
    """The program's recent units of kind ``unit`` that ran with no
    profiler (the last ``LAST`` steps or requests; every epoch but a
    Trainer's first), or None when the run is not of the unit's kind, the
    program has no telemetry or recorded none."""
    if records.get("kind") != KIND[unit]:
        return None
    try:
        from matcha_tpu_torch import telemetry
    except ImportError:
        return None
    got = [u for u in telemetry.units(unit) if not u.profiled]
    if unit == "epoch":
        got = [u for u in got if u.index != 0 and u.children > 0]
    else:
        got = got[-LAST:]
    return got or None


def span_ms(u, names) -> float:
    return 1e3 * sum(u.spans.get(n, 0.0) for n in names)


def syncs(u) -> int:
    return sum(u.syncs.values())


def sync_ms(u) -> float:
    return 1e3 * sum(u.sync_s.values())


def mean(records: dict, unit: str, value: Callable) -> Optional[float]:
    got = units(records, unit)
    return None if got is None else statistics.fmean(value(u) for u in got)


def epoch_median(records: dict, value: Callable) -> Optional[float]:
    """The median over the unprofiled epochs of ``value(epoch)`` per step
    of the epoch."""
    got = units(records, "epoch")
    return (None if got is None
            else statistics.median(value(u) / u.children for u in got))


def per_step(records: dict, value: Callable) -> Optional[float]:
    """A step's ``value`` (the steps' mean) plus its share of the epoch's
    own (the epochs' median per step)."""
    step = mean(records, "step", value)
    epoch = epoch_median(records, value)
    return None if step is None or epoch is None else step + epoch
