"""The result line of a run: the metrics the cell reports, the device, the
breakdown of a traced run, and the numbers the output check compared, each
beside its limit (last).  A run is correct when no unit of work in its
window failed, its draws passed their checks and every number the cell's
limits name is at or under its limit."""

from __future__ import annotations

import torch

from portbench.core import registry


def checks(cell: dict, check: dict, failed: int) -> dict:
    limits, gaps = cell["limits"], check["gaps"]
    out = {n: {"value": gaps.get(n), "limit": limits.get(n)}
           for n in sorted(set(gaps) | set(limits))}
    out["failed"] = {"value": int(failed), "limit": 0}
    return out


def is_correct(cell: dict, check: dict, failed: int) -> bool:
    limits, gaps = cell["limits"], check["gaps"]
    return (bool(limits) and int(failed) == 0 and not check["inputs"]
            and all(n in gaps and gaps[n] <= lim
                    for n, lim in limits.items()))


def metrics(cell: dict, out: dict, trace: bool, setup_s: float) -> dict:
    got = {}
    if not trace:
        values = {**out["e2e"], "setup_s": setup_s}
        for m in cell["end_to_end"]:
            if m["name"] in values:
                got[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        return got
    for m in cell["per_layer"]:
        value = registry.load_module("metrics", m["name"]).read(
            out["records"])
        if value is not None:
            got[m["name"]] = {"value": value, "unit": m["unit"]}
    return got


def assemble(cell: dict, out: dict, trace: bool, setup_s: float, device,
             card: str) -> dict:
    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell["workload"]["chips"]),
           "memory_peak_bytes": int(out["memory_peak_bytes"]),
           "card": card}
    line = {"correct": is_correct(cell, out["check"], out["failed"]),
            "attempted": int(out["attempted"]),
            "failed": int(out["failed"]),
            "metrics": metrics(cell, out, trace, setup_s),
            "device": dev}
    rec = out.get("records", {})
    if trace and "busy_s" in rec:
        dev["busy_s"], dev["window_s"] = rec["busy_s"], rec["window_s"]
        line["breakdown"] = {"device_ops": rec["device_ops_top"],
                             "idle_gaps": rec["idle_gaps"]}
    line["checks"] = checks(cell, out["check"], out["failed"])
    return line
