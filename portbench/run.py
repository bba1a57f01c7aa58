#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell's entry in ``BENCHMARK.json`` names
its configuration and traffic mix; the mix names its driver in
``portbench/drivers/``.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number the output
check compared, with its limit (also the last lines of standard error).

Exits 2 without a result when there is no CUDA device or fewer than the
cell asks for, when the program (``matcha_tpu_torch``) cannot be imported,
and when a module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``matcha_tpu`` is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "matcha_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None, *, cell=None, device=None) -> int:
    """``cell`` and ``device`` (the tests) replace the lookup of the
    workload in ``BENCHMARK.json`` and the look for a card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench.core import registry, result

    if cell is None:
        cell = registry.cell(args.workload, registry.benchmark())
        chips = int(cell["workload"]["chips"])
        if not torch.cuda.is_available():
            return fail("no CUDA device")
        if torch.cuda.device_count() < chips:
            return fail(f"{torch.cuda.device_count()} CUDA devices, the cell "
                        f"asks for {chips}")
        device = torch.device("cuda")
    try:
        from matcha_tpu_torch.kernels import build
    except ImportError as e:
        return fail(f"the program cannot be imported: {e}")
    if device.type == "cuda":
        built = build.build()
        print(f"setup to the kernels built: {time.perf_counter() - T_START:.3f}"
              f" s (compiled: {sorted(built) or 'none'})", file=sys.stderr,
              flush=True)
    driver = registry.load_module("drivers", cell["traffic"]["driver"])
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        return fail(f"modules loaded: {found}")
    line = result.assemble(cell, out, bool(args.trace),
                           out["setup_done"] - T_START, device,
                           card() if device.type == "cuda" else "cpu")
    print(f"kernel launches per {out['unit']} (the program's counters): "
          f"{out['launches']}; window {out['window_s']:.3f} s, output check "
          f"{out['check_s']:.3f} s", file=sys.stderr)
    rec = out.get("records", {})
    if rec.get("unit_s") and rec.get("units"):
        from portbench.core.roofline import overhead
        print(f"profiled stretch: {rec['window_s'] / rec['units']:.6f} s per "
              f"{out['unit']}, untraced {rec['unit_s']:.6f} s (the "
              f"profiler's factor {overhead(rec):.4f})", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    for msg in out["check"]["inputs"]:
        print(f"check inputs: {msg}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
