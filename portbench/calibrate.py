#!/usr/bin/env python3
"""Readings the output check's limits are set from (not run by the
benchmark's own runs).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--seconds 3] [--out <file.jsonl>]

For each seed, in one process: the cell's set-up (a training cell's first
steps through the window's own call), for a scoring cell a short window at
the cell's load, and then the comparison of the program with the reference
(the lower readings), of the control with the reference (the reference in
float8 e4m3 in the program's place, the precision below the program's
bf16), and for a training cell of the faults planted in the reference put
in the program's place (half of each size's rows left out; a state left
unchanged reads 1 and needs no run).  One JSON line per seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from matcha_tpu_torch.kernels import build
    from portbench.core import registry
    cell = registry.cell(args.workload, registry.benchmark())
    build.build()
    driver = registry.load_module("drivers", cell["traffic"]["driver"])
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        out = driver.run(cell, seed, args.seconds, False,
                         torch.device("cuda"), calibrate=True)
        line = {"workload": args.workload, "seed": seed,
                "seconds": time.perf_counter() - t0, **out["check"]}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
