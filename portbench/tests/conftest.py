"""Shared pieces of the harness's tests: a CPU-sized cell (three toy
chromosomes, the published widths) driven through the harness on the CPU,
where the port takes its plain versions."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = Path(__file__).parent / "fixtures" / "tiny.json"
TRAFFIC = {
    "train": {"driver": "train_epochs", "batch_size": 16,
              "steps_per_epoch": 6, "check_steps": 3, "profile_from": 7,
              "profile_steps": 2},
    "score": {"driver": "score_requests", "per_k": 300, "batch_size": 10_000,
              "pool": 3, "warm_requests": 1, "check_requests": 3,
              "profile_from": 1, "profile_requests": 1},
}
CELL = {"train": "train_1mb_b2048", "score": "score_1mb"}


def tiny_cell(kind: str, compute: str = "bfloat16") -> dict:
    """The cell of BENCHMARK.json that ``kind``'s driver runs, with its
    limits and metrics, on the tiny configuration and traffic."""
    from portbench.core import registry
    cell = registry.cell(CELL[kind], registry.benchmark())
    cfg = json.loads(TINY.read_text())
    cfg["model"]["compute_dtype"] = compute
    cell.update(config=cfg, traffic=dict(TRAFFIC[kind]))
    return cell


def run_cell(cell: dict, capsys, seed: int = 2**31 + 11,
             seconds: float = 0.5) -> dict:
    """Drives ``portbench/run.py`` on the CPU (no look for a card) and
    returns its result line."""
    import torch
    from portbench import run
    rc = run.main(["--workload", cell["workload"]["name"], "--seed",
                   str(seed), "--seconds", str(seconds), "--trace", "0"],
                  cell=cell, device=torch.device("cpu"))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
