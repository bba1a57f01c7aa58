"""Structured training observability.

After ``matcha_tpu/train/logging.py`` (the port imports nothing of the JAX
package): a JSONL metrics stream, one object per epoch, with the epoch's
host time split (``host``, from ``telemetry.epoch_split``), and a
pass-through for log lines.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    """Writes one JSON object per epoch to ``<dir>/metrics.jsonl``."""

    def __init__(self, log_dir: Optional[str] = None, stdout=print):
        self.log_dir = log_dir
        self.stdout = stdout
        self._file = None
        self._start = time.time()
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log_epoch(self, stage: str, epoch: int, train: Dict, valid: Dict,
                  host: Optional[Dict] = None) -> None:
        """``host``: the training epoch's host time per step by span, its
        syncs, sampler rounds and kernel launches per step
        (``telemetry.epoch_split``); null when not given."""
        record = {
            "time": time.time() - self._start,
            "stage": stage, "epoch": epoch,
            "train_bce": train.get("bce"), "train_recon": train.get("recon"),
            "valid_bce": valid.get("bce"), "valid_recon": valid.get("recon"),
            "hyperedges_per_sec": train.get("hyperedges_per_sec"),
            "train_metrics": train.get("metrics"),
            "valid_metrics": valid.get("metrics"),
            "host": host,
        }
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()

    def __call__(self, message: str) -> None:
        self.stdout(message)

    def close(self) -> None:
        if self._file:
            self._file.close()
