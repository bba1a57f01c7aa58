"""Structured training observability.

A copy of ``matcha_tpu/train/logging.py`` (the port imports nothing of the
JAX package): a JSONL metrics stream, one object per epoch, with optional
TensorBoard scalars, and a pass-through for log lines.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    """Writes one JSON object per epoch to ``<dir>/metrics.jsonl``; mirrors
    scalars to TensorBoard when available and enabled."""

    def __init__(self, log_dir: Optional[str] = None,
                 tensorboard: bool = False, stdout=print):
        self.log_dir = log_dir
        self.stdout = stdout
        self._file = None
        self._tb = None
        self._start = time.time()
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self._tb = SummaryWriter(log_dir)
                except ImportError:
                    self._tb = None

    def log_epoch(self, stage: str, epoch: int, train: Dict, valid: Dict,
                  ) -> None:
        record = {
            "time": time.time() - self._start,
            "stage": stage, "epoch": epoch,
            "train_bce": train.get("bce"), "train_recon": train.get("recon"),
            "valid_bce": valid.get("bce"), "valid_recon": valid.get("recon"),
            "hyperedges_per_sec": train.get("hyperedges_per_sec"),
            "train_metrics": train.get("metrics"),
            "valid_metrics": valid.get("metrics"),
        }
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._tb:
            for name, m in [("train_bce", train), ("valid_bce", valid)]:
                if m.get("bce") is not None:
                    self._tb.add_scalar(f"{stage}/{name}", m["bce"], epoch)
            for split, m in [("train", train), ("valid", valid)]:
                for k, v in m.get("metrics", {}).items():
                    self._tb.add_scalar(f"{stage}/{split}_auroc_{k}",
                                        v["auroc"], epoch)

    def __call__(self, message: str) -> None:
        self.stdout(message)

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._tb:
            self._tb.close()
