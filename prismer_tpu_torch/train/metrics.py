"""Structured metric logging, ported from prismer_tpu/train/metrics.py:
JSONL records with wall-clock offsets, one file per experiment."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class MetricsLogger:
    def __init__(self, log_dir: str, name: str = "metrics",
                 enabled: bool = True):
        self.enabled = enabled
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
        self._t0 = time.time()

    def log(self, record: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        rec = {"t": round(time.time() - self._t0, 3), **record}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
