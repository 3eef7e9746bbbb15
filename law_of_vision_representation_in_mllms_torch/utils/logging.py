"""Structured metrics logging (a copy of the JAX package's
`utils/logging.py`): one JSONL metrics logger with rank-0 gating. Each line
holds `step`, `time` (seconds since the logger started), `steps_per_sec` and
the metrics; the schema is wandb-importable. The rank is
`torch.distributed`'s where a process group exists, else 0.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional

import torch


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def rank0_print(*args, **kwargs):
    """Print only on process 0 (`train.py:46-48 rank0_print`)."""
    if _rank() == 0:
        print(*args, **kwargs)


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, run_name: str = "run",
                 stdout: bool = True, every: int = 1):
        self.stdout = stdout
        self.every = every
        self._fh = None
        if log_dir and _rank() == 0:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, f"{run_name}.jsonl"), "a")
        self._t0 = time.time()
        self._last_step = 0
        self._last_t = self._t0

    def log(self, step: int, metrics: Dict[str, Any]):
        if step % self.every:
            return
        now = time.time()
        rec = {"step": int(step), "time": round(now - self._t0, 3)}
        if step > self._last_step and now > self._last_t:
            rec["steps_per_sec"] = round(
                (step - self._last_step) / (now - self._last_t), 4)
        self._last_step, self._last_t = step, now
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.stdout and _rank() == 0:
            kv = " ".join(f"{k}={v:.5g}" if isinstance(v, float)
                          else f"{k}={v}" for k, v in rec.items()
                          if k != "time")
            print(f"[{rec['time']:9.1f}s] {kv}", file=sys.stderr)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
