"""Profiling helpers (counterpart of the JAX package's `utils/profiling.py`):
a `torch.profiler` trace in place of `jax.profiler.trace`, and phase
wall-clock timers.

`trace_profile(log_dir)` records the host and, on a CUDA machine, the card,
and writes one Chrome trace (`trace.json`, viewable in Perfetto or
chrome://tracing) into `log_dir`; with no `log_dir` it does nothing. A
profiler session leaves its tracing attached to the process and makes every
later launch dearer for the host, so time host-bound work before the first
one.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace_profile(log_dir: Optional[str]):
    """Capture a trace into `log_dir/trace.json` when `log_dir` is set."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class phase_timer:
    """Accumulating phase timer: `with timer("encode"): ...`;
    `timer.report()` -> {phase: seconds}, longest first. Host wall clock:
    synchronise the card inside a phase that should include its work."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self._current = None
        self._t0 = 0.0

    def __call__(self, name: str):
        self._current = name
        return self

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        name = self._current or "unnamed"
        self.totals[name] = (self.totals.get(name, 0.0)
                             + time.perf_counter() - self._t0)
        return False

    def report(self) -> Dict[str, float]:
        return dict(sorted(self.totals.items(), key=lambda kv: -kv[1]))
