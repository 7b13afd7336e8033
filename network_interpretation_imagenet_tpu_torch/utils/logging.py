"""Structured logging, phase timers and a profiler hook (port of
``utils/logging.py``).

Every phase emits one JSON line and phases nest; :func:`profiler_trace`
wraps a block in a ``torch.profiler`` trace whose Chrome trace lands in a
directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Any, Dict, Optional


class PhaseLogger:
    """JSON-line logger with nested phase timing.

    >>> log = PhaseLogger()
    >>> with log.phase("segment", image=3):
    ...     pass
    emits {"phase": "segment", "seconds": ..., "image": 3}
    """

    def __init__(self, stream=None, enabled: bool = True):
        self.stream = stream or sys.stderr
        self.enabled = enabled
        self._stack = []

    def emit(self, record: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        self.stream.write(json.dumps(record, default=str) + "\n")
        self.stream.flush()

    @contextlib.contextmanager
    def phase(self, name: str, **fields):
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._stack.pop()
            self.emit({"phase": ".".join(self._stack + [name]) if self._stack else name,
                       "seconds": round(dt, 6), **fields})

    def metric(self, name: str, value: float, **fields) -> None:
        self.emit({"metric": name, "value": value, **fields})


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Trace a block with ``torch.profiler`` (CPU, and CUDA where there is a
    card) when ``log_dir`` is given; the Chrome trace is written to
    ``log_dir/trace.json``."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
