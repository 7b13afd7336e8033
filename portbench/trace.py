"""Host spans, the device trace, and the reductions from them to numbers.

Spans are the harness's own, around its calls into a layer of the program:
``(name, start_ns, end_ns)`` on ``time.time_ns()``, the clock the profiler's
events carry. Device intervals come from ``torch.profiler`` (CUDA activity
only), read from its raw Kineto events.

``union_ms`` and the B1 / B2 grouping by symbol prefix are frozen from
``chip_smoke.py:851`` (``union_ms``) and ``:864`` (``kernel_group``)."""

from __future__ import annotations

import contextlib
import re
import time
from typing import Dict, Iterable, List, Optional, Tuple

_SYMBOL = re.compile(r"^(?:void\s+)?(?:[A-Za-z_]\w*::)*([A-Za-z_]\w*)")


def symbol(name: str) -> str:
    """A kernel's function name without its return type, namespaces
    (anonymous ones too) and template or call arguments."""
    m = _SYMBOL.match(name.replace("(anonymous namespace)::", "").strip())
    return m.group(1) if m else name


def family(name: str) -> str:
    """``b1``, ``b2`` or ``other``: the hand-written kernels carry their id as
    the prefix of their symbol (``b2_conv_wgmma``, ``b1_masked_batch``)."""
    s = symbol(name)
    return "b1" if s.startswith("b1_") else "b2" if s.startswith("b2_") else "other"


def union_ms(spans: Iterable[Tuple[float, float]]) -> float:
    """Milliseconds covered by the union of (start, end) intervals in ns.
    Launches that overlap (programmatic dependent launch) count once."""
    union, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > reach:
            union += b - max(a, reach)
            reach = b
    return union / 1e6


class Spans:
    """The harness's host spans, kept in memory."""

    def __init__(self) -> None:
        self.spans: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def wrap(self, name: str, fn):
        """``fn`` with a span around each call."""
        def wrapped(*args, **kwargs):
            with self(name):
                return fn(*args, **kwargs)
        return wrapped

    def durations_ms(self, name: str) -> List[float]:
        return [(b - a) / 1e6 for n, a, b in self.spans if n == name]


class DeviceTrace:
    """``torch.profiler`` over a block: the device intervals of every kernel,
    copy and set that ran, as ``(name, start_ns, end_ns)``, and the block's
    wall-clock start and end on the same clock."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self.kernels: List[Tuple[str, int, int]] = []
        self.t0 = self.t1 = 0

    @contextlib.contextmanager
    def __call__(self):
        import torch

        if not self.enabled:
            yield self
            return
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            self.t0 = time.time_ns()
            yield self
            torch.cuda.synchronize()
            self.t1 = time.time_ns()
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda and e.duration_ns() > 0:
                self.kernels.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def union_ms(self, fam: Optional[str] = None) -> float:
        return union_ms((a, b) for n, a, b in self.kernels if fam is None or family(n) == fam)

    def top_ops(self, k: int = 10) -> List[list]:
        """The ``k`` device operations that took the most time, by symbol:
        the seconds the union of each symbol's intervals covers (B2's
        launches overlap, so their summed durations would pass the window)."""
        by: Dict[str, list] = {}
        for n, a, b in self.kernels:
            by.setdefault(symbol(n), []).append((a, b))
        secs = {n: union_ms(spans) / 1e3 for n, spans in by.items()}
        return [[n, s] for n, s in sorted(secs.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, spans: Spans, k: int = 10) -> List[list]:
        """The ``k`` longest stretches of the window with no device interval,
        each named after the innermost host span open at its midpoint
        (``host`` where none is)."""
        gaps, reach = [], self.t0
        for a, b in sorted((a, b) for _, a, b in self.kernels):
            if a > reach:
                gaps.append((reach, a))
            reach = max(reach, b)
        if self.t1 > reach:
            gaps.append((reach, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = (a + b) // 2
            open_ = [(s1 - s0, n) for n, s0, s1 in spans.spans if s0 <= mid <= s1]
            out.append([min(open_)[1] if open_ else "host", (b - a) / 1e9])
        return out
