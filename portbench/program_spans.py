"""The reductions of the metrics that read the program's own spans (its
tracer, ``utils/logging.py`` of the port), kept apart from ``readers.py``,
which reads the harness's.

The harness loads the port before any reader runs, so a reader finds the
tracer in ``sys.modules`` and imports nothing of the port. Spans are the
tracer's, on ``time.time_ns()`` like the device trace; a reader keeps those
inside the traced window ``[ctx.trace.t0, ctx.trace.t1]``. Each returns
None where the run was untraced, the program has no tracer (an older
checkout), or it recorded nothing to read."""

from __future__ import annotations

import bisect
import sys
from typing import Dict, List, Optional

import numpy as np

TRACER = "network_interpretation_imagenet_tpu_torch.utils.logging"
COPY_SPANS = ("engine.fetch", "bo.fetch")   # each waits for one device-to-host copy
PAIR_NS = 10_000_000  # a copy and its span end this close, or are not a pair
NEAR = 2              # pairs either side whose bounds a pair's clock offset meets


def window_spans(ctx) -> Optional[list]:
    """The tracer's spans that lie inside the traced window, or None."""
    tracer = sys.modules.get(TRACER)
    if not ctx.traced or not callable(getattr(tracer, "spans", None)):
        return None
    t0, t1 = ctx.trace.t0, ctx.trace.t1
    return [s for s in tracer.spans() if t0 <= s.start_ns and s.end_ns <= t1] or None


def _p50(values: List[float]) -> Optional[float]:
    return float(np.median(values)) if values else None


def _ms(span) -> float:
    return (span.end_ns - span.start_ns) / 1e6


def segment_ms(ctx) -> Optional[float]:
    """Median over the window's images of span ``segment`` (Felzenszwalb in
    ``segment_image``)."""
    spans = window_spans(ctx)
    return _p50([_ms(s) for s in spans if s.name == "segment"]) if spans else None


def _copies_by_image(spans) -> Dict[object, list]:
    """The ``engine.upload`` and ``engine.fetch`` spans of each of the
    window's images, the request ids of its ``sweep.collect`` spans."""
    by_image: Dict[object, list] = {s.rid: [] for s in spans if s.name == "sweep.collect"}
    for s in spans:
        if s.rid in by_image and s.name in ("engine.upload", "engine.fetch"):
            by_image[s.rid].append(s)
    return by_image


def sweep_wait_ms(ctx) -> Optional[float]:
    """Median over the window's images of their summed ``engine.upload``
    and ``engine.fetch`` spans: the host blocked on the stream."""
    spans = window_spans(ctx)
    return _p50([sum(map(_ms, c)) for c in _copies_by_image(spans).values()]) if spans else None


def syncs_per_image(ctx) -> Optional[float]:
    """Median over the window's images of their ``engine.upload`` and
    ``engine.fetch`` spans: the synchronising copies an image makes."""
    spans = window_spans(ctx)
    return _p50([len(c) for c in _copies_by_image(spans).values()]) if spans else None


def _union(intervals) -> List[list]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap_ns(xs: List[list], ys: List[list]) -> int:
    """Nanoseconds covered by both of two sorted disjoint interval lists."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        total += max(0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def copy_pairs(ctx, spans) -> List[tuple]:
    """The window's device-to-host copies, each paired with the span that
    waited for it (``COPY_SPANS``): both in time order, the one offset of
    up to two places (the window's edges cut a copy or a span off) that
    pairs the most ends within ``PAIR_NS``; pairs further apart go. The
    bound is loose: the device's clock can drift some milliseconds from the
    host's within a window, and a misplaced pair is further off still."""
    t0, t1 = ctx.trace.t0, ctx.trace.t1
    copies = sorted((a, b) for n, a, b in ctx.trace.kernels
                    if "Memcpy DtoH" in n and t0 <= a and b <= t1)
    waits = sorted((s.start_ns, s.end_ns) for s in spans if s.name in COPY_SPANS)

    def paired(k):
        return [(c, w) for c, w in zip(copies[max(k, 0):], waits[max(-k, 0):])
                if abs(c[1] - w[1]) < PAIR_NS]

    return max((paired(k) for k in range(-2, 3)), key=len)


def clock_offsets(pairs) -> List[int]:
    """Per pair, the nanoseconds to add to the device trace's times there.
    A copy starts after the span that waits for it opens and ends before it
    closes, so the offset lies in [span start - copy start, span end - copy
    end]; a pair takes the value nearest 0 in the bounds of the ``NEAR``
    pairs either side (the device's clock wanders against the host's), or,
    where those bounds cross, their middle."""
    lo = [w[0] - c[0] for c, w in pairs]
    hi = [w[1] - c[1] for c, w in pairs]
    out = []
    for i in range(len(pairs)):
        a, b = max(lo[max(i - NEAR, 0):i + NEAR + 1]), min(hi[max(i - NEAR, 0):i + NEAR + 1])
        out.append(min(max(0, a), b) if a <= b else (a + b) // 2)
    return out


def reanchored(ctx, spans) -> List[tuple]:
    """The device intervals on the host's clock: each shifted by the clock
    offset of the copy pair nearest it in time (unshifted without pairs)."""
    pairs = copy_pairs(ctx, spans)
    if not pairs:
        return list(ctx.trace.kernels)
    ends, offsets = [c[1] for c, _ in pairs], clock_offsets(pairs)
    out = []
    for n, a, b in ctx.trace.kernels:
        i = bisect.bisect_left(ends, a)
        j = i if i == 0 or (i < len(ends) and ends[i] - a < a - ends[i - 1]) else i - 1
        out.append((n, a + offsets[j], b + offsets[j]))
    return out


def idle_in_segment(ctx) -> Optional[float]:
    """Share of the window's device-idle time (the gaps in the union of all
    device intervals, as ``device_idle``, re-anchored to the host's clock by
    ``reanchored``) that lies inside a ``segment`` span."""
    spans = window_spans(ctx)
    if not spans:
        return None
    t0, t1 = ctx.trace.t0, ctx.trace.t1
    busy = _union((max(a, t0), min(b, t1)) for _, a, b in reanchored(ctx, spans)
                  if b > t0 and a < t1)
    idle, reach = [], t0
    for a, b in busy:
        if a > reach:
            idle.append([reach, a])
        reach = max(reach, b)
    if t1 > reach:
        idle.append([reach, t1])
    idle_ns = sum(b - a for a, b in idle)
    segment = _union((s.start_ns, s.end_ns) for s in spans if s.name == "segment")
    return _overlap_ns(idle, segment) / idle_ns if idle_ns and segment else None


def _per_call(ctx, names, outside: bool) -> Optional[float]:
    """Median over the window's ``bo.call`` spans of their time in the
    children ``names``, or (``outside``) of the rest of the call."""
    spans = window_spans(ctx)
    if not spans:
        return None
    calls = {s.id: s for s in spans if s.name == "bo.call"}
    inside = dict.fromkeys(calls, 0.0)
    for s in spans:
        if s.parent in inside and s.name in names:
            inside[s.parent] += _ms(s)
    return _p50([_ms(c) - inside[i] if outside else inside[i] for i, c in calls.items()])


def bo_wait_ms(ctx) -> Optional[float]:
    """Median per request of ``bo.fetch``: the host waiting for the
    replayed loop."""
    return _per_call(ctx, ("bo.fetch",), outside=False)


def bo_host_ms(ctx) -> Optional[float]:
    """Median per request of ``bo.call``'s time outside its ``bo.replay``
    (the graph's launch, which a profiler slows) and ``bo.fetch`` (the
    wait): the request's host work, draws, input copies and heatmap."""
    return _per_call(ctx, ("bo.replay", "bo.fetch"), outside=True)
