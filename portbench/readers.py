"""The reductions the metric readers share. Each metric file under
``metrics/`` names one of these as its ``read(ctx)``; the harness calls it
only in the cells that ``BENCHMARK.json`` lists for that metric. A reader
returns None where it finds nothing to read (an untraced run for a
device-trace metric), and the metric is then left out of the line."""

from __future__ import annotations

import numpy as np


def setup_s(ctx):
    """Seconds from the process's start to the first timed request."""
    return ctx.setup_s


def evals_per_s(ctx):
    """Masked forwards of the images that finished in the window, over the
    window's wall time from the first hand-off to the end of the call,
    drain included."""
    return ctx.evals / ctx.window_s if ctx.window_s > 0 and ctx.evals else None


def latency_ms(ctx, q: float):
    """The ``q``-th percentile of the finished requests' latencies (linear
    between order statistics)."""
    return float(np.percentile(ctx.latencies_ms, q)) if ctx.latencies_ms else None


def device_idle(ctx):
    """Share of the traced window's wall time in which no operation ran on
    the device (the union of the profiler's device intervals)."""
    return 1.0 - ctx.trace.union_ms() / 1e3 / ctx.trace.window_s if ctx.traced else None


def mfu(ctx):
    """The forward operations the finished work needed (convolutions and
    head from the family's ``forward_flops``, every forward of every image),
    over the traced window's wall time, as a share of the card's dense peak
    in the config's dtype."""
    return 100.0 * ctx.flops() / ctx.trace.window_s / ctx.peak_flops() if ctx.traced else None


def b2_roofline(ctx):
    """The chain bounds of every forward the finished work needed (each
    stage's stride-1 chain at that forward's batch, in the config's dtype)
    over the union of the device intervals of kernels whose symbol starts
    with ``b2_``; None for a config with no ``chains``."""
    busy = ctx.trace.union_ms("b2") if ctx.traced else 0.0
    bound = ctx.b2_bound_ms()
    return 100.0 * bound / busy if busy > 0 and bound is not None else None


def b1_roofline(ctx):
    """The bytes bound of every B1 call the finished work needed (image,
    segments and starts read once, masked images written once in the
    config's dtype) over the union of the device intervals of kernels whose
    symbol starts with ``b1_``."""
    busy = ctx.trace.union_ms("b1") if ctx.traced else 0.0
    return 100.0 * ctx.b1_bound_ms() / busy if busy > 0 else None


def other_kernels_ms_per_kevals(ctx):
    """Device milliseconds covered by every operation outside the ``b1_``
    and ``b2_`` families (cuDNN, elementwise glue, copies) per 1,000
    masked forwards."""
    return ctx.trace.union_ms("other") / (ctx.evals / 1e3) if ctx.traced and ctx.evals else None


def span_p50_ms(ctx, name: str):
    """Median of the harness's spans called ``name`` in the window."""
    ms = ctx.spans.durations_ms(name)
    return float(np.median(ms)) if ms else None
