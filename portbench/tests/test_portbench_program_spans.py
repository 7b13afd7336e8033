"""The readers of the program's spans (``program_spans.py``) on a
hand-built run: synthetic spans and device intervals, the values computed
by hand. Each reads nothing (None) in an untraced run or from a program
without the tracer. The device clock is re-anchored to the host's at the
device-to-host copies."""

import collections
import sys
import types

import pytest

from portbench import program_spans, spec

Span = collections.namedtuple("Span", "name start_ns end_ns id parent rid attrs")
MS = 1_000_000
READ = {   # metric -> its value on the run below
    "segment_ms.window": 20.0,
    "sweep_wait_ms.window": 16.0,
    "syncs_per_image.window": 2.0,
    "idle_in_segment.window": 0.76,
    "bo_wait_ms.bo": 9.0,
    "bo_host_ms.bo": 20.0,
}


def _span(name, a, b, sid, parent=None, rid=None):
    return Span(name, int(a * MS), int(b * MS), sid, parent, sid if rid is None else rid, None)


def _spans():
    """A window of [0, 1000] ms: three images of a sweep and three BO requests."""
    out = [
        # segment: 20, 18, 25 ms in the window (p50 20), one outside it
        _span("segment", 100, 120, 1, rid=0), _span("segment", 300, 318, 2, rid=1),
        _span("segment", 500, 525, 3, rid=2), _span("segment", 1500, 1510, 4, rid=3),
        # each image's collect names it; image 3's falls outside the window
        _span("sweep.collect", 200, 230, 5, rid=0), _span("sweep.collect", 400, 430, 6, rid=1),
        _span("sweep.collect", 600, 610, 7, rid=2), _span("sweep.collect", 1600, 1610, 8, rid=3),
        # copies: image 0 4 x 1 + 10 + 2 = 16, image 1 2 + 20 = 22, image 2 5 (p50 16);
        # 6, 2 and 1 of them (p50 2)
        *[_span("engine.upload", 130 + j, 131 + j, 10 + j, rid=0) for j in range(4)],
        _span("engine.fetch", 200, 210, 14, rid=0), _span("engine.fetch", 210, 212, 15, rid=0),
        _span("engine.upload", 330, 332, 16, rid=1), _span("engine.fetch", 400, 420, 17, rid=1),
        _span("engine.fetch", 600, 605, 18, rid=2),
        _span("engine.fetch", 700, 790, 19, rid=99),    # no image of the sweep
        _span("engine.fetch", 1600, 1609, 20, rid=3),   # outside the window
        # BO calls: fetch 8, 10, 9 (p50 9); replay 2, 5, none (a capture instead):
        # the rest 20, 25, 16 (p50 20)
        _span("bo.call", 0, 30, 30), _span("bo.fetch", 20, 28, 31, parent=30, rid=30),
        _span("bo.heatmap", 28, 29, 32, parent=30, rid=30),
        _span("bo.replay", 10, 12, 39, parent=30, rid=30),
        _span("bo.call", 100, 140, 33), _span("bo.fetch", 120, 130, 34, parent=33, rid=33),
        _span("bo.replay", 110, 115, 40, parent=33, rid=33),
        _span("bo.call", 200, 225, 35), _span("bo.fetch", 210, 219, 36, parent=35, rid=35),
        _span("bo.capture", 201, 209, 41, parent=35, rid=35),
        _span("bo.call", 990, 1020, 37), _span("bo.fetch", 995, 999, 38, parent=37, rid=37),
    ]
    return out


def _ctx(traced=True):
    """Device busy [0, 100], [130, 300], [320, 1000] ms (one interval runs
    past the window's end): idle 30 + 20 ms, of which segments cover 20 + 18."""
    kernels = [("k", 0, 100 * MS), ("k", 130 * MS, 250 * MS), ("k", 200 * MS, 300 * MS),
               ("k", 320 * MS, 990 * MS), ("k", 900 * MS, 1100 * MS)]
    trace = types.SimpleNamespace(t0=0, t1=1000 * MS, kernels=kernels)
    return types.SimpleNamespace(traced=traced, trace=trace, images=3)


@pytest.fixture
def tracer(monkeypatch):
    fake = types.SimpleNamespace(spans=_spans)
    monkeypatch.setitem(sys.modules, program_spans.TRACER, fake)
    return fake


@pytest.mark.parametrize("name", sorted(READ))
def test_reader_reads_the_hand_computed_value(tracer, name):
    assert spec.reader(name)(_ctx()) == pytest.approx(READ[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(READ))
def test_reader_reads_nothing_untraced(tracer, name):
    assert spec.reader(name)(_ctx(traced=False)) is None


@pytest.mark.parametrize("name", sorted(READ))
def test_reader_reads_nothing_from_a_program_without_the_tracer(monkeypatch, name):
    monkeypatch.setitem(sys.modules, program_spans.TRACER, types.SimpleNamespace())
    assert spec.reader(name)(_ctx()) is None


@pytest.mark.parametrize("name", sorted(READ))
def test_reader_reads_nothing_where_nothing_was_recorded(monkeypatch, name):
    empty = types.SimpleNamespace(spans=list)
    monkeypatch.setitem(sys.modules, program_spans.TRACER, empty)
    assert spec.reader(name)(_ctx()) is None


def test_every_new_metric_is_declared():
    declared = {m["name"]: m for m in spec.load_json(spec.ROOT + "/BENCHMARK.json")["per_layer"]}
    for name in READ:
        assert declared[name]["source"] == "program_span"


def _late_ctx(late_ms, copies):
    """Device busy [0, 100] and [120, 1100] ms on the host's clock, reported
    ``late_ms`` late, with its device-to-host ``copies`` (host-clock ms)."""
    d = late_ms * MS
    kernels = [("k", d, 100 * MS + d), ("k", 120 * MS + d, 1100 * MS + d)]
    kernels += [("Memcpy DtoH (Device -> Pageable)", int(a * MS) + d, int(b * MS) + d)
                for a, b in copies]
    trace = types.SimpleNamespace(t0=0, t1=1000 * MS, kernels=kernels)
    return types.SimpleNamespace(traced=True, trace=trace, images=1)


@pytest.mark.parametrize("late_ms", [0.0, 0.7, -0.4])
def test_idle_in_segment_reanchors_the_device_clock(monkeypatch, late_ms):
    """A blocking fetch's copy ends at its span's end and a short one fills
    its span: the offset that puts both inside is the device's lateness, so
    the idle gap [100, 120] ms lies wholly in the segment span however late
    the device's clock reads; without copies to anchor at, it is read as
    reported."""
    spans = [_span("segment", 100, 120, 1, rid=0), _span("sweep.collect", 150, 400, 2, rid=0),
             _span("engine.fetch", 200, 300, 3, rid=0), _span("engine.fetch", 300.1, 300.2, 4, rid=0)]
    copies = [(299.99, 300.0), (300.1, 300.2)]
    monkeypatch.setitem(sys.modules, program_spans.TRACER, types.SimpleNamespace(spans=lambda: spans))
    ctx = _late_ctx(late_ms, copies)
    pairs = program_spans.copy_pairs(ctx, spans)
    assert [w for _, w in pairs] == [(200 * MS, 300 * MS), (int(300.1 * MS), int(300.2 * MS))]
    assert program_spans.clock_offsets(pairs) == [-int(late_ms * MS)] * 2
    assert program_spans.idle_in_segment(ctx) == pytest.approx(1.0, abs=1e-9)
    ctx.trace.kernels = ctx.trace.kernels[:2]
    reported = (20 - abs(late_ms)) / (20 + max(late_ms, 0))   # a late device idles [0, late] too
    assert program_spans.idle_in_segment(ctx) == pytest.approx(reported, rel=1e-9)


def test_copies_pair_in_order_past_a_cut_edge():
    """A window that cuts off the first copy's span pairs the rest in order,
    though the lone copy ends nearer another span than its own."""
    spans = [_span("engine.fetch", 10, 50, 1), _span("engine.fetch", 50.1, 50.2, 2),
             _span("engine.fetch", 90, 140, 3), _span("engine.fetch", 140.1, 140.2, 4)]
    copies = [("Memcpy DtoH (Device -> Pageable)", int(a * MS), int(b * MS))
              for a, b in ((9.9, 9.95), (49.95, 50.0), (50.1, 50.15), (139.9, 140.0), (140.1, 140.2))]
    ctx = types.SimpleNamespace(trace=types.SimpleNamespace(t0=0, t1=1000 * MS, kernels=copies))
    pairs = program_spans.copy_pairs(ctx, spans)
    assert [(c[1], w[1]) for c, w in pairs] == [(int(b * MS), int(e * MS)) for b, e in
                                                ((50.0, 50), (50.15, 50.2), (140.0, 140),
                                                 (140.2, 140.2))]


def test_a_drifting_device_clock_is_tracked():
    """Requests every 50 ms, each with a short fetch and a blocking one, on
    a device clock that falls behind 1.5 ms a second (as one traced run of
    ``r101.bo`` read for 1.2 s): every copy pairs, and each pair's offset
    takes the drift back out to within 0.1 ms."""
    spans, copies, drift = [], [], []
    for i in range(80):
        t = 50.0 * i
        spans += [_span("engine.fetch", t, t + 0.2, 2 * i), _span("bo.fetch", t + 30, t + 42, 2 * i + 1)]
        for a, b in ((t + 0.05, t + 0.1), (t + 41.85, t + 41.9)):
            drift.append(1.5e-3 * b)
            copies.append(("Memcpy DtoH (Device -> Pageable)", int((a + drift[-1]) * MS),
                           int((b + drift[-1]) * MS)))
    ctx = types.SimpleNamespace(trace=types.SimpleNamespace(t0=0, t1=5000 * MS, kernels=copies))
    pairs = program_spans.copy_pairs(ctx, spans)
    assert len(pairs) == 160 and drift[-1] > 5.9
    for o, d in zip(program_spans.clock_offsets(pairs), drift):
        assert abs(o / MS + d) <= 0.1
