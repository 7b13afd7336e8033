"""The port's tracer (utils/logging.py): the switch, spans with ids, parents
and request ids, the bounded buffer, the clock it shares with
``torch.profiler``, and the spans that the streaming sweep and the fused BO
request record, on the CPU with a reduced ResNet."""

import io
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from network_interpretation_imagenet_tpu_torch.config import BOConfig, SegmentConfig
from network_interpretation_imagenet_tpu_torch.models import ModelBundle, ResNet
from network_interpretation_imagenet_tpu_torch.saliency import bo_pipeline, sweep
from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine, fetch
from network_interpretation_imagenet_tpu_torch.utils import logging as trace
from network_interpretation_imagenet_tpu_torch.utils.logging import (
    PhaseLogger,
    Tracer,
    profiler_trace,
)

SYNCS_PER_IMAGE = 2   # outcomes and logits fetched; the uploads do not wait


@pytest.fixture(autouse=True)
def _clean_tracer():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


@pytest.fixture(scope="module")
def engine():
    """A reduced ResNet at 32^2 on the CPU, f32, 8 masks a forward."""
    torch.manual_seed(0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    stages = (1, 1, 1, 1)
    bundle = ModelBundle("r", ResNet(stages, num_classes=10), 32, 3, 10)
    yield SaliencyEngine(bundle, bundle.init(3), mask_batch=8, compute_dtype=torch.float32,
                         device="cpu")
    torch.set_num_threads(n)


def _images(count: int):
    rng = np.random.RandomState(4)
    return [rng.standard_normal((32, 32, 3)).astype(np.float32) for _ in range(count)]


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    reads = []
    clock = time.time_ns
    monkeypatch.setattr(time, "time_ns", lambda: reads.append(1) or clock())
    with trace.span("a", rid=3, x=1):
        with trace.span("b"):
            pass
    with PhaseLogger(enabled=False).phase("p", index=1):
        pass
    assert reads == [] and trace.spans() == [] and trace.TRACER.dropped == 0


def test_enable_and_a_profiler_switch_recording():
    trace.enable()
    with trace.span("on"):
        pass
    trace.disable()
    with trace.span("off"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("profiled"):
            pass
    with trace.span("after"):
        pass
    assert [s.name for s in trace.spans()] == ["on", "profiled"]


def test_ids_parents_and_request_ids_across_a_thread():
    trace.enable()
    seen = {}

    def worker():
        with trace.span("thread.root") as root:
            with trace.span("thread.child"):
                seen["root"] = root.id

    with trace.span("main", rid=7, k="v") as main:
        with trace.span("main.child"):
            with trace.span("main.grandchild", rid="other"):
                pass
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
        assert not t.is_alive()
    with trace.span("second.root") as second:
        pass
    got = {s.name: s for s in trace.spans()}
    assert len({s.id for s in got.values()}) == len(got) == 6
    assert (got["main"].parent, got["main"].rid, got["main"].attrs) == (None, 7, {"k": "v"})
    assert (got["main.child"].parent, got["main.child"].rid) == (main.id, 7)
    assert (got["main.grandchild"].parent, got["main.grandchild"].rid) == (
        got["main.child"].id, "other")
    # Another thread's spans start their own tree: a root's request id is its own id.
    assert (got["thread.root"].parent, got["thread.root"].rid) == (None, seen["root"])
    assert (got["thread.child"].parent, got["thread.child"].rid) == (seen["root"], seen["root"])
    assert (got["second.root"].parent, got["second.root"].rid) == (None, second.id)
    for s in got.values():
        assert s.start_ns <= s.end_ns
    assert got["main"].start_ns <= got["main.child"].start_ns <= got["main.child"].end_ns \
        <= got["main"].end_ns


def test_buffer_is_bounded_and_drops_are_counted():
    tr = Tracer(max_spans=3)
    tr.enable()
    for i in range(5):
        with tr.span(f"s{i}"):
            pass
    assert [s.name for s in tr.spans()] == ["s2", "s3", "s4"]
    assert tr.dropped == 2
    tr.clear()
    assert tr.spans() == [] and tr.dropped == 0
    assert trace.MAX_SPANS == 1 << 20


def test_threads_lose_no_update():
    """More threads than cores, switching often: every span is kept, each
    with an id of its own."""
    trace.enable()
    threads, per = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with trace.span("w"):
                    pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    spans = trace.spans()
    assert len(spans) == len({s.id for s in spans}) == threads * per
    assert all(s.parent is None and s.rid == s.id for s in spans)


def test_the_clock_is_the_profilers():
    """A ``record_function`` event from inside a span lies within the span,
    on the profiler's own timestamps: the span's clock is Kineto's, to well
    under the 5 ms either side."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer") as outer:
            time.sleep(0.005)
            with torch.profiler.record_function("inner"):
                time.sleep(0.002)
            time.sleep(0.005)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    inner, mine = events["inner"], _by_name(trace.spans(), "outer")[0]
    assert mine.id == outer.id
    assert mine.start_ns <= inner.start_ns()
    assert inner.start_ns() + inner.duration_ns() <= mine.end_ns
    assert "outer" in events   # the span's own record_function


def test_profiler_trace_holds_the_span_names(tmp_path):
    with profiler_trace(str(tmp_path)):
        with trace.span("sweep.predict", rid=0):
            with trace.span("engine.upload"):
                torch.ones(4) @ torch.ones(4)
    names = {e.get("name") for e in json.load(open(tmp_path / "trace.json"))["traceEvents"]}
    assert {"sweep.predict", "engine.upload"} <= names


def test_phase_is_a_span_and_keeps_its_line():
    trace.enable()
    out = io.StringIO()
    log = PhaseLogger(out)
    with log.phase("outer", count=2):
        with log.phase("segment", span="sweep.segment", rid=4, index=4):
            pass
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [(r["phase"], r.get("index"), r.get("count")) for r in lines] == [
        ("outer.segment", 4, None), ("outer", None, 2)]
    assert all(isinstance(r["seconds"], float) for r in lines)
    got = {s.name: s for s in trace.spans()}
    assert set(got) == {"outer", "sweep.segment"}
    assert got["outer"].attrs == {"count": 2}
    assert (got["sweep.segment"].parent, got["sweep.segment"].rid,
            got["sweep.segment"].attrs) == (got["outer"].id, 4, {"index": 4})


def test_streaming_sweep_traces_each_image(engine):
    """Each image's stages carry its index as the request id (its collect
    too, which runs while the next image is in flight); ``segment`` sits
    under ``sweep.segment`` and each copy under the stage that made it: the
    two fetches under ``sweep.collect``, and no ``engine.upload`` (the sweep
    uploads with ``upload_async``, which does not wait)."""
    images = _images(3)
    trace.enable()
    res = sweep.saliency_sweep(engine, [(im, None, None) for im in images],
                               SegmentConfig(min_size=10), num_mask_samples=12, seed=1)
    assert res.images_explained == 3
    spans = trace.spans()
    by_id = {s.id: s for s in spans}
    for i in range(3):
        mine = [s for s in spans if s.rid == i]
        stages = {s.name for s in mine if s.parent is None}
        assert stages == {"sweep.segment", "sweep.predict", "sweep.dispatch", "sweep.collect",
                          "sweep.finish"}
        (seg,) = _by_name(mine, "segment")
        assert by_id[seg.parent].name == "sweep.segment"
        parents = sorted(by_id[s.parent].name for s in mine if s.name.startswith("engine."))
        assert parents == ["sweep.collect"] * 2
        assert len(_by_name(mine, "engine.upload")) == 0
        assert len(_by_name(mine, "engine.fetch")) == 2
    # The collect of image i runs after image i + 1 is dispatched.
    first = {(s.name, s.rid): s for s in spans}
    assert first[("sweep.collect", 0)].start_ns >= first[("sweep.dispatch", 1)].end_ns
    copies = [s for s in spans if s.name in ("engine.upload", "engine.fetch")]
    assert len(copies) == SYNCS_PER_IMAGE * 3


def test_fetch_without_an_event_is_the_plain_copy():
    """``fetch(t)`` with no ``after=``: the tensor's values, dtype and shape,
    one ``engine.fetch`` span, the tensor left as it was."""
    trace.enable()
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7
    before = t.clone()
    got = fetch(t)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == (3, 4)
    np.testing.assert_array_equal(got, before.numpy())
    assert torch.equal(t, before)
    assert [s.name for s in trace.spans()] == ["engine.fetch"]


def test_upload_async_and_device_tensors_take_no_upload_span(engine):
    """``upload_async`` gives a contiguous tensor of the asked dtype on the
    engine's device with no ``engine.upload`` span, and a tensor already
    there passes ``_to_device`` without one; a host array still takes one."""
    trace.enable()
    seg = np.asfortranarray(np.arange(12, dtype=np.int64).reshape(3, 4))
    t = engine.upload_async(seg, np.int32)
    assert t.dtype == torch.int32 and t.device == engine.device and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), seg)
    assert engine._to_device(t, np.int32) is t
    assert trace.spans() == []
    engine._to_device(seg, np.int32)
    assert [s.name for s in trace.spans()] == ["engine.upload"]


def test_fused_bo_request_is_one_tree(engine):
    """One ``bo.call`` a request, each a root with a request id of its own;
    its children are the draws, the runner's input copies and its run
    (eager on the CPU), the one fetch and the heatmap."""
    image = _images(1)[0]
    seg = np.broadcast_to((np.arange(32) * 12 // 32).astype(np.int32)[None, :], (32, 32))
    target, _ = engine.predict_one(image)
    trace.enable()
    for seed in (0, 1):
        bo_pipeline.bo_window_saliency(engine, image, np.ascontiguousarray(seg),
                                       BOConfig(n_iters=2, n_pre_samples=2), seed=seed,
                                       target=target)
    spans = trace.spans()
    calls = _by_name(spans, "bo.call")
    assert len(calls) == 2 and len({c.rid for c in calls}) == 2
    for call in calls:
        assert call.parent is None and call.rid == call.id
        children = [s for s in spans if s.parent == call.id]
        assert sorted(s.name for s in children) == [
            "bo.draws", "bo.eager", "bo.fetch", "bo.heatmap", "bo.upload"]
        assert all(s.rid == call.rid and call.start_ns <= s.start_ns <= s.end_ns
                   <= call.end_ns for s in children)
    assert len(_by_name(spans, "bo.eager")) == 2 and not _by_name(spans, "bo.capture")
