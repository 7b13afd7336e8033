"""The module plan's span (``models.ModulePlan``, the engine's forward for
every arch but the ImageNet ResNets): one ``plan.forward`` a call, under the
caller's span and request id, with the batch, the pool kernel's launches
(0 on the CPU) and the dense layers' concatenated bytes (0 in a net without
dense layers), and nothing recorded or changed while the tracer is off. On
the CPU, Inception-v3 at 75^2 and small nets of the zoo."""

import numpy as np
import pytest
import torch

from network_interpretation_imagenet_tpu_torch.config import SegmentConfig
from network_interpretation_imagenet_tpu_torch.models import ModulePlan, create_model
from network_interpretation_imagenet_tpu_torch.saliency import sweep
from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
from network_interpretation_imagenet_tpu_torch.utils import logging as trace

@pytest.fixture(autouse=True)
def _clean_tracer():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _plan(arch: str, dtype=torch.bfloat16) -> ModulePlan:
    bundle = create_model(arch, "imagenet", num_classes=10)
    return ModulePlan(bundle.module, bundle.init(0), dtype, "cpu")


def _images(side: int, batch: int = 2, dtype=torch.bfloat16) -> torch.Tensor:
    g = torch.Generator().manual_seed(side)
    return torch.randn(batch, side, side, 3, generator=g).to(dtype)


@pytest.mark.parametrize("arch, side", [("inception_v3", 75), ("mobilenet_v2", 64),
                                        ("squeezenet1_1", 64), ("googlenet", 64)])
def test_one_span_a_forward_with_batch(arch, side):
    plan = _plan(arch)
    trace.enable()
    with torch.inference_mode():
        plan(_images(side, batch=3))
        plan(_images(side, batch=1))
    first, second = trace.spans()
    assert [s.name for s in (first, second)] == ["plan.forward"] * 2
    assert first.attrs == {"batch": 3, "pool_launches": 0, "concat_bytes": 0}
    assert second.attrs == {"batch": 1, "pool_launches": 0, "concat_bytes": 0}
    assert first.parent is None and first.rid == first.id and second.rid == second.id
    assert first.start_ns <= first.end_ns <= second.start_ns <= second.end_ns


def test_the_span_is_the_callers_child_with_its_request_id():
    plan = _plan("inception_v3")
    trace.enable()
    with torch.inference_mode(), trace.span("caller", rid=7):
        plan(_images(75))
    spans = {s.name: s for s in trace.spans()}
    assert spans["plan.forward"].parent == spans["caller"].id
    assert spans["plan.forward"].rid == 7


def test_off_records_nothing():
    plan = _plan("inception_v3")
    with torch.inference_mode():
        plan(_images(75))
    assert trace.spans() == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_logits_are_bit_for_bit_the_modules(dtype):
    """Calls with the tracer off and on, and the eval-mode module itself,
    give the same logits to the bit."""
    plan = _plan("inception_v3", dtype)
    x = _images(75, dtype=dtype)
    with torch.inference_mode():
        off = plan(x)
        trace.enable()
        on = plan(x)
        trace.disable()
        module = plan.net(x).float()
    assert off.dtype == torch.float32
    assert torch.equal(off, module) and torch.equal(on, module)


def test_the_sweep_records_each_images_forwards():
    """A streaming sweep over a module-plan arch: each image's prediction
    (batch 1, under ``sweep.predict``) and its masked forwards (batches 8 and
    4, under ``sweep.dispatch``) carry the image's index as request id."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        bundle = create_model("mobilenet_v2", "imagenet", num_classes=10)
        engine = SaliencyEngine(bundle, bundle.init(1), mask_batch=8,
                                compute_dtype=torch.float32, device="cpu")
        rng = np.random.RandomState(2)
        images = [rng.standard_normal((32, 32, 3)).astype(np.float32) for _ in range(3)]
        trace.enable()
        res = sweep.saliency_sweep(engine, [(im, None, None) for im in images],
                                   SegmentConfig(min_size=10), num_mask_samples=12, seed=1)
    finally:
        torch.set_num_threads(n)
    assert res.images_explained == 3
    spans = trace.spans()
    by_id = {s.id: s for s in spans}
    for i in range(3):
        plans = [s for s in spans if s.name == "plan.forward" and s.rid == i]
        assert [(by_id[s.parent].name, s.attrs["batch"]) for s in plans] == [
            ("sweep.predict", 1), ("sweep.dispatch", 8), ("sweep.dispatch", 4)]


def test_a_forward_that_raises_closes_its_span():
    """A wrong input raises inside the span: the span is recorded, closed,
    and the next one opens as a root, not as its child."""
    plan = _plan("squeezenet1_1")
    trace.enable()
    with torch.inference_mode():
        with pytest.raises(RuntimeError):
            plan(torch.zeros(2, 64, 64, 5, dtype=torch.bfloat16))
        plan(_images(64))
    failed, ok = trace.spans()
    assert (failed.name, failed.attrs) == ("plan.forward", {"batch": 2})
    assert failed.end_ns >= failed.start_ns
    assert ok.parent is None and ok.rid == ok.id
