"""The dense layers' concatenation counter (``DenseLayer.concat_bytes``) and
the module plan's span that reads it, on the CPU: the bytes each forward's
concatenations write against a count by hand (a small torchvision-layout
DenseNet, the reference's DenseNet-BC, DenseNet-121 and DenseNet-201 at
B = 1), nothing counted by a net without dense layers, the span's
attributes, logits equal to the bit with the tracer on and off; and the
tracer's ``counted_call``, which both plans open their span with."""

import threading

import pytest
import torch

from network_interpretation_imagenet_tpu_torch.models import (
    DenseLayer,
    DenseNet,
    FoldedResNet,
    ModulePlan,
    create_model,
)
from network_interpretation_imagenet_tpu_torch.utils import logging as trace


@pytest.fixture(autouse=True)
def _clean_tracer():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def hand_count(block_config, growth, init, side, batch, itemsize, compression=0.5):
    """Bytes of every dense layer's output (its input and ``growth`` new
    channels) at ``side`` (the first block's), the side halved and the
    channels compressed by each transition."""
    total, c = 0, init
    for i, n in enumerate(block_config):
        for _ in range(n):
            c += growth
            total += c * side * side * batch * itemsize
        if i != len(block_config) - 1:
            c, side = int(c * compression), side // 2
    return total


def _small() -> DenseNet:
    """torchvision's layout (the 7x7/2 stem, a 3x3/2 max pool, a 7x7 head
    pool) at small widths: 224^2 -> 56^2 in the first block, 7^2 at the head."""
    return DenseNet(growth_rate=8, block_config=(2, 3, 2, 1), compression=0.5,
                    num_init_features=16, bn_size=4, avgpool_size=7, num_classes=10,
                    imagenet_stem=True, input_size=224)


# name -> (module maker, input side, batch, hand count per byte of an element)
NETS = {
    "small": (_small, 224, 2, hand_count((2, 3, 2, 1), 8, 16, 56, 2, 1)),
    "densenet_bc40": (lambda: create_model("densenet", "cifar10", depth=40).module, 32, 3,
                      hand_count((6, 6, 6), 12, 24, 32, 3, 1)),
    "densenet121": (lambda: create_model("densenet121", num_classes=10).module, 224, 1,
                    hand_count((6, 12, 24, 16), 32, 64, 56, 1, 1)),
    "densenet201": (lambda: create_model("densenet201", num_classes=10).module, 224, 1,
                    hand_count((6, 12, 48, 32), 32, 64, 56, 1, 1)),
}


def _plan(module, dtype):
    return ModulePlan(module, module.init_state_dict(torch.Generator().manual_seed(3)), dtype,
                      "cpu")


def _images(side, batch, dtype):
    g = torch.Generator().manual_seed(side + batch)
    return torch.randn(batch, side, side, 3, generator=g).to(dtype)


def test_densenet201s_count_at_one_image_is_the_hand_count():
    """98 dense layers at 56^2, 28^2, 14^2 and 7^2: 18,489,856 elements an
    image, 36,979,712 bytes in bf16 (x 256: 9,466,806,272, the mask
    batch's on the card)."""
    assert hand_count((6, 12, 48, 32), 32, 64, 56, 1, 2) == 36_979_712
    assert hand_count((6, 12, 48, 32), 32, 64, 56, 256, 2) == 9_466_806_272


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(NETS))
def test_the_span_carries_the_hand_count(name, dtype):
    make, side, batch, per_byte = NETS[name]
    plan = _plan(make(), dtype)
    trace.enable()
    before = DenseLayer.concat_bytes
    with torch.inference_mode():
        plan(_images(side, batch, dtype))
    want = per_byte * torch.finfo(dtype).bits // 8
    assert DenseLayer.concat_bytes - before == want
    (span,) = trace.spans()
    assert span.attrs == {"batch": batch, "pool_launches": 0, "concat_bytes": want}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["small", "densenet201"])
def test_logits_are_bit_for_bit_the_same_traced(name, dtype):
    """Off, the span records nothing and the counter still counts; on or
    off, the logits are equal to the bit, and the module's own."""
    make, side, batch, per_byte = NETS[name]
    plan = _plan(make(), dtype)
    x = _images(side, batch, dtype)
    with torch.inference_mode():
        before = DenseLayer.concat_bytes
        off = plan(x)
        assert trace.spans() == []
        assert DenseLayer.concat_bytes - before == per_byte * torch.finfo(dtype).bits // 8
        trace.enable()
        on = plan(x)
        trace.disable()
        module = plan.net(x).float()
    assert off.dtype == torch.float32
    assert torch.equal(off, on) and torch.equal(off, module)


def test_inception_counts_no_concatenated_bytes():
    """Inception-v3 concatenates its branches, but has no dense layer."""
    bundle = create_model("inception_v3", num_classes=10)
    plan = ModulePlan(bundle.module, bundle.init(0), torch.bfloat16, "cpu")
    trace.enable()
    before = DenseLayer.concat_bytes
    with torch.inference_mode():
        plan(_images(75, 2, torch.bfloat16))
    assert DenseLayer.concat_bytes == before
    (span,) = trace.spans()
    assert span.attrs == {"batch": 2, "pool_launches": 0, "concat_bytes": 0}


def test_a_resnet_plan_counts_none_and_keeps_its_own_attributes():
    bundle = create_model("resnet18", num_classes=10)
    plan = FoldedResNet(bundle.init(0), bundle.module.stage_sizes, torch.float32)
    trace.enable()
    before = DenseLayer.concat_bytes
    with torch.inference_mode():
        plan(_images(32, 2, torch.float32))
    assert DenseLayer.concat_bytes == before
    (span,) = trace.spans()
    assert span.attrs == {"batch": 2, "grouped_convs": 0, "epilogues": 0}


def test_a_training_forward_counts_too():
    """The counter is the dense layer's, whatever calls it: a train-mode
    forward with gradients counts as the plan does."""
    module = _small().train()
    before = DenseLayer.concat_bytes
    module(torch.zeros(2, 224, 224, 3, requires_grad=True)).sum().backward()
    assert DenseLayer.concat_bytes - before == NETS["small"][3] * 4


# ``trace.counted_call``: a span, and each counter's rise over the call.

class _Counter:
    def __init__(self):
        self.value, self.reads = 0, 0

    def read(self):
        self.reads += 1
        return self.value


def test_counted_call_annotates_each_counters_rise():
    a, b = _Counter(), _Counter()
    a.value, b.value = 5, 100

    def work(x, y):
        a.value += x
        b.value += y
        return x * y

    trace.enable()
    with trace.span("caller", rid=4):
        got = trace.counted_call("step", {"as": a.read, "bs": b.read}, work, 3, 7, batch=2)
    assert got == 21
    step, caller = trace.spans()
    assert (step.name, step.attrs) == ("step", {"batch": 2, "as": 3, "bs": 7})
    assert step.parent == caller.id and step.rid == 4


def test_counted_call_off_reads_no_counter():
    a = _Counter()
    assert trace.counted_call("step", {"as": a.read}, lambda: 11) == 11
    assert a.reads == 0 and trace.spans() == []


def test_counted_call_that_raises_keeps_its_attributes_alone():
    a = _Counter()

    def fail():
        a.value += 1
        raise ValueError("no")

    trace.enable()
    with pytest.raises(ValueError):
        trace.counted_call("step", {"as": a.read}, fail, batch=1)
    (span,) = trace.spans()
    assert span.attrs == {"batch": 1}
    assert span.end_ns >= span.start_ns


def test_counted_call_counts_what_other_threads_add_meanwhile():
    """The counters are process-wide: a rise made by another thread during
    the call is counted in it."""
    a = _Counter()
    started, finish = threading.Event(), threading.Event()

    def other():
        started.wait()
        a.value += 10
        finish.set()

    def work():
        started.set()
        finish.wait()
        a.value += 1

    t = threading.Thread(target=other)
    t.start()
    trace.enable()
    trace.counted_call("step", {"as": a.read}, work)
    t.join()
    (span,) = trace.spans()
    assert span.attrs == {"as": 11}
