"""Inception-v3, the family of ``portbench/nets/inception3.py``, on the CPU:
its state dict against the port's module, its operation count, the plain
f32 net against the port's f32 module plan, and a whole tiny cell in a
fresh directory (correct; its fp8 control and a planted wrong logit fail
the check), and the module plan's two metrics: one from the program's
spans, one from the device trace's kernels."""

import contextlib
import json
import os
import shutil
import sys
import time
import types

import pytest
import torch

from portbench import harness, program_spans, reference as ref, spec
from portbench.traffic import make_pool

CONFIG = "portbench/configs/inception_v3-299-bf16.json"
# The plain f32 net against the port's f32 module plan: the widest logit
# error over the spread (std over the classes) of the reference's logits.
# Both sum in f32 but in other orders (the port's channels_last module
# against NCHW convolutions with BatchNorm as a scale and a shift); the two
# read 9.7e-5 to 1.8e-4 at 75^2 on seeds 1-3, the fp8 control 10.4 to 12.5.
PLAN_TOL = 1e-3
# The tiny cell's limit, from whole runs of one image at 75^2 on the CPU
# over seeds 1-8 and 2**31 + 7, 2**31 + 8 in float32: the program read
# rel_logit_err 2.1e-5 to 1.5e-4, the fp8 control 5.50-11.65;
# lower^0.4 * upper^0.6, rounded up. The cell is float32 so that its limit
# is tight enough to catch a small planted fault: in bf16 the CPU's module
# plan at 75^2 read 0.29-0.98 over those seeds.
TINY_LIMIT = 0.082
SEEDS = (1, 4, 2 ** 31 + 8)   # program 7.8e-5, 7.4e-5, 9.0e-5; control 5.75, 5.50, 9.90


def _config():
    return spec.load_json(os.path.join(spec.ROOT, CONFIG))


@pytest.fixture(scope="module")
def net():
    return spec.net(_config())


def test_state_shapes_are_the_ports(net):
    """Key for key, shape for shape and in order, the port's state dict
    without the train-only ``AuxLogits.*`` and BatchNorm's step counters,
    which inference does not read."""
    from network_interpretation_imagenet_tpu_torch.models import create_model

    module = create_model("inception_v3", "imagenet", num_classes=1000).module
    port = [(k, tuple(v.shape)) for k, v in module.state_dict().items()
            if not k.startswith("AuxLogits.") and not k.endswith("num_batches_tracked")]
    assert list(net.state_shapes(_config()).items()) == port
    assert net.HEAD == ("fc.weight", "fc.bias")
    assert net.residual_bn_keys(_config()) == {k for k, _ in port if k.endswith("bn.weight")}
    assert sum(k.endswith("conv.weight") for k, _ in port) == 94


def test_forward_flops_pinned_and_against_a_hook_count(net):
    from network_interpretation_imagenet_tpu_torch.models import create_model

    assert net.forward_flops(_config()) == 11_426_432_192
    counted = []

    def count(m, _, out):
        if isinstance(m, torch.nn.Conv2d):
            counted.append(2 * out.numel() * m.kernel_size[0] * m.kernel_size[1] * m.in_channels)
        elif isinstance(m, torch.nn.Linear):
            counted.append(2 * out.numel() * m.in_features)

    module = create_model("inception_v3", "imagenet", num_classes=10).module.eval()
    for m in module.modules():
        m.register_forward_hook(count)
    with torch.no_grad():
        module(torch.zeros(1, 75, 75, 3))
    assert net.forward_flops(dict(_config(), resolution=75, num_classes=10)) == sum(counted)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plain_against_the_ports_f32_plan(net, seed):
    from network_interpretation_imagenet_tpu_torch.models import ModulePlan, create_model

    cfg = dict(_config(), resolution=75, num_classes=10)
    state = ref.make_weights(net, cfg, seed, "cpu")
    images, _ = make_pool(20, 75, seed, "cpu")
    ref.calibrate(net, cfg, state, torch.from_numpy(images[:16]))
    x = torch.from_numpy(images[16:])
    want = net.Plain(cfg, state)(x).double()
    plan = ModulePlan(create_model("inception_v3", "imagenet", num_classes=10).module, state,
                      torch.float32, "cpu")
    with torch.inference_mode():
        got = plan(x).double()
    fp8 = net.Plain(cfg, state, quantize="fp8")(x).double()

    def err(logits):
        return float(((logits - want).abs().max(dim=1).values / want.std(dim=1)).max())

    assert err(got) <= PLAN_TOL
    assert err(fp8) > 100 * PLAN_TOL


@pytest.fixture(scope="module")
def inception_root(tmp_path_factory):
    """A fresh checkout holding one cell ``i.tiny``: Inception-v3 at 75^2,
    10 classes, float32, 20 windows an image in calls of 8, its own limits;
    no file of the harness edited."""
    root = tmp_path_factory.mktemp("inception") / "root"
    for sub in ("metrics", "nets"):
        shutil.copytree(os.path.join(spec.ROOT, "portbench", sub), root / "portbench" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "traffic", "limits"):
        (root / "portbench" / sub).mkdir()
    cfg = dict(_config(), name="inception-tiny", resolution=75, num_classes=10,
               dtype="float32")
    (root / "portbench/configs/inception-tiny.json").write_text(json.dumps(cfg))
    mix = spec.load_json(os.path.join(spec.ROOT, "portbench/traffic/window-1024.json"))
    mix.update(masks_per_image=20, mask_batch=8, pool_images=6, calibration_images=16,
               warm_images=1, check_images=2, check_batch=8)
    (root / "portbench/traffic/tiny.json").write_text(json.dumps(mix))
    (root / "portbench/limits/i.tiny.json").write_text(json.dumps({"limits": {
        "segments_heatmap_mismatch": 0, "iou_mismatch": 0, "outcome_mismatch": 0,
        "rel_logit_err": TINY_LIMIT}}))
    bench = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    bench["configs"] = [{"name": cfg["name"], "source": "https://arxiv.org/abs/1512.00567",
                         "file": "portbench/configs/inception-tiny.json", "reduced": [],
                         "why": "test"}]
    bench["workloads"] = [{"name": "i.tiny", "config": cfg["name"], "traffic": "tiny",
                           "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["i.tiny"] if "inception3.window-1024" in m["workloads"] else []
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def _run(root, seed, **kw):
    return harness.run(spec.Cell("i.tiny", root=root), seed, 0.0, False, time.perf_counter(),
                       device="cpu", **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_tiny_cell_is_correct_and_its_control_fails(inception_root, seed):
    out = _run(inception_root, seed, control=True)
    assert out["line"]["correct"] is True, out["checks"]
    assert out["verdicts"] == {"program": True, "control": False}, out["readings"]
    assert out["line"]["checks"]["rel_logit_err"]["limit"] == TINY_LIMIT


def _halve_a_target_probability(engine):
    """The first mask's probability of the target halved where the outcomes
    are produced: one wrong logit, every outcome kept."""
    collect = engine.collect

    def altered(handle):
        out = collect(handle)
        out.prob_target[0] *= 0.5
        return out

    engine.collect = altered


def test_a_planted_wrong_logit_fails(inception_root):
    out = _run(inception_root, SEEDS[0], engine_hook=_halve_a_target_probability)
    assert out["line"]["correct"] is False
    assert out["readings"]["program"]["rel_logit_err"] > TINY_LIMIT
    assert out["readings"]["program"]["outcome_mismatch"] == 0


class TracerOnTrace(harness.DeviceTrace):
    """A device trace on the CPU: the port's tracer records through the
    window, which one stand-in interval covers."""

    def __init__(self, enabled):
        super().__init__(True)

    @contextlib.contextmanager
    def __call__(self):
        from network_interpretation_imagenet_tpu_torch.utils import logging as tracer

        tracer.clear()
        tracer.enable()
        self.t0 = time.time_ns()
        try:
            yield self
        finally:
            self.t1 = time.time_ns()
            tracer.disable()
        self.kernels = [("b1_masked_batch", self.t0, self.t1)]


def test_the_plan_metrics_in_a_traced_tiny_run(inception_root, monkeypatch):
    """The window's images each run their prediction and 20 masks in calls
    of 8, 8 and 4 through the module plan: ``plan_host_ms.window`` reads the
    image's summed ``plan.forward`` spans. The stand-in trace holds one B1
    interval and no kernel, so ``plan_ops_per_forward.window`` finds no gap
    to count and is left out of the line."""
    from network_interpretation_imagenet_tpu_torch.utils import logging as tracer

    monkeypatch.setattr(harness, "DeviceTrace", TracerOnTrace)
    try:
        out = harness.run(spec.Cell("i.tiny", root=inception_root), SEEDS[0], 0.0, True,
                          time.perf_counter(), device="cpu")
    finally:
        tracer.clear()
    metrics = out["line"]["metrics"]
    assert out["line"]["correct"] is True, out["checks"]
    assert "plan_ops_per_forward.window" not in metrics
    assert 0 < metrics["plan_host_ms.window"]["value"] < out["window_s"] * 1e3


def _fake_tracer(monkeypatch, spans):
    module = types.ModuleType(program_spans.TRACER)
    module.spans = lambda: spans
    monkeypatch.setitem(sys.modules, program_spans.TRACER, module)


class _Ctx:
    def __init__(self, traced=True, kernels=()):
        self.traced = traced
        self.traffic = {"mask_batch": 8}
        self.trace = types.SimpleNamespace(t0=0, t1=1_000_000_000, kernels=list(kernels))


def _span(name, a_ms, b_ms, rid, attrs=None):
    return types.SimpleNamespace(name=name, start_ns=int(a_ms * 1e6), end_ns=int(b_ms * 1e6),
                                 id=None, parent=None, rid=rid, attrs=attrs)


def test_the_plan_host_reader_by_hand(monkeypatch):
    """Two images in the window (a third's collect falls outside it):
    image 0's plan spans sum 1 + 4 + 3 = 8 ms, image 1's 2 + 10 = 12 ms
    (median 10), a forward of no image of the sweep left out. Nothing to
    read untraced, or from a program without the span."""
    read = spec.reader("plan_host_ms.window")
    spans = [_span("sweep.collect", 100, 110, 0), _span("sweep.collect", 300, 310, 1),
             _span("sweep.collect", 1500, 1510, 2),
             _span("plan.forward", 10, 11, 0, {"batch": 1}),
             _span("plan.forward", 20, 24, 0, {"batch": 8}),
             _span("plan.forward", 30, 33, 0, {"batch": 4}),
             _span("plan.forward", 200, 202, 1, {"batch": 1}),
             _span("plan.forward", 210, 220, 1, {"batch": 8}),
             _span("plan.forward", 400, 401, 7, {"batch": 8}),
             _span("plan.forward", 1400, 1500, 2, {"batch": 8})]
    _fake_tracer(monkeypatch, spans)
    assert read(_Ctx()) == pytest.approx(10.0)
    assert read(_Ctx(traced=False)) is None
    _fake_tracer(monkeypatch, [s for s in spans if s.name != "plan.forward"])
    assert read(_Ctx()) is None


def test_the_plan_kernels_reader_by_hand():
    """Four B1 launches, the trace out of order: the gaps hold 3 kernels
    (a copy and a set beside them, left out), 3, and 5 (the next image's
    prediction too); the median is 3. Nothing to read untraced or with one
    B1 launch."""
    read = spec.reader("plan_ops_per_forward.window")
    names = ["void b1_masked_batch<bf16>(int)", "conv", "bn", "relu",
             "Memcpy DtoH (Device -> Pinned)", "b1_masked_batch", "conv", "Memset (Device)", "bn",
             "relu", "b1_masked_batch", "conv", "bn", "relu", "conv", "softmax",
             "b1_masked_batch", "conv"]
    kernels = [(n, 10 * i, 10 * i + 5) for i, n in enumerate(names)][::-1]
    assert read(_Ctx(kernels=kernels)) == 3.0
    assert read(_Ctx(traced=False, kernels=kernels)) is None
    assert read(_Ctx(kernels=kernels[:4])) is None
