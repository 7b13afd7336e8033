"""ResNeXt, the family of ``portbench/nets/resnext.py``, on the CPU: its
state dict against the port's module, its operation count and the grouped
convolutions' bound, the plain f32 net against the port's f32 folded plan
at a small grouped size, a whole tiny cell in a fresh directory (correct;
its fp8 control and a planted wrong logit fail the check), and the cell's
metric of the grouped convolutions, from the program's spans."""

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

CONFIG = "portbench/configs/resnext101_32x8d-224-bf16.json"
SMALL = dict(stage_sizes=[1, 1, 1, 1], groups=4, width_per_group=4, resolution=64,
             num_classes=10)
# The plain f32 net against the port's f32 folded plan: the widest logit
# error over the spread (std over the classes) of the reference's logits.
# Both sum in f32 but in other orders (the plan's BatchNorm folded into the
# weights, channels_last, against NCHW convolutions followed by BatchNorm as
# a scale and a shift); the two read 4.4e-6 to 7.0e-6 at SMALL on seeds
# 1-3 with four torch threads, the fp8 control 0.76 to 1.12.
PLAN_TOL = 5e-5
# The tiny cell's limit, from whole runs of one image of ResNeXt-50 32x4d at
# 64^2 on the CPU in float32 over seeds 1-5, 2**31 + 7 and 2**31 + 8: the
# program read rel_logit_err 5.1e-6 to 1.3e-5, the fp8 control 0.98 to
# 1.83; lower^0.4 * upper^0.6, rounded up. The cell is float32 so that its
# limit is tight enough to catch a small planted fault.
TINY_LIMIT = 0.011
SEEDS = (1, 3, 2 ** 31 + 8)   # program 1.1e-5, 9.3e-6, 6.7e-6; control 1.21, 0.98, 1.83


def _config():
    return spec.load_json(os.path.join(spec.ROOT, CONFIG))


@pytest.fixture(scope="module")
def net():
    return spec.net(_config())


def test_state_shapes_are_the_ports(net):
    """Key for key, shape for shape and in order, the port's state dict of
    ``resnext101_32x8d`` without BatchNorm's step counters, which inference
    does not read; its 33 grouped 3x3s are [w, w / 32, 3, 3]."""
    from network_interpretation_imagenet_tpu_torch.models import create_model

    with torch.device("meta"):
        module = create_model("resnext101_32x8d", "imagenet", num_classes=1000).module
    port = [(k, tuple(v.shape)) for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")]
    assert list(net.state_shapes(_config()).items()) == port
    assert net.HEAD == ("fc.weight", "fc.bias")
    assert net.residual_bn_keys(_config()) == {k for k, _ in port if k.endswith("bn3.weight")}
    grouped = [s for k, s in port if k.endswith("conv2.weight")]
    assert len(grouped) == 33 and all(s[0] == 32 * s[1] for s in grouped)
    assert {s[0] for s in grouped} == {256, 512, 1024, 2048}


def test_forward_flops_pinned_and_against_a_hook_count(net):
    from network_interpretation_imagenet_tpu_torch.models import create_model

    assert net.forward_flops(_config()) == 32_828_030_976
    counted = []

    def count(m, _, out):
        if isinstance(m, torch.nn.Conv2d):
            counted.append(2 * out.numel() * m.kernel_size[0] * m.kernel_size[1]
                           * m.in_channels // m.groups)
        elif isinstance(m, torch.nn.Linear):
            counted.append(2 * out.numel() * m.in_features)

    module = create_model("resnext101_32x8d", "imagenet", num_classes=10).module.eval()
    for m in module.modules():
        m.register_forward_hook(count)
    with torch.no_grad():
        module(torch.zeros(1, 64, 64, 3))
    assert net.forward_flops(dict(_config(), resolution=64, num_classes=10)) == sum(counted)


def test_the_grouped_bound_pinned_and_by_hand(net):
    """33 convolutions; layer1.0's by hand at B = 256 (56^2 in and out, 256
    channels in 32 groups of 8, bf16); the forward's bound at B = 256 is
    bytes-bound (10.25 GB at 3.35 TB/s against 0.98 TFLOP at 989 TFLOP/s)."""
    cfg = _config()
    costs = net.grouped_costs(cfg, 256)
    assert len(costs) == 33
    assert costs[0] == (2.0 * 256 * 56 * 56 * 256 * 8 * 9,
                        2.0 * (2 * 256 * 56 * 56 * 256 + 256 * 8 * 9 + 256))
    assert sum(b for _, b in costs) == 10_246_073_856
    assert net.grouped_bound_ms(cfg, 256) == pytest.approx(3.0585295092537312, rel=1e-12)
    assert net.grouped_bound_ms(cfg, 1) == pytest.approx(0.01831324656716418, rel=1e-12)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plain_against_the_ports_f32_folded_plan(net, seed):
    """At a small grouped size (one block a stage, 4 groups of 4 channels in
    stage 1, 64^2), on the reference's seeded, calibrated weights."""
    from network_interpretation_imagenet_tpu_torch.models import FoldedResNet, ResNet

    cfg = dict(_config(), **SMALL)
    module = ResNet(SMALL["stage_sizes"], num_classes=10, groups=4, base_width=4)
    assert list(net.state_shapes(cfg).items()) == [
        (k, tuple(v.shape)) for k, v in module.state_dict().items()
        if not k.endswith("num_batches_tracked")]
    state = ref.make_weights(net, cfg, seed, "cpu")
    images, _ = make_pool(20, 64, seed, "cpu")
    ref.calibrate(net, cfg, state, torch.from_numpy(images[:16]))
    x = torch.from_numpy(images[16:])
    want = net.Plain(cfg, state)(x).double()
    plan = FoldedResNet(state, SMALL["stage_sizes"], torch.float32, "cpu")
    assert all(not chain for _, chain in plan.stages)   # a grouped net runs no B2 chain
    with torch.inference_mode():
        got = plan(x).double()
    fp8 = net.Plain(cfg, state, quantize="fp8")(x).double()

    def err(logits):
        return float(((logits - want).abs().max(dim=1).values / want.std(dim=1)).max())

    assert err(got) <= PLAN_TOL
    assert err(fp8) > 100 * PLAN_TOL


@pytest.fixture(scope="module")
def resnext_root(tmp_path_factory):
    """A fresh checkout holding one cell ``x.tiny``: ResNeXt-50 32x4d (the
    port's arch, whole) at 64^2, 10 classes, float32, 20 windows an image in
    calls of 8, its own limits; no file of the harness edited."""
    root = tmp_path_factory.mktemp("resnext") / "root"
    for sub in ("metrics", "nets"):
        shutil.copytree(os.path.join(spec.ROOT, "portbench", sub), root / "portbench" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "traffic", "limits"):
        (root / "portbench" / sub).mkdir()
    cfg = dict(_config(), name="resnext-tiny", arch="resnext50_32x4d", stage_sizes=[3, 4, 6, 3],
               width_per_group=4, resolution=64, num_classes=10, dtype="float32")
    (root / "portbench/configs/resnext-tiny.json").write_text(json.dumps(cfg))
    mix = spec.load_json(os.path.join(spec.ROOT, "portbench/traffic/window-1024.json"))
    mix.update(masks_per_image=20, mask_batch=8, pool_images=6, calibration_images=16,
               warm_images=1, check_images=2, check_batch=8)
    (root / "portbench/traffic/tiny.json").write_text(json.dumps(mix))
    (root / "portbench/limits/x.tiny.json").write_text(json.dumps({"limits": {
        "segments_heatmap_mismatch": 0, "iou_mismatch": 0, "outcome_mismatch": 0,
        "rel_logit_err": TINY_LIMIT}}))
    bench = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    bench["configs"] = [{"name": cfg["name"], "source": "https://arxiv.org/abs/1611.05431",
                         "file": "portbench/configs/resnext-tiny.json", "reduced": [],
                         "why": "test"}]
    bench["workloads"] = [{"name": "x.tiny", "config": cfg["name"], "traffic": "tiny",
                           "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["x.tiny"] if "resnext101.window-1024" in m["workloads"] else []
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def _run(root, seed, **kw):
    return harness.run(spec.Cell("x.tiny", root=root), seed, 0.0, False, time.perf_counter(),
                       device="cpu", **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_tiny_cell_is_correct_and_its_control_fails(resnext_root, seed):
    out = _run(resnext_root, seed, control=True)
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


def test_a_planted_wrong_logit_fails(resnext_root):
    out = _run(resnext_root, SEEDS[0], engine_hook=_halve_a_target_probability)
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


def test_the_folded_plan_metrics_in_a_traced_tiny_run(resnext_root, monkeypatch):
    """The window's image runs its prediction and 20 masks in calls of 8, 8
    and 4 through the folded plan: ``grouped_convs_per_forward.window``
    reads ResNeXt-50's 16 grouped 3x3s in a forward of 8, and
    ``plan_host_ms.window`` the image's summed ``plan.forward`` spans."""
    from network_interpretation_imagenet_tpu_torch.utils import logging as tracer

    monkeypatch.setattr(harness, "DeviceTrace", TracerOnTrace)
    try:
        out = harness.run(spec.Cell("x.tiny", root=resnext_root), SEEDS[0], 0.0, True,
                          time.perf_counter(), device="cpu")
    finally:
        tracer.clear()
    metrics = out["line"]["metrics"]
    assert out["line"]["correct"] is True, out["checks"]
    assert metrics["grouped_convs_per_forward.window"]["value"] == 16.0
    assert 0 < metrics["plan_host_ms.window"]["value"] < out["window_s"] * 1e3


def _fake_tracer(monkeypatch, spans):
    module = types.ModuleType(program_spans.TRACER)
    module.spans = lambda: spans
    monkeypatch.setitem(sys.modules, program_spans.TRACER, module)


class _Ctx:
    def __init__(self, traced=True):
        self.traced = traced
        self.traffic = {"mask_batch": 8}
        self.trace = types.SimpleNamespace(t0=0, t1=1_000_000_000, kernels=[])


def _span(name, a_ms, b_ms, attrs=None):
    return types.SimpleNamespace(name=name, start_ns=int(a_ms * 1e6), end_ns=int(b_ms * 1e6),
                                 id=None, parent=None, rid=0, attrs=attrs)


def test_the_grouped_convs_reader_by_hand(monkeypatch):
    """The forwards at the mask batch read 33, 33 and 30 (median 33); a
    prediction at batch 1, a span without the counter, another span and one
    outside the window are passed over. Nothing to read untraced, from a
    program whose plan records no counter, or with no forward at the mask
    batch."""
    read = spec.reader("grouped_convs_per_forward.window")
    spans = [_span("plan.forward", 10, 11, {"batch": 1, "grouped_convs": 7}),
             _span("plan.forward", 20, 24, {"batch": 8, "grouped_convs": 33}),
             _span("plan.forward", 30, 34, {"batch": 8, "grouped_convs": 30}),
             _span("plan.forward", 40, 44, {"batch": 8, "grouped_convs": 33}),
             _span("plan.forward", 50, 54, {"batch": 8, "pool_launches": 0}),
             _span("sweep.collect", 60, 61, {"grouped_convs": 0}),
             _span("plan.forward", 1400, 1500, {"batch": 8, "grouped_convs": 0})]
    _fake_tracer(monkeypatch, spans)
    assert read(_Ctx()) == 33.0
    assert read(_Ctx(traced=False)) is None
    _fake_tracer(monkeypatch, [s for s in spans if s.attrs.get("batch") != 8])
    assert read(_Ctx()) is None
    _fake_tracer(monkeypatch, [_span("plan.forward", 20, 24, {"batch": 8})])
    assert read(_Ctx()) is None
