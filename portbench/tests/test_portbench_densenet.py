"""DenseNet-BC, the family of ``portbench/nets/densenet.py``, on the CPU: its
state dict against the port's modules (DenseNet-121, -169 and -201), its
operation count and the bytes its concatenations write, the plain f32 net
against the port's f32 module plan at a small size, a whole tiny cell in a
fresh directory (correct; its fp8 control and a planted wrong logit fail
the check), and the cell's metric of the concatenated bytes, from the
program's spans."""

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

CONFIG = "portbench/configs/densenet201-224-bf16.json"
# torchvision's layout at small widths; 224^2 is the least side at which the
# port's 7x7 head pool has a window (its torchvision nets' one resolution).
SMALL = dict(block_config=[2, 3, 2, 1], growth_rate=8, bn_size=4, num_init_features=16,
             num_classes=10)
# The plain f32 net against the port's f32 module plan: the widest logit
# error over the spread (std over the classes) of the reference's logits.
# Both sum in f32 but in other orders (the port's channels_last module
# against NCHW convolutions with BatchNorm as a scale and a shift); the two
# read 1.7e-6 to 5.0e-6 at SMALL on seeds 1-3 with four torch threads, the
# fp8 control 1.09 to 1.83.
PLAN_TOL = 5e-5
# The tiny cell's limit, from whole runs of one image of DenseNet-121 at
# 224^2 on the CPU in float32 over seeds 1-8, 2**31 + 7 and 2**31 + 8: the
# program read rel_logit_err 7.2e-7 to 1.3e-5, the fp8 control 0.143 to
# 1.82; lower^0.4 * upper^0.6, rounded up. The cell is float32 so that its
# limit is tight enough to catch a small planted fault.
TINY_LIMIT = 0.0035
SEEDS = (1, 3, 2 ** 31 + 8)   # program 1.3e-5, 1.2e-5, 5.3e-6; control 1.82, 0.77, 1.03


def _config():
    return spec.load_json(os.path.join(spec.ROOT, CONFIG))


@pytest.fixture(scope="module")
def net():
    return spec.net(_config())


@pytest.mark.parametrize("arch, blocks", [("densenet121", [6, 12, 24, 16]),
                                          ("densenet169", [6, 12, 32, 32]),
                                          ("densenet201", [6, 12, 48, 32])])
def test_state_shapes_are_the_ports(net, arch, blocks):
    """Key for key, shape for shape and in order, the port's state dict of
    ``arch`` without BatchNorm's step counters, which inference does not
    read; no BatchNorm is damped."""
    from network_interpretation_imagenet_tpu_torch.models import create_model

    with torch.device("meta"):
        module = create_model(arch, "imagenet", num_classes=1000).module
    port = [(k, tuple(v.shape)) for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")]
    cfg = dict(_config(), block_config=blocks)
    assert list(net.state_shapes(cfg).items()) == port
    assert net.HEAD == ("classifier.weight", "classifier.bias")
    assert net.residual_bn_keys(cfg) == set()
    assert sum(k.endswith("conv2.weight") for k, _ in port) == sum(blocks)


def test_densenet201s_shapes_by_hand(net):
    """98 dense layers and 3 transitions; the last layer reads 1,888
    channels at 7^2, and ``norm5`` and the head 1,920."""
    cfg = _config()
    shapes = net.state_shapes(cfg)
    dense = [p for p, _, _ in net.layers(cfg) if "denselayer" in p]
    assert len(dense) == 98 and len(list(net.layers(cfg))) == 101
    assert shapes["features.denseblock3.denselayer48.norm1.weight"] == (1760,)
    assert shapes["features.denseblock4.denselayer32.conv1.weight"] == (128, 1888, 1, 1)
    assert shapes["features.denseblock4.denselayer32.conv2.weight"] == (32, 128, 3, 3)
    assert shapes["features.transition2.conv.weight"] == (256, 512, 1, 1)
    assert shapes["features.norm5.weight"] == (1920,)
    assert shapes["classifier.weight"] == (1000, 1920)
    assert net.features(cfg) == 1920


def test_forward_flops_pinned_and_against_a_hook_count(net):
    from network_interpretation_imagenet_tpu_torch.models import create_model

    assert net.forward_flops(_config()) == 8_582_731_776
    counted = []

    def count(m, _, out):
        if isinstance(m, torch.nn.Conv2d):
            counted.append(2 * out.numel() * m.kernel_size[0] * m.kernel_size[1] * m.in_channels)
        elif isinstance(m, torch.nn.Linear):
            counted.append(2 * out.numel() * m.in_features)

    module = create_model("densenet121", "imagenet", num_classes=10).module.eval()
    for m in module.modules():
        m.register_forward_hook(count)
    with torch.no_grad():
        module(torch.zeros(1, 224, 224, 3))
    cfg = dict(_config(), block_config=[6, 12, 24, 16], num_classes=10)
    assert net.forward_flops(cfg) == sum(counted)


def test_concat_bytes_pinned_and_against_the_ports_counter(net):
    """9,466,806,272 bytes at 256 images in bf16 (36,979,712 at one), and
    the port's counter over one f32 forward of DenseNet-121 at two images."""
    from network_interpretation_imagenet_tpu_torch.models import (
        DenseLayer,
        ModulePlan,
        create_model,
    )

    cfg = _config()
    assert net.concat_bytes(cfg, 256, 2) == 9_466_806_272
    assert net.concat_bytes(cfg, 1, 2) == 36_979_712
    bundle = create_model("densenet121", "imagenet", num_classes=10)
    plan = ModulePlan(bundle.module, bundle.init(0), torch.float32, "cpu")
    before = DenseLayer.concat_bytes
    with torch.inference_mode():
        plan(torch.zeros(2, 224, 224, 3))
    assert DenseLayer.concat_bytes - before == net.concat_bytes(
        dict(cfg, block_config=[6, 12, 24, 16]), 2, 4)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plain_against_the_ports_f32_plan(net, seed):
    """At SMALL, on the reference's seeded, calibrated weights."""
    from network_interpretation_imagenet_tpu_torch.models import DenseNet, ModulePlan

    cfg = dict(_config(), **SMALL)
    module = DenseNet(growth_rate=8, block_config=(2, 3, 2, 1), compression=0.5,
                      num_init_features=16, bn_size=4, avgpool_size=7, num_classes=10,
                      imagenet_stem=True, input_size=224)
    assert list(net.state_shapes(cfg).items()) == [
        (k, tuple(v.shape)) for k, v in module.state_dict().items()
        if not k.endswith("num_batches_tracked")]
    state = ref.make_weights(net, cfg, seed, "cpu")
    images, _ = make_pool(20, 224, seed, "cpu")
    ref.calibrate(net, cfg, state, torch.from_numpy(images[:16]))
    x = torch.from_numpy(images[16:])
    want = net.Plain(cfg, state)(x).double()
    with torch.inference_mode():
        got = ModulePlan(module, state, torch.float32, "cpu")(x).double()
    fp8 = net.Plain(cfg, state, quantize="fp8")(x).double()

    def err(logits):
        return float(((logits - want).abs().max(dim=1).values / want.std(dim=1)).max())

    assert err(got) <= PLAN_TOL
    assert err(fp8) > 100 * PLAN_TOL


@pytest.fixture(scope="module")
def densenet_root(tmp_path_factory):
    """A fresh checkout holding one cell ``d.tiny``: DenseNet-121 (the
    port's arch, whole) at 224^2, 10 classes, float32, 20 windows an image
    in calls of 8, its own limits; no file of the harness edited."""
    root = tmp_path_factory.mktemp("densenet") / "root"
    for sub in ("metrics", "nets"):
        shutil.copytree(os.path.join(spec.ROOT, "portbench", sub), root / "portbench" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "traffic", "limits"):
        (root / "portbench" / sub).mkdir()
    cfg = dict(_config(), name="densenet-tiny", arch="densenet121",
               block_config=[6, 12, 24, 16], num_classes=10, dtype="float32")
    (root / "portbench/configs/densenet-tiny.json").write_text(json.dumps(cfg))
    mix = spec.load_json(os.path.join(spec.ROOT, "portbench/traffic/window-1024.json"))
    mix.update(masks_per_image=20, mask_batch=8, pool_images=6, calibration_images=16,
               warm_images=1, check_images=2, check_batch=8)
    (root / "portbench/traffic/tiny.json").write_text(json.dumps(mix))
    (root / "portbench/limits/d.tiny.json").write_text(json.dumps({"limits": {
        "segments_heatmap_mismatch": 0, "iou_mismatch": 0, "outcome_mismatch": 0,
        "rel_logit_err": TINY_LIMIT}}))
    bench = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    bench["configs"] = [{"name": cfg["name"], "source": "https://arxiv.org/abs/1608.06993",
                         "file": "portbench/configs/densenet-tiny.json", "reduced": [],
                         "why": "test"}]
    bench["workloads"] = [{"name": "d.tiny", "config": cfg["name"], "traffic": "tiny",
                           "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["d.tiny"] if "densenet201.window-1024" in m["workloads"] else []
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def _run(root, seed, **kw):
    return harness.run(spec.Cell("d.tiny", root=root), seed, 0.0, False, time.perf_counter(),
                       device="cpu", **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_tiny_cell_is_correct_and_its_control_fails(densenet_root, seed):
    out = _run(densenet_root, seed, control=True)
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


def test_a_planted_wrong_logit_fails(densenet_root):
    out = _run(densenet_root, SEEDS[0], engine_hook=_halve_a_target_probability)
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


def test_the_dense_metric_in_a_traced_tiny_run(densenet_root, monkeypatch, net):
    """The window's image runs its prediction and 20 masks in calls of 8,
    8 and 4 through the module plan: ``concat_gb_per_forward.window`` reads
    DenseNet-121's concatenated bytes in a forward of 8 in f32, and
    ``plan_host_ms.window`` the image's summed ``plan.forward`` spans."""
    from network_interpretation_imagenet_tpu_torch.utils import logging as tracer

    monkeypatch.setattr(harness, "DeviceTrace", TracerOnTrace)
    try:
        out = harness.run(spec.Cell("d.tiny", root=densenet_root), SEEDS[0], 0.0, True,
                          time.perf_counter(), device="cpu")
    finally:
        tracer.clear()
    metrics = out["line"]["metrics"]
    assert out["line"]["correct"] is True, out["checks"]
    want = net.concat_bytes(dict(_config(), block_config=[6, 12, 24, 16]), 8, 4) / 1e9
    assert want == 0.325541888
    assert metrics["concat_gb_per_forward.window"]["value"] == want
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


def test_the_concat_reader_by_hand(monkeypatch):
    """The forwards at the mask batch read 4e9, 5e9 and 9e9 bytes (median
    5 GB); a prediction at batch 1, a span without the counter (the folded
    plan's), another span and one outside the window are passed over.
    Nothing to read untraced, from a program whose plan records no counter
    (the parent of the counter), or with no forward at the mask batch."""
    read = spec.reader("concat_gb_per_forward.window")
    spans = [_span("plan.forward", 10, 11, {"batch": 1, "concat_bytes": 7}),
             _span("plan.forward", 20, 24, {"batch": 8, "concat_bytes": 9_000_000_000}),
             _span("plan.forward", 30, 34, {"batch": 8, "concat_bytes": 4_000_000_000}),
             _span("plan.forward", 40, 44, {"batch": 8, "concat_bytes": 5_000_000_000}),
             _span("plan.forward", 50, 54, {"batch": 8, "grouped_convs": 0, "epilogues": 0}),
             _span("sweep.collect", 60, 61, {"concat_bytes": 1}),
             _span("plan.forward", 1400, 1500, {"batch": 8, "concat_bytes": 1})]
    _fake_tracer(monkeypatch, spans)
    assert read(_Ctx()) == 5.0
    assert read(_Ctx(traced=False)) is None
    _fake_tracer(monkeypatch, [s for s in spans if s.attrs.get("batch") != 8])
    assert read(_Ctx()) is None
    _fake_tracer(monkeypatch, [_span("plan.forward", 20, 24, {"batch": 8, "pool_launches": 0})])
    assert read(_Ctx()) is None
