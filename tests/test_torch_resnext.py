"""ResNeXt and Wide-ResNet in the port (models/resnet_imagenet.py,
utils/convert.py) against the JAX package's, f32 on the CPU.

Reduced depth (stage sizes (1, 2, 1, 1)) at the two shapes that matter:
grouped 3x3s (groups 4, base width 8: ResNeXt's layout) and wide ones
(groups 1, base width 128: Wide-ResNet's P = 2 * planes, C = 2 * P). The
JAX weights come from flax's own parameter shapes (``jax.eval_shape`` of
``init``, filled from numpy), so the test proves that a grouped flax kernel
[kH, kW, I/g, O] reaches torch's [O, I/g, kH, kW] through
``resnet_from_jax``. Logits within 1e-4 of max |logit|."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_interpretation_imagenet_tpu.models.resnet_imagenet import Bottleneck as JBottleneck
from network_interpretation_imagenet_tpu.models.resnet_imagenet import ResNet as JaxResNet
from network_interpretation_imagenet_tpu.utils.convert import convert_resnet_imagenet
from network_interpretation_imagenet_tpu_torch.models import FoldedResNet, ResNet, create_model
from network_interpretation_imagenet_tpu_torch.models.common import fold_bn, max_pool_same
from network_interpretation_imagenet_tpu_torch.models import resnet_imagenet
from network_interpretation_imagenet_tpu_torch.models.resnet_imagenet import ARCHS
from network_interpretation_imagenet_tpu_torch.ops import _cuda_build
from network_interpretation_imagenet_tpu_torch.ops import epilogue_nhwc as en
from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import bottleneck_chain_plain
from network_interpretation_imagenet_tpu_torch.utils.convert import resnet_from_jax

STAGES = (1, 2, 1, 1)
TOL = 1e-4
SHAPES = {"grouped": (4, 8), "wide": (1, 128)}   # (groups, base_width)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flax_variables(module, size, seed):
    """Seeded numpy values in flax's own parameter tree (shapes from
    ``jax.eval_shape`` of ``init``): conv kernels LeCun-normal, BatchNorm
    scale, bias and statistics random."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3), jnp.float32))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name.endswith(("['scale']", "['var']")):
            return (rng.rand(*shape) + 0.5).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _images(size, n=2, seed=0):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


@pytest.mark.parametrize("kind,size", [("grouped", 32), ("grouped", 64), ("wide", 32)])
def test_logits_match_jax(kind, size):
    groups, base_width = SHAPES[kind]
    module = JaxResNet(stage_sizes=STAGES, block=JBottleneck, num_classes=10, groups=groups,
                       base_width=base_width)
    variables = _flax_variables(module, size, seed=size + groups)
    x = _images(size)
    want = np.asarray(module.apply(variables, jnp.asarray(x)))

    net = ResNet(STAGES, num_classes=10, groups=groups, base_width=base_width).eval()
    sd = resnet_from_jax(variables)
    net.load_state_dict(sd)   # strict: every key and every shape
    w3 = sd["layer1.0.conv2.weight"]
    width = int(64 * base_width / 64) * groups
    assert tuple(w3.shape) == (width, width // groups, 3, 3)
    np.testing.assert_array_equal(  # flax [kH, kW, I/g, O] -> torch [O, I/g, kH, kW]
        w3.numpy(), np.transpose(variables["params"]["layer1_0"]["conv2"]["kernel"],
                                 (3, 2, 0, 1)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("kind", ["grouped", "wide"])
def test_folded_plan_matches_plain_module(kind):
    """FoldedResNet f32 against the plain eval module within 1e-4 of max
    |logit|, on the CPU's route and on the epilogues' (``plain=True``); a
    grouped net runs no chain, a wide one a chain of C = 2 * P."""
    groups, base_width = SHAPES[kind]
    net = ResNet(STAGES, num_classes=10, groups=groups, base_width=base_width).eval()
    sd = net.init_state_dict(torch.Generator().manual_seed(1))
    rng = np.random.RandomState(2)
    for k in sd:
        if k.endswith(("running_var", "running_mean")):
            sd[k] = torch.from_numpy((rng.rand(*sd[k].shape) + 0.5).astype(np.float32)
                                     if k.endswith("var") else
                                     (rng.randn(*sd[k].shape) * 0.1).astype(np.float32))
    net.load_state_dict(sd)
    x = torch.from_numpy(_images(32, seed=3))
    folded = FoldedResNet(sd, STAGES, torch.float32)
    with torch.no_grad():
        want = net(x)
        got, got_epilogues = folded(x), folded(x, plain=True)
    for g in (got, got_epilogues):
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=0,
                                   atol=TOL * float(want.abs().max()))
    chains = [chain for _, chain in folded.stages]
    if kind == "grouped":
        assert not any(chains) and [len(b) for b, _ in folded.stages] == list(STAGES)
        assert folded.stages[0][0][0][0][1][4] == groups   # the 3x3's groups
    else:
        w1, _, w3, _, w2, _ = chains[1][:6]   # layer2.1: C = 512, P = 256
        assert tuple(w1.shape) == (512, 256) and tuple(w3.shape) == (3, 3, 256, 256)
        assert tuple(w2.shape) == (256, 512)


@pytest.mark.parametrize("arch", ["resnext50_32x4d", "wide_resnet50_2"])
def test_resnet_from_jax_inverts_convert_resnet_imagenet(arch):
    """Port state dict -> the JAX package's converter -> resnet_from_jax:
    identical, grouped kernels included."""
    sd = create_model(arch, num_classes=10).init(3)
    back = resnet_from_jax(convert_resnet_imagenet({k: v.numpy() for k, v in sd.items()}, arch))
    assert back.keys() == sd.keys()
    for k in ("layer1.0.conv2.weight", "layer4.2.conv2.weight", "layer3.1.bn2.running_var"):
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy(), err_msg=k)
    assert all(back[k].shape == sd[k].shape for k in sd)


def test_archs_match_the_jax_registry():
    from network_interpretation_imagenet_tpu.models import resnet_imagenet as jres

    assert set(ARCHS) == set(jres._CONFIGS)
    for arch in ARCHS:
        with torch.device("meta"):
            module = create_model(arch).module
        block, stages = jres._CONFIGS[arch]
        assert module.stage_sizes == stages, arch
        groups, base_width = jres._GROUPS.get(arch, (1, 64))
        if block is JBottleneck:
            conv2 = module.layer4[0].conv2
            assert conv2.groups == groups, arch
            assert conv2.out_channels == int(512 * base_width / 64) * groups, arch


# The folded plan's span: ``plan.forward`` with the batch, the grouped
# convolutions the call launched (ResNeXt-101's 33 grouped 3x3s, none in a
# dense net) and E1's launches (none on the CPU), the logits the same to the
# bit with the tracer on or off.
GROUPED_CONVS = {"resnext101_32x8d": 33, "resnet50": 0}
# Epilogues a forward: the stem's, then three an eager block (every block of
# ResNeXt-101, the first of each stage of a dense net).
EPILOGUES = {"resnext101_32x8d": 1 + 3 * 33, "resnet50": 1 + 3 * 4}


@pytest.fixture(scope="module")
def folded_plans():
    """Per (arch, dtype), the folded plan of ``arch`` with 10 classes on
    seeded weights, built once for the tests below."""
    made = {}

    def get(arch, dtype):
        if (arch, dtype) not in made:
            bundle = create_model(arch, num_classes=10)
            made[arch, dtype] = FoldedResNet(bundle.init(5), bundle.module.stage_sizes, dtype)
        return made[arch, dtype]

    return get


@pytest.fixture
def tracer():
    from network_interpretation_imagenet_tpu_torch.utils import logging as trace

    trace.disable()
    trace.clear()
    yield trace
    trace.disable()
    trace.clear()


@pytest.mark.parametrize("arch", sorted(GROUPED_CONVS))
def test_the_folded_plans_span_counts_its_grouped_convs(folded_plans, tracer, arch):
    """Two calls under a caller's span at 32^2: one ``plan.forward`` each,
    the caller's child with its request id, with ``batch`` and
    ``grouped_convs``."""
    plan = folded_plans(arch, torch.float32)
    tracer.enable()
    with torch.inference_mode(), tracer.span("caller", rid=9):
        plan(torch.from_numpy(_images(32, n=3)))
        plan(torch.from_numpy(_images(32, n=1)))
    caller = next(s for s in tracer.spans() if s.name == "caller")
    forwards = [s for s in tracer.spans() if s.name == "plan.forward"]
    assert [s.attrs for s in forwards] == [
        {"batch": 3, "grouped_convs": GROUPED_CONVS[arch], "epilogues": 0},
        {"batch": 1, "grouped_convs": GROUPED_CONVS[arch], "epilogues": 0}]
    assert all(s.parent == caller.id and s.rid == 9 for s in forwards)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", sorted(GROUPED_CONVS))
def test_the_folded_plans_logits_are_the_same_traced(folded_plans, tracer, arch, dtype):
    """Off, the span records nothing and the counter still counts; on or
    off, the logits are equal to the bit."""
    plan = folded_plans(arch, dtype)
    x = torch.from_numpy(_images(32, n=2)).to(dtype)
    with torch.inference_mode():
        before = FoldedResNet.grouped_launches
        off = plan(x)
        assert tracer.spans() == []
        assert FoldedResNet.grouped_launches - before == GROUPED_CONVS[arch]
        tracer.enable()
        on = plan(x)
    assert off.dtype == torch.float32 and torch.equal(off, on)
    (span,) = tracer.spans()
    assert span.attrs == {"batch": 2, "grouped_convs": GROUPED_CONVS[arch], "epilogues": 0}


class _FakeLibrary:
    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def epilogue_spy(monkeypatch):
    """Every forward takes the epilogue route (on the CPU too) through a
    recorder that lists ``(H, W, C, residual)`` of each epilogue and hands
    it to ``route`` (the plain twin unless a test sets it); E1's library is
    a recorder too (its calls listed)."""
    calls, seen = [], []
    monkeypatch.setattr(_cuda_build, "library", lambda name, sigs: _FakeLibrary(calls))
    monkeypatch.setattr(_cuda_build, "stream_ptr", lambda device: None)
    spy = types.SimpleNamespace(calls=calls, seen=seen, route=en.epilogue_nhwc_plain)

    def epilogue(y, bias, res=None):
        seen.append((y.shape[2], y.shape[3], y.shape[1], res is not None))
        return spy.route(y, bias, res)

    monkeypatch.setattr(FoldedResNet, "_epilogue", staticmethod(lambda device, plain: epilogue))
    return spy


@pytest.mark.parametrize("arch", sorted(EPILOGUES))
def test_the_epilogue_route_runs_once_a_convolution(folded_plans, tracer, epilogue_spy, arch):
    """A forward at 32^2 through the epilogue route (the plain twin) runs
    one epilogue after the stem and after each eager convolution, none
    after a projection, the residual with each block's last; the span reads
    ``epilogues`` 0 and the library is never called."""
    plan = folded_plans(arch, torch.bfloat16)
    tracer.enable()
    with torch.inference_mode():
        plan(torch.from_numpy(_images(32, n=2)).to(torch.bfloat16))
    (span,) = tracer.spans()
    blocks = (EPILOGUES[arch] - 1) // 3
    assert len(epilogue_spy.seen) == EPILOGUES[arch]
    assert [r for *_, r in epilogue_spy.seen] == [False] + [False, False, True] * blocks
    assert span.attrs["epilogues"] == 0 and epilogue_spy.calls == []


def test_the_cpu_route_runs_no_epilogue(folded_plans, tracer, monkeypatch):
    """On the CPU a forward without ``plain`` takes the convolutions' own
    biases: it calls neither the epilogue route nor the plain twin."""
    plan = folded_plans("resnet50", torch.bfloat16)

    def refuse(*args):
        raise AssertionError("an epilogue ran on the CPU's route")

    refuse.launches = 0
    for name in ("epilogue_nhwc", "epilogue_nhwc_plain"):
        monkeypatch.setattr(resnet_imagenet, name, refuse)
    tracer.enable()
    with torch.inference_mode():
        plan(torch.from_numpy(_images(32, n=1)).to(torch.bfloat16))
    (span,) = tracer.spans()
    assert span.attrs["epilogues"] == 0
    assert FoldedResNet._epilogue(torch.device("cpu"), False) is None
    monkeypatch.undo()
    assert FoldedResNet._epilogue(torch.device("meta"), False) is en.epilogue_nhwc
    assert FoldedResNet._epilogue(torch.device("cpu"), True) is en.epilogue_nhwc_plain


@pytest.mark.parametrize("kind", ["grouped", "wide"])
def test_a_reduced_nets_epilogues_and_their_launch_count(epilogue_spy, tracer, kind):
    """At reduced depth (stage sizes (1, 2, 1, 1)), a grouped net (every
    block eager) and a dense one (the first block of each stage) run 1 + 3
    x (eager blocks) epilogues a forward; where they reach the kernel's
    wrapper (its library a stand-in), ``plan.forward`` reads that many
    ``epilogues``, each launch with a residual exactly after a block's
    last convolution."""
    groups, base_width = SHAPES[kind]
    sd = ResNet(STAGES, num_classes=10, groups=groups,
                base_width=base_width).init_state_dict(torch.Generator().manual_seed(1))
    plan = FoldedResNet(sd, STAGES, torch.float32)
    eager = sum(STAGES) if kind == "grouped" else len(STAGES)
    x = torch.from_numpy(_images(32, seed=3))
    with torch.inference_mode():
        plan(x)
        assert len(epilogue_spy.seen) == 1 + 3 * eager
        epilogue_spy.route = en.epilogue_nhwc_kernel
        tracer.enable()
        plan(x)
    (span,) = tracer.spans()
    assert span.attrs["epilogues"] == 1 + 3 * eager == len(epilogue_spy.calls)
    residual = [args[1] is not None for _, args in epilogue_spy.calls]
    assert residual == [False] + [False, False, True] * eager


def _library_logits(plan, sd, x):
    """The forward as the library's ops run it: each convolution (the
    projection too) with its own bias, from the state dict's BatchNorms, in
    ``x``'s dtype, then ReLU, and after a block's last convolution the
    residual add and ReLU."""
    def conv(t, op, name, bn):
        w, _, stride, padding, groups = op
        w_hwio = sd[name + ".weight"].numpy().transpose(2, 3, 1, 0)
        b = torch.from_numpy(fold_bn(w_hwio, *(sd[f"{bn}.{k}"].numpy() for k in (
            "weight", "bias", "running_mean", "running_var")))[1]).to(t.dtype)
        return torch.nn.functional.conv2d(t, w, b, stride, padding, groups=groups)

    y = x.permute(0, 3, 1, 2)
    y = max_pool_same(torch.relu(conv(y, plan.stem, "conv1", "bn1")), 3, 2)
    for s, (blocks, chain) in enumerate(plan.stages, start=1):
        for b, (convs, ds, _) in enumerate(blocks):
            p = f"layer{s}.{b}"
            out = y
            for c, op in enumerate(convs[:-1], start=1):
                out = torch.relu(conv(out, op, f"{p}.conv{c}", f"{p}.bn{c}"))
            last = len(convs)
            out = conv(out, convs[-1], f"{p}.conv{last}", f"{p}.bn{last}")
            identity = y if ds is None else conv(y, ds, f"{p}.downsample.0",
                                                 f"{p}.downsample.1")
            y = torch.relu(out + identity)
        if chain:
            y = bottleneck_chain_plain(y.permute(0, 2, 3, 1), chain).permute(0, 3, 1, 2)
    return torch.matmul(y.float().mean(dim=(2, 3)), plan.fc_w) + plan.fc_b


def _reduced_plan(kind, dtype):
    """A reduced net's plan on seeded weights whose BatchNorms shift each
    bias, and the state dict."""
    groups, base_width = SHAPES[kind]
    net = ResNet(STAGES, num_classes=10, groups=groups, base_width=base_width)
    sd = net.init_state_dict(torch.Generator().manual_seed(4))
    rng = np.random.RandomState(5)
    for k in sd:
        if k.endswith(("bn1.bias", "bn2.bias", "bn3.bias", "downsample.1.bias")):
            sd[k] = torch.from_numpy((rng.randn(*sd[k].shape) * 0.5).astype(np.float32))
    return FoldedResNet(sd, STAGES, dtype), sd


@pytest.mark.parametrize("kind", ["grouped", "wide"])
def test_the_projection_bias_fold_keeps_the_logits(kind):
    """In f32, the epilogue route (each projection bias-free, its bias
    added to its block's last convolution's) gives the library's route's
    logits within 1e-5 of max |logit|; every projection block's last bias
    is the sum of the two."""
    plan, sd = _reduced_plan(kind, torch.float32)
    blocks = [blk for blocks, _ in plan.stages for blk in blocks if blk[1] is not None]
    assert len(blocks) == 4 and all(torch.equal(last, convs[-1][1] + ds[1])
                                    for convs, ds, last in blocks)
    x = torch.from_numpy(_images(32, seed=6))
    with torch.inference_mode():
        got, want = plan(x, plain=True), _library_logits(plan, sd, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind", ["grouped", "wide"])
def test_the_cpu_route_is_the_librarys_bit_for_bit(kind, dtype):
    """On the CPU a forward without ``plain`` is the library's op sequence
    to the bit: each bias added inside its convolution, before its one
    rounding."""
    plan, sd = _reduced_plan(kind, dtype)
    x = torch.from_numpy(_images(32, seed=6)).to(dtype)
    with torch.inference_mode():
        assert torch.equal(plan(x), _library_logits(plan, sd, x))
