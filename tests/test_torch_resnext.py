"""ResNeXt and Wide-ResNet in the port (models/resnet_imagenet.py,
utils/convert.py) against the JAX package's, f32 on the CPU.

Reduced depth (stage sizes (1, 2, 1, 1)) at the two shapes that matter:
grouped 3x3s (groups 4, base width 8: ResNeXt's layout) and wide ones
(groups 1, base width 128: Wide-ResNet's P = 2 * planes, C = 2 * P). The
JAX weights come from flax's own parameter shapes (``jax.eval_shape`` of
``init``, filled from numpy), so the test proves that a grouped flax kernel
[kH, kW, I/g, O] reaches torch's [O, I/g, kH, kW] through
``resnet_from_jax``. Logits within 1e-4 of max |logit|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_interpretation_imagenet_tpu.models.resnet_imagenet import Bottleneck as JBottleneck
from network_interpretation_imagenet_tpu.models.resnet_imagenet import ResNet as JaxResNet
from network_interpretation_imagenet_tpu.utils.convert import convert_resnet_imagenet
from network_interpretation_imagenet_tpu_torch.models import FoldedResNet, ResNet, create_model
from network_interpretation_imagenet_tpu_torch.models.resnet_imagenet import ARCHS
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
    |logit|; a grouped net runs no chain, a wide one a chain of C = 2 * P."""
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
        got = folded(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
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


# The folded plan's span: ``plan.forward`` with the batch and the grouped
# convolutions the call launched (ResNeXt-101's 33 grouped 3x3s, none in a
# dense net), the logits the same to the bit with the tracer on or off.
GROUPED_CONVS = {"resnext101_32x8d": 33, "resnet50": 0}


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
        {"batch": 3, "grouped_convs": GROUPED_CONVS[arch]},
        {"batch": 1, "grouped_convs": GROUPED_CONVS[arch]}]
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
    assert span.attrs == {"batch": 2, "grouped_convs": GROUPED_CONVS[arch]}
