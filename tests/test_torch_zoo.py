"""The torchvision zoo of the port (``models/{vgg,alexnet,squeezenet,
inception,googlenet,mobilenet,shufflenet,mnasnet,densenet}.py``) against
the JAX package's.

Every arch name the JAX package's ``create_model`` takes is enumerated: the
port's takes it too, the variables of both (the JAX one's traced with
``jax.eval_shape``, the port's on the meta device) have the same modules,
names and shapes, and the Grad-CAM layer menu, its default and the sanity
check's randomization stages are the same. One net of
each family, at the smallest input it takes (Inception 75^2, AlexNet 63^2,
DenseNet-121's 224^2 stem at reduced depth, 32^2 elsewhere), runs seeded
random weights (``tests/torch_port_util.py:jax_reference``, BatchNorm
statistics random) through both packages: f32 logits within
``LOGIT_TOL`` x max |logit|. ``max_pool_ceil`` is
held against the JAX package's at every shape SqueezeNet and GoogLeNet give
it at 224^2; the window and knockout survive labels of one zoo net
(MobileNetV2) are exact in f32, and its BO explanation (host loop and
fused runner) gives the JAX package's trace.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import jax_reference, jax_traced

from network_interpretation_imagenet_tpu import models as jmodels
from network_interpretation_imagenet_tpu.models import common as jcommon
from network_interpretation_imagenet_tpu.models.densenet import DenseNet as JDenseNet
from network_interpretation_imagenet_tpu.config import BOConfig as JBOConfig
from network_interpretation_imagenet_tpu.saliency import bo_pipeline as jbo
from network_interpretation_imagenet_tpu.saliency import engine as jengine
from network_interpretation_imagenet_tpu_torch.models import (
    ALL_ARCHS,
    ARCHS,
    TV_CONFIGS,
    DenseNet,
    ModelBundle,
    create_model,
    googlenet,
    squeezenet,
)
from network_interpretation_imagenet_tpu_torch.models.common import max_pool_ceil
from network_interpretation_imagenet_tpu_torch.config import BOConfig
from network_interpretation_imagenet_tpu_torch.saliency import bo_pipeline, gradient, sanity
from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
from network_interpretation_imagenet_tpu_torch.utils import convert

# Every name the JAX package's create_model takes (its models/__init__.py:73-175).
JAX_ARCHS = (
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
    "resnext101_32x8d", "wide_resnet50_2", "wide_resnet101_2",
    "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn",
    "alexnet", "squeezenet1_0", "squeezenet1_1", "inception_v3", "googlenet", "mobilenet_v2",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
    "mnasnet0_5", "mnasnet0_75", "mnasnet1_0", "mnasnet1_3", "mnist_cnn", "resnet",
    "densenet121", "densenet169", "densenet201", "densenet")
# f32 logits, port vs JAX: x max |logit| (measured up to 3e-6 on these nets).
LOGIT_TOL = 2e-5
ARCH_WK = "mobilenet_v2"  # the zoo net of the window and knockout test
# (arch, input side) of the nets run through both packages, one per family.
PARITY = (("vgg11_bn", 32), ("alexnet", 63), ("squeezenet1_0", 32), ("inception_v3", 75),
          ("googlenet", 32),
          ("mobilenet_v2", 32), ("shufflenet_v2_x0_5", 32), ("mnasnet0_5", 32),
          ("densenet_tv", 224))


def _dataset(arch):
    return {"mnist_cnn": ("mnist", {}), "resnet": ("cifar10", {"depth": 8}),
            "densenet": ("cifar10", {"depth": 10})}.get(arch, ("imagenet", {}))


def test_create_model_takes_every_jax_arch():
    assert sorted(ALL_ARCHS) == sorted(JAX_ARCHS)
    for arch in ("vgg", "resnet20x", "densenet100"):
        with pytest.raises(ValueError):
            create_model(arch)
    bundle = create_model("inception_v3")
    assert (bundle.input_size, bundle.module.transform_input) == (299, True)
    assert create_model("googlenet").module.transform_input
    assert create_model("resnet", "cifar10").module.depth == 56
    assert len(create_model("densenet", "cifar10").module.block_config) == 3
    assert create_model("densenet", "cifar10").module.block_config == (16, 16, 16)
    assert create_model("mnist_cnn", "mnist").input_channels == 1


@pytest.mark.parametrize("arch", [a for a in JAX_ARCHS if a not in ARCHS])
def test_variables_cam_layers_and_stages_match_jax(arch):
    """For every arch but the ImageNet ResNets (held in
    tests/test_torch_models.py, test_torch_resnext.py, test_torch_attribution.py
    and test_torch_xrai_lm.py), traced (``jax.eval_shape``; the port on the
    meta device): the port's variables carried into the JAX layout have the
    JAX model's tree (module paths, leaves and shapes) and the JAX tree
    carried back is the port's state_dict (train-only heads aside); the
    Grad-CAM layer menu (names and shapes), its default and the sanity
    check's randomization stages are the JAX package's
    (``tests/torch_port_util.py:jax_traced``)."""
    dataset, kw = _dataset(arch)
    size = {"inception_v3": 75, "alexnet": 63}.get(arch, 32 if dataset == "imagenet" else None)
    if arch in TV_CONFIGS:
        size = 224  # below it the 7x7 head pool leaves no features
    jb = jmodels.create_model(arch, dataset, num_classes=10, **kw)
    size = size or jb.input_size
    x = jnp.zeros((1, size, size, jb.input_channels))
    want, jmenu, jdefault, jstages = jax_traced(jb.module, x)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), want)
    want = jax.tree.map(lambda s: tuple(s.shape), want)
    with torch.device("meta"):
        bundle = (_at_side(arch, size) if dataset == "imagenet"
                  else create_model(arch, dataset, num_classes=10, **kw))
        sd = dict(bundle.module.state_dict())
        menu = gradient.gradcam_target_layers(bundle, sd, torch.zeros(x.shape[1:]))
    assert menu == jmenu
    assert gradient._default_gradcam_layer(menu) == jdefault
    assert sanity.randomization_stages(bundle) == jstages
    got = jax.tree.map(lambda a: tuple(a.shape), convert.jax_variables(
        {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in sd.items()}, bundle.module))
    assert got == want
    back = convert.from_jax(zeros, bundle.module)
    optional = bundle.module.optional_prefixes
    assert set(back) == {k for k in sd if not k.startswith(optional)}


def _at_side(arch, side):
    """The port's ImageNet net of ``arch`` with its input-sized Dense
    layers (VGG's, AlexNet's, DenseNet's) sized for ``side``, as the JAX
    package's are by the input they are built on."""
    from network_interpretation_imagenet_tpu_torch.models import (
        create_densenet_torchvision,
        create_vgg,
    )
    from network_interpretation_imagenet_tpu_torch.models.alexnet import AlexNet

    if arch.startswith("vgg"):
        module = create_vgg(arch, num_classes=10, input_size=side)
    elif arch.startswith("densenet"):
        module = create_densenet_torchvision(arch, num_classes=10, input_size=side)
    elif arch == "alexnet":
        module = AlexNet(num_classes=10, input_size=side)
    else:
        module = create_model(arch, num_classes=10).module
    return ModelBundle(arch, module, side, 3, 10)


def _pair(arch, side):
    """(JAX bundle, port bundle) at ``side``; ``densenet_tv`` is
    DenseNet-121's ImageNet stem and 7x7 head at reduced depth."""
    if arch == "densenet_tv":
        kw = dict(growth_rate=32, block_config=(1, 2, 1, 1), num_init_features=64,
                  bn_size=4, avgpool_size=7, num_classes=10, imagenet_stem=True)
        return (jmodels.ModelBundle(arch, JDenseNet(**kw), side, 3, 10),
                ModelBundle(arch, DenseNet(**kw, input_size=side), side, 3, 10))
    return (jmodels.create_model(arch, num_classes=10), _at_side(arch, side))


@pytest.fixture(scope="module")
def parity_cache():
    return {}


def _parity(cache, arch, side):
    if arch not in cache:
        jb, bundle = _pair(arch, side)
        x = np.random.RandomState(1).rand(2, side, side, 3).astype(np.float32)
        cache[arch] = (bundle, x) + jax_reference(jb, x, seed=0)
    return cache[arch]


@pytest.mark.parametrize("arch,side", PARITY)
def test_zoo_logits_match_jax(parity_cache, arch, side):
    bundle, x, variables, jlogits = _parity(parity_cache, arch, side)
    sd = convert.from_jax(variables, bundle.module)
    logits = bundle.logits(sd, torch.from_numpy(x)).detach().numpy()
    scale = np.abs(jlogits).max()
    assert np.abs(jlogits).std() > 1e-3 * scale
    np.testing.assert_allclose(logits, jlogits, rtol=0, atol=LOGIT_TOL * scale)


def _pool_calls(module_of_pool, bundle):
    """(input shape, window, stride, padding) of every ``max_pool_ceil`` call
    of ``bundle``'s forward at 224^2."""
    calls = []
    real = module_of_pool.max_pool_ceil

    def record(x, *args):
        calls.append((tuple(x.shape), *args))
        return real(x, *args)

    module_of_pool.max_pool_ceil = record
    try:
        with torch.no_grad():
            bundle.module.eval()(torch.zeros(1, 224, 224, 3))
    finally:
        module_of_pool.max_pool_ceil = real
    return calls


def test_max_pool_ceil_matches_jax_padding():
    """torch's ceil-mode pool against the JAX package's asymmetric -inf
    padding at every call SqueezeNet 1.0 / 1.1 and GoogLeNet make at 224^2
    (3x3/2 at odd and even sides, GoogLeNet's 2x2/2 and its branches'
    3x3/1 pad 1), on random values: exact."""
    calls = set()
    for arch, mod in (("squeezenet1_0", squeezenet), ("squeezenet1_1", squeezenet),
                      ("googlenet", googlenet)):
        calls |= set(_pool_calls(mod, create_model(arch, num_classes=10)))
    assert len(calls) >= 10
    rng = np.random.RandomState(0)
    for shape, window, stride, *pad in sorted(calls):
        padding = pad[0] if pad else 0
        x = rng.randn(1, min(shape[1], 8), shape[2], shape[3]).astype(np.float32)
        got = max_pool_ceil(torch.from_numpy(x), window, stride, padding).numpy()
        want = np.asarray(jcommon.max_pool_ceil(jnp.asarray(x.transpose(0, 2, 3, 1)), window,
                                                stride, padding)).transpose(0, 3, 1, 2)
        np.testing.assert_array_equal(got, want, err_msg=str((shape, window, stride, padding)))


@pytest.fixture(scope="module")
def zoo_engines(parity_cache):
    """MobileNetV2 at 32^2 on both engines in f32, seeded weights shared:
    (image, segments, JAX engine, port engine, target)."""
    bundle, x, variables, *_ = _parity(parity_cache, ARCH_WK, 32)
    hh, ww = np.mgrid[0:32, 0:32]
    segments = ((hh // 8) * 4 + ww // 8).astype(np.int32)  # 16 segments
    jb = jmodels.create_model(ARCH_WK, num_classes=10)
    je = jengine.SaliencyEngine(jb, variables, mask_batch=16, compute_dtype=jnp.float32)
    engine = SaliencyEngine(bundle, convert.from_jax(variables, bundle.module), mask_batch=16,
                            compute_dtype=torch.float32, device="cpu")
    target = engine.predict_one(x[0])[0]
    assert target == je.predict_one(x[0])[0]
    return x[0], segments, je, engine, target


def test_zoo_window_and_knockout_labels_match_jax(zoo_engines):
    """MobileNetV2 at 32^2 through both engines in f32: window and knockout
    survive labels and predictions exact, probabilities close."""
    image, segments, je, engine, target = zoo_engines
    rng = np.random.RandomState(3)
    firsts = rng.randint(0, 16, 40).astype(np.int32)
    knock = rng.randint(0, 16, (40, 2)).astype(np.int32)
    for got, want in ((engine.eval_window_masks(image, segments, firsts, 6, target),
                       je.eval_window_masks(image, segments, firsts, 6, target)),
                      (engine.eval_knockout_masks(image, segments, knock, target),
                       je.eval_knockout_masks(image, segments, knock, target))):
        np.testing.assert_array_equal(got.survived, want.survived)
        np.testing.assert_array_equal(got.preds, want.preds)
        np.testing.assert_allclose(got.prob_target, want.prob_target, atol=1e-5)
        # The labels hold both outcomes (29 and 37 of 40 survive), so exactness means something.
        assert 0 < got.survived.sum() < 40


@pytest.mark.parametrize("fused", [False, True])
def test_zoo_bo_window_saliency_matches_jax(zoo_engines, fused):
    """The BO explanation through a non-ResNet plan: the host loop from the
    same seed, and the fused runner (its CUDA graph's program, run eagerly
    here) fed the JAX trace's starts as draws, give the JAX package's trace
    and heatmap."""
    image, segments, je, engine, target = zoo_engines
    jout, jtr = jbo.bo_window_saliency(je, image, segments, JBOConfig(n_iters=4, n_pre_samples=3),
                                       seed=1, target=target, fused=fused)
    kw = {"draws": torch.from_numpy(jtr.xp.astype(np.int64))} if fused else {"seed": 1}
    out, tr = bo_pipeline.bo_window_saliency(engine, image, segments,
                                             BOConfig(n_iters=4, n_pre_samples=3), target=target,
                                             fused=fused, **kw)
    np.testing.assert_array_equal(tr.xp, jtr.xp)
    np.testing.assert_array_equal(tr.survived, jtr.survived)
    # As the window test's probabilities: MobileNetV2's f32 convolutions round
    # differently in the two packages by up to 6e-6 here (ResNet's by 1e-6).
    np.testing.assert_allclose(tr.yp, jtr.yp, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out.heatmap, jout.heatmap)
