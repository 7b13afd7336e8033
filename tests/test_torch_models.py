"""Port vs JAX package: the ResNet, its folded inference plan, and weights
carried across by ``resnet_from_jax``.

A reduced JAX ``ResNet(stage_sizes=(1, 2, 1, 2), block=Bottleneck)`` at 64^2
with random BatchNorm statistics goes through ``resnet_from_jax`` into the
port, and so do full-depth ResNet-18 and ResNet-34 (BasicBlock, 10 classes,
64^2). f32 logits must agree within 5e-4 * max|logit| (the COMPONENT_MAP.md
bar; the port folds BatchNorm, so rounding differs in the last f32 bits),
and the argmax exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_interpretation_imagenet_tpu.models.resnet_imagenet import BasicBlock as JaxBasicBlock
from network_interpretation_imagenet_tpu.models.resnet_imagenet import Bottleneck
from network_interpretation_imagenet_tpu.models.resnet_imagenet import ResNet as JaxResNet
from network_interpretation_imagenet_tpu.utils.convert import convert_resnet_imagenet
from network_interpretation_imagenet_tpu_torch.models import FoldedResNet, ResNet, create_model
from network_interpretation_imagenet_tpu_torch.utils.convert import resnet_from_jax
from torch_port_util import flax_resnet_variables, randomize_bn

STAGES = (1, 2, 1, 2)


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.RandomState(0)
    module = JaxResNet(stage_sizes=STAGES, block=Bottleneck, num_classes=10)
    variables = jax.tree.map(np.array, module.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 64, 64, 3))))
    randomize_bn(variables["params"], variables["batch_stats"], rng)
    x = rng.randn(3, 64, 64, 3).astype(np.float32)
    logits = np.asarray(jax.jit(module.apply)(variables, jnp.asarray(x)))
    return variables, x, logits


def test_resnet_logits_match_jax(jax_model):
    variables, x, want = jax_model
    sd = resnet_from_jax(variables)
    model = ResNet(STAGES, num_classes=10).eval()
    model.load_state_dict(sd, strict=True)
    atol = 5e-4 * np.abs(want).max()
    with torch.inference_mode():
        plain = model(torch.from_numpy(x)).numpy()
        folded = FoldedResNet(sd, STAGES, torch.float32, "cpu")(torch.from_numpy(x)).numpy()
    for got in (plain, folded):
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", ["resnet18", "resnet34"])
def test_basicblock_resnet_logits_match_jax(arch):
    """Every block of a BasicBlock net runs as plain torch convolutions in
    the folded plan (no B2 chain), and both forms match the JAX model."""
    bundle = create_model(arch, num_classes=10)
    stages = bundle.module.stage_sizes
    rng = np.random.RandomState(len(stages) + sum(stages))
    variables = flax_resnet_variables(bundle.init(4), stages)
    randomize_bn(variables["params"], variables["batch_stats"], rng)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    module = JaxResNet(stage_sizes=stages, block=JaxBasicBlock, num_classes=10)
    want = np.asarray(jax.jit(module.apply)(variables, jnp.asarray(x)))
    sd = resnet_from_jax(variables)
    model = bundle.module.eval()
    model.load_state_dict(sd, strict=True)
    folded_plan = FoldedResNet(sd, stages, torch.float32, "cpu")
    assert all(not chain for _, chain in folded_plan.stages)
    assert [len(blocks) for blocks, _ in folded_plan.stages] == list(stages)
    atol = 5e-4 * np.abs(want).max()
    with torch.inference_mode():
        plain = model(torch.from_numpy(x)).numpy()
        folded = folded_plan(torch.from_numpy(x)).numpy()
    for got in (plain, folded):
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", ["resnet18", "resnet34"])
def test_resnet_from_jax_inverts_convert_resnet_imagenet_basicblock(arch):
    sd = create_model(arch, num_classes=10).init(5)
    back = resnet_from_jax(convert_resnet_imagenet({k: v.numpy() for k, v in sd.items()}, arch))
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy(), err_msg=k)


def test_resnet_from_jax_inverts_convert_resnet_imagenet():
    """Port state_dict -> the JAX converter -> resnet_from_jax: identical."""
    bundle = create_model("resnet50", num_classes=10)
    sd = bundle.init(3)
    variables = convert_resnet_imagenet({k: v.numpy() for k, v in sd.items()}, "resnet50")
    back = resnet_from_jax(variables)
    assert back.keys() == sd.keys()
    for k in sd:
        assert back[k].dtype == sd[k].dtype, k
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy(), err_msg=k)


def test_create_model_bundle_and_seeded_init():
    bundle = create_model("resnet101", "imagenet", dtype=torch.bfloat16)
    assert (bundle.input_size, bundle.input_channels, bundle.num_classes) == (224, 3, 1000)
    assert bundle.dtype == torch.bfloat16 and bundle.module.stage_sizes == (3, 4, 23, 3)
    a, b, c = bundle.init(0), bundle.init(0), bundle.init(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    assert torch.equal(a["layer3.5.bn2.running_var"], torch.ones(256))
    assert create_model("resnet18").module.stage_sizes == (2, 2, 2, 2)
    with pytest.raises(ValueError):
        create_model("resnext50_32x4d")


def test_folded_plan_keeps_channels_last_and_runs_bf16():
    model = ResNet(STAGES, num_classes=10)
    sd = model.init_state_dict(torch.Generator().manual_seed(0))
    x = torch.randn(2, 64, 64, 3)
    with torch.inference_mode():
        f32 = FoldedResNet(sd, STAGES, torch.float32)(x)
        bf16 = FoldedResNet(sd, STAGES, torch.bfloat16)(x.to(torch.bfloat16))
    assert bf16.dtype == torch.float32 and bf16.shape == (2, 10)
    assert torch.isfinite(bf16).all()
    np.testing.assert_allclose(bf16.numpy(), f32.numpy(), rtol=0,
                               atol=0.1 * float(f32.abs().max()))
