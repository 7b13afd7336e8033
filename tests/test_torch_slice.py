"""The slice as a whole, port vs JAX package, in f32 on the CPU:

fixture image -> eval transform (64^2) -> display -> Felzenszwalb ->
predict_one -> eval_window_masks with the same starts -> heatmap ->
localization_score, through both engines on a reduced ResNet
(stage_sizes=(1, 2, 1, 2)) whose JAX weights reach the port through
``resnet_from_jax``.

Survive labels and preds are compared exactly. That is meaningful only where
no masked image's top-2 logit gap is within the logit tolerance
(5e-4 * max|logit|). The seeds below (init key 1, BatchNorm statistics from
RandomState(5)) were picked so, and so that survive labels vary (33 of 40
masks survive); the test asserts both.
Probabilities agree within 1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from network_interpretation_imagenet_tpu import models as jmodels
from network_interpretation_imagenet_tpu.models.resnet_imagenet import Bottleneck
from network_interpretation_imagenet_tpu.models.resnet_imagenet import ResNet as JaxResNet
from network_interpretation_imagenet_tpu.ops import aggregate as jaggregate
from network_interpretation_imagenet_tpu.saliency import pipeline as jpipeline
from network_interpretation_imagenet_tpu.saliency.engine import SaliencyEngine as JaxEngine
from network_interpretation_imagenet_tpu_torch.config import SegmentConfig
from network_interpretation_imagenet_tpu_torch.data.transform import pil_eval_transform
from network_interpretation_imagenet_tpu_torch.models import ModelBundle, ResNet
from network_interpretation_imagenet_tpu_torch.ops import aggregate, masking
from network_interpretation_imagenet_tpu_torch.ops.masked_batch import masked_batch
from network_interpretation_imagenet_tpu_torch.ops.preprocess import to_display_uint8
from network_interpretation_imagenet_tpu_torch.saliency import pipeline
from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
from network_interpretation_imagenet_tpu_torch.segment.common import segment_image
from network_interpretation_imagenet_tpu_torch.utils.convert import resnet_from_jax
from torch_port_util import randomize_bn

STAGES = (1, 2, 1, 2)
IMAGE = os.path.join(os.path.dirname(__file__), "fixtures", "imagenet_loc", "n01440764",
                     "ILSVRC2012_val_00000001.JPEG")
GT_XYWH = (10, 12, 30, 28)
K = 40


@pytest.fixture(scope="module")
def slice_setup():
    image = pil_eval_transform(Image.open(IMAGE).convert("RGB"), crop=64)
    segments = segment_image(to_display_uint8(torch.from_numpy(image)).numpy(), SegmentConfig())
    module = JaxResNet(stage_sizes=STAGES, block=Bottleneck, num_classes=10)
    variables = jax.tree.map(np.array, module.init(jax.random.PRNGKey(1),
                                                   jnp.zeros((1, 64, 64, 3))))
    randomize_bn(variables["params"], variables["batch_stats"], np.random.RandomState(5))
    jengine = JaxEngine(jmodels.ModelBundle("r", module, 64, 3, 10), variables,
                        mask_batch=16, compute_dtype=jnp.float32)
    bundle = ModelBundle("r", ResNet(STAGES, num_classes=10), 64, 3, 10)
    engine = SaliencyEngine(bundle, resnet_from_jax(variables), mask_batch=16,
                            compute_dtype=torch.float32, device="cpu")
    return image, segments, jengine, engine


def test_slice_matches_jax(slice_setup):
    image, segments, jengine, engine = slice_setup
    s = int(segments.max()) + 1
    width = int(0.4 * s)
    assert s >= 5, "degenerate segmentation"

    target, logits = engine.predict_one(image)
    jtarget, jlogits = jengine.predict_one(image)
    assert target == jtarget
    np.testing.assert_allclose(logits, jlogits, rtol=0, atol=5e-4 * np.abs(jlogits).max())

    firsts = masking.sample_window_starts_host(0, K, s, width)
    got = engine.eval_window_masks(image, segments, firsts, width, target)
    want = jengine.eval_window_masks(image, segments, firsts, width, target)

    # Exact label comparison is meaningful: no masked image sits near an argmax tie.
    with torch.inference_mode():
        masked = masked_batch(torch.from_numpy(image), torch.from_numpy(segments),
                              torch.from_numpy(firsts), width, torch.float32)
        top2 = torch.topk(engine.model(masked), 2).values
    gap = (top2[:, 0] - top2[:, 1]).min().item()
    assert gap > 5e-4 * np.abs(jlogits).max(), gap

    np.testing.assert_array_equal(got.survived, want.survived)
    np.testing.assert_array_equal(got.preds, want.preds)
    np.testing.assert_allclose(got.prob_target, want.prob_target, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.prob_max, want.prob_max, rtol=0, atol=1e-5)
    assert 0 < got.survived.sum() < K, "all masks alike: a weak test"

    heat = aggregate.summed_superpixel_labels_np(segments, firsts, width, got.survived)
    np.testing.assert_array_equal(
        heat, jaggregate.summed_superpixel_labels_np(segments, firsts, width, want.survived))
    for ref_compat in (False, True):
        iou, box = pipeline.localization_score(heat, GT_XYWH, ref_compat=ref_compat)
        jiou, jbox = jpipeline.localization_score(heat, GT_XYWH, ref_compat=ref_compat)
        np.testing.assert_array_equal(box, jbox)
        assert iou == jiou


def test_random_window_saliency_matches_jax_on_its_own_starts(slice_setup):
    """The port draws its starts from a torch.Generator; fed those starts,
    the JAX engine and aggregation give the same heatmap."""
    image, segments, jengine, engine = slice_setup
    out = pipeline.random_window_saliency(engine, image, segments, num_samples=K, seed=3)
    s = int(segments.max()) + 1
    assert out.num_segments == s and out.width == int(0.4 * s)
    assert out.firsts.min() >= 1 and out.firsts.max() <= max(s - out.width, 1)
    target, _ = jengine.predict_one(image)
    want = jengine.eval_window_masks(image, segments, out.firsts, out.width, target)
    np.testing.assert_array_equal(out.eval.survived, want.survived)
    np.testing.assert_array_equal(
        out.heatmap,
        jaggregate.summed_superpixel_labels_np(segments, out.firsts, out.width, want.survived))

    again = pipeline.random_window_saliency(engine, image, segments, num_samples=K, seed=3)
    other = pipeline.random_window_saliency(engine, image, segments, num_samples=K, seed=4)
    np.testing.assert_array_equal(again.firsts, out.firsts)
    np.testing.assert_array_equal(again.heatmap, out.heatmap)
    assert not np.array_equal(other.firsts, out.firsts)


def test_entry_points_need_a_card_unless_cpu_is_asked_for(slice_setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from network_interpretation_imagenet_tpu_torch.device import resolve_device
    from network_interpretation_imagenet_tpu_torch.ops import _cuda_build

    engine = slice_setup[3]
    with pytest.raises(RuntimeError):
        SaliencyEngine(engine.bundle, engine.bundle.init(0))
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        _cuda_build.library("masked_batch", {})
    assert resolve_device("cpu").type == "cpu"
