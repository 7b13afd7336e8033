"""Port vs JAX package: configuration, eval transform, preprocessing,
segmentation, aggregation and box metrics, on the committed ImageNet
fixture and its torch-semantics goldens. All comparisons are exact unless a
tolerance is stated."""

import dataclasses
import importlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from network_interpretation_imagenet_tpu import config as jconfig
from network_interpretation_imagenet_tpu.data import transform as jtransform
from network_interpretation_imagenet_tpu.ops import aggregate as jaggregate
from network_interpretation_imagenet_tpu.ops import metrics as jmetrics
from network_interpretation_imagenet_tpu.ops import preprocess as jpreprocess
from network_interpretation_imagenet_tpu_torch import config
from network_interpretation_imagenet_tpu_torch.data import transform
from network_interpretation_imagenet_tpu_torch.ops import aggregate, metrics, preprocess
from network_interpretation_imagenet_tpu_torch.segment import common
from network_interpretation_imagenet_tpu_torch.segment import felzenszwalb as felz

# The JAX segment package re-exports same-named functions; fetch the modules.
jcommon = importlib.import_module("network_interpretation_imagenet_tpu.segment.common")
jfelz = importlib.import_module("network_interpretation_imagenet_tpu.segment.felzenszwalb")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "imagenet_loc")
IMAGES = [
    os.path.join(FIXTURE, "n01440764", "ILSVRC2012_val_00000001.JPEG"),
    os.path.join(FIXTURE, "n01443537", "ILSVRC2012_val_00000002.JPEG"),
    os.path.join(FIXTURE, "n01484850", "ILSVRC2012_val_00000003.JPEG"),
]


def _pil(i):
    return Image.open(IMAGES[i]).convert("RGB")


def _display(i, crop):
    """Fixture image -> eval transform -> the min-max uint8 display image."""
    norm = transform.pil_eval_transform(_pil(i), crop=crop)
    return preprocess.to_display_uint8(torch.from_numpy(norm)).numpy()


def test_config_matches_jax():
    for port_cls, jax_cls in [(config.DatasetSpec, jconfig.DatasetSpec),
                              (config.SegmentConfig, jconfig.SegmentConfig)]:
        jax_f = {f.name: f.default for f in dataclasses.fields(jax_cls)}
        for f in dataclasses.fields(port_cls):  # the port keeps the fields it uses
            assert f.name in jax_f and f.default == jax_f[f.name], f.name
    assert [f.name for f in dataclasses.fields(config.DatasetSpec)] == \
        [f.name for f in dataclasses.fields(jconfig.DatasetSpec)]
    assert config.DATASETS == {k: config.DatasetSpec(**dataclasses.asdict(v))
                               for k, v in jconfig.DATASETS.items()}
    assert (config.IMAGENET_MEAN, config.IMAGENET_STD) == (jconfig.IMAGENET_MEAN,
                                                          jconfig.IMAGENET_STD)


@pytest.mark.parametrize("i", range(3))
def test_eval_transform_matches_jax_and_golden(i):
    golden = np.load(os.path.join(FIXTURE, "golden.npz"))
    got = transform.pil_eval_transform(_pil(i))
    np.testing.assert_array_equal(got, jtransform.pil_eval_transform(_pil(i)))
    np.testing.assert_allclose(got, golden[f"img{i}"], atol=1e-6)
    np.testing.assert_array_equal(transform.pil_eval_transform(_pil(i), crop=64, raw=True),
                                  jtransform.pil_eval_transform(_pil(i), crop=64, raw=True))
    assert transform.resized_output_size(500, 375, 224) == \
        jtransform.resized_output_size(500, 375, 224)


def test_preprocess_matches_jax(rng):
    img = rng.rand(32, 24, 3).astype(np.float32)
    mean, std = config.IMAGENET_MEAN, config.IMAGENET_STD
    norm = preprocess.normalize(torch.from_numpy(img), mean, std)
    jnorm = jpreprocess.normalize(jnp.asarray(img), mean, std)
    np.testing.assert_array_equal(norm.numpy(), np.asarray(jnorm))
    np.testing.assert_array_equal(preprocess.denormalize(norm, mean, std).numpy(),
                                  np.asarray(jpreprocess.denormalize(jnorm, mean, std)))
    np.testing.assert_array_equal(preprocess.to_display_uint8(norm).numpy(),
                                  np.asarray(jpreprocess.to_display_uint8(jnorm)))


def test_relabel_sequential_matches_jax(rng):
    labels = rng.randint(0, 50, (40, 30)) * 7 + 3
    got = common.relabel_sequential(labels)
    np.testing.assert_array_equal(got, jcommon.relabel_sequential(labels))
    assert got[0, 0] == 0 and got.max() + 1 == len(np.unique(labels))


@pytest.mark.parametrize("i", range(3))
def test_felzenszwalb_native_matches_jax_on_fixture(i):
    disp = _display(i, 224)
    got = felz.felzenszwalb(disp, scale=100, sigma=0.5, min_size=50)
    np.testing.assert_array_equal(
        got, jfelz.felzenszwalb(disp, scale=100, sigma=0.5, min_size=50, backend="native"))
    np.testing.assert_array_equal(common.segment_image(disp, config.SegmentConfig()),
                                  jcommon.segment_image(disp, jconfig.SegmentConfig()))
    assert got.min() == 0 and got.max() + 1 == len(np.unique(got))


def test_felzenszwalb_numpy_matches_native_and_jax():
    disp = _display(0, 48)
    cfg = dict(scale=8.0, sigma=0.5, min_size=10)
    plain = felz.felzenszwalb(disp, backend="numpy", **cfg)
    np.testing.assert_array_equal(plain, felz.felzenszwalb(disp, backend="native", **cfg))
    np.testing.assert_array_equal(plain, jfelz.felzenszwalb(disp, backend="numpy", **cfg))
    with pytest.raises(ValueError):
        felz.felzenszwalb(disp, backend="auto")


def test_aggregate_matches_jax(rng):
    seg = rng.randint(0, 30, (20, 20)).astype(np.int32)
    firsts = rng.randint(1, 20, 50).astype(np.int32)
    labels = rng.rand(50) > 0.4
    heat = aggregate.summed_superpixel_labels_np(seg, firsts, 12, labels)
    np.testing.assert_array_equal(
        heat, jaggregate.summed_superpixel_labels_np(seg, firsts, 12, labels))
    np.testing.assert_array_equal(aggregate.normalize_to_uint8_np(heat),
                                  jaggregate.normalize_to_uint8_np(heat))
    flat = np.full((5, 5), 3.0, np.float32)  # constant map: no division by zero
    np.testing.assert_array_equal(aggregate.normalize_to_uint8_np(flat),
                                  jaggregate.normalize_to_uint8_np(flat))


def test_box_metrics_match_jax_and_golden(rng):
    gray = np.zeros((40, 40), np.uint8)
    gray[2:9, 3:20] = 200
    gray[15:35, 10:30] = 250
    gray[30:38, 34:39] = 181  # a third, smaller component
    for ref_compat in (False, True):
        np.testing.assert_array_equal(
            metrics.generate_boundingbox(gray, 180, ref_compat=ref_compat),
            jmetrics.generate_boundingbox(gray, 180, ref_compat=ref_compat))
    np.testing.assert_array_equal(metrics.largest_component_bbox(gray > 255),
                                  jmetrics.largest_component_bbox(gray > 255))
    golden = np.load(os.path.join(FIXTURE, "golden.npz"))
    with open(os.path.join(FIXTURE, "golden_meta.json")) as f:
        meta = json.load(f)
    p = np.asarray(meta["pred_box_xywh"], np.float32)
    for i in range(3):
        g = golden[f"bbox{i}"]
        a = np.array([p[0], p[1], p[0] + p[2], p[1] + p[3]])
        b = np.array([g[0], g[1], g[0] + g[2], g[1] + g[3]])
        assert metrics.iou_ref_compat(a, b) == jmetrics.iou_ref_compat(a, b)
        np.testing.assert_allclose(metrics.iou_ref_compat(a, b), meta[f"iou{i}"], atol=1e-5)
