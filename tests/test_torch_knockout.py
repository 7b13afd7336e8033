"""Knockout masks, the device-side aggregate and metric functions, the
engine's knockout, multi-image and mask-bank paths, ``knockout_saliency``
and ``minimal_mask_search``: port vs JAX package, f32 on the CPU.

Masks, ids, heatmaps, levels, boxes and counts are compared exactly. The
engine paths run both packages on a reduced ResNet-50 (stage_sizes
(1, 2, 1, 2), the fixture's images at 64^2, random BatchNorm statistics,
as in tests/test_torch_slice.py). Survive labels and preds are compared
exactly, which is meaningful only where no masked image's top-2 logit gap is
within the logit tolerance (5e-4 * max|logit|): every engine test asserts
that gap on its own batch. Probabilities agree within 1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_interpretation_imagenet_tpu import models as jmodels
from network_interpretation_imagenet_tpu.models.resnet_imagenet import Bottleneck
from network_interpretation_imagenet_tpu.models.resnet_imagenet import ResNet as JaxResNet
from network_interpretation_imagenet_tpu.ops import aggregate as jaggregate
from network_interpretation_imagenet_tpu.ops import masking as jmasking
from network_interpretation_imagenet_tpu.ops import metrics as jmetrics
from network_interpretation_imagenet_tpu.saliency import pipeline as jpipeline
from network_interpretation_imagenet_tpu.saliency.engine import SaliencyEngine as JaxEngine
from network_interpretation_imagenet_tpu_torch.config import SegmentConfig
from network_interpretation_imagenet_tpu_torch.data.imagenet_loc import ImagenetLocalizationDataset
from network_interpretation_imagenet_tpu_torch.models import ModelBundle, ResNet
from network_interpretation_imagenet_tpu_torch.ops import aggregate, masking, metrics
from network_interpretation_imagenet_tpu_torch.ops.preprocess import to_display_uint8
from network_interpretation_imagenet_tpu_torch.saliency import pipeline
from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
from network_interpretation_imagenet_tpu_torch.segment.common import segment_image
from network_interpretation_imagenet_tpu_torch.utils.convert import resnet_from_jax
from torch_port_util import randomize_bn

STAGES = (1, 2, 1, 2)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "imagenet_loc")
PROB_TOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def _segments(rng, h=12, w=10, s=9):
    """A contiguous 0..s-1 label map with every id present."""
    seg = rng.randint(0, s, size=(h, w)).astype(np.int32)
    seg.reshape(-1)[:s] = np.arange(s)
    return seg


# --- masks and ids ---------------------------------------------------------


@pytest.mark.parametrize("m", [1, 3])
def test_knockout_masks_match_jax(m):
    rng = np.random.RandomState(m)
    seg = _segments(rng)
    ids = rng.randint(-1, 9, size=(7, m)).astype(np.int32)   # -1 knocks nothing
    ids[0] = -1
    got = masking.knockout_masks(t(seg), t(ids)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmasking.knockout_masks(seg, ids)))
    assert got[0].all()
    # A [K, H, W] stack of label maps (the multi-image grid) gives mask k its own map.
    segs = np.stack([_segments(rng) for _ in range(7)])
    per_mask = masking.knockout_masks(t(segs), t(ids)).numpy()
    for k in range(7):
        np.testing.assert_array_equal(
            per_mask[k], np.asarray(jmasking.knockout_masks(segs[k], ids[k:k + 1]))[0])


def test_window_helpers_match_jax():
    rng = np.random.RandomState(0)
    seg = _segments(rng)
    np.testing.assert_array_equal(masking.single_mask_from_window(t(seg), 2, 4).numpy(),
                                  np.asarray(jmasking.single_mask_from_window(seg, 2, 4)))
    masks = rng.rand(5, 6, 7) > 0.4
    np.testing.assert_array_equal(masking.masked_fraction(t(masks)).numpy(),
                                  np.asarray(jmasking.masked_fraction(jnp.asarray(masks))))


@pytest.mark.parametrize("num, m, s", [(20, 1, 30), (15, 4, 30), (6, 5, 4), (5, 3, 1)])
def test_sample_knockout_ids_host_is_the_jax_packages(num, m, s):
    """The host sampler draws numpy's stream number for number, including
    the degenerate images (fewer eligible segments than M)."""
    for seed in (0, 7):
        np.testing.assert_array_equal(masking.sample_knockout_ids_host(seed, num, m, s),
                                      jmasking.sample_knockout_ids_host(seed, num, m, s))


@pytest.mark.parametrize("num, m, s", [(64, 1, 30), (64, 5, 30), (8, 5, 4)])
def test_sample_knockout_ids_distribution(num, m, s):
    """The device sampler has the JAX sampler's contract (its jax.random
    stream cannot be reproduced): ids in [0, S-1), distinct within a mask
    when S-1 >= M, else clamped duplicates; the same seed, the same ids."""
    ids = masking.sample_knockout_ids(torch.Generator().manual_seed(3), num, m, s)
    again = masking.sample_knockout_ids(torch.Generator().manual_seed(3), num, m, s)
    jids = np.asarray(jmasking.sample_knockout_ids(jax.random.PRNGKey(3), num, m,
                                                   jnp.int32(s)))
    assert ids.dtype == torch.int32 and ids.shape == jids.shape == (num, m)
    assert torch.equal(ids, again)
    hi = max(s - 1, 1)
    for got in (ids.numpy(), jids):
        assert got.min() >= 0 and got.max() < hi
        distinct = [len(set(row)) for row in got.tolist()]
        assert distinct == [min(m, hi)] * num
    if m == 1:
        assert len(set(ids.reshape(-1).tolist())) > hi // 2   # spread over the range


# --- device-side aggregate and metric functions ----------------------------


def test_aggregate_functions_match_jax():
    rng = np.random.RandomState(1)
    seg = _segments(rng)
    masks = rng.rand(6, 12, 10) > 0.5
    labels = (rng.rand(6) > 0.4).astype(np.float32)
    np.testing.assert_array_equal(
        aggregate.summed_label_heatmap(t(masks), t(labels)).numpy(),
        np.asarray(jaggregate.summed_label_heatmap(jnp.asarray(masks), jnp.asarray(labels))))
    firsts = rng.randint(0, 8, size=6).astype(np.int32)
    for s_cap in (9, 16):
        np.testing.assert_array_equal(
            aggregate.summed_superpixel_labels(t(seg), t(firsts), 3, t(labels), s_cap).numpy(),
            np.asarray(jaggregate.summed_superpixel_labels(jnp.asarray(seg), jnp.asarray(firsts),
                                                           jnp.int32(3), jnp.asarray(labels),
                                                           s_cap)))
    for lib in (aggregate, jaggregate):
        with pytest.raises(ValueError, match="s_cap"):
            lib.summed_superpixel_labels(jnp.asarray(seg) if lib is jaggregate else t(seg),
                                         jnp.asarray(firsts) if lib is jaggregate else t(firsts),
                                         3, jnp.asarray(labels) if lib is jaggregate else t(labels),
                                         s_cap=8)
    ids = rng.randint(-1, 9, size=(6, 3)).astype(np.int32)
    ids[1] = [4, 4, 2]   # a duplicate counts once
    np.testing.assert_array_equal(aggregate.summed_knockout_labels_np(seg, ids, labels),
                                  jaggregate.summed_knockout_labels_np(seg, ids, labels))
    np.testing.assert_array_equal(   # and equals the heatmap of the materialized bank
        aggregate.summed_knockout_labels_np(seg, ids, labels),
        aggregate.summed_label_heatmap(masking.knockout_masks(t(seg), t(ids)), t(labels)).numpy())

    heat = (rng.rand(3, 8, 9) * 40 - 7).astype(np.float32)
    heat[2] = 5.0   # a flat image
    np.testing.assert_array_equal(aggregate.normalize_to_uint8(t(heat[0])).numpy(),
                                  np.asarray(jaggregate.normalize_to_uint8(jnp.asarray(heat[0]))))
    np.testing.assert_array_equal(
        aggregate.normalize_to_uint8_batch(t(heat)).numpy(),
        np.asarray(jaggregate.normalize_to_uint8_batch(jnp.asarray(heat))))
    np.testing.assert_array_equal(aggregate.normalize_to_uint8_np(heat[1]),
                                  jaggregate.normalize_to_uint8_np(heat[1]))

    counts = rng.randint(0, 7, size=(9, 8)).astype(np.float32)
    for k_max in (7, 12):
        levels, n = aggregate.distinct_sorted_levels(t(counts), k_max)
        jlevels, jn = jaggregate.distinct_sorted_levels(jnp.asarray(counts), k_max)
        np.testing.assert_array_equal(levels.numpy(), np.asarray(jlevels))
        assert int(n) == int(jn) == len(np.unique(counts))
    np.testing.assert_array_equal(aggregate.threshold_mask(t(counts), 3.0).numpy(),
                                  np.asarray(jaggregate.threshold_mask(jnp.asarray(counts), 3.0)))


def test_metric_functions_match_jax():
    rng = np.random.RandomState(2)
    for mask in (rng.rand(9, 11) > 0.8, np.zeros((9, 11), bool)):   # blobs, and empty
        np.testing.assert_array_equal(metrics.bbox_from_mask(t(mask)).numpy(),
                                      np.asarray(jmetrics.bbox_from_mask(jnp.asarray(mask))))
    one = np.zeros((9, 11), bool)
    one[4, 7] = True
    np.testing.assert_array_equal(metrics.bbox_from_mask(t(one)).numpy(), [7, 4, 1, 1])
    boxes = [(3, 4, 10, 7), (5, 2, 6, 9), (20, 20, 3, 3), (0, 0, 2, 2)]
    for a in boxes:
        np.testing.assert_array_equal(metrics.xywh_to_corners(t(a)).numpy(),
                                      np.asarray(jmetrics.xywh_to_corners(jnp.asarray(a))))
        for b in boxes:   # overlapping, nested and disjoint pairs
            ca = np.array(jmetrics.xywh_to_corners(a))
            cb = np.array(jmetrics.xywh_to_corners(b))
            assert float(metrics.iou(ca, cb)) == float(jmetrics.iou(ca, cb))
            np.testing.assert_array_equal(metrics.bbox_intersection(a, b).numpy(),
                                          np.asarray(jmetrics.bbox_intersection(a, b)))
    logits = np.round(rng.randn(12, 8), 1).astype(np.float32)
    logits[:, 5] = logits[:, 2]   # ties: the lower index ranks first
    labels = rng.randint(0, 8, size=12).astype(np.int32)
    labels[:4] = 5
    got = metrics.topk_correct(t(logits), t(labels), (1, 2, 5))
    want = jmetrics.topk_correct(jnp.asarray(logits), jnp.asarray(labels), (1, 2, 5))
    assert [int(g) for g in got] == [int(w) for w in want]


# --- engine paths ----------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    ds = ImagenetLocalizationDataset(FIXTURE, crop=64)
    images = np.stack([ds[i][0] for i in range(3)])
    segs = np.stack([segment_image(to_display_uint8(t(im)).numpy(), SegmentConfig())
                     for im in images]).astype(np.int32)
    module = JaxResNet(stage_sizes=STAGES, block=Bottleneck, num_classes=10)
    variables = jax.tree.map(np.array, module.init(jax.random.PRNGKey(1),
                                                   jnp.zeros((1, 64, 64, 3))))
    randomize_bn(variables["params"], variables["batch_stats"], np.random.RandomState(5))
    jengine = JaxEngine(jmodels.ModelBundle("r", module, 64, 3, 10), variables,
                        mask_batch=16, compute_dtype=jnp.float32)
    bundle = ModelBundle("r", ResNet(STAGES, num_classes=10), 64, 3, 10)
    engine = SaliencyEngine(bundle, resnet_from_jax(variables), mask_batch=16,
                            compute_dtype=torch.float32, device="cpu")
    targets = [engine.predict_one(im)[0] for im in images]
    return images, segs, targets, jengine, engine


def assert_no_near_tie(engine, batch):
    """No image of the f32 batch [B, H, W, C] sits within the logit
    tolerance of an argmax tie, so exact label comparison is meaningful."""
    with torch.inference_mode():
        logits = engine.model(t(batch).float())
    top2 = torch.topk(logits, 2).values
    gap = (top2[:, 0] - top2[:, 1]).min().item()
    assert gap > 5e-4 * logits.abs().max().item(), gap


def assert_same_outcomes(got, want, vary=True):
    np.testing.assert_array_equal(got.survived, want.survived)
    np.testing.assert_array_equal(got.preds, want.preds)
    np.testing.assert_allclose(got.prob_target, want.prob_target, rtol=0, atol=PROB_TOL)
    np.testing.assert_allclose(got.prob_max, want.prob_max, rtol=0, atol=PROB_TOL)
    if vary:
        assert 0 < got.survived.sum() < len(got.survived), "all masks alike: a weak test"


@pytest.mark.parametrize("m", [1, 3])
def test_eval_knockout_masks_matches_jax(engines, m):
    images, segs, targets, jengine, engine = engines
    s = int(segs[1].max()) + 1
    ids = masking.sample_knockout_ids_host(m, 37, m, s)   # 37 = 2 chunks + a remainder
    ids[5, -1] = -1
    got = engine.eval_knockout_masks(images[1], segs[1], ids, targets[1])
    want = jengine.eval_knockout_masks(images[1], segs[1], ids, targets[1])
    assert_no_near_tie(engine, masking.apply_masks(t(images[1]),
                                                   masking.knockout_masks(t(segs[1]), t(ids))))
    assert_same_outcomes(got, want)


def test_eval_knockout_masks_multi_matches_jax_and_per_image(engines):
    """N=3 images (the JAX package pads the image axis to 4; the port does
    not), K=11 each, so chunks of 16 straddle images."""
    images, segs, targets, jengine, engine = engines
    k, m = 11, 2
    ids = np.stack([masking.sample_knockout_ids_host(10 + i, k, m, int(segs[i].max()) + 1)
                    for i in range(3)])
    got = engine.eval_knockout_masks_multi(images, segs, ids, targets)
    want = jengine.eval_knockout_masks_multi(images, segs, ids, np.asarray(targets))
    assert len(got) == len(want) == 3
    for i in range(3):
        assert len(got[i].survived) == k
        assert_no_near_tie(engine, masking.apply_masks(
            t(images[i]), masking.knockout_masks(t(segs[i]), t(ids[i]))))
        assert_same_outcomes(got[i], want[i], vary=False)
        single = engine.eval_knockout_masks(images[i], segs[i], ids[i], targets[i])
        np.testing.assert_array_equal(got[i].survived, single.survived)
        np.testing.assert_allclose(got[i].prob_target, single.prob_target, rtol=0, atol=PROB_TOL)
    assert 0 < sum(g.survived.sum() for g in got) < 3 * k


def test_eval_window_masks_multi_matches_jax_and_per_image(engines):
    """The multi window grid builds each chunk by B1 (its plain version
    here), one call per image run of the chunk, each with its own width.
    Targets may also be a device tensor (the argmax of a batched predict)."""
    images, segs, targets, jengine, engine = engines
    k = 13
    widths = np.array([int(0.4 * (int(g.max()) + 1)) for g in segs], np.int32)
    firsts = np.stack([masking.sample_window_starts_host(20 + i, k, int(segs[i].max()) + 1,
                                                         widths[i]) for i in range(3)])
    target_t = engine.predict_logits_device(images).argmax(dim=1)
    assert target_t.tolist() == targets
    got = engine.eval_window_masks_multi(images, segs, firsts, widths, target_t)
    want = jengine.eval_window_masks_multi(images, segs, firsts, widths, np.asarray(targets))
    for i in range(3):
        assert_no_near_tie(engine, masking.apply_masks(
            t(images[i]), masking.window_masks(t(segs[i]), t(firsts[i]), int(widths[i]))))
        assert_same_outcomes(got[i], want[i], vary=False)
        single = engine.eval_window_masks(images[i], segs[i], firsts[i], int(widths[i]),
                                          targets[i])
        np.testing.assert_array_equal(got[i].survived, single.survived)
        np.testing.assert_array_equal(got[i].preds, single.preds)
    assert 0 < sum(g.survived.sum() for g in got) < 3 * k


def test_eval_mask_bank_matches_jax(engines):
    images, segs, targets, jengine, engine = engines
    rng = np.random.RandomState(4)
    masks = rng.rand(21, 64, 64) > 0.35
    got = engine.eval_mask_bank(images[1], masks, targets[1])
    want = jengine.eval_mask_bank(images[1], masks, targets[1])
    assert_no_near_tie(engine, masking.apply_masks(t(images[1]), t(masks)))
    assert_same_outcomes(got, want)


@pytest.mark.parametrize("m", [1, 2])
def test_knockout_saliency_matches_jax(engines, monkeypatch, m):
    """Fed the JAX package's jax.random ids, the port gives the same ids,
    outcomes, masks and heatmap."""
    images, segs, targets, jengine, engine = engines
    s = int(segs[1].max()) + 1
    jids = np.asarray(jmasking.sample_knockout_ids(jax.random.PRNGKey(6), 30, m, jnp.int32(s),
                                                   max_s=4096))
    monkeypatch.setattr(masking, "sample_knockout_ids",
                        lambda gen, num, mm, ss: t(jids) if (num, mm, ss) == (30, m, s) else None)
    got = pipeline.knockout_saliency(engine, images[1], segs[1], 30, num_knockout=m, seed=6)
    want = jpipeline.knockout_saliency(jengine, images[1], segs[1], 30, num_knockout=m, seed=6)
    np.testing.assert_array_equal(got.knock_ids, want.knock_ids)
    assert got.num_segments == want.num_segments == s
    assert_no_near_tie(engine, masking.apply_masks(t(images[1]), t(got.masks)))
    assert_same_outcomes(got.eval, want.eval)
    np.testing.assert_array_equal(got.masks, want.masks)
    np.testing.assert_array_equal(got.heatmap, want.heatmap)
    np.testing.assert_array_equal(got.heatmap,
                                  aggregate.summed_knockout_labels_np(segs[1], jids,
                                                                      got.eval.survived))


def test_knockout_saliency_draws_its_own_ids(engines):
    images, segs, targets, _, engine = engines
    s = int(segs[0].max()) + 1
    a = pipeline.knockout_saliency(engine, images[0], segs[0], 12, num_knockout=2, seed=1,
                                   target=targets[0])
    b = pipeline.knockout_saliency(engine, images[0], segs[0], 12, num_knockout=2, seed=1,
                                   target=targets[0])
    np.testing.assert_array_equal(a.knock_ids, b.knock_ids)
    np.testing.assert_array_equal(a.heatmap, b.heatmap)
    assert a.knock_ids.shape == (12, 2) and a.knock_ids.max() < s - 1
    assert a.masks.shape == (12, 64, 64) and a.masks.dtype == bool


@pytest.mark.parametrize("max_levels", [None, 5])
def test_minimal_mask_search_matches_jax(engines, max_levels):
    """The threshold, the keep flag of every level and the levels equal the
    JAX package's: the same np.unique and linspace pick, the same batched
    bank forward, the same binary search replayed on its flags."""
    images, segs, targets, jengine, engine = engines
    s = int(segs[1].max()) + 1
    width = int(0.4 * s)
    firsts = masking.sample_window_starts_host(8, 40, s, width)
    res = engine.eval_window_masks(images[1], segs[1], firsts, width, targets[1])
    heat = aggregate.summed_superpixel_labels_np(segs[1], firsts, width, res.survived)
    thr, keep, levels = pipeline.minimal_mask_search(engine, images[1], heat, targets[1],
                                                     max_levels=max_levels)
    jthr, jkeep, jlevels = jpipeline.minimal_mask_search(jengine, images[1], heat, targets[1],
                                                         max_levels=max_levels)
    assert_no_near_tie(engine, masking.apply_masks(t(images[1]),
                                                   t(heat[None] >= levels[:, None, None])))
    np.testing.assert_array_equal(levels, jlevels)
    np.testing.assert_array_equal(keep, jkeep)
    assert thr == jthr
    assert len(levels) == (max_levels or len(np.unique(heat)))
    assert keep.any() and not keep.all(), "every level alike: a weak test"
