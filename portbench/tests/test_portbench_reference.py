"""The plain reference against the port's CPU path at small sizes, so that
the comparison code runs here. The port is imported by these tests only."""

import hashlib

import numpy as np
import pytest
import torch

from portbench import reference as ref
from portbench.spec import ROOT, load_json, net
from portbench.traffic import make_pool

TINY = {"name": "tiny", "arch": "resnet50", "stage_sizes": [3, 4, 6, 3], "base_width": 64,
        "num_classes": 10, "resolution": 64, "init": {"residual_scale": 0.2, "head_gain": 8.0}}
RESNET = net(TINY)


@pytest.fixture(scope="module")
def pool():
    return make_pool(6, 64, 11, "cpu")


@pytest.fixture(scope="module")
def state(pool):
    s = ref.make_weights(RESNET, TINY, 5, "cpu")
    ref.calibrate(RESNET, TINY, s, torch.from_numpy(pool[0][:4]))
    return s


def test_pool_is_the_seeds(pool):
    again = make_pool(6, 64, 11, "cpu")
    assert np.array_equal(pool[0], again[0]) and np.array_equal(pool[1], again[1])
    other = make_pool(6, 64, 12, "cpu")
    assert not np.array_equal(pool[0], other[0])
    x, y, w, h = pool[1].T
    assert (x >= 0).all() and (x + w <= 64).all() and (y + h <= 64).all() and (w > 0).all()


def test_weights_are_the_seeds():
    a, b = ref.make_weights(RESNET, TINY, 5, "cpu"), ref.make_weights(RESNET, TINY, 5, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = ref.make_weights(RESNET, TINY, 6, "cpu")
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])


# The two configs' full-size weights from seed 2**31 + 5, as they read before
# the family moved to ``portbench/nets/bottleneck_resnet.py``: the count and
# order of the keys (sha256 of the keys joined by newlines), every tensor's
# bytes in that order (sha256), and the f64 sum and sum of squares of all.
WEIGHTS = {
    "resnet101-224-bf16": (
        522, "9c722028624e2922940a109e573135c314b643bf4cdde0ca81dfdf59253ad579",
        "50a0e16444564bbad29ba36b0dfef489177d1bce57600341542cddae4f0de043",
        78978.04713641669, 1778698.9946529712),
    "wide_resnet50_2-224-bf16": (
        267, "ec98463d02daea9e8194bb4c42abcb7668efbb6329f6a17b8d67ae8085bd11c2",
        "7c93488fba72173b0e817f92574f7a37f5092d2aa717617d7fed4de14847dd34",
        56824.17523614549, 1718466.7545709275),
}


@pytest.mark.parametrize("config", sorted(WEIGHTS))
def test_full_size_weights_are_pinned(config):
    cfg = load_json(f"{ROOT}/portbench/configs/{config}.json")
    state = ref.make_weights(net(cfg), cfg, 2 ** 31 + 5, "cpu")
    count, keys, data, total, squares = WEIGHTS[config]
    assert len(state) == count
    assert hashlib.sha256("\n".join(state).encode()).hexdigest() == keys
    h, s, sq = hashlib.sha256(), 0.0, 0.0
    for t in state.values():
        a = t.numpy()
        h.update(a.tobytes())
        s += float(a.astype(np.float64).sum())
        sq += float((a.astype(np.float64) ** 2).sum())
    assert h.hexdigest() == data
    assert s == pytest.approx(total, rel=1e-12) and sq == pytest.approx(squares, rel=1e-12)


def test_plain_net_matches_the_port_in_f32(pool, state):
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine

    bundle = create_model("resnet50", "imagenet", num_classes=10)
    engine = SaliencyEngine(bundle, state, mask_batch=4, compute_dtype=torch.float32, device="cpu")
    images = pool[0][4:6]
    got = engine.predict_logits_device(images)
    want = RESNET.Plain(TINY, state)(torch.from_numpy(images))
    assert float((got - want).abs().max()) < 1e-3 * float(want.abs().max())
    fp8 = RESNET.Plain(TINY, state, quantize="fp8")(torch.from_numpy(images))
    assert float((fp8 - want).abs().max()) > 1e-2 * float(want.abs().max())


def test_felzenszwalb_matches_the_port(pool):
    from network_interpretation_imagenet_tpu_torch.ops.aggregate import normalize_to_uint8_np
    from network_interpretation_imagenet_tpu_torch.segment.felzenszwalb import felzenszwalb

    for image in pool[0][:3]:
        disp = ref.normalize_to_uint8(image)
        assert np.array_equal(disp, normalize_to_uint8_np(image))
        scale = ref.segment_scale(64, 64, None)
        assert np.array_equal(ref.felzenszwalb(disp, scale, 0.5, 20),
                              felzenszwalb(disp, scale=scale, sigma=0.5, min_size=20))


def test_starts_heatmap_and_iou_match_the_port(pool):
    from network_interpretation_imagenet_tpu_torch.ops.aggregate import summed_superpixel_labels_np
    from network_interpretation_imagenet_tpu_torch.ops.masking import sample_window_starts_host
    from network_interpretation_imagenet_tpu_torch.saliency.pipeline import localization_score

    disp = ref.normalize_to_uint8(pool[0][0])
    seg = ref.felzenszwalb(disp, ref.segment_scale(64, 64, None), 0.5, 20)
    s = int(seg.max()) + 1
    width = int(0.4 * s)
    firsts = ref.window_starts(2 ** 31 + 3, 50, s, width)
    assert np.array_equal(firsts, sample_window_starts_host(2 ** 31 + 3, 50, s, width))
    survived = np.random.RandomState(0).rand(50) < 0.6
    heat = ref.summed_heatmap(seg, firsts, width, survived)
    assert np.array_equal(heat, summed_superpixel_labels_np(seg, firsts, width, survived))
    gt = tuple(int(v) for v in pool[1][0])
    assert ref.localization_iou(heat, gt, 180) == localization_score(heat, gt, 180)[0]


def test_masked_images_match_the_ports_b1_plain(pool):
    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import masked_batch_plain

    image = torch.from_numpy(pool[0][0])
    seg = torch.from_numpy(ref.felzenszwalb(ref.normalize_to_uint8(pool[0][0]), 1.0, 0.5, 20))
    firsts = torch.tensor([1, 2, 3], dtype=torch.int32)
    want = masked_batch_plain(image, seg, firsts, 2, torch.float32)
    assert torch.equal(ref.masked_images(image, seg, firsts, 2), want)


def test_the_bo_loops_choices_are_gp_ei_choices():
    """The stage a BO cell's check follows rather than repeats: each start
    the port's fused loop takes after its pre-samples is the float64 GP-EI
    choice given its observations before it (ties within 1e-3 of the best
    EI, lengthscales within 0.5 nats of the best marginal likelihood), or
    the draw where that choice was already observed. The CPU's f32 agrees
    at these sizes; on the card near-singular lengthscales move about one
    step in 2,600."""
    from network_interpretation_imagenet_tpu_torch.config import BOConfig, SegmentConfig
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.saliency.bo_pipeline import bo_window_saliency
    from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
    from network_interpretation_imagenet_tpu_torch.segment.common import segment_image

    cfg = dict(TINY, resolution=112)
    images, _ = make_pool(10, 112, 5, "cpu")
    state = ref.make_weights(RESNET, cfg, 3, "cpu")
    ref.calibrate(RESNET, cfg, state, torch.from_numpy(images[:6]))
    engine = SaliencyEngine(create_model("resnet50", "imagenet", num_classes=10), state,
                            mask_batch=16, compute_dtype=torch.bfloat16, device="cpu")
    bo = BOConfig()
    steps = 0
    for i in range(6, 10):
        seg = segment_image(ref.normalize_to_uint8(images[i]), SegmentConfig(min_size=20))
        target, _ = engine.predict_one(images[i])
        _, tr = bo_window_saliency(engine, images[i], seg, bo, seed=1000 + i, target=target)
        upper = int(0.6 * (int(seg.max()) + 1))
        draws = ref.bo_draws(1000 + i, upper, bo.n_pre_samples + bo.n_iters)
        assert np.array_equal(tr.xp[:bo.n_pre_samples], draws[:bo.n_pre_samples])
        for t in range(bo.n_pre_samples, len(tr.xp)):
            steps += 1
            assert ref.ei_choice_ok(tr.xp[:t], tr.yp[:t], float(tr.xp[t]), float(draws[t]), upper,
                                    bo.lengthscale_grid, bo.alpha, bo.epsilon, 0.5, 1e-3), (i, t)
    assert steps == 40
