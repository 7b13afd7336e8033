"""XRAI, the Felzenszwalb ladder, the learned mask and the sanity checks:
port vs JAX package, f32 on the CPU.

The models are test_torch_attribution's (reduced ResNets sharing weights
with the JAX package, the fixture's images at 64^2). Tolerances: the signed
XRAI attribution and the learned mask's heatmap within 1e-4 x max |JAX
map| (MAP_TOL), its probabilities and loss within 1e-5; exact: the ladder's
labels, the greedy ranking and the XRAI region order on the fixture's
images, spearman_abs to 1e-12, the randomization stages and the spliced
state dicts. The learned mask's shifts are the JAX package's jax.random
draws, handed in."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_interpretation_imagenet_tpu.saliency import learned_mask as jlm
from network_interpretation_imagenet_tpu.saliency import sanity as jsanity
from network_interpretation_imagenet_tpu.saliency import xrai as jxrai
from network_interpretation_imagenet_tpu_torch.data.imagenet_loc import ImagenetLocalizationDataset
from network_interpretation_imagenet_tpu_torch.ops.preprocess import to_display_uint8
from network_interpretation_imagenet_tpu_torch.saliency import learned_mask as lm
from network_interpretation_imagenet_tpu_torch.saliency import sanity, xrai
from network_interpretation_imagenet_tpu_torch.segment import felzenszwalb as felz
from network_interpretation_imagenet_tpu_torch.utils.convert import resnet_from_jax
from test_torch_attribution import _models, _target, assert_map_close
from torch_port_util import flax_resnet_variables

jfelz = importlib.import_module("network_interpretation_imagenet_tpu.segment.felzenszwalb")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "imagenet_loc")
PROB_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: under pytest-xdist every worker's
    own pool of one thread per core oversubscribes the host, and these small
    shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture_images():
    """The fixture's three images at 64^2: (normalized f32, display uint8)."""
    ds = ImagenetLocalizationDataset(FIXTURE, crop=64)
    imgs = [ds[i][0] for i in range(3)]
    return imgs, [to_display_uint8(torch.from_numpy(im)).numpy() for im in imgs]


@pytest.fixture(scope="module")
def bottleneck():
    return _models("bottleneck")


# --- Felzenszwalb ladder and the greedy ranking -----------------------------------


def test_felzenszwalb_ladder_matches_jax(fixture_images):
    """Labels equal the JAX package's, native and numpy, and each scale
    equals the single-scale segmenter's."""
    _, disps = fixture_images
    scales = xrai.adaptive_scales(64, 64)
    assert scales == jxrai.adaptive_scales(64, 64)
    assert xrai.adaptive_scales(224, 224) == xrai.DEFAULT_SCALES
    for disp in disps:
        got = felz.felzenszwalb_ladder(disp, scales)
        want = jfelz.felzenszwalb_ladder(disp, scales)
        plain = felz.felzenszwalb_ladder(disp, scales, backend="numpy")
        assert len(got) == len(want) == 5
        for a, b, c, s in zip(got, want, plain, scales):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(
                a, felz.felzenszwalb(disp, s, 0.5, max(int(round(s / 10.0)), 5)))
        assert len(np.unique(got[0])) > len(np.unique(got[-1])) >= 1
    assert felz.felzenszwalb_ladder(disps[0], []) == []
    with pytest.raises(ValueError):
        felz.felzenszwalb_ladder(disps[0], [1.0, 2.0], min_sizes=[5])


def test_label_components_and_postpass_match_jax():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 4, size=(17, 13)).astype(np.int32)
    comp, n = felz.label_components(labels)
    jcomp, jn = jfelz.label_components(labels)
    np.testing.assert_array_equal(comp, jcomp)
    assert n == jn > 4
    for frac in (0.25, 0.6):
        np.testing.assert_array_equal(felz.slic_postpass_native(labels, frac),
                                      jfelz.slic_postpass_native(labels, frac))


@pytest.mark.parametrize("min_area", [1, 4, 30])
def test_greedy_region_ranking_matches_jax(fixture_images, min_area):
    _, disps = fixture_images
    ladder = felz.felzenszwalb_ladder(disps[0], xrai.adaptive_scales(64, 64))
    attr = np.random.RandomState(min_area).randn(64, 64).astype(np.float32)
    want, wn = jxrai.greedy_region_ranking(attr, ladder, min_area=min_area)
    for backend in ("native", "numpy"):
        got, n = xrai.greedy_region_ranking(attr, ladder, min_area=min_area, backend=backend)
        np.testing.assert_array_equal(got, want)
        assert n == wn > 1
    with pytest.raises(ValueError):
        xrai.greedy_region_ranking(attr, [ladder[0][:3]])


# --- XRAI ------------------------------------------------------------------------


def test_xrai_attribution_matches_jax(bottleneck, fixture_images):
    bundle, sd, jbundle, v = bottleneck
    imgs, _ = fixture_images
    t = _target(bundle, sd, imgs[0])
    want = jxrai.xrai_attribution(jbundle.logits, v, imgs[0], t, steps=4)
    got = xrai.xrai_attribution(bundle.logits, sd, imgs[0], t, steps=4)
    assert_map_close(got, want)
    assert (np.asarray(want) < 0).any() and (np.asarray(want) > 0).any(), "signed"
    assert_map_close(xrai.xrai_attribution(bundle.logits, sd, imgs[0], t, steps=4, step_batch=2),
                     want)
    base = [np.zeros_like(imgs[0]), np.full_like(imgs[0], 0.5)]
    assert_map_close(xrai.xrai_attribution(bundle.logits, sd, imgs[0], t, steps=2, baselines=base),
                     jxrai.xrai_attribution(jbundle.logits, v, imgs[0], t, steps=2,
                                            baselines=[jnp.asarray(b) for b in base]))
    targets = [_target(bundle, sd, im) for im in imgs]
    got_b = xrai.xrai_attribution_batch(bundle.logits, sd, np.stack(imgs), targets, steps=2,
                                        step_batch=1)
    want_b = jxrai.xrai_attribution_batch(jbundle.logits, v, np.stack(imgs), targets, steps=2)
    for i in range(3):
        assert_map_close(got_b[i], want_b[i])


def test_xrai_saliency_region_order_matches_jax(bottleneck, fixture_images):
    """End to end on the fixture's images: the same regions in the same
    order (the rank heatmaps equal exactly)."""
    bundle, sd, jbundle, v = bottleneck
    imgs, disps = fixture_images
    for img, disp in zip(imgs, disps):
        t = _target(bundle, sd, img)
        got = xrai.xrai_saliency(bundle.logits, sd, img, t, disp, steps=4)
        want = jxrai.xrai_saliency(jbundle.logits, v, img, t, disp, steps=4)
        assert got.num_regions == want.num_regions > 2
        np.testing.assert_array_equal(got.heatmap, want.heatmap)
        assert_map_close(got.attribution, want.attribution)


# --- learned mask ------------------------------------------------------------------


def jax_shifts(seed, iters, jitter, max_shift):
    """The learned mask's jax.random shifts (one key split per step)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(iters):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (jitter, 2), -max_shift, max_shift + 1)))
    return torch.from_numpy(np.stack(out).astype(np.int64))


def test_gaussian_blur_matches_jax(fixture_images):
    imgs, _ = fixture_images
    for sigma in (0.6, 3.0, 10.0):
        np.testing.assert_allclose(lm.gaussian_blur(torch.from_numpy(imgs[1]), sigma).numpy(),
                                   np.asarray(jlm.gaussian_blur(imgs[1], sigma)),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("baseline, jitter, iters", [("blur", 2, 4), ("blur", 0, 4),
                                                     ("zero", 2, 1)])
def test_learned_mask_matches_jax(bottleneck, fixture_images, monkeypatch, baseline, jitter,
                                  iters):
    """Adam steps on a 7x7 mask with the JAX package's shifts: heatmap,
    low-res mask, probabilities and loss. The zero baseline is held at one
    step: on these weights its second iterate's masked image sits where the
    network's f32 input gradient is ill-conditioned (on image 2 the port's
    strays 14% of its scale from a float64 gradient and the JAX package's
    18%), so later steps part by rounding, not by a port fault."""
    bundle, sd, jbundle, v = bottleneck
    imgs, _ = fixture_images
    t = _target(bundle, sd, imgs[2])
    kw = dict(mask_size=7, iters=iters, jitter=jitter, max_shift=3, baseline=baseline, seed=2)
    monkeypatch.setattr(lm, "learned_mask_shifts", jax_shifts)
    got = lm.learned_mask_saliency(bundle.logits, sd, imgs[2], t, **kw)
    want = jlm.learned_mask_saliency(jbundle.logits, v, imgs[2], t, **kw)
    assert_map_close(got.heatmap, want.heatmap)
    assert_map_close(got.mask_lowres, want.mask_lowres)
    assert np.ptp(want.mask_lowres) > 1e-4 or iters == 1, "an unchanged mask: a weak test"
    for name in ("prob_original", "prob_masked", "final_loss"):
        assert abs(getattr(got, name) - getattr(want, name)) <= PROB_TOL, name
    # The batch entry gives each image the single call's result.
    batch = lm.learned_mask_saliency_batch(bundle.logits, sd, np.stack(imgs[1:]),
                                           [_target(bundle, sd, im) for im in imgs[1:]],
                                           seeds=[5, 2], **{k: kw[k] for k in kw if k != "seed"})
    assert_map_close(batch[1].heatmap, got.heatmap)
    with pytest.raises(ValueError):
        lm.learned_mask_saliency(bundle.logits, sd, imgs[2], t, baseline="noise")


# --- sanity checks -------------------------------------------------------------------


def test_spearman_abs_matches_jax():
    rng = np.random.RandomState(3)
    a = rng.randn(20, 20)
    for b in (a + 0.3 * rng.randn(20, 20), -a, np.round(rng.randn(20, 20), 1), np.zeros((20, 20))):
        assert abs(sanity.spearman_abs(a, b) - jsanity.spearman_abs(a, b)) <= 1e-12
    assert sanity.spearman_abs(a, -a) == pytest.approx(1.0)
    assert sanity.spearman_abs(a, np.ones_like(a)) == 0.0
    with pytest.raises(ValueError):
        sanity.spearman_abs(a, a[:3])


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_randomization_stages_and_splicing_match_jax(block):
    """The stages are the JAX package's names in its order (output side
    first); splicing replaces a module's weights and BatchNorm statistics."""
    bundle, sd, jbundle, v = _models(block)
    stages = sanity.randomization_stages(bundle)
    assert stages == jsanity.randomization_stages(jbundle)
    assert stages[:2] == ["fc", "layer4_0"] and stages[-2:] == ["bn1", "conv1"]
    rand = sanity.fresh_random_variables(bundle, 4)
    assert all(torch.equal(rand[k], bundle.init(4 + 7919)[k]) for k in rand)
    jrand = flax_resnet_variables(rand, (1, 1, 1, 1))
    done = ["fc", "layer4_0", "layer3_0"]
    got = sanity.randomize_modules(sd, rand, done, bundle)
    want = resnet_from_jax(jsanity.randomize_modules(v, jrand, done))
    for k, val in want.items():
        np.testing.assert_array_equal(got[k].numpy(), val.numpy(), err_msg=k)
    assert torch.equal(got["layer3.0.bn1.running_var"], rand["layer3.0.bn1.running_var"])
    assert torch.equal(got["layer2.0.conv1.weight"], sd["layer2.0.conv1.weight"])


def test_cascading_randomization_matches_jax(bottleneck, fixture_images):
    """Input-gradient maps under cumulative randomization: the same stages,
    and Spearman correlations within 1e-4 (the maps agree to 1e-6 of their
    scale; a rank swap of two near-equal pixels moves the correlation by
    about 1/(H W)^2)."""
    from network_interpretation_imagenet_tpu.saliency import gradient as jg
    from network_interpretation_imagenet_tpu_torch.saliency import gradient as g

    bundle, sd, jbundle, v = bottleneck
    imgs, _ = fixture_images
    t = _target(bundle, sd, imgs[0])
    rand = sanity.fresh_random_variables(bundle, 0)
    got = sanity.cascading_randomization(
        lambda w: g.input_gradient(bundle.logits, w, imgs[0], t), bundle, sd,
        random_variables=rand)
    want = jsanity.cascading_randomization(
        lambda w: jg.input_gradient(jbundle.logits, w, imgs[0], t), jbundle, v,
        random_variables=flax_resnet_variables(rand, (1, 1, 1, 1)))
    assert [s for s, _ in got["stages"]] == [s for s, _ in want["stages"]]
    for (_, a), (_, b) in zip(got["stages"], want["stages"]):
        assert abs(a - b) <= 1e-4
    assert got["stages"][-1][1] < 0.9
