"""The gradient, occlusion, RISE and CAM methods, the fidelity metrics and the
bilinear resize: port vs JAX package, f32 on the CPU.

Both packages run the same weights: a reduced ResNet of each block type
(stage_sizes (1, 1, 1, 1), 10 classes, random BatchNorm statistics) on the
fixture's images at 64^2, the port's seeded state dict carried to flax by
``torch_port_util.flax_resnet_variables``. The JAX package's random draws
(SmoothGrad's noise, RISE's cells and offsets) are handed to the port in
place of its ``torch.Generator`` draws.

Tolerances: every f32 map within 1e-4 x max |JAX map| (MAP_TOL); the
gradcam menu and default layer exactly; fidelity rank maps and cut counts
exactly and AUCs within 1e-5; the resize within 1e-6 of jax.image.resize.
SmoothGrad at a ReLU kink is held against float64 (GRAD64_TOL)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from network_interpretation_imagenet_tpu import models as jmodels
from network_interpretation_imagenet_tpu.models.resnet_imagenet import BasicBlock as JBasic
from network_interpretation_imagenet_tpu.models.resnet_imagenet import Bottleneck as JBottleneck
from network_interpretation_imagenet_tpu.models.resnet_imagenet import ResNet as JaxResNet
from network_interpretation_imagenet_tpu.saliency import eval_metrics as jeval
from network_interpretation_imagenet_tpu.saliency import gradient as jg
from network_interpretation_imagenet_tpu.saliency.engine import SaliencyEngine as JaxEngine
from network_interpretation_imagenet_tpu_torch.data.imagenet_loc import ImagenetLocalizationDataset
from network_interpretation_imagenet_tpu_torch.models import (
    BasicBlock,
    Bottleneck,
    ModelBundle,
    ResNet,
)
from network_interpretation_imagenet_tpu_torch.ops.resize import resize_bilinear
from network_interpretation_imagenet_tpu_torch.saliency import eval_metrics
from network_interpretation_imagenet_tpu_torch.saliency import gradient as g
from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
from torch_port_util import flax_resnet_variables, randomize_bn

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "imagenet_loc")
STAGES = (1, 1, 1, 1)
MAP_TOL = 1e-4
AUC_TOL = 1e-5
GRAD64_TOL = 1e-5   # an f32 sample gradient vs float64's: x max |gradient|


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: under pytest-xdist every worker's
    own pool of one thread per core oversubscribes the host, and these small
    shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_map_close(got, want, tol=MAP_TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0, "an all-zero map: a weak test"
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"max err {err} > {tol} x {scale}"


def jax_noise(seed, samples, shape):
    """SmoothGrad's jax.random draws, in place of the port's."""
    return torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                                         (samples, *shape))))


def jax_rise_draws(seed, chunks, batch, grid, keep_prob, cell_h, cell_w):
    """RISE's jax.random draws (one key split per chunk, then three), in the
    port's ``rise_draws`` layout."""
    key = jax.random.PRNGKey(seed)
    cells, oy, ox = [], [], []
    for _ in range(chunks):
        key, sub = jax.random.split(key)
        kg, ky, kx = jax.random.split(sub, 3)
        cells.append(jax.random.bernoulli(kg, jnp.float32(keep_prob), (batch, grid, grid)))
        oy.append(jax.random.randint(ky, (batch,), 0, cell_h))
        ox.append(jax.random.randint(kx, (batch,), 0, cell_w))
    return (torch.from_numpy(np.asarray(jnp.stack(cells), np.float32)),
            torch.from_numpy(np.asarray(jnp.stack(oy), np.int64)),
            torch.from_numpy(np.asarray(jnp.stack(ox), np.int64)))


@pytest.fixture(scope="module")
def images():
    ds = ImagenetLocalizationDataset(FIXTURE, crop=64)
    return np.stack([ds[i][0] for i in range(3)])


def _models(block):
    """(port bundle, state dict, JAX bundle, flax variables) sharing weights."""
    basic = block == "basic"
    bundle = ModelBundle("r", ResNet(STAGES, num_classes=10,
                                     block=BasicBlock if basic else Bottleneck), 64, 3, 10)
    variables = flax_resnet_variables(bundle.init(3), STAGES)
    randomize_bn(variables["params"], variables["batch_stats"], np.random.RandomState(4))
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in _state_dict(variables, bundle).items()}
    jbundle = jmodels.ModelBundle("r", JaxResNet(stage_sizes=STAGES, block=JBasic if basic
                                                 else JBottleneck, num_classes=10), 64, 3, 10)
    return bundle, sd, jbundle, variables


def _state_dict(variables, bundle):
    from network_interpretation_imagenet_tpu_torch.utils.convert import resnet_from_jax

    sd = resnet_from_jax(variables)
    for k, v in bundle.module.state_dict().items():
        sd.setdefault(k, v)   # num_batches_tracked
    return sd


@pytest.fixture(scope="module", params=["basic", "bottleneck"])
def models(request):
    return _models(request.param)


def _target(bundle, sd, image):
    return int(bundle.logits(sd, torch.from_numpy(image)[None]).argmax())


def _folded(bundle, sd):
    """(logits_fn, variables) of the masked forwards: an f32 CPU engine's
    folded plan, the path B2 takes on the card."""
    engine = SaliencyEngine(bundle, sd, compute_dtype=torch.float32, device="cpu")
    return engine.folded_logits, engine.variables


# --- resize ------------------------------------------------------------------


@pytest.mark.parametrize("src, dst", [((7, 7), (64, 64)), ((1, 1), (9, 9)), ((2, 3), (64, 64)),
                                      ((64, 64), (32, 32)), ((28, 28), (224, 224)),
                                      ((32, 48), (16, 100))])
def test_resize_matches_jax_image_resize(src, dst):
    """The port's resize is jax.image.resize(..., "bilinear") on every side,
    growing or shrinking; a 1-pixel side upsamples to an exactly constant
    row. F.interpolate(align_corners=False) agrees when every side grows,
    and when a side shrinks only with antialias=True (without it, 0.4 off
    and more on a random map)."""
    x = np.random.RandomState(0).randn(3, *src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, *dst), "bilinear"))
    got = resize_bilinear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max() * 10)
    if src == (1, 1):
        assert np.ptp(got[0]) == 0
    xt = torch.from_numpy(x)[:, None]
    plain = F.interpolate(xt, size=dst, mode="bilinear", align_corners=False)[:, 0].numpy()
    anti = F.interpolate(xt, size=dst, mode="bilinear", align_corners=False,
                         antialias=True)[:, 0].numpy()
    if dst[0] >= src[0] and dst[1] >= src[1]:
        np.testing.assert_allclose(plain, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(anti, want, rtol=0, atol=1e-5)
        assert np.abs(plain - want).max() > 0.4
    xg = torch.from_numpy(x).requires_grad_(True)
    resize_bilinear(xg, dst).sum().backward()
    assert torch.isfinite(xg.grad).all()


# --- gradient methods ----------------------------------------------------------


def test_gradient_methods_match_jax(models, images, monkeypatch):
    bundle, sd, jbundle, v = models
    img = images[0]
    t = _target(bundle, sd, img)
    assert_map_close(g.input_gradient(bundle.logits, sd, img, t),
                     jg.input_gradient(jbundle.logits, v, img, t))
    assert_map_close(g.grad_times_input(bundle.logits, sd, img, t),
                     jg.grad_times_input(jbundle.logits, v, img, t))
    want = jg.integrated_gradients(jbundle.logits, v, img, t, steps=4)
    assert_map_close(g.integrated_gradients(bundle.logits, sd, img, t, steps=4), want)
    assert_map_close(g.integrated_gradients(bundle.logits, sd, img, t, steps=4, step_batch=2),
                     want)
    base = np.full_like(img, 0.3)
    assert_map_close(g.integrated_gradients(bundle.logits, sd, img, t, steps=3, baseline=base),
                     jg.integrated_gradients(jbundle.logits, v, img, t, steps=3,
                                             baseline=jnp.asarray(base)))
    monkeypatch.setattr(g, "smoothgrad_noise", jax_noise)
    for magnitude in (False, True):
        want = jg.smoothgrad(jbundle.logits, v, img, t, samples=4, seed=5, magnitude=magnitude)
        assert_map_close(g.smoothgrad(bundle.logits, sd, img, t, samples=4, seed=5,
                                      magnitude=magnitude), want)
        assert_map_close(g.smoothgrad(bundle.logits, sd, img, t, samples=4, seed=5,
                                      magnitude=magnitude, sample_batch=2), want)
    # An explicit noise argument is the same draw.
    assert_map_close(g.smoothgrad(bundle.logits, sd, img, t, samples=4,
                                  noise=jax_noise(5, 4, img.shape)),
                     jg.smoothgrad(jbundle.logits, v, img, t, samples=4, seed=5))


def test_smoothgrad_and_rise_draws_are_seeded():
    a, b = g.smoothgrad_noise(3, 4, (5, 6, 3)), g.smoothgrad_noise(3, 4, (5, 6, 3))
    assert torch.equal(a, b) and not torch.equal(a, g.smoothgrad_noise(4, 4, (5, 6, 3)))
    assert abs(float(a.mean())) < 0.2 and 0.8 < float(a.std()) < 1.2
    cells, oy, ox = g.rise_draws(0, 2, 50, 7, 0.5, 10, 12)
    again = g.rise_draws(0, 2, 50, 7, 0.5, 10, 12)
    assert all(torch.equal(x, y) for x, y in zip((cells, oy, ox), again))
    assert cells.shape == (2, 50, 7, 7) and set(cells.unique().tolist()) == {0.0, 1.0}
    assert 0.4 < float(cells.mean()) < 0.6
    assert oy.min() >= 0 and oy.max() < 10 and ox.min() >= 0 and ox.max() < 12


# --- CAMs ----------------------------------------------------------------------


def test_gradcam_menu_and_default_layer_match_jax(models, images):
    """Same entries, order and shapes under the flax paths, and the same
    default layer, so --gradcam-layer takes the same strings in both."""
    bundle, sd, jbundle, v = models
    menu = g.gradcam_target_layers(bundle, sd, images[0])
    assert menu == jg.gradcam_target_layers(jbundle, v, images[0])
    assert g._default_gradcam_layer(menu) == jg._default_gradcam_layer(menu) == "layer4_0"
    assert g.default_gradcam_layer(bundle, sd, images[0].shape) == "layer4_0"
    assert {"layer3_0/downsample_conv", "layer2_0/conv1", "bn1"} <= {n for n, _ in menu}
    with pytest.raises(ValueError, match="unknown layer"):
        g.gradcam(bundle, sd, images[0], 0, layer="layer9_9")


@pytest.mark.parametrize("layer", [None, "layer3_0", "layer2_0/conv1", "layer4_0/downsample_bn"])
def test_gradcam_matches_jax(models, images, layer):
    bundle, sd, jbundle, v = models
    img = images[1]
    t = _target(bundle, sd, img)
    assert_map_close(g.gradcam(bundle, sd, img, t, layer=layer),
                     jg.gradcam(jbundle, v, img, t, layer=layer))


# --- mask-batched methods ------------------------------------------------------


def test_occlusion_matches_jax(models, images):
    """The adaptive default at 64^2 (patch 9, stride 4: 196 positions in
    chunks of 64, the last one short) and an explicit patch."""
    bundle, sd, jbundle, v = models
    img = images[2]
    t = _target(bundle, sd, img)
    assert g.occlusion_positions(64, 64, None, None)[:2] == (9, 4)
    assert g.occlusion_positions(32, 32, None, None)[:2] == (5, 2)
    fn, fv = _folded(bundle, sd)
    assert_map_close(g.occlusion_map(fn, fv, img, t, batch=64,
                                     compute_dtype=torch.float32),
                     jg.occlusion_map(jbundle.logits, v, img, t, batch=64,
                                      compute_dtype=jnp.float32))
    assert_map_close(g.occlusion_map(fn, fv, img, t, patch=16, stride=12,
                                     batch=5, compute_dtype=torch.float32),
                     jg.occlusion_map(jbundle.logits, v, img, t, patch=16, stride=12, batch=5,
                                      compute_dtype=jnp.float32))
    with pytest.raises(ValueError, match="no occlusion"):
        g.occlusion_map(fn, fv, img, t, patch=80)
    with pytest.raises(ValueError, match="engine.variables"):
        fn(sd, torch.zeros(1, 64, 64, 3))


def test_rise_matches_jax(models, images, monkeypatch):
    """20 masks in chunks of 8 (three chunks, rounded up to 24), grid 5."""
    bundle, sd, jbundle, v = models
    img = images[0]
    t = _target(bundle, sd, img)
    monkeypatch.setattr(g, "rise_draws", jax_rise_draws)
    fn, fv = _folded(bundle, sd)
    assert_map_close(g.rise_map(fn, fv, img, t, num_masks=20, grid=5, batch=8,
                                seed=2, compute_dtype=torch.float32),
                     jg.rise_map(jbundle.logits, v, img, t, num_masks=20, grid=5, batch=8,
                                 seed=2, compute_dtype=jnp.float32))


@pytest.mark.parametrize("layer, channels, batch", [(None, 8, 3), ("layer3_0", 5, 64)])
def test_scorecam_matches_jax(models, images, layer, channels, batch):
    """The masked forwards through the plain module (the default) and
    through the engine's folded plan."""
    bundle, sd, jbundle, v = models
    img = images[1]
    t = _target(bundle, sd, img)
    want = jg.scorecam(jbundle, v, img, t, layer=layer, channels=channels, batch=batch,
                       compute_dtype=jnp.float32)
    assert_map_close(g.scorecam(bundle, sd, img, t, layer=layer, channels=channels,
                                batch=batch, compute_dtype=torch.float32), want)
    fn, fv = _folded(bundle, sd)
    assert_map_close(g.scorecam(bundle, fv, img, t, layer=layer, channels=channels,
                                batch=batch, compute_dtype=torch.float32, logits_fn=fn), want)


# --- sweep entries -------------------------------------------------------------


def test_batch_entries_match_jax(images, monkeypatch):
    """attribute_batch (one stacked backward over N images) and
    mask_method_batch (one image after another) against the JAX package's
    vmapped and lax.map programs, per-image seeds included."""
    bundle, sd, jbundle, v = _models("bottleneck")
    targets = [_target(bundle, sd, im) for im in images]
    # Image 1 takes seed 5: with seed 0 or 3 the JAX package's f32 forward
    # crosses a ReLU / max-pool kink on one noisy sample, and its SmoothGrad
    # map leaves float64's while the port's stays on it
    # (test_smoothgrad_kink_seeds_against_float64).
    seeds = [0, 5, 1]
    monkeypatch.setattr(g, "smoothgrad_noise", jax_noise)
    monkeypatch.setattr(g, "rise_draws", jax_rise_draws)
    for method, kw in (("gradient", {}), ("integrated", {"steps": 2, "step_batch": 1}),
                       ("smoothgrad", {"samples": 2}), ("gradcam", {})):
        got = g.attribute_batch(bundle.logits, sd, images, targets, method, bundle=bundle,
                                seeds=seeds, **kw)
        want = jg.attribute_batch(jbundle.logits, v, images, targets, method, bundle=jbundle,
                                  seeds=seeds, **kw)
        for i in range(3):
            assert_map_close(got[i], want[i])
    # The JAX package's batch entry runs its one-shot functions at their
    # default bf16; held here against those functions in f32.
    f32 = jnp.float32
    fn, fv = _folded(bundle, sd)
    for method, kw, one_shot in (
            ("occlusion", {"patch": 16, "stride": 16},
             lambda i: jg.occlusion_map(jbundle.logits, v, images[i], targets[i], patch=16,
                                        stride=16, compute_dtype=f32)),
            ("rise", {"rise_masks": 8, "rise_grid": 4, "mask_batch": 4},
             lambda i: jg.rise_map(jbundle.logits, v, images[i], targets[i], num_masks=8,
                                   grid=4, batch=4, seed=seeds[i], compute_dtype=f32)),
            ("scorecam", {"scorecam_channels": 4},
             lambda i: jg.scorecam(jbundle, v, images[i], targets[i], channels=4,
                                   compute_dtype=f32))):
        got = g.mask_method_batch(fn, fv, images, targets, method,
                                  bundle=bundle, seeds=seeds, compute_dtype=torch.float32, **kw)
        for i in range(3):
            assert_map_close(got[i], one_shot(i))
    one = g.mask_method_one_fn(fn, bundle, "occlusion", patch=16, stride=16,
                               compute_dtype=torch.float32)
    assert_map_close(one(fv, images[0], targets[0], 0),
                     jg.occlusion_map(jbundle.logits, v, images[0], targets[0], patch=16,
                                      stride=16, compute_dtype=jnp.float32))
    assert g.attribute_batch(bundle.logits, sd, images[:0], [], "gradient").shape == (0, 64, 64)
    with pytest.raises(ValueError, match="unknown"):
        g.attribute_batch(bundle.logits, sd, images, targets, "rise")


def _port_grads(bundle, sd, x, t, dtype):
    """Per-sample ∂ logit_t / ∂ x of the port's plain module in ``dtype``."""
    state = {k: u.to(dtype) if u.is_floating_point() else u for k, u in sd.items()}
    xx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    bundle.module.eval()
    out = torch.func.functional_call(bundle.module, state, (xx,))[:, t].sum()
    return torch.autograd.grad(out, xx)[0].double().numpy()


def _jax_grads(module, v, x, t):
    return np.asarray(jax.vmap(jax.grad(lambda z: module.apply(v, z[None], False)[0, t]))(
        jnp.asarray(x)), np.float64)


@pytest.mark.parametrize("seed", [0, 3])
def test_smoothgrad_kink_seeds_against_float64(images, seed):
    """Image 1 with seeds 0 and 3 (two samples), the seeds the batch test
    avoids. Both packages add the same noise (the same f32 inputs, bit for
    bit). The gradient of a ReLU / max-pool net is piecewise constant in its
    input, so an f32 forward that puts one unit on the other side of a kink
    than exact arithmetic gives another gradient, not a rounded one.
    Witness: both packages' float64 gradients agree (to 1e-12); every one of
    the port's f32 sample gradients is within GRAD64_TOL of float64's, and
    its SmoothGrad map within MAP_TOL of the float64 map; the JAX package's
    f32 gradients leave float64 at one sample at most, the kink (measured
    on this CPU: seed 0 sample 1 2.5e-2, seed 3 sample 0 5.2e-3 x max
    |gradient|, where the port reads 8.7e-7 and 8.1e-7), and those sample
    gradients are the JAX package's SmoothGrad exactly."""
    bundle, sd, jbundle, v = _models("bottleneck")
    img = images[1]
    t = _target(bundle, sd, img)
    noise = jax_noise(seed, 2, img.shape)
    image = torch.from_numpy(img)[None]
    x = (image + noise * 0.15 * (image.max() - image.min())).numpy()
    jimg = jnp.asarray(img)
    jx = jimg[None] + jax.random.normal(jax.random.PRNGKey(seed), (2, *img.shape)) * 0.15 * (
        jnp.max(jimg) - jnp.min(jimg))
    np.testing.assert_array_equal(np.asarray(jx), x)
    with jax.enable_x64(True):
        j64 = JaxResNet(stage_sizes=STAGES, block=JBottleneck, num_classes=10,
                        dtype=jnp.float64, param_dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), v)
        want64 = _jax_grads(j64, v64, x.astype(np.float64), t)
    got64 = _port_grads(bundle, sd, x, t, torch.float64)
    scale = np.abs(want64).max()
    assert np.abs(got64 - want64).max() <= 1e-12 * scale
    port32 = _port_grads(bundle, sd, x, t, torch.float32)
    jax32 = _jax_grads(jbundle.module, v, x, t)
    port_err = [np.abs(port32[i] - want64[i]).max() / scale for i in range(2)]
    jax_err = [np.abs(jax32[i] - want64[i]).max() / scale for i in range(2)]
    assert max(port_err) <= GRAD64_TOL, port_err
    assert sorted(jax_err)[0] <= GRAD64_TOL, jax_err
    np.testing.assert_allclose(np.abs(jax32.mean(0)).sum(-1),
                               jg.smoothgrad(jbundle.logits, v, img, t, samples=2, seed=seed),
                               rtol=1e-6, atol=1e-6 * scale)
    map64 = np.abs(want64.mean(0)).sum(-1)
    assert_map_close(g.smoothgrad(bundle.logits, sd, img, t, samples=2, noise=noise), map64)
    print(f"seed {seed}: sample gradients vs float64, port {port_err}, JAX {jax_err}")


# --- fidelity metrics ------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(images):
    bundle, sd, jbundle, v = _models("bottleneck")
    return (SaliencyEngine(bundle, sd, mask_batch=16, compute_dtype=torch.float32, device="cpu"),
            JaxEngine(jbundle, v, mask_batch=16, compute_dtype=jnp.float32))


def test_rank_map_and_cut_counts_match_jax():
    heat = np.round(np.random.RandomState(1).rand(9, 7), 1)   # many ties
    rank = eval_metrics._rank_map(heat)
    np.testing.assert_array_equal(rank, jeval._rank_map(heat))
    assert sorted(rank.ravel()) == list(range(63))
    np.testing.assert_array_equal(eval_metrics._cut_counts(np.zeros((9, 7, 3)), 8),
                                  np.round(np.linspace(0, 63, 9)).astype(np.int32))


def test_fidelity_matches_jax(engines, images):
    """The same heatmap through both engines: both curves of
    deletion_insertion_auc and each fidelity_curve within AUC_TOL."""
    engine, jengine = engines
    img = images[1]
    heat = np.round(np.random.RandomState(2).rand(64, 64), 2).astype(np.float32)
    t = engine.predict_one(img)[0]
    got = eval_metrics.deletion_insertion_auc(engine, img, heat, t, steps=8)
    want = jeval.deletion_insertion_auc(jengine, img, heat, t, steps=8)
    for key in ("deletion_auc", "insertion_auc"):
        assert abs(got[key] - want[key]) <= AUC_TOL, key
    for key in ("deletion_curve", "insertion_curve"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=AUC_TOL)
    assert np.ptp(got["deletion_curve"]) > 1e-3, "a flat curve: a weak test"
    for mode in ("deletion", "insertion"):
        probs, auc = eval_metrics.fidelity_curve(engine, img, heat, t, steps=5, mode=mode)
        jprobs, jauc = jeval.fidelity_curve(jengine, img, heat, t, steps=5, mode=mode)
        np.testing.assert_allclose(probs, jprobs, rtol=0, atol=AUC_TOL)
        assert abs(auc - jauc) <= AUC_TOL and probs.dtype == np.float32
    with pytest.raises(ValueError):
        eval_metrics.fidelity_curve(engine, img, heat, t, mode="sideways")


def test_pointing_game_matches_jax():
    """Half-open boxes: the argmax on the left/top edge is in, one past the
    right/bottom edge is out unless the tolerance reaches it; float boxes."""
    heat = np.zeros((20, 30), np.float32)
    cases = []
    for (y, x) in ((5, 4), (5, 14), (15, 10), (0, 0), (19, 29)):
        h = heat.copy()
        h[y, x] = 1.0
        for box in ((4, 5, 10, 8), (4.0, 5.0, 10.5, 10.0), (0, 0, 1, 1), (28, 18, 2, 2)):
            for tol in (0, 1):
                got = eval_metrics.pointing_game(h, box, tolerance=tol)
                assert got == jeval.pointing_game(h, box, tolerance=tol), (y, x, box, tol)
                cases.append(got)
    assert any(cases) and not all(cases)
    h = heat.copy()
    h[5, 14] = 1.0
    assert not eval_metrics.pointing_game(h, (4, 5, 10, 8))
    assert eval_metrics.pointing_game(h, (4, 5, 10, 8), tolerance=1)
