"""The port's BO (bo/acquisition.py, bo/loop.py, saliency/bo_pipeline.py)
against the JAX package's, in f32 on the CPU.

Random numbers: the host loop draws from numpy's RandomState in both
packages. The fused loop's jax.random draws cannot be reproduced, so the
port's fused runs take JAX's trace as their draws (pre-samples, then the
value of each (iteration, proposal) slot): where JAX resampled, the port
gets the same value; where JAX took its proposal, the draw goes unused.

Exact comparisons of proposals are meaningful only where the EI argmax is
not a near-tie: at every iteration each test computes the EI of both
packages on the trace and asserts that the competing candidates stand
further apart than twice the largest difference between the two (see
_assert_unambiguous). Survive labels are compared exactly where no masked image sits
within 5e-4 of the largest logit of an argmax tie (as tests/test_torch_slice.py
does). Scores agree within 1e-6."""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from network_interpretation_imagenet_tpu import models as jmodels
from network_interpretation_imagenet_tpu.bo import acquisition as jacq
from network_interpretation_imagenet_tpu.bo import loop as jloop
from network_interpretation_imagenet_tpu.config import BOConfig as JBOConfig
from network_interpretation_imagenet_tpu.gp import exact as jexact
from network_interpretation_imagenet_tpu.models.resnet_imagenet import Bottleneck
from network_interpretation_imagenet_tpu.models.resnet_imagenet import ResNet as JaxResNet
from network_interpretation_imagenet_tpu.saliency import bo_pipeline as jbo
from network_interpretation_imagenet_tpu.saliency import pipeline as jpipeline
from network_interpretation_imagenet_tpu.saliency.engine import SaliencyEngine as JaxEngine
from network_interpretation_imagenet_tpu_torch.bo import acquisition, loop
from network_interpretation_imagenet_tpu_torch.config import BOConfig, SegmentConfig
from network_interpretation_imagenet_tpu_torch.data.transform import pil_eval_transform
from network_interpretation_imagenet_tpu_torch.gp import exact
from network_interpretation_imagenet_tpu_torch.models import ModelBundle, ResNet
from network_interpretation_imagenet_tpu_torch.ops.masked_batch import masked_batch
from network_interpretation_imagenet_tpu_torch.ops.preprocess import to_display_uint8
from network_interpretation_imagenet_tpu_torch.saliency import bo_pipeline, pipeline
from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
from network_interpretation_imagenet_tpu_torch.segment.common import segment_image
from network_interpretation_imagenet_tpu_torch.utils.convert import resnet_from_jax
from torch_port_util import flax_resnet_variables, randomize_bn

GRID = loop.LENGTHSCALE_GRID
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "imagenet_loc")
IMAGES = ("n01440764/ILSVRC2012_val_00000001.JPEG", "n01443537/ILSVRC2012_val_00000002.JPEG",
          "n01484850/ILSVRC2012_val_00000003.JPEG")
STAGES = (1, 2, 1, 2)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _assert_unambiguous(ei, jei, xs_obs, k, where):
    """The k proposals taken from the port's ``ei`` cannot flip by rounding:
    each of the k + 1 leading candidates stands clear of the next by more
    than twice the largest difference between the port's and JAX's EI (so
    JAX orders the two alike, with a factor 2 to spare), unless
    both candidates are observed already (then either is resampled with the
    same draw) or tie exactly in both packages (both take the lower index)."""
    ei, jei = ei.double().numpy(), np.asarray(jei, np.float64)
    finite = np.isfinite(ei)
    np.testing.assert_array_equal(finite, np.isfinite(jei))
    tol = 2 * np.abs(ei[finite] - jei[finite]).max()
    order = np.argsort(-ei, kind="stable")
    observed = set(int(x) for x in xs_obs)
    for a, b in zip(order[:k], order[1:k + 1]):
        if ei[a] == ei[b] and jei[a] == jei[b]:
            continue
        if ei[a] - ei[b] <= tol and not {int(a), int(b)} <= observed:
            pytest.fail(f"{where}: EI near-tie between candidates {a} and {b} "
                        f"({ei[a]} vs {ei[b]}; the packages differ by up to {tol / 2})")


_HOST_CANDIDATES = 64   # every host case's upper is below this: one JAX compile per n


@functools.lru_cache(maxsize=None)
def _jax_host_ei():
    grid = jnp.asarray(GRID, jnp.float32)
    cand = jnp.arange(_HOST_CANDIDATES, dtype=jnp.float32)[:, None]
    return jax.jit(lambda x, y: jacq.ei_over_candidates(
        jexact.fit_lengthscale_sweep(x, y, grid), cand, y))


def _host_ei_check(xp, yp, n_pre, upper):
    """The host loop's EI in both packages at every iteration of a trace."""
    cand = t(np.arange(upper + 1))[:, None]
    for n in range(n_pre, len(xp)):
        x, y = np.asarray(xp[:n], np.float32)[:, None], np.asarray(yp[:n], np.float32)
        fit = exact.fit_lengthscale_sweep(t(x), t(y), t(GRID))
        jei = np.asarray(_jax_host_ei()(jnp.asarray(x), jnp.asarray(y)))[:upper + 1]
        _assert_unambiguous(acquisition.ei_over_candidates(fit, cand, t(y)), jei, xp[:n], 1,
                            f"host iteration {n - n_pre}")


@functools.lru_cache(maxsize=None)
def _jax_fused_ei(m, n_cand):
    """JAX's fused-loop acquisition (``bo/loop.py:252-289``) from the JAX
    package's incremental GP functions, jitted once per buffer and candidate
    count: ``fn(xs[m], ys[m], n, upper)`` -> EI at observation count n."""
    grid = jnp.asarray(GRID, jnp.float32)
    cand = jnp.arange(n_cand, dtype=jnp.float32)
    slots = jnp.arange(m)

    @jax.jit
    def fn(xs, ys, n, upper):
        def build(ls):
            def body(i, state):
                buf = jnp.where(slots <= i, xs, 0.0)
                new = jexact.incremental_add(state, buf, i, xs[i], ls, 1e-5)
                return jax.tree.map(lambda a, b: jnp.where(i < n, a, b), new, state)

            return jax.lax.fori_loop(0, m, body, jexact.incremental_init(m))

        gp = jax.vmap(build)(grid)
        valid = (slots < n).astype(jnp.float32)
        xs_n, ys_n = xs * valid, ys * valid
        cnt = jnp.maximum(jnp.sum(valid), 1.0)
        mean = jnp.sum(ys_n * valid) / cnt
        std = jnp.sqrt(jnp.maximum(jnp.sum(valid * (ys_n - mean) ** 2) / cnt, 1e-12))
        yn = (ys_n - mean) / std * valid
        mlls = jax.vmap(lambda g: jexact.incremental_mll(g, yn, n.astype(jnp.float32)))(gp)
        mu, sigma = jax.vmap(lambda g, ls: jexact.incremental_predict(
            g, xs_n, valid, yn, cand, ls))(gp, grid)
        best = jnp.nanargmax(mlls)
        ei = jacq.expected_improvement(mu[best], sigma[best], jnp.where(valid > 0, yn, -jnp.inf),
                                       greater_is_better=True)
        return jnp.where(cand <= upper, ei, -jnp.inf)

    return fn


def _fused_ei_check(xs, ys, n_pre, n_iters, q, upper, max_candidates):
    """The fused loop's EI in both packages at every iteration of a trace:
    the port's ``loop.fused_ei`` on a GP state built up from the trace."""
    m = n_pre + n_iters * q
    xs_b, ys_b = t(xs)[None], t(ys)[None]
    gp = exact.incremental_init(m, (1, len(GRID)))
    cand = np.arange(max_candidates, dtype=np.float32)
    for i in range(m - 1):
        buf = torch.where(torch.arange(m) <= i, xs_b, torch.zeros_like(xs_b))
        gp = exact.incremental_add(gp, buf[:, None, :], i, xs_b[:, i, None], t(GRID), 1e-5)
        n = i + 1
        if n >= n_pre and (n - n_pre) % q == 0:
            ys_n = torch.where(torch.arange(m) < n, ys_b, torch.zeros_like(ys_b))
            ei = loop.fused_ei(gp, buf, ys_n, n, t(cand), t(GRID), t(cand)[None] <= upper)[0]
            jei = _jax_fused_ei(m, max_candidates)(jnp.asarray(xs, jnp.float32),
                                                   jnp.asarray(ys, jnp.float32), n, upper)
            _assert_unambiguous(ei, jei, xs[:n], q,
                                f"fused iteration {(n - n_pre) // q}")


@pytest.mark.parametrize("greater", [True, False])
def test_expected_improvement_matches_jax(greater):
    rng = np.random.RandomState(0)
    mu = rng.randn(12).astype(np.float32)
    sigma = (np.abs(rng.randn(12)) + 0.1).astype(np.float32)
    sigma[[2, 7]] = 0.0
    y = rng.randn(6).astype(np.float32)
    want = np.asarray(jacq.expected_improvement(jnp.asarray(mu), jnp.asarray(sigma),
                                                jnp.asarray(y), greater))
    got = acquisition.expected_improvement(t(mu), t(sigma), t(y), greater).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[2] == 0.0 and got[7] == 0.0 and (got >= 0).all()


def _peak(idx):
    idx = np.asarray(idx, float)
    scores = np.exp(-0.5 * ((idx - 17.0) / 5.0) ** 2)
    return scores.astype(np.float32), scores > 0.8


def _flat(idx):
    idx = np.asarray(idx, float)
    return np.ones_like(idx, np.float32) * 0.5, np.ones_like(idx, bool)


@pytest.mark.parametrize("objective,upper,n_pre,n_iters,seed", [
    (_peak, 40, 3, 4, 0),      # tests/test_bo.py:44's planted optimum
    (_peak, 40, 3, 4, 5),
    (_flat, 10, 3, 4, 1),      # tests/test_bo.py:60: duplicates -> resamples
])
def test_host_loop_matches_jax(objective, upper, n_pre, n_iters, seed):
    want = jloop.bayesian_optimize(objective, upper=upper, n_pre_samples=n_pre,
                                   n_iters=n_iters, seed=seed)
    got = loop.bayesian_optimize(objective, upper=upper, n_pre_samples=n_pre, n_iters=n_iters,
                                 seed=seed, device="cpu")
    _host_ei_check(got.xp, got.yp, n_pre, upper)
    np.testing.assert_array_equal(got.xp, want.xp)
    np.testing.assert_array_equal(got.survived, want.survived)
    np.testing.assert_allclose(got.yp, want.yp, rtol=0, atol=1e-6)
    assert len(got.xp) == n_pre + n_iters


def _toy():
    """tests/test_bo.py:71's problem: segments 3..5 hold the evidence, and
    class 1's logit grows with the evidence a window keeps."""
    h = w = 16
    segments = (np.arange(h * w).reshape(h, w) // (h * w // 8)).astype(np.int32)
    image = np.zeros((h, w, 1), np.float32)
    image[(segments >= 3) & (segments <= 5)] = 1.0
    return image, segments


@pytest.mark.parametrize("q,n_pre,n_iters,seed", [(1, 3, 8, 1), (1, 3, 8, 3), (2, 2, 4, 0)])
def test_fused_loop_matches_jax_with_its_draws(q, n_pre, n_iters, seed):
    image, segments = _toy()

    def jlogits(imgs):
        s = jnp.sum(imgs, axis=(1, 2, 3))
        return jnp.stack([jnp.full_like(s, 3.0), s * 0.15], axis=1)

    def tlogits(imgs):
        s = torch.sum(imgs, dim=(1, 2, 3))
        return torch.stack([torch.full_like(s, 3.0), s * 0.15], dim=1)

    jxs, jys, jsurv, jcount = jloop.fused_window_bo(
        jlogits, jnp.asarray(image), jnp.asarray(segments), jnp.int32(3), jnp.int32(1),
        jnp.int32(7), max_candidates=8, n_pre_samples=n_pre, n_iters=n_iters,
        key=jax.random.PRNGKey(seed), proposals_per_iter=q)
    count = int(jcount)
    jxs, jys, jsurv = (np.asarray(a)[:count] for a in (jxs, jys, jsurv))
    xs, ys, surv, got_count = loop.fused_window_bo(
        tlogits, image, segments, 3, 1, 7, 8, n_pre_samples=n_pre, n_iters=n_iters,
        draws=torch.from_numpy(jxs.astype(np.int64)), proposals_per_iter=q, device="cpu")
    _fused_ei_check(xs.numpy(), ys.numpy(), n_pre, n_iters, q, 7, 8)
    assert got_count == count == n_pre + n_iters * q
    np.testing.assert_array_equal(xs.numpy(), jxs)
    np.testing.assert_array_equal(surv.numpy(), jsurv)
    np.testing.assert_allclose(ys.numpy(), jys, rtol=0, atol=1e-6)
    assert int(xs[ys.argmax()]) in (2, 3, 4)   # the planted optimum, as tests/test_bo.py asks


def test_fused_program_never_reads_the_device():
    """Between the pre-samples and the last iteration the loop makes no host
    read (each would be a device synchronisation on the card)."""
    image, segments = _toy()
    run = loop.make_fused_window_bo(
        loop.logits_outcomes(lambda x: torch.stack([x.sum((1, 2, 3)), -x.sum((1, 2, 3))], 1)),
        8, n_pre_samples=2, n_iters=3, proposals_per_iter=2, device="cpu")
    draws = loop.window_draws(torch.Generator().manual_seed(0), 7, run.max_obs)
    args = (t(image)[None], torch.from_numpy(segments)[None],
            torch.tensor([3], dtype=torch.int32), torch.tensor([0]), t([7]), draws[None].float())

    def refuse(*_a, **_k):
        raise AssertionError("host read inside the fused program")

    names = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__", "__index__")
    saved = {name: getattr(torch.Tensor, name) for name in names}
    try:
        for name in names:
            setattr(torch.Tensor, name, refuse)
        xs, ys, survived = run._program(*args)
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
    assert xs.shape == (1, 8) and bool(((xs >= 0) & (xs <= 7)).all())


def test_fused_runner_checks_its_draws():
    image, segments = _toy()
    run = loop.make_fused_window_bo(loop.logits_outcomes(lambda x: x.sum((1, 2, 3))[:, None]),
                                    8, n_pre_samples=2, n_iters=3, device="cpu")
    with pytest.raises(ValueError):
        run(image, segments, 3, 0, 7, torch.zeros(4, dtype=torch.int64))
    draws = loop.window_draws(torch.Generator().manual_seed(3), 7, 1000)
    assert int(draws.min()) == 0 and int(draws.max()) == 7
    assert torch.equal(draws, loop.window_draws(torch.Generator().manual_seed(3), 7, 1000))
    assert [loop.next_pow2(n) for n in (1, 8, 9, 100, 128)] == [8, 8, 16, 128, 128]


def test_runner_graph_cache_by_shape(monkeypatch):
    """The card's graph cache, with CUDA graph capture stood in for on the
    CPU (the stand-in's replay does nothing, so a call gives the right answer
    only when its capture ran the program on its own inputs): the first call
    of a shape runs eagerly, the second captures, later calls replay. The
    widths are device inputs and do not key the cache; at most MAX_GRAPHS
    shapes are kept."""
    replays = []

    class StandInGraph:
        def replay(self):
            replays.append(1)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph: contextlib.nullcontext())
    image, segments = _toy()
    run = loop.make_fused_window_bo(loop.logits_outcomes(lambda x: torch.stack(
        [x.sum((1, 2, 3)), -x.sum((1, 2, 3))], 1)), 8, n_pre_samples=2, n_iters=3, device="cpu")
    eager = loop.make_fused_window_bo(run.outcomes_fn, 8, n_pre_samples=2, n_iters=3,
                                      device="cpu")
    run.cuda_graph = True
    draws = loop.window_draws(torch.Generator().manual_seed(0), 7, run.max_obs)
    for i, width in enumerate((3, 2)):
        got = run(image, segments, width, 0, 7, draws)
        want = eager(image, segments, width, 0, 7, draws)
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b)
        entry, = run.graphs.values()
        assert (entry is None) == (i == 0) and len(replays) == i
    run(image, segments, 3, 0, 7, draws)
    assert len(replays) == 2 and len(run.graphs) == 1
    for size in range(4, 4 + loop.MAX_GRAPHS):
        run(np.zeros((size, size, 1), np.float32), np.zeros((size, size), np.int32), 1, 0, 7,
            draws)
    assert len(run.graphs) == loop.MAX_GRAPHS and tuple(image.shape) not in (
        key[0][1:] for key in run.graphs)


@pytest.fixture(scope="module")
def engines():
    """The reduced ResNet of tests/test_torch_slice.py with random weights
    and BatchNorm statistics, the same in both packages (the JAX weights
    reach the port through ``resnet_from_jax``), f32 on the CPU; the fixture
    images at 64^2. With these seeds a mix of windows survive on each image."""
    images = [pil_eval_transform(Image.open(os.path.join(FIXTURES, p)).convert("RGB"), crop=64)
              for p in IMAGES]
    segments = [segment_image(to_display_uint8(torch.from_numpy(im)).numpy(), SegmentConfig())
                for im in images]
    module = JaxResNet(stage_sizes=STAGES, block=Bottleneck, num_classes=10)
    bundle = ModelBundle("r", ResNet(STAGES, num_classes=10), 64, 3, 10)
    state_dict = bundle.init(4)
    for name, w in state_dict.items():
        if w.dim() == 4:   # LeCun-normal scale, as flax draws it: livelier logits than Kaiming's
            state_dict[name] = w * (w.shape[0] / (2.0 * w.shape[1])) ** 0.5
    variables = flax_resnet_variables(state_dict, STAGES)
    randomize_bn(variables["params"], variables["batch_stats"], np.random.RandomState(5))
    jengine = JaxEngine(jmodels.ModelBundle("r", module, 64, 3, 10), variables, mask_batch=16,
                        compute_dtype=jnp.float32)
    engine = SaliencyEngine(bundle, resnet_from_jax(variables), mask_batch=16,
                            compute_dtype=torch.float32, device="cpu")
    return images, segments, jengine, engine


def _assert_labels_meaningful(engine, image, segments, firsts, width):
    """No evaluated window's masked image sits near an argmax tie."""
    with torch.inference_mode():
        imgs = masked_batch(t(image), torch.from_numpy(segments),
                            torch.from_numpy(np.asarray(firsts, np.int32)), width, torch.float32)
        logits = engine.model(imgs)
    top2 = torch.topk(logits, 2).values
    assert (top2[:, 0] - top2[:, 1]).min().item() > 5e-4 * logits.abs().max().item()


def _target(engines, i):
    images, _, jengine, engine = engines
    target = engine.predict_one(images[i])[0]
    assert target == jengine.predict_one(images[i])[0]
    return target


@pytest.mark.parametrize("image,seed", [(0, 0), (1, 1)])
def test_bo_window_saliency_host_loop_matches_jax(engines, image, seed):
    images, segments, jengine, engine = engines
    target = _target(engines, image)
    out, tr = bo_pipeline.bo_window_saliency(engine, images[image], segments[image],
                                             BOConfig(n_iters=4, n_pre_samples=3), seed=seed,
                                             target=target, fused=False)
    jout, jtr = jbo.bo_window_saliency(jengine, images[image], segments[image],
                                       JBOConfig(n_iters=4, n_pre_samples=3), seed=seed,
                                       target=target, fused=False)
    _host_ei_check(tr.xp, tr.yp, 3, int(0.6 * out.num_segments))
    _assert_labels_meaningful(engine, images[image], segments[image], tr.xp, out.width)
    np.testing.assert_array_equal(tr.xp, jtr.xp)
    np.testing.assert_array_equal(tr.survived, jtr.survived)
    np.testing.assert_allclose(tr.yp, jtr.yp, rtol=0, atol=1e-6)
    assert 0 < tr.survived.sum() < len(tr.xp), "all windows alike: a weak test"
    np.testing.assert_array_equal(out.heatmap, jout.heatmap)
    gt = (10, 12, 30, 28)
    for ref_compat in (False, True):
        iou, box = pipeline.localization_score(out.heatmap, gt, ref_compat=ref_compat)
        jiou, jbox = jpipeline.localization_score(jout.heatmap, gt, ref_compat=ref_compat)
        np.testing.assert_array_equal(box, jbox)
        assert iou == jiou


@pytest.mark.parametrize("image,seed", [(0, 0), (2, 1)])
def test_bo_window_saliency_fused_matches_jax(engines, image, seed):
    images, segments, jengine, engine = engines
    target = _target(engines, image)
    jout, jtr = jbo.bo_window_saliency(jengine, images[image], segments[image],
                                       JBOConfig(n_iters=3, n_pre_samples=2), seed=seed,
                                       target=target, fused=True)
    out, tr = bo_pipeline.bo_window_saliency(
        engine, images[image], segments[image], BOConfig(n_iters=3, n_pre_samples=2),
        target=target, draws=torch.from_numpy(jtr.xp.astype(np.int64)))
    upper = int(0.6 * out.num_segments)
    _fused_ei_check(tr.xp, tr.yp, 2, 3, 1, upper, loop.next_pow2(upper + 1))
    _assert_labels_meaningful(engine, images[image], segments[image], tr.xp, out.width)
    np.testing.assert_array_equal(tr.xp, jtr.xp)
    np.testing.assert_array_equal(tr.survived, jtr.survived)
    np.testing.assert_allclose(tr.yp, jtr.yp, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out.heatmap, jout.heatmap)
    np.testing.assert_array_equal(out.firsts, jout.firsts)


@pytest.mark.parametrize("q", [1, 2])
def test_multi_image_equals_single_calls(engines, q):
    """N = 3 images in one program, per-image seeds: each trace equals the
    single-image call with that seed."""
    images, segments, _, engine = engines
    cfg = BOConfig(n_iters=3, n_pre_samples=2)
    seeds, targets = [11, 12, 13], [_target(engines, i) for i in range(3)]
    multi = bo_pipeline.bo_window_saliency_multi(engine, images, segments, cfg, targets=targets,
                                                 proposals_per_iter=q, per_image_seeds=seeds)
    assert len(multi) == 3
    for i, (out, tr) in enumerate(multi):
        one, one_tr = bo_pipeline.bo_window_saliency(engine, images[i], segments[i], cfg,
                                                     seed=seeds[i], target=targets[i],
                                                     proposals_per_iter=q)
        np.testing.assert_array_equal(tr.xp, one_tr.xp)
        np.testing.assert_array_equal(tr.survived, one_tr.survived)
        np.testing.assert_allclose(tr.yp, one_tr.yp, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(out.heatmap, one.heatmap)
        assert len(tr.xp) == 2 + 3 * q and tr.xp.max() <= int(0.6 * out.num_segments)
    # Without per-image seeds image 0 draws what a single call with ``seed`` draws.
    first = bo_pipeline.bo_window_saliency_multi(engine, images, segments, cfg, seed=5,
                                                 targets=targets, proposals_per_iter=q)[0][1]
    single = bo_pipeline.bo_window_saliency(engine, images[0], segments[0], cfg, seed=5,
                                            target=targets[0], proposals_per_iter=q)[1]
    np.testing.assert_array_equal(first.xp, single.xp)
