"""The port's serving artifacts (network_interpretation_imagenet_tpu_torch/
serving.py) against the JAX package's, on the MNIST CNN (28x28x1, f32,
buckets 16 and 4, as tests/test_serving.py uses), on the CPU.

The weights are ``torch_port_util.serving_mnist``'s (BatchNorm statistics
measured on window-masked copies of the test image, so masked predictions
move), the same in both packages (``jax_variables``). Tolerances: predictions, survive labels, BO traces and
window heatmaps exactly; probabilities within 1e-5 (a JAX-written artifact
served by the port, against the JAX server and engine); the deterministic
attribution maps within 1e-4 of the JAX map's scale, as
tests/test_torch_attribution.py holds them; the stochastic ones (their draws
come from the port's generators) exactly against the port's own library
call; BO scores of an image-batched loop within 1e-6 of the single loop's
(tests/test_torch_bo.py's rounding at another batch size)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import serving_mnist

from network_interpretation_imagenet_tpu import serving as jserving
from network_interpretation_imagenet_tpu.config import BOConfig as JBOConfig
from network_interpretation_imagenet_tpu.models import create_model as jcreate_model
from network_interpretation_imagenet_tpu.saliency import SaliencyEngine as JaxEngine
from network_interpretation_imagenet_tpu.saliency import bo_pipeline as jbo
from network_interpretation_imagenet_tpu.saliency import gradient as jgrad
from network_interpretation_imagenet_tpu.saliency import xrai as jxrai
from network_interpretation_imagenet_tpu_torch import serving
from network_interpretation_imagenet_tpu_torch.config import BOConfig
from network_interpretation_imagenet_tpu_torch.ops.aggregate import normalize_to_uint8_np
from network_interpretation_imagenet_tpu_torch.saliency import bo_pipeline
from network_interpretation_imagenet_tpu_torch.saliency import gradient as g
from network_interpretation_imagenet_tpu_torch.saliency import learned_mask
from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
from network_interpretation_imagenet_tpu_torch.utils.convert import jax_variables

BUCKETS = (16, 4)
TARGET = 4          # the masked images' usual prediction: most survive, some die
BO_TARGET = 2       # for the BO loop's wider windows (6 of 16 blocks): some survive
BO_CFG = dict(n_iters=3, n_pre_samples=2)
# A small-cost attribution configuration (the keys the JAX package checks).
ATTR_CFG = {"ig_steps": 8, "sg_samples": 4, "rise_masks": 32, "mask_batch": 16,
            "scorecam_channels": 16, "lm_iters": 3}
ATTR = ("gradient", "grad_input", "integrated", "smoothgrad", "gradcam", "scorecam",
        "occlusion", "rise", "meaningful", "xrai")


def blocks(side=28, cell=7):
    """A grid of square segments ((side/cell)^2 of them)."""
    n = side // cell
    idx = np.arange(side) // cell
    return (idx[:, None] * n + idx[None, :]).astype(np.int32)


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    """Port and JAX engines on the same calibrated MNIST CNN, the test image,
    its 16-block segments, 21 window starts (16 + 4 + a padded tail), and a
    JAX-written artifact (buckets 16 and 4, knockout_m 2)."""
    bundle, state_dict, image, segments, firsts = serving_mnist()
    engine = SaliencyEngine(bundle, state_dict, mask_batch=16, compute_dtype=torch.float32,
                            device="cpu")
    jbundle = jcreate_model("mnist_cnn", "mnist")
    jvars = jax_variables(state_dict, bundle.module)
    jengine = JaxEngine(jbundle, jvars, mask_batch=16, compute_dtype=jnp.float32)
    root = tmp_path_factory.mktemp("serving")
    jax_dir = str(root / "jax")
    jserving.export_engine(jengine, jax_dir, batch_sizes=BUCKETS, knockout_m=2)
    port_dir = str(root / "port")
    serving.export_engine(engine, port_dir, batch_sizes=BUCKETS, knockout_m=2,
                          attribution=ATTR, attribution_cfg=ATTR_CFG,
                          attribution_batches=(2,))
    serving.export_bo_engine(engine, port_dir, bo_cfg=BOConfig(**BO_CFG),
                             candidate_buckets=(16,), image_batches=(4,),
                             include_weights=False)
    return dict(bundle=bundle, engine=engine, jbundle=jbundle, jvars=jvars, jengine=jengine,
                image=image, segments=segments, firsts=firsts[:21], jax_dir=jax_dir,
                port_dir=port_dir, root=root,
                server=serving.load_exported(port_dir, device="cpu"),
                bo=serving.load_exported_bo(port_dir, device="cpu"))


def assert_same_outcomes(got, want):
    np.testing.assert_array_equal(got.preds, want.preds)
    np.testing.assert_array_equal(got.survived, want.survived)
    np.testing.assert_allclose(got.prob_target, want.prob_target, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.prob_max, want.prob_max, rtol=0, atol=1e-5)


def test_jax_artifact_served_by_the_port(mnist):
    """The JAX package's export_engine writes, the port's load_exported
    serves: against the JAX server and the JAX engine on 21 starts."""
    srv = serving.load_exported(mnist["jax_dir"], device="cpu")
    jsrv = jserving.load_exported(mnist["jax_dir"])
    image, segments, firsts = mnist["image"], mnist["segments"], mnist["firsts"]
    got = srv.eval_window_masks(image, segments, firsts, 4, TARGET)
    assert type(got).__name__ == "MaskEvalResult"
    assert 0 < got.survived.sum() < len(firsts), "all windows alike: a weak test"
    assert_same_outcomes(got, jsrv.eval_window_masks(image, segments, firsts, 4, TARGET))
    assert_same_outcomes(got, mnist["jengine"].eval_window_masks(image, segments, firsts, 4,
                                                                 TARGET))
    empty = srv.logits_for_windows(image, segments, np.zeros(0, np.int32), 4)
    assert empty.shape == (0, 10) and empty.dtype == np.float32
    r0 = srv.eval_window_masks(image, segments, np.zeros(0, np.int32), 4, TARGET)
    assert r0.survived.shape == (0,) and r0.preds.shape == (0,)


@pytest.mark.parametrize("m", [1, 2])
def test_knockouts_up_to_the_exported_m_match_jax(mnist, m):
    """m < M pads with the -1 sentinel; m = M as exported; m > M refused."""
    srv = serving.load_exported(mnist["jax_dir"], device="cpu")
    jsrv = jserving.load_exported(mnist["jax_dir"])
    rng = np.random.RandomState(m)
    ids = rng.randint(0, 16, size=(21, m)).astype(np.int32)
    image, segments = mnist["image"], mnist["segments"]
    got = srv.eval_knockout_masks(image, segments, ids, TARGET)
    assert_same_outcomes(got, jsrv.eval_knockout_masks(image, segments, ids, TARGET))
    assert_same_outcomes(got, mnist["jengine"].eval_knockout_masks(image, segments, ids, TARGET))
    with pytest.raises(ValueError, match="exported with knockout_m=2; re-export"):
        srv.eval_knockout_masks(image, segments, np.zeros((2, 3), np.int32), TARGET)
    assert srv.logits_for_knockouts(image, segments, np.zeros((0, m), np.int32)).shape == (0, 10)


def test_port_artifact_bytes_and_manifest_match_jax(mnist, tmp_path):
    """The port's export_engine writes the JAX package's weight bytes and its
    manifest key for key, apart from the null program maps,
    export_platform and the added "model" entry."""
    kw = dict(batch_sizes=BUCKETS, knockout_m=2, attribution=("gradient", "gradcam", "xrai"),
              attribution_batches=(2,), attribution_cfg={"ig_steps": 8})
    want = jserving.export_engine(mnist["jengine"], str(tmp_path / "j"), **kw)
    got = serving.export_engine(mnist["engine"], str(tmp_path / "p"), **kw)
    with open(tmp_path / "j" / "variables.msgpack", "rb") as a, \
            open(tmp_path / "p" / "variables.msgpack", "rb") as b:
        assert a.read() == b.read()
    with open(tmp_path / "p" / "manifest.json") as f:
        assert json.load(f) == got
    assert set(got) == set(want) | {"model"}
    assert got["model"] == {"dataset": "mnist", "depth": None, "death_mode": "none",
                            "death_rate": 0.5, "growth_rate": 12, "bn_size": 4,
                            "compression": 0.5, "transform_input": False, "dtype": "float32"}
    assert got["export_platform"] == "cpu"

    def programs_null(tree):
        return {k: programs_null(v) if isinstance(v, dict) else None for k, v in tree.items()}

    for key in ("files", "knockout_files"):
        assert got[key] == programs_null(want[key])
    ga, wa = got["attribution"], want["attribution"]
    assert ga["config"] == wa["config"]
    assert ga["files"] == programs_null(wa["files"])
    assert ga["batched_files"] == programs_null(wa["batched_files"])
    assert ga["xrai"] == {**wa["xrai"], "file": None}
    for key in set(want) - {"files", "knockout_files", "attribution", "export_platform"}:
        assert got[key] == want[key], key


def test_bo_manifest_matches_jax(mnist, tmp_path):
    """export_bo_engine: the JAX package's BO manifest key for key, with
    null program maps and the loop's alpha, epsilon and lengthscale grid
    added under "bo" (the JAX package bakes them into its programs)."""
    kw = dict(candidate_buckets=(7, 16), image_batches=(3,), include_weights=False)
    want = jserving.export_bo_engine(mnist["jengine"], str(tmp_path / "j"),
                                     bo_cfg=JBOConfig(**BO_CFG), **kw)
    got = serving.export_bo_engine(mnist["engine"], str(tmp_path / "p"),
                                   bo_cfg=BOConfig(**BO_CFG), **kw)
    assert set(got) == set(want) | {"model"}
    assert got["bo"] == {**want["bo"], "alpha": 1e-5, "epsilon": 1e-7,
                         "lengthscale_grid": list(BOConfig().lengthscale_grid)}
    assert got["files"] == {k: None for k in want["files"]}
    assert got["batched_files"] == {n: {k: None for k in per}
                                    for n, per in want["batched_files"].items()}
    assert got["batched_predicts"] == {k: None for k in want["batched_predicts"]}
    assert got["predict"] is None and got["weights"] is None
    for key in ("arch", "num_classes", "input_size", "input_channels", "compute_dtype",
                "candidate_buckets", "image_batches"):
        assert got[key] == want[key], key


def test_pad_rows_do_not_change_the_true_rows(mnist):
    """The tail bucket's pad rows are dropped and leave the true rows'
    logits exactly as they are, whatever the pad rows hold."""
    srv, image, segments, firsts = (mnist["server"], mnist["image"], mnist["segments"],
                                    mnist["firsts"])
    got = srv.logits_for_windows(image, segments, firsts, 4)
    other = srv.logits_for_windows(image, segments, np.concatenate([firsts, [12, 7, 3]]), 4)
    assert got.shape == (21, 10)
    np.testing.assert_array_equal(got, other[:21])
    ids = np.stack([firsts % 16, (firsts + 5) % 16], axis=1)
    ko = srv.logits_for_knockouts(image, segments, ids)
    ko_other = srv.logits_for_knockouts(image, segments,
                                        np.concatenate([ids, [[1, 2], [3, 4], [5, 6]]]))
    np.testing.assert_array_equal(ko, ko_other[:21])


def test_port_artifact_round_trip_equals_the_engine(mnist):
    """A port-written artifact serves the engine's own outcomes, and the
    loaders rebuild the net from the "model" entry."""
    srv, engine = mnist["server"], mnist["engine"]
    image, segments, firsts = mnist["image"], mnist["segments"], mnist["firsts"]
    assert_same_outcomes(srv.eval_window_masks(image, segments, firsts, 4, TARGET),
                         engine.eval_window_masks(image, segments, firsts, 4, TARGET))
    assert all(torch.equal(srv.variables[k], v) for k, v in engine.variables.items()
               if not k.endswith("num_batches_tracked"))
    assert srv.warmup() == len(BUCKETS) * 2 + len(ATTR) - 1 + 5 + 1


def test_artifact_without_weights_takes_variables(mnist, tmp_path):
    """include_weights=False: the loader refuses to guess, and takes either
    package's weights layout (the JAX tree or a port state dict)."""
    serving.export_engine(mnist["engine"], str(tmp_path), batch_sizes=(4,),
                          include_weights=False)
    assert not os.path.exists(tmp_path / serving.WEIGHTS)
    with pytest.raises(ValueError, match="artifact has no bundled weights; pass variables="):
        serving.load_exported(str(tmp_path), device="cpu")
    image, segments, firsts = mnist["image"], mnist["segments"], mnist["firsts"][:4]
    want = mnist["server"].logits_for_windows(image, segments, firsts, 4)
    for variables in (mnist["jvars"], mnist["engine"].variables):
        srv = serving.load_exported(str(tmp_path), variables=variables, device="cpu")
        np.testing.assert_array_equal(srv.logits_for_windows(image, segments, firsts, 4), want)


def _jax_map(mnist, method, cfg):
    """The JAX package's function for ``method`` with the artifact's
    hyperparameters, on the test image at TARGET."""
    jb, v, img = mnist["jbundle"], mnist["jvars"], jnp.asarray(mnist["image"])
    if method == "gradient":
        return jgrad.input_gradient(jb.logits, v, img, TARGET)
    if method == "grad_input":
        return jgrad.grad_times_input(jb.logits, v, img, TARGET)
    if method == "integrated":
        return jgrad.integrated_gradients(jb.logits, v, img, TARGET, steps=cfg["ig_steps"])
    if method == "gradcam":
        return jgrad.gradcam(jb, v, img, TARGET, layer=cfg["gradcam_layer"])
    if method == "scorecam":
        return jgrad.scorecam(jb, v, img, TARGET, layer=cfg["gradcam_layer"],
                              channels=cfg["scorecam_channels"], batch=cfg["mask_batch"],
                              compute_dtype=jnp.float32)
    return jgrad.occlusion_map(jb.logits, v, img, TARGET, patch=cfg["occ_patch"],
                               stride=cfg["occ_stride"], batch=cfg["mask_batch"],
                               compute_dtype=jnp.float32)


@pytest.mark.parametrize("method", ["gradient", "grad_input", "integrated", "gradcam",
                                    "scorecam", "occlusion"])
def test_deterministic_attribution_matches_jax(mnist, method):
    srv = mnist["server"]
    got = srv.attribute(mnist["image"], TARGET, method)
    want = np.asarray(_jax_map(mnist, method, srv.attribution_config))
    assert got.shape == (28, 28) and got.dtype == np.float32
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_xrai_matches_jax(mnist):
    """Signed IG within 1e-4 of scale; the region ranking exactly."""
    srv = mnist["server"]
    cfg = srv.xrai_config
    assert cfg["scales"] == [float(s) for s in jxrai.adaptive_scales(28, 28)]
    got = srv.xrai(mnist["image"], TARGET)
    display = normalize_to_uint8_np(mnist["image"])
    want = jxrai.xrai_saliency(mnist["jbundle"].logits, mnist["jvars"],
                               jnp.asarray(mnist["image"]), TARGET, display, steps=cfg["steps"],
                               scales=cfg["scales"], min_area=cfg["min_area"])
    scale = float(np.abs(want.attribution).max())
    np.testing.assert_allclose(got.attribution, want.attribution, rtol=0, atol=1e-4 * scale)
    np.testing.assert_array_equal(got.heatmap, want.heatmap)
    assert got.num_regions == want.num_regions


@pytest.mark.parametrize("method", ["smoothgrad", "rise", "meaningful"])
def test_stochastic_attribution_equals_the_port_library(mnist, method):
    """Served with a seed = the port's function with that seed (the draws
    come from the port's generators, not jax.random)."""
    srv, engine = mnist["server"], mnist["engine"]
    cfg, img, seed = srv.attribution_config, mnist["image"], 7
    got = srv.attribute(img, TARGET, method, seed=seed)
    v = engine.variables
    if method == "smoothgrad":
        want = g.smoothgrad(engine.bundle.logits, v, img, TARGET, samples=cfg["sg_samples"],
                            noise_sigma=cfg["sg_sigma"], seed=seed)
    elif method == "rise":
        want = g.rise_map(engine.folded_logits, v, img, TARGET, num_masks=cfg["rise_masks"],
                          grid=cfg["rise_grid"], keep_prob=cfg["rise_keep"],
                          batch=cfg["mask_batch"], seed=seed, compute_dtype=torch.float32)
    else:
        want = learned_mask.learned_mask_saliency(
            engine.bundle.logits, v, img, TARGET, mask_size=cfg["lm_mask_size"],
            iters=cfg["lm_iters"], seed=seed).heatmap
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not np.array_equal(got, srv.attribute(img, TARGET, method, seed=seed + 1))


@pytest.mark.parametrize("method", ["integrated", "smoothgrad", "gradcam"])
def test_attribute_many_batched_equals_per_image(mnist, method):
    srv = mnist["server"]
    images = np.stack([mnist["image"], mnist["image"][::-1].copy()])
    heats, calls = srv.attribute_many(images, [TARGET, 2], method, seeds=[3, 4])
    assert calls == 1 and heats.shape == (2, 28, 28)
    for i, t in enumerate((TARGET, 2)):
        one = srv.attribute(images[i], t, method, seed=3 + i)
        np.testing.assert_allclose(heats[i], one, rtol=0, atol=1e-5 * np.abs(one).max())
    three, calls = srv.attribute_many(np.concatenate([images, images[:1]]), [TARGET, 2, 1],
                                      method, seeds=[3, 4, 5])
    assert calls == 3   # no exported image batch holds 3: one call per image
    empty, calls = srv.attribute_many(np.zeros((0, 28, 28, 1), np.float32), [], method)
    assert empty.shape == (0, 28, 28) and calls == 0


def test_attribution_refusals_are_the_jax_packages(mnist, tmp_path):
    engine, srv = mnist["engine"], mnist["server"]
    with pytest.raises(ValueError, match=r"unsupported attribution methods \['saliency'\]"):
        serving.export_engine(engine, str(tmp_path), attribution=("saliency",))
    with pytest.raises(ValueError, match=r"unknown attribution_cfg keys \['ig_step'\]"):
        serving.export_engine(engine, str(tmp_path), attribution=("gradient",),
                              attribution_cfg={"ig_step": 4})
    with pytest.raises(ValueError, match="attribution_batches needs attribution"):
        serving.export_engine(engine, str(tmp_path), attribution_batches=(2,))
    with pytest.raises(ValueError, match="must be >= 2"):
        serving.export_engine(engine, str(tmp_path), attribution=("gradient",),
                              attribution_batches=(1,))
    with pytest.raises(ValueError, match=r"target 10 out of range \[0, 10\)"):
        srv.attribute(mnist["image"], 10, "gradient")
    plain = serving.load_exported(mnist["jax_dir"], device="cpu")
    with pytest.raises(ValueError, match="artifact has no 'gradient' attribution program"):
        plain.attribute(mnist["image"], 0, "gradient")
    with pytest.raises(ValueError, match="artifact has no XRAI program"):
        plain.xrai(mnist["image"], 0)
    with pytest.raises(ValueError, match="image shape"):
        srv.logits_for_windows(np.zeros((32, 32, 1), np.float32), mnist["segments"], [0], 1)


def test_bo_explain_equals_the_library_and_jax(mnist):
    """explain: bo_window_saliency (fused) for the seed; the JAX package's
    fused loop with its trace handed in as the draws."""
    bo, engine = mnist["bo"], mnist["engine"]
    image, segments = mnist["image"], mnist["segments"]
    out, tr = bo.explain(image, segments, seed=3, target=BO_TARGET)
    ref, rtr = bo_pipeline.bo_window_saliency(engine, image, segments, BOConfig(**BO_CFG),
                                              seed=3, target=BO_TARGET)
    np.testing.assert_array_equal(tr.xp, rtr.xp)
    np.testing.assert_array_equal(tr.yp, rtr.yp)
    np.testing.assert_array_equal(out.heatmap, ref.heatmap)
    assert 0 < tr.survived.sum() < len(tr.xp), "all windows alike: a weak test"
    jout, jtr = jbo.bo_window_saliency(mnist["jengine"], image, segments, JBOConfig(**BO_CFG),
                                       seed=3, target=BO_TARGET, fused=True)
    out, tr = bo.explain(image, segments, target=BO_TARGET,
                         draws=torch.from_numpy(jtr.xp.astype(np.int64)))
    np.testing.assert_array_equal(tr.xp, jtr.xp)
    np.testing.assert_array_equal(tr.survived, jtr.survived)
    np.testing.assert_allclose(tr.yp, jtr.yp, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out.heatmap, jout.heatmap)
    assert bo.explain(image, segments, seed=3)[1].xp.tolist() == bo.explain(
        image, segments, seed=3, target=int(bo.predict_logits(image).argmax()))[1].xp.tolist()


def test_bo_explain_batch_equals_single_explains(mnist):
    """N = 3 padded to the exported 4: image i is explain(seed + i)."""
    bo, image = mnist["bo"], mnist["image"]
    images = [image, image[::-1].copy(), image * 0.5]
    segs = [mnist["segments"]] * 3
    outs = bo.explain_batch(images, segs, seed=5, targets=[BO_TARGET] * 3)
    many, calls = bo.explain_many(images, segs, per_image_seeds=[5, 6, 7],
                                  targets=[BO_TARGET] * 3)
    assert len(outs) == 3 and calls == 1
    for i, ((out, tr), (mout, mtr)) in enumerate(zip(outs, many)):
        one, one_tr = bo.explain(images[i], segs[i], seed=5 + i, target=BO_TARGET)
        for a in (tr, mtr):
            np.testing.assert_array_equal(a.xp, one_tr.xp)
            np.testing.assert_array_equal(a.survived, one_tr.survived)
            np.testing.assert_allclose(a.yp, one_tr.yp, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(out.heatmap, one.heatmap)
    single, calls = bo.explain_many(images[:1], segs[:1], per_image_seeds=[5],
                                    targets=[BO_TARGET])
    assert calls == 1 and single[0][1].xp.tolist() == outs[0][1].xp.tolist()
    logits = bo.predict_logits_batch(np.stack(images))
    np.testing.assert_allclose(logits[1], bo.predict_logits(images[1]), rtol=0, atol=1e-5)
    assert bo.explain_batch([], []) == []


def test_bo_bucket_too_small_is_the_jax_message(mnist):
    segments = blocks(cell=4)     # 49 segments: upper 29, a bucket >= 30 needed
    with pytest.raises(ValueError) as e:
        mnist["bo"].explain(mnist["image"], segments, target=BO_TARGET)
    assert str(e.value) == ("image needs a candidate bucket >= 30; exported buckets: [16] "
                            "— re-export with a larger bucket")
    with pytest.raises(ValueError, match="needs an exported image batch >= 5"):
        mnist["bo"].explain_batch([mnist["image"]] * 5, [mnist["segments"]] * 5)
    with pytest.raises(ValueError, match="explain_many needs explicit targets"):
        mnist["bo"].explain_many([mnist["image"]], [mnist["segments"]])


def test_bo_warmup_runs_every_program_without_graph_eviction(mnist):
    bo = mnist["bo"]
    assert bo.warmup() == 1 + 1 + 1 + 1      # predict, the loop, the N=4 loop, its predict
    assert sorted(bo.runners) == [(1, 16), (4, 16)]
    assert all(run.cuda_graph is False for run in bo.runners.values())


def test_cifar_manifest_without_model_entry_is_refused(mnist, tmp_path):
    """A JAX-written CIFAR ResNet manifest does not say its depth."""
    from torch_port_util import seeded_jax_variables

    jb = jcreate_model("resnet", "cifar10", depth=20)
    v = seeded_jax_variables(jb.module, jnp.zeros((1, 32, 32, 3)), 0)
    jserving.export_engine(JaxEngine(jb, v, mask_batch=1, compute_dtype=jnp.float32),
                           str(tmp_path), batch_sizes=(1,), include_weights=False)
    with pytest.raises(ValueError, match="no 'model' entry, and arch 'resnet' needs one"):
        serving.load_exported(str(tmp_path), variables={}, device="cpu")


def test_loaders_default_to_the_card(mnist, monkeypatch):
    """No device given means the card: without one the loaders raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load in (serving.load_exported, serving.load_exported_bo):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load(mnist["port_dir"])
    assert os.path.isfile(os.path.join(mnist["port_dir"], serving.BO_MANIFEST))


def test_flatten_batches_is_the_jax_packages():
    for total in (0, 1, 5, 17, 21, 255, 1000, 1300):
        for buckets in ((16, 4), (1024, 256, 32), (7,)):
            assert serving._flatten_batches(total, buckets) == list(
                jserving._flatten_batches(total, buckets))
