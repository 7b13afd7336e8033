"""The attribution CLIs (compare_saliency_methods, occlusion_saliency,
attribution_sanity) and ``--fidelity`` of the flagship and generator CLIs:
the port's payloads against the JAX package's, f32 on the CPU.

Both packages read the same ResNet-18 checkpoint (seeded, random BatchNorm
statistics) and draw the same masks: the JAX package's window starts and
knockout ids are the port's ``torch.Generator`` draws, and the port's
SmoothGrad noise, RISE draws and learned-mask shifts are the JAX package's
``jax.random`` draws; the randomization of the sanity check is one state
dict given to both. Discrete entries (images, targets, degenerate counts,
stages, boxes, region counts) are compared exactly. Scores are compared
within AUC_TOL: the heatmaps agree to 1e-4 of their scale, but a fidelity
curve ranks pixels, and near-equal pixels may swap places between the
packages, which moves an AUC by about one pixel's share of a step."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_interpretation_imagenet_tpu.cli import attribution_sanity as jsanity_cli
from network_interpretation_imagenet_tpu.cli import bayesian_active_learning_imagenet as jbal
from network_interpretation_imagenet_tpu.cli import common as jcommon
from network_interpretation_imagenet_tpu.cli import compare_saliency_methods as jcompare
from network_interpretation_imagenet_tpu.cli import generate_gp_training_data_imagenet as jgen
from network_interpretation_imagenet_tpu.cli import occlusion_saliency as jocc
from network_interpretation_imagenet_tpu.ops import masking as jmasking
from network_interpretation_imagenet_tpu.saliency import sanity as jsanity
from network_interpretation_imagenet_tpu_torch.cli import attribution_sanity as sanity_cli
from network_interpretation_imagenet_tpu_torch.cli import bayesian_active_learning_imagenet as bal
from network_interpretation_imagenet_tpu_torch.cli import common
from network_interpretation_imagenet_tpu_torch.cli import compare_saliency_methods as compare
from network_interpretation_imagenet_tpu_torch.cli import generate_gp_training_data_imagenet as gen
from network_interpretation_imagenet_tpu_torch.cli import occlusion_saliency as occ
from network_interpretation_imagenet_tpu_torch.models import create_model
from network_interpretation_imagenet_tpu_torch.ops import masking
from network_interpretation_imagenet_tpu_torch.saliency import gradient as g
from network_interpretation_imagenet_tpu_torch.saliency import learned_mask as lm
from network_interpretation_imagenet_tpu_torch.saliency import sanity
from test_torch_attribution import jax_noise, jax_rise_draws
from test_torch_xrai_lm import jax_shifts
from torch_port_util import flax_resnet_variables

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "imagenet_loc")
AUC_TOL = 2e-3
# Every method at small sizes: 8 masks, 2 IG / SmoothGrad steps, 2 Adam steps.
SMALL = ["--dtype", "float32", "--mask-batch", "8", "--num_mask_samples", "8",
         "--rise-masks", "8", "--ig-steps", "2", "--sg-samples", "2", "--lm-iters", "2",
         "--lm-mask-size", "7", "--scorecam-channels", "4", "--patch", "112"]


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
def ckpt(tmp_path_factory):
    """ResNet-18 weights with random BatchNorm statistics, as a torch
    checkpoint both packages read."""
    sd = create_model("resnet18").init(0)
    rng = np.random.RandomState(9)
    for k in list(sd):
        n = sd[k].shape[0] if sd[k].dim() else 0
        if k.endswith("running_mean") or (k.endswith("bias") and not k.startswith("fc")):
            sd[k] = torch.from_numpy((rng.randn(n) * 0.1).astype(np.float32))
        elif k.endswith("running_var") or (k.endswith("weight") and sd[k].dim() == 1):
            sd[k] = torch.from_numpy((rng.rand(n) + 0.5).astype(np.float32))
    path = str(tmp_path_factory.mktemp("ckpt") / "resnet18.pth.tar")
    torch.save({"state_dict": sd}, path)
    return path


@pytest.fixture
def same_draws(monkeypatch):
    """The port's window starts and knockout ids in the JAX package, the JAX
    package's SmoothGrad, RISE and learned-mask draws in the port (seed 0,
    the CLIs' default)."""
    def starts(key, num, total, width):
        return jnp.asarray(masking.sample_window_starts(torch.Generator().manual_seed(0), num,
                                                        int(total), int(width)).numpy())

    def knock(key, num, m, total, max_s=4096):
        return jnp.asarray(masking.sample_knockout_ids(torch.Generator().manual_seed(0), num, m,
                                                       int(total)).numpy())

    monkeypatch.setattr(jmasking, "sample_window_starts", starts)
    monkeypatch.setattr(jmasking, "sample_knockout_ids", knock)
    monkeypatch.setattr(g, "smoothgrad_noise", jax_noise)
    monkeypatch.setattr(g, "rise_draws", jax_rise_draws)
    monkeypatch.setattr(lm, "learned_mask_shifts", jax_shifts)


def _json(out, name):
    with open(os.path.join(out, name)) as f:
        return json.load(f)


def _run_both(port_mod, jax_mod, argv, tmp_path, name):
    """Each package's main on ``argv``; returns (port payload, JAX payload)."""
    p_out, j_out = str(tmp_path / "port"), str(tmp_path / "jax")
    assert port_mod.main(argv + ["--device", "cpu", "--out", p_out]) in (None, 0)
    assert jax_mod.main(argv + ["--out", j_out]) in (None, 0)
    return _json(p_out, name), _json(j_out, name)


def _assert_comparison_matches(got, want):
    assert set(got) == set(want)
    for key in ("images_used", "skipped_degenerate", "gp_field", "gp_labels", "source",
                "fidelity_steps", "bootstrap"):
        assert got[key] == want[key], key
    assert set(got["methods"]) == set(want["methods"])
    for m, w in want["methods"].items():
        r = got["methods"][m]
        assert set(r) == set(w), m
        for key in ("images", "degenerate_images", "pointing_game_acc"):
            assert r.get(key) == w.get(key), (m, key)
        for key in ("mean_deletion_auc", "mean_insertion_auc", "margin_mean"):
            assert abs(r[key] - w[key]) <= AUC_TOL, (m, key, r[key], w[key])
    # Adjacent methods whose margins stand apart by more than the tolerance
    # keep their order.
    margin = {m: w["margin_mean"] for m, w in want["methods"].items()}
    pos = {m: i for i, m in enumerate(got["ranking"])}
    for a, b in zip(want["ranking"], want["ranking"][1:]):
        if margin[a] - margin[b] > 2 * AUC_TOL:
            assert pos[a] < pos[b], (a, b)


@pytest.mark.parametrize("overrides", [{}, {"rise_masks": 1000},
                                       {"sg_samples": 8, "lm_iters": 50, "lm_jitter": 2}])
def test_method_and_segment_flags_match_jax(overrides):
    """add_method_flags (with each CLI's overrides), parse_xrai_scales and the
    segmentation flags (SLIC included) have the JAX package's names and
    defaults, and give the same SegmentConfig."""
    p, jp = common.build_parser(""), jcommon.build_parser("")
    common.add_method_flags(p, **overrides)
    jcommon.add_method_flags(jp, **overrides)
    for argv in ([], ["--segmenter", "slic", "--n_segments", "30", "--xrai-scales", "5,10"]):
        args, jargs = p.parse_args(argv), jp.parse_args(argv)
        names = [a.dest for a in jp._actions if a.dest in vars(args)]
        assert len(names) > 25
        for name in names:
            assert getattr(args, name) == getattr(jargs, name), name
        cfg, jcfg = common.segment_config(args), jcommon.segment_config(jargs)
        for field in ("method", "scale", "sigma", "min_size", "n_segments", "compactness",
                      "slic_iters", "enforce_connectivity"):
            assert getattr(cfg, field) == getattr(jcfg, field), field
        assert common.parse_xrai_scales(args.xrai_scales) == jcommon.parse_xrai_scales(
            jargs.xrai_scales)


def test_compare_all_methods_synthetic_matches_jax(ckpt, same_draws, tmp_path):
    """All 16 methods on two synthetic images, with the paired bootstrap."""
    argv = ["--synthetic", "--ckpt", ckpt, "--num-images", "2", "--fidelity-steps", "4",
            "--n_iters", "1", "--n_pre_samples", "2", "--gp_iters", "2", "--gp-cls-iters", "2",
            "--gp-train-subsample", "256", "--bootstrap", "50"] + SMALL
    got, want = _run_both(compare, jcompare, argv, tmp_path, "method_comparison.json")
    _assert_comparison_matches(got, want)
    assert got["images_used"] == 2 and len(got["methods"]) == 16 == len(compare.METHODS)
    assert tuple(compare.METHODS) == tuple(jcompare.METHODS)
    assert set(got["methods"]["rise"]) >= {"margin_ci95", "seconds_per_image"}


def test_compare_fixture_jpegs_matches_jax(ckpt, same_draws, tmp_path):
    """The fixture's JPEGs through --jpeg-dir (targets are the model's own
    argmax), knockout fields with soft labels, --skip-degenerate."""
    argv = ["--jpeg-dir", FIXTURE, "--ckpt", ckpt, "--num-images", "2",
            "--methods", "field,gp,occlusion,integrated,xrai,meaningful",
            "--gp-field", "knockout", "--gp-labels", "soft", "--skip-degenerate",
            "--fidelity-steps", "4", "--gp_iters", "2", "--bootstrap", "20"] + SMALL
    got, want = _run_both(compare, jcompare, argv, tmp_path, "method_comparison.json")
    _assert_comparison_matches(got, want)
    assert got["source"] == "jpeg-dir" and got["images_used"] == 2


@pytest.mark.parametrize("method", ["occlusion", "xrai", "meaningful", "smoothgrad"])
def test_occlusion_saliency_matches_jax(ckpt, same_draws, tmp_path, method):
    """One method on the fixture's first image (gt box: IOU and box too)."""
    argv = ["--data", FIXTURE, "--ckpt", ckpt, "--method", method] + SMALL
    got, want = _run_both(occ, jocc, argv, tmp_path, f"{method}_result.json")
    assert set(got) == set(want)
    for key in ("method", "target", "num_regions"):
        assert got.get(key) == want.get(key), key
    for key in ("prob_original", "prob_masked"):
        if key in want:
            assert abs(got[key] - want[key]) <= 1e-5, key
    scale = max(abs(v) for v in want["heat_range"])
    np.testing.assert_allclose(got["heat_range"], want["heat_range"], rtol=0, atol=1e-4 * scale)
    if method in ("xrai", "occlusion"):   # heatmaps that are equal or nearly so
        assert got["pred_box_xywh"] == want["pred_box_xywh"]
        assert got["IOU"] == want["IOU"]


def test_gradcam_layer_list_matches_jax(ckpt, capsys):
    argv = ["--synthetic", "--ckpt", ckpt, "--method", "gradcam", "--gradcam-layer", "list",
            "--dtype", "float32"]
    assert occ.main(argv + ["--device", "cpu"]) == 0
    port = [ln for ln in capsys.readouterr().out.splitlines() if "(" in ln]
    jocc.main(argv)
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines() if "(" in ln]
    assert port == jax_lines and len(port) > 40 and port[0].startswith("bn1 ")


def test_attribution_sanity_matches_jax(ckpt, same_draws, tmp_path, monkeypatch):
    """The cascading test over ResNet-18's eleven stages with one random state
    dict given to both packages."""
    bundle = create_model("resnet18")
    rand = sanity.fresh_random_variables(bundle, 0)
    monkeypatch.setattr(jsanity, "fresh_random_variables",
                        lambda b, seed=0: flax_resnet_variables(rand, (2, 2, 2, 2)))
    argv = ["--synthetic", "--ckpt", ckpt, "--methods", "gradient,integrated,occlusion"] + SMALL
    got, want = _run_both(sanity_cli, jsanity_cli, argv, tmp_path, "sanity_check.json")
    assert got["target"] == want["target"]
    assert got["stages"] == want["stages"] == sanity.randomization_stages(bundle)
    assert got["stages"][0] == "fc" and len(got["stages"]) == 11
    for m in ("gradient", "integrated", "occlusion"):
        for r, w in zip(got["methods"][m], want["methods"][m]):
            assert r["randomized_through"] == w["randomized_through"]
            assert abs(r["spearman"] - w["spearman"]) <= 2e-3, (m, r, w)


def test_flagship_fidelity_matches_jax(ckpt, tmp_path):
    """--fidelity on the fixture: deletion and insertion AUC and the
    pointing game beside the BO payload (the host loop draws numpy's stream
    in both packages)."""
    argv = ["--data", FIXTURE, "--arch", "resnet18", "--ckpt", ckpt, "--dtype", "float32",
            "--n_iters", "2", "--n_pre_samples", "2", "--mask-batch", "8", "--fidelity"]
    got, want = _run_both(bal, jbal, argv, tmp_path, "bo_result.json")
    assert set(got) == set(want) >= {"deletion_auc", "insertion_auc", "pointing_game_hit"}
    assert got["bo_xp"] == want["bo_xp"] and got["pointing_game_hit"] == want["pointing_game_hit"]
    for key in ("deletion_auc", "insertion_auc"):
        assert abs(got[key] - want[key]) <= 1e-4, key
    # The batched path adds the same entries to every row.
    payload, _ = bal.explain(bal.parse_args(argv + ["--device", "cpu", "--num-images", "2",
                                                    "--out", str(tmp_path / "b")]))
    assert all({"deletion_auc", "insertion_auc", "pointing_game_hit"} <= set(row)
               for row in payload["per_image"])


def test_generator_fidelity_matches_jax(ckpt, same_draws, tmp_path):
    argv = ["--data", FIXTURE, "--ckpt", ckpt, "--dtype", "float32", "--mask-batch", "8",
            "--num_mask_samples", "16", "--fidelity", "--skip-threshold-search"]
    got, want = _run_both(gen, jgen, argv, tmp_path, "gp_training_data_result.json")
    assert set(got) == set(want) >= {"deletion_auc", "insertion_auc", "pointing_game_hit"}
    assert got["pointing_game_hit"] == want["pointing_game_hit"]
    for key in ("deletion_auc", "insertion_auc"):
        assert abs(got[key] - want[key]) <= 1e-4, key
