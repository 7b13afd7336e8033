"""The port's random-mask and GP-surrogate CLIs against the JAX package's, on
the ImageNet-localization fixture, on the CPU:

  generate_gp_training_data_imagenet  (random windows -> heatmap -> minimal mask)
  gp_superpixel_data_imagenet         (random windows -> heatmap -> Kronecker GP)
  gp_regression, gp_classification    (masks.npz or a mask PNG directory -> GP)
  generate_superpixels                (segmentation only)

Both packages run ResNet-18 in f32 on the same weights (a seeded state dict
with random BatchNorm statistics, read by each package's ``--ckpt``) and,
for the generators, on the same window starts: the port's
``torch.Generator`` starts are handed to the JAX pipeline in place of its
``jax.random`` draw. Discrete payload entries (target, segment and survive
counts, the threshold, its levels and keep flags, boxes, the GP's chosen
lengthscale) are compared exactly, and so are the masks.npz arrays; GP
losses within 1e-4 relative (the variational GP's 1e-3, see its test), the
rounded ranges within their rounding plus that share of their scale."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_interpretation_imagenet_tpu.cli import common as jcommon
from network_interpretation_imagenet_tpu.cli import generate_gp_training_data_imagenet as jgen
from network_interpretation_imagenet_tpu.cli import generate_superpixels as jsp
from network_interpretation_imagenet_tpu.cli import gp_classification as jgpc
from network_interpretation_imagenet_tpu.cli import gp_regression as jgpr
from network_interpretation_imagenet_tpu.cli import gp_superpixel_data_imagenet as jgps
from network_interpretation_imagenet_tpu.ops import masking as jmasking
from network_interpretation_imagenet_tpu_torch.cli import common
from network_interpretation_imagenet_tpu_torch.cli import generate_gp_training_data_imagenet as gen
from network_interpretation_imagenet_tpu_torch.cli import generate_superpixels as sp
from network_interpretation_imagenet_tpu_torch.cli import gp_classification as gpc
from network_interpretation_imagenet_tpu_torch.cli import gp_regression as gpr
from network_interpretation_imagenet_tpu_torch.cli import gp_superpixel_data_imagenet as gps
from network_interpretation_imagenet_tpu_torch.models import create_model
from network_interpretation_imagenet_tpu_torch.ops import masking

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "imagenet_loc")
K = 16   # image 1 at 16 masks: some threshold levels lose the prediction


def _json(out, name):
    with open(os.path.join(out, name)) as f:
        return json.load(f)


def _port_starts(key, num, total_segments, width):
    """The port's starts for seed 0 (the CLIs' default), in place of the
    JAX pipeline's ``jax.random`` draw."""
    starts = masking.sample_window_starts(torch.Generator().manual_seed(0), num,
                                          int(total_segments), int(width))
    return jnp.asarray(starts.numpy())


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """ResNet-18 weights with random BatchNorm statistics, as a torch
    checkpoint both packages read."""
    sd = create_model("resnet18").init(0)
    rng = np.random.RandomState(9)
    for k in list(sd):
        n = sd[k].shape[0] if sd[k].dim() else 0
        if k.endswith("running_mean"):
            sd[k] = torch.from_numpy((rng.randn(n) * 0.1).astype(np.float32))
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy((rng.rand(n) + 0.5).astype(np.float32))
        elif ".bn" in k or "downsample.1" in k or k.startswith("bn1"):
            if k.endswith("weight"):
                sd[k] = torch.from_numpy((rng.rand(n) + 0.5).astype(np.float32))
            elif k.endswith("bias"):
                sd[k] = torch.from_numpy((rng.randn(n) * 0.1).astype(np.float32))
    path = str(tmp_path_factory.mktemp("ckpt") / "resnet18.pth.tar")
    torch.save({"state_dict": sd}, path)
    return path


def _argv(ckpt, out, port):
    argv = ["--data", FIXTURE, "--arch", "resnet18", "--dtype", "float32", "--ckpt", ckpt,
            "--mask-batch", "8", "--num_mask_samples", str(K), "--out", out]
    return argv + (["--device", "cpu"] if port else [])


@pytest.fixture(scope="module")
def generated(ckpt, tmp_path_factory):
    """Each package's generator run once: (port out dir, JAX out dir)."""
    p_out = str(tmp_path_factory.mktemp("gen_port"))
    j_out = str(tmp_path_factory.mktemp("gen_jax"))
    gen.main(_argv(ckpt, p_out, True) + ["--save-pngs"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmasking, "sample_window_starts", _port_starts)
        jgen.main(_argv(ckpt, j_out, False))
    return p_out, j_out


def test_cli_defaults_match_jax():
    """The port's CLIs default to ResNet-18, as the JAX package's do, with
    the same mask and GP flags."""
    args = common.build_parser("").parse_args([])
    jargs = jcommon.build_parser("").parse_args([])
    for name in ("arch", "num_mask_samples", "window_fraction", "num_masked_superpixels",
                 "mask_batch", "seed"):
        assert getattr(args, name) == getattr(jargs, name), name
    assert args.arch == "resnet18"
    jp = jcommon.build_parser("")
    jcommon.add_gp_flags(jp)
    jgargs = jp.parse_args([])
    gargs = gpr.parse_args(["--masks", "m.npz"])
    for name in ("gp_mode", "grid_size", "gp_iters", "gp_lr", "gp_ckpt"):
        assert getattr(gargs, name) == getattr(jgargs, name), name
    cargs = gpc.parse_args(["--masks", "m.npz"])
    assert (cargs.grid_size, cargs.gp_iters, cargs.train_subsample) == (10, 30, 4096)


def test_generate_gp_training_data_matches_jax(generated):
    p_out, j_out = generated
    got = _json(p_out, "gp_training_data_result.json")
    want = _json(j_out, "gp_training_data_result.json")
    assert set(got) == set(want)
    for key in set(want) - {"masks_npz"}:
        assert got[key] == want[key], key
    assert os.path.basename(got["masks_npz"]) == os.path.basename(want["masks_npz"])
    keep = got["keeps_prediction"]
    assert got["mask_threshold"] is not None and 0 < sum(keep) < len(keep), "a weak test"
    assert 0 < got["correct_pred_count"] < K, "all masks alike: a weak test"
    with np.load(os.path.join(p_out, "masks.npz")) as a, \
            np.load(os.path.join(j_out, "masks.npz")) as b:
        assert set(a.files) == set(b.files)
        for name in set(a.files) - {"prob_target"}:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        np.testing.assert_allclose(a["prob_target"], b["prob_target"], rtol=0, atol=1e-5)
    assert len(os.listdir(os.path.join(p_out, "masks"))) == K
    for name in ("heatmap.png", f"index_1_threshold_{got['mask_threshold']:g}.png"):
        assert os.path.exists(os.path.join(p_out, name)), name


def test_generate_compute_writes_nothing(ckpt, tmp_path):
    args = gen.parse_args(_argv(ckpt, str(tmp_path / "o"), True) + ["--skip-threshold-search"])
    payload, result = gen.compute(args)
    assert "mask_threshold" not in payload and result["threshold"] is None
    assert not os.path.exists(tmp_path / "o")
    # --fidelity adds the deletion and insertion AUCs and, with a gt box, the pointing game.
    payload, _ = gen.compute(gen.parse_args(_argv(ckpt, str(tmp_path / "o"), True)
                                            + ["--skip-threshold-search", "--fidelity"]))
    assert {"deletion_auc", "insertion_auc", "pointing_game_hit"} <= set(payload)
    assert not os.path.exists(tmp_path / "o")


def _assert_payload_close(got, want, exact=(), close=(), rtol=1e-4):
    assert set(got) == set(want)
    for key in exact:
        assert got[key] == want[key], key
    for key in close:
        a, b = np.asarray(got[key], np.float64), np.asarray(want[key], np.float64)
        # Rounded to at most 3 or 4 decimals by the CLIs: half a unit of the last one.
        assert np.abs(a - b).max() <= 5e-4 + rtol * np.abs(b).max(), (key, a, b)


def test_gp_superpixel_data_matches_jax(ckpt, tmp_path):
    p_out, j_out = str(tmp_path / "port"), str(tmp_path / "jax")
    argv = ["--gp_iters", "8"]
    gps.main(_argv(ckpt, p_out, True) + argv)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmasking, "sample_window_starts", _port_starts)
        jgps.main(_argv(ckpt, j_out, False) + argv)
    got = _json(p_out, "gp_superpixel_result.json")
    want = _json(j_out, "gp_superpixel_result.json")
    _assert_payload_close(got, want, exact=("target", "num_segments", "survived",
                                            "gp_lengthscale"),
                          close=("gp_loss_first", "gp_loss_last", "mean_range", "var_range"))
    assert got["gp_loss_last"] < got["gp_loss_first"]
    for name in ("gp_mean.png", "gp_var.png", "gp_superpixel_result.png"):
        assert os.path.exists(os.path.join(p_out, name)), name


@pytest.mark.parametrize("source", ["port_npz", "jax_npz", "png_dir"])
def test_gp_regression_reads_either_packages_masks(generated, tmp_path, source):
    """Each package's gp_regression on the port's masks.npz, the JAX
    package's, and the port's mask PNG directory (--save-pngs)."""
    p_gen, j_gen = generated
    masks = {"port_npz": os.path.join(p_gen, "masks.npz"),
             "jax_npz": os.path.join(j_gen, "masks.npz"),
             "png_dir": os.path.join(p_gen, "masks")}[source]
    results = {}
    for name, mod, extra in (("port", gpr, ["--device", "cpu"]), ("jax", jgpr, [])):
        out = str(tmp_path / name)
        mod.main(["--masks", masks, "--gp-mode", "train+eval", "--gp-ckpt",
                  str(tmp_path / f"ckpt_{name}"), "--out", out] + extra)
        results[name] = _json(out, "gp_regression_result.json")
    got, want = results["port"], results["jax"]
    _assert_payload_close(got, want, exact=("n", "covered_pixels", "lengthscale"),
                          close=("train_losses", "mean_range", "std_range"))
    assert got["masks"] == masks and got["n"] == 224 and len(got["train_losses"]) == 20
    heat, coverage = gpr.load_mask_source(masks)
    jheat, jcoverage = jgpr.load_mask_source(type("A", (), {"masks": masks})())
    np.testing.assert_array_equal(heat, jheat)
    np.testing.assert_array_equal(coverage, jcoverage)
    assert os.path.exists(str(tmp_path / "port" / "gp_reg_result.png"))


def test_gp_regression_eval_reads_its_checkpoint(generated, tmp_path):
    masks = os.path.join(generated[0], "masks.npz")
    base = ["--masks", masks, "--gp-ckpt", str(tmp_path / "ckpt"), "--device", "cpu",
            "--gp_iters", "5"]
    with pytest.raises(SystemExit, match="no GP checkpoint"):
        gpr.compute(gpr.parse_args(base + ["--gp-mode", "eval"]))
    trained, _ = gpr.compute(gpr.parse_args(base + ["--gp-mode", "train+eval"]))
    evaluated, result = gpr.compute(gpr.parse_args(base + ["--gp-mode", "eval"]))
    assert evaluated["mean_range"] == trained["mean_range"]
    assert evaluated["std_range"] == trained["std_range"]
    assert "train_losses" not in evaluated and result["mean"].shape == (224, 224)


@pytest.mark.parametrize("binarize", ["median", "nonzero"])
def test_gp_classification_matches_jax(generated, tmp_path, binarize):
    masks = os.path.join(generated[1], "masks.npz")
    flags = ["--masks", masks, "--binarize", binarize, "--train_subsample", "1024"]
    results = {}
    for name, mod, extra in (("port", gpc, ["--device", "cpu"]), ("jax", jgpc, [])):
        out = str(tmp_path / name)
        mod.main(flags + ["--gp-ckpt", str(tmp_path / f"ckpt_{name}"), "--out", out] + extra)
        results[name] = _json(out, "gp_classification_result.json")
    got, want = results["port"], results["jax"]
    # At the reference's configuration (10 x 10 inducing points 24.8 px apart,
    # lengthscale 28) K_uu is ill-conditioned in f32: both packages' ELBOs
    # stray up to 5e-4 from float64 (test_torch_gp_surrogates.py::
    # test_vgp_reference_configuration_f32_error), hence 1e-3 here.
    _assert_payload_close(got, want, exact=("masks", "train_points", "grid_size"),
                          close=("elbo_first", "elbo_last", "prob_range"), rtol=1e-3)
    assert got["train_points"] == 1024 and got["elbo_last"] > got["elbo_first"]
    # --gp-mode eval restores the trained model and predicts the same map.
    payload, result = gpc.compute(gpc.parse_args(
        flags + ["--gp-ckpt", str(tmp_path / "ckpt_port"), "--gp-mode", "eval", "--device",
                 "cpu", "--out", str(tmp_path / "eval")]))
    assert payload["prob_range"] == got["prob_range"]
    assert result["probs"].shape == (224, 224)


@pytest.mark.parametrize("images", [False, True])
def test_generate_superpixels_matches_jax(tmp_path, images):
    """Images 1 and 2 of the fixture, through the dataset or as files."""
    argv = ["--data", FIXTURE]
    if images:
        folders = sorted(d for d in os.listdir(FIXTURE) if d.startswith("n"))[:2]
        argv += ["--images"] + [os.path.join(FIXTURE, d, os.listdir(os.path.join(FIXTURE, d))[0])
                                for d in folders]
    results = {}
    for name, mod in (("port", sp), ("jax", jsp)):
        out = str(tmp_path / name)
        mod.main(argv + ["--out", out])
        results[name] = _json(out, "superpixels.json")
        assert os.path.exists(results[name].pop("figure"))
    assert results["port"] == results["jax"]
    assert len(results["port"]["segments"]) == 2
