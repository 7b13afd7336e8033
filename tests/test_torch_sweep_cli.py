"""The port's sweep CLI (cli/saliency_sweep.py) against the JAX package's,
f32 on the CPU.

Both packages read one ResNet-18 checkpoint (seeded, random BatchNorm
statistics). The window and knockout lanes draw their masks on the host from
numpy's RandomState in both packages, so their results are compared key for
key, the wall-clock keys (``p50_latency_s``, ``evals_per_sec``) aside. The
BO, attribution, journal and GP-surrogate lanes run the port alone; the
sweeps under them are held to the JAX package in tests/test_torch_sweep.py.
Flag conflicts must fail with the JAX package's messages."""

import json
import os

import numpy as np
import pytest
import torch

from network_interpretation_imagenet_tpu.cli import saliency_sweep as jcli
from network_interpretation_imagenet_tpu_torch.cli import saliency_sweep as cli
from network_interpretation_imagenet_tpu_torch.models import create_model

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "imagenet_loc")
SMALL = ["--dtype", "float32", "--mask-batch", "8", "--num_mask_samples", "8",
         "--num-images", "2"]
TIMED = ("p50_latency_s", "evals_per_sec")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


def _result(out):
    with open(os.path.join(out, "sweep_result.json")) as f:
        return json.load(f)


def _port(argv, out):
    cli.main(argv + ["--device", "cpu", "--out", out])
    return _result(out)


@pytest.mark.parametrize("lane", [
    ["--synthetic"],
    ["--synthetic", "--mode", "knockout", "--num-knockout", "2", "--image-batch", "2"],
    # Labelled images, misclassified by the random net: the skip path.
    ["--data", FIXTURE, "--num-images", "3", "--workers", "2"]])
def test_window_and_knockout_results_match_jax(ckpt, tmp_path, lane):
    argv = SMALL + ["--ckpt", ckpt] + lane
    got = _port(argv, str(tmp_path / "port"))
    jcli.main(argv + ["--out", str(tmp_path / "jax")])
    want = _result(str(tmp_path / "jax"))
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in TIMED} == \
        {k: v for k, v in want.items() if k not in TIMED}
    assert got["images_total"] == int(lane[lane.index("--num-images") + 1]
                                      if "--num-images" in lane else 2)
    assert got["evals_per_sec"] > 0 or got["images_explained"] == 0
    journal = os.path.join(str(tmp_path / "port"), "sweep_journal.jsonl")
    jjournal = os.path.join(str(tmp_path / "jax"), "sweep_journal.jsonl")
    assert open(journal).readline() == open(jjournal).readline()   # the config stamp


def test_bo_lane_with_gp_passes(ckpt, tmp_path):
    """--bo over a flush of two synthetic images, then both GP passes: the
    artifacts hold one fit per explained image."""
    out = str(tmp_path / "bo")
    got = _port(SMALL + ["--ckpt", ckpt, "--synthetic", "--bo", "--image-batch", "2",
                         "--n_iters", "1", "--n_pre_samples", "2", "--gp-heatmaps",
                         "--gp_iters", "2", "--gp-class-heatmaps", "--gp-class-iters", "2",
                         "--grid_size", "3"], out)
    assert (got["images_total"], got["images_explained"], got["images_failed"]) == (2, 2, 0)
    assert 0.0 <= got["mean_survival"] <= 1.0 and got["evals_per_sec"] > 0
    for key, field in (("gp_heatmaps", "gp_mean"), ("gp_class_heatmaps", "survive_proba")):
        assert got[key]["images"] == 2 and got[key]["artifact"] == f"{key}.npz"
        arrays = np.load(os.path.join(out, f"{key}.npz"))
        assert list(arrays["indices"]) == [0, 1]
        assert arrays[field].shape == arrays["heatmaps"].shape == (2, 224, 224)
        assert np.isfinite(arrays[field]).all()


@pytest.mark.parametrize("method,extra", [
    ("rise", ["--rise-masks", "8", "--rise-grid", "4", "--attr-mask-batch", "8"]),
    ("gradient", ["--heatmap-wire", "u8", "--fidelity", "--fidelity-steps", "2"]),
    ("smoothgrad", ["--sg-samples", "2", "--uint8-wire", "--heatmap-wire", "f16"])])
def test_attribute_lanes(ckpt, tmp_path, method, extra):
    got = _port(SMALL + ["--ckpt", ckpt, "--synthetic", "--attribute", method,
                         "--image-batch", "2"] + extra, str(tmp_path / method))
    assert (got["images_total"], got["images_explained"], got["images_failed"]) == (2, 2, 0)
    assert got["evals_per_sec"] > 0 and got["mean_survival"] == 0.0
    if "--fidelity" in extra:
        assert 0.0 <= got["mean_deletion_auc"] <= 1.0 and 0.0 <= got["mean_insertion_auc"] <= 1.0


def test_journal_resume_equals_an_uninterrupted_run(ckpt, tmp_path):
    """A sweep of one image, resumed to three, reports what a three-image run
    reports; the resume never re-explains the journaled image."""
    argv = SMALL[:-2] + ["--ckpt", ckpt, "--data", FIXTURE, "--image-batch", "1"]
    full = _port(argv + ["--num-images", "3"], str(tmp_path / "full"))
    journal = str(tmp_path / "j.jsonl")
    _port(argv + ["--num-images", "1", "--journal", journal], str(tmp_path / "part"))
    resumed = _port(argv + ["--num-images", "3", "--journal", journal, "--resume"],
                    str(tmp_path / "resumed"))
    assert {k: v for k, v in resumed.items() if k not in TIMED} == \
        {k: v for k, v in full.items() if k not in TIMED}
    events = [json.loads(line) for line in open(journal)]
    assert events[0]["event"] == "config"
    assert sorted(e["index"] for e in events[1:]) == [0, 1, 2]
    with pytest.raises(ValueError, match="journal config mismatch"):
        _port(argv + ["--num-images", "3", "--journal", journal, "--resume", "--seed", "1"],
              str(tmp_path / "other"))


@pytest.mark.parametrize("flags", [
    ["--bo", "--attribute", "gradient"],
    ["--uint8-wire"],
    ["--heatmap-wire", "f16"],
    ["--attribute", "meaningful", "--heatmap-wire", "f16"],
    ["--attribute", "xrai", "--heatmap-wire", "u8"]])
def test_flag_conflicts_fail_with_jax_messages(capsys, flags):
    errors = []
    for parse in (cli.parse_args, jcli.main):
        with pytest.raises(SystemExit) as exc:
            parse(["--synthetic"] + flags)
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1] and ": error: " in errors[0]


def test_multihost_flags_are_not_ported(capsys):
    """The multi-process flags are ported now (tests/test_torch_parallel.py
    drives them): they parse, and --multihost with no coordinator anywhere
    exits 2 with the JAX package's error, naming torch.distributed."""
    for flag in ("--multihost", "--data-parallel"):
        assert getattr(cli.parse_args(["--synthetic", flag]), flag[2:].replace("-", "_"))
    assert cli.main(["--synthetic", "--multihost", "--device", "cpu"]) == 2
    assert "--multihost could not initialize torch.distributed" in capsys.readouterr().err
