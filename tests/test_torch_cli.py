"""The port's flagship CLI (cli/bayesian_active_learning_imagenet.py) on the
ImageNet-localization fixture, on the CPU: it writes bo_result.json with the
JAX package's payload keys, the heatmap and the panel figure."""

import json
import os

import numpy as np
import pytest
import torch

from network_interpretation_imagenet_tpu.data import labels as jlabels
from network_interpretation_imagenet_tpu.data.imagenet_loc import (
    ImagenetLocalizationDataset as JaxDataset,
)
from network_interpretation_imagenet_tpu.ops import colormap as jcolormap
from network_interpretation_imagenet_tpu.saliency import viz as jviz
from network_interpretation_imagenet_tpu_torch.cli import bayesian_active_learning_imagenet as cli
from network_interpretation_imagenet_tpu_torch.cli import common
from network_interpretation_imagenet_tpu_torch.data import labels
from network_interpretation_imagenet_tpu_torch.data.imagenet_loc import ImagenetLocalizationDataset
from network_interpretation_imagenet_tpu_torch.ops import colormap
from network_interpretation_imagenet_tpu_torch.saliency import viz
from network_interpretation_imagenet_tpu_torch.utils import convert

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "imagenet_loc")
ARGS = ["--data", FIXTURE, "--arch", "resnet50", "--dtype", "float32", "--device", "cpu",
        "--n_iters", "2", "--n_pre_samples", "2"]

# The JAX CLI's payloads (network_interpretation_imagenet_tpu/cli/
# bayesian_active_learning_imagenet.py:78-91 and :160-211), with gt boxes.
SINGLE_KEYS = {"eval_img_index", "target", "num_segments", "bo_xp", "bo_yp", "survived",
               "time_duration_s", "IOU", "pred_box_xywh", "gt_box_xywh"}
BATCHED_KEYS = {"num_images", "per_image", "time_duration_s", "ms_per_image"}
ROW_KEYS = {"eval_img_index", "target", "num_segments", "survived", "best_start", "IOU"}


def _result(out):
    with open(os.path.join(out, "bo_result.json")) as f:
        return json.load(f)


def test_cli_single_image(tmp_path):
    out = str(tmp_path)
    cli.main(ARGS + ["--out", out, "--save-pngs"])
    r = _result(out)
    assert set(r) == SINGLE_KEYS
    assert len(r["bo_xp"]) == len(r["bo_yp"]) == 4
    assert max(r["bo_xp"]) <= int(0.6 * r["num_segments"]) and 0.0 <= r["IOU"] <= 1.0
    for name in ("heatmap.png", "index_1.png", "masks"):
        assert os.path.exists(os.path.join(out, name))
    assert len(os.listdir(os.path.join(out, "masks"))) == 4


def test_cli_num_images(tmp_path):
    out = str(tmp_path)
    cli.main(ARGS + ["--out", out, "--num-images", "2", "--fused"])
    r = _result(out)
    assert set(r) == BATCHED_KEYS and r["num_images"] == 2
    assert [set(row) for row in r["per_image"]] == [ROW_KEYS, ROW_KEYS]
    assert [row["eval_img_index"] for row in r["per_image"]] == [1, 2]
    for name in ("heatmap_1.png", "heatmap_2.png", "index_1.png", "index_2.png"):
        assert os.path.exists(os.path.join(out, name))


def test_explain_runs_without_writing(tmp_path):
    """``explain`` is the whole computation; nothing is written until
    ``write_artifacts``. The synthetic image needs no dataset."""
    args = cli.parse_args(["--synthetic", "--arch", "resnet50", "--dtype", "float32",
                           "--device", "cpu", "--n_iters", "1", "--n_pre_samples", "2",
                           "--fused", "--out", str(tmp_path / "o")])
    payload, outputs = cli.explain(args)
    assert set(payload) == SINGLE_KEYS - {"IOU", "pred_box_xywh", "gt_box_xywh"}
    assert len(payload["bo_xp"]) == 3 and len(outputs) == 1
    assert not os.path.exists(tmp_path / "o")
    # --fidelity adds the deletion and insertion AUCs (no gt box: no pointing game).
    payload, _ = cli.explain(cli.parse_args(["--synthetic", "--arch", "resnet50", "--dtype",
                                             "float32", "--device", "cpu", "--n_iters", "1",
                                             "--n_pre_samples", "2", "--fidelity"]))
    assert set(payload) == SINGLE_KEYS - {"IOU", "pred_box_xywh", "gt_box_xywh"} | {
        "deletion_auc", "insertion_auc"}
    assert 0.0 <= payload["deletion_auc"] <= 1.0 and 0.0 <= payload["insertion_auc"] <= 1.0


def test_ckpt_reads_torch_state_dicts_only(tmp_path):
    """A torch checkpoint's ``state_dict`` entry loads with DataParallel's
    ``module.`` prefix stripped; a ``--ckpt`` that is neither a torch file,
    an artifact nor a checkpoint directory raises (the other formats are
    held in tests/test_torch_weights.py)."""
    sd = {"conv1.weight": torch.ones(2, 3), "fc.bias": torch.zeros(2)}
    path = str(tmp_path / "ckpt.pth.tar")
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}, "epoch": 3}, path)
    got = convert.load_state_dict(path)
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    args = cli.parse_args(["--synthetic", "--arch", "resnet18", "--device", "cpu",
                           "--ckpt", str(tmp_path / "weights.msgpack")])
    with pytest.raises(FileNotFoundError):
        common.build_engine(args)


def test_dataset_and_figures_match_jax():
    ds, jds = ImagenetLocalizationDataset(FIXTURE), JaxDataset(FIXTURE)
    assert len(ds) == len(jds) == 3
    for i in range(3):
        (img, label, gt), (jimg, jlabel, jgt) = ds[i], jds[i]
        np.testing.assert_array_equal(img, jimg)
        assert label == jlabel
        np.testing.assert_array_equal(gt, jgt)
    gray = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(colormap.apply_jet(gray), np.asarray(jcolormap.apply_jet(gray)))
    seg = (np.arange(64).reshape(8, 8) // 9).astype(np.int32)
    np.testing.assert_array_equal(viz.mark_boundaries(gray[:8, :8], seg),
                                  jviz.mark_boundaries(gray[:8, :8], seg))


def test_class_names_match_jax(tmp_path):
    (tmp_path / "LOC_synset_mapping.txt").write_text("n02 goldfish\nn01 tench, Tinca tinca\n")
    names = labels.load_imagenet_class_names(str(tmp_path))
    assert names == jlabels.load_imagenet_class_names(str(tmp_path)) == {
        0: "tench, Tinca tinca", 1: "goldfish"}
    assert labels.load_imagenet_class_names(None) == {}
    for label, dataset in ((3, "cifar10"), (12, "cifar10"), (7, "mnist"), (1, "imagenet"),
                           (5, "imagenet"), (40, "cifar100")):
        assert labels.class_name(label, dataset, names) == jlabels.class_name(label, dataset, names)
