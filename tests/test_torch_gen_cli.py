"""The MNIST and CIFAR generators (``cli/generate_gp_training_data_{mnist,
cifar}.py``) against the JAX package's CLIs, ``--mode gp-data``, f32 on the
CPU: the same flags and defaults, and on the same weights (a weights
artifact the port writes, which both read) and the same knockout draws (the
JAX package's sampler patched to the port's, seed 0), the same
``masks.npz`` and result JSON. Every array of ``masks.npz`` is exact but
``prob_max``, a softmax of logits that the two packages' convolutions round
differently, which is held within 1e-6. The training modes train one epoch
in both packages from the same initial weights, and gp-data then runs from
each one's checkpoint.
"""

import json
import os
import shutil
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import calibrate_bn, seeded_jax_variables, torch_threads

from network_interpretation_imagenet_tpu import models as jmodels
from network_interpretation_imagenet_tpu.cli import generate_gp_training_data_cifar as jcifar
from network_interpretation_imagenet_tpu.cli import generate_gp_training_data_mnist as jmnist
from network_interpretation_imagenet_tpu.ops import masking as jmasking
from network_interpretation_imagenet_tpu_torch.cli import generate_gp_training_data_cifar as cifar
from network_interpretation_imagenet_tpu_torch.cli import generate_gp_training_data_mnist as mnist
from network_interpretation_imagenet_tpu_torch.models import create_model
from network_interpretation_imagenet_tpu_torch.ops import masking
from network_interpretation_imagenet_tpu_torch.utils import convert

# name -> (port CLI, JAX CLI, arch, dataset, extra argv, result file)
GENERATORS = {
    "mnist": (mnist, jmnist, "mnist_cnn", "mnist", ["--eval_img_index", "2"],
              "mnist_gp_data_result.json"),
    "cifar": (cifar, jcifar, "resnet", "cifar10+", ["--synthetic", "-d", "8"],
              "cifar_gp_data_result.json"),
}
# Weights seed, and BatchNorm statistics measured on the data: settings under
# which the knockouts move the prediction (86 and 136 of 160 survive).
WEIGHTS = {"mnist": (1, True), "cifar": (2, False)}


def _mnist_dir(tmp_path):
    """An MNIST test set of four "digits" (bright rectangles on black) as IDX
    files, which Felzenszwalb cuts into 7-9 segments."""
    r = np.random.RandomState(0)
    images = np.zeros((4, 28, 28), np.uint8)
    for i in range(4):
        for _ in range(5):
            y, x = r.randint(2, 20, 2)
            h, w = r.randint(2, 8, 2)
            images[i, y:y + h, x:x + w] = r.randint(80, 256)
    d = tmp_path / "mnist"
    d.mkdir()
    for name, arr in (("t10k-images-idx3-ubyte", images), ("t10k-labels-idx1-ubyte",
                                                            np.arange(4))):
        header = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(f">{arr.ndim}I", *arr.shape)
        (d / name).write_bytes(header + arr.astype(np.uint8).tobytes())
    return str(d), images[..., None].astype(np.float32) / 255.0


def same_knockouts_patch(monkeypatch):
    """The port's knockout ids (seed 0, the CLIs' default) in the JAX package."""
    def knock(key, num, m, total, max_s=4096):
        return jnp.asarray(masking.sample_knockout_ids(torch.Generator().manual_seed(0), num, m,
                                                       int(total)).numpy())

    monkeypatch.setattr(jmasking, "sample_knockout_ids", knock)


@pytest.fixture
def same_knockouts(monkeypatch):
    same_knockouts_patch(monkeypatch)


def _artifact(tmp_path, arch, dataset, depth, seed, images=None):
    """Seeded weights (BatchNorm statistics measured on ``images`` where
    given) written as an artifact by the port."""
    bundle = create_model(arch, dataset, depth=depth)
    jb = jmodels.create_model(arch, dataset, depth=depth)
    side, ch = bundle.input_size, bundle.input_channels
    variables = seeded_jax_variables(jb.module, jnp.zeros((1, side, side, ch)), seed)
    sd = convert.from_jax(variables, bundle.module)
    if images is not None:
        sd = calibrate_bn(bundle, sd, images)
    path = str(tmp_path / "weights")
    convert.save_weights_artifact(convert.jax_variables(sd, bundle.module), path,
                                  meta={"arch": arch, "dataset": dataset, "depth": depth})
    return path


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_gp_data_matches_jax(tmp_path, same_knockouts, name):
    port, jax_cli, arch, dataset, extra, result = GENERATORS[name]
    seed, calibrate = WEIGHTS[name]
    if name == "mnist":
        data, images = _mnist_dir(tmp_path)
        extra = extra + ["--data", data]
    ckpt = _artifact(tmp_path, arch, dataset, 8, seed, images if calibrate else None)
    out = str(tmp_path / "out")
    argv = ["--dtype", "float32", "--ckpt", ckpt, "--num_mask_samples", "160",
            "--mask-batch", "64", "--out", out] + extra
    jax_cli.main(argv)
    shutil.move(out, out + "_jax")
    port.main(argv + ["--device", "cpu"])
    got, want = _json(os.path.join(out, result)), _json(os.path.join(out + "_jax", result))
    assert got == want
    assert 0 < got["correct_pred_count"] < 160
    _same_masks(out, out + "_jax")
    assert os.path.exists(os.path.join(out, "heatmap.png"))


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_flags_defaults_and_training_modes(name, monkeypatch, tmp_path):
    """Every flag of the JAX CLI (its XLA-only debug flags aside) with the
    same default and ``--device`` defaulting to the card; then the training
    mode (``train-nn`` / ``train``) for one epoch on synthetic data from the
    same initial weights in both packages (the JAX bundle's ``init`` patched
    to the port's), and ``--mode gp-data`` from each one's ``model_best``
    checkpoint. The training results agree (losses within 1e-4 relative:
    eight SGD steps compound f32 rounding; error rates exactly), and so do
    the gp-data results, ``masks.npz`` as in ``test_gp_data_matches_jax``
    but ``prob_max`` within 1e-5: the two packages' trained weights differ
    in the fifth digit."""
    port, jax_cli, arch, dataset, *_ = GENERATORS[name]

    def parsed(args):
        raise _Parsed(vars(args))

    monkeypatch.setattr(jax_cli.common, "apply_debug_flags", parsed)
    with pytest.raises(_Parsed) as e:
        jax_cli.main([])
    want = {k: v for k, v in e.value.args[0].items()
            if k not in ("debug_nans", "compilation_cache", "platform", "local_devices")}
    args = vars(port.parse_args([]))
    assert {k: args[k] for k in want} == want
    assert args["device"] == "cuda" and args["mode"] == "gp-data"
    assert args["arch"] == ("mnist_cnn" if name == "mnist" else "resnet")
    assert args["num_mask_samples"] == 1000
    assert args["num_masked_superpixels"] == (1 if name == "mnist" else 5)
    assert args["dataset"] == ("mnist" if name == "mnist" else "cifar10+")
    train = "train-nn" if name == "mnist" else "train"
    monkeypatch.undo()
    same_knockouts_patch(monkeypatch)
    bundle = create_model(arch, dataset, depth=8)
    variables = convert.jax_variables(bundle.init(0), bundle.module)
    monkeypatch.setattr(jmodels.ModelBundle, "init",
                        lambda self, key, train=False: jax.tree.map(jnp.asarray, variables))
    # ResNet-8 at its default lr 0.1 parts from JAX by one of 128 val images in 8 steps.
    depth = ["-d", "8", "--lr", "0.01"] if name == "cifar" else []
    out = {side: str(tmp_path / side) for side in ("port", "jax")}
    jax_cli.main(["--mode", train, "--epochs", "1", "--out", out["jax"]] + depth)
    with torch_threads(1):
        port.main(["--mode", train, "--epochs", "1", "--device", "cpu", "--out", out["port"]]
                  + depth)
    result = f"{name}_train_result.json"
    got, want = (_json(os.path.join(out[side], result)) for side in ("port", "jax"))
    if name == "mnist":
        assert got["epochs"] == want["epochs"] == 1
        for g, w in zip(got["history"], want["history"]):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4 if "loss" in k else 0,
                                           err_msg=k)
        ckpt = "saved_checkpoints/mnist/model_best"
    else:
        assert {k: v for k, v in got.items() if k != "save_dir"} == \
            {k: v for k, v in want.items() if k != "save_dir"}
        ckpt = "saved_checkpoints/cifar10+-resnet-8/model_best"
    argv = ["--synthetic", "--dtype", "float32", "--num_mask_samples", "64",
            "--mask-batch", "64"] + depth[:2]
    jax_cli.main(argv + ["--ckpt", os.path.join(out["jax"], ckpt), "--out", out["jax"]])
    port.main(argv + ["--ckpt", os.path.join(out["port"], ckpt), "--device", "cpu",
                      "--out", out["port"]])
    result = GENERATORS[name][-1]
    got, want = (_json(os.path.join(out[side], result)) for side in ("port", "jax"))
    assert got.pop("masks_npz") == os.path.join(out["port"], "masks.npz")
    assert want.pop("masks_npz") == os.path.join(out["jax"], "masks.npz")
    assert got == want
    _same_masks(out["port"], out["jax"], prob_tol=1e-5)


def _json(path):
    with open(path) as f:
        return json.load(f)


def _same_masks(got_dir, want_dir, prob_tol=1e-6):
    with np.load(os.path.join(got_dir, "masks.npz")) as a, \
            np.load(os.path.join(want_dir, "masks.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            if k == "prob_max":
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=prob_tol)
            else:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name,lane", [("mnist", ["--mode", "knockout"]),
                                       ("cifar", ["--image-batch", "2"])])
def test_sweep_cli_on_mnist_and_cifar_matches_jax(tmp_path, name, lane):
    """The sweep CLI with ``--dataset mnist`` / ``cifar10+`` on synthetic
    images: the same result as the JAX package's, the wall-clock keys aside."""
    from network_interpretation_imagenet_tpu.cli import saliency_sweep as jsweep
    from network_interpretation_imagenet_tpu_torch.cli import saliency_sweep as sweep

    _, _, arch, dataset, *_ = GENERATORS[name]
    ckpt = _artifact(tmp_path, arch, dataset, 8, WEIGHTS[name][0])
    argv = ["--synthetic", "--dataset", dataset, "--arch", arch, "-d", "8", "--ckpt", ckpt,
            "--dtype", "float32", "--num-images", "2", "--num_mask_samples", "24",
            "--mask-batch", "16"] + lane
    sweep.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port")])
    jsweep.main(argv + ["--out", str(tmp_path / "jax")])
    results = []
    for side in ("port", "jax"):
        with open(tmp_path / side / "sweep_result.json") as f:
            results.append({k: v for k, v in json.load(f).items()
                            if k not in ("p50_latency_s", "evals_per_sec")})
    assert results[0] == results[1]
    assert results[0]["images_explained"] == 2
