"""The MNIST / CIFAR side of the port against the JAX package: the MNIST CNN,
the reference's CIFAR ResNet-6N+2 and DenseNet-BC (``models/{mnist_cnn,
resnet_cifar,densenet}.py``), the MNIST / CIFAR readers and loaders
(``data/loaders.py``), the synthetic batch, and the CLI pieces for those
datasets (``cli/common.py``: ``resolve_image``, per-dataset ``min_size``,
the arch-resume flags).

Models run seeded random weights (``tests/torch_port_util.py:jax_reference``,
BatchNorm statistics random) at small depth (ResNet-8 and -20, DenseNet-BC
10 with and without bottlenecks): f32 logits within ``LOGIT_TOL`` x max
|logit|; the Grad-CAM menu, its default and the randomization stages equal
(``jax_traced``);
window and knockout survive labels exact in f32 for the MNIST CNN and the
CIFAR ResNet. Loaders read IDX and pickle files the test writes.
"""

import argparse
import gzip
import pickle
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import calibrate_bn, jax_reference, jax_traced

from network_interpretation_imagenet_tpu import models as jmodels
from network_interpretation_imagenet_tpu.cli import common as jcommon
from network_interpretation_imagenet_tpu.data import loaders as jloaders
from network_interpretation_imagenet_tpu.data import synthetic as jsynthetic
from network_interpretation_imagenet_tpu.saliency import engine as jengine
from network_interpretation_imagenet_tpu_torch.cli import common
from network_interpretation_imagenet_tpu_torch.data import loaders, synthetic
from network_interpretation_imagenet_tpu_torch.models import create_model, death_rates_for
from network_interpretation_imagenet_tpu_torch.saliency import gradient, sanity
from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
from network_interpretation_imagenet_tpu_torch.utils import convert

# f32 logits, port vs JAX: x max |logit| (measured up to 4e-7 on these nets).
LOGIT_TOL = 2e-5
# (case, arch, dataset, create_model kwargs)
CASES = (("mnist_cnn", "mnist_cnn", "mnist", {}),
         ("resnet8", "resnet", "cifar10", {"depth": 8}),
         ("resnet20_c100", "resnet", "cifar100", {"depth": 20}),
         ("densenet10", "densenet", "cifar10+", {"depth": 10}),
         ("densenet10_nobn", "densenet", "cifar10", {"depth": 10, "bn_size": 0,
                                                     "growth_rate": 6, "compression": 0.75}))


@pytest.fixture(scope="module")
def cache():
    return {}


def _case(cache, name):
    if name not in cache:
        _, arch, dataset, kw = next(c for c in CASES if c[0] == name)
        jb = jmodels.create_model(arch, dataset, **kw)
        bundle = create_model(arch, dataset, **kw)
        x = np.random.RandomState(1).rand(2, jb.input_size, jb.input_size,
                                          jb.input_channels).astype(np.float32)
        cache[name] = (bundle, jb, x) + jax_reference(jb, x, seed=0)
    return cache[name]


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_logits_cam_layers_and_stages_match_jax(cache, name):
    bundle, jb, x, variables, jlogits = _case(cache, name)
    sd = convert.from_jax(variables, bundle.module)
    logits = bundle.logits(sd, torch.from_numpy(x)).detach().numpy()
    scale = np.abs(jlogits).max()
    np.testing.assert_allclose(logits, jlogits, rtol=0, atol=LOGIT_TOL * scale)
    assert np.abs(jlogits).std() > 1e-3 * scale
    _, jmenu, jdefault, jstages = jax_traced(jb.module, jnp.asarray(x[:1]))
    menu = gradient.gradcam_target_layers(bundle, sd, x[0])
    assert menu == jmenu
    assert gradient._default_gradcam_layer(menu) == jdefault
    assert sanity.randomization_stages(bundle) == jstages


@pytest.mark.parametrize("arch,kw", [("densenet", {"depth": 10}), ("resnet", {"depth": 8}),
                                     ("vgg11", {})])
def test_nets_too_deep_for_28px_are_refused(arch, kw):
    """A net whose head pool outgrows MNIST's 28^2 (the reference's CIFAR
    DenseNet-BC and ResNet leave 7x7 under an 8x8 pool, VGG pools 28 to 0)
    has no features to classify: the port refuses to build it, and the JAX
    package's Dense initializer divides by the fan-in of 0 (ROADMAP.md
    section C)."""
    with pytest.raises(ValueError, match="too small"):
        create_model(arch, "mnist", **kw)
    jb = jmodels.create_model(arch, "mnist", **kw)
    with pytest.raises(ZeroDivisionError):
        jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    assert create_model(arch, "cifar10", **kw).input_size == 32


def test_death_rates_and_eval_mode_match_jax():
    """The reference's schedules, and eval mode adding each branch unscaled
    whatever the death rates (the JAX model at death_mode linear gives the
    logits it gives without)."""
    from network_interpretation_imagenet_tpu.models import death_rates_for as jrates

    for mode in ("none", "uniform", "linear"):
        assert death_rates_for(56, mode, 0.5) == jrates(56, mode, 0.5)
    jb = jmodels.create_model("resnet", "cifar10", depth=8, death_mode="linear")
    bundle = create_model("resnet", "cifar10", depth=8, death_mode="linear")
    assert bundle.module.death_rates == jrates(8, "linear", 0.5)
    x = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    from torch_port_util import seeded_jax_variables

    v = seeded_jax_variables(jb.module, jnp.asarray(x[:1]), 5)
    np.testing.assert_allclose(
        bundle.logits(convert.from_jax(v, bundle.module), torch.from_numpy(x)).detach().numpy(),
        np.asarray(jb.logits(v, jnp.asarray(x))), rtol=0, atol=1e-5)


def _segments(side):
    hh, ww = np.mgrid[0:side, 0:side]
    q = side // 4
    return ((hh // q) * 4 + ww // q).astype(np.int32)  # 16 segments


def _blobs(seed, side, channels):
    """Six random rectangles on black."""
    r = np.random.RandomState(seed)
    img = np.zeros((side, side, channels), np.float32)
    for _ in range(6):
        y, x = r.randint(0, side - 6, 2)
        h, w = r.randint(3, side // 2, 2)
        img[y:y + h, x:x + w] = r.rand(channels) * 3 - 1
    return img


# name -> (calibrate BatchNorm on the batch, image, window width, knockout M):
# settings under which both outcomes occur (a random net's prediction rarely moves).
WK = {"mnist_cnn": (True, "batch", 4, 1), "resnet8": (False, "blobs", 8, 5)}


@pytest.mark.parametrize("name", sorted(WK))
def test_window_and_knockout_labels_match_jax(cache, name):
    """Both engines in f32 on the same masks: survive labels and predictions
    exact, probabilities close, and both outcomes present."""
    bundle, jb, _, variables, *_ = _case(cache, name)
    calibrate, source, width, m = WK[name]
    side, ch = jb.input_size, jb.input_channels
    batch = np.random.RandomState(1).rand(8, side, side, ch).astype(np.float32)
    image = batch[1] if source == "batch" else _blobs(3, side, ch)
    sd = convert.from_jax(variables, bundle.module)
    if calibrate:
        sd = calibrate_bn(bundle, sd, batch)
        variables = convert.jax_variables(sd, bundle.module)
    segments = _segments(side)
    firsts = np.random.RandomState(4).randint(0, 16, 48).astype(np.int32)
    knock = np.random.RandomState(4).randint(0, 15, (48, m)).astype(np.int32)
    je = jengine.SaliencyEngine(jb, variables, mask_batch=20, compute_dtype=jnp.float32)
    engine = SaliencyEngine(bundle, sd, mask_batch=20, compute_dtype=torch.float32, device="cpu")
    target = engine.predict_one(image)[0]
    assert target == je.predict_one(image)[0]
    for got, want in ((engine.eval_window_masks(image, segments, firsts, width, target),
                       je.eval_window_masks(image, segments, firsts, width, target)),
                      (engine.eval_knockout_masks(image, segments, knock, target),
                       je.eval_knockout_masks(image, segments, knock, target))):
        np.testing.assert_array_equal(got.survived, want.survived)
        np.testing.assert_array_equal(got.preds, want.preds)
        np.testing.assert_allclose(got.prob_target, want.prob_target, atol=1e-5)
        assert 0 < got.survived.sum() < 48


# --- loaders -------------------------------------------------------------------------


def _write_idx(path, array):
    header = struct.pack(">HBB", 0, 8, array.ndim) + struct.pack(f">{array.ndim}I",
                                                                  *array.shape)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(header + array.astype(np.uint8).tobytes())


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    """MNIST IDX files (train gzipped, test raw), CIFAR-10 batches and
    CIFAR-100 pickles, all small and seeded."""
    rng = np.random.RandomState(0)
    root = tmp_path_factory.mktemp("data")
    mnist = root / "mnist"
    mnist.mkdir()
    for prefix, n, ext in (("train", 12, ".gz"), ("t10k", 7, "")):
        _write_idx(str(mnist / f"{prefix}-images-idx3-ubyte{ext}"),
                   rng.randint(0, 256, (n, 28, 28)))
        _write_idx(str(mnist / f"{prefix}-labels-idx1-ubyte{ext}"), rng.randint(0, 10, n))
    c10 = root / "c10" / "cifar-10-batches-py"
    c10.mkdir(parents=True)
    for name, n in [(f"data_batch_{i}", 1200) for i in range(1, 6)] + [("test_batch", 9)]:
        with open(c10 / name, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                         b"labels": list(rng.randint(0, 10, n))}, f)
    c100 = root / "c100"
    c100.mkdir()
    for name, n in (("train", 30), ("test", 6)):
        with open(c100 / name, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                         b"fine_labels": list(rng.randint(0, 100, n))}, f)
    return {"mnist": str(mnist), "cifar10": str(root / "c10"), "cifar100": str(c100)}


def test_readers_match_jax(data_dirs):
    for train in (False, True):
        for ours, theirs, d in ((loaders.load_mnist_dir, jloaders.load_mnist_dir, "mnist"),
                                (loaders.load_cifar10_dir, jloaders.load_cifar10_dir, "cifar10"),
                                (loaders.load_cifar100_dir, jloaders.load_cifar100_dir,
                                 "cifar100")):
            (x, y), (jx, jy) = ours(data_dirs[d], train), theirs(data_dirs[d], train)
            assert x.dtype == jx.dtype == np.float32 and y.dtype == jy.dtype == np.int64
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
    with pytest.raises(FileNotFoundError):
        loaders.load_mnist_dir(data_dirs["cifar100"])


def test_array_loader_and_cifar_loaders_match_jax(data_dirs):
    """The same seed gives the same batches: shuffle, "+" augmentation,
    normalization, set_epoch's re-seeding and drop_last."""
    x, y = synthetic.synthetic_classification_batch(3, 37, 32, 3, 10)
    jx, jy = jsynthetic.synthetic_classification_batch(3, 37, 32, 3, 10)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    kw = dict(shuffle=True, augment=True, mean=(0.5, 0.4, 0.3), std=(0.2, 0.3, 0.4), seed=7)
    for drop_last in (False, True):
        ours = loaders.ArrayLoader(x, y, 8, drop_last=drop_last, **kw)
        theirs = jloaders.ArrayLoader(x, y, 8, drop_last=drop_last, **kw)
        assert len(ours) == len(theirs)
        for epoch in (None, 3):
            if epoch is not None:
                ours.set_epoch(epoch)
                theirs.set_epoch(epoch)
            for _ in range(2):
                batches, jbatches = list(ours), list(theirs)
                assert len(batches) == len(jbatches)
                for (bx, by), (jbx, jby) in zip(batches, jbatches):
                    np.testing.assert_array_equal(bx, jbx)
                    np.testing.assert_array_equal(by, jby)
    for dataset in ("cifar10+", "cifar10"):
        got = loaders.get_cifar_loaders(data_dirs["cifar10"], dataset, 500, seed=1)
        want = jloaders.get_cifar_loaders(data_dirs["cifar10"], dataset, 500, seed=1)
        for ours, theirs in zip(got, want):
            assert len(ours) == len(theirs)
            for (bx, by), (jbx, jby) in zip(list(ours)[:3], list(theirs)[:3]):
                np.testing.assert_array_equal(bx, jbx)
                np.testing.assert_array_equal(by, jby)


# --- CLI pieces ----------------------------------------------------------------------


def _args(dataset, data=None, **kw):
    ns = dict(dataset=dataset, data=data, synthetic=data is None, seed=0, eval_img_index=2,
              segmenter="felzenszwalb", scale=None, sigma=0.5, min_size=None, n_segments=48)
    ns.update(kw)
    return argparse.Namespace(**ns)


@pytest.mark.parametrize("dataset", ["mnist", "cifar10", "cifar100+", "imagenet"])
def test_resolve_image_and_segment_config_match_jax(data_dirs, dataset):
    data = {"mnist": data_dirs["mnist"], "cifar10": data_dirs["cifar10"],
            "cifar100+": data_dirs["cifar100"]}.get(dataset)
    for d in ([None, data] if data else [None]):
        got = common.resolve_image(_args(dataset, d))
        want = jcommon.resolve_image(_args(dataset, d))
        for a, b in zip(got, want):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got, want = common.segment_config(_args(dataset)), jcommon.segment_config(_args(dataset))
    for field in ("method", "scale", "sigma", "min_size", "n_segments"):
        assert getattr(got, field) == getattr(want, field)
    assert common.segment_config(_args(dataset, min_size=3)).min_size == 3


def test_parser_and_arch_resume_match_jax():
    assert common.ARCH_RESUME_NAMES == jcommon.ARCH_RESUME_NAMES
    argv = ["--dataset", "cifar100", "-a", "densenet", "-d", "40", "--death-mode", "linear",
            "--death-rate", "0.2", "--growth-rate", "8", "--bn-size", "0", "--compression",
            "0.75"]
    args = common.build_parser("p").parse_args(argv)
    jargs = jcommon.build_parser("p").parse_args(argv)
    for name in common.ARCH_RESUME_NAMES + ("dataset",):
        assert getattr(args, name) == getattr(jargs, name)
    saved = {"arch": "resnet", "depth": np.int64(110), "death_rate": 0.1}
    common.apply_arch_resume(args, saved)
    jcommon.apply_arch_resume(jargs, saved)
    assert vars(args)["depth"] == vars(jargs)["depth"] == 110
    assert (args.arch, args.death_rate, args.bn_size) == ("resnet", 0.1, 0)
    common.apply_arch_resume(args, None)
    assert args.arch == "resnet"
    assert common.build_parser("p", dataset_default="mnist").parse_args([]).dataset == "mnist"
    with pytest.raises(SystemExit):
        common.build_parser("p").parse_args(["--dataset", "svhn"])
