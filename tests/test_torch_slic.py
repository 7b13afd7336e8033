"""SLIC superpixels, their connectivity pass and the SLIC branch of the
segmentation dispatcher: port vs JAX package on the CPU.

The k-means labels are compared pixel for pixel. Both packages compute the
squared distances ||p||^2 + ||c||^2 - 2 p.c in f32 with products in full f32
but in their own summation order, so a pixel whose two nearest centres stand
within f32 rounding of each other may go either way: the test allows such a
pixel only when the port's own two smallest d^2 tie within D2_TIE of their
magnitude, and names it. The connectivity pass and the relabelling are
integer work and equal exactly."""

import importlib
import os

import numpy as np
import pytest
import torch

from network_interpretation_imagenet_tpu.config import SegmentConfig as JSegmentConfig
from network_interpretation_imagenet_tpu.segment import common as jcommon
from network_interpretation_imagenet_tpu_torch.config import SegmentConfig
from network_interpretation_imagenet_tpu_torch.data.imagenet_loc import ImagenetLocalizationDataset
from network_interpretation_imagenet_tpu_torch.data.synthetic import synthetic_imagenet_image
from network_interpretation_imagenet_tpu_torch.ops.preprocess import to_display_uint8
from network_interpretation_imagenet_tpu_torch.segment import common, slic

jslic = importlib.import_module("network_interpretation_imagenet_tpu.segment.slic")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "imagenet_loc")
D2_TIE = 1e-6   # relative: a few f32 ulps of the distances' magnitude


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
def displays():
    ds = ImagenetLocalizationDataset(FIXTURE, crop=64)
    disps = [to_display_uint8(torch.from_numpy(ds[i][0])).numpy() for i in range(3)]
    synth = (np.clip(synthetic_imagenet_image(3, 96), 0, 1) * 255).astype(np.uint8)
    return disps + [synth]


def _tied(disp, n_segments, pixels):
    """Whether each pixel's two smallest d^2 (the port's, after the same
    iterations) tie within D2_TIE of their magnitude."""
    imgs, lab = slic._as_batch([disp], "cpu")
    pix, centers = slic.slic_features(imgs, n_segments, 10.0, lab)
    for _ in range(10):
        labels = torch.argmin(slic.slic_distances(pix, centers), dim=2)
        onehot = torch.nn.functional.one_hot(labels, centers.shape[1]).float()
        counts = onehot.sum(dim=1)[:, :, None]
        sums = torch.bmm(onehot.transpose(1, 2), pix)
        centers = torch.where(counts > 0, sums / counts.clamp(min=1.0), centers)
    d2 = slic.slic_distances(pix, centers)[0]
    w = disp.shape[1]
    out = []
    for y, x in pixels:
        two = torch.sort(d2[y * w + x]).values[:2]
        out.append(bool(two[1] - two[0] <= D2_TIE * two[1].abs().clamp(min=1.0)))
    return out


@pytest.mark.parametrize("n_segments", [16, 48])
def test_slic_labels_match_jax(displays, n_segments):
    for i, disp in enumerate(displays):
        got = slic.slic(disp, n_segments=n_segments, device="cpu").numpy()
        want = np.asarray(jslic.slic(disp, n_segments=n_segments))
        diff = list(zip(*np.nonzero(got != want)))
        if diff:
            ties = _tied(disp, n_segments, diff)
            named = [f"image {i} pixel {p}" for p, tie in zip(diff, ties)]
            assert all(ties), f"labels differ beyond a d^2 tie at {named}"
            print("tied pixels:", named)
        assert len(diff) <= 2
        gh, gw = slic._grid_shape(*disp.shape[:2], n_segments)
        assert got.max() < gh * gw and len(np.unique(got)) > gh * gw // 2


def test_slic_batch_equals_single_calls(displays):
    batch = slic.slic_batch(displays[:3], n_segments=20, device="cpu")
    for disp, got in zip(displays[:3], batch):
        assert torch.equal(got, slic.slic(disp, n_segments=20, device="cpu"))
    gray = displays[0][:, :, 0]
    np.testing.assert_array_equal(slic.slic(gray, n_segments=9, device="cpu").numpy(),
                                  np.asarray(jslic.slic(gray, n_segments=9)))


def test_rgb_to_lab_matches_jax():
    rgb = np.random.RandomState(0).rand(50, 3).astype(np.float32)
    rgb[:3] = [[0, 0, 0], [1, 1, 1], [0.04, 0.5, 0.9]]
    np.testing.assert_allclose(slic.rgb_to_lab(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jslic.rgb_to_lab(rgb)), rtol=0, atol=1e-4)


@pytest.mark.parametrize("min_fraction", [0.25, 0.7])
def test_enforce_connectivity_matches_jax(min_fraction):
    """The native pass and the JAX package's agree on fragmented maps."""
    rng = np.random.RandomState(1)
    labels = np.repeat(np.repeat(rng.randint(0, 6, size=(8, 8)), 4, 0), 4, 1).astype(np.int32)
    labels[rng.rand(32, 32) < 0.05] = 2   # islands
    want = jslic.enforce_connectivity(labels, min_fraction)
    assert not np.array_equal(want, labels), "nothing merged: a weak test"
    np.testing.assert_array_equal(slic.enforce_connectivity(labels, min_fraction), want)
    flat = np.arange(16, dtype=np.int32).reshape(4, 4)
    np.testing.assert_array_equal(slic.enforce_connectivity(flat), flat)


def test_segment_image_slic_matches_jax(displays):
    """The dispatcher's SLIC branch (k-means, connectivity, relabelling) and
    its batch, against the JAX package's."""
    cfg = SegmentConfig(method="slic", n_segments=24)
    jcfg = JSegmentConfig(method="slic", n_segments=24)
    got = [common.segment_image(d, cfg, device="cpu") for d in displays]
    want = [jcommon.segment_image(d, jcfg) for d in displays]
    for g_, w_ in zip(got, want):
        assert (g_ != w_).mean() <= 2e-3   # a boundary tie moves at most a pixel or two
        assert g_.min() == 0 and len(np.unique(g_)) == g_.max() + 1
    batch = common.segment_image_batch(displays[:3], cfg, device="cpu")
    for a, b in zip(batch, got[:3]):
        np.testing.assert_array_equal(a, b)
    no_cc = common.segment_image(displays[0], SegmentConfig(method="slic", n_segments=24,
                                                            enforce_connectivity=False),
                                 device="cpu")
    assert no_cc.shape == displays[0].shape[:2]
    with pytest.raises(ValueError, match="unknown segmentation"):
        common.segment_image(displays[0], SegmentConfig(method="watershed"))
