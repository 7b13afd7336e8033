"""The native Felzenszwalb kernel (``native/felzenszwalb.cc``'s
``felzenszwalb_image``) against its yardsticks: the numpy plain version
(``backend="numpy"``: scipy's smoothing, then ``_felzenszwalb_numpy``) and
the JAX package's native kernel, the design it replaced. Every comparison is
exact: labels equal, smoothed images equal bit for bit. Also the per-thread
workspace: results independent of what a thread segmented before, threads
apart, and the ``segment`` span's ``workspace`` attribute."""

import importlib
import itertools
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from network_interpretation_imagenet_tpu_torch.config import SegmentConfig
from network_interpretation_imagenet_tpu_torch.segment import common
from network_interpretation_imagenet_tpu_torch.segment import felzenszwalb as felz
from network_interpretation_imagenet_tpu_torch.utils import logging as trace

jfelz = importlib.import_module("network_interpretation_imagenet_tpu.segment.felzenszwalb")

SIGMAS = (0.0, 0.5, 1.3)        # radius none, 2 and 5 (wider than a 3-pixel side)
SCALES = (1.0, 100.0, 500.0)
MIN_SIZES = (1, 50)


def _picture(seed: int, size: int = 224) -> np.ndarray:
    """A uint8 [size, size, 3] picture like the benchmark's: coloured
    ellipses on a gradient and a two-tone box, quantized to uint8."""
    rng = np.random.RandomState(seed)
    grid = np.arange(size, dtype=np.float32) / (size - 1.0)
    yy, xx = np.meshgrid(grid, grid, indexing="ij")
    img = np.stack([0.2 + 0.5 * xx, 0.3 + 0.4 * yy, 0.6 - 0.3 * xx * yy], axis=-1)
    for _ in range(12):
        cy, cx, ry, rx = rng.rand(4)
        inside = ((yy - cy) / (ry * 0.08 + 0.02)) ** 2 + ((xx - cx) / (rx * 0.08 + 0.02)) ** 2 < 1
        img[inside] = rng.rand(3)
    bw, bh = rng.randint(size * 72 // 224, size * 136 // 224 + 1, 2)
    x0, y0 = rng.randint(0, size - bw), rng.randint(0, size - bh)
    img[y0:y0 + bh, x0:x0 + bw] = (0.9, 0.2, 0.1)
    img[y0:y0 + bh // 2, x0:x0 + bw] = (0.1, 0.7, 0.3)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _assert_all_equal(img, sigma, scale, min_size, jax_too=True):
    got = felz.felzenszwalb(img, scale, sigma, min_size)
    np.testing.assert_array_equal(
        got, felz.felzenszwalb(img, scale, sigma, min_size, backend="numpy"),
        err_msg=f"numpy, sigma={sigma} scale={scale} min_size={min_size}")
    if jax_too:
        np.testing.assert_array_equal(
            got, jfelz.felzenszwalb(img, scale=scale, sigma=sigma, min_size=min_size,
                                    backend="native"),
            err_msg=f"JAX native, sigma={sigma} scale={scale} min_size={min_size}")
    assert got.dtype == np.int32 and got.min() == 0
    assert got.max() + 1 == len(np.unique(got))


@pytest.mark.parametrize("seed", [0, 1, 2147484101])
def test_native_equals_plain_on_pictures(seed):
    img = _picture(seed)
    _assert_all_equal(img, 0.5, 100.0, 50)
    # Every scale and min_size, against the kernel it replaced (the plain
    # version at 224^2 costs a second or two a call).
    for sigma, scale, min_size in itertools.product(SIGMAS, SCALES, MIN_SIZES):
        np.testing.assert_array_equal(
            felz.felzenszwalb(img, scale, sigma, min_size),
            jfelz.felzenszwalb(img, scale=scale, sigma=sigma, min_size=min_size,
                               backend="native"))


@pytest.mark.parametrize("shape", [(1, 9), (9, 1), (2, 2), (3, 7), (17, 5)])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_native_equals_plain_on_odd_shapes(shape, channels):
    img = np.random.RandomState(sum(shape) * channels).randint(
        0, 256, (*shape, channels)).astype(np.uint8)
    for sigma, scale, min_size in itertools.product(SIGMAS, SCALES, MIN_SIZES):
        _assert_all_equal(img, sigma, scale, min_size)


def test_native_equals_plain_at_299():
    _assert_all_equal(_picture(7, 299), 0.5, 100.0 * 299 * 299 / (224 * 224), 50)


@pytest.mark.parametrize("kind", ["constant", "two_level"])
@pytest.mark.parametrize("shape", [(1, 6), (5, 1), (3, 7), (23, 19, 3)])
def test_native_equals_plain_on_ties(kind, shape):
    """A constant image: every weight 0, ties everywhere. Two levels, 0 and
    255: mass ties at one non-zero weight (unsmoothed; in one channel it is
    1.0, so at scale 1 it equals a single pixel's threshold), and a handful
    of weights repeated everywhere (smoothed)."""
    img = np.zeros(shape, np.uint8)
    if kind == "two_level":
        img[(np.indices(shape[:2]).sum(axis=0) % 3) == 0] = 255
    for sigma, scale, min_size in itertools.product(SIGMAS, SCALES, MIN_SIZES):
        _assert_all_equal(img, sigma, scale, min_size)


@pytest.mark.parametrize("shape", [(13, 11), (13, 11, 3), (6, 9, 4)])
def test_native_equals_plain_on_float_images(shape):
    """Float input goes in as float32, unscaled, as the plain version takes it."""
    img = np.random.RandomState(3).rand(*shape)
    for sigma, scale in itertools.product(SIGMAS, (0.5, 5.0)):
        _assert_all_equal(img, sigma, scale, 3)
        _assert_all_equal(img.astype(np.float32), sigma, scale, 3)


# --- the smoothing twin ------------------------------------------------------


@pytest.mark.parametrize("h,w", list(itertools.product(range(1, 5), repeat=2)) + [(31, 24)])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_smoothing_equals_scipy_bit_for_bit(h, w, dtype):
    """Sides of 1-4 pixels fold the reflect border more than once (sigma 3
    has radius 12)."""
    rng = np.random.RandomState(h * 10 + w)
    for c, sigma in itertools.product((1, 3, 4), (0.0, 0.3, 0.5, 1.3, 3.0)):
        if dtype == "uint8":
            img = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
        else:
            img = (rng.standard_normal((h, w, c)) * 3).astype(np.float32)
        want = felz._smoothed(img, sigma)
        got = felz.smooth_native(img, sigma)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                      err_msg=f"c={c} sigma={sigma}")


# --- the per-thread workspace --------------------------------------------------


def _in_fresh_thread(fn):
    """fn() on a new thread, whose workspace starts empty; its result."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # re-raised on the test's thread
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    if "error" in out:
        raise out["error"]
    return out["value"]


def test_workspace_reuse_across_sizes_changes_no_result():
    """224^2, 299^2, 5x3 and 224^2 again on one thread: each equals the plain
    version, and the workspace grows only for an image larger than any
    before it."""
    pictures = [_picture(11), _picture(12, 299), _picture(13)[:5, :3], _picture(11)]
    cfgs = [(100.0, 50), (178.0, 50), (1.0, 2), (100.0, 50)]
    got = _in_fresh_thread(lambda: [felz.felzenszwalb_native(p, [s], 0.5, [m])
                                    for p, (s, m) in zip(pictures, cfgs)])
    assert [ws for _, ws in got] == ["grown", "grown", "reused", "reused"]
    plain = {}
    for i, (p, (s, m)) in enumerate(zip(pictures, cfgs)):
        key = (p.shape, s, m, p.tobytes())
        if key not in plain:
            plain[key] = felz.felzenszwalb(p, s, 0.5, m, backend="numpy")
        np.testing.assert_array_equal(got[i][0][0], plain[key], err_msg=f"call {i}")


def test_segment_image_batch_threads_equal_serial_calls():
    displays = [_picture(100 + i) for i in range(16)]
    cfg = SegmentConfig()
    serial = [common.segment_image(d, cfg) for d in displays]
    with ThreadPoolExecutor(max_workers=8) as pool:
        for _ in range(2):   # the second round on warm workspaces
            batched = common.segment_image_batch(displays, cfg)
            assert len(batched) == 16
            for a, b in zip(batched, serial):
                np.testing.assert_array_equal(a, b)
            # Eight threads at once on workspaces of their own.
            for a, b in zip(pool.map(lambda d: common.segment_image(d, cfg), displays), serial):
                np.testing.assert_array_equal(a, b)


def test_segment_span_reports_the_workspace():
    trace.disable()
    trace.clear()
    trace.enable()
    try:
        cfg = SegmentConfig()
        _in_fresh_thread(lambda: [common.segment_image(_picture(21 + i), cfg)
                                  for i in range(3)])
        spans = [s for s in trace.spans() if s.name == "segment"]
    finally:
        trace.disable()
        trace.clear()
    assert [s.attrs["workspace"] for s in spans] == ["grown", "reused", "reused"]


@pytest.mark.parametrize("sigma", SIGMAS)
def test_ladder_equals_per_scale_calls(sigma):
    img = _picture(31, 96)
    scales, min_sizes = (20.0, 60.0, 150.0, 500.0), (5, 6, 15, 50)
    ladder = felz.felzenszwalb_ladder(img, scales, sigma=sigma, min_sizes=min_sizes)
    assert len(ladder) == len(scales)
    for got, s, m in zip(ladder, scales, min_sizes):
        np.testing.assert_array_equal(got, felz.felzenszwalb(img, s, sigma, m))
        np.testing.assert_array_equal(
            got, jfelz.felzenszwalb(img, scale=s, sigma=sigma, min_size=m, backend="native"))


def test_rejects_images_it_cannot_take():
    for bad in (np.zeros((0, 4), np.uint8), np.zeros((4, 0, 3), np.uint8),
                np.zeros((2, 2, 2, 2), np.uint8), np.zeros(5, np.uint8)):
        with pytest.raises(ValueError):
            felz.felzenszwalb(bad)
