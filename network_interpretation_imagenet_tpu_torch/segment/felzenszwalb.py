"""Felzenszwalb-Huttenlocher segmentation: native C++ kernel + numpy plain version.

Port of ``segment/felzenszwalb.py`` of the JAX package: ``felzenszwalb``,
XRAI's multi-scale ``felzenszwalb_ladder``, and the native helpers of SLIC's
connectivity pass (``label_components``, ``slic_postpass_native``). The
serial union-find is host work: ``native/felzenszwalb.cc``, the port's own
redesign of the JAX package's kernel, is built at first use by
``ops/_cuda_build.py`` (``g++``, into ``_build/``) and loaded with ctypes.
It runs one pass from the image to the labels (smoothing, edges, sort,
union-find) over buffers each thread keeps between calls. A failed build raises; the numpy implementation (scipy's
smoothing, then ``_felzenszwalb_numpy``) runs only when asked for
(``backend="numpy"``) and is the yardstick the tests hold the native kernel
to, bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np

from network_interpretation_imagenet_tpu_torch.ops import _cuda_build
from network_interpretation_imagenet_tpu_torch.segment.common import relabel_sequential

_I32P, _F32P = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
_F64P, _I32 = ctypes.POINTER(ctypes.c_double), ctypes.c_int32
_SIGNATURES = {
    "felzenszwalb_image": [ctypes.c_void_p, _I32, _I32, _I32, _I32, _F64P, _I32, _F32P, _I32P,
                           _I32, _I32P],
    "felzenszwalb_smooth": [ctypes.c_void_p, _I32, _I32, _I32, _I32, _F64P, _I32, _F32P],
    "label_components": [_I32P, _I32, _I32, _I32P],
    "slic_postpass": [_I32P, _I32, _I32, ctypes.c_float, _I32P],
    "xrai_greedy_rank": [_F64P, _I32P, _I32, _I32, _I32, _F32P],
}


def _load_native() -> ctypes.CDLL:
    """The native kernel, built once per source hash; raises on failure."""
    return _cuda_build.library("felzenszwalb", _SIGNATURES)


def _smooth(img: np.ndarray, sigma: float) -> np.ndarray:
    """Per-channel gaussian smoothing (sigma in pixels, reflect boundary)."""
    from scipy import ndimage

    img = np.ascontiguousarray(img, np.float32)
    if sigma <= 0:
        return img
    out = np.empty_like(img)
    for ch in range(img.shape[2]):
        ndimage.gaussian_filter(img[:, :, ch], sigma, output=out[:, :, ch], mode="reflect")
    return out


def _edges_8conn(h: int, w: int):
    """8-connectivity edge lists in the order the C++ kernel emits them (pixel
    raster-major, then right/down/down-right/down-left). With stable sorts on
    both sides, equal-weight ties resolve identically, so the two backends
    agree bit for bit."""
    idx = np.arange(h * w, dtype=np.int32).reshape(h, w)
    n = h * w
    a4 = np.full((n, 4), -1, np.int32)
    b4 = np.full((n, 4), -1, np.int32)
    flat = idx.ravel()
    for d, (sa, sb) in enumerate((
        ((slice(None), slice(None, -1)), (slice(None), slice(1, None))),      # right
        ((slice(None, -1), slice(None)), (slice(1, None), slice(None))),      # down
        ((slice(None, -1), slice(None, -1)), (slice(1, None), slice(1, None))),  # down-right
        ((slice(None, -1), slice(1, None)), (slice(1, None), slice(None, -1))),  # down-left
    )):
        m = np.zeros((h, w), bool)
        m[sa] = True
        a4[flat[m.ravel()], d] = idx[sa].ravel()
        b4[flat[m.ravel()], d] = idx[sb].ravel()
    valid = a4.ravel() >= 0
    return a4.ravel()[valid], b4.ravel()[valid]


def _felzenszwalb_numpy(img: np.ndarray, scale: float, min_size: int) -> np.ndarray:
    """Plain numpy FH (edges vectorized, union-find in Python: fine for
    test-sized images; the C++ kernel covers 224^2)."""
    h, w, c = img.shape
    a, b = _edges_8conn(h, w)
    flat = img.reshape(-1, c)
    weights = np.sqrt(((flat[a] - flat[b]) ** 2).sum(axis=1))
    order = np.argsort(weights, kind="stable")
    a, b, weights = a[order], b[order], weights[order]

    n = h * w
    parent = np.arange(n, dtype=np.int32)
    size = np.ones(n, np.int32)
    # float32 like the C++ kernel, so the merge threshold rounds identically.
    internal = np.zeros(n, np.float32)
    scale32 = np.float32(scale)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    def merge(ra: int, rb: int, wt: float) -> None:
        if size[ra] < size[rb]:
            ra, rb = rb, ra
        parent[rb] = ra
        size[ra] += size[rb]
        internal[ra] = wt

    for i in range(len(a)):
        ra, rb = find(int(a[i])), find(int(b[i]))
        if ra == rb:
            continue
        wt = weights[i]
        ta = internal[ra] + scale32 / np.float32(size[ra])
        tb = internal[rb] + scale32 / np.float32(size[rb])
        if wt <= ta and wt <= tb:
            merge(ra, rb, wt)

    for i in range(len(a)):
        ra, rb = find(int(a[i])), find(int(b[i]))
        if ra != rb and (size[ra] < min_size or size[rb] < min_size):
            merge(ra, rb, weights[i])

    roots = np.fromiter((find(int(p)) for p in range(n)), np.int32, n)
    return relabel_sequential(roots.reshape(h, w))


def _gaussian_taps(sigma):
    """The centre and right half (float64 [r + 1]) of the taps that
    ``scipy.ndimage.gaussian_filter(x, sigma)`` smooths with: its
    ``_gaussian_kernel1d`` at ``truncate=4.0``, by the same numpy
    expressions. Empty where it leaves the image as it is."""
    if not float(sigma) > 1e-15:
        return np.empty(0, np.float64)
    radius = int(4.0 * float(sigma) + 0.5)
    sigma2 = sigma * sigma
    x = np.arange(-radius, radius + 1)
    phi_x = np.exp(-0.5 / sigma2 * x ** 2)
    phi_x = phi_x / phi_x.sum()
    return np.ascontiguousarray(phi_x[radius:])


def _native_image(image: np.ndarray):
    """``image`` as the native kernel reads it: a C-contiguous [H, W, C]
    array, uint8 as it is and anything else as float32, and whether it is
    uint8."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or 0 in img.shape or img.shape[0] * img.shape[1] >= 1 << 30:
        raise ValueError(f"felzenszwalb takes a non-empty [H, W] or [H, W, C] image of "
                         f"fewer than 2^30 pixels, not shape {np.shape(image)}")
    u8 = img.dtype == np.uint8
    return np.ascontiguousarray(img, np.uint8 if u8 else np.float32), u8


def felzenszwalb_native(image: np.ndarray, scales, sigma: float, min_sizes):
    """The native kernel over ``image`` (as :func:`felzenszwalb` takes it):
    one int32[H, W] label map per (scale, min_size), each equal to the numpy
    plain version's, and what the calling thread's workspace did for the
    call, ``"grown"`` or ``"reused"``."""
    img, u8 = _native_image(image)
    h, w, c = img.shape
    taps = _gaussian_taps(sigma)
    scales = np.ascontiguousarray(scales, np.float32)
    min_sizes = np.ascontiguousarray(min_sizes, np.int32)
    labels = np.empty((len(scales), h, w), np.int32)
    grew = _load_native().felzenszwalb_image(
        img.ctypes.data, int(u8), h, w, c, _ptr(taps, ctypes.c_double), len(taps) - 1,
        _ptr(scales, ctypes.c_float), _ptr(min_sizes, ctypes.c_int32), len(scales),
        _ptr(labels, ctypes.c_int32))
    if grew < 0:
        raise RuntimeError(f"felzenszwalb_image refused shape {img.shape}")
    return list(labels), "grown" if grew else "reused"


def smooth_native(image: np.ndarray, sigma: float) -> np.ndarray:
    """The native kernel's Gaussian pre-smoothing alone: float32 [H, W, C],
    bit for bit :func:`_smooth` of ``image`` scaled as :func:`felzenszwalb`
    scales it."""
    img, u8 = _native_image(image)
    taps = _gaussian_taps(sigma)
    out = np.empty(img.shape, np.float32)
    if _load_native().felzenszwalb_smooth(img.ctypes.data, int(u8), *img.shape,
                                          _ptr(taps, ctypes.c_double), len(taps) - 1,
                                          _ptr(out, ctypes.c_float)) < 0:
        raise RuntimeError(f"felzenszwalb_smooth refused shape {img.shape}")
    return out


def _smoothed(image: np.ndarray, sigma: float) -> np.ndarray:
    """The numpy plain version's input: float32 [H, W, C], uint8 scaled to
    [0, 1] (``img_as_float``, as the reference), smoothed by scipy."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    return _smooth(img.astype(np.float32), sigma)


def felzenszwalb(image: np.ndarray, scale: float = 100.0, sigma: float = 0.5,
                 min_size: int = 50, backend: str = "native") -> np.ndarray:
    """Segment an image; returns int32[H, W] contiguous labels.

    ``image``: uint8 or float [H, W] / [H, W, C]; uint8 scales to [0, 1]
    (``img_as_float``, as the reference). ``backend``: ``"native"`` (C++)
    or ``"numpy"`` (the plain version)."""
    if backend == "native":
        return felzenszwalb_native(image, [scale], sigma, [min_size])[0][0]
    if backend != "numpy":
        raise ValueError(f"unknown backend {backend!r}")
    return _felzenszwalb_numpy(_smoothed(image, sigma), scale, min_size)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def label_components(labels: np.ndarray):
    """4-connectivity connected components of an int32 label map (pixels join
    iff adjacent and equal), by the native kernel: ``(comp int32[H, W],
    n_components)`` with contiguous ids in raster first-occurrence order."""
    lib = _load_native()
    labels = np.ascontiguousarray(labels, np.int32)
    h, w = labels.shape
    out = np.empty(h * w, np.int32)
    n = lib.label_components(_ptr(labels, ctypes.c_int32), h, w, _ptr(out, ctypes.c_int32))
    return out.reshape(h, w), int(n)


def slic_postpass_native(labels: np.ndarray, min_fraction: float) -> np.ndarray:
    """The native SLIC connectivity pass (components, keep rule, adjacency
    absorption; the spec is ``segment.slic.enforce_connectivity``'s): the
    absorbed int32 label map, not relabelled."""
    lib = _load_native()
    labels = np.ascontiguousarray(labels, np.int32)
    h, w = labels.shape
    out = np.empty(h * w, np.int32)
    lib.slic_postpass(_ptr(labels, ctypes.c_int32), h, w, ctypes.c_float(min_fraction),
                      _ptr(out, ctypes.c_int32))
    return out.reshape(h, w)


def felzenszwalb_ladder(image: np.ndarray, scales, sigma: float = 0.5, min_sizes=None,
                        backend: str = "native") -> list:
    """Multi-scale FH oversegmentation (XRAI's ladder): the smoothing, the
    edge build and the sort are shared by every scale, only the union-find
    passes repeat, and each scale's labels equal ``felzenszwalb(image, s,
    sigma, m)``'s. ``min_sizes`` defaults to XRAI's ``max(round(s / 10),
    5)``. Returns a list of int32[H, W] contiguous label maps, one per scale.
    ``backend="numpy"`` runs the plain version per scale."""
    scales = [float(s) for s in scales]
    if min_sizes is None:
        min_sizes = [max(int(round(s / 10.0)), 5) for s in scales]
    min_sizes = [int(m) for m in min_sizes]
    if len(min_sizes) != len(scales):
        raise ValueError(f"min_sizes length {len(min_sizes)} != scales {len(scales)}")
    if not scales:
        return []
    if backend == "numpy":
        img = _smoothed(image, sigma)
        return [_felzenszwalb_numpy(img, s, m) for s, m in zip(scales, min_sizes)]
    if backend != "native":
        raise ValueError(f"unknown backend {backend!r}")
    return felzenszwalb_native(image, scales, sigma, min_sizes)[0]


def xrai_greedy_rank_native(attr: np.ndarray, ids: np.ndarray, min_area: int):
    """The native XRAI greedy ranking (``native/felzenszwalb.cc``): f64 [H*W]
    attribution and int32 [scales, H*W] zero-based segment ids -> (f32
    [H*W] rank heat, number of regions)."""
    lib = _load_native()
    flat = np.ascontiguousarray(attr, np.float64)
    ids = np.ascontiguousarray(ids, np.int32)
    out = np.empty(flat.size, np.float32)
    n = lib.xrai_greedy_rank(_ptr(flat, ctypes.c_double), _ptr(ids, ctypes.c_int32),
                             ctypes.c_int32(ids.shape[0]), ctypes.c_int32(flat.size),
                             ctypes.c_int32(int(min_area)), _ptr(out, ctypes.c_float))
    if n < 0:
        raise RuntimeError("xrai_greedy_rank failed")
    return out, int(n)
