"""Felzenszwalb-Huttenlocher segmentation: native C++ kernel + numpy plain version.

Port of ``segment/felzenszwalb.py:felzenszwalb`` of the JAX package. The
serial union-find is host work: ``native/felzenszwalb.cc`` (the JAX
package's source, unchanged) is compiled with ``g++`` at first use into
``_build/`` and loaded with ctypes. A failed build raises; the numpy
implementation runs only when asked for (``backend="numpy"``) and is the
plain version the tests hold the native one against. Gaussian pre-smoothing
happens here (scipy) so both consume identical inputs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from network_interpretation_imagenet_tpu_torch.segment.common import relabel_sequential

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "native", "felzenszwalb.cc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# No -march=native: _build/ may be copied to another machine with the
# checkout, and a library tuned to one CPU can fault on another.
_CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _load_native() -> ctypes.CDLL:
    """Build (once per source hash) and load the C++ kernel; raises on failure."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        with open(_SOURCE, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(_CXXFLAGS).encode()).hexdigest()[:16]
        path = os.path.join(_BUILD_DIR, f"libfelzenszwalb-{digest}.so")
        if not os.path.isfile(path):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            proc = subprocess.run(["g++", *_CXXFLAGS, "-o", tmp, _SOURCE],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"building {_SOURCE} failed:\n{proc.stderr[-4000:]}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        lib.felzenszwalb_segment.restype = ctypes.c_int32
        lib.felzenszwalb_segment.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_float, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return lib


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


def felzenszwalb(image: np.ndarray, scale: float = 100.0, sigma: float = 0.5,
                 min_size: int = 50, backend: str = "native") -> np.ndarray:
    """Segment an image; returns int32[H, W] contiguous labels.

    ``image``: uint8 or float [H, W] / [H, W, C]; uint8 scales to [0, 1]
    (``img_as_float``, as the reference). ``backend``: ``"native"`` (C++)
    or ``"numpy"`` (the plain version)."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img = _smooth(img.astype(np.float32), sigma)
    if backend == "numpy":
        return _felzenszwalb_numpy(img, scale, min_size)
    if backend != "native":
        raise ValueError(f"unknown backend {backend!r}")
    lib = _load_native()
    h, w, c = img.shape
    img_c = np.ascontiguousarray(img, np.float32)
    out = np.empty(h * w, np.int32)
    lib.felzenszwalb_segment(
        img_c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w, c,
        ctypes.c_float(scale), ctypes.c_int32(min_size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out.reshape(h, w)
