"""B1: the masked classifier batch, built in one kernel.

Counterpart of the TPU kernel ``ops/pallas_masking.py:49``
(``masked_batch_pallas``). :func:`masked_batch` launches
``csrc/masked_batch.cu`` for CUDA tensors and takes :func:`masked_batch_plain`
(window masks, multiply, cast) only for CPU tensors. Both are bit-identical:
the product is f32 and rounds once. The kernel writes a group of masks per
block; :func:`launch_plan` sizes the group and the grid. Each mask row's
body leaves in 16-byte stores at the row's own address, whatever H*W*C or
the ``out=`` slice: :func:`row_plan` picks the kernel's instance and its
walk over rows by residue, and :func:`row_shift`, :func:`residue_classes`
and :func:`thread_stores` model that split of a row into head, body and
tail.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.ops import _cuda_build, masking

_SIG = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_ENTRY = {torch.bfloat16: "masked_batch_bf16", torch.float32: "masked_batch_f32"}

THREADS = 256        # per block; each thread owns 8 elements of the image, in 16-byte words
PER_THREAD = 8
MAX_GROUP = 64       # masks per block, the kernel's shared-memory table of starts
_TARGET_BLOCKS = 4 * 132   # a few blocks per SM of the H100


def launch_plan(k: int, hwc: int) -> tuple:
    """(group, grid_x, grid_y): grid_x blocks cover the H*W*C elements, and
    each block writes ``group`` masks, as many as still leave about four
    blocks per SM, at most 64. At 224x224x3 and K=256 that is 32 masks,
    128 KB of bf16 per block, in a 74 x 8 grid."""
    grid_x = -(-hwc // (PER_THREAD * THREADS))
    rows = -(-_TARGET_BLOCKS // grid_x)
    group = min(MAX_GROUP, -(-k // rows))
    return group, grid_x, -(-k // group)


def row_shift(out_offset: int, k, hwc: int, itemsize: int):
    """Elements of mask row ``k`` (an int or an array of rows) before its
    first 16-byte boundary: the row's head, which the kernel writes with
    scalar stores. ``out_offset`` is the output's address in elements
    (``out.data_ptr() // itemsize``)."""
    return (-(out_offset + np.asarray(k, np.int64) * hwc)) % (16 // itemsize)


def aligned(out_offset: int, hwc: int, itemsize: int) -> bool:
    """Whether every row starts on a 16-byte boundary, so that the kernel's
    instance at shift 0 (8 image values a thread, one row loop) runs."""
    v = 16 // itemsize
    return out_offset % v == 0 and hwc % v == 0


def row_period(hwc: int, itemsize: int) -> int:
    """The fewest rows whose H*W*C elements fill whole 16-byte words: rows
    this many apart start at the same residue mod 16 bytes."""
    v = 16 // itemsize
    return next(p for p in range(1, v + 1) if p * (hwc % v) % v == 0)


def row_plan(out_offset: int, hwc: int, itemsize: int) -> tuple:
    """(aligned, period) as the wrapper hands them to the kernel, for an
    output ``out_offset`` elements into memory (``out.data_ptr() //
    itemsize``): 1 takes the instance at shift 0, 0 the shifted one, which
    walks a block's rows by residue class, ``period`` rows apart."""
    return int(aligned(out_offset, hwc, itemsize)), row_period(hwc, itemsize)


def residue_classes(out_offset: int, k0: int, nk: int, hwc: int, itemsize: int) -> list:
    """The kernel's walk over one block's rows ``k0 .. k0 + nk - 1``: a list
    of ``(shift, rows)``, one per residue class of the rows' addresses mod
    16 bytes, each class's rows ``period`` apart (the fewest rows whose
    H*W*C elements fill whole 16-byte words)."""
    is_aligned, period = row_plan(out_offset, hwc, itemsize)
    if is_aligned:
        return [(0, range(k0, k0 + nk))]
    return [(int(row_shift(out_offset, k0 + q, hwc, itemsize)), range(k0 + q, k0 + nk, period))
            for q in range(min(period, nk))]


def thread_stores(shift: int, hwc: int, grid_x: int, itemsize: int) -> tuple:
    """The stores of one row whose first 16-byte boundary lies ``shift``
    elements in, as the kernel makes them: (row elements where its 16-byte
    stores start, row elements it writes with scalar stores). Each warp owns
    256 elements, lane l's word q at ``warp_start + q * 32 * v + l * v``
    (``v`` elements to 16 bytes), moved up by ``shift``; a lane whose first
    word starts past the row does nothing. A whole word is one 16-byte
    store, what of a partial one lies in the row scalar stores; thread 0
    also writes the head ``[0, shift)``."""
    v = 16 // itemsize
    t = np.arange(grid_x * THREADS, dtype=np.int64)
    i0 = (t - t % 32) * PER_THREAD + (t % 32) * v
    i0 = i0[i0 < hwc]
    words = (shift + i0[:, None] + 32 * v * np.arange(PER_THREAD // v)).ravel()
    whole = words + v <= hwc
    part = (words[~whole][:, None] + np.arange(v)).ravel()
    return words[whole], np.concatenate([np.arange(min(shift, hwc)), part[part < hwc]])


def masked_batch_plain(image, segments, firsts, width, out_dtype=torch.bfloat16):
    """Plain PyTorch version: ``apply_masks(image, window_masks(...))`` cast to
    ``out_dtype``."""
    masks = masking.window_masks(segments, firsts, width)
    return masking.apply_masks(image, masks).to(out_dtype)


def masked_batch(image: torch.Tensor, segments: torch.Tensor, firsts: torch.Tensor,
                 width, out_dtype=torch.bfloat16, out: torch.Tensor = None) -> torch.Tensor:
    """f32[H, W, C] image, int32[H, W] contiguous labels, int32[K] starts,
    width -> ``out_dtype``[K, H, W, C] (bf16 or f32), NHWC contiguous.
    ``width`` is an int, or an int32 tensor of one element on the image's
    device, which the kernel reads there (a CUDA graph then holds no width).
    ``out``, a contiguous tensor of that shape, dtype and device (for example
    one image's slice of a larger batch, at any mask offset), receives the
    result in place of a new tensor; one whose address is not a whole
    number of elements raises."""
    if image.dim() != 3 or segments.shape != image.shape[:2] or firsts.dim() != 1:
        raise ValueError(f"masked_batch: shapes image {tuple(image.shape)}, segments "
                         f"{tuple(segments.shape)}, firsts {tuple(firsts.shape)}")
    shape = (firsts.shape[0], *image.shape)
    if out is not None and (tuple(out.shape) != shape or out.dtype != out_dtype
                            or out.device != image.device or not out.is_contiguous()):
        raise ValueError(f"masked_batch: out must be a contiguous {out_dtype} tensor of shape "
                         f"{shape} on {image.device}, got {out.dtype} {tuple(out.shape)} on "
                         f"{out.device}")
    if out is not None and out.data_ptr() % out.element_size():
        raise ValueError(f"masked_batch: out's address {out.data_ptr():#x} is not "
                         f"{out.element_size()}-byte aligned")
    if image.device.type == "cpu":
        result = masked_batch_plain(image, segments, firsts, width, out_dtype)
        return result if out is None else out.copy_(result)
    checks = [("image", image, torch.float32), ("segments", segments, torch.int32),
              ("firsts", firsts, torch.int32)]
    width_dev = width if isinstance(width, torch.Tensor) else None
    if width_dev is not None:
        if width_dev.numel() != 1:
            raise ValueError(f"masked_batch: a width tensor holds one element, got "
                             f"{tuple(width_dev.shape)}")
        checks.append(("width", width_dev, torch.int32))
    for name, t, dtype in checks:
        if t.device != image.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"masked_batch: {name} must be a contiguous {dtype} "
                             f"tensor on {image.device}, got {t.dtype} on {t.device}")
    if out_dtype not in _ENTRY:
        raise ValueError(f"masked_batch: out_dtype {out_dtype} not supported")
    h, w, c = image.shape
    k = firsts.shape[0]
    if not 0 < k <= 65535 or h * w * c >= 2**31:
        raise ValueError(f"masked_batch: K={k} or H*W*C={h * w * c} out of range")
    if out is None:
        out = torch.empty(shape, dtype=out_dtype, device=image.device)
    lib = _cuda_build.library("masked_batch", {e: _SIG for e in _ENTRY.values()})
    rc = getattr(lib, _ENTRY[out_dtype])(
        _cuda_build.ptr(image), _cuda_build.ptr(segments), _cuda_build.ptr(firsts),
        0 if width_dev is not None else int(width),
        None if width_dev is None else _cuda_build.ptr(width_dev), _cuda_build.ptr(out), k,
        h * w * c, c, *launch_plan(k, h * w * c),
        *row_plan(out.data_ptr() // out.element_size(), h * w * c, out.element_size()),
        _cuda_build.stream_ptr(image.device))
    _cuda_build.check(rc, "masked_batch")
    masked_batch.launches += 1
    return out


masked_batch.launches = 0
