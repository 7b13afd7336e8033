"""P1: Inception-v3's 3x3 pools of a channels_last activation, in one kernel.

Replaces no TPU kernel: the JAX package's pools are XLA's ``reduce_window``.
:func:`pool_nhwc` launches ``csrc/pool_nhwc.cu`` for every CUDA tensor and
takes :func:`pool_nhwc_plain` (``F.avg_pool2d(x, 3, 1, 1)`` /
``F.max_pool2d(x, 3, 2)``) on any other device. Where autograd records the
input (training, the gradient attributions) it goes through
:class:`_Pool`, whose backward is the kernel too. The kernel takes a
channels_last-contiguous bf16 or f32 tensor and raises, naming the shape,
for anything else. It sums in f32 in the window's row-major order and
divides by 9 (zeros counted), as PyTorch's own kernel does, and max is
exact, so both give the same bits. :func:`strip_rows` picks the strip of
output rows a thread walks.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from network_interpretation_imagenet_tpu_torch.ops import _cuda_build

# reduce -> (stride, padding) of its 3x3 window: Inception-v3's two pools.
KINDS = {"avg": (1, 1), "max": (2, 0)}
# The kernel's kinds (csrc/pool_nhwc.cu:Kind): the two pools and the
# average pool's gradient, which is the same stencil over the gradient.
_KIND = {"avg": 0, "max": 1, "avg_grad": 2}
_DTYPE = {torch.bfloat16: "bf16", torch.float32: "f32"}
_SIGS = {
    **{f"pool_nhwc_{d}": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
       for d in _DTYPE.values()},
    **{f"pool_nhwc_max_grad_{d}": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
       for d in _DTYPE.values()},
}

MAX_STRIP = 8        # output rows a thread walks at most (csrc/pool_nhwc.cu:kMaxStrip)
TARGET_THREADS = 2 * 132 * 2048   # two full loads of the H100's 132 SMs


def out_side(side: int, reduce: str) -> int:
    stride, pad = KINDS[reduce]
    return (side + 2 * pad - 3) // stride + 1


def strip_rows(n: int, oh: int, ow: int, c: int, itemsize: int) -> int:
    """The output rows a thread walks: the fewest that still give about
    TARGET_THREADS threads (one per image, strip, column and 16-byte word
    of channels), at most MAX_STRIP; one row where even that gives fewer.
    The kernel cuts the ``oh`` rows into ceil(oh / strip) strips, so the
    rows are spread over them as evenly as they go."""
    per_strip = n * ow * (c // (16 // itemsize))
    wanted = -(-TARGET_THREADS // per_strip)
    strips = -(-oh // max(1, min(MAX_STRIP, oh // wanted)))
    return -(-oh // strips)


def pool_nhwc_plain(x: torch.Tensor, reduce: str) -> torch.Tensor:
    """Plain PyTorch version: the 3x3 pool of ``reduce`` over NCHW-indexed
    ``x`` (any memory format)."""
    stride, pad = KINDS[reduce]
    if reduce == "avg":
        return F.avg_pool2d(x, 3, stride, pad)
    return F.max_pool2d(x, 3, stride, pad)


def pool_nhwc(x: torch.Tensor, reduce: str) -> torch.Tensor:
    """``reduce`` ("avg": 3x3, stride 1, pad 1, zeros counted; "max": 3x3,
    stride 2, VALID) over ``x`` [N, C, H, W]: the kernel on CUDA (through
    :class:`_Pool` where autograd records ``x``), the plain version on any
    other device."""
    if reduce not in KINDS:
        raise ValueError(f"pool_nhwc: reduce {reduce!r} is not one of {sorted(KINDS)}")
    if x.device.type != "cuda":
        return pool_nhwc_plain(x, reduce)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Pool.apply(x, reduce)
    return pool_nhwc_kernel(x, reduce)


def _checked(x: torch.Tensor, what: str) -> None:
    """Raises, naming the shape, unless ``x`` is a channels_last-contiguous
    bf16 or f32 [N, C, H, W] tensor with C a multiple of 16 bytes' elements
    and its data on a 16-byte boundary."""
    if x.dtype not in _DTYPE:
        raise ValueError(f"pool_nhwc: {x.dtype} {what} of shape {tuple(x.shape)}; the kernel "
                         f"takes {sorted(map(str, _DTYPE))}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"pool_nhwc: {what} of shape {tuple(x.shape)} and strides "
                         f"{x.stride()} is not a channels_last-contiguous NCHW tensor")
    vec = 16 // x.element_size()
    if x.shape[1] % vec or x.data_ptr() % 16:
        raise ValueError(f"pool_nhwc: {what} of shape {tuple(x.shape)}: C must be a multiple of "
                         f"{vec} ({x.dtype}'s 16-byte vector) and the data 16-byte aligned")


def pool_nhwc_kernel(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The kernel's launch of ``kind`` (a reduce, or "avg_grad" over an
    average pool's output gradient) on ``x``'s device: a channels_last bf16
    or f32 [N, C, H, W] tensor with C a multiple of 16 bytes' elements -> a
    new channels_last tensor of the pooled shape. Anything else raises,
    naming the shape. Counts the launch."""
    reduce = "max" if kind == "max" else "avg"
    _checked(x, "gradient" if kind == "avg_grad" else "input")
    n, c, h, w = x.shape
    oh, ow = out_side(h, reduce), out_side(w, reduce)
    if n < 1 or oh < 1 or ow < 1:
        raise ValueError(f"pool_nhwc: input of shape {tuple(x.shape)} has no {reduce} output")
    out = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    lib = _cuda_build.library("pool_nhwc", _SIGS)
    rc = getattr(lib, f"pool_nhwc_{_DTYPE[x.dtype]}")(
        _cuda_build.ptr(x), _cuda_build.ptr(out), n, h, w, c, _KIND[kind],
        strip_rows(n, oh, ow, c, x.element_size()), _cuda_build.stream_ptr(x.device))
    _cuda_build.check(rc, "pool_nhwc")
    pool_nhwc.launches += 1
    return out


def pool_nhwc_max_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The max pool's gradient on the card: ``x`` the pool's input, ``g``
    its output's gradient (both channels_last, of ``x``'s dtype) -> the
    input's gradient, channels_last."""
    _checked(x, "input")
    _checked(g, "gradient")
    n, c, h, w = x.shape
    oh, ow = out_side(h, "max"), out_side(w, "max")
    if g.shape != (n, c, oh, ow) or g.dtype != x.dtype:
        raise ValueError(f"pool_nhwc: a {g.dtype} gradient of shape {tuple(g.shape)} for a max "
                         f"pool of the {x.dtype} input of shape {tuple(x.shape)}")
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    lib = _cuda_build.library("pool_nhwc", _SIGS)
    rc = getattr(lib, f"pool_nhwc_max_grad_{_DTYPE[x.dtype]}")(
        _cuda_build.ptr(x), _cuda_build.ptr(g), _cuda_build.ptr(dx), n, h, w, c,
        _cuda_build.stream_ptr(x.device))
    _cuda_build.check(rc, "pool_nhwc max grad")
    pool_nhwc.launches += 1
    return dx


class _Pool(torch.autograd.Function):
    """The kernel where autograd records the input. The average pool's
    gradient is the same 3x3/1/pad-1 stencil over the output's gradient,
    each term divided by 9 and rounded to the gradient's type (as PyTorch's
    backward divides); the max pool's goes to each window's first largest
    input."""

    @staticmethod
    def forward(ctx, x, reduce):
        ctx.reduce = reduce
        if reduce == "max":
            ctx.save_for_backward(x)
        return pool_nhwc_kernel(x, reduce)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        g = g.contiguous(memory_format=torch.channels_last)
        if ctx.reduce == "avg":
            return pool_nhwc_kernel(g, "avg_grad"), None
        x, = ctx.saved_tensors
        return pool_nhwc_max_grad(x, g), None


pool_nhwc.launches = 0
