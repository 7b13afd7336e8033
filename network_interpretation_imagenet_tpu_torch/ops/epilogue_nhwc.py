"""E1: a convolution's bias, residual and ReLU on its channels_last output,
in one pass, in place.

Replaces no TPU kernel: the JAX package leaves these to XLA's fusion.
:func:`epilogue_nhwc` launches ``csrc/epilogue_nhwc.cu`` for every CUDA
tensor and takes :func:`epilogue_nhwc_plain` (the same f32 arithmetic in
torch ops) only for CPU tensors. The kernel takes a channels_last-contiguous
bf16 or f32 ``y`` with C a multiple of 16 bytes' elements, an f32 bias
[C] and an optional residual of ``y``'s shape and dtype that does not
overlap it, and raises, naming the shape, for anything else. It is for
inference: nothing records it for autograd. :func:`rows_per_pass` sizes
its grid.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from network_interpretation_imagenet_tpu_torch.ops import _cuda_build

_DTYPE = {torch.bfloat16: "bf16", torch.float32: "f32"}
_SIGS = {f"epilogue_nhwc_{d}": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
         for d in _DTYPE.values()}

TARGET_THREADS = 132 * 2048   # as many threads as the H100's 132 SMs hold at once


def rows_per_pass(m: int, c: int, itemsize: int) -> int:
    """The rows of ``y`` [m, c] the kernel's grid covers at once (one thread
    per 16-byte word of a row): the fewest that give TARGET_THREADS threads,
    at most ``m``."""
    words = c // (16 // itemsize)
    return max(1, min(m, -(-TARGET_THREADS // words)))


def epilogue_nhwc_plain(y: torch.Tensor, bias: torch.Tensor,
                        res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version, on any device: ``y`` [N, C, H, W] (any memory
    format) becomes ``relu((f32(y) + bias) + f32(res))`` rounded once to
    its dtype, in place; returns ``y``."""
    t = y.float() + bias.view(1, -1, 1, 1)
    if res is not None:
        t += res.float()
    return y.copy_(torch.relu_(t))


def epilogue_nhwc(y: torch.Tensor, bias: torch.Tensor,
                  res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The epilogue of ``y`` in place (see :func:`epilogue_nhwc_plain`): the
    plain version for a CPU tensor, the kernel for any other."""
    if y.device.type == "cpu":
        return epilogue_nhwc_plain(y, bias, res)
    return epilogue_nhwc_kernel(y, bias, res)


def _refuse(y: torch.Tensor, why: str) -> ValueError:
    return ValueError(f"epilogue_nhwc: y of shape {tuple(y.shape)}: {why}")


def epilogue_nhwc_kernel(y: torch.Tensor, bias: torch.Tensor,
                         res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's launch on ``y``'s device, in place, on its current
    stream; returns ``y``. Raises, naming the shape, unless ``y`` is a
    channels_last-contiguous bf16 or f32 [N, C, H, W] tensor with C a
    multiple of 16 bytes' elements, ``bias`` a contiguous f32 [C] and
    ``res`` None or a channels_last tensor of ``y``'s shape and dtype that
    does not overlap it, all on ``y``'s device and 16-byte aligned. Counts
    the launch. The checks of shapes, strides, dtypes and devices run once
    for each set of them (``_PLANS``); the addresses' every call."""
    key = (y.shape, y.stride(), y.dtype, y.device, bias.shape, bias.stride(), bias.dtype,
           bias.device, None if res is None else (res.shape, res.stride(), res.dtype, res.device))
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _plan(y, bias, res)
    m, c, rows, entry = plan
    yp, bp = y.data_ptr(), bias.data_ptr()
    rp = None if res is None else res.data_ptr()
    if (yp | bp | (rp or 0)) % 16:
        raise _refuse(y, "its data, the bias's and the residual's must be 16-byte aligned")
    nbytes = m * c * y.element_size()
    if rp is not None and rp < yp + nbytes and yp < rp + nbytes:
        raise _refuse(y, "the residual overlaps it")
    rc = getattr(_cuda_build.library("epilogue_nhwc", _SIGS), entry)(
        yp, rp, bp, m, c, rows, _cuda_build.stream_ptr(y.device))
    _cuda_build.check(rc, "epilogue_nhwc")
    epilogue_nhwc.launches += 1
    return y


_PLANS: dict = {}


def _plan(y: torch.Tensor, bias: torch.Tensor, res: Optional[torch.Tensor]) -> tuple:
    """(rows, channels, rows a pass, the C entry) of a launch on these
    inputs' shapes, strides, dtypes and devices; raises, naming the shape,
    where the kernel does not take them."""
    if y.dtype not in _DTYPE:
        raise _refuse(y, f"dtype {y.dtype}; the kernel takes {sorted(map(str, _DTYPE))}")
    if y.dim() != 4 or not y.is_contiguous(memory_format=torch.channels_last):
        raise _refuse(y, f"strides {y.stride()} are not a channels_last-contiguous NCHW tensor's")
    n, c, h, w = y.shape
    vec = 16 // y.element_size()
    if c % vec:
        raise _refuse(y, f"C must be a multiple of {vec} ({y.dtype}'s 16-byte vector)")
    if (bias.dtype != torch.float32 or tuple(bias.shape) != (c,) or not bias.is_contiguous()
            or bias.device != y.device):
        raise _refuse(y, f"the bias must be a contiguous float32 [{c}] on {y.device}, not "
                         f"{bias.dtype} {tuple(bias.shape)} on {bias.device}")
    if res is not None and (res.shape != y.shape or res.dtype != y.dtype
                            or res.device != y.device
                            or not res.is_contiguous(memory_format=torch.channels_last)):
        raise _refuse(y, f"the residual ({res.dtype} {tuple(res.shape)} on {res.device}, "
                         f"strides {res.stride()}) must be a channels_last tensor of y's "
                         "shape, dtype and device")
    m = n * h * w
    if not 0 < m < 2**31:
        raise _refuse(y, "the kernel takes 1 to 2^31 - 1 rows of C channels")
    return m, c, rows_per_pass(m, c, y.element_size()), f"epilogue_nhwc_{_DTYPE[y.dtype]}"


epilogue_nhwc.launches = 0
