"""B2: a chain of stride-1 ResNet bottleneck blocks in one call.

Counterpart of the TPU kernel ``ops/pallas_bottleneck.py:105``
(``fused_bottleneck_chain``). :func:`bottleneck_chain` launches
``csrc/bottleneck_chain.cu`` (three implicit-GEMM launches per block) for
CUDA tensors and takes :func:`bottleneck_chain_plain` only for CPU tensors.

Weights come as the JAX package lays them out, six per block, BatchNorm
already folded (``models.common.fold_bn``): ``w1 [C, P]``, ``b1 [P]``,
``w3 [3, 3, P, P]`` (HWIO), ``b3 [P]``, ``w2 [P, C]``, ``b2 [C]``. Biases are
f32; on the card the three matrices must already be in ``x``'s dtype (the
model casts them once when it is built).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from network_interpretation_imagenet_tpu_torch.ops import _cuda_build

_SIG = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ENTRY = {torch.bfloat16: "bottleneck_chain_bf16", torch.float32: "bottleneck_chain_f32"}


def bottleneck_chain_plain(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version with the same arithmetic: the weights round to
    ``x``'s dtype, products and convolutions run in f32, the bias adds in
    f32, and ReLU's result rounds to ``x``'s dtype, at the three points of
    ``bottleneck_chain_xla``."""
    dt = x.dtype
    for i in range(len(weights) // 6):
        w1, b1, w3, b3, w2, b2 = weights[6 * i: 6 * i + 6]
        xf = x.float()
        t1 = torch.relu(torch.matmul(xf, w1.to(dt).float()) + b1).to(dt)
        t2 = F.conv2d(t1.float().permute(0, 3, 1, 2),
                      w3.to(dt).float().permute(3, 2, 0, 1), padding=1)
        t2 = torch.relu(t2.permute(0, 2, 3, 1) + b3).to(dt)
        t3 = torch.matmul(t2.float(), w2.to(dt).float()) + b2
        x = torch.relu(t3 + xf).to(dt)
    return x.contiguous()


def _check(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> None:
    if x.dim() != 4 or not weights or len(weights) % 6:
        raise ValueError(f"bottleneck_chain: x {tuple(x.shape)} with {len(weights)} weights")
    if not x.is_contiguous():
        raise ValueError("bottleneck_chain: x must be contiguous NHWC "
                         "(channels_last activations)")
    c = x.shape[3]
    p = weights[0].shape[1]
    shapes = [(c, p), (p,), (3, 3, p, p), (p,), (p, c), (c,)]
    for i, t in enumerate(weights):
        if tuple(t.shape) != shapes[i % 6]:
            raise ValueError(f"bottleneck_chain: weight {i} has shape {tuple(t.shape)}, "
                             f"expected {shapes[i % 6]}")


def bottleneck_chain(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """x[B, H, W, C] (bf16 or f32, NHWC contiguous) through len(weights)/6
    blocks -> a new [B, H, W, C] tensor of x's dtype."""
    _check(x, weights)
    if x.device.type == "cpu":
        return bottleneck_chain_plain(x, weights)
    if x.dtype not in _ENTRY:
        raise ValueError(f"bottleneck_chain: dtype {x.dtype} not supported")
    for i, t in enumerate(weights):
        want = torch.float32 if i % 2 else x.dtype
        if t.device != x.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"bottleneck_chain: weight {i} must be a contiguous {want} "
                             f"tensor on {x.device}, got {t.dtype} on {t.device}")
    b, h, w, c = x.shape
    p = weights[0].shape[1]
    if c % 8 or p % 8:
        raise ValueError(f"bottleneck_chain: C={c} and P={p} must be multiples of 8")
    out = torch.empty_like(x)
    t1 = torch.empty((b, h, w, p), dtype=x.dtype, device=x.device)
    t2 = torch.empty_like(t1)
    ptrs = (ctypes.c_void_p * len(weights))(*[t.data_ptr() for t in weights])
    lib = _cuda_build.library("bottleneck_chain", {e: _SIG for e in _ENTRY.values()})
    rc = getattr(lib, _ENTRY[x.dtype])(
        _cuda_build.ptr(x), _cuda_build.ptr(out), _cuda_build.ptr(t1), _cuda_build.ptr(t2),
        ptrs, len(weights) // 6, b, h, w, c, p, _cuda_build.stream_ptr(x.device))
    _cuda_build.check(rc, "bottleneck_chain")
    bottleneck_chain.launches += 1
    return out


bottleneck_chain.launches = 0
