"""B2: a chain of stride-1 ResNet bottleneck blocks in one call.

Counterpart of the TPU kernel ``ops/pallas_bottleneck.py:105``
(``fused_bottleneck_chain``). :func:`bottleneck_chain` launches
``csrc/bottleneck_chain.cu`` (three implicit-GEMM launches per block) for
CUDA tensors and takes :func:`bottleneck_chain_plain` only for CPU tensors.
Each instance runs the tile plan that Python derives from each
convolution's shape, splitting K where the output tiles alone would leave
SMs idle: the bf16 kernel (``wgmma`` fed by TMA) :func:`conv_plan`'s, the
f32 kernel (IEEE f32 FMAs on the CUDA cores, fed by TMA)
:func:`conv_plan_f32`'s. On the card both take C and P that are multiples
of 64 (:func:`check_cuda_shapes`).

Weights come as the JAX package lays them out, six per block, BatchNorm
already folded (``models.common.fold_bn``): ``w1 [C, P]``, ``b1 [P]``,
``w3 [3, 3, P, P]`` (HWIO), ``b3 [P]``, ``w2 [P, C]``, ``b2 [C]``. Biases are
f32; on the card the three matrices must already be in ``x``'s dtype (the
model casts them once when it is built).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from network_interpretation_imagenet_tpu_torch.ops import _cuda_build

# x, out, t1, t2, weights; n_blocks, B, H, W, C, P; plan; part, counters, stream
_SIG = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        + [ctypes.c_void_p] * 3)
_ENTRY = {torch.bfloat16: "bottleneck_chain_bf16", torch.float32: "bottleneck_chain_f32"}
_SIGS = {entry: _SIG for entry in _ENTRY.values()}

TILE_M = 128           # output rows per block: two consumer warpgroups of 64
TILE_K = 64            # K per pipeline stage: one 128-byte swizzle row of bf16
MAX_STAGES = 8
SMEM_PER_BLOCK = 232_448   # the most dynamic shared memory a Hopper block may opt in to
_SMEM_ALIGN = 1024         # slack for aligning the ring to the 128B swizzle's 1024-byte atom
H100_SMS = 132
# The fewest K steps (of TILE_K) a split of a tile keeps. Each split beyond
# the first costs the tile's last block one more 128 x 64 f32 partial tile
# (32 KB) to read back, and the launch one more block's start; at
# ResNet-101's batches 1, 3 and 8, 12 measured faster on the H100 than 4, 6,
# 8 and 16 (PERF.md).
MIN_SPLIT_K = 12

# The f32 instance: 128 x 128 or 128 x 64 output tiles on four warps (8 x 16
# or 8 x 8 outputs a thread), K in steps of 32 (one 128-byte swizzle row of
# f32), two blocks an SM: each ring fits in half the SM's shared memory.
F32_TILE_K = 32
F32_MAX_STAGES = 8
F32_BLOCKS_PER_SM = 2
SMEM_PER_SM = 233_472      # an H100 SM's shared memory: 228 KB
SMEM_RESERVED = 1_024      # what the card keeps of it per resident block
_F32_STATIC_SMEM = 16      # the f32 kernel's static shared memory: split-K's flags
# The fewest K steps (of F32_TILE_K) a split of an f32 tile keeps.
MIN_SPLIT_K_F32 = 4
# How much worse than the best per-SM balance a smaller split count may be.
F32_SPLIT_SLACK = 0.05
# A 128 x 64 tile's rate against a 128 x 128 tile's (8 x 8 outputs a thread
# against 8 x 16): 0.94 read on the H100 (ResNet-101's 3x3s at B=256, stage 1
# against stage 3; PERF.md).
F32_NARROW_RATE = 0.94
# A lone 128 x 64 block's rate against two sharing an SM (one warp, not two,
# on each quarter of the SM): 0.72 read on the H100 (ResNet-101's 3x3s at B=1,
# 10.0 us a K step alone against 7.2 of SM time shared; PERF.md).
F32_LONE_BLOCK_RATE = 0.7


class ConvPlan(NamedTuple):
    """Tile plan of one convolution launch (either instance): the N tile,
    the depth of the shared-memory ring, the dynamic shared memory it takes,
    the output tiles (``m_tiles * n_tiles``, N tiles fastest), the
    persistent grid that walks them, at most as many blocks as the SMs hold
    at once, and the K splits of each tile (its K steps in contiguous,
    near-equal slices, slice s taking steps [s * K / splits, (s + 1) * K /
    splits) as the kernel rounds them)."""

    bn: int
    stages: int
    smem: int
    m_tiles: int
    n_tiles: int
    grid: int
    splits: int

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles


def conv_plan(m: int, cin: int, cout: int, ks: int, sms: int = H100_SMS) -> ConvPlan:
    """The tile plan for a ``ks`` x ``ks`` convolution, [m, ks*ks*cin] x
    [ks*ks*cin, cout] as a GEMM: the widest N tile of 256, 128 or 64 that
    divides ``cout``, but at most 128 for a 1x1 with ``cin`` >= 256, whose
    long K loop gains more from the deeper ring that the narrower tile
    leaves room for (measured on the H100, PERF.md); beside the output tile
    staged for its TMA stores (256 * N bytes: two warpgroups' 64 rows), as
    many stages of A (128 x 64) and B (64 x N) tiles as fit, up to 8; and
    ``min(tiles, sms)`` persistent blocks.

    Where those tiles would leave SMs idle (small batches), the N tile is
    the narrowest whose tiles still fit on ``sms`` blocks, and where even
    64-wide tiles leave SMs idle, each tile's K steps split into the most
    slices that fit beside the other tiles while each keeps MIN_SPLIT_K
    steps, one block per slice. Only 64-wide tiles ever split: a narrower
    tile is more tiles before any split and the smallest partial sums."""
    check_cuda_shapes(cin, cout)
    widest = 128 if ks == 1 and cin >= 256 else 256
    bn = next(n for n in (256, 128, 64) if cout % n == 0 and n <= widest)
    m_tiles = -(-m // TILE_M)
    if m_tiles * (cout // bn) < sms:
        bn = next(n for n in (64, 128, 256) if cout % n == 0 and m_tiles * (cout // n) <= sms)
    stage = (TILE_M * TILE_K + TILE_K * bn) * 2
    staged = TILE_M * bn * 2

    def smem(stages):  # + a full and an empty mbarrier per stage, a residual one per warpgroup
        return _SMEM_ALIGN + staged + stages * stage + (2 * stages + 2) * 8

    stages = max(s for s in range(1, MAX_STAGES + 1) if smem(s) <= SMEM_PER_BLOCK)
    n_tiles = cout // bn
    tiles, k_steps = m_tiles * n_tiles, ks * ks * cin // TILE_K
    splits = max(1, min(sms // tiles, k_steps // MIN_SPLIT_K))
    return ConvPlan(bn, stages, smem(stages), m_tiles, n_tiles, min(tiles * splits, sms), splits)


def f32_smem(bn: int, stages: int) -> int:
    """Dynamic shared memory of an f32 launch: the ring's stages of A (128 x
    32) and B (32 x ``bn``) f32 tiles, aligned to the 128B swizzle's
    1024-byte atom, and a full and an empty mbarrier per stage."""
    return _SMEM_ALIGN + stages * (TILE_M + bn) * F32_TILE_K * 4 + 2 * stages * 8


@functools.lru_cache(maxsize=None)
def conv_plan_f32(m: int, cin: int, cout: int, ks: int, sms: int = H100_SMS) -> ConvPlan:
    """The f32 instance's tile plan for a ``ks`` x ``ks`` convolution,
    [m, ks*ks*cin] x [ks*ks*cin, cout] as a GEMM, by conv_plan's rules, for
    F32_BLOCKS_PER_SM blocks on each of the ``sms`` SMs: the 64-wide N tile
    below one wave of 128-wide tiles, its K split as :func:`f32_splits`
    balances the SMs' work; at a wave or more the 128-wide tile (never
    split), unless the 64-wide tiles balance the SMs' work better by more
    than their lower rate (F32_NARROW_RATE); as deep a ring as half the SM's
    shared memory holds, up to F32_MAX_STAGES. The persistent grid is at
    most one block a slot; a block walks its share of the (tile, slice)
    items."""
    check_cuda_shapes(cin, cout)
    m_tiles = -(-m // TILE_M)
    slots = F32_BLOCKS_PER_SM * sms
    k_steps = ks * ks * cin // F32_TILE_K
    splits = f32_splits(m_tiles * (cout // 64), k_steps, sms)
    bn = 64
    if cout % 128 == 0 and m_tiles * (cout // 128) >= slots:
        narrow = f32_balance(m_tiles * (cout // 64), splits, sms) / 2 / F32_NARROW_RATE
        if f32_balance(m_tiles * (cout // 128), 1, sms) <= narrow:
            bn, splits = 128, 1
    room = (min(SMEM_PER_BLOCK, SMEM_PER_SM // F32_BLOCKS_PER_SM - SMEM_RESERVED)
            - _F32_STATIC_SMEM)
    stages = max(s for s in range(1, F32_MAX_STAGES + 1) if f32_smem(bn, s) <= room)
    n_tiles = cout // bn
    tiles = m_tiles * n_tiles
    return ConvPlan(bn, stages, f32_smem(bn, stages), m_tiles, n_tiles,
                    min(tiles * splits, slots), splits)


def f32_balance(tiles: int, splits: int, sms: int) -> float:
    """The busiest SM's time, in tiles at a full SM's rate, when each of
    ``tiles`` splits into ``splits`` K slices and the persistent grid of
    min(items, 2 * sms) blocks walks them, block b taking items b, b + grid,
    ...: blocks b and b + sms share SM b, each at half its rate while both
    run, then the one left alone at F32_LONE_BLOCK_RATE."""
    items = tiles * splits
    grid = min(items, F32_BLOCKS_PER_SM * sms)
    b = np.arange(min(sms, grid))
    first = -(-(items - b) // grid)
    second = np.where(b + sms < grid, -(-(items - b - sms) // grid), 0)
    busy = 2 * np.minimum(first, second) + np.abs(first - second) / F32_LONE_BLOCK_RATE
    return float(busy.max()) / splits


def f32_splits(tiles: int, k_steps: int, sms: int) -> int:
    """The K splits of a 64-wide f32 launch: the fewest whose busiest SM
    comes within F32_SPLIT_SLACK of the best balance any split count leaves,
    each slice keeping MIN_SPLIT_K_F32 steps. 1 where the tiles already
    divide evenly over the SMs (every launch at B=256): a split then only
    adds fixups."""
    options = range(1, max(1, k_steps // MIN_SPLIT_K_F32) + 1)
    best = min(f32_balance(tiles, s, sms) for s in options)
    return next(s for s in options if f32_balance(tiles, s, sms) <= best * (1 + F32_SPLIT_SLACK))


def chain_plan(b: int, h: int, w: int, c: int, p: int, sms: int = H100_SMS,
               dtype: torch.dtype = torch.bfloat16) -> tuple:
    """Plans of a block's three launches for the ``dtype`` instance: 1x1
    reduce (C -> P), 3x3 (P -> P) and 1x1 expand (P -> C)."""
    plan = conv_plan_f32 if dtype == torch.float32 else conv_plan
    m = b * h * w
    return plan(m, c, p, 1, sms), plan(m, p, p, 3, sms), plan(m, p, c, 1, sms)


def split_scratch(plans: Sequence[ConvPlan]) -> tuple:
    """(f32 elements, int32 counters) of the split-K scratch that a chain
    with these launch plans needs (either instance): every split's partial
    128 x N f32 tile, and one counter per output tile, of its largest split
    launch; (0, 0) when no launch splits."""
    split = [cp for cp in plans if cp.splits > 1]
    return (max((cp.tiles * cp.splits * TILE_M * cp.bn for cp in split), default=0),
            max((cp.tiles for cp in split), default=0))


def split_buffers(plans: Sequence[ConvPlan], device) -> tuple:
    """The split-K scratch of :func:`split_scratch` on ``device``: the f32
    partials (uninitialised) and the counters (zeroed; every fixup leaves
    its counter at 0 again), each None when no launch splits."""
    n_part, n_counters = split_scratch(plans)
    part = torch.empty(n_part, dtype=torch.float32, device=device) if n_part else None
    counters = (torch.zeros(n_counters, dtype=torch.int32, device=device)
                if n_counters else None)
    return part, counters


def device_sms(device) -> int:
    """The card's SM count, which every tile plan fills."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_cuda_shapes(c: int, p: int) -> None:
    """Both instances take C and P that are multiples of 64: the bf16 kernel
    reads K and N in 64-channel slices (one TMA box row of 128 bytes, one
    ``wgmma`` N multiple), the f32 kernel K in 32-channel slices (one
    128-byte row) and N in tiles of 64 or 128. Other widths run only on the
    CPU."""
    if c % 64 or p % 64 or c <= 0 or p <= 0:
        raise ValueError(f"bottleneck_chain: on the card C={c} and P={p} must be "
                         "multiples of 64")


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
    check_cuda_shapes(c, p)
    if b * h * w >= 2**31:
        raise ValueError(f"bottleneck_chain: B*H*W={b * h * w} too large for one call")
    out = torch.empty_like(x)
    t1 = torch.empty((b, h, w, p), dtype=x.dtype, device=x.device)
    t2 = torch.empty_like(t1)
    ptrs = (ctypes.c_void_p * len(weights))(*[t.data_ptr() for t in weights])
    plans = chain_plan(b, h, w, c, p, device_sms(x.device), x.dtype)
    flat = [v for cp in plans for v in (cp.bn, cp.stages, cp.smem, cp.grid, cp.splits)]
    # One scratch per call, shared by its launches, which run in stream order.
    part, counters = split_buffers(plans, x.device)
    args = [_cuda_build.ptr(x), _cuda_build.ptr(out), _cuda_build.ptr(t1), _cuda_build.ptr(t2),
            ptrs, len(weights) // 6, b, h, w, c, p, (ctypes.c_int * len(flat))(*flat),
            _cuda_build.ptr(part) if part is not None else None,
            _cuda_build.ptr(counters) if counters is not None else None]
    lib = _cuda_build.library("bottleneck_chain", _SIGS)
    rc = getattr(lib, _ENTRY[x.dtype])(*args, _cuda_build.stream_ptr(x.device))
    _cuda_build.check(rc, "bottleneck_chain")
    bottleneck_chain.launches += 1
    return out


bottleneck_chain.launches = 0
