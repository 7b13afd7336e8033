"""Operations and bytes of the work a cell needs, from layer shapes, and the
H100's published peaks.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at its
700 W limit. The chain costs are frozen from ``chip_smoke.py:305-307``
(constants), ``:508`` (``b2_costs``) and ``:527`` (``chain_bound``)."""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

H100_BF16_FLOPS = 989e12     # dense tensor-core peak, SXM
H100_F32_FLOPS = 67e12       # float32 on the CUDA cores, SXM
H100_BYTES_PER_S = 3.35e12   # HBM3


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def forward_flops(cfg: dict) -> float:
    """Multiply-add operations (2 per MAC) of one image's forward through the
    config's convolutions and head; BatchNorm, ReLU, pooling and residual adds
    are not counted."""
    size = cfg["resolution"]
    h = _out(size, 7, 2, 3)
    flops = 2.0 * 64 * 3 * 49 * h * h              # stem
    h = _out(h, 3, 2, 1)                          # max-pool
    inplanes = 64
    for s, n in enumerate(cfg["stage_sizes"]):
        planes = 64 * 2 ** s
        width, out = int(planes * cfg["base_width"] / 64.0), planes * 4
        for b in range(n):
            stride = 2 if s > 0 and b == 0 else 1
            ho = _out(h, 3, stride, 1)
            flops += 2.0 * inplanes * width * h * h        # 1x1 reduce
            flops += 2.0 * width * width * 9 * ho * ho    # 3x3
            flops += 2.0 * width * out * ho * ho           # 1x1 expand
            if stride != 1 or inplanes != out:
                flops += 2.0 * inplanes * out * ho * ho    # projection
            h, inplanes = ho, out
    return flops + 2.0 * inplanes * cfg["num_classes"]


def b2_costs(h: int, c: int, p: int, n: int, batch: int) -> Tuple[float, float]:
    """(operations, bytes) of one bf16 chain call of ``n`` stride-1 Bottleneck
    blocks on ``batch`` images of h x h x c, inner width p: x read and y
    written once, and each block's weights and biases read once."""
    m = batch * h * h
    flops = (4 * c * p + 18 * p * p) * m * n
    nbytes = 2 * m * c * 2 + n * ((2 * c * p + 9 * p * p) * 2 + (2 * p + c) * 4)
    return float(flops), float(nbytes)


def chain_bound_ms(flops: float, nbytes: float) -> float:
    """The least time of a chain call on the card: the larger of its
    operations at the bf16 peak and its bytes at HBM's rate."""
    return max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3


def b2_bound_ms(chains: Iterable[Sequence[int]], batch: int) -> float:
    """Sum of the chain bounds of one forward's chains at ``batch``."""
    return sum(chain_bound_ms(*b2_costs(h, c, p, n, batch)) for h, c, p, n in chains)


def b1_bytes(h: int, w: int, c: int, k: int, out_itemsize: int = 2) -> float:
    """Bytes one B1 call needs: the f32 image and the int32 segments read
    once, the K int32 starts read once, the K masked images written once."""
    return float(h * w * c * 4 + h * w * 4 + k * 4 + k * h * w * c * out_itemsize)


def b1_bound_ms(h: int, w: int, c: int, k: int) -> float:
    return b1_bytes(h, w, c, k) / H100_BYTES_PER_S * 1e3
