"""Operations and bytes of the work a cell needs, from layer shapes, and the
H100's published peaks. A forward's operations are its family's
(``forward_flops`` of ``portbench/nets/<net>.py``).

The peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at its
700 W limit. The chain costs are frozen from ``chip_smoke.py:305-307``
(constants), ``:508`` (``b2_costs``) and ``:527`` (``chain_bound``)."""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

H100_BF16_FLOPS = 989e12     # dense tensor-core peak, SXM
H100_F32_FLOPS = 67e12       # float32 on the CUDA cores, SXM
H100_BYTES_PER_S = 3.35e12   # HBM3
# Per dtype a config may state: the peak its forwards run against, and the
# bytes of one element the kernels move.
PEAK_FLOPS = {"bfloat16": H100_BF16_FLOPS, "float32": H100_F32_FLOPS}
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def conv_out(size: int, k: int, stride: int, pad: int) -> int:
    """The output side of a convolution or pooling window over ``size``."""
    return (size + 2 * pad - k) // stride + 1


def b2_costs(h: int, c: int, p: int, n: int, batch: int, itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one chain call of ``n`` stride-1 Bottleneck
    blocks on ``batch`` images of h x h x c, inner width p: x read and y
    written once, and each block's weights and biases read once; activations
    and weights of ``itemsize`` bytes (bf16 2, the f32 instance 4), biases
    f32."""
    m = batch * h * h
    flops = (4 * c * p + 18 * p * p) * m * n
    nbytes = 2 * m * c * itemsize + n * ((2 * c * p + 9 * p * p) * itemsize + (2 * p + c) * 4)
    return float(flops), float(nbytes)


def chain_bound_ms(flops: float, nbytes: float, peak: float = H100_BF16_FLOPS) -> float:
    """The least time of a chain call on the card: the larger of its
    operations at ``peak`` (bf16's, or f32's on the CUDA cores) and its
    bytes at HBM's rate."""
    return max(flops / peak, nbytes / H100_BYTES_PER_S) * 1e3


def b2_bound_ms(chains: Iterable[Sequence[int]], batch: int, dtype: str = "bfloat16") -> float:
    """Sum of the chain bounds of one forward's chains at ``batch`` in the
    instance of ``dtype``."""
    return sum(chain_bound_ms(*b2_costs(h, c, p, n, batch, ITEMSIZE[dtype]), PEAK_FLOPS[dtype])
               for h, c, p, n in chains)


def b1_bytes(h: int, w: int, c: int, k: int, out_itemsize: int = 2) -> float:
    """Bytes one B1 call needs: the f32 image and the int32 segments read
    once, the K int32 starts read once, the K masked images written once."""
    return float(h * w * c * 4 + h * w * 4 + k * 4 + k * h * w * c * out_itemsize)


def b1_bound_ms(h: int, w: int, c: int, k: int, out_itemsize: int = 2) -> float:
    return b1_bytes(h, w, c, k, out_itemsize) / H100_BYTES_PER_S * 1e3
