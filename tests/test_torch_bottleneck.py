"""Port vs JAX package: BatchNorm folding and B2's plain version
(``bottleneck_chain``) against ``bottleneck_chain_xla``.

bf16 tolerance rtol = atol = 2e-2: the two sum in different orders, so an
output can move by one bf16 ulp (2^-8 relative), and two blocks compound
that. The Pallas chain itself is not run here: its interpret-mode compile is
of the 16-minute class (see tests/conftest.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_interpretation_imagenet_tpu.ops import pallas_bottleneck as jpb
from network_interpretation_imagenet_tpu_torch.models.common import fold_bn
from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import (
    bottleneck_chain,
    bottleneck_chain_plain,
)

B, H, C, P = 4, 8, 32, 8


def _bn(rng, n):
    return rng.rand(n) + 0.5, rng.randn(n) * 0.1, rng.randn(n) * 0.1, rng.rand(n) + 0.5


def _weights(rng, blocks=2):
    """Folded weights as numpy (the same recipe as tests/test_pallas.py)."""
    mk = lambda *s: rng.randn(*s).astype(np.float32) * 0.1
    out = []
    for _ in range(blocks):
        w1, b1 = jpb.fold_bn(mk(C, P), *_bn(rng, P))
        w3, b3 = jpb.fold_bn(mk(3, 3, P, P), *_bn(rng, P))
        w2, b2 = jpb.fold_bn(mk(P, C), *_bn(rng, C))
        out += [w1, b1, w3, b3, w2, b2]
    return out


def test_fold_bn_matches_jax_exactly(rng):
    for shape in [(C, P), (3, 3, P, P), (7, 7, 3, 64)]:
        w = rng.randn(*shape).astype(np.float32)
        bn = _bn(rng, shape[-1])
        for got, want in zip(fold_bn(w, *bn), jpb.fold_bn(w, *bn)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)])
def test_bottleneck_chain_plain_matches_xla(rng, dtype, tol):
    ws = _weights(rng)
    x = rng.randn(B, H, H, C).astype(np.float32)
    want = np.asarray(jpb.bottleneck_chain_xla(jnp.asarray(x), tuple(map(jnp.asarray, ws))),
                      np.float32)
    tx = torch.from_numpy(x).to(dtype)
    tw = [torch.from_numpy(w) for w in ws]
    got = bottleneck_chain_plain(tx, tw)
    assert got.dtype == dtype and got.shape == (B, H, H, C) and got.is_contiguous()
    np.testing.assert_array_equal(bottleneck_chain(tx, tw).float().numpy(),
                                  got.float().numpy())  # the CPU wrapper is the plain version
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    else:
        # f32 storage: the XLA twin still rounds to bf16 at its three points,
        # so hold the f32 chain against an f32 recomputation instead.
        ref = torch.from_numpy(x)
        for i in range(2):
            w1, b1, w3, b3, w2, b2 = (torch.from_numpy(w) for w in ws[6 * i:6 * i + 6])
            t1 = torch.relu(ref @ w1 + b1)
            t2 = torch.nn.functional.conv2d(t1.permute(0, 3, 1, 2), w3.permute(3, 2, 0, 1),
                                            padding=1).permute(0, 2, 3, 1)
            ref = torch.relu((torch.relu(t2 + b3) @ w2 + b2) + ref)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=tol, atol=tol)


def test_bottleneck_chain_checks_shapes_and_layout(rng):
    tw = [torch.from_numpy(w) for w in _weights(rng, 1)]
    x = torch.randn(B, H, H, C, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        bottleneck_chain(x.permute(0, 2, 1, 3), tw)  # not NHWC-contiguous
    with pytest.raises(ValueError):
        bottleneck_chain(x, tw[:5])
    with pytest.raises(ValueError):
        bottleneck_chain(x[..., :16].contiguous(), tw)
    before = bottleneck_chain.launches
    bottleneck_chain(x, tw)
    assert bottleneck_chain.launches == before  # CPU runs count no launch
