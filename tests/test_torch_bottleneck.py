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
from network_interpretation_imagenet_tpu_torch.ops import bottleneck_chain as jbc
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


def _stage_shapes():
    """(arch, H, C, P) of every stage of the Bottleneck ResNets, from the
    port's own configurations."""
    from network_interpretation_imagenet_tpu_torch.models.resnet_imagenet import _CONFIGS

    return [(arch, 56 >> s, 256 << s, 64 << s)
            for arch, sizes in _CONFIGS.items() for s in range(len(sizes))]


@pytest.mark.parametrize("batch", [1, 3, 8, 24, 32, 256])
@pytest.mark.parametrize("arch,h,c,p", _stage_shapes())
def test_chain_plan_fits_and_covers(arch, h, c, p, batch):
    m = batch * h * h
    plans = jbc.chain_plan(batch, h, h, c, p)
    for plan, (cin, cout, ks) in zip(plans, [(c, p, 1), (p, p, 3), (p, c, 1)]):
        assert plan.smem <= jbc.SMEM_PER_BLOCK == 232_448
        assert plan.bn in (64, 128, 256) and cout % plan.bn == 0
        assert plan.stages >= 3
        ring = plan.stages * (jbc.TILE_M + plan.bn) * jbc.TILE_K * 2
        assert plan.smem >= ring + jbc.TILE_M * plan.bn * 2 + 1024  # ring + staged output
        assert plan.m_tiles * jbc.TILE_M >= m > (plan.m_tiles - 1) * jbc.TILE_M
        assert plan.n_tiles * plan.bn == cout
        assert cin % jbc.TILE_K == 0
        k_steps = ks * ks * cin // jbc.TILE_K
        # No SM left idle that a split could fill: one block per K slice of each
        # tile, up to one per SM.
        assert 1 <= plan.grid <= jbc.H100_SMS
        assert plan.grid == min(plan.tiles * plan.splits, jbc.H100_SMS)
        # The slices (the kernel's [s * K / splits, (s + 1) * K / splits))
        # partition the K steps into contiguous, non-empty ranges, each of at
        # least MIN_SPLIT_K steps once K splits.
        ranges = [(s * k_steps // plan.splits, (s + 1) * k_steps // plan.splits)
                  for s in range(plan.splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == k_steps
        assert all(k1 == k0_next for (_, k1), (k0_next, _) in zip(ranges, ranges[1:]))
        assert all(k1 > k0 for k0, k1 in ranges)
        if plan.splits > 1:
            assert plan.bn == 64 and plan.tiles * plan.splits <= jbc.H100_SMS
            assert all(k1 - k0 >= jbc.MIN_SPLIT_K for k0, k1 in ranges)
        # The most slices the card and MIN_SPLIT_K allow.
        more = plan.splits + 1
        assert plan.tiles * more > jbc.H100_SMS or k_steps // more < jbc.MIN_SPLIT_K
    # The scratch the wrapper allocates holds the largest split launch's
    # partial tiles and one counter per tile of it.
    n_part, n_counters = jbc.split_scratch(plans)
    for plan in plans:
        if plan.splits > 1:
            assert n_part >= plan.tiles * plan.splits * jbc.TILE_M * plan.bn
            assert n_counters >= plan.tiles
    if all(cp.splits == 1 for cp in plans):
        assert (n_part, n_counters) == (0, 0)


def _whole_tile_plan(m, cin, cout, ks):
    """(bn, stages, smem, m_tiles, n_tiles, grid) of a launch that walks whole
    output tiles: the plan every launch ran before K could split, written out
    independently of conv_plan."""
    bn = next(n for n in (256, 128, 64)
              if cout % n == 0 and n <= (128 if ks == 1 and cin >= 256 else 256))
    stages = next(s for s in range(8, 0, -1)
                  if 1024 + 256 * bn + s * (128 + bn) * 128 + (2 * s + 2) * 8 <= 232_448)
    smem = 1024 + 256 * bn + stages * (128 + bn) * 128 + (2 * stages + 2) * 8
    m_tiles, n_tiles = -(-m // 128), cout // bn
    return bn, stages, smem, m_tiles, n_tiles, min(m_tiles * n_tiles, 132)


@pytest.mark.parametrize("batch", [1, 3, 8, 24, 41, 64, 66, 100, 250, 256, 512, 1024])
@pytest.mark.parametrize("h,c,p", [(56, 256, 64), (28, 512, 128), (14, 1024, 256), (7, 2048, 512),
                                   (56, 256, 128), (28, 512, 256), (14, 1024, 512),
                                   (7, 2048, 1024)])
def test_chain_plan_keeps_plans_that_fill_the_card(h, c, p, batch):
    """ResNet's and Wide-ResNet's chain shapes: every launch whose whole tiles
    fill the 132 SMs (all of B=256) keeps its plan field for field and never
    splits; the others run no fewer blocks than before."""
    m = batch * h * h
    for plan, (cin, cout, ks) in zip(jbc.chain_plan(batch, h, h, c, p),
                                     [(c, p, 1), (p, p, 3), (p, c, 1)]):
        whole = _whole_tile_plan(m, cin, cout, ks)
        if whole[3] * whole[4] >= jbc.H100_SMS:
            assert tuple(plan[:6]) == whole and plan.splits == 1
        else:
            assert plan.grid >= whole[5] and plan.bn <= whole[0]
    if batch == 256:
        assert all(cp.splits == 1 and cp.grid == jbc.H100_SMS
                   for cp in jbc.chain_plan(batch, h, h, c, p))


@pytest.mark.parametrize("c,p,ok", [(256, 64, True), (2048, 512, True), (192, 128, True),
                                    (256, 32, False), (96, 64, False), (64, 8, False),
                                    (0, 64, False)])
def test_cuda_shape_check(c, p, ok):
    if ok:
        jbc.check_cuda_shapes(c, p)
        assert jbc.conv_plan(3 * 7 * 7, c, p, 1).bn in (64, 128, 256)
    else:
        with pytest.raises(ValueError, match="multiples of 64"):
            jbc.check_cuda_shapes(c, p)
