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


def _f32_stage_shapes():
    """(H, C, P) of every chain shape B2's f32 instance runs: the Bottleneck
    ResNets' stages and Wide-ResNet's (C = 2P)."""
    return sorted({(h, c, p) for _, h, c, p in _stage_shapes()}
                  | {(56 >> s, 256 << s, 128 << s) for s in range(4)})


F32_BATCHES = (1, 2, 3, 4, 6, 8, 12, 24, 32, 41, 64, 66, 100, 250, 256, 512, 1024)


@pytest.mark.parametrize("batch", F32_BATCHES)
@pytest.mark.parametrize("h,c,p", _f32_stage_shapes())
def test_f32_chain_plan_fits_and_covers(h, c, p, batch):
    """The f32 plan: its ring fits the shared memory it reserves, as many
    blocks an SM as the plan counts on; the persistent grid walks every
    (output tile, K slice) exactly once; the slices partition each tile's K
    steps, each keeping MIN_SPLIT_K_F32 steps once K splits; and no more
    slices would still fit."""
    m = batch * h * h
    plans = jbc.chain_plan(batch, h, h, c, p, dtype=torch.float32)
    for plan, (cin, cout, ks) in zip(plans, [(c, p, 1), (p, p, 3), (p, c, 1)]):
        assert plan.bn in (64, 128) and cout % plan.bn == 0 and cin % jbc.F32_TILE_K == 0
        assert plan.stages >= 3
        ring = plan.stages * (jbc.TILE_M * jbc.F32_TILE_K + jbc.F32_TILE_K * plan.bn) * 4
        assert plan.smem >= 1024 + ring + plan.stages * 2 * 8  # aligned ring + its mbarriers
        assert plan.smem <= jbc.SMEM_PER_BLOCK
        per_sm = jbc.F32_BLOCKS_PER_SM
        assert per_sm * (plan.smem + 16 + 1024) <= 233_472  # + static bytes, the card's reserve
        assert plan.m_tiles * jbc.TILE_M >= m > (plan.m_tiles - 1) * jbc.TILE_M
        assert plan.n_tiles * plan.bn == cout
        slots = per_sm * jbc.H100_SMS
        assert 1 <= plan.grid == min(plan.tiles * plan.splits, slots)
        walked = sorted(item for b in range(plan.grid)
                        for item in range(b, plan.tiles * plan.splits, plan.grid))
        assert walked == list(range(plan.tiles * plan.splits))
        k_steps = ks * ks * cin // jbc.F32_TILE_K
        ranges = [(s * k_steps // plan.splits, (s + 1) * k_steps // plan.splits)
                  for s in range(plan.splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == k_steps
        assert all(k1 == k0_next for (_, k1), (k0_next, _) in zip(ranges, ranges[1:]))
        if plan.splits > 1:
            assert all(k1 - k0 >= jbc.MIN_SPLIT_K_F32 for k0, k1 in ranges)
        # The fewest splits within F32_SPLIT_SLACK of the best balance any
        # allowed split count gives (64-wide tiles only).
        options = range(1, max(1, k_steps // jbc.MIN_SPLIT_K_F32) + 1) if plan.bn == 64 else [1]
        costs = {n: jbc.f32_balance(plan.tiles, n, jbc.H100_SMS) for n in options}
        best = min(costs.values()) * (1 + jbc.F32_SPLIT_SLACK)
        assert costs[plan.splits] <= best
        assert all(costs[n] > best for n in options if n < plan.splits)
    n_part, n_counters = jbc.split_scratch(plans)
    for plan in plans:
        if plan.splits > 1:
            assert n_part >= plan.tiles * plan.splits * jbc.TILE_M * plan.bn
            assert n_counters >= plan.tiles


@pytest.mark.parametrize("h,c,p", _f32_stage_shapes())
def test_f32_chain_plan_splits_only_launches_that_leave_sms_idle(h, c, p):
    """At every batch from 1 to 1,024: 128-wide tiles only where they fill
    the card's block slots (two an SM), whole (no split), and then unless
    the 64-wide tiles balance the SMs' work better by more than their lower
    rate; a launch splits K only where its 64-wide tiles, whole, would
    leave SMs idle while the busiest finishes, and the split shortens the
    busiest SM's time; and every launch at B=256 runs whole tiles."""
    slots, sms = 2 * jbc.H100_SMS, jbc.H100_SMS
    for batch in range(1, 1025):
        m_tiles = -(-batch * h * h // 128)
        for plan, cout, cin, ks in zip(jbc.chain_plan(batch, h, h, c, p, dtype=torch.float32),
                                       (p, p, c), (c, p, p), (1, 3, 1)):
            tiles64 = m_tiles * (cout // 64)
            wide = cout % 128 == 0 and m_tiles * (cout // 128) >= slots
            if wide:
                s64 = jbc.f32_splits(tiles64, ks * ks * cin // 32, sms)
                narrow = jbc.f32_balance(tiles64, s64, sms) / 2 / jbc.F32_NARROW_RATE
                keeps_wide = jbc.f32_balance(m_tiles * (cout // 128), 1, sms) <= narrow
            if plan.bn == 128:
                assert wide and keeps_wide and (plan.splits, plan.grid) == (1, slots)
            else:
                assert plan.bn == 64 and plan.tiles == tiles64 and not (wide and keeps_wide)
            if plan.splits > 1:
                whole = jbc.f32_balance(plan.tiles, 1, jbc.H100_SMS)
                assert plan.bn == 64 and whole > plan.tiles / jbc.H100_SMS
                assert jbc.f32_balance(plan.tiles, plan.splits, jbc.H100_SMS) < whole
            if batch == 256:
                assert plan.splits == 1


def _schedule_time(tiles, splits, sms, lone):
    """f32_balance written out block by block: the persistent grid deals
    items b, b + grid, ... to block b; blocks b and b + sms share SM b, each
    at half rate while both run, the one left alone at ``lone``."""
    items = tiles * splits
    grid = min(items, 2 * sms)
    work = [len(range(b, items, grid)) for b in range(grid)] + [0] * (2 * sms - grid)
    busiest = 0.0
    for sm in range(sms):
        a, b = work[sm], work[sm + sms]
        busiest = max(busiest, 2 * min(a, b) + abs(a - b) / lone)
    return busiest / splits


@pytest.mark.parametrize("tiles,splits", [(1, 1), (8, 16), (8, 33), (148, 1), (148, 5), (196, 2),
                                          (294, 3), (392, 1), (784, 2), (6272, 1)])
def test_f32_balance_follows_the_schedule(tiles, splits):
    assert jbc.f32_balance(tiles, splits, jbc.H100_SMS) == pytest.approx(
        _schedule_time(tiles, splits, jbc.H100_SMS, jbc.F32_LONE_BLOCK_RATE))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch,h,c,p", [(1, 14, 1024, 256), (3, 7, 2048, 512),
                                         (32, 28, 512, 128), (256, 56, 256, 64)])
def test_wrapper_hands_each_instance_its_plan(monkeypatch, dtype, batch, h, c, p):
    """The wrapper passes each instance's entry the 15 plan ints of
    chain_plan for that dtype, and the split-K scratch that split_scratch
    sizes for them (zeroed counters; none when no launch splits). Meta
    tensors stand in for the card's; a fake library records the entry's
    arguments."""
    from network_interpretation_imagenet_tpu_torch.ops import _cuda_build

    calls, scratch = [], []

    class FakeLibrary:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    def recording_buffers(plans, device):
        scratch.append(real_buffers(plans, device))
        return scratch[-1]

    real_buffers = jbc.split_buffers
    monkeypatch.setattr(_cuda_build, "library", lambda name, sigs: FakeLibrary())
    monkeypatch.setattr(_cuda_build, "stream_ptr", lambda device: None)
    monkeypatch.setattr(jbc, "device_sms", lambda device: jbc.H100_SMS)
    monkeypatch.setattr(jbc, "split_buffers", recording_buffers)
    monkeypatch.setattr(bottleneck_chain, "launches", bottleneck_chain.launches)
    meta = torch.device("meta")
    shapes = [(c, p), (p,), (3, 3, p, p), (p,), (p, c), (c,)]
    ws = [torch.empty(s, dtype=torch.float32 if i % 2 else dtype, device=meta)
          for i, s in enumerate(shapes * 2)]
    x = torch.empty((batch, h, h, c), dtype=dtype, device=meta)
    before = bottleneck_chain.launches
    out = bottleneck_chain(x, ws)
    assert out.shape == x.shape and out.dtype == dtype and bottleneck_chain.launches == before + 1
    (name, args), = calls
    plans = jbc.chain_plan(batch, h, h, c, p, dtype=dtype)
    assert name == jbc._ENTRY[dtype] == ("bottleneck_chain_f32" if dtype == torch.float32
                                         else "bottleneck_chain_bf16")
    assert args[5:11] == (2, batch, h, h, c, p)
    assert list(args[11]) == [v for cp in plans for v in
                              (cp.bn, cp.stages, cp.smem, cp.grid, cp.splits)]
    (part, counters), = scratch
    n_part, n_counters = jbc.split_scratch(plans)
    if n_part:
        assert part.dtype == torch.float32 and part.numel() == n_part
        assert counters.dtype == torch.int32 and counters.numel() == n_counters
    else:
        assert part is None and counters is None and args[12] is None and args[13] is None
    if (dtype, batch, h) == (torch.float32, 1, 14):  # stage 3's 3x3 at the BO's B=1 splits K
        assert plans[1].splits > 1 and n_part > 0
    with pytest.raises(ValueError, match="multiples of 64"):  # the kernels' widths only
        bottleneck_chain(torch.empty((1, 7, 7, 96), dtype=dtype, device=meta),
                         [torch.empty(s, dtype=torch.float32 if i % 2 else dtype, device=meta)
                          for i, s in enumerate([(96, 32), (32,), (3, 3, 32, 32), (32,),
                                                 (32, 96), (96,)])])


def test_split_buffers_zero_the_counters():
    """The counters start at 0 (every fixup leaves its counter at 0 again);
    no scratch at all when no launch splits."""
    plans = jbc.chain_plan(1, 14, 14, 1024, 256, dtype=torch.float32)
    part, counters = jbc.split_buffers(plans, "cpu")
    assert (part.numel(), counters.numel()) == jbc.split_scratch(plans)
    assert torch.equal(counters, torch.zeros_like(counters))
    assert jbc.split_buffers(jbc.chain_plan(256, 14, 14, 1024, 256, dtype=torch.float32),
                             "cpu") == (None, None)
