"""P1, Inception-v3's 3x3 pools (``ops/pool_nhwc.py``), on the CPU: the
plain twin at each of the net's 13 pools against the library's pools and
the JAX package's; the kernel's strips at each of them; the wrapper's
raises, its route and what it hands the kernel's entries, forward and
backward; models of the two gradients against the library's; and the
module plan's logits and span. The kernel itself runs only on the card
(``chip_smoke.py --pool``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from network_interpretation_imagenet_tpu.models import inception as jinception
from network_interpretation_imagenet_tpu_torch.models import ModulePlan, create_model
from network_interpretation_imagenet_tpu_torch.models import inception
from network_interpretation_imagenet_tpu_torch.ops import _cuda_build
from network_interpretation_imagenet_tpu_torch.ops import pool_nhwc as pn

POOL_IDS = [f"{i}-{where}" for i, (where, *_) in enumerate(inception.POOLS)]
LIBRARY = {"avg": lambda x: F.avg_pool2d(x, 3, 1, 1), "max": lambda x: F.max_pool2d(x, 3, 2)}
JAX = {"avg": jinception._avg3, "max": jinception._max3s2}


def _input(side, c, dtype=torch.float32, batch=2, seed=0):
    g = torch.Generator().manual_seed(seed + side + c)
    x = torch.randn(batch, c, side, side, generator=g).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


def test_pools_are_the_nets(monkeypatch):
    """:data:`inception.POOLS` lists the pools one forward at 299^2 runs,
    in order (the net traced on the meta device)."""
    seen = []

    def record(x, reduce):
        seen.append((reduce, x.shape[2], x.shape[1]))
        return pn.pool_nhwc_plain(x, reduce)

    monkeypatch.setattr(inception, "pool_nhwc", record)
    with torch.device("meta"):
        create_model("inception_v3").module.eval()(torch.zeros(1, 299, 299, 3))
    assert seen == [(r, side, c) for _, r, side, c in inception.POOLS]
    assert [r for _, r, *_ in inception.POOLS].count("avg") == 9


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pool", inception.POOLS, ids=POOL_IDS)
def test_plain_twin_at_every_inception_pool(pool, dtype):
    """At each pool's shape (batch 2): the plain twin is the library's pool
    to the bit, channels_last in and out, whatever the input's memory
    format; in f32 it is the JAX package's pool; on the CPU the wrapper
    takes it and launches nothing."""
    _, reduce, side, c = pool
    x = _input(side, c, dtype)
    got = pn.pool_nhwc_plain(x, reduce)
    out = pn.out_side(side, reduce)
    assert got.shape == (2, c, out, out) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, LIBRARY[reduce](x))
    assert torch.equal(pn.pool_nhwc_plain(x.contiguous(), reduce), got)
    before = pn.pool_nhwc.launches
    assert torch.equal(pn.pool_nhwc(x, reduce), got)
    assert pn.pool_nhwc.launches == before
    if dtype == torch.float32:
        want = np.asarray(JAX[reduce](jnp.asarray(x.permute(0, 2, 3, 1).numpy())))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("batch", [1, 3, 256])
@pytest.mark.parametrize("pool", inception.POOLS, ids=POOL_IDS)
def test_launch_plan_covers_every_inception_pool(pool, batch, itemsize):
    """One thread per (image, strip, column, 16-byte word), as the kernel
    cuts the grid from :func:`strip_rows`: the words cover the channels,
    the strips every output row once with none empty; at B=256 there are
    threads for two full loads of the H100's 132 SMs, at B=1 strips of one
    row."""
    _, reduce, side, c = pool
    out = pn.out_side(side, reduce)
    strip = pn.strip_rows(batch, out, out, c, itemsize)
    vec = 16 // itemsize
    assert c % vec == 0
    assert 1 <= strip <= pn.MAX_STRIP
    strips = -(-out // strip)
    assert strips * strip >= out > (strips - 1) * strip
    total = batch * strips * out * (c // vec)
    if batch == 256:
        assert total >= 2 * 132 * 2048
    if batch == 1:
        assert strip == 1


class _FakeLibrary:
    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_kernel(monkeypatch):
    """A stand-in library that records each entry's arguments; meta tensors
    stand in for the card's."""
    calls = []
    monkeypatch.setattr(_cuda_build, "library", lambda name, sigs: _FakeLibrary(calls))
    monkeypatch.setattr(_cuda_build, "stream_ptr", lambda device: None)
    monkeypatch.setattr(pn.pool_nhwc, "launches", 0)
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pool", inception.POOLS, ids=POOL_IDS)
def test_the_kernel_gets_the_shape_and_the_plan(fake_kernel, pool, dtype):
    """The launch hands the entry of the input's dtype the shape, the pool's
    kind and :func:`strip_rows`' strip, into a new channels_last tensor of
    the pooled shape, and counts the launch."""
    _, reduce, side, c = pool
    x = _input(side, c, dtype, batch=256).to("meta")
    got = pn.pool_nhwc_kernel(x, reduce)
    out = pn.out_side(side, reduce)
    assert got.shape == (256, c, out, out) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    (name, args), = fake_kernel
    strip = pn.strip_rows(256, out, out, c, dtype.itemsize)
    assert name == {torch.bfloat16: "pool_nhwc_bf16", torch.float32: "pool_nhwc_f32"}[dtype]
    assert args[2:-1] == (256, side, side, c, int(reduce == "max"), strip)
    assert pn.pool_nhwc.launches == 1


@pytest.mark.parametrize("dtype, c", [(torch.bfloat16, 12), (torch.bfloat16, 4),
                                      (torch.float32, 6)])
def test_a_channel_count_off_the_vector_raises_naming_the_shape(fake_kernel, dtype, c):
    x = _input(17, c, dtype).to("meta")
    for reduce in pn.KINDS:
        with pytest.raises(ValueError,
                           match=rf"\(2, {c}, 17, 17\).*multiple of {16 // dtype.itemsize}"):
            pn.pool_nhwc_kernel(x, reduce)
    assert fake_kernel == [] and pn.pool_nhwc.launches == 0


def test_inputs_the_kernel_does_not_take_raise_naming_the_shape(fake_kernel):
    """A dtype other than bf16 and f32, an NCHW tensor, an input with no max
    output, and an unknown reduce raise; nothing is launched."""
    with pytest.raises(ValueError, match=r"float16 input of shape \(2, 16, 17, 17\)"):
        pn.pool_nhwc_kernel(_input(17, 16, torch.float16).to("meta"), "avg")
    with pytest.raises(ValueError, match=r"\(2, 16, 17, 17\).*channels_last"):
        pn.pool_nhwc_kernel(_input(17, 16).contiguous().to("meta"), "avg")
    with pytest.raises(ValueError, match=r"\(2, 16, 2, 2\) has no max output"):
        pn.pool_nhwc_kernel(_input(2, 16).to("meta"), "max")
    with pytest.raises(ValueError, match="reduce 'sum'"):
        pn.pool_nhwc(_input(17, 16), "sum")
    assert fake_kernel == [] and pn.pool_nhwc.launches == 0


def test_the_route_sends_cpu_nchw_and_recorded_inputs_to_the_plain_version(fake_kernel):
    """The CPU (channels_last or NCHW, recorded by autograd or not) and
    another device than CUDA take the plain version: the library's values,
    no launch; a recorded input's gradient flows through it. (On CUDA every
    input takes the kernel, or raises.)"""
    x = _input(17, 16)
    nchw = x.contiguous()
    leaf = x.clone().requires_grad_(True)
    for t in (x, nchw, leaf, x.to("meta")):
        for reduce in pn.KINDS:
            got = pn.pool_nhwc(t, reduce)
            if t.device.type == "cpu":
                assert torch.equal(got.detach(), LIBRARY[reduce](x))
    pn.pool_nhwc(leaf, "avg").sum().backward()
    assert leaf.grad is not None and leaf.grad.abs().sum() > 0
    assert fake_kernel == [] and pn.pool_nhwc.launches == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("reduce", sorted(pn.KINDS))
def test_a_recorded_input_takes_the_kernel_forward_and_backward(fake_kernel, reduce, dtype):
    """Where autograd records the input, :class:`_Pool` launches the pool,
    and its backward launches the average pool's gradient (kind 2 over the
    output's gradient) or the max pool's (the input and the gradient), into
    a channels_last gradient of the input's shape."""
    leaf = _input(17, 16, dtype).to("meta").requires_grad_(True)
    out = pn._Pool.apply(leaf, reduce)
    out.sum().backward()
    assert leaf.grad.shape == leaf.shape and leaf.grad.dtype == dtype
    assert leaf.grad.is_contiguous(memory_format=torch.channels_last)
    d = {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]
    (fwd, fargs), (bwd, bargs) = fake_kernel
    assert fwd == f"pool_nhwc_{d}" and fargs[2:7] == (2, 17, 17, 16, int(reduce == "max"))
    if reduce == "avg":
        assert bwd == f"pool_nhwc_{d}" and bargs[2:7] == (2, 17, 17, 16, 2)
    else:
        assert bwd == f"pool_nhwc_max_grad_{d}" and bargs[3:7] == (2, 17, 17, 16)
    assert pn.pool_nhwc.launches == 2


def _avg_grad_model(g):
    """The kernel's average-pool gradient: each input's sum, from 0 in the
    window's row-major order, of the output gradients around it over 9."""
    h, w = g.shape[2:]
    padded = F.pad(g, (1, 1, 1, 1))
    acc = torch.zeros_like(g)
    for dy in range(3):
        for dx in range(3):
            acc = acc + padded[:, :, dy:dy + h, dx:dx + w] / 9
    return acc


def _max_grad_model(x, g):
    """The kernel's max-pool gradient, input by input: over the windows that
    hold it (rows, then columns), the gradient of each whose first largest
    value (a NaN wins) it is."""
    n, c, h, w = x.shape
    oh, ow = g.shape[2:]
    dx = torch.zeros_like(x)
    for iy in range(h):
        oys = range(0 if iy < 3 else (iy - 3) // 2 + 1, min(iy // 2 + 1, oh))
        for ix in range(w):
            oxs = range(0 if ix < 3 else (ix - 3) // 2 + 1, min(ix // 2 + 1, ow))
            acc = torch.zeros(n, c, dtype=x.dtype)
            for oy in oys:
                for ox in oxs:
                    win = x[:, :, 2 * oy:2 * oy + 3, 2 * ox:2 * ox + 3].reshape(n, c, 9)
                    best = torch.full((n, c), -torch.inf, dtype=x.dtype)
                    at = torch.zeros(n, c, dtype=torch.long)
                    for k in range(9):
                        take = (win[..., k] > best) | win[..., k].isnan()
                        best = torch.where(take, win[..., k], best)
                        at = torch.where(take, k, at)
                    mine = (iy - 2 * oy) * 3 + (ix - 2 * ox)
                    acc = acc + torch.where(at == mine, g[:, :, oy, ox], 0)
            dx[:, :, iy, ix] = acc
    return dx


@pytest.mark.parametrize("pool", [p for p in inception.POOLS if p[1] == "avg"],
                         ids=[i for i, p in zip(POOL_IDS, inception.POOLS) if p[1] == "avg"])
def test_the_avg_gradient_is_the_librarys(pool):
    """The average pool's gradient, as the kernel computes it (the same
    stencil over the output's gradient, each term over 9), is the library's
    backward of ``F.avg_pool2d(x, 3, 1, 1)`` at each of the net's average
    pools, to f32 rounding."""
    _, _, side, c = pool
    x = _input(side, c, batch=1).requires_grad_(True)
    g = _input(side, c, batch=1, seed=1)
    want, = torch.autograd.grad(LIBRARY["avg"](x), x, g)
    torch.testing.assert_close(_avg_grad_model(g), want, rtol=2e-6, atol=2e-7)


@pytest.mark.parametrize("side", [7, 8, 9])
def test_the_max_gradient_is_the_librarys(side):
    """The max pool's gradient, as the kernel gathers it, is the library's
    backward of ``F.max_pool2d(x, 3, 2)`` to the bit, with ties (small
    whole numbers) and a NaN in the input, and whole-number gradients."""
    g = torch.Generator().manual_seed(side)
    x = torch.randint(0, 3, (2, 3, side, side), generator=g).float()
    x[1, 2, 3, 4] = torch.nan
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    out = LIBRARY["max"](x)
    grad = torch.randint(-4, 5, out.shape, generator=g).float()
    want, = torch.autograd.grad(out, x, grad)
    assert torch.equal(_max_grad_model(x.detach(), grad), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_inception_plan_logits_on_the_cpu_are_what_the_library_pools_give(monkeypatch, dtype):
    """Inception-v3's module plan on the CPU gives, bit for bit, the logits
    of the same net with the library's pools called directly, and launches
    nothing."""
    bundle = create_model("inception_v3", "imagenet", num_classes=10)
    plan = ModulePlan(bundle.module, bundle.init(3), dtype, "cpu")
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 75, 75, 3, generator=g).to(dtype)
    before = pn.pool_nhwc.launches
    with torch.inference_mode():
        got = plan(x)
        monkeypatch.setattr(inception, "_avg3", LIBRARY["avg"])
        monkeypatch.setattr(inception, "_max3s2", LIBRARY["max"])
        want = plan(x)
    assert pn.pool_nhwc.launches == before
    assert torch.equal(got, want)
