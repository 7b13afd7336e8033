"""E1, a convolution's bias, residual and ReLU in one pass
(``ops/epilogue_nhwc.py``), on the CPU: the plain twin at every epilogue
shape of ResNeXt-101 32x8d and ResNet-101 against the formula computed in
numpy, and against the library op sequence the folded plan ran before; the
kernel's grid at those shapes; the wrapper's raises, its route and what it
hands the kernel's entries. The kernel itself runs only on the card
(``chip_smoke.py --epilogue``)."""

import numpy as np
import pytest
import torch

from network_interpretation_imagenet_tpu_torch.models import FoldedResNet, create_model
from network_interpretation_imagenet_tpu_torch.ops import _cuda_build
from network_interpretation_imagenet_tpu_torch.ops import epilogue_nhwc as en

# The (H, W, C, residual) of the epilogues of a forward at 224^2, each once,
# in the order the forward first runs them (test_the_shapes_are_the_nets
# records them from the plans).
RESNEXT101 = [(112, 112, 64, False), (56, 56, 256, False), (56, 56, 256, True),
              (56, 56, 512, False), (28, 28, 512, False), (28, 28, 512, True),
              (28, 28, 1024, False), (14, 14, 1024, False), (14, 14, 1024, True),
              (14, 14, 2048, False), (7, 7, 2048, False), (7, 7, 2048, True)]
RESNET101 = [(112, 112, 64, False), (56, 56, 64, False), (56, 56, 256, True),
             (56, 56, 128, False), (28, 28, 128, False), (28, 28, 512, True),
             (28, 28, 256, False), (14, 14, 256, False), (14, 14, 1024, True),
             (14, 14, 512, False), (7, 7, 512, False), (7, 7, 2048, True)]
SHAPES = list(dict.fromkeys(RESNEXT101 + RESNET101))
SHAPE_IDS = [f"{h}x{w}x{c}{'+res' if res else ''}" for h, w, c, res in SHAPES]
DTYPES = [torch.bfloat16, torch.float32]


def _tensor(shape, dtype, batch=2, seed=0):
    h, w, c = shape[:3]
    g = torch.Generator().manual_seed(seed + h + c)
    return torch.randn(batch, c, h, w, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)


def _inputs(shape, dtype, batch=2):
    """(y, f32 bias [C], residual or None) at ``shape`` (H, W, C, residual)."""
    c = shape[2]
    bias = torch.randn(c, generator=torch.Generator().manual_seed(c)) * 0.5
    res = _tensor(shape, dtype, batch, seed=1) if shape[3] else None
    return _tensor(shape, dtype, batch), bias, res


def _bits(t):
    return t.contiguous().view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype])


def _numpy_epilogue(y, bias, res):
    """``round(relu((f32(y) + bias) + f32(res)))`` in numpy f32, rounded to
    bf16 (to nearest even, on the bits) where ``y`` is bf16: its bits."""
    s = y.float().numpy() + bias.numpy()[None, :, None, None]
    if res is not None:
        s = s + res.float().numpy()
    s = np.where(s < 0, np.float32(0), s).astype(np.float32)
    if y.dtype == torch.float32:
        return s.view(np.int32)
    u = s.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16).view(np.int16)


@pytest.mark.parametrize("arch, want, blocks", [("resnext101_32x8d", RESNEXT101, 33),
                                                 ("resnet101", RESNET101, 4)])
def test_the_shapes_are_the_nets(monkeypatch, arch, want, blocks):
    """One f32 forward of ``arch``'s folded plan at 224^2 through the
    epilogue route (the plain twin) runs the stem's epilogue and three in
    each eager block (every block of ResNeXt-101, each stage's first of
    ResNet-101), the last with the residual, at the shapes listed above."""
    seen = []

    def spy(y, bias, res=None):
        seen.append((y.shape[2], y.shape[3], y.shape[1], res is not None))
        return en.epilogue_nhwc_plain(y, bias, res)

    bundle = create_model(arch, num_classes=10)
    plan = FoldedResNet(bundle.init(2), bundle.module.stage_sizes, torch.float32)
    monkeypatch.setattr(FoldedResNet, "_epilogue", staticmethod(lambda device, plain: spy))
    with torch.inference_mode():
        plan(torch.zeros(1, 224, 224, 3))
    assert len(seen) == 1 + 3 * blocks
    assert [r for *_, r in seen] == [False] + [False, False, True] * blocks
    assert list(dict.fromkeys(seen)) == want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_twin_is_the_formula_bit_for_bit(shape, dtype):
    """At each epilogue shape (batch 2), the plain twin gives numpy's f32
    ``relu((y + bias) + res)`` rounded once, to the bit, in place and
    channels_last; on the CPU the wrapper takes it and launches nothing."""
    y, bias, res = _inputs(shape, dtype)
    want = _numpy_epilogue(y, bias, res)
    y_in = y.clone()
    got = en.epilogue_nhwc_plain(y, bias, res)
    assert got is y and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_bits(got).numpy(), want)
    before = en.epilogue_nhwc.launches
    assert torch.equal(en.epilogue_nhwc(y_in, bias, res), got)
    assert en.epilogue_nhwc.launches == before


def _bf16_ulp(x):
    """One bf16 unit in the last place at each |x| (2^-133 at 0)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_twin_against_the_old_op_sequence(shape):
    """Against what the plan ran before in bf16, with its bias in bf16: the
    broadcast bias add rounded to bf16, ReLU, and after a block's last
    convolution the residual add rounded again and ReLU. Without a residual
    the two are equal to the bit (one rounding each); with one they are
    within one bf16 ulp of the larger of the old partial sum ``y + bias``
    and the results (the old one rounds twice)."""
    y, bias, res = _inputs(shape, torch.bfloat16)
    bias16 = bias.to(torch.bfloat16)
    partial = y + bias16.view(1, -1, 1, 1)
    old = torch.relu(partial if res is None else partial + res)
    new = en.epilogue_nhwc_plain(y.clone(), bias16.float(), res)
    if res is None:
        assert torch.equal(_bits(new), _bits(old))
    else:
        scale = torch.maximum(partial.abs(), torch.maximum(old.abs(), new.abs()))
        assert ((new.float() - old.float()).abs() <= _bf16_ulp(scale)).all()


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_the_grid_covers_every_epilogue(shape, itemsize):
    """One thread per 16-byte word of ``rows_per_pass`` rows: at B=256
    TARGET_THREADS threads or more (each walks the rows in steps of the
    pass); at B=1 all the rows where they hold fewer words than that."""
    h, w, c, _ = shape
    words = c // (16 // itemsize)
    assert c % (16 // itemsize) == 0
    for batch in (1, 256):
        m = batch * h * w
        r = en.rows_per_pass(m, c, itemsize)
        assert 1 <= r <= m
        if m * words >= en.TARGET_THREADS:
            assert en.TARGET_THREADS <= r * words < en.TARGET_THREADS + words
        else:
            assert r == m
    assert en.rows_per_pass(256 * h * w, c, itemsize) * words >= en.TARGET_THREADS


class _FakeLibrary:
    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_kernel(monkeypatch):
    """A stand-in library that records each entry's arguments."""
    calls = []
    monkeypatch.setattr(_cuda_build, "library", lambda name, sigs: _FakeLibrary(calls))
    monkeypatch.setattr(_cuda_build, "stream_ptr", lambda device: None)
    monkeypatch.setattr(en.epilogue_nhwc, "launches", 0)
    return calls


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [SHAPES[0], (7, 7, 2048, True)], ids=["stem", "7x7x2048+res"])
def test_the_kernel_gets_the_shape_pointers_bias_and_residual(fake_kernel, shape, dtype):
    """The launch hands the entry of ``y``'s dtype y's, the residual's (or
    a null pointer) and the bias's addresses, the rows and channels, and
    :func:`rows_per_pass`'s rows; it returns ``y`` and counts the launch."""
    y, bias, res = _inputs(shape, dtype, batch=3)
    assert en.epilogue_nhwc_kernel(y, bias, res) is y
    (name, args), = fake_kernel
    m, c = 3 * shape[0] * shape[1], shape[2]
    assert name == {torch.bfloat16: "epilogue_nhwc_bf16", torch.float32: "epilogue_nhwc_f32"}[dtype]
    assert args[0] == y.data_ptr() and args[2] == bias.data_ptr()
    assert args[1] == (None if res is None else res.data_ptr())
    assert args[3:] == (m, c, en.rows_per_pass(m, c, dtype.itemsize), None)
    assert en.epilogue_nhwc.launches == 1


def test_inputs_the_kernel_does_not_take_raise_naming_the_shape(fake_kernel):
    """A dtype other than bf16 and f32, an NCHW tensor, a channel count off
    the 16-byte vector, a bias that is not f32 [C], and a residual of
    another shape or dtype, NCHW, overlapping ``y`` or off a 16-byte
    address raise; nothing is launched."""
    y, bias, res = _inputs((9, 9, 16, True), torch.bfloat16)
    shape = r"\(2, 16, 9, 9\)"
    cases = [
        (y.half(), bias, None, "float16"),
        (y.contiguous(), bias, None, "channels_last"),
        (_tensor((9, 9, 12), torch.bfloat16), bias[:12], None, "multiple of 8"),
        (_tensor((9, 9, 6), torch.float32), bias[:6], None, "multiple of 4"),
        (y, bias.to(torch.bfloat16), None, "float32"),
        (y, bias[:8], None, "float32"),
        (y, bias, res[:, :8], "residual"),
        (y, bias, res.float(), "residual"),
        (y, bias, res.contiguous(), "residual"),
        (y, bias, y, "overlaps"),
        (y, bias, torch.zeros(res.numel() + 1, dtype=res.dtype)[1:].view(2, 9, 9, 16).permute(
            0, 3, 1, 2), "aligned"),
    ]
    for y_, b_, r_, why in cases:
        want = r"\(2, \d+, 9, 9\)" if y_.shape[1] != 16 else shape
        with pytest.raises(ValueError, match=rf"{want}.*{why}"):
            en.epilogue_nhwc_kernel(y_, b_, r_)
    assert fake_kernel == [] and en.epilogue_nhwc.launches == 0


def test_the_route_sends_cpu_tensors_to_the_plain_twin(fake_kernel):
    """A CPU tensor, channels_last or NCHW, takes the plain twin (no
    launch); a tensor on another device takes the kernel."""
    y, bias, res = _inputs((9, 9, 16, True), torch.bfloat16)
    want = en.epilogue_nhwc_plain(y.clone(), bias, res)
    assert torch.equal(en.epilogue_nhwc(y.clone(), bias, res), want)
    assert torch.equal(en.epilogue_nhwc(y.contiguous(), bias, res.contiguous()), want)
    assert fake_kernel == [] and en.epilogue_nhwc.launches == 0
    en.epilogue_nhwc(y.to("meta"), bias.to("meta"))
    assert [name for name, _ in fake_kernel] == ["epilogue_nhwc_bf16"]
    assert en.epilogue_nhwc.launches == 1


def test_the_checks_run_once_a_set_of_shapes(fake_kernel, monkeypatch):
    """The shape, stride, dtype and device checks run at the first launch
    on a set of them and are kept; the addresses are checked at every
    launch: a residual that overlaps ``y`` raises after a launch with the
    same shapes went through."""
    y, bias, res = _inputs((5, 7, 32, True), torch.float32)
    made = []
    plan = en._plan
    monkeypatch.setattr(en, "_PLANS", {})
    monkeypatch.setattr(en, "_plan", lambda *a: made.append(a) or plan(*a))
    for _ in range(3):
        en.epilogue_nhwc_kernel(y, bias, res)
    en.epilogue_nhwc_kernel(y, bias)
    assert len(made) == 2 and len(fake_kernel) == 4
    with pytest.raises(ValueError, match="overlaps"):
        en.epilogue_nhwc_kernel(y, bias, y.clone().copy_(res).set_(y))
    assert len(made) == 2 and en.epilogue_nhwc.launches == 4
