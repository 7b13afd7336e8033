"""Port vs JAX package: window masks, masking, window starts, and B1's plain
version (``masked_batch``) against the XLA formulation and the Pallas kernel
in interpret mode. All comparisons are bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_interpretation_imagenet_tpu.ops import masking as jmask
from network_interpretation_imagenet_tpu.ops.pallas_masking import (
    masked_batch_pallas,
    masked_batch_xla,
)
from network_interpretation_imagenet_tpu_torch.ops import masking
from network_interpretation_imagenet_tpu_torch.ops.masked_batch import (
    masked_batch,
    masked_batch_plain,
)

_DTYPES = [(jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)]


def _case(rng, h=16, w=16, c=3, s=12):
    img = rng.randn(h, w, c).astype(np.float32)
    seg = rng.randint(0, s, (h, w)).astype(np.int32)
    return img, seg


def _f32(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("width", [4, np.array([1, 3, 5, 99], np.int32)])
def test_window_masks_and_apply_match_jax(rng, width):
    img, seg = _case(rng)
    firsts = np.array([0, 3, 7, 11], np.int32)  # the last window runs past S=12
    want = np.asarray(jmask.window_masks(jnp.asarray(seg), jnp.asarray(firsts), width))
    got = masking.window_masks(torch.from_numpy(seg), firsts, width).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        masking.apply_masks(torch.from_numpy(img), torch.from_numpy(got)).numpy(),
        np.asarray(jmask.apply_masks(jnp.asarray(img), jnp.asarray(want))))


def test_sample_window_starts_host_matches_jax():
    for seed, num, s, width in [(0, 100, 40, 16), (3, 7, 5, 4), (9, 32, 2, 1)]:
        np.testing.assert_array_equal(
            masking.sample_window_starts_host(seed, num, s, width),
            jmask.sample_window_starts_host(seed, num, s, width))


def test_sample_window_starts_range_and_determinism():
    def draw(seed):
        return masking.sample_window_starts(torch.Generator().manual_seed(seed), 500, 40, 16)

    a = draw(0)
    assert a.dtype == torch.int32 and a.shape == (500,)
    assert int(a.min()) == 1 and int(a.max()) == 40 - 16  # inclusive range, both ends hit
    assert torch.equal(a, draw(0)) and not torch.equal(a, draw(1))
    tiny = masking.sample_window_starts(torch.Generator().manual_seed(0), 50, 3, 2)
    assert set(tiny.tolist()) == {1}  # S - width < 1: guarded to [1, 1]


@pytest.mark.parametrize("jdt,tdt,shape", [
    pytest.param(jnp.bfloat16, torch.bfloat16, (16, 16, 3), id="bfloat16-tdt0"),
    pytest.param(jnp.float32, torch.float32, (16, 16, 3), id="float32-tdt1"),
    # H*W*C = 273 is odd: rows start at every residue mod 16 bytes.
    pytest.param(jnp.bfloat16, torch.bfloat16, (13, 7, 3), id="odd-hwc-bfloat16"),
    pytest.param(jnp.float32, torch.float32, (13, 7, 3), id="odd-hwc-float32"),
])
def test_masked_batch_plain_matches_xla_and_pallas(rng, jdt, tdt, shape):
    img, seg = _case(rng, *shape)
    firsts = np.array([0, 3, 7, 11], np.int32)
    args = (jnp.asarray(img), jnp.asarray(seg), jnp.asarray(firsts), jnp.int32(4))
    xla = masked_batch_xla(*args, out_dtype=jdt)
    pallas = masked_batch_pallas(*args, out_dtype=jdt, interpret=True)
    timg, tseg, tfirsts = (torch.from_numpy(a) for a in (img, seg, firsts))
    plain = masked_batch_plain(timg, tseg, tfirsts, 4, tdt)
    wrapped = masked_batch(timg, tseg, tfirsts, 4, tdt)  # CPU tensors: the plain version
    assert plain.dtype == wrapped.dtype == tdt and plain.shape == (4, *shape)
    for got in (plain, wrapped):
        np.testing.assert_array_equal(_f32(got), _f32(xla))
        np.testing.assert_array_equal(_f32(got), _f32(pallas))


@pytest.mark.parametrize("jdt,tdt", _DTYPES)
def test_masked_batch_clipping_matches_pallas(rng, jdt, tdt):
    img = rng.rand(8, 8, 1).astype(np.float32)
    seg = (np.arange(64).reshape(8, 8) % 5).astype(np.int32)
    firsts = np.array([4], np.int32)
    want = masked_batch_pallas(jnp.asarray(img), jnp.asarray(seg), jnp.asarray(firsts),
                               jnp.int32(99), out_dtype=jdt, interpret=True)
    got = masked_batch(torch.from_numpy(img), torch.from_numpy(seg),
                       torch.from_numpy(firsts), 99, tdt)
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_masked_batch_cpu_does_not_count_launches(rng):
    img, seg = _case(rng)
    before = masked_batch.launches
    masked_batch(torch.from_numpy(img), torch.from_numpy(seg),
                 torch.tensor([1, 2], dtype=torch.int32), 3)
    assert masked_batch.launches == before
    with pytest.raises(ValueError):
        masked_batch(torch.from_numpy(img), torch.from_numpy(seg[:4]),
                     torch.tensor([1], dtype=torch.int32), 3)


@pytest.mark.parametrize("k", [1, 3, 256, 1024, 7, 1000])
@pytest.mark.parametrize("hwc", [224 * 224 * 3, 13 * 7, 64 * 64 * 4, 299 * 299 * 3, 5])
def test_masked_batch_launch_plan_covers(k, hwc):
    """The grid covers every element and mask; and at every residue of the
    output's address, the kernel's split (the model beside launch_plan)
    walks each row of each block once, at that row's own shift, and writes
    each element of the row exactly once: 16-byte stores on 16-byte
    boundaries for the row's whole words, scalar stores for its head and
    tail only."""
    from network_interpretation_imagenet_tpu_torch.ops import masked_batch as mb

    group, grid_x, grid_y = mb.launch_plan(k, hwc)
    assert 1 <= group <= mb.MAX_GROUP
    assert grid_x * mb.THREADS * mb.PER_THREAD >= hwc > (grid_x - 1) * mb.THREADS * mb.PER_THREAD
    assert grid_y * group >= k > (grid_y - 1) * group
    assert grid_y <= 65535
    for itemsize in (2, 4):
        v = 16 // itemsize
        for base in range(v):
            out_offset = (1 << 20) * v + base  # the output's address in elements
            # The plan's group, and groups that hold whole residue periods.
            for g in sorted({group, 7, mb.MAX_GROUP}):
                walked = np.zeros(k, np.int64)
                for k0 in range(0, k, g):
                    for shift, rows in mb.residue_classes(out_offset, k0, min(g, k - k0), hwc,
                                                          itemsize):
                        rows = np.asarray(rows)
                        assert (mb.row_shift(out_offset, rows, hwc, itemsize) == shift).all()
                        walked[rows] += 1
                assert (walked == 1).all()
            shifts = mb.row_shift(out_offset, np.arange(k), hwc, itemsize)
            assert (shifts == 0).all() or not mb.aligned(out_offset, hwc, itemsize)
            for shift in np.unique(shifts):
                vec, scalar = mb.thread_stores(int(shift), hwc, grid_x, itemsize)
                row = int(np.flatnonzero(shifts == shift)[0])
                assert ((out_offset + row * hwc + vec) % v == 0).all()
                body = np.sort(vec)
                assert np.array_equal(body, shift + v * np.arange(len(body)))
                end = shift + v * len(body)
                assert np.array_equal(np.sort(scalar), np.concatenate(
                    [np.arange(min(shift, hwc)), np.arange(max(end, min(shift, hwc)), hwc)]))
                assert len(scalar) < 2 * v
                written = np.concatenate([(vec[:, None] + np.arange(v)).ravel(), scalar])
                assert np.array_equal(np.bincount(written, minlength=hwc), np.ones(hwc, np.int64))


@pytest.mark.parametrize("tdt,shape", [
    pytest.param(torch.bfloat16, (16, 16, 3), id="tdt0"),
    pytest.param(torch.float32, (16, 16, 3), id="tdt1"),
    pytest.param(torch.bfloat16, (13, 7, 3), id="odd-hwc-bfloat16"),
    pytest.param(torch.float32, (13, 7, 3), id="odd-hwc-float32"),
])
def test_masked_batch_out_slices_equal_the_default(rng, tdt, shape):
    """``out=`` writes each image's masks into its slice of one batch buffer,
    the values the default (a new tensor) gives, and JAX's XLA formulation
    and Pallas kernel give, also for slices at odd mask offsets; a wrong
    buffer raises."""
    cases = [_case(rng, *shape) for _ in range(2)]
    firsts = torch.tensor([[0, 5, 9], [2, 3, 11]], dtype=torch.int32)
    batch = torch.full((6, *shape), float("nan"), dtype=tdt)
    for i, (img, seg) in enumerate(cases):
        got = masked_batch(torch.from_numpy(img), torch.from_numpy(seg), firsts[i], 4, tdt,
                           out=batch[3 * i:3 * i + 3])
        assert got.data_ptr() == batch[3 * i].data_ptr()
    want = torch.cat([masked_batch(torch.from_numpy(img), torch.from_numpy(seg), firsts[i], 4, tdt)
                      for i, (img, seg) in enumerate(cases)])
    assert torch.equal(batch, want)
    # Slices that start at every mask offset 1..7 of a buffer, the first
    # image's masks, against the JAX formulations.
    img, seg = cases[0]
    jdt = jnp.bfloat16 if tdt == torch.bfloat16 else jnp.float32
    big = torch.full((7 + 3, *shape), float("nan"), dtype=tdt)
    jargs = (jnp.asarray(img), jnp.asarray(seg), jnp.asarray(firsts[0].numpy()), jnp.int32(4))
    for ref in (masked_batch_xla(*jargs, out_dtype=jdt),
                masked_batch_pallas(*jargs, out_dtype=jdt, interpret=True)):
        for j in range(1, 8):
            masked_batch(torch.from_numpy(img), torch.from_numpy(seg), firsts[0], 4, tdt,
                         out=big[j:j + 3])
            np.testing.assert_array_equal(_f32(big[j:j + 3]), _f32(ref))
    img, seg = (torch.from_numpy(a) for a in cases[0])
    for bad in (torch.empty((2, *shape), dtype=tdt),                          # shape
                torch.empty((3, *shape), dtype=torch.float16),                # dtype
                torch.empty((3, shape[0], shape[2], shape[1]),
                            dtype=tdt).transpose(2, 3)):                      # not contiguous
        with pytest.raises(ValueError):
            masked_batch(img, seg, firsts[0], 4, tdt, out=bad)


@pytest.mark.parametrize("tdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(16, 16, 3), (13, 7, 3)])
def test_masked_batch_hands_the_row_plan_to_the_kernel(monkeypatch, tdt, shape):
    """The wrapper passes the kernel the instance and residue period of the
    output's real address (``row_plan``), for out= slices at every mask
    offset: 1 (shift 0 throughout) only where every row starts on a 16-byte
    boundary. Meta tensors stand in for the card's, with addresses of their
    own; a fake library records the entry's arguments."""
    import math

    from network_interpretation_imagenet_tpu_torch.ops import _cuda_build
    from network_interpretation_imagenet_tpu_torch.ops import masked_batch as mb

    calls = []

    class FakeLibrary:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(_cuda_build, "library", lambda name, sigs: FakeLibrary())
    monkeypatch.setattr(_cuda_build, "stream_ptr", lambda device: None)
    monkeypatch.setattr(masked_batch, "launches", masked_batch.launches)
    meta = torch.device("meta")
    image = torch.empty(shape, dtype=torch.float32, device=meta)
    seg = torch.empty(shape[:2], dtype=torch.int32, device=meta)
    firsts = torch.empty(3, dtype=torch.int32, device=meta)
    hwc, size = math.prod(shape), tdt.itemsize
    big = torch.empty((8 + 3, *shape), dtype=tdt, device=meta)
    for j in range(8):
        masked_batch(image, seg, firsts, 4, tdt, out=big[j:j + 3])
        name, args = calls.pop()
        address = big[j:j + 3].data_ptr()
        assert name == mb._ENTRY[tdt] and args[5].value == (address or None)
        assert args[-3:-1] == (int(address % 16 == 0 and hwc * size % 16 == 0),
                               16 // math.gcd(hwc * size, 16))
    assert masked_batch.launches > 0


def test_masked_batch_out_off_element_alignment_raises(rng):
    """An ``out`` whose address is not a whole number of elements (which
    PyTorch does not make for itself) raises instead of falling back."""
    img, seg = (torch.from_numpy(a) for a in _case(rng, 13, 7, 3))
    firsts = torch.tensor([0, 5], dtype=torch.int32)
    n = 2 * 13 * 7 * 3
    odd = torch.frombuffer(bytearray(2 * n + 2), dtype=torch.bfloat16, offset=1, count=n)
    assert odd.data_ptr() % 2 == 1
    with pytest.raises(ValueError, match="aligned"):
        masked_batch(img, seg, firsts, 4, torch.bfloat16, out=odd.view(2, 13, 7, 3))


@pytest.mark.parametrize("width_shape", [(), (1,)])
def test_masked_batch_width_tensor_equals_int(rng, width_shape):
    """A width given as an int32 tensor (which the kernel reads on the
    device) gives what the int gives."""
    img, seg = (torch.from_numpy(a) for a in _case(rng))
    firsts = torch.tensor([0, 5, 9, 13], dtype=torch.int32)
    for tdt in (torch.bfloat16, torch.float32):
        want = masked_batch(img, seg, firsts, 4, tdt)
        got = masked_batch(img, seg, firsts, torch.full(width_shape, 4, dtype=torch.int32), tdt)
        assert torch.equal(got, want)
