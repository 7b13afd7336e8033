"""The ImageNet train pipeline (``data/imagenet_train.py``) against the JAX
package's, exactly: the random-resized-crop boxes, the augmented images of a
``TrainImageFolder`` on JPEGs this test writes, and ``epoch_batches``'
orders, ``skip`` and ``process_slice``. Both packages draw from the same
numpy streams in the same order, so every array is bit for bit equal."""

import numpy as np
import pytest

from network_interpretation_imagenet_tpu.data import imagenet_train as jtrain
from network_interpretation_imagenet_tpu_torch.data import imagenet_train as train


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Three classes of JPEGs of assorted sizes and aspects (one narrower
    than 3:4 and one wider than 4:3, which reach the crop's fallback more
    often)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("train")
    rng = np.random.RandomState(0)
    sizes = [(40, 30), (24, 64), (64, 20), (33, 33), (50, 41), (28, 36), (45, 45)]
    for c in range(3):
        (root / f"class{c}").mkdir()
        for i, (w, h) in enumerate(sizes[c:c + 4]):
            arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(root / f"class{c}" / f"img{i}.jpg", quality=90)
    return str(root)


@pytest.mark.parametrize("seed", range(4))
def test_random_resized_crop_box_matches_jax(seed):
    for width, height in ((500, 375), (64, 20), (20, 64), (224, 224), (7, 300)):
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(20):
            assert (train.random_resized_crop_box(rng, width, height)
                    == jtrain.random_resized_crop_box(jrng, width, height))


def test_train_image_folder_matches_jax(folder):
    ds, jds = train.TrainImageFolder(folder, crop=24, seed=3), jtrain.TrainImageFolder(
        folder, crop=24, seed=3)
    assert ds.items == jds.items and len(ds) == 12
    for epoch in (0, 1):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        for i in range(len(ds)):
            (x, y), (jx, jy) = ds[i], jds[i]
            assert x.dtype == jx.dtype == np.float32 and x.shape == (24, 24, 3)
            np.testing.assert_array_equal(x, jx)
            assert y == jy
    ds.set_epoch(0)
    ds1 = np.stack([ds[i][0] for i in range(4)])
    ds.set_epoch(1)
    assert not np.array_equal(ds1, np.stack([ds[i][0] for i in range(4)]))


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, workers=0),
    dict(shuffle=True, workers=3, drop_last=True),
    dict(shuffle=False, workers=2, indices=[5, 1, 7, 3, 9]),
    dict(shuffle=True, workers=2, skip=2),
    dict(shuffle=True, workers=2, process_slice=(1, 2)),
    dict(shuffle=True, workers=0, process_slice=(0, 2), skip=1),
])
def test_epoch_batches_match_jax(folder, kw):
    ds, jds = train.TrainImageFolder(folder, crop=16, seed=1), jtrain.TrainImageFolder(
        folder, crop=16, seed=1)
    for epoch in (0, 2):
        got = list(train.epoch_batches(ds, 4, epoch=epoch, seed=7, **kw))
        want = list(jtrain.epoch_batches(jds, 4, epoch=epoch, seed=7, **kw))
        assert len(got) == len(want) > 0
        for (x, y), (jx, jy) in zip(got, want):
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)


def test_skip_and_workers_do_not_change_the_stream(folder):
    """A resumed epoch (``skip``) yields the uninterrupted epoch's tail, and
    the worker count changes nothing."""
    ds = train.TrainImageFolder(folder, crop=16, seed=1)
    full = list(train.epoch_batches(ds, 3, epoch=1, seed=2, workers=0))
    for workers in (0, 4):
        tail = list(train.epoch_batches(ds, 3, epoch=1, seed=2, workers=workers, skip=1))
        assert len(tail) == len(full) - 1
        for (x, y), (fx, fy) in zip(tail, full[1:]):
            np.testing.assert_array_equal(x, fx)
            np.testing.assert_array_equal(y, fy)
