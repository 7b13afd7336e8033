"""The port's val-set sweep (saliency/sweep.py, saliency/journal.py) against
the JAX package's, f32 on the CPU, and its helpers (utils/logging.py,
utils/meters.py, data/prefetch.py, ops/preprocess.py).

Both packages run the reduced ResNet of tests/test_torch_bo.py (random
weights and BatchNorm statistics, the JAX weights reaching the port through
``resnet_from_jax``) on the three fixture images at 64^2. The dataset holds
a correctly labelled image, a misclassified one, a malformed item (it
raises) and an unlabelled one. The window and knockout sweeps draw their
masks on the host from numpy's RandomState in both packages, so rows,
heatmaps and counts are compared exactly; fidelity AUCs within 1e-5."""

import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_interpretation_imagenet_tpu import models as jmodels
from network_interpretation_imagenet_tpu.config import SegmentConfig as JSegmentConfig
from network_interpretation_imagenet_tpu.models.resnet_imagenet import Bottleneck
from network_interpretation_imagenet_tpu.models.resnet_imagenet import ResNet as JaxResNet
from network_interpretation_imagenet_tpu.ops import aggregate as jaggregate
from network_interpretation_imagenet_tpu.ops import preprocess as jpre
from network_interpretation_imagenet_tpu.saliency import journal as jjournal
from network_interpretation_imagenet_tpu.saliency import sweep as jsweep
from network_interpretation_imagenet_tpu.saliency.engine import SaliencyEngine as JaxEngine
from network_interpretation_imagenet_tpu.utils import logging as jlogging
from network_interpretation_imagenet_tpu_torch.config import SegmentConfig
from network_interpretation_imagenet_tpu_torch.data.imagenet_loc import (
    ImagenetLocalizationDataset,
)
from network_interpretation_imagenet_tpu_torch.data.prefetch import prefetch
from network_interpretation_imagenet_tpu_torch.models import ModelBundle, ResNet
from network_interpretation_imagenet_tpu_torch.ops import preprocess
from network_interpretation_imagenet_tpu_torch.saliency import sweep
from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
from network_interpretation_imagenet_tpu_torch.saliency.journal import SweepJournal
from network_interpretation_imagenet_tpu_torch.utils.convert import resnet_from_jax
from network_interpretation_imagenet_tpu_torch.utils.logging import PhaseLogger
from network_interpretation_imagenet_tpu_torch.utils.meters import AverageMeter
from torch_port_util import flax_resnet_variables, randomize_bn

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "imagenet_loc")
STAGES = (1, 2, 1, 2)
K = 12            # masks per image: one full chunk of 8 and a remainder
FID_TOL = 1e-5    # fidelity AUCs, port vs JAX


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (pytest-xdist workers would
    oversubscribe the host; these shapes gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    """(port engine, JAX engine, dataset items): the reduced ResNet of
    tests/test_torch_bo.py in both packages, f32 on the CPU, mask_batch 8,
    and four items: image 0 labelled with its prediction, image 1 with
    another class, a malformed item, image 2 unlabelled."""
    ds = ImagenetLocalizationDataset(FIXTURE, crop=64)
    module = JaxResNet(stage_sizes=STAGES, block=Bottleneck, num_classes=10)
    bundle = ModelBundle("r", ResNet(STAGES, num_classes=10), 64, 3, 10)
    state_dict = bundle.init(4)
    for name, w in state_dict.items():
        if w.dim() == 4:   # LeCun-normal scale, as flax draws it
            state_dict[name] = w * (w.shape[0] / (2.0 * w.shape[1])) ** 0.5
    variables = flax_resnet_variables(state_dict, STAGES)
    randomize_bn(variables["params"], variables["batch_stats"], np.random.RandomState(5))
    jengine = JaxEngine(jmodels.ModelBundle("r", module, 64, 3, 10), variables, mask_batch=8,
                        compute_dtype=jnp.float32)
    engine = SaliencyEngine(bundle, resnet_from_jax(variables), mask_batch=8,
                            compute_dtype=torch.float32, device="cpu")
    imgs = [ds[i] for i in range(3)]
    preds = [engine.predict_one(img)[0] for img, _, _ in imgs]
    items = [(imgs[0][0], preds[0], imgs[0][2]),
             (imgs[1][0], (preds[1] + 1) % 10, imgs[1][2]),
             ("malformed",),
             (imgs[2][0], None, imgs[2][2])]
    return engine, jengine, items


def _rows(res):
    return sorted(({k: v for k, v in r.items() if k != "seconds"} for r in res.per_image),
                  key=lambda r: r["index"])


def _assert_same_sweep(got, want, fid_tol=0.0):
    """Counts, rows (without the wall-clock ``seconds``) and heatmaps."""
    for key in ("images_total", "images_explained", "images_skipped_misclassified",
                "images_failed"):
        assert getattr(got, key) == getattr(want, key), key
    rows, jrows = _rows(got), _rows(want)
    assert [r["index"] for r in rows] == [r["index"] for r in jrows]
    for r, j in zip(rows, jrows):
        assert set(r) == set(j)
        for k in r:
            if k in ("deletion_auc", "insertion_auc"):
                assert abs(r[k] - j[k]) <= fid_tol, (k, r[k], j[k])
            else:
                assert r[k] == j[k], (k, r[k], j[k])
    assert set(got.heatmaps) == set(want.heatmaps)
    for i in want.heatmaps:
        np.testing.assert_array_equal(got.heatmaps[i], np.asarray(want.heatmaps[i]))
    assert got.mean_iou == pytest.approx(want.mean_iou, abs=1e-12)
    assert got.mean_survival == pytest.approx(want.mean_survival, abs=1e-12)


@pytest.mark.parametrize("image_batch,mode,method", [
    (1, "window", "felzenszwalb"), (2, "window", "slic"),
    (1, "knockout", "felzenszwalb"), (2, "knockout", "felzenszwalb")])
def test_saliency_sweep_matches_jax(engines, image_batch, mode, method):
    """Streaming (image_batch 1) and batched-flush (2) sweeps: the same rows,
    heatmaps, skipped and failed counts as the JAX package."""
    engine, jengine, items = engines
    kw = dict(num_mask_samples=K, image_batch=image_batch, mode=mode, num_knockout=2,
              keep_heatmaps=True, seed=3)
    got = sweep.saliency_sweep(engine, items, SegmentConfig(method=method), **kw)
    want = jsweep.saliency_sweep(jengine, items, JSegmentConfig(method=method), **kw)
    _assert_same_sweep(got, want)
    assert (got.images_total, got.images_explained, got.images_skipped_misclassified,
            got.images_failed) == (4, 2, 1, 1)
    surv = [r["survival"] for r in got.per_image]
    assert any(0.0 < s < 1.0 for s in surv), "every mask alike: a weak test"
    assert all("iou" in r for r in got.per_image)


@pytest.mark.parametrize("mode", ["window", "knockout"])
def test_streaming_lane_hands_the_engine_device_tensors(engines, mode):
    """The streaming lane through a recording engine, as the benchmark's
    harness wraps it: one ``collect`` per dispatched image with its K
    outcomes, and the prediction and the masked forwards given tensors on
    the engine's device (the lane's own uploads), never host arrays."""
    engine, _, items = engines
    calls = {"collect": [], "predict": [], "dispatch": []}
    dispatch_name = f"eval_{mode}_masks_async"
    originals = {n: getattr(engine, n) for n in ("collect", "predict_logits_device",
                                                 dispatch_name)}

    def record(name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls[name].append(out if name == "collect" else args)
            return out
        return wrapped

    engine.collect = record("collect", originals["collect"])
    engine.predict_logits_device = record("predict", originals["predict_logits_device"])
    setattr(engine, dispatch_name, record("dispatch", originals[dispatch_name]))
    try:
        res = sweep.saliency_sweep(engine, items, SegmentConfig(), num_mask_samples=K,
                                   mode=mode, num_knockout=2, seed=3)
    finally:
        for n in originals:
            delattr(engine, n)
    dispatched = res.images_explained + res.images_skipped_misclassified
    assert (res.images_explained, dispatched) == (2, 3)
    assert len(calls["collect"]) == len(calls["predict"]) == len(calls["dispatch"]) == dispatched
    assert all(len(r.survived) == K for r in calls["collect"])
    for args in calls["predict"] + [a[:3] for a in calls["dispatch"]]:
        assert all(isinstance(a, torch.Tensor) and a.device == engine.device
                   for a in args if not isinstance(a, int))
    assert [a[0].shape for a in calls["predict"]] == [(1, 64, 64, 3)] * dispatched


@pytest.mark.parametrize("mode", ["window", "knockout", "empty"])
def test_outcomes_handle_collects_as_the_plain_list(engines, mode):
    """An ``Outcomes`` handle (off the card, no event) collects to the
    same result as the plain list of its chunks, the empty one too."""
    from network_interpretation_imagenet_tpu_torch.saliency.engine import Outcomes

    engine, _, items = engines
    image = items[0][0]
    seg = np.asarray(sweep.segment_image(sweep._display(image), SegmentConfig()), np.int32)
    s = int(seg.max()) + 1
    if mode == "window":
        handle = engine.eval_window_masks_async(image, seg, np.arange(K, dtype=np.int32) % s,
                                                max(1, s // 3), 1)
    elif mode == "knockout":
        handle = engine.eval_knockout_masks_async(
            image, seg, (np.arange(2 * K, dtype=np.int32) % s).reshape(K, 2), 1)
    else:
        handle = Outcomes()
    assert type(handle) is Outcomes and handle.done is None
    assert len(handle) == (0 if mode == "empty" else 2)   # a chunk of 8 and the remainder
    got, want = engine.collect(handle), engine.collect(list(handle))
    for field in ("survived", "preds", "prob_target", "prob_max"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape == ((0,) if mode == "empty" else (K,))
        np.testing.assert_array_equal(a, b)


def test_fidelity_rows_match_jax(engines):
    engine, jengine, items = engines
    kw = dict(num_mask_samples=K, fidelity_steps=4, seed=1)
    got = sweep.saliency_sweep(engine, items, SegmentConfig(), **kw)
    want = jsweep.saliency_sweep(jengine, items, JSegmentConfig(), **kw)
    _assert_same_sweep(got, want, fid_tol=FID_TOL)
    assert all("deletion_auc" in r and "pointing" in r for r in got.per_image)
    for key in ("mean_deletion_auc", "mean_insertion_auc", "pointing_game_acc"):
        assert abs(getattr(got, key) - getattr(want, key)) <= FID_TOL, key


# --- journal ------------------------------------------------------------------


def test_journal_bytes_match_jax(tmp_path):
    """The same events through both packages' journals: the same bytes, and
    the same restore."""
    config = {"mode": "window", "seed": 0, "segmenter": {"method": "slic", "scale": None}}
    events = [{"event": "image_done", "index": 0, "target": 3, "survival": 0.5,
               "iou": 0.25, "seconds": 0.1},
              {"event": "skip_misclassified", "index": 1, "pred": 3, "label": 4},
              {"event": "image_failed", "index": 2, "error": "ValueError('x')"},
              {"event": "batch_failed", "indices": [4, 5], "error": "boom"},
              {"event": "image_done", "index": 3, "target": np.int64(2), "survival": 1.0}]
    paths = {}
    for name, cls in (("port", SweepJournal), ("jax", jjournal.SweepJournal)):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        j = cls(paths[name], config=config)
        for ev in events:
            j.record(ev)
        j.close()
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    with open(paths["port"], "a") as f:
        f.write('{"event": "image_done", "ind')  # a torn tail
    got = SweepJournal(paths["port"], resume=True, config=config)
    want = jjournal.SweepJournal(paths["jax"], resume=True, config=config)
    assert got.done == want.done == {0, 1, 3}
    assert got.restored_rows == want.restored_rows and got.restored_skips == 1
    got.close()
    want.close()


def test_journal_refuses_a_mismatched_config(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = SweepJournal(path, config={"seed": 0})
    j.record({"event": "image_done", "index": 0})
    j.close()
    with pytest.raises(ValueError) as got:
        SweepJournal(path, resume=True, config={"seed": 1})
    with pytest.raises(ValueError) as want:
        jjournal.SweepJournal(path, resume=True, config={"seed": 1})
    assert str(got.value) == str(want.value)
    assert "journal config mismatch" in str(got.value)


def test_journal_heatmap_roundtrip(tmp_path):
    j = SweepJournal(str(tmp_path / "j.jsonl"), keep_heatmaps=True)
    heat = np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0
    j.save_heatmap(5, heat)
    np.testing.assert_array_equal(j.load_heatmap(5), heat)
    assert j.load_heatmap(6) is None
    j.close()


@pytest.mark.parametrize("image_batch", [1, 2])
def test_resume_equals_an_uninterrupted_run(engines, tmp_path, image_batch):
    """A sweep cut after two images and resumed from its journal gives the
    uninterrupted run's rows, heatmaps and counts; its journal holds the
    JAX package's events (without the wall-clock seconds)."""
    engine, jengine, items = engines
    kw = dict(num_mask_samples=K, keep_heatmaps=True, image_batch=image_batch, seed=2)
    ref = sweep.saliency_sweep(engine, items, SegmentConfig(), **kw)
    path = str(tmp_path / "j.jsonl")
    j1 = SweepJournal(path, keep_heatmaps=True, config={"k": K})
    part = sweep.saliency_sweep(engine, items, SegmentConfig(), max_images=2, journal=j1, **kw)
    j1.close()
    assert part.images_total == 2
    j2 = SweepJournal(path, resume=True, keep_heatmaps=True, config={"k": K})
    assert j2.done == {0, 1}  # one explained, one misclassified: both terminal
    res = sweep.saliency_sweep(engine, items, SegmentConfig(), journal=j2, **kw)
    j2.close()
    _assert_same_sweep(res, ref)
    assert res.images_total == ref.images_total == 4

    jpath = str(tmp_path / "jax.jsonl")
    jj = jjournal.SweepJournal(jpath, keep_heatmaps=True, config={"k": K})
    jsweep.saliency_sweep(jengine, items, JSegmentConfig(), max_images=2, journal=jj, **kw)
    jj.close()

    def events(p):
        return [{k: v for k, v in json.loads(line).items() if k != "seconds"}
                for line in open(p) if line.strip()]

    assert events(str(tmp_path / "j.jsonl"))[:len(events(jpath))] == events(jpath)


@pytest.mark.parametrize("lane,image_batch", [("window", 1), ("window", 2), ("knockout", 1),
                                              ("bo", 2)])
def test_journal_event_keys_in_the_jax_packages_order(engines, tmp_path, lane, image_batch):
    """Every journal line a sweep writes (the config stamp, image_done,
    skip_misclassified, image_failed and, in a flush of two images of
    different shapes, batch_failed) carries the JAX package's keys in the
    JAX package's order, event for event."""
    from network_interpretation_imagenet_tpu.config import BOConfig as JBOConfig
    from network_interpretation_imagenet_tpu_torch.config import BOConfig

    engine, jengine, items = engines
    items = list(items)
    if image_batch > 1:  # the last flush stacks 64^2 and 48^2: it fails as a batch
        items.append((items[3][0][:48, :48], None, None))
    runs = {}
    for name, mod, eng, seg_cfg, bo_cfg, journal in (
            ("port", sweep, engine, SegmentConfig(), BOConfig(n_iters=2, n_pre_samples=2),
             SweepJournal),
            ("jax", jsweep, jengine, JSegmentConfig(), JBOConfig(n_iters=2, n_pre_samples=2),
             jjournal.SweepJournal)):
        path = str(tmp_path / f"{name}.jsonl")
        j = journal(path, config={"lane": lane})
        if lane == "bo":
            mod.bo_saliency_sweep(eng, items, seg_cfg, bo_cfg, image_batch=image_batch, seed=1,
                                  journal=j)
        else:
            mod.saliency_sweep(eng, items, seg_cfg, num_mask_samples=K, image_batch=image_batch,
                               mode=lane, seed=1, journal=j)
        j.close()
        runs[name] = [json.loads(line) for line in open(path) if line.strip()]
    assert [list(ev) for ev in runs["port"]] == [list(ev) for ev in runs["jax"]]
    assert {ev["event"] for ev in runs["port"]} == (
        {"config", "image_done", "skip_misclassified", "image_failed"}
        | ({"batch_failed"} if image_batch > 1 else set()))


# --- BO sweep -----------------------------------------------------------------


def test_bo_sweep_rows_equal_single_image_calls(engines):
    """Each row of the batched BO sweep equals the port's own
    bo_window_saliency(seed=seed + index) on that image."""
    from network_interpretation_imagenet_tpu_torch.config import BOConfig
    from network_interpretation_imagenet_tpu_torch.saliency.bo_pipeline import (
        bo_window_saliency,
    )
    from network_interpretation_imagenet_tpu_torch.segment.common import segment_image

    engine, _, items = engines
    cfg = BOConfig(n_iters=2, n_pre_samples=2)
    res = sweep.bo_saliency_sweep(engine, items, SegmentConfig(), bo_cfg=cfg, image_batch=2,
                                  seed=7, keep_heatmaps=True)
    assert (res.images_total, res.images_explained, res.images_skipped_misclassified,
            res.images_failed) == (4, 2, 1, 1)
    for row in res.per_image:
        img = items[row["index"]][0]
        seg = segment_image(sweep._display(img), SegmentConfig())
        out, tr = bo_window_saliency(engine, img, seg, cfg, seed=7 + row["index"],
                                     target=row["target"])
        assert row["num_segments"] == out.num_segments
        assert row["survival"] == float(np.mean(out.eval.survived))
        assert row["best_start"] == int(tr.xp[np.argmax(tr.yp)])
        np.testing.assert_array_equal(res.heatmaps[row["index"]], out.heatmap)


def test_bo_sweep_matches_jax_with_its_draws(engines, monkeypatch):
    """With each image's draws taken from the JAX package's trace (its
    jax.random stream cannot be reproduced), the BO sweep's rows and
    heatmaps equal the JAX package's bo_saliency_sweep."""
    from network_interpretation_imagenet_tpu.config import BOConfig as JBOConfig
    from network_interpretation_imagenet_tpu.saliency import bo_pipeline as jbo
    from network_interpretation_imagenet_tpu_torch.config import BOConfig
    from network_interpretation_imagenet_tpu_torch.saliency import bo_pipeline

    engine, jengine, items = engines
    kept = [(0, items[0]), (3, items[3])]
    data = [items[0], items[3]]
    want = jsweep.bo_saliency_sweep(jengine, data, JSegmentConfig(), JBOConfig(n_iters=2,
                                    n_pre_samples=2), image_batch=2, seed=5,
                                    keep_heatmaps=True, dataset_indices=[0, 3])
    traces = {}
    for i, (img, _, _) in kept:
        seg = jsweep.segment_image(jaggregate.normalize_to_uint8_np(img), JSegmentConfig())
        traces[i] = jbo.bo_window_saliency(jengine, img, seg, JBOConfig(n_iters=2,
                                           n_pre_samples=2), seed=5 + i, fused=True)[1]

    def jax_draws(seed, per_image_seeds, uppers, count):
        return torch.stack([torch.from_numpy(traces[s - 5].xp.astype(np.int64))
                            for s in per_image_seeds])

    monkeypatch.setattr(bo_pipeline, "_multi_draws", jax_draws)
    got = sweep.bo_saliency_sweep(engine, data, SegmentConfig(), BOConfig(n_iters=2,
                                  n_pre_samples=2), image_batch=2, seed=5, keep_heatmaps=True,
                                  dataset_indices=[0, 3])
    _assert_same_sweep(got, want)
    assert got.images_explained == 2


# --- attribution sweep --------------------------------------------------------


def test_attribution_sweep_gradient_matches_jax(engines):
    """A deterministic gradient method: maps within 1e-4 of their scale,
    rows (targets, IOUs) equal."""
    engine, jengine, items = engines
    kw = dict(method="grad_input", image_batch=2, keep_heatmaps=True)
    got = sweep.attribution_sweep(engine, items, **kw)
    want = jsweep.attribution_sweep(jengine, items, **kw)
    for key in ("images_total", "images_explained", "images_skipped_misclassified",
                "images_failed"):
        assert getattr(got, key) == getattr(want, key), key
    assert _rows(got) == _rows(want)
    for i, w in want.heatmaps.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got.heatmaps[i], w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_attribution_sweep_rise_equals_mask_method_batch(engines):
    """RISE rows: each image's map is the port's mask_method_batch on that
    image with the sweep's seed (seed + index), bit for bit."""
    from network_interpretation_imagenet_tpu_torch.saliency import gradient

    engine, _, items = engines
    data = [items[0], items[3]]
    res = sweep.attribution_sweep(engine, data, method="rise", image_batch=2, seed=4,
                                  rise_masks=16, rise_grid=4, mask_batch=8, keep_heatmaps=True)
    imgs = np.stack([data[0][0], data[1][0]])
    targets = [engine.predict_one(im)[0] for im in imgs]
    want = gradient.mask_method_batch(engine.folded_logits, engine.variables, imgs, targets,
                                      "rise", seeds=[4, 5], rise_masks=16, rise_grid=4,
                                      mask_batch=8)
    for pos in range(2):
        np.testing.assert_array_equal(res.heatmaps[pos], want[pos].numpy())
    assert res.evals_per_sec > 0 and [r["target"] for r in res.per_image] == targets


def test_occlusion_sweep_matches_jax_and_resolves_the_default_patch(engines):
    """With an explicit patch the occlusion sweep's maps (the masked images
    in bf16, the method's default, in both packages) equal the JAX
    package's within 1e-4 of their scale. With the default (patch=None,
    resolution-adaptive) the port counts the positions occlusion_map runs;
    the JAX package's eval count raises on None and fails every image."""
    engine, jengine, items = engines
    data = [items[0], items[3]]
    kw = dict(method="occlusion", image_batch=2, keep_heatmaps=True, patch=16, stride=16)
    got = sweep.attribution_sweep(engine, data, **kw)
    want = jsweep.attribution_sweep(jengine, data, **kw)
    assert _rows(got) == _rows(want) and got.images_explained == 2
    for i, w in want.heatmaps.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got.heatmaps[i], w, rtol=0, atol=1e-4 * np.abs(w).max())
    kw.update(patch=None, stride=None)
    got = sweep.attribution_sweep(engine, data, **kw)
    want = jsweep.attribution_sweep(jengine, data, **kw)
    assert (got.images_explained, got.images_failed) == (2, 0)
    assert (want.images_explained, want.images_failed) == (0, 2)


def test_heatmap_wire_u8_matches_jax():
    """The u8 heatmap wire's quantization: q exact, lo and span within one
    f32 ulp of the JAX package's."""
    rng = np.random.RandomState(0)
    heats = rng.randn(3, 16, 16).astype(np.float32) * np.float32([1.0, 1e-3, 50.0])[:, None, None]
    heats[1] = 0.25  # a constant map: span falls to the f32 tiny floor
    q, lo, span = sweep._quantize_heats_device(torch.from_numpy(heats))
    jq, jlo, jspan = (np.asarray(a) for a in jsweep._quantize_heats_device(jnp.asarray(heats)))
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_max_ulp(lo.numpy(), jlo, maxulp=1)
    np.testing.assert_array_max_ulp(span.numpy(), jspan, maxulp=1)


# --- helpers ------------------------------------------------------------------


def test_u8_normalize_matches_jax():
    """Device and host halves of the uint8 wire: equal to each other and to
    the JAX package's host half; the JAX device half (XLA multiplies by
    reciprocals) within 1e-6 of the values' range, about 4 f32 ulps of 2."""
    u8 = np.random.RandomState(1).randint(0, 256, (5, 7, 3)).astype(np.uint8)
    norm = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
    dev = sweep._u8_normalize_device(torch.from_numpy(u8), norm).numpy()
    host = sweep._u8_normalize_host(u8, norm)
    np.testing.assert_array_equal(dev, host)
    np.testing.assert_array_equal(host, jsweep._u8_normalize_host(u8, norm))
    np.testing.assert_allclose(dev, np.asarray(jsweep._u8_normalize_device(
        jnp.asarray(u8), norm)), rtol=0, atol=1e-6)


def test_phase_logger_lines_match_jax():
    got, want = io.StringIO(), io.StringIO()
    for log, stream in ((PhaseLogger(got), got), (jlogging.PhaseLogger(want), want)):
        log.emit({"event": "image_done", "index": 1, "v": np.float32(0.5)})
        log.metric("evals_per_sec", 12.5, lane="window")
        with log.phase("outer", count=2):
            with log.phase("inner", index=3):
                pass
    strip = [{k: v for k, v in json.loads(line).items() if k != "seconds"}
             for line in got.getvalue().splitlines()]
    jstrip = [{k: v for k, v in json.loads(line).items() if k != "seconds"}
              for line in want.getvalue().splitlines()]
    assert strip == jstrip
    assert strip[2]["phase"] == "outer.inner" and strip[3]["phase"] == "outer"
    silent = io.StringIO()
    PhaseLogger(silent, enabled=False).emit({"x": 1})
    assert silent.getvalue() == ""


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    from network_interpretation_imagenet_tpu_torch.utils.logging import profiler_trace

    with profiler_trace(None):   # no directory: no trace
        pass
    with profiler_trace(str(tmp_path / "trace")):
        torch.ones(4) @ torch.ones(4)
    events = json.load(open(tmp_path / "trace" / "trace.json"))["traceEvents"]
    assert any("matmul" in e.get("name", "") or "dot" in e.get("name", "") for e in events)


def test_average_meter():
    m = AverageMeter()
    for v, n in ((1.0, 1), (4.0, 2), (np.float32(0.5), 1)):
        m.update(v, n)
    assert (m.val, m.sum, m.count) == (0.5, 9.5, 4) and m.avg == pytest.approx(9.5 / 4)
    m.reset()
    assert (m.val, m.avg, m.sum, m.count) == (0.0, 0.0, 0.0, 0)


def test_prefetch_keeps_order_and_errors():
    class Slow:
        def __len__(self):
            return 9

        def __getitem__(self, i):
            if i == 7:
                raise KeyError(i)
            return i * 10

    order = [5, 0, 3, 1]
    assert list(prefetch(Slow(), num_workers=3, buffer=2, indices=order)) == [50, 0, 30, 10]
    assert list(prefetch(Slow(), num_workers=0, indices=order)) == [50, 0, 30, 10]
    assert list(prefetch(iter([1, 2]), num_workers=2)) == [1, 2]
    gen = prefetch(Slow(), num_workers=2, indices=[1, 7, 2])
    assert next(gen) == 10
    with pytest.raises(KeyError):
        next(gen)


@pytest.mark.parametrize("shape", [(30, 41, 3), (50, 20, 3), (12, 12, 1)])
def test_preprocess_matches_jax(shape):
    """resize_shorter_side, resize_to, center_crop and standard_eval_pipeline
    against the JAX package's within 1e-5 (of the [0, 255] range for the
    resizes of uint8-scaled images)."""
    rng = np.random.RandomState(sum(shape))
    u8 = rng.randint(0, 256, shape).astype(np.uint8)
    x = u8.astype(np.float32)
    pairs = [(preprocess.resize_shorter_side(torch.from_numpy(x), 16),
              jpre.resize_shorter_side(jnp.asarray(x), 16)),
             (preprocess.resize_to(torch.from_numpy(x), (9, 23)),
              jpre.resize_to(jnp.asarray(x), (9, 23))),
             (preprocess.center_crop(torch.from_numpy(x), 24),
              jpre.center_crop(jnp.asarray(x), 24)),
             (preprocess.standard_eval_pipeline(torch.from_numpy(u8), 16, (0.4,) * shape[2],
                                                (0.2,) * shape[2]),
              jpre.standard_eval_pipeline(jnp.asarray(u8), 16, (0.4,) * shape[2],
                                          (0.2,) * shape[2]))]
    for got, want in pairs:
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(255.0, float(np.abs(want).max())))
