"""Val-set saliency sweep: many images through one engine (port of
``saliency/sweep.py``), optionally sharded over a mesh of ranks.

Every ported explanation runs over a dataset here: random windows and
knockouts (:func:`saliency_sweep`), the fused GP-EI BO loop
(:func:`bo_saliency_sweep`) and the attribution family
(:func:`attribution_sweep`), with per-image rows (IOU, survival, fidelity),
skipped misclassified images and failures counted, not fatal, and a
crash-safe journal (``saliency.journal``).

The host and the card overlap. CUDA launches return before the card has
run them, so the streaming sweep segments image i+1 on the host while image
i's masked forwards run, uploads image i+1 from pinned memory without a
wait, dispatches its prediction and masked forwards, and only then collects
image i. On the card that collect waits for image i's own event (recorded
behind its last chunk) and copies on a side stream, so image i+1's work
stays queued and the card runs it through image i's finish and image i+2's
segmentation; an image's two waits are its outcomes and its logits. The
window masks of every chunk are built by B1 and every masked forward runs
the engine's inference plan (for an ImageNet ResNet the folded net, whose
stride-1 Bottleneck stages are B2 chains).
The streaming sweep's stages are spans of the tracer (``utils.logging``):
``sweep.segment``, ``sweep.predict``, ``sweep.dispatch``, ``sweep.collect``
and ``sweep.finish``, each with the image's index as its request id;
``sweep.collect`` carries ``ready`` on the card: whether the image's event
had completed as the collect began (the host was the slower side).

The reference aborts the whole run on the first misclassified image
(``bayesian_active_learning_imagenet.py:221``); the sweep skips and records
it.

With ``mesh`` (``parallel.make_mesh``, more than one rank) every rank runs
the same sweep on the same images and the work of each image shards over
the mesh's data axis: the window and knockout sweep's masks per image
(``_sharded_*_saliency``) or per flush grid (``sharded_*_eval_multi``),
synchronously, the BO sweep's and the attribution sweep's image axis per
flush. A failed collective (``parallel.mesh.CollectiveError``) ends the run
on every rank; it is never counted as one image's failure.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Iterable, Optional

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.config import SegmentConfig
from network_interpretation_imagenet_tpu_torch.ops import aggregate, masking
from network_interpretation_imagenet_tpu_torch.ops.preprocess import normalize as _normalize
from network_interpretation_imagenet_tpu_torch.parallel.mesh import CollectiveError, mesh_size
from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine, fetch
from network_interpretation_imagenet_tpu_torch.saliency.pipeline import localization_score
from network_interpretation_imagenet_tpu_torch.segment.common import (
    segment_image,
    segment_image_batch,
    slic_batch_device,
    slic_postpass_host,
)
from network_interpretation_imagenet_tpu_torch.utils import logging as trace
from network_interpretation_imagenet_tpu_torch.utils.logging import PhaseLogger
from network_interpretation_imagenet_tpu_torch.utils.meters import AverageMeter


@dataclasses.dataclass
class SweepResult:
    images_total: int = 0
    images_explained: int = 0
    images_skipped_misclassified: int = 0
    images_failed: int = 0
    mean_iou: float = 0.0
    mean_survival: float = 0.0
    # Per-image "seconds" rows (and this pooled p50) span enqueue to
    # finalize through the pipeline, overlap with other images' work
    # included: an upper bound on one image's latency. Throughput
    # (`evals_per_sec`) is the sweep's primary metric.
    p50_latency_s: float = 0.0
    evals_per_sec: float = 0.0
    # From the per-image rows when the sweep runs with fidelity_steps > 0:
    # good saliency has a low deletion AUC, a high insertion AUC and a high
    # pointing-game accuracy.
    mean_deletion_auc: float = 0.0
    mean_insertion_auc: float = 0.0
    pointing_game_acc: float = 0.0
    per_image: list = dataclasses.field(default_factory=list)
    # index -> f32[H, W] heatmap; filled only with keep_heatmaps=True (for
    # the GP-surrogate passes).
    heatmaps: dict = dataclasses.field(default_factory=dict)


def _host(t) -> np.ndarray:
    """A tensor on any device (copied by ``engine.fetch``), or an array, as a
    numpy array."""
    return fetch(t) if isinstance(t, torch.Tensor) else np.asarray(t)


def _display(image: np.ndarray) -> np.ndarray:
    """The uint8 display image Felzenszwalb segments (2-D for one channel)."""
    disp = aggregate.normalize_to_uint8_np(image)
    return disp[:, :, 0] if disp.ndim == 3 and disp.shape[2] == 1 else disp


def _display_batch(images: torch.Tensor) -> torch.Tensor:
    """:func:`_display` of a device batch [N, H, W, C], on the device."""
    disp = aggregate.normalize_to_uint8_batch(images)
    return disp[..., 0] if disp.dim() == 4 and disp.shape[-1] == 1 else disp


def _fidelity_row_fields(engine, image, heat, target: int, gt_bbox, steps: int) -> dict:
    """Per-image faithfulness fields: one batched forward of both curves
    through the engine's folded net (B2 on the card), and the pointing game
    where a gt box exists."""
    from network_interpretation_imagenet_tpu_torch.saliency import eval_metrics

    d = eval_metrics.deletion_insertion_auc(engine, image, heat, int(target), steps=steps)
    fields = {"deletion_auc": round(d["deletion_auc"], 6),
              "insertion_auc": round(d["insertion_auc"], 6)}
    if gt_bbox is not None:
        fields["pointing"] = bool(eval_metrics.pointing_game(heat, gt_bbox))
    return fields


def _finalize_fidelity_means(res: SweepResult) -> None:
    """Fidelity means from the per-image rows (the rows are the source, so
    journal-restored results aggregate the same way)."""
    dels = [r["deletion_auc"] for r in res.per_image if "deletion_auc" in r]
    inss = [r["insertion_auc"] for r in res.per_image if "insertion_auc" in r]
    pts = [r["pointing"] for r in res.per_image if "pointing" in r]
    res.mean_deletion_auc = float(np.mean(dels)) if dels else 0.0
    res.mean_insertion_auc = float(np.mean(inss)) if inss else 0.0
    res.pointing_game_acc = float(np.mean(pts)) if pts else 0.0


def _unpack_item(item):
    """(image, label?, gt_bbox?) from a 2- or 3-element dataset item. Any
    sequence type; a malformed item raises inside the caller's per-image
    try block instead of aborting the sweep."""
    seq = tuple(item)
    if len(seq) == 2:
        return seq[0], seq[1], None
    return seq[0], seq[1], seq[2]


def _fatal(e: Exception) -> None:
    """Re-raise a failed collective: the ranks can no longer keep step, so
    it ends the run instead of failing one image."""
    if isinstance(e, CollectiveError):
        raise e


def _sharded_window_saliency(engine: SaliencyEngine, mesh, image, segments, num_samples: int,
                             window_fraction: float, seed: int, target: int, firsts=None):
    """Mask-parallel :func:`~saliency.pipeline.random_window_saliency` over a
    mesh: the K windows through ``parallel.sharded_window_eval`` (B1 and the
    engine's folded net on each rank's slice), the heatmap summed on the host."""
    from network_interpretation_imagenet_tpu_torch.parallel import sharded_window_eval
    from network_interpretation_imagenet_tpu_torch.saliency.engine import MaskEvalResult
    from network_interpretation_imagenet_tpu_torch.saliency.pipeline import SaliencyOutput

    segments = np.asarray(segments, np.int32)
    s = int(segments.max()) + 1
    width = int(window_fraction * s)
    if firsts is None:
        firsts = masking.sample_window_starts_host(seed, num_samples, s, width)
    firsts = np.asarray(firsts, np.int32)
    survived, probs, _ = sharded_window_eval(mesh, engine.folded_logits, engine.variables, image,
                                             segments, firsts, width, target,
                                             compute_dtype=engine.compute_dtype)
    heat = aggregate.summed_superpixel_labels_np(segments, firsts, width, survived)
    return SaliencyOutput(
        segments=segments, num_segments=s,
        eval=MaskEvalResult(survived=survived, preds=np.where(survived, target, -1),
                            prob_target=probs, prob_max=np.full_like(probs, np.nan)),
        heatmap=heat, firsts=firsts, width=width)


def _sharded_knockout_saliency(engine: SaliencyEngine, mesh, image, segments, knock_ids,
                               target: int):
    """Knockout twin of :func:`_sharded_window_saliency`."""
    from network_interpretation_imagenet_tpu_torch.parallel import sharded_knockout_eval
    from network_interpretation_imagenet_tpu_torch.saliency.engine import MaskEvalResult
    from network_interpretation_imagenet_tpu_torch.saliency.pipeline import SaliencyOutput

    segments = np.asarray(segments, np.int32)
    s = int(segments.max()) + 1
    knock_ids = np.asarray(knock_ids, np.int32)
    survived, probs, _ = sharded_knockout_eval(mesh, engine.folded_logits, engine.variables,
                                               image, segments, knock_ids, target,
                                               compute_dtype=engine.compute_dtype)
    heat = aggregate.summed_knockout_labels_np(segments, knock_ids, survived)
    return SaliencyOutput(
        segments=segments, num_segments=s,
        eval=MaskEvalResult(survived=survived, preds=np.where(survived, target, -1),
                            prob_target=probs, prob_max=np.full_like(probs, np.nan)),
        heatmap=heat, knock_ids=knock_ids)


def _misclassified(pred: int, label) -> bool:
    return label is not None and pred != int(label)


class _Books:
    """One sweep's bookkeeping, shared by every lane and both drivers: the
    result and its meters, the latencies, the journaled work restored and
    the log (teeing terminal events to the journal). It writes each image's
    row, skip and failure; the lanes keep their pipelines."""

    def __init__(self, engine, journal, logger, keep_heatmaps: bool, bbox_threshold: int,
                 fidelity_steps: int, normalize=None) -> None:
        self.engine, self.journal, self.keep_heatmaps = engine, journal, keep_heatmaps
        self.bbox_threshold, self.fidelity_steps = bbox_threshold, fidelity_steps
        self.normalize = normalize
        self.log = logger or PhaseLogger(enabled=False)
        self.res = SweepResult()
        self.iou_m, self.surv_m = AverageMeter(), AverageMeter()
        self.latencies = []
        self.done = ()
        if journal is not None:
            from network_interpretation_imagenet_tpu_torch.saliency.journal import JournalingLogger

            journal.restore_into(self.res, self.iou_m, self.surv_m, self.latencies,
                                 keep_heatmaps)
            self.done = journal.done
            self.log = JournalingLogger(self.log, journal)
        self.gt = {}  # index -> gt box, from the dataset item
        self.evals = 0
        self.t_start = time.perf_counter()

    def items(self, dataset: Iterable, max_images: Optional[int], dataset_indices):
        """``(i, t0, image, label)`` for each image this run explains: at most
        ``max_images`` positions, ``dataset_indices`` mapping position ->
        index, journaled images skipped. An item that will not unpack fails
        here."""
        for pos, item in enumerate(dataset):
            if max_images is not None and pos >= max_images:
                break
            i = int(dataset_indices[pos]) if dataset_indices is not None else pos
            if i in self.done:  # a terminal outcome journaled by an earlier run
                continue
            self.res.images_total += 1
            t0 = time.perf_counter()
            try:
                image, label, gt_bbox = _unpack_item(item)
                image = np.asarray(image)
                self.gt[i] = gt_bbox
            except Exception as e:
                self.image_failed(i, e)
                continue
            yield i, t0, image, label

    def finish(self, i: int, target: int, heat, t0: float, image: np.ndarray, evals: int,
               fields: dict) -> None:
        """The row of an explained image, ``{index, target, **fields, iou?,
        fidelity..., seconds}``; a ``"survival"`` field feeds the survival
        meter. ``image`` (uint8 on the uint8 wire) is what fidelity scores."""
        self.evals += evals
        heat = np.asarray(heat)
        row = {"index": i, "target": target, **fields}
        if "survival" in fields:
            self.surv_m.update(float(fields["survival"]))
        gt_bbox = self.gt.get(i)
        if gt_bbox is not None:
            iou, _ = localization_score(heat, gt_bbox, self.bbox_threshold)
            row["iou"] = float(iou)
            self.iou_m.update(float(iou))
        if self.fidelity_steps > 0:
            if image.dtype == np.uint8 and self.normalize is not None:
                image = _u8_normalize_host(image, self.normalize)
            row.update(_fidelity_row_fields(self.engine, image, heat, target, gt_bbox,
                                            self.fidelity_steps))
        self.res.images_explained += 1
        if self.keep_heatmaps:
            self.res.heatmaps[i] = heat
            if self.journal is not None:
                self.journal.save_heatmap(i, heat)  # before the row marks it done
        self.latencies.append(time.perf_counter() - t0)
        row["seconds"] = round(self.latencies[-1], 4)
        self.res.per_image.append(row)
        self.log.emit({"event": "image_done", **row})

    def skip(self, i: int, pred: int, label) -> None:
        self.res.images_skipped_misclassified += 1
        self.log.emit({"event": "skip_misclassified", "index": i, "pred": pred,
                       "label": int(label)})

    def image_failed(self, i: int, e: Exception) -> None:
        _fatal(e)
        self.res.images_failed += 1
        self.log.emit({"event": "image_failed", "index": i, "error": repr(e)})

    def batch_failed(self, indices: list, e: Exception) -> None:
        _fatal(e)
        self.res.images_failed += len(indices)
        self.log.emit({"event": "batch_failed", "indices": indices, "error": repr(e)})

    def result(self) -> SweepResult:
        res, wall = self.res, time.perf_counter() - self.t_start
        res.mean_iou = self.iou_m.avg
        res.mean_survival = self.surv_m.avg
        res.p50_latency_s = float(np.median(self.latencies)) if self.latencies else 0.0
        res.evals_per_sec = self.evals / wall if wall > 0 else 0.0
        _finalize_fidelity_means(res)
        return res


def saliency_sweep(
    engine: SaliencyEngine,
    dataset: Iterable,
    seg_cfg: SegmentConfig,
    num_mask_samples: int = 100,
    window_fraction: float = 0.4,
    bbox_threshold: int = 180,
    max_images: Optional[int] = None,
    seed: int = 0,
    logger: Optional[PhaseLogger] = None,
    image_batch: int = 1,
    keep_heatmaps: bool = False,
    dataset_indices=None,
    mode: str = "window",
    num_knockout: int = 1,
    journal=None,
    fidelity_steps: int = 0,
    mesh=None,
) -> SweepResult:
    """Sweep (image, label, gt_bbox?) items; returns aggregate metrics.

    ``dataset`` yields ``(normalized f32 HWC image, int label | None,
    gt_bbox | None)``. Each image's masks are sampled on the host from
    numpy's ``RandomState(seed + index)`` (the JAX package's stream), so a
    row depends only on its image and index. ``mode="knockout"`` swaps the
    windows for the reference's MNIST/CIFAR knockouts: each of the K masks
    zeros ``num_knockout`` random segments.

    ``image_batch`` <= 1 streams: each image is segmented on the host, its
    prediction, targets and masked forwards dispatched with the target left
    on the device, and its outcomes collected one image behind, where the
    misclassification skip is decided (a misclassified image wastes its
    masked forwards; the device queue never drains: the collect waits for
    that image's event, not for the stream). ``image_batch`` > 1
    (same-shape images) flushes that many images at once: one upload, one
    batched segmentation (SLIC on the device), one batched prediction and
    one multi-image mask grid (``eval_{window,knockout}_masks_multi_async``,
    B1 once per image run of a chunk), collected one flush behind.

    ``dataset_indices`` maps enumerate position -> dataset index (seeds,
    rows). ``journal`` (a ``SweepJournal``) appends each image's terminal
    outcome and, built with ``resume=True``, restores finished images and
    skips them: a resumed sweep's rows equal an uninterrupted run's.
    ``evals_per_sec`` counts only this run's work. ``fidelity_steps`` > 0
    scores every explained heatmap (deletion/insertion AUC, pointing game).

    ``mesh`` with more than one rank (every rank sweeping the same images):
    with ``image_batch`` <= 1 each image runs synchronously, its prediction
    deciding the skip and its target (the label where there is one, as in
    the JAX package), then its K masks sharded over the mesh
    (``_sharded_*_saliency``); with ``image_batch`` > 1 each flush's N*K grid
    shards (``sharded_*_eval_multi``). A mesh of one rank runs the
    single-device paths above. ``dataset_indices`` then maps positions to a
    process's stride of a multi-process sweep.
    """
    if mode not in ("window", "knockout"):
        raise ValueError(f"unknown sweep mode {mode!r}")
    is_knockout = mode == "knockout"

    def sample_plan(seed_i: int, s: int) -> dict:
        """Per-image mask parameters, sampled on the host (both families),
        so dispatch never waits for the device."""
        if is_knockout:
            return {"ids": masking.sample_knockout_ids_host(seed_i, num_mask_samples,
                                                            num_knockout, s)}
        width = int(window_fraction * s)
        return {"firsts": masking.sample_window_starts_host(seed_i, num_mask_samples, s, width),
                "width": width}

    def aggregate_plan(seg, plan: dict, survived) -> np.ndarray:
        if is_knockout:
            return aggregate.summed_knockout_labels_np(seg, plan["ids"], survived)
        return aggregate.summed_superpixel_labels_np(seg, plan["firsts"], plan["width"],
                                                     survived)

    book = _Books(engine, journal, logger, keep_heatmaps, bbox_threshold, fidelity_steps)
    log = book.log

    def finish(i, target, s, heat, survived, t0, image):
        book.finish(i, target, heat, t0, image, num_mask_samples,
                    {"num_segments": s, "survival": float(np.mean(survived))})

    def skip(i, pred, label) -> bool:
        if not _misclassified(pred, label):
            return False
        book.skip(i, pred, label)
        return True

    pending = []                    # batched path: (i, image, display, label, t0)
    inflight = collections.deque()  # streaming path: dispatched, not collected
    inflight_batch = None           # batched path: one dispatched flush

    def collect_one():
        """Fetch the oldest in-flight image's outcomes and logits, behind its
        own event and not behind the next image's work, and finalize it; the
        misclassification skip is decided here."""
        fl = inflight.popleft()
        done = fl["handle"].done   # the image's event, on the card
        try:
            with trace.span("sweep.collect", rid=fl["i"]) as open_span:
                if open_span is not None and done is not None:
                    open_span.annotate(ready=done.query())
                r = engine.collect(fl["handle"])
                pred = int(fetch(fl["logits"], after=done)[0].argmax())
            if skip(fl["i"], pred, fl["label"]):
                return
            with trace.span("sweep.finish", rid=fl["i"]):
                heat = aggregate_plan(fl["seg"], fl["plan"], r.survived)
                finish(fl["i"], pred, fl["s"], heat, r.survived, fl["t0"], fl["image"])
        except Exception as e:
            book.image_failed(fl["i"], e)

    def collect_batch():
        """Finalize the in-flight flush. A failure to fetch fails the whole
        flush; a failure in one image's rows fails that image only."""
        nonlocal inflight_batch
        if inflight_batch is None:
            return
        fb, inflight_batch = inflight_batch, None
        try:
            preds = _host(fb["logits"]).argmax(axis=1)
            if fb["handle"] is not None:
                survived_per_image = [r.survived for r in
                                      engine.collect_multi(fb["handle"], fb["n"], fb["k"])]
            else:   # the mesh's flush, gathered already
                survived_per_image = fb["survived_per_image"]
        except Exception as e:
            book.batch_failed([m[0] for m in fb["metas"]], e)
            return
        for j, (i, seg, s, plan, label, t0, img) in enumerate(fb["metas"]):
            try:
                pred = int(preds[j])
                if skip(i, pred, label):
                    continue
                surv = survived_per_image[j]
                finish(i, pred, s, aggregate_plan(seg, plan, surv), surv, t0, img)
            except Exception as e:
                book.image_failed(i, e)

    def flush_pending():
        """Dispatch the pending images (one upload, one batched predict with
        the targets left on the device, one multi-image mask grid), then
        collect the previous flush while this one runs."""
        nonlocal inflight_batch
        if not pending:
            collect_batch()
            return
        batch = list(pending)
        pending.clear()
        try:
            idxs, imgs, disps, labels, t0s = zip(*batch)
            imgs_dev = torch.from_numpy(np.stack(imgs).astype(np.float32)).to(engine.device)
            with log.phase("segment_batch", count=len(batch)):
                seg_in = _display_batch(imgs_dev) if seg_cfg.method == "slic" else disps
                segs = [np.asarray(s, np.int32)
                        for s in segment_image_batch(seg_in, seg_cfg, engine.device)]
            ss = [int(s.max()) + 1 for s in segs]
            plans = [sample_plan(seed + idxs[j], ss[j]) for j in range(len(batch))]
            logits_dev = engine.predict_logits_device(imgs_dev)
            targets_dev = torch.argmax(logits_dev, dim=1)
            fb = {"handle": None, "n": len(batch), "k": num_mask_samples, "logits": logits_dev,
                  "metas": list(zip(idxs, segs, ss, plans, labels, t0s, imgs))}
            if on_mesh:
                # The flush's N*K grid shards over the mesh, synchronously.
                from network_interpretation_imagenet_tpu_torch.parallel import (
                    sharded_knockout_eval_multi,
                    sharded_window_eval_multi,
                )

                if is_knockout:
                    survived_nk, _ = sharded_knockout_eval_multi(
                        mesh, engine.folded_logits, engine.variables, np.stack(imgs),
                        np.stack(segs), np.stack([p["ids"] for p in plans]), _host(targets_dev),
                        compute_dtype=engine.compute_dtype)
                else:
                    survived_nk, _ = sharded_window_eval_multi(
                        mesh, engine.folded_logits, engine.variables, np.stack(imgs),
                        np.stack(segs), np.stack([p["firsts"] for p in plans]),
                        np.asarray([p["width"] for p in plans], np.int32), _host(targets_dev),
                        compute_dtype=engine.compute_dtype)
                fb["survived_per_image"] = list(survived_nk)
            elif is_knockout:
                fb["handle"], _, _ = engine.eval_knockout_masks_multi_async(
                    imgs_dev, np.stack(segs), np.stack([p["ids"] for p in plans]), targets_dev)
            else:
                fb["handle"], _, _ = engine.eval_window_masks_multi_async(
                    imgs_dev, np.stack(segs), np.stack([p["firsts"] for p in plans]),
                    np.asarray([p["width"] for p in plans], np.int32), targets_dev)
            collect_batch()  # the previous flush drains while this one computes
            inflight_batch = fb
        except Exception as e:
            book.batch_failed([b[0] for b in batch], e)

    on_mesh = mesh_size(mesh) > 1
    for i, t0, image, label in book.items(dataset, max_images, dataset_indices):
        try:
            # Host segmentation runs first, so it overlaps the card running
            # the in-flight image. A SLIC flush derives its displays on the
            # device from the flush's one upload.
            disp = None if image_batch > 1 and seg_cfg.method == "slic" else _display(image)
            if image_batch > 1:
                pending.append((i, image, disp, label, t0))
                if len(pending) >= image_batch:
                    flush_pending()
                continue
            with log.phase("segment", span="sweep.segment", rid=i, index=i):
                seg = np.asarray(segment_image(disp, seg_cfg, engine.device), np.int32)
            s = int(seg.max()) + 1
            plan = sample_plan(seed + i, s)
            if on_mesh:
                # Synchronous: the prediction decides the skip and the target
                # before the masks shard over the mesh.
                pred, _ = engine.predict_one(image)
                if skip(i, pred, label):
                    continue
                target = int(label) if label is not None else pred
                with log.phase("masked_forwards", index=i, k=num_mask_samples):
                    if is_knockout:
                        out = _sharded_knockout_saliency(engine, mesh, image, seg, plan["ids"],
                                                         target)
                    else:
                        out = _sharded_window_saliency(engine, mesh, image, seg,
                                                       num_mask_samples, window_fraction,
                                                       seed + i, target, plan["firsts"])
                finish(i, target, out.num_segments, out.heatmap, out.eval.survived, t0, image)
                continue
            # Uploads, prediction, argmax (a device scalar, so the masked
            # forwards need no fetch) and masked forwards are all enqueued
            # with no wait; the image is collected one behind.
            with trace.span("sweep.predict", rid=i):
                image_t = engine.upload_async(image, np.float32)
                logits_dev = engine.predict_logits_device(image_t[None])
                target_dev = torch.argmax(logits_dev[0])
            with trace.span("sweep.dispatch", rid=i):
                seg_t = engine.upload_async(seg, np.int32)
                if is_knockout:
                    handle = engine.eval_knockout_masks_async(
                        image_t, seg_t, engine.upload_async(plan["ids"], np.int32), target_dev)
                else:
                    handle = engine.eval_window_masks_async(
                        image_t, seg_t, engine.upload_async(plan["firsts"], np.int32),
                        plan["width"], target_dev)
            inflight.append({"i": i, "label": label, "logits": logits_dev, "seg": seg, "s": s,
                             "plan": plan, "handle": handle, "t0": t0, "image": image})
            while len(inflight) > 1:
                collect_one()
        except Exception as e:  # per-image failure isolation
            book.image_failed(i, e)

    while inflight:
        collect_one()
    flush_pending()  # dispatch the tail flush and drain the previous one
    collect_batch()
    return book.result()


def _u8_normalize_device(u8: torch.Tensor, normalize) -> torch.Tensor:
    """Device half of the uint8 wire: /255 then ``(x - mean) / std``, all f32
    on the device; the upload carries raw bytes (a quarter of f32's)."""
    mean, std = normalize
    return _normalize(u8.to(torch.float32) / 255.0, mean, std)


def _u8_normalize_host(u8: np.ndarray, normalize) -> np.ndarray:
    """Host twin of :func:`_u8_normalize_device` (the same f32 operations in
    the same order), for the per-image host consumers (fidelity forwards)."""
    mean, std = normalize
    x = u8.astype(np.float32) / np.float32(255.0)
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _quantize_heats_device(heats: torch.Tensor):
    """Device half of ``heatmap_wire="u8"``: per-image min-max quantization
    of f32 [N, H, W] heatmaps to (u8 q, f32 lo, f32 span); the host
    reconstructs ``lo + q * span / 255``. Bbox and IOU stay exact
    (localization min-max-normalizes to uint8 anyway, and the map is
    monotonic); fidelity ranks coarsen to 256 levels."""
    flat = heats.reshape(heats.shape[0], -1)
    lo = flat.min(dim=1).values
    span = torch.clamp(flat.max(dim=1).values - lo, min=torch.finfo(torch.float32).tiny)
    q = torch.round((heats - lo[:, None, None]) / span[:, None, None] * 255.0)
    return q.to(torch.uint8), lo, span


def _batched_flush_sweep(
    engine: SaliencyEngine,
    items,
    book: _Books,
    *,
    enqueue_display,
    dispatch,
    collect,
    evals_per_image,
    image_batch: int,
    normalize=None,
    prepare=None,
) -> None:
    """Shared driver of the image-batched sweeps (fused BO and attribution):
    a staged flush pipeline (upload and prepare flush k, dispatch flush k-1,
    finalize flush k-2) over ``items`` (``book.items``), a batched predict
    with the misclassification skip before dispatch, and each kept image's
    row written by ``book``.

    The per-flush compute comes as hooks:

    * ``enqueue_display(image) -> disp | None``: enqueue-time host work;
    * ``prepare(imgs_dev, disps, keep) -> prep`` (optional): device work
      issued as soon as a flush is uploaded, without waiting for it;
    * ``dispatch(imgs_dev, disps, keep, idxs, preds, prep) -> state``: enqueue
      the flush's program over the kept images; raising fails them;
    * ``collect(state) -> [(heatmap, row_fields)]`` aligned with ``keep``.

    ``evals_per_image`` counts each finalized kept image's evals (or is a
    callable of the image shape).

    ``normalize=(mean, std)`` enables the uint8 wire: the dataset yields raw
    uint8 HWC images, uploaded at a quarter of the f32 bytes and normalized
    on the device. A flush that mixes uint8 and float images raises, as
    does uint8 without ``normalize``.
    """
    pending = []   # (i, image, display, label, t0)
    inflight = []  # at most one dispatched flush, finalized behind the next
    staged = []    # at most one uploaded and prepared flush, not yet dispatched

    def finalize():
        state, keep, idxs, preds, t0s, imgs = inflight.pop(0)
        try:
            preds = _host(preds)  # a device tensor on the deferred-predict path
            results = collect(state)
        except Exception as e:
            book.batch_failed([idxs[j] for j in keep], e)
            return
        for pos, j in enumerate(keep):
            try:
                evals = (evals_per_image(imgs[j].shape) if callable(evals_per_image)
                         else evals_per_image)
                heat, fields = results[pos]
                book.finish(idxs[j], int(preds[j]), heat, t0s[j], imgs[j], evals, fields)
            except Exception as e:
                book.image_failed(idxs[j], e)

    def dispatch_staged():
        imgs_dev, disps, keep, idxs, preds, t0s, imgs, prep = staged.pop(0)
        try:
            state = dispatch(imgs_dev, disps, keep, idxs, preds, prep)
        except Exception as e:
            book.batch_failed([idxs[j] for j in keep], e)
            return
        inflight.append((state, keep, idxs, preds, t0s, imgs))
        while len(inflight) > 1:  # finalize the previous flush behind this one
            finalize()

    def flush():
        if not pending:
            return
        batch = list(pending)
        pending.clear()
        keep = None  # None until the skip decision lands (the predict can fail)
        try:
            idxs, imgs, disps, labels, t0s = zip(*batch)
            dtypes = {im.dtype for im in imgs}
            if np.dtype(np.uint8) in dtypes and len(dtypes) > 1:
                # np.stack would promote the uint8 images to float raw pixels
                # and skip their normalization.
                raise ValueError(f"flush mixes uint8 and float images ({dtypes}); the "
                                 "uint8 wire needs a homogeneous dataset")
            arr = np.stack(imgs)
            if arr.dtype == np.uint8:
                imgs_dev = _u8_normalize_device(torch.from_numpy(arr).to(engine.device),
                                                normalize)
            else:
                imgs_dev = torch.from_numpy(arr.astype(np.float32)).to(engine.device)
            if all(lab is None for lab in labels):
                # No skip decision to make: the targets stay on the device
                # and finalize() fetches them once the program is done.
                preds = torch.argmax(engine.predict_logits_device(imgs_dev), dim=1)
                keep = list(range(len(batch)))
            else:
                preds = engine.predict(imgs_dev).argmax(axis=1)
                keep = [j for j in range(len(batch))
                        if not _misclassified(int(preds[j]), labels[j])]
                for j in range(len(batch)):
                    if j not in keep:
                        book.skip(idxs[j], int(preds[j]), labels[j])
                if not keep:
                    return
            prep = prepare(imgs_dev, disps, keep) if prepare else None
        except Exception as e:
            # Skipped images are accounted for already; only the kept (or,
            # before the predict, the whole) set counts as failed.
            book.batch_failed([b[0] for b in batch] if keep is None
                              else [batch[j][0] for j in keep], e)
            return
        staged.append((imgs_dev, disps, keep, idxs, preds, t0s, imgs, prep))
        while len(staged) > 1:  # dispatch the previous staged flush
            dispatch_staged()

    for i, t0, image, label in items:
        if image.dtype == np.uint8 and normalize is None:
            # A configuration error, not a per-image failure.
            raise ValueError("dataset yielded uint8 images; pass normalize=(mean, std) "
                             "so the sweep can scale + normalize them on device")
        try:
            pending.append((i, image, enqueue_display(image), label, t0))
            if len(pending) >= image_batch:
                flush()
        except Exception as e:
            book.image_failed(i, e)
    flush()
    while staged:
        dispatch_staged()
    while inflight:
        finalize()


def _kept(imgs_dev: torch.Tensor, keep) -> torch.Tensor:
    """The kept images of a flush (the batch itself when all are kept)."""
    if len(keep) == int(imgs_dev.shape[0]):
        return imgs_dev
    return imgs_dev[torch.as_tensor(keep, device=imgs_dev.device)]


def _kept_targets(preds, keep):
    """The kept images' targets: a device tensor on the deferred-predict
    path (all kept), host ints otherwise."""
    if isinstance(preds, torch.Tensor):
        return preds
    return np.asarray([int(preds[j]) for j in keep], np.int64)


def _attr_evals_per_image(method: str, *, steps, samples, lm, rise_masks, mask_batch, patch,
                          stride, scorecam_channels):
    """Per-image device-eval count for :func:`attribution_sweep`'s
    ``evals_per_sec``: backward passes for the gradient family, masked
    forwards for the mask-batched family; occlusion's depends on the image
    shape, so it is a callable the flush driver resolves per row."""
    if method == "meaningful":
        return int(lm.get("iters", 150))
    if method == "rise":
        chunk = 250 if mask_batch is None else int(mask_batch)
        return -(-int(rise_masks) // chunk) * chunk  # rounds up, like rise_map
    if method == "occlusion":
        from network_interpretation_imagenet_tpu_torch.saliency.gradient import (
            occlusion_positions,
        )

        # The position grid, ``patch=None``'s resolution-adaptive default
        # resolved as occlusion_map resolves it (the JAX package's count
        # raises on None and fails every image of such a sweep).
        return lambda shape: len(occlusion_positions(int(shape[0]), int(shape[1]), patch,
                                                     stride)[2])
    if method == "scorecam":
        return int(scorecam_channels)
    return {"integrated": int(steps), "smoothgrad": int(samples),
            "xrai": 2 * int(steps)}.get(method, 1)


def bo_saliency_sweep(
    engine: SaliencyEngine,
    dataset: Iterable,
    seg_cfg: SegmentConfig,
    bo_cfg=None,
    window_fraction: float = 0.4,
    bbox_threshold: int = 180,
    image_batch: int = 16,
    max_images: Optional[int] = None,
    seed: int = 0,
    logger: Optional[PhaseLogger] = None,
    proposals_per_iter: int = 1,
    keep_heatmaps: bool = False,
    dataset_indices=None,
    journal=None,
    fidelity_steps: int = 0,
    normalize=None,
    mesh=None,
) -> SweepResult:
    """Val-set sweep driven by the flagship path, GP-EI BO per image
    (``bayesian_active_learning_imagenet.py:379-498``), batched: every
    ``image_batch`` images run as one fused BO program
    (``bo_window_saliency_multi_async``, one CUDA graph per image count on
    the card, B1 per image and B2 in every forward).

    Misclassified images are skipped before dispatch (one batched predict
    per flush), and only the kept images are segmented. Image j's draws come
    from a generator seeded with ``seed + index``, so its row equals
    ``bo_window_saliency(seed=seed + index)`` whatever the flush holds (up to
    the rounding of a forward at another batch size), and a resumed journal
    equals an uninterrupted run. Per-image ``seconds`` span the whole
    flush's program: an upper bound shared by up to ``image_batch`` images.

    ``normalize=(mean, std)``: the uint8 wire (see ``_batched_flush_sweep``).
    With ``seg_cfg.method == "slic"`` the displays derive on the device from
    the normalized batch; with Felzenszwalb the display stretches the raw
    uint8 image. ``mesh``: each flush's image axis shards over its data axis
    (each rank runs its slice of the loops; ``bo_window_saliency_multi``).
    """
    from network_interpretation_imagenet_tpu_torch.config import BOConfig
    from network_interpretation_imagenet_tpu_torch.saliency.bo_pipeline import (
        bo_window_saliency_multi_async,
    )

    bo_cfg = bo_cfg or BOConfig()
    book = _Books(engine, journal, logger, keep_heatmaps, bbox_threshold, fidelity_steps,
                  normalize)
    log = book.log

    def enqueue_display(image):
        return None if seg_cfg.method == "slic" else _display(image)

    def prepare(imgs_dev, disps, keep):
        """Enqueue SLIC's k-means on the device display of the kept images
        as soon as the flush lands; the previous flush's host work runs
        meanwhile."""
        if seg_cfg.method != "slic":
            return None  # Felzenszwalb is host work in dispatch
        keep_imgs = _kept(imgs_dev, keep)
        return keep_imgs, slic_batch_device(_display_batch(keep_imgs), seg_cfg, engine.device)

    def dispatch(imgs_dev, disps, keep, idxs, preds, prep):
        if prep is not None:
            keep_imgs, segs_dev = prep
            with log.phase("segment_batch", count=len(keep)):
                segs = slic_postpass_host(_host(segs_dev), seg_cfg)
        else:
            keep_imgs = _kept(imgs_dev, keep)
            with log.phase("segment_batch", count=len(keep)):
                segs = [np.asarray(s, np.int32)
                        for s in segment_image_batch([disps[j] for j in keep], seg_cfg)]
        ss = [int(s.max()) + 1 for s in segs]
        collect_fn = bo_window_saliency_multi_async(
            engine, keep_imgs, segs, bo_cfg, window_fraction=window_fraction,
            per_image_seeds=[seed + int(idxs[j]) for j in keep],
            targets=_kept_targets(preds, keep), proposals_per_iter=proposals_per_iter,
            mesh=mesh)
        return collect_fn, ss

    def collect(state):
        collect_fn, ss = state
        return [(out.heatmap, {"num_segments": ss[pos],
                               "survival": float(np.mean(out.eval.survived)),
                               "best_start": int(trace.xp[np.argmax(trace.yp)])})
                for pos, (out, trace) in enumerate(collect_fn())]

    _batched_flush_sweep(
        engine, book.items(dataset, max_images, dataset_indices), book,
        enqueue_display=enqueue_display, dispatch=dispatch, collect=collect,
        evals_per_image=bo_cfg.n_pre_samples + bo_cfg.n_iters * proposals_per_iter,
        image_batch=image_batch, normalize=normalize, prepare=prepare)
    return book.result()


def attribution_sweep(
    engine: SaliencyEngine,
    dataset: Iterable,
    method: str = "gradient",
    bbox_threshold: int = 180,
    image_batch: int = 16,
    max_images: Optional[int] = None,
    seed: int = 0,
    logger: Optional[PhaseLogger] = None,
    keep_heatmaps: bool = False,
    dataset_indices=None,
    journal=None,
    fidelity_steps: int = 0,
    steps: int = 16,
    samples: int = 16,
    noise_sigma: float = 0.15,
    magnitude: bool = False,
    gradcam_layer: Optional[str] = None,
    step_batch: Optional[int] = None,
    sample_batch: Optional[int] = None,
    lm_cfg: Optional[dict] = None,
    xrai_scales=None,
    normalize=None,
    heatmap_wire: str = "f32",
    # None = occlusion_map's resolution-adaptive defaults.
    patch: "int | None" = None,
    stride: "int | None" = None,
    rise_masks: int = 1000,
    rise_grid: int = 7,
    rise_keep_prob: float = 0.5,
    mask_batch: Optional[int] = None,
    scorecam_channels: int = 64,
    mesh=None,
) -> SweepResult:
    """Val-set sweep driven by the attribution family, through the same flush
    driver as :func:`bo_saliency_sweep`; no segmentation (these methods
    attribute pixels), and ``mean_survival`` stays 0.

    ``method`` is one of ``gradient.BATCHABLE_METHODS`` (gradient,
    grad_input, integrated, smoothgrad, gradcam: one stacked backward of the
    plain module per flush, ``gradient.attribute_batch``), ``"meaningful"``
    (the learned deletion mask per image,
    ``learned_mask.learned_mask_batch_dispatch``, hyperparameters in
    ``lm_cfg``; rows add prob_original and prob_masked), ``"xrai"`` (the
    batched signed IG per flush, then per image the host Felzenszwalb ladder
    and greedy ranking at collect time; rows add num_regions), or one of
    ``gradient.MASK_BATCHED_METHODS`` (occlusion, rise, scorecam: one image
    after another, each a run of masked forwards through the engine's folded
    net, B2 on the card). Stochastic seeds are ``seed + index``, so rows do
    not depend on the flush's composition and a resume equals an
    uninterrupted run. ``evals_per_sec`` counts backward passes (``steps``
    for integrated, ``samples`` for smoothgrad, the Adam ``iters`` for
    meaningful, 1 otherwise) or masked forwards (rise's rounded-up masks,
    occlusion's positions, scorecam's channels).

    ``normalize=(mean, std)``: the uint8 wire (for xrai the raw image is the
    ladder's display). ``heatmap_wire`` ``"f16"`` halves the heatmap fetch
    (<= 2^-11 relative rounding), ``"u8"`` quarters it by per-image min-max
    quantization (bbox and IOU exact); meaningful keeps f32, xrai's signed
    maps refuse ``"u8"``. ``mesh``: each flush's image axis shards over its
    data axis (every batched entry's ``mesh=``); seeds stay tied to images.
    """
    if heatmap_wire not in ("f32", "f16", "u8"):
        raise ValueError(f"heatmap_wire must be f32|f16|u8, got {heatmap_wire!r}")
    if method == "meaningful" and heatmap_wire != "f32":
        raise ValueError(f"heatmap_wire={heatmap_wire!r}: 'meaningful' keeps its f32 "
                         f"tuple state (heatmaps + per-image probabilities)")
    if method == "xrai" and heatmap_wire == "u8":
        raise ValueError(
            "heatmap_wire='u8': per-image min-max quantization destroys "
            "the SIGN of xrai's attributions; use 'f16' (sign-preserving, "
            "<=2^-11 relative rounding) or 'f32'")
    from network_interpretation_imagenet_tpu_torch.saliency import gradient as gmod

    all_methods = gmod.BATCHABLE_METHODS + ("meaningful", "xrai") + gmod.MASK_BATCHED_METHODS
    if method not in all_methods:
        raise ValueError(f"unknown attribution method {method!r}; choose from {all_methods}")
    book = _Books(engine, journal, logger, keep_heatmaps, bbox_threshold, fidelity_steps,
                  normalize)
    lm = dict(lm_cfg or {})

    def enqueue_display(image):
        if method != "xrai":
            return None
        if image.dtype == np.uint8:  # uint8 wire: the raw image is the display
            return image[:, :, 0] if image.ndim == 3 and image.shape[2] == 1 else image
        return _display(image)

    def wire(heats: torch.Tensor):
        if heatmap_wire == "f16":
            return heats.to(torch.float16)
        if heatmap_wire == "u8":
            return _quantize_heats_device(heats)
        return heats

    def dispatch(imgs_dev, disps, keep, idxs, preds, prep):
        keep_imgs = _kept(imgs_dev, keep)
        targets = _kept_targets(preds, keep)
        seeds = np.asarray([seed + int(idxs[j]) for j in keep], np.int64)
        if method == "meaningful":
            from network_interpretation_imagenet_tpu_torch.saliency import learned_mask

            return learned_mask.learned_mask_batch_dispatch(
                engine.bundle.logits, engine.variables, keep_imgs, targets, seeds=seeds,
                mesh=mesh, **lm)
        if method == "xrai":
            from network_interpretation_imagenet_tpu_torch.saliency import xrai

            attr = xrai.xrai_attribution_batch(engine.bundle.logits, engine.variables,
                                               keep_imgs, targets, steps=steps,
                                               step_batch=step_batch, mesh=mesh)
            return (attr.to(torch.float16) if heatmap_wire == "f16" else attr,
                    [disps[j] for j in keep])
        if method in gmod.MASK_BATCHED_METHODS:
            # The masked images in bf16, the methods' default, as the JAX
            # package's sweep runs them whatever the engine's dtype.
            return wire(gmod.mask_method_batch(
                engine.folded_logits, engine.variables, keep_imgs, targets, method,
                bundle=engine.bundle, seeds=seeds, patch=patch, stride=stride,
                rise_masks=rise_masks, rise_grid=rise_grid, rise_keep_prob=rise_keep_prob,
                mask_batch=mask_batch, gradcam_layer=gradcam_layer,
                scorecam_channels=scorecam_channels, mesh=mesh))
        return wire(gmod.attribute_batch(
            engine.bundle.logits, engine.variables, keep_imgs, targets, method,
            bundle=engine.bundle, steps=steps, samples=samples, noise_sigma=noise_sigma,
            magnitude=magnitude, gradcam_layer=gradcam_layer, seeds=seeds,
            step_batch=step_batch, sample_batch=sample_batch, mesh=mesh))

    def collect(state):
        if method == "xrai":
            from network_interpretation_imagenet_tpu_torch.saliency import xrai
            from network_interpretation_imagenet_tpu_torch.segment.felzenszwalb import (
                felzenszwalb_ladder,
            )

            attrs, kept_disps = state
            attrs = _host(attrs).astype(np.float32)  # one fetch; f16 back to f32
            # None: the area-adaptive ladder (DEFAULT_SCALES is a 224^2 calibration).
            scales = (xrai.adaptive_scales(*kept_disps[0].shape[:2])
                      if xrai_scales is None else xrai_scales)
            out = []
            for pos in range(len(attrs)):
                seg_maps = felzenszwalb_ladder(kept_disps[pos], scales, sigma=0.5)
                heat, n_regions = xrai.greedy_region_ranking(attrs[pos], seg_maps)
                out.append((heat, {"method": method, "num_regions": int(n_regions)}))
            return out
        if method == "meaningful":
            heats, _, p_orig, p_masked, _ = (_host(t) for t in state)
            return [(heats[pos], {"method": method,
                                  "prob_original": round(float(p_orig[pos]), 6),
                                  "prob_masked": round(float(p_masked[pos]), 6)})
                    for pos in range(len(heats))]
        if heatmap_wire == "u8":
            q, lo, span = (_host(t) for t in state)
            heats = lo[:, None, None] + q.astype(np.float32) * (span[:, None, None] / 255.0)
        else:  # f32 (lossless) or f16 (reconstructs with rounding)
            heats = _host(state).astype(np.float32)
        return [(heats[pos], {"method": method}) for pos in range(len(heats))]

    _batched_flush_sweep(
        engine, book.items(dataset, max_images, dataset_indices), book,
        enqueue_display=enqueue_display, dispatch=dispatch, collect=collect,
        evals_per_image=_attr_evals_per_image(
            method, steps=steps, samples=samples, lm=lm, rise_masks=rise_masks,
            mask_batch=mask_batch, patch=patch, stride=stride,
            scorecam_channels=scorecam_channels),
        image_batch=image_batch, normalize=normalize)
    return book.result()
