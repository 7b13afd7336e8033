"""BO-guided saliency CLI, the reference's flagship path
(``bayesian_active_learning_imagenet.py:379-498``): GP-EI Bayesian
optimization over superpixel-window masks, summed-label heatmap, bbox + IOU.

    python -m network_interpretation_imagenet_tpu_torch.cli.bayesian_active_learning_imagenet \\
        --data tests/fixtures/imagenet_loc --arch resnet101 [--fused] [--num-images N] \\
        [--device cpu] --out outputs

:func:`explain` computes the result and :func:`main` writes it: ``bo_result.json``
(the JAX package's payload keys), the heatmap PNG, the panel figure
(matplotlib) and, with ``--save-pngs``, one PNG per evaluated mask.
"""

from __future__ import annotations

import copy
import os
import time

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.cli import common
from network_interpretation_imagenet_tpu_torch.config import BOConfig
from network_interpretation_imagenet_tpu_torch.saliency.bo_pipeline import (
    bo_window_saliency,
    bo_window_saliency_multi,
)
from network_interpretation_imagenet_tpu_torch.saliency.pipeline import localization_score


def parse_args(argv=None):
    p = common.build_parser(__doc__)
    common.add_bo_flags(p)
    p.add_argument("--bbox_threshold", type=int, default=180)
    p.add_argument("--proposals-per-iter", type=int, default=1,
                   help="q-batched BO: evaluate the top-q EI proposals of an iteration in "
                        "one forward (1 = reference behavior)")
    p.add_argument("--fidelity", action="store_true",
                   help="deletion/insertion AUC: not ported yet (ROADMAP A19)")
    p.add_argument("--num-images", type=int, default=1,
                   help=">1: explain N consecutive images with the image-batched fused loop")
    return p.parse_args(argv)


def explain(args):
    """Run the explanation; returns ``(payload, outputs)``: the
    ``bo_result.json`` payload, and per image ``(index, display, saliency
    output)`` for the artifact writers."""
    if args.fidelity:
        raise NotImplementedError("--fidelity is not ported yet (ROADMAP A19)")
    if args.num_images > 1:
        return _explain_batched(args)

    start = time.time()
    image, disp, label, gt_bbox = common.resolve_image(args)
    engine = common.build_engine(args)
    pred, _ = engine.predict_one(image)
    if label is not None and pred != label:
        # The reference raises here (:221); the predicted class is explained instead.
        print(f"[warn] wrong prediction (pred={pred}, label={label}); "
              "explaining the predicted class instead")
    target = pred

    seg = common.segment_display(disp, common.segment_config(args))
    print(f"{args.segmenter} number of segments: {seg.max() + 1}")
    cfg = BOConfig(n_iters=args.n_iters, n_pre_samples=args.n_pre_samples)
    out, trace = bo_window_saliency(
        engine, image, seg, cfg, window_fraction=args.window_fraction, seed=args.seed,
        target=target, fused=args.fused, proposals_per_iter=args.proposals_per_iter)
    duration = time.time() - start

    payload = {
        "eval_img_index": args.eval_img_index,
        "target": int(target),
        "num_segments": out.num_segments,
        "bo_xp": trace.xp.tolist(),
        "bo_yp": [round(float(v), 5) for v in trace.yp],
        "survived": int(out.eval.survived.sum()),
        "time_duration_s": round(duration, 3),
    }
    if gt_bbox is not None:
        iou, pred_box = localization_score(out.heatmap, gt_bbox, args.bbox_threshold)
        payload["IOU"] = round(float(iou), 4)
        payload["pred_box_xywh"] = [int(v) for v in pred_box]
        payload["gt_box_xywh"] = [float(v) for v in gt_bbox]
    return payload, [(args.eval_img_index, disp, out)]


def _explain_batched(args):
    """N images through the image-batched fused loop, one program (the host
    loop cannot batch images, so ``--no-fused`` does not apply here)."""
    from network_interpretation_imagenet_tpu_torch.segment.common import segment_image_batch

    if not args.fused:
        print("[note] --num-images > 1 always uses the fused image-batched loop "
              "(--no-fused applies to single-image runs only)")
    start = time.time()
    engine = common.build_engine(args)
    images, disps, labels, gts = [], [], [], []
    for i in range(args.num_images):
        a = copy.copy(args)
        a.eval_img_index = args.eval_img_index + i
        image, disp, label, gt_bbox = common.resolve_image(a)
        images.append(np.asarray(image))
        disps.append(disp)
        labels.append(label)
        gts.append(gt_bbox)
    segs = segment_image_batch(disps, common.segment_config(args))

    preds = np.asarray(engine.predict(np.stack(images)).argmax(axis=1))
    for i, label in enumerate(labels):
        if label is not None and int(preds[i]) != int(label):
            print(f"[warn] wrong prediction at index {args.eval_img_index + i} "
                  f"(pred={int(preds[i])}, label={label}); explaining the predicted class "
                  "instead")

    cfg = BOConfig(n_iters=args.n_iters, n_pre_samples=args.n_pre_samples)
    results = bo_window_saliency_multi(
        engine, images, segs, cfg, window_fraction=args.window_fraction, seed=args.seed,
        targets=preds.tolist(), proposals_per_iter=args.proposals_per_iter)
    duration = time.time() - start

    rows, outputs = [], []
    for i, (out, trace) in enumerate(results):
        row = {
            "eval_img_index": args.eval_img_index + i,
            "target": int(preds[i]),
            "num_segments": out.num_segments,
            "survived": int(out.eval.survived.sum()),
            "best_start": int(trace.xp[np.argmax(trace.yp)]),
        }
        if gts[i] is not None:
            iou, _ = localization_score(out.heatmap, gts[i], args.bbox_threshold)
            row["IOU"] = round(float(iou), 4)
        rows.append(row)
        outputs.append((args.eval_img_index + i, disps[i], out))
    payload = {
        "num_images": args.num_images,
        "per_image": rows,
        "time_duration_s": round(duration, 3),
        "ms_per_image": round(duration / args.num_images * 1000, 1),
    }
    return payload, outputs


def write_artifacts(args, payload, outputs) -> None:
    """The heatmap PNG, the panel figure and the mask PNGs of each image,
    then ``bo_result.json``."""
    from network_interpretation_imagenet_tpu_torch.ops import masking
    from network_interpretation_imagenet_tpu_torch.saliency.viz import mark_boundaries, save_panels

    batched = args.num_images > 1
    for index, disp, out in outputs:
        common.write_heatmap_png(
            os.path.join(args.out, f"heatmap_{index}.png" if batched else "heatmap.png"),
            out.heatmap)
        save_panels(os.path.join(args.out, f"index_{index}.png"),
                    [disp, mark_boundaries(disp, out.segments), out.heatmap],
                    ["Org_img", "Superpixels", "Summed label training heatmap"])
        if args.save_pngs:
            masks = masking.window_masks(torch.from_numpy(out.segments),
                                         torch.from_numpy(out.firsts), out.width).numpy()
            common.save_mask_pngs(
                os.path.join(args.out, f"masks_{index}" if batched else "masks"), masks,
                out.eval.labels)
    common.emit_result(args.out, "bo_result.json", payload)


def main(argv=None):
    args = parse_args(argv)
    write_artifacts(args, *explain(args))


if __name__ == "__main__":
    main()
