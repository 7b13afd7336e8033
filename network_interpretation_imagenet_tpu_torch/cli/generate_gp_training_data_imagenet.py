"""Random-mask GP-training-data generator and minimal-mask search CLI
(reference ``generate_gp_training_data_imagenet.py``): N random window masks
-> classifier verdicts -> summed heatmap, then the minimal summed-label
threshold whose mask keeps the prediction (``:396-487``), every threshold
level evaluated in one batched forward.

    python -m network_interpretation_imagenet_tpu_torch.cli.generate_gp_training_data_imagenet \\
        --data tests/fixtures/imagenet_loc [--arch resnet18] [--num_mask_samples 100] \\
        [--device cpu] --out outputs

:func:`compute` computes the result and :func:`main` writes it:
``gp_training_data_result.json`` (the JAX package's payload keys),
``masks.npz`` (what ``gp_regression`` and ``gp_classification`` read),
the heatmap PNG, the threshold panel figure (matplotlib) and, with
``--save-pngs``, one PNG per mask.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.cli import common
from network_interpretation_imagenet_tpu_torch.saliency.pipeline import (
    localization_score,
    minimal_mask_search,
    random_window_saliency,
)


def parse_args(argv=None):
    p = common.build_parser(__doc__)
    p.add_argument("--bbox_threshold", type=int, default=180)
    p.add_argument("--skip-threshold-search", action="store_true")
    p.add_argument("--fidelity", action="store_true",
                   help="also report deletion/insertion AUC (and the pointing game with gt "
                        "boxes) for the produced heatmap")
    return p.parse_args(argv)


def compute(args):
    """Run the generator; returns ``(payload, result)``: the JSON payload,
    and the arrays the writers need (display image, segments, saliency
    output, threshold)."""
    image, disp, label, gt_bbox = common.resolve_image(args)
    engine = common.build_engine(args)
    target, _ = engine.predict_one(image)
    if label is not None and target != label:
        print(f"[warn] wrong prediction (pred={target}, label={label})")

    seg = common.segment_display(disp, common.segment_config(args), args.device)
    print(f"number of segments: {seg.max() + 1}")
    out = random_window_saliency(engine, image, seg, num_samples=args.num_mask_samples,
                                 window_fraction=args.window_fraction, seed=args.seed,
                                 target=target)
    correct = int(out.eval.survived.sum())
    print(f"{args.num_mask_samples} samples, the correct prediction number: {correct}")

    payload = {
        "eval_img_index": args.eval_img_index,
        "target": int(target),
        "num_segments": out.num_segments,
        "num_mask_samples": args.num_mask_samples,
        "correct_pred_count": correct,
        "masks_npz": os.path.join(args.out, "masks.npz"),
    }
    thr = None
    if not args.skip_threshold_search:
        thr, keep, levels = minimal_mask_search(engine, image, out.heatmap, target)
        payload["mask_threshold"] = thr
        payload["levels"] = levels.tolist()
        payload["keeps_prediction"] = keep.astype(int).tolist()
    if gt_bbox is not None:
        iou, pred_box = localization_score(out.heatmap, gt_bbox, args.bbox_threshold)
        payload["IOU"] = round(float(iou), 4)
        payload["pred_box_xywh"] = [int(v) for v in pred_box]
    if args.fidelity:
        payload.update(common.fidelity_entries(engine, image, out.heatmap, target, gt_bbox))
    return payload, {"disp": disp, "segments": seg, "out": out, "threshold": thr}


def write_artifacts(args, payload, result) -> None:
    """The heatmap PNG, ``masks.npz``, the mask PNGs, the threshold panel,
    then the JSON payload."""
    from network_interpretation_imagenet_tpu_torch.ops import masking
    from network_interpretation_imagenet_tpu_torch.saliency.viz import mark_boundaries, save_panels

    out, seg, disp, thr = result["out"], result["segments"], result["disp"], result["threshold"]
    common.write_heatmap_png(os.path.join(args.out, "heatmap.png"), out.heatmap)
    common.save_mask_npz(
        os.path.join(args.out, "masks.npz"),
        segments=seg, firsts=out.firsts, width=np.asarray(out.width),
        labels=out.eval.labels, prob_target=out.eval.prob_target,
        heatmap=out.heatmap, target=np.asarray(payload["target"]),
    )
    if args.save_pngs:
        masks = masking.window_masks(torch.from_numpy(seg), torch.from_numpy(out.firsts),
                                     out.width).numpy()
        common.save_mask_pngs(os.path.join(args.out, "masks"), masks, out.eval.labels)
    if thr is not None:
        mask1 = out.heatmap >= thr
        save_panels(
            os.path.join(args.out, f"index_{args.eval_img_index}_threshold_{thr:g}.png"),
            [disp, mark_boundaries(disp, seg), mask1.astype(float),
             np.asarray(disp) * mask1[..., None] if disp.ndim == 3 else disp * mask1],
            [f"original_img_label_{payload['target']}", "Superpixel",
             f"Mask threshold_{thr:g}", "Org_img_with_mask"],
        )
    common.emit_result(args.out, "gp_training_data_result.json", payload)


def main(argv=None):
    args = parse_args(argv)
    write_artifacts(args, *compute(args))


if __name__ == "__main__":
    main()
