"""One attribution method on one image (port of ``cli/occlusion_saliency.py``
of the JAX package).

Methods: ``occlusion`` (patch-sweep probability drop, masked forwards),
``gradient`` (input gradient), ``grad_input``, ``integrated`` (integrated
gradients), ``smoothgrad`` (``--sg-squared`` for SmoothGrad^2), ``rise``
(random upsampled soft masks), ``gradcam`` (``--gradcam-layer list`` prints
the model's layer menu), ``scorecam`` (top-K activation channels as soft
masks), ``xrai`` (region-ranked integrated gradients over a Felzenszwalb
ladder, ``--xrai-scales``), ``meaningful`` (a learned deletion mask,
``--lm-*``). The masked forwards (occlusion, rise, scorecam) run the folded
net, B2 on the card; the gradient methods differentiate the plain module.

    python -m network_interpretation_imagenet_tpu_torch.cli.occlusion_saliency \\
        --data tests/fixtures/imagenet_loc --method occlusion [--device cpu] --out outputs

:func:`compute` returns ``(payload, heatmap, display)`` (``payload`` is
``None`` after ``--gradcam-layer list``); :func:`main` writes
``<method>_result.json`` (the JAX package's keys), the heatmap PNG and the
panel figure (matplotlib).
"""

from __future__ import annotations

import os

from network_interpretation_imagenet_tpu_torch.cli import common
from network_interpretation_imagenet_tpu_torch.cli.compare_saliency_methods import heatmap
from network_interpretation_imagenet_tpu_torch.saliency import gradient as grad_mod
from network_interpretation_imagenet_tpu_torch.saliency.pipeline import localization_score

METHODS = ("occlusion", "gradient", "grad_input", "xrai", "meaningful", "integrated",
           "smoothgrad", "rise", "gradcam", "scorecam")


def parse_args(argv=None):
    p = common.build_parser(__doc__)
    p.add_argument("--method", default="occlusion", choices=METHODS)
    common.add_method_flags(p, rise_masks=1000)
    p.add_argument("--bbox_threshold", type=int, default=180)
    return p.parse_args(argv)


def compute(args):
    image, disp, label, gt_bbox = common.resolve_image(args)
    engine = common.build_engine(args)
    target, _ = engine.predict_one(image)   # the prediction is explained
    if args.method in ("gradcam", "scorecam") and args.gradcam_layer == "list":
        for name, shape in grad_mod.gradcam_target_layers(engine.bundle, engine.variables, image):
            print(f"{name}  {shape}")
        return None, None, disp
    payload = {"method": args.method, "target": int(target)}
    if args.method in ("xrai", "meaningful"):
        # These two report more than the heatmap: run them here.
        from network_interpretation_imagenet_tpu_torch.saliency import learned_mask, xrai

        if args.method == "xrai":
            res = xrai.xrai_saliency(engine.bundle.logits, engine.variables, image, target, disp,
                                     steps=args.ig_steps,
                                     scales=common.parse_xrai_scales(args.xrai_scales))
            heat = res.heatmap
        else:
            res = learned_mask.learned_mask_saliency(
                engine.bundle.logits, engine.variables, image, target,
                mask_size=args.lm_mask_size, iters=args.lm_iters, l1=args.lm_l1, tv=args.lm_tv,
                jitter=args.lm_jitter, baseline=args.lm_baseline, seed=args.seed,
                compute_dtype=engine.compute_dtype)
            heat = res.heatmap
    else:
        heat = heatmap(args.method, engine, image, disp, None, int(target), args)
    payload["heat_range"] = [float(heat.min()), float(heat.max())]
    if args.method == "xrai":
        payload["num_regions"] = int(res.num_regions)
    if args.method == "meaningful":
        payload["prob_original"] = round(res.prob_original, 6)
        payload["prob_masked"] = round(res.prob_masked, 6)
    if gt_bbox is not None:
        iou, pred_box = localization_score(heat, gt_bbox, args.bbox_threshold)
        payload["IOU"] = round(float(iou), 4)
        payload["pred_box_xywh"] = [int(v) for v in pred_box]
    return payload, heat, disp


def main(argv=None):
    from network_interpretation_imagenet_tpu_torch.saliency.viz import save_panels

    args = parse_args(argv)
    payload, heat, disp = compute(args)
    if payload is None:
        return 0
    common.write_heatmap_png(os.path.join(args.out, f"{args.method}_heatmap.png"), heat)
    save_panels(os.path.join(args.out, f"{args.method}_result.png"), [disp, heat],
                ["Original image", f"{args.method} saliency"])
    common.emit_result(args.out, f"{args.method}_result.json", payload)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
