"""Rank attribution methods by faithfulness on a slice of images (port of
``cli/compare_saliency_methods.py`` of the JAX package).

Runs every attribution method over the same images, scores each heatmap by
deletion AUC (lower is better) and insertion AUC (higher is better), one
batched forward per pair of curves, and the pointing game where gt boxes
exist, then ranks the methods by the margin insertion - deletion. Methods:
``window`` (random superpixel windows), ``knockout``, ``bo`` (GP-EI BO),
``field`` (the GP methods' raw training field), ``gp`` (the field smoothed by
the Kronecker pixel GP's posterior mean), ``gp_cls`` (the variational
classification GP's survive probability), ``occlusion``, ``gradient``,
``grad_input``, ``integrated``, ``smoothgrad``, ``rise``, ``gradcam``,
``scorecam``, ``xrai``, ``meaningful``.

The ranking comes with paired-bootstrap 95% intervals over images; a tier
boundary is drawn only where the bootstrap separates adjacent methods
(P(margin_A > margin_B) >= ``--tier-sep``).

    python -m network_interpretation_imagenet_tpu_torch.cli.compare_saliency_methods \\
        --data tests/fixtures/imagenet_loc --num-images 3 [--methods window,bo,rise] \\
        [--device cpu] --out outputs

:func:`compute` scores the methods and returns the ``method_comparison.json``
payload (the JAX package's keys); :func:`main` prints the table and writes it.
"""

from __future__ import annotations

import copy
import glob
import os
import time

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.cli import common
from network_interpretation_imagenet_tpu_torch.config import BOConfig
from network_interpretation_imagenet_tpu_torch.saliency import bo_pipeline, eval_metrics, pipeline
from network_interpretation_imagenet_tpu_torch.saliency import gradient as grad_mod

METHODS = ("window", "knockout", "bo", "field", "gp", "gp_cls", "occlusion",
           "gradient", "grad_input", "integrated", "smoothgrad", "rise",
           "gradcam", "scorecam", "xrai", "meaningful")


def field_info(engine, image, segments, target: int, args, kind=None, soft=None):
    """``(field, degenerate)``: the summed mask-label field that the GP
    methods train on and the ``window`` method's heatmap. ``kind`` is
    ``"window"`` (40% windows) or ``"knockout"`` (``--num_masked_superpixels``
    segments removed per mask); ``None`` follows ``--gp-field``. Cached per
    image in ``args._field_cache``. ``degenerate``: every mask got the same
    label, so the field holds mask coverage only."""
    from network_interpretation_imagenet_tpu_torch.ops import aggregate

    kind = kind or getattr(args, "gp_field", "window")
    if soft is None:
        soft = getattr(args, "gp_labels", "hard") == "soft"
    key = (kind, soft)
    cache = getattr(args, "_field_cache", None)
    if cache is not None and key in cache:
        return cache[key]
    if kind == "knockout":
        out = pipeline.knockout_saliency(engine, image, segments,
                                         num_samples=args.num_mask_samples,
                                         num_knockout=args.num_masked_superpixels,
                                         seed=args.seed, target=target)
        field = (aggregate.summed_label_heatmap(
            torch.from_numpy(out.masks), torch.from_numpy(out.eval.prob_target)).numpy()
            if soft else out.heatmap).astype(np.float32)
    else:
        out = pipeline.random_window_saliency(engine, image, segments,
                                              num_samples=args.num_mask_samples,
                                              window_fraction=args.window_fraction,
                                              seed=args.seed, target=target)
        field = (aggregate.summed_superpixel_labels_np(out.segments, out.firsts, out.width,
                                                        out.eval.prob_target)
                 if soft else out.heatmap).astype(np.float32)
    labels = out.eval.prob_target if soft else out.eval.labels
    info = (field, bool(np.ptp(np.asarray(labels)) == 0))
    if cache is not None:
        cache[key] = info
    return info


def _host(heat) -> np.ndarray:
    return heat.detach().cpu().numpy() if isinstance(heat, torch.Tensor) else np.asarray(heat)


def heatmap(method: str, engine, image, disp, segments, target: int, args) -> np.ndarray:
    """One method's heatmap for one image (every method shares the engine:
    its ``variables``, ``bundle.logits`` for the gradients and
    ``engine.folded_logits`` for the masked forwards)."""
    bundle, variables = engine.bundle, engine.variables
    grad_fn, masked_fn = bundle.logits, engine.folded_logits
    dtype = engine.compute_dtype
    if method == "window":
        return field_info(engine, image, segments, target, args, kind="window", soft=False)[0]
    if method == "knockout":
        return pipeline.knockout_saliency(engine, image, segments,
                                          num_samples=args.num_mask_samples,
                                          num_knockout=args.num_masked_superpixels,
                                          seed=args.seed, target=target).heatmap
    if method == "bo":
        out, _ = bo_pipeline.bo_window_saliency(
            engine, image, segments, BOConfig(n_iters=args.n_iters,
                                              n_pre_samples=args.n_pre_samples),
            window_fraction=args.window_fraction, seed=args.seed, target=target,
            fused=args.fused)
        return out.heatmap
    if method == "field":
        return field_info(engine, image, segments, target, args)[0]
    if method == "gp":
        from network_interpretation_imagenet_tpu_torch.gp import kron

        heat = field_info(engine, image, segments, target, args)[0]
        params, _ = kron.fit_adam(heat, iters=args.gp_iters, lr=args.gp_lr, device=engine.device)
        return _host(kron.posterior(params, heat, device=engine.device)[0])
    if method == "gp_cls":
        from network_interpretation_imagenet_tpu_torch.gp import variational as vgp

        heat = field_info(engine, image, segments, target, args)[0]
        h, w = heat.shape
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        coords = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float32)
        flat = heat.ravel()
        y01 = (flat > np.median(flat)).astype(np.float32)
        train_idx = np.arange(len(flat))
        if len(train_idx) > args.gp_train_subsample:
            train_idx = np.random.RandomState(args.seed).choice(
                train_idx, args.gp_train_subsample, replace=False)
        model = vgp.init_model(max(h, w), grid_size=args.gp_grid_size, device=engine.device)
        model, _ = vgp.fit_adam(model, coords[train_idx], y01[train_idx],
                                iters=args.gp_cls_iters, lr=args.gp_lr)
        return _host(vgp.predict_proba(model, coords)).reshape(h, w)
    if method == "occlusion":
        return _host(grad_mod.occlusion_map(masked_fn, variables, image, target,
                                            patch=args.patch, stride=args.stride,
                                            batch=args.mask_batch, compute_dtype=dtype))
    if method == "gradient":
        return _host(grad_mod.input_gradient(grad_fn, variables, image, target))
    if method == "grad_input":
        return _host(grad_mod.grad_times_input(grad_fn, variables, image, target))
    if method == "integrated":
        return _host(grad_mod.integrated_gradients(grad_fn, variables, image, target,
                                                   steps=args.ig_steps))
    if method == "smoothgrad":
        return _host(grad_mod.smoothgrad(grad_fn, variables, image, target,
                                         samples=args.sg_samples, noise_sigma=args.sg_sigma,
                                         seed=args.seed, magnitude=args.sg_squared))
    if method == "rise":
        return _host(grad_mod.rise_map(masked_fn, variables, image, target,
                                       num_masks=args.rise_masks, grid=args.rise_grid,
                                       keep_prob=args.rise_keep, batch=args.mask_batch,
                                       seed=args.seed, compute_dtype=dtype))
    if method == "gradcam":
        return _host(grad_mod.gradcam(bundle, variables, image, target, layer=args.gradcam_layer))
    if method == "scorecam":
        return _host(grad_mod.scorecam(bundle, variables, image, target,
                                       layer=args.gradcam_layer,
                                       channels=args.scorecam_channels, batch=args.mask_batch,
                                       compute_dtype=dtype, logits_fn=masked_fn))
    if method == "xrai":
        from network_interpretation_imagenet_tpu_torch.saliency import xrai

        return xrai.xrai_saliency(grad_fn, variables, image, target, disp, steps=args.ig_steps,
                                  scales=common.parse_xrai_scales(args.xrai_scales)).heatmap
    if method == "meaningful":
        from network_interpretation_imagenet_tpu_torch.saliency import learned_mask

        return learned_mask.learned_mask_saliency(
            grad_fn, variables, image, target, mask_size=args.lm_mask_size,
            iters=args.lm_iters, l1=args.lm_l1, tv=args.lm_tv, jitter=args.lm_jitter,
            baseline=args.lm_baseline, seed=args.seed, compute_dtype=dtype).heatmap
    raise ValueError(f"unknown method {method!r}")


def parse_args(argv=None):
    p = common.build_parser(__doc__)
    p.add_argument("--methods", default=",".join(METHODS),
                   help=f"comma list from {','.join(METHODS)}")
    p.add_argument("--num-images", type=int, default=8)
    p.add_argument("--fidelity-steps", type=int, default=32)
    g = p.add_argument_group("gp surrogate methods")
    g.add_argument("--gp_iters", type=int, default=20,
                   help="gp: Adam iterations of the Kronecker pixel GP")
    g.add_argument("--gp_lr", type=float, default=0.1)
    g.add_argument("--gp-cls-iters", type=int, default=30, help="gp_cls: ELBO Adam iterations")
    g.add_argument("--gp-grid-size", type=int, default=10, help="gp_cls: inducing grid side")
    g.add_argument("--gp-train-subsample", type=int, default=4096,
                   help="gp_cls: most training pixels")
    g.add_argument("--gp-labels", default="hard", choices=["hard", "soft"],
                   help="labels the gp/gp_cls training field sums: 'hard' survive bits (the "
                        "reference's) or 'soft' target-class probabilities")
    g.add_argument("--gp-field", default="window", choices=["window", "knockout"],
                   help="mask family the gp/gp_cls surrogates train on: 40%% windows (the "
                        "reference's ImageNet field) or knockouts of "
                        "--num_masked_superpixels segments")
    p.add_argument("--jpeg-dir", default=None, metavar="DIR",
                   help="score the JPEG/PNG files under DIR (resized and centre-cropped, "
                        "normalized; targets are the model's argmax) instead of "
                        "--synthetic/--data")
    p.add_argument("--skip-degenerate", action="store_true",
                   help="skip images whose --gp-field labels are constant, scanning up to "
                        "4x --num-images for informative ones")
    g = p.add_argument_group("statistics")
    g.add_argument("--bootstrap", type=int, default=2000,
                   help="paired bootstrap resamples over images (0 disables)")
    g.add_argument("--tier-sep", type=float, default=0.975,
                   help="P(margin_A > margin_B) needed for a tier boundary")
    common.add_method_flags(p)
    common.add_bo_flags(p)
    args = p.parse_args(argv)
    methods = list(dict.fromkeys(m.strip() for m in args.methods.split(",") if m.strip()))
    unknown = [m for m in methods if m not in METHODS]
    if unknown:
        p.error(f"unknown methods {unknown}; choose from {METHODS}")
    args.method_list = methods
    return args


def _jpeg_loader(args):
    """The ``--jpeg-dir`` files and a loader of one: (normalized f32 HWC,
    display uint8 HWC)."""
    exts = ("*.JPEG", "*.jpeg", "*.jpg", "*.png")
    files = sorted(f for e in exts
                   for f in glob.glob(os.path.join(args.jpeg_dir, "**", e), recursive=True))
    if not files:
        raise SystemExit(f"--jpeg-dir {args.jpeg_dir!r}: no JPEG/PNG files found")

    def load(path):
        from PIL import Image

        from network_interpretation_imagenet_tpu_torch.config import DATASETS
        from network_interpretation_imagenet_tpu_torch.data.transform import pil_eval_transform
        from network_interpretation_imagenet_tpu_torch.ops import preprocess

        spec = DATASETS[args.dataset]
        with Image.open(path) as f:
            img = pil_eval_transform(f.convert("RGB"), crop=spec.image_size, mean=spec.mean,
                                     std=spec.std)
        return img, preprocess.to_display_uint8(torch.from_numpy(img)).numpy()

    return files, load


def compute(args) -> dict:
    """Score ``args.method_list`` on the slice; returns the
    ``method_comparison.json`` payload. Prints nothing but notes."""
    methods = args.method_list
    engine = common.build_engine(args)
    seg_cfg = common.segment_config(args)
    jpegs, load = _jpeg_loader(args) if args.jpeg_dir else ([], None)
    rows = {m: [] for m in methods}
    times = {m: 0.0 for m in methods}
    used, skipped = 0, 0
    # --eval_img_index is the 1-based start of the slice.
    n_images = min(args.num_images, len(jpegs)) if jpegs else args.num_images
    scan = (min(4 * n_images, len(jpegs)) if jpegs else 4 * n_images) \
        if args.skip_degenerate else n_images
    a = copy.copy(args)
    for i in range(scan):
        if used >= n_images:
            break
        a.eval_img_index = args.eval_img_index + i
        if jpegs:
            image, disp = load(jpegs[i])
            label, gt_bbox = None, None
        else:
            image, disp, label, gt_bbox = common.resolve_image(a)
        target, _ = engine.predict_one(image)
        if label is not None and int(target) != int(label):
            continue  # the reference explains correct predictions only
        segments = common.segment_display(disp, seg_cfg, args.device)
        a._field_cache = {}
        if args.skip_degenerate and field_info(engine, image, segments, int(target), a)[1]:
            skipped += 1
            continue
        used += 1
        for m in methods:
            t0 = time.perf_counter()
            heat = heatmap(m, engine, image, disp, segments, int(target), a)
            times[m] += time.perf_counter() - t0
            d = eval_metrics.deletion_insertion_auc(engine, image, heat, int(target),
                                                    steps=args.fidelity_steps)
            # A constant heatmap scores the pixel-index-order baseline, not the
            # method; the field-trained methods degenerate with their labels.
            degenerate = bool(np.ptp(heat) == 0) or (
                m in ("field", "gp", "gp_cls")
                and field_info(engine, image, segments, int(target), a)[1]) or (
                m == "window" and field_info(engine, image, segments, int(target), a,
                                             kind="window", soft=False)[1])
            row = {"deletion_auc": float(d["deletion_auc"]),
                   "insertion_auc": float(d["insertion_auc"]), "degenerate": degenerate}
            if gt_bbox is not None:
                row["pointing_hit"] = bool(eval_metrics.pointing_game(heat, gt_bbox))
            rows[m].append(row)
    payload = {"images_used": used, "skipped_degenerate": skipped, "gp_field": args.gp_field,
               "gp_labels": args.gp_labels,
               "source": ("jpeg-dir" if jpegs else
                          "synthetic" if (args.synthetic or not args.data) else "dataset"),
               "fidelity_steps": args.fidelity_steps}
    if not used:
        return payload
    summary = {}
    for m in methods:
        rs = rows[m]
        entry = {"images": len(rs),
                 "mean_deletion_auc": round(float(np.mean([r["deletion_auc"] for r in rs])), 5),
                 "mean_insertion_auc": round(float(np.mean([r["insertion_auc"] for r in rs])), 5),
                 "seconds_per_image": round(times[m] / max(len(rs), 1), 3),
                 "degenerate_images": int(sum(r["degenerate"] for r in rs))}
        hits = [r["pointing_hit"] for r in rs if "pointing_hit" in r]
        if hits:
            entry["pointing_game_acc"] = round(float(np.mean(hits)), 4)
        summary[m] = entry
    order = sorted(methods, key=lambda m: summary[m]["mean_insertion_auc"]
                   - summary[m]["mean_deletion_auc"], reverse=True)
    # Paired bootstrap: one index vector per replicate keeps the per-image
    # pairing, so the intervals and P(margin_A > margin_B) share replicates.
    margins = {m: np.array([r["insertion_auc"] - r["deletion_auc"] for r in rows[m]])
               for m in methods}
    tiers, seps = [[order[0]]], {}
    if args.bootstrap > 0 and used > 1:
        idx = np.random.RandomState(args.seed).randint(0, used, size=(args.bootstrap, used))
        boot = {m: margins[m][idx].mean(axis=1) for m in methods}
        for m in methods:
            lo, hi = np.percentile(boot[m], [2.5, 97.5])
            summary[m]["margin_mean"] = round(float(margins[m].mean()), 5)
            summary[m]["margin_ci95"] = [round(float(lo), 5), round(float(hi), 5)]
        for x, y in zip(order, order[1:]):
            p_gt = float(np.mean(boot[x] > boot[y]))
            seps[f"{x}>{y}"] = round(p_gt, 4)
            if p_gt >= args.tier_sep:
                tiers.append([y])
            else:
                tiers[-1].append(y)
    else:
        tiers = [list(order)]
        for m in methods:
            summary[m]["margin_mean"] = round(float(margins[m].mean()), 5)
    payload.update({"ranking": order, "tiers": tiers, "adjacent_separation": seps,
                    "bootstrap": args.bootstrap, "methods": summary})
    return payload


def print_table(args, payload) -> None:
    """The ranking table, as the JAX package prints it."""
    summary, order = payload["methods"], payload["ranking"]
    tier_of = {m: i + 1 for i, t in enumerate(payload["tiers"]) for m in t}
    any_deg = any(summary[m]["degenerate_images"] for m in order)
    header = (f"{'tier':>4}  {'method':>12}  {'del_auc↓':>9}  {'ins_auc↑':>9}  {'margin':>7}  "
              f"{'ci95':>18}  {'s/img':>7}")
    if any_deg:
        header += f"  {'deg':>7}"
    if any("pointing_game_acc" in summary[m] for m in order):
        header += f"  {'point':>6}"
    print(header)
    for m in order:
        s = summary[m]
        ci = s.get("margin_ci95")
        ci_s = f"[{ci[0]:+.3f},{ci[1]:+.3f}]" if ci else "-"
        line = (f"{tier_of[m]:>4}  {m:>12}  {s['mean_deletion_auc']:>9.4f}  "
                f"{s['mean_insertion_auc']:>9.4f}  {s['margin_mean']:>+7.3f}  {ci_s:>18}  "
                f"{s['seconds_per_image']:>7.2f}")
        if any_deg:
            line += f"  {s['degenerate_images']:>3d}/{s['images']:<3d}"
        if "pointing_game_acc" in s:
            line += f"  {s['pointing_game_acc']:>6.2f}"
        print(line)
    if len(payload["tiers"]) < len(order):
        print(f"(methods sharing a tier are NOT separated at P>={args.tier_sep:g} by the paired "
              "bootstrap; their in-tier order is noise)")
    if any_deg:
        print("(deg = images where the method's heatmap was constant: those rows scored the "
              "pixel-index-order baseline, not the method)")
    if args.skip_degenerate:
        print(f"(--skip-degenerate: {payload['skipped_degenerate']} images without mask "
              "signal skipped during the scan)")


def main(argv=None):
    args = parse_args(argv)
    payload = compute(args)
    if not payload["images_used"]:
        print("no scoreable images: every scanned image was misclassified or lacked mask "
              "signal (--skip-degenerate)")
        return 1
    print_table(args, payload)
    common.emit_result(args.out, "method_comparison.json", payload)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
