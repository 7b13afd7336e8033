"""Masks -> GP pipeline CLI (reference ``gp_superpixel_data_imagenet.py``):
random window masks -> summed superpixel label field -> exact Kronecker grid
GP (``gp.kron``, in place of the reference's KISS-GP) -> posterior mean and
variance heatmaps, in one process.

    python -m network_interpretation_imagenet_tpu_torch.cli.gp_superpixel_data_imagenet \\
        --data tests/fixtures/imagenet_loc [--arch resnet18] [--device cpu] --out outputs

:func:`compute` computes the result and :func:`main` writes it:
``gp_superpixel_result.json`` (the JAX package's payload keys), the mean and
variance PNGs and the panel figure (matplotlib).
"""

from __future__ import annotations

import os

import numpy as np

from network_interpretation_imagenet_tpu_torch.cli import common
from network_interpretation_imagenet_tpu_torch.gp import kron
from network_interpretation_imagenet_tpu_torch.saliency.pipeline import random_window_saliency


def parse_args(argv=None):
    p = common.build_parser(__doc__)
    common.add_gp_flags(p)
    return p.parse_args(argv)


def compute(args):
    """Run masks -> heatmap -> GP; returns ``(payload, result)``: the JSON
    payload, and the display image, heatmap, posterior mean and variance."""
    image, disp, _, _ = common.resolve_image(args)
    engine = common.build_engine(args)
    target, _ = engine.predict_one(image)

    seg = common.segment_display(disp, common.segment_config(args), args.device)
    out = random_window_saliency(engine, image, seg, num_samples=args.num_mask_samples,
                                 window_fraction=args.window_fraction, seed=args.seed,
                                 target=target)
    # GP over the summed superpixel labels of all n² pixels, 20 Adam(0.1) steps.
    heat = out.heatmap.astype(np.float32)
    params, losses = kron.fit_adam(heat, iters=args.gp_iters, lr=args.gp_lr, device=engine.device)
    mean, var = (t.cpu().numpy() for t in kron.posterior(params, heat, device=engine.device))
    losses = losses.cpu().numpy()
    payload = {
        "target": int(target),
        "num_segments": out.num_segments,
        "survived": int(out.eval.survived.sum()),
        "gp_loss_first": round(float(losses[0]), 3),
        "gp_loss_last": round(float(losses[-1]), 3),
        "gp_lengthscale": round(float(np.exp(float(params.log_lengthscale))), 3),
        "mean_range": [round(float(mean.min()), 3), round(float(mean.max()), 3)],
        "var_range": [round(float(var.min()), 5), round(float(var.max()), 5)],
    }
    return payload, {"disp": disp, "heatmap": out.heatmap, "mean": mean, "var": var}


def write_artifacts(args, payload, result) -> None:
    from network_interpretation_imagenet_tpu_torch.saliency.viz import save_panels

    common.write_heatmap_png(os.path.join(args.out, "gp_mean.png"), result["mean"])
    common.write_heatmap_png(os.path.join(args.out, "gp_var.png"), result["var"])
    save_panels(os.path.join(args.out, "gp_superpixel_result.png"),
                [result["disp"], result["heatmap"], result["mean"], result["var"]],
                ["Original image", "Summed label heatmap", "GP posterior mean",
                 "GP posterior variance"])
    common.emit_result(args.out, "gp_superpixel_result.json", payload)


def main(argv=None):
    args = parse_args(argv)
    write_artifacts(args, *compute(args))


if __name__ == "__main__":
    main()
