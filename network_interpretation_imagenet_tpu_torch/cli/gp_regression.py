"""GP-regression saliency surrogate CLI (reference ``gp_regression.py``):
stored masks -> per-pixel summed labels -> the pixel-grid GP (20 Adam(0.1)
steps, ``:179-224``) -> a smooth saliency mean and its confidence over the
full n² grid (``:227-282``). The exact Kronecker solve (``gp.kron``) takes
the place of the reference's KISS-GP.

    python -m network_interpretation_imagenet_tpu_torch.cli.gp_regression \\
        --masks outputs/masks.npz [--gp-mode train+eval] [--device cpu] --out outputs

``--masks`` is a ``masks.npz`` written by ``generate_gp_training_data_imagenet``
of either package, or a reference-style ``./masks`` PNG directory
(``mask_{i}_{0|1}.png``, the label parsed from the file name as at
``gp_regression.py:63-72``). :func:`compute` fits and predicts (it writes
and reads the GP checkpoint, as the train/eval switch needs); :func:`main`
also writes ``gp_regression_result.json`` and the figures.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.cli import common
from network_interpretation_imagenet_tpu_torch.gp import kron
from network_interpretation_imagenet_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)

CKPT_NAME = "gp_reg_checkpoint"


def load_mask_source(masks_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (summed-label heatmap f32 [n, n], coverage bool [n, n]: the pixels
    some mask keeps), from a ``masks.npz`` or a directory of mask PNGs."""
    from network_interpretation_imagenet_tpu_torch.ops import aggregate, masking

    if masks_path.endswith(".npz"):
        with np.load(masks_path) as blob:
            if "heatmap" in blob and "firsts" in blob:
                masks = masking.window_masks(
                    torch.from_numpy(blob["segments"].astype(np.int32)),
                    torch.from_numpy(blob["firsts"].astype(np.int32)), int(blob["width"]))
                labels = torch.from_numpy(blob["labels"])
            else:
                masks = torch.from_numpy(blob["masks"].astype(bool))
                labels = torch.from_numpy(blob["labels"])
        heat = aggregate.summed_label_heatmap(masks, labels).numpy()
        return heat.astype(np.float32), masks.any(dim=0).numpy()
    from PIL import Image

    heat = coverage = None
    for fname in sorted(os.listdir(masks_path)):
        if not fname.endswith(".png"):
            continue
        label = int(fname.split("_")[2].split(".")[0])  # the reference's parse (:66)
        m = np.asarray(Image.open(os.path.join(masks_path, fname)).convert("L")) == 255
        if heat is None:
            heat, coverage = np.zeros(m.shape, np.float32), np.zeros(m.shape, bool)
        heat += m * label
        coverage |= m
    if heat is None:
        raise FileNotFoundError(f"no mask PNGs in {masks_path}")
    return heat, coverage


def parse_args(argv=None):
    p = common.build_parser(__doc__)
    common.add_gp_flags(p)
    p.add_argument("--masks", required=True,
                   help="masks.npz from generate_gp_training_data_imagenet or a ./masks PNG dir")
    return p.parse_args(argv)


def compute(args):
    """Train and/or evaluate as ``--gp-mode`` says; returns ``(payload,
    result)``: the JSON payload, and the heatmap, posterior mean and
    standard deviation (the latter two None without an eval)."""
    heat, coverage = load_mask_source(args.masks)
    payload = {"masks": args.masks, "n": int(heat.shape[0]),
               "covered_pixels": int(coverage.sum())}
    mean = sd = None
    if args.gp_mode in ("train", "train+eval"):
        params, losses = kron.fit_adam(heat, iters=args.gp_iters, lr=args.gp_lr,
                                       device=args.device)
        save_checkpoint({k: v.cpu().numpy() for k, v in params._asdict().items()},
                        args.gp_ckpt, name=CKPT_NAME)
        payload["train_losses"] = [round(float(v), 4) for v in losses.cpu().numpy()]
        payload["lengthscale"] = round(float(np.exp(params.log_lengthscale.item())), 4)
    if args.gp_mode in ("eval", "train+eval"):
        blob = restore_checkpoint(args.gp_ckpt, name=CKPT_NAME)
        if blob is None:
            raise SystemExit(f"no GP checkpoint under {args.gp_ckpt}; run --gp-mode train")
        params = kron.KronGPParams(**{k: torch.from_numpy(np.asarray(blob[k], np.float32))
                                      for k in kron.KronGPParams._fields})
        mean, var = (t.cpu().numpy() for t in kron.posterior(params, heat, device=args.device))
        sd = np.sqrt(var)
        payload["mean_range"] = [round(float(mean.min()), 3), round(float(mean.max()), 3)]
        payload["std_range"] = [round(float(sd.min()), 4), round(float(sd.max()), 4)]
    return payload, {"heatmap": heat, "mean": mean, "sd": sd}


def write_artifacts(args, payload, result) -> None:
    """The mean PNG and the panel figure (after an eval), then the JSON."""
    if result["mean"] is not None:
        from network_interpretation_imagenet_tpu_torch.saliency.viz import save_panels

        common.write_heatmap_png(os.path.join(args.out, "gp_reg_mean.png"), result["mean"])
        save_panels(os.path.join(args.out, "gp_reg_result.png"),
                    [result["heatmap"], result["mean"], result["sd"]],
                    ["Summed label training heatmap", "Predicted mask heatmap",
                     "Posterior std (confidence region)"])
    common.emit_result(args.out, "gp_regression_result.json", payload)


def main(argv=None):
    args = parse_args(argv)
    write_artifacts(args, *compute(args))


if __name__ == "__main__":
    main()
