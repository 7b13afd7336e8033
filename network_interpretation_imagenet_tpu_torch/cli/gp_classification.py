"""GP-classification saliency surrogate CLI (reference
``gp_classification.py``): a grid-inducing variational GP with a Bernoulli
(probit) likelihood over per-pixel mask labels, 30 Adam(0.1) steps
(``:160-217``), then each pixel's survive probability over the full grid
(``:219-264``).

    python -m network_interpretation_imagenet_tpu_torch.cli.gp_classification \\
        --masks outputs/masks.npz [--binarize median] [--device cpu] --out outputs

As in the JAX package, the summed counts are binarized before they meet the
Bernoulli likelihood (``--binarize median`` by default; ``none`` feeds the
raw counts, as the reference does at ``:81-82,374``), and at most
``--train_subsample`` covered pixels, drawn with ``RandomState(--seed)``,
train the model. :func:`compute` fits (or restores, with ``--gp-mode
eval``) and predicts; :func:`main` also writes
``gp_classification_result.json`` and the figures.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.cli import common
from network_interpretation_imagenet_tpu_torch.cli.gp_regression import load_mask_source
from network_interpretation_imagenet_tpu_torch.gp import variational
from network_interpretation_imagenet_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)

CKPT_NAME = "gp_cls_checkpoint"


def parse_args(argv=None):
    p = common.build_parser(__doc__)
    common.add_gp_flags(p)
    # The reference's classification defaults: grid_size 10, 30 Adam steps (:141, :176).
    p.set_defaults(grid_size=10, gp_iters=30)
    p.add_argument("--masks", required=True)
    p.add_argument("--binarize", default="median", choices=["median", "nonzero", "none"])
    p.add_argument("--train_subsample", type=int, default=4096,
                   help="max training pixels (covered pixels are subsampled)")
    return p.parse_args(argv)


def training_points(heat: np.ndarray, coverage: np.ndarray, binarize: str, subsample: int,
                    seed: int):
    """(x f32[P, 2] pixel coordinates, y f32[P] labels) of at most
    ``subsample`` covered pixels, the JAX package's draw and binarization."""
    n = heat.shape[0]
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    cov_idx = np.where(coverage.ravel())[0]
    if len(cov_idx) > subsample:
        cov_idx = np.random.RandomState(seed).choice(cov_idx, subsample, replace=False)
    x = np.stack([yy.ravel()[cov_idx], xx.ravel()[cov_idx]], -1).astype(np.float32)
    raw = heat.ravel()[cov_idx]
    if binarize == "median":
        return x, (raw > np.median(raw)).astype(np.float32)
    if binarize == "nonzero":
        return x, (raw > 0).astype(np.float32)
    return x, raw.astype(np.float32)


def compute(args):
    """Returns ``(payload, result)``: the JSON payload, and the heatmap and
    the probability map [n, n]."""
    heat, coverage = load_mask_source(args.masks)
    n = heat.shape[0]
    x, y = training_points(heat, coverage, args.binarize, args.train_subsample, args.seed)
    model = variational.init_model(n, grid_size=args.grid_size, lengthscale=n / 8.0,
                                   device=args.device)
    if args.gp_mode == "eval":
        # The reference loads the saved GP state before it predicts (:222-228).
        blob = restore_checkpoint(args.gp_ckpt, name=CKPT_NAME)
        if blob is None:
            raise SystemExit(f"no GP ckpt under {args.gp_ckpt}; run --gp-mode train")
        params = variational.VGPParams(**{
            k: torch.from_numpy(np.asarray(blob[k], np.float32)).to(model.inducing.device)
            for k in variational.VGPParams._fields})
        model = variational.VGPModel(params, model.inducing)
        losses = np.zeros(1)
    else:
        model, losses = variational.fit_adam(model, x, y, iters=args.gp_iters, lr=args.gp_lr)
        save_checkpoint({k: v.cpu().numpy() for k, v in model.params._asdict().items()},
                        args.gp_ckpt, name=CKPT_NAME)
        losses = losses.cpu().numpy()
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    all_x = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float32)
    probs = variational.predict_proba(model, all_x).cpu().numpy().reshape(n, n)
    payload = {
        "masks": args.masks,
        "train_points": int(len(x)),
        "grid_size": args.grid_size,
        "elbo_first": round(-float(losses[0]), 3),
        "elbo_last": round(-float(losses[-1]), 3),
        "prob_range": [round(float(probs.min()), 4), round(float(probs.max()), 4)],
    }
    return payload, {"heatmap": heat, "probs": probs}


def write_artifacts(args, payload, result) -> None:
    from network_interpretation_imagenet_tpu_torch.saliency.viz import save_panels

    common.write_heatmap_png(os.path.join(args.out, "gp_cls_prob.png"), result["probs"])
    save_panels(os.path.join(args.out, "gp_cls_result.png"), [result["heatmap"], result["probs"]],
                ["Summed label training heatmap", "Bernoulli GP p(survive)"])
    common.emit_result(args.out, "gp_classification_result.json", payload)


def main(argv=None):
    args = parse_args(argv)
    write_artifacts(args, *compute(args))


if __name__ == "__main__":
    main()
