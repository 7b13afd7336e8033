"""MNIST pipeline CLI (port of ``cli/generate_gp_training_data_mnist.py`` of
the JAX package, the reference's ``generate_gp_training_data_mnist.py``):
``--mode gp-data`` explains the MNIST CNN's prediction on one test image with
N single-superpixel knockout masks and their survive labels, every masked
forward batched on the engine.

    python -m network_interpretation_imagenet_tpu_torch.cli.generate_gp_training_data_mnist \\
        [--data MNIST_IDX_DIR | --synthetic] [--ckpt WEIGHTS] [--device cpu] --out outputs

:func:`compute` computes the result and :func:`main` writes it:
``mnist_gp_data_result.json`` and ``masks.npz`` (the JAX package's keys),
the heatmap PNG and, with ``--save-pngs``, one PNG per mask. ``--mode
train-nn`` (the reference's 4-epoch SGD training) is not ported yet
(ROADMAP.md section A, item 6): it exits with an error.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from network_interpretation_imagenet_tpu_torch.cli import common
from network_interpretation_imagenet_tpu_torch.saliency.pipeline import knockout_saliency

TRAIN_NOT_PORTED = ("--mode {mode}: training is not ported yet (ROADMAP.md section A, item 6); "
                    "train with the JAX package and pass its weights artifact as --ckpt")


def parse_args(argv=None):
    p = common.build_parser(__doc__, dataset_default="mnist")
    p.add_argument("--mode", default="gp-data", choices=["train-nn", "gp-data"])
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.5)
    p.add_argument("--batch-size", type=int, default=64)
    p.set_defaults(arch="mnist_cnn", num_mask_samples=1000)
    return p.parse_args(argv)


def compute(args):
    """gp-data: returns ``(payload, result)``, the JSON payload and the
    arrays the writers need (segments, saliency output, target)."""
    image, disp, _label, _ = common.resolve_image(args)
    engine = common.build_engine(args)
    target, _ = engine.predict_one(image)  # the label where the prediction is right
    seg = common.segment_display(disp, common.segment_config(args), args.device)
    print(f"number of segments: {seg.max() + 1}")
    out = knockout_saliency(engine, image, seg, num_samples=args.num_mask_samples,
                            num_knockout=args.num_masked_superpixels, seed=args.seed,
                            target=target)
    payload = {
        "mode": "gp-data",
        "target": int(target),
        "num_segments": out.num_segments,
        "num_mask_samples": args.num_mask_samples,
        "correct_pred_count": int(out.eval.survived.sum()),
        "wrong_pred_count": int((~out.eval.survived).sum()),
        "masks_npz": os.path.join(args.out, "masks.npz"),
    }
    return payload, {"segments": seg, "out": out, "target": target}


def write_artifacts(args, payload, result, extra_npz=("prob_max",),
                    name="mnist_gp_data_result.json") -> None:
    """The heatmap PNG, ``masks.npz`` (plus the ``extra_npz`` outcome
    arrays), the mask PNGs, then the JSON payload."""
    out, seg = result["out"], result["segments"]
    common.write_heatmap_png(os.path.join(args.out, "heatmap.png"), out.heatmap)
    extra = {k: getattr(out.eval, k) for k in extra_npz}
    common.save_mask_npz(os.path.join(args.out, "masks.npz"), segments=seg, masks=out.masks,
                         knock_ids=out.knock_ids, labels=out.eval.labels, **extra,
                         heatmap=out.heatmap, target=np.asarray(result["target"]))
    if args.save_pngs:
        common.save_mask_pngs(os.path.join(args.out, "masks"), out.masks, out.eval.labels)
    common.emit_result(args.out, name, payload)


def main(argv=None):
    args = parse_args(argv)
    if args.mode != "gp-data":
        sys.exit(TRAIN_NOT_PORTED.format(mode=args.mode))
    write_artifacts(args, *compute(args))


if __name__ == "__main__":
    main()
