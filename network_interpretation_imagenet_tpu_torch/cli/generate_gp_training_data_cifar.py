"""CIFAR pipeline CLI (port of ``cli/generate_gp_training_data_cifar.py`` of
the JAX package, the reference's ``generate_gp_training_data_cifar.py``):
``--mode gp-data`` explains the CIFAR classifier's prediction (default the
reference's ResNet-56 on CIFAR-10+) on one test image with N masks, each
knocking out ``--num_masked_superpixels`` random segments (the reference's
5), and their survive labels.

    python -m network_interpretation_imagenet_tpu_torch.cli.generate_gp_training_data_cifar \\
        [--data CIFAR_DIR | --synthetic] [--ckpt WEIGHTS] [--device cpu] --out outputs

:func:`compute` computes the result and :func:`main` writes it:
``cifar_gp_data_result.json`` and ``masks.npz`` (the JAX package's keys),
the heatmap PNG and, with ``--save-pngs``, one PNG per mask. ``--mode
train`` (the reference's training harness) is not ported yet (ROADMAP.md
section A, item 6): it exits with an error.
"""

from __future__ import annotations

import os
import sys

from network_interpretation_imagenet_tpu_torch.cli import common
from network_interpretation_imagenet_tpu_torch.cli.generate_gp_training_data_mnist import (
    TRAIN_NOT_PORTED,
)
from network_interpretation_imagenet_tpu_torch.cli.generate_gp_training_data_mnist import (
    write_artifacts as _write_artifacts,
)
from network_interpretation_imagenet_tpu_torch.saliency.pipeline import knockout_saliency


def parse_args(argv=None):
    p = common.build_parser(__doc__, dataset_default="cifar10+")
    p.add_argument("--mode", default="gp-data", choices=["train", "gp-data"])
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "rmsprop", "adam"])
    p.add_argument("--patience", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--resume", action="store_true")
    p.set_defaults(arch="resnet", num_mask_samples=1000, num_masked_superpixels=5)
    return p.parse_args(argv)


def compute(args):
    """gp-data: returns ``(payload, result)``, the JSON payload and the
    arrays the writers need (segments, saliency output, target)."""
    image, disp, _label, _ = common.resolve_image(args)
    engine = common.build_engine(args)
    target, _ = engine.predict_one(image)  # the label where the prediction is right
    seg = common.segment_display(disp, common.segment_config(args), args.device)
    out = knockout_saliency(engine, image, seg, num_samples=args.num_mask_samples,
                            num_knockout=args.num_masked_superpixels, seed=args.seed,
                            target=target)
    payload = {
        "mode": "gp-data",
        "target": int(target),
        "num_segments": out.num_segments,
        "correct_pred_count": int(out.eval.survived.sum()),
        "masks_npz": os.path.join(args.out, "masks.npz"),
    }
    return payload, {"segments": seg, "out": out, "target": target}


def write_artifacts(args, payload, result) -> None:
    _write_artifacts(args, payload, result, extra_npz=(), name="cifar_gp_data_result.json")


def main(argv=None):
    args = parse_args(argv)
    if args.mode != "gp-data":
        sys.exit(TRAIN_NOT_PORTED.format(mode=args.mode))
    write_artifacts(args, *compute(args))


if __name__ == "__main__":
    main()
