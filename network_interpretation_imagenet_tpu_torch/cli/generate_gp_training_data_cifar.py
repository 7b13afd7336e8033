"""CIFAR pipeline CLI (port of ``cli/generate_gp_training_data_cifar.py`` of
the JAX package, the reference's ``generate_gp_training_data_cifar.py``):
``--mode train`` runs the training harness (resume with the saved
architecture flags, ``scores.tsv``, early stopping, ``:81-234``; a
synthetic CIFAR-like batch without ``--data``) and saves under
``OUT/saved_checkpoints/DATASET-ARCH-DEPTH``; ``--mode gp-data`` explains
the CIFAR classifier's prediction (default the reference's ResNet-56 on
CIFAR-10+) on one test image with N masks, each knocking out
``--num_masked_superpixels`` random segments (the reference's 5), and their
survive labels.

    python -m network_interpretation_imagenet_tpu_torch.cli.generate_gp_training_data_cifar \\
        --mode train [--data CIFAR_DIR] [-d 110 --death-mode linear] [--resume] --out outputs
    python -m network_interpretation_imagenet_tpu_torch.cli.generate_gp_training_data_cifar \\
        [--data CIFAR_DIR | --synthetic] [--ckpt WEIGHTS] [--device cpu] --out outputs

:func:`compute` computes the gp-data result and :func:`main` writes it:
``cifar_gp_data_result.json`` and ``masks.npz`` (the JAX package's keys),
the heatmap PNG and, with ``--save-pngs``, one PNG per mask.
"""

from __future__ import annotations

import os

from network_interpretation_imagenet_tpu_torch.cli import common
from network_interpretation_imagenet_tpu_torch.cli.generate_gp_training_data_mnist import (
    write_artifacts as _write_artifacts,
)
from network_interpretation_imagenet_tpu_torch.config import TrainConfig
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


def train(args) -> dict:
    """train: runs the harness and writes ``cifar_train_result.json``;
    returns its payload."""
    from network_interpretation_imagenet_tpu_torch.data.loaders import (
        ArrayLoader,
        get_cifar_loaders,
    )
    from network_interpretation_imagenet_tpu_torch.data.synthetic import (
        synthetic_classification_batch,
    )
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.train import Trainer

    if args.data:
        train_loader, val_loader, _ = get_cifar_loaders(args.data, args.dataset,
                                                        args.batch_size, seed=args.seed)
    else:
        print("[warn] no --data: training on synthetic CIFAR-like batch")
        x, y = synthetic_classification_batch(args.seed, 512, 32, 3, 10)
        train_loader = ArrayLoader(x, y, args.batch_size, shuffle=True)
        val_loader = ArrayLoader(x[-128:], y[-128:], args.batch_size)
    save_dir = os.path.join(args.out, "saved_checkpoints",
                            f"{args.dataset}-{args.arch}-{args.depth}")
    if args.resume:
        # The architecture flags come from the checkpoint, before the model
        # is built (reference arch_resume_names, args.py:79-80).
        saved = Trainer.peek_arch_args(save_dir)
        if saved:
            common.apply_arch_resume(args, saved)
    arch_args = {n: getattr(args, n) for n in common.ARCH_RESUME_NAMES}
    bundle = create_model(args.arch, args.dataset, depth=args.depth, death_mode=args.death_mode,
                          death_rate=args.death_rate, growth_rate=args.growth_rate,
                          bn_size=args.bn_size, compression=args.compression)
    cfg = TrainConfig(optimizer=args.optimizer, lr=args.lr, momentum=args.momentum,
                      weight_decay=args.weight_decay, epochs=args.epochs,
                      patience=args.patience, seed=args.seed)
    t = Trainer(bundle, cfg, steps_per_epoch=len(train_loader), save_dir=save_dir,
                arch_args=arch_args, device=args.device)
    if args.resume and t.resume():
        print(f"resumed from epoch {t.start_epoch}")
    history = t.fit(train_loader, val_loader)
    payload = {"mode": "train", "epochs_run": len(history), "best_err1": t.best_err1,
               "best_epoch": t.best_epoch, "save_dir": save_dir}
    common.emit_result(args.out, "cifar_train_result.json", payload)
    return payload


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
    if args.mode == "train":
        train(args)
        return
    write_artifacts(args, *compute(args))


if __name__ == "__main__":
    main()
