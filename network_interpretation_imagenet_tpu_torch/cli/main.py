"""ImageNet training on one GPU (port of ``cli/main.py`` of the JAX package):
the ``main.py`` the reference README advertises (``python main.py -a
resnet18 [imagenet-folder with train and val folders]``) but does not ship.

The stock flag set (``-a/-j/--epochs/-b/--lr/--momentum/--weight-decay/-p/
--resume/-e/--pretrained``) with the 0.1 -> /10 every 30 epochs schedule,
over the train step of ``parallel.train_step``, the epoch harness of
``train.harness.Trainer`` (``scores.tsv``, best checkpoint, resume) and the
augmenting loader of ``data.imagenet_train`` (its draws independent of the
worker count)::

    python -m network_interpretation_imagenet_tpu_torch.cli.main -a resnet18 <imagenet-dir>
    python -m network_interpretation_imagenet_tpu_torch.cli.main -a resnet50 --synthetic \\
        --limit-images 2048 -b 256 --epochs 2
    python -m network_interpretation_imagenet_tpu_torch.cli.main -a resnet50 -e \\
        --pretrained weights/resnet50 <imagenet-dir>

``--device {cuda,cpu}`` takes the place of ``--platform`` (the card unless
cpu is asked for); the XLA-only flags (compilation cache, ``--debug-nans``,
``--local-devices``) are not here. Multi-process and tensor-parallel
training (``--multihost``, ``--coordinator``, ``--num-processes``,
``--process-id``, ``--model-parallel`` above 1) wait for ROADMAP.md section
A, item 7: they exit with code 2.
"""

from __future__ import annotations

import argparse
import os
import sys
from functools import partial

from network_interpretation_imagenet_tpu_torch.config import TrainConfig

MULTI_NOT_PORTED = ("error: {flag}: multi-process and tensor-parallel training are not ported "
                    "yet (ROADMAP.md section A, item 7); train on one device")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ImageNet training on one GPU")
    p.add_argument("data", nargs="?", default=None,
                   help="path to dataset (ImageFolder train/ and val/ subdirs)")
    p.add_argument("--arch", "-a", default="resnet18",
                   help="model architecture (any zoo name: resnet*, vgg*, "
                        "alexnet, densenet*, ... default: resnet18)")
    p.add_argument("--workers", "-j", type=int, default=4,
                   help="number of data loading workers (default: 4)")
    p.add_argument("--epochs", type=int, default=90,
                   help="number of total epochs to run")
    p.add_argument("--start-epoch", type=int, default=0,
                   help="manual epoch number (useful on restarts)")
    p.add_argument("--batch-size", "-b", type=int, default=256,
                   help="mini-batch size (default: 256)")
    p.add_argument("--lr", "--learning-rate", type=float, default=0.1,
                   help="initial learning rate (use 0.01 for alexnet/vgg)")
    p.add_argument("--momentum", type=float, default=0.9, help="momentum")
    p.add_argument("--weight-decay", "--wd", type=float, default=1e-4,
                   help="weight decay (default: 1e-4)")
    p.add_argument("--print-freq", "-p", type=int, default=10,
                   help="print frequency (default: 10)")
    p.add_argument("--resume", default="", metavar="PATH",
                   help="path to latest checkpoint dir (default: none)")
    p.add_argument("--evaluate", "-e", action="store_true",
                   help="evaluate model on validation set")
    p.add_argument("--pretrained", default=None, metavar="CKPT",
                   help="initialize from weights: a torch .pth[.tar], or a weights "
                        "artifact from cli.convert_checkpoint")
    # -- beyond the stock surface -------------------------------------------
    p.add_argument("--save", default="./outputs/imagenet_train",
                   help="checkpoint/scores directory")
    p.add_argument("--crop", type=int, default=224)
    p.add_argument("--patience", type=int, default=0,
                   help="early stop after N non-improving epochs (0 = off)")
    p.add_argument("--save-every-steps", type=int, default=0,
                   help="mid-epoch checkpoints every N train steps (0 = per-epoch "
                        "only); --resume re-enters the epoch at the exact batch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit-images", type=int, default=None,
                   help="truncate train/val sets (smoke runs)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on a synthetic separable batch (no dataset)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where training runs (the card unless cpu is asked for)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="devices per tensor-parallel group (only 1: ROADMAP item 7)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process data-parallel training (ROADMAP item 7)")
    p.add_argument("--coordinator", default=None,
                   help="(--multihost) coordinator address host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    for flag, given in (("--multihost", args.multihost),
                        ("--model-parallel", args.model_parallel != 1),
                        ("--coordinator", args.coordinator is not None),
                        ("--num-processes", args.num_processes is not None),
                        ("--process-id", args.process_id is not None)):
        if given:
            print(MULTI_NOT_PORTED.format(flag=flag), file=sys.stderr)
            return 2

    from network_interpretation_imagenet_tpu_torch.data.image_folder import ImageFolderDataset
    from network_interpretation_imagenet_tpu_torch.data.imagenet_train import TrainImageFolder
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.train import Trainer

    # -- data ---------------------------------------------------------------
    if args.synthetic:
        from network_interpretation_imagenet_tpu_torch.data.loaders import ArrayLoader
        from network_interpretation_imagenet_tpu_torch.data.synthetic import (
            synthetic_classification_batch,
        )

        num_classes = 8
        n = args.limit_images or 256
        x, y = synthetic_classification_batch(args.seed, n, args.crop, 3, num_classes)
        train_factory = ArrayLoader(x, y, args.batch_size, shuffle=True, seed=args.seed)
        val_loader = ArrayLoader(x[-max(n // 4, args.batch_size):],
                                 y[-max(n // 4, args.batch_size):], args.batch_size)
        steps_per_epoch = len(train_factory)
    else:
        if not args.data:
            print("error: DIR positional argument (or --synthetic) required", file=sys.stderr)
            return 2
        train_dir = os.path.join(args.data, "train")
        val_dir = os.path.join(args.data, "val")
        if not os.path.isdir(train_dir):
            # A bare folder of classes (no train/val split) serves as both.
            train_dir = val_dir = args.data
        train_set = TrainImageFolder(train_dir, crop=args.crop, seed=args.seed)
        val_set = ImageFolderDataset(val_dir, crop=args.crop)
        num_classes = max(len(train_set.class_to_label), 2)
        train_indices = val_indices = None
        if args.limit_images:
            train_indices = list(range(min(args.limit_images, len(train_set))))
            val_indices = list(range(min(args.limit_images, len(val_set))))
        n_train = len(train_indices or train_set)
        if n_train < args.batch_size and not args.evaluate:
            # drop_last discards the lone partial batch: every "epoch" would
            # run zero steps while reporting loss 0.0.
            print(f"error: train set has {n_train} images (after --limit-images) but "
                  f"--batch-size is {args.batch_size}; lower -b so at least one full "
                  f"batch exists (partial batches are dropped)", file=sys.stderr)
            return 2
        steps_per_epoch = max(1, n_train // args.batch_size)
        train_factory = partial(_train_epoch_loader, train_set, args, train_indices)
        val_loader = _ValLoader(val_set, args, val_indices)

    # -- model + trainer ----------------------------------------------------
    bundle = create_model(args.arch, "imagenet", num_classes=num_classes)
    cfg = TrainConfig(
        optimizer="sgd", lr=args.lr, momentum=args.momentum,
        weight_decay=args.weight_decay, epochs=args.epochs,
        batch_size=args.batch_size, patience=args.patience, seed=args.seed,
        decay_rate=0.1, decay_epochs=(30, 60),  # stock schedule: /10 every 30
        print_freq=args.print_freq,
    )
    save_dir = args.resume or os.path.join(args.save, f"imagenet-{args.arch}")
    t = Trainer(bundle, cfg, steps_per_epoch=steps_per_epoch, save_dir=save_dir,
                arch_args={"arch": args.arch}, save_every_steps=args.save_every_steps,
                device=args.device)

    if args.pretrained:
        _load_pretrained(t, bundle, args)
    if args.resume:
        if t.resume():
            print(f"=> resumed from '{args.resume}' (epoch {t.start_epoch})")
        else:
            print(f"=> no checkpoint found at '{args.resume}'")
    elif args.start_epoch:
        t.start_epoch = args.start_epoch

    if args.evaluate:
        loss, err1, err5 = t.evaluate(val_loader)
        print(f" * Prec@1 {100 - err1:.3f} Prec@5 {100 - err5:.3f}")
        _emit(args, {"mode": "evaluate", "val_loss": loss, "top1": 100 - err1,
                     "top5": 100 - err5})
        return 0

    history = t.fit(train_factory, val_loader)
    if history:
        last = history[-1]
        print(f" * Prec@1 {100 - last['val_err1']:.3f} "
              f"Prec@5 {100 - last['val_err5']:.3f} "
              f"(best err1 {t.best_err1:.3f} @ epoch {t.best_epoch})")
    _emit(args, {"mode": "train", "epochs_run": len(history), "best_err1": t.best_err1,
                 "best_epoch": t.best_epoch, "save_dir": save_dir, "history": history})
    return 0


def _train_epoch_loader(train_set, args, indices, epoch, skip=0):
    from network_interpretation_imagenet_tpu_torch.data.imagenet_train import epoch_batches

    return epoch_batches(train_set, args.batch_size, epoch=epoch, seed=args.seed, shuffle=True,
                         workers=args.workers, drop_last=True, indices=indices, skip=skip)


class _ValLoader:
    """Re-iterable val loader (Trainer.evaluate runs once per epoch)."""

    def __init__(self, val_set, args, indices):
        self.val_set = val_set
        self.args = args
        self.indices = indices

    def __iter__(self):
        from network_interpretation_imagenet_tpu_torch.data.imagenet_train import epoch_batches

        return epoch_batches(self.val_set, self.args.batch_size, epoch=0, seed=0, shuffle=False,
                             workers=self.args.workers, indices=self.indices)


def _load_pretrained(t, bundle, args):
    from network_interpretation_imagenet_tpu_torch.utils import convert

    if convert.is_weights_artifact(args.pretrained):
        variables, meta = convert.load_weights_artifact(args.pretrained)
        if meta.get("arch") and meta["arch"] != args.arch:
            raise ValueError(f"--pretrained artifact is for arch {meta['arch']!r}, "
                             f"--arch is {args.arch!r}")
        state_dict = convert.from_jax(variables, bundle.module)
    else:
        state_dict = convert.convert_checkpoint(args.pretrained, args.arch)
    # Shapes must match the initialized model before the swap: a head trained
    # for another num_classes would otherwise fail opaquely at the first step.
    optional = getattr(bundle.module, "optional_prefixes", ())
    state_dict = {k: v for k, v in state_dict.items() if not k.startswith(optional)}
    _check_tree_shapes(state_dict, t.variables(), args.pretrained)
    t.load_variables(state_dict)
    print(f"=> initialized from pretrained weights '{args.pretrained}'")


def _check_tree_shapes(new, like, source):
    """Raise a clear error if ``new``'s entries or their shapes disagree
    with the initialized model's (``like``; train-only heads the JAX model
    lacks are in neither), BatchNorm's batch counters aside."""
    keys = sorted(k for k in like if not k.endswith("num_batches_tracked"))
    if sorted(k for k in new if not k.endswith("num_batches_tracked")) != keys:
        raise ValueError(f"--pretrained '{source}': its entries do not match the initialized "
                         f"model (different arch variant?)")
    for k in keys:
        if tuple(new[k].shape) != tuple(like[k].shape):
            raise ValueError(
                f"--pretrained '{source}': {k} has shape {tuple(new[k].shape)} but the model "
                f"expects {tuple(like[k].shape)} — wrong num_classes (dataset class count) "
                f"or arch variant?")


def _emit(args, payload):
    from network_interpretation_imagenet_tpu_torch.cli import common

    common.emit_result(args.save, "imagenet_train_result.json", payload)


if __name__ == "__main__":
    raise SystemExit(main())
