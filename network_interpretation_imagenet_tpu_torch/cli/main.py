"""ImageNet training on one GPU or across processes (port of ``cli/main.py``
of the JAX package):
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
``--local-devices``) are not here.

``--multihost`` trains data-parallel across processes, one per device, on
``torch.distributed`` (``--coordinator host:port --num-processes P
--process-id R``, or torchrun's environment): ``--batch-size`` is the
global batch, every rank builds the same shuffled loader and decodes only
its rows of each full global batch (a partial one is dropped), validation
strides the images across ranks and sums the counts, and rank 0 alone
writes the checkpoints, ``scores.tsv`` and the result. ``--dist-backend``
overrides the process group's backend (NCCL on the card, gloo on the CPU):
gloo lets ranks share one card, which NCCL refuses. As in the JAX package,
``--multihost`` takes no ``--model-parallel`` above 1, and without
``--multihost`` the joining flags are ignored and a process is a world of
one, where ``--model-parallel`` falls back to 1: the single-device step::

    python -m network_interpretation_imagenet_tpu_torch.cli.main -a resnet18 --synthetic \
        --multihost --coordinator 127.0.0.1:29500 --num-processes 2 --process-id R
"""

from __future__ import annotations

import argparse
import os
import sys
from functools import partial

from network_interpretation_imagenet_tpu_torch.config import TrainConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ImageNet training on GPUs")
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
                   help="devices per tensor-parallel group (rest go to data "
                        "parallelism over the batch; a world of one process falls back to 1)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process data-parallel training: join the process group, "
                        "each rank decodes only its slice of the GLOBAL batch, rank 0 "
                        "owns checkpoints/scores")
    p.add_argument("--coordinator", default=None,
                   help="(--multihost) coordinator address host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="the process group's backend (default: nccl with --device cuda, "
                        "gloo with --device cpu); gloo lets ranks share one card")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from network_interpretation_imagenet_tpu_torch.data.image_folder import ImageFolderDataset
    from network_interpretation_imagenet_tpu_torch.data.imagenet_train import TrainImageFolder
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.parallel import make_mesh, multihost
    from network_interpretation_imagenet_tpu_torch.train import Trainer

    rank, world, mesh = 0, 1, None
    if args.multihost:
        if args.model_parallel > 1:
            # The JAX CLI's refusal, kept: its checkpoints read the local replica.
            # The port's gather the shards, and the API (Trainer(mesh=make_mesh(
            # model_parallel=N))) trains the model axis across processes.
            print("error: --multihost supports data parallelism only (--model-parallel "
                  "must be 1, as in the JAX package; shard the model axis through "
                  "Trainer(mesh=make_mesh(model_parallel=N)))", file=sys.stderr)
            return 2
        if not multihost.initialize_distributed(args.coordinator, args.num_processes,
                                                args.process_id, backend=args.dist_backend,
                                                device=args.device):
            # Two processes each silently running as "rank 0" would race on the
            # shared checkpoint directory and not be distributed at all.
            print("error: --multihost could not initialize torch.distributed — pass "
                  "--coordinator/--num-processes/--process-id or set MASTER_ADDR, "
                  "MASTER_PORT, WORLD_SIZE and RANK (refusing to degrade to a silent "
                  "single-process run)", file=sys.stderr)
            return 2
        rank, world = multihost.process_index(), multihost.process_count()
        if args.batch_size % world:
            print(f"error: --batch-size {args.batch_size} (GLOBAL) must divide evenly "
                  f"across {world} processes", file=sys.stderr)
            return 2
        mesh = make_mesh(device=args.device)
    # Without --multihost no process group is built: a world of one process,
    # whose mesh (model_parallel falling back to 1) is the single-device step.

    # -- data ---------------------------------------------------------------
    if args.synthetic:
        from network_interpretation_imagenet_tpu_torch.data.loaders import ArrayLoader
        from network_interpretation_imagenet_tpu_torch.data.synthetic import (
            synthetic_classification_batch,
        )

        num_classes = 8
        n = args.limit_images or 256
        x, y = synthetic_classification_batch(args.seed, n, args.crop, 3, num_classes)
        # Across processes the partial global batch is dropped (_RankSlice), so
        # the loader's length, steps_per_epoch, counts only full batches: the
        # mid-epoch save's suppression on the last batch relies on it.
        train_factory = ArrayLoader(x, y, args.batch_size, shuffle=True, seed=args.seed,
                                    drop_last=world > 1)
        val_loader = ArrayLoader(x[-max(n // 4, args.batch_size):],
                                 y[-max(n // 4, args.batch_size):], args.batch_size)
        steps_per_epoch = len(train_factory)
        if world > 1:
            # Every rank builds the same loader (same seed, same shuffles) and
            # feeds its contiguous rows of each full global batch; validation
            # strides every batch's items instead, the counts summed across
            # ranks (Trainer's eval_local_metrics).
            train_factory = _RankSlice(train_factory, rank, world, args.batch_size)
            val_loader = _RankStride(val_loader, rank, world)
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
        process_slice = (rank, world) if world > 1 else None
        train_factory = partial(_train_epoch_loader, train_set, args, train_indices,
                                process_slice)
        if world > 1:
            # Validation covers every image: rank-strided indices (no global
            # batch to fill, no dropped tail), counts summed across ranks.
            vi = list(val_indices if val_indices is not None else range(len(val_set)))
            val_indices = vi[rank::world]
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
    # Across processes the loaders give each rank its rows already.
    globalize = (lambda images, labels: (images, labels)) if world > 1 else None
    t = Trainer(bundle, cfg, steps_per_epoch=steps_per_epoch, mesh=mesh, save_dir=save_dir,
                arch_args={"arch": args.arch}, globalize=globalize,
                eval_local_metrics=world > 1, save_every_steps=args.save_every_steps,
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


def _train_epoch_loader(train_set, args, indices, process_slice, epoch, skip=0):
    from network_interpretation_imagenet_tpu_torch.data.imagenet_train import epoch_batches

    return epoch_batches(train_set, args.batch_size, epoch=epoch, seed=args.seed, shuffle=True,
                         workers=args.workers, drop_last=True, indices=indices,
                         process_slice=process_slice, skip=skip)


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


class _RankSlice:
    """This rank's contiguous rows of every FULL global batch (the
    synthetic train path: every rank generates the same global batches, and
    the ranks' rows concatenate in rank order to the single-process batch).
    A partial global batch is dropped: data-parallel training across
    processes implies drop_last on the global batch."""

    def __init__(self, inner, rank, world, global_batch):
        self.inner = inner
        self.rank, self.world = rank, world
        self.global_batch = int(global_batch)

    def __len__(self):
        return len(self.inner)

    def _slices(self, it):
        local = self.global_batch // self.world
        for images, labels in it:
            if len(labels) != self.global_batch:
                continue   # a partial tail: dropped
            lo = self.rank * local
            yield images[lo:lo + local], labels[lo:lo + local]

    def __call__(self, epoch):
        if callable(self.inner):
            inner = self.inner(epoch)
        else:
            if hasattr(self.inner, "set_epoch"):
                # The stateful loader's shuffle stays a function of (seed,
                # epoch): a mid-epoch resume replays the same stream.
                self.inner.set_epoch(epoch)
            inner = iter(self.inner)
        gen = self._slices(inner)
        if hasattr(self.inner, "__len__"):
            # A sized epoch lets the Trainer suppress a mid-epoch save on the
            # last (full) batch: the inner loader drops its last partial batch,
            # so its length is the full-batch count.
            return _SizedIter(gen, len(self.inner))
        return gen

    def __iter__(self):
        return self._slices(iter(self.inner))


class _SizedIter:
    """A one-epoch generator with a known batch count."""

    def __init__(self, gen, n):
        self._gen, self._n = gen, n

    def __iter__(self):
        return iter(self._gen)

    def __len__(self):
        return self._n


class _RankStride:
    """Items ``rank::world`` of every batch (the synthetic val path): the
    ranks' items are disjoint and together cover every item, with no
    divisibility to meet and no tail dropped. Pairs with
    ``Trainer(eval_local_metrics=True)``, which sums the counts across ranks."""

    def __init__(self, inner, rank, world):
        self.inner, self.rank, self.world = inner, rank, world

    def __iter__(self):
        for images, labels in iter(self.inner):
            yield images[self.rank::self.world], labels[self.rank::self.world]


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
    t.load_variables(state_dict)   # each rank takes its shards
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
    from network_interpretation_imagenet_tpu_torch.parallel import multihost

    if multihost.process_index() != 0:
        return   # rank 0 owns the result file on the shared filesystem
    common.emit_result(args.save, "imagenet_train_result.json", payload)


if __name__ == "__main__":
    raise SystemExit(main())
