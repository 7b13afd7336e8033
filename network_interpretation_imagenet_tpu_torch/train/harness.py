"""Classifier training harness (port of ``train/harness.py`` of the JAX
package), on one device or on a mesh of ranks.

The reference's CIFAR harness (``generate_gp_training_data_cifar.py:81-234``)
and optimizer flags (``args.py:83-117``): sgd / rmsprop / adam with momentum
and weight decay, the stepped lr schedule, ``scores.tsv`` rewritten each
epoch, early stopping on the val error with ``patience``, a best-checkpoint
copy and resume, mid-epoch included. The step is
``parallel.train_step``'s, with or without a mesh.

The optimizers are optax's, written out (``torch.optim``'s differ): the
weight decay is added to the gradient *before* the optimizer core
(``optax.add_decayed_weights``, coupled L2); SGD keeps a trace
``g + momentum * trace``; RMSprop (decay 0.9) scales by
``rsqrt(nu + eps)``, eps inside the root, and applies the learning rate
before its momentum trace; Adam's bias corrections are f32. The learning
rate of 0-based step k is ``schedule(k)``, the count read before it
increments, and ``piecewise_constant_schedule`` scales from the step equal
to a boundary on, in f32.

Checkpoints go through ``utils.checkpoint``: parameters and BatchNorm
statistics in the JAX package's layout (``params`` / ``batch_stats``, which
``--ckpt`` reads), the optimizer's count and slots under torch names, the
generator's state, and the position.
"""

from __future__ import annotations

import inspect
import itertools
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from network_interpretation_imagenet_tpu_torch.config import TrainConfig
from network_interpretation_imagenet_tpu_torch.device import resolve_device
from network_interpretation_imagenet_tpu_torch.models import ModelBundle
from network_interpretation_imagenet_tpu_torch.parallel import multihost
from network_interpretation_imagenet_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    axis_size,
    shard_batch,
)
from network_interpretation_imagenet_tpu_torch.parallel.train_step import (
    gather_full,
    make_sharded_train_step,
    param_shardings,
    take_shards,
)
from network_interpretation_imagenet_tpu_torch.utils import convert
from network_interpretation_imagenet_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from network_interpretation_imagenet_tpu_torch.utils.logging import PhaseLogger
from network_interpretation_imagenet_tpu_torch.utils.meters import AverageMeter

# Each optimizer's slots, in the order optax's state holds them.
SLOTS = {"sgd": ("trace",), "adam": ("mu", "nu"), "rmsprop": ("nu", "trace")}
ADAM_B1, ADAM_B2, EPS = 0.9, 0.999, 1e-8
RMS_DECAY = 0.9


def lr_schedule(cfg: TrainConfig, steps_per_epoch: int):
    """``optax.piecewise_constant_schedule(cfg.lr, {e * steps_per_epoch:
    cfg.decay_rate})``: count -> the f32 learning rate, scaled once for each
    boundary the count has reached (the classic ``adjust_learning_rate``,
    ``generate_gp_training_data_imagenet.py:299-303``)."""
    boundaries = sorted({int(e) * steps_per_epoch: cfg.decay_rate
                         for e in cfg.decay_epochs}.items())

    def schedule(count: int) -> float:
        v = np.float32(cfg.lr)
        for threshold, scale in boundaries:
            if count >= threshold:
                v = np.float32(np.float32(scale) * v)
        return float(v)

    return schedule


class Optimizer:
    """``optax.chain(add_decayed_weights(weight_decay), core)`` with core
    ``sgd(schedule, momentum)``, ``rmsprop(schedule, momentum=momentum)`` or
    ``adam(schedule)``, updating parameters in place (``torch._foreach``
    ops: one launch per operation for all tensors on the card).

    The state is ``{"count": int, slot: {name: tensor}}`` with the slots of
    :data:`SLOTS`, zeros at init as optax's."""

    def __init__(self, kind: str, schedule, momentum: float, weight_decay: float) -> None:
        if kind not in SLOTS:
            raise ValueError(f"unknown optimizer {kind}")
        self.kind, self.schedule = kind, schedule
        self.momentum, self.weight_decay = float(momentum), float(weight_decay)

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        state: Dict[str, Any] = {"count": 0}
        for slot in SLOTS[self.kind]:
            state[slot] = {n: torch.zeros_like(p, requires_grad=False) for n, p in params.items()}
        return state

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
               params: Sequence[torch.Tensor]) -> None:
        """One step: ``params`` and ``state`` in place; ``grads`` in the
        order of ``params`` (the order of ``state``'s slots)."""
        params = list(params)
        lr = self.schedule(state["count"])
        g = (torch._foreach_add(grads, params, alpha=self.weight_decay) if self.weight_decay
             else list(grads))
        if self.kind == "sgd":
            trace = list(state["trace"].values())
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, g)                      # g + m * trace
            torch._foreach_add_(params, trace, alpha=-lr)
        elif self.kind == "adam":
            mu, nu = list(state["mu"].values()), list(state["nu"].values())
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, g, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - ADAM_B2)
            k = np.float32(state["count"] + 1)
            bc1 = float(np.float32(1) - np.power(np.float32(ADAM_B1), k, dtype=np.float32))
            bc2 = float(np.float32(1) - np.power(np.float32(ADAM_B2), k, dtype=np.float32))
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, EPS)
            u = torch._foreach_div(mu, bc1)
            torch._foreach_div_(u, den)
            torch._foreach_add_(params, u, alpha=-lr)
        else:  # rmsprop: lr applied before the momentum trace
            nu, trace = list(state["nu"].values()), list(state["trace"].values())
            torch._foreach_mul_(nu, RMS_DECAY)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - RMS_DECAY)
            u = torch._foreach_add(nu, EPS)
            torch._foreach_rsqrt_(u)
            torch._foreach_mul_(u, g)
            torch._foreach_mul_(u, -lr)
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, u)
            torch._foreach_add_(params, trace)
        state["count"] += 1


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int) -> Optimizer:
    """sgd | rmsprop | adam with torch-style (coupled) weight decay and the
    reference's stepped lr schedule (``decay_rate`` at ``decay_epochs``)."""
    return Optimizer(cfg.optimizer, lr_schedule(cfg, steps_per_epoch), cfg.momentum,
                     cfg.weight_decay)


def opt_state_from_jax(optimizer: Optimizer, count: int, slots: Dict[str, Any],
                       module: torch.nn.Module, like: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """An optax state of the JAX harness's optimizer as the port's: ``slots``
    maps each slot of :data:`SLOTS` (SGD's and RMSprop's ``trace``, Adam's
    ``mu`` and ``nu``, RMSprop's ``nu``) to its params-shaped tree in the JAX
    layout, ``count`` is the schedule's count; ``like`` (the train state's
    parameters) gives each tensor's device and memory format."""
    state: Dict[str, Any] = {"count": int(count)}
    for slot in SLOTS[optimizer.kind]:
        sd = convert.from_jax({"params": slots[slot]}, module)
        state[slot] = {n: p.detach().clone().copy_(sd[n]) for n, p in like.items()}
    return state


def _factory_accepts_skip(factory) -> bool:
    """True when an epoch -> loader factory takes a ``skip`` keyword (batches
    to drop before decode: mid-epoch resume without decoding them). An
    explicit named parameter only: a bare ``**kwargs`` might swallow it."""
    try:
        return "skip" in inspect.signature(factory).parameters
    except (TypeError, ValueError):
        return False


class Trainer:
    """Epoch-loop harness over numpy loaders (see ``data.loaders``), on
    ``device`` (the card unless ``"cpu"`` is asked for).

    ``save_every_steps > 0`` saves the full state every N train steps with
    its position ``mid_epoch_step``; ``resume()`` re-enters that epoch and
    ``fit`` skips the batches already trained. The loaders' per-(seed,
    epoch) order and per-(seed, epoch, index) augmentation, and the
    generator's state in the checkpoint, make a resumed run's updates those
    of an uninterrupted one.

    ``mesh`` (``parallel.make_mesh``) trains with the sharded step; every
    rank runs the same loop. The mesh's dimension names, (data, model) in
    ``make_mesh``'s order, name the axes of the step, the shardings, the
    batch slices and the sums. ``globalize(images, labels)`` maps one host
    batch to this rank's rows of the global batch: by default its slice of
    a batch every rank holds whole (``shard_batch`` over the data axis); a
    multi-process caller whose loaders already give each rank its rows
    (``cli.main --multihost``) passes the identity. The meters count the
    global batch. ``eval_local_metrics`` evaluates each rank's own val
    batches with local tensors, and the sums ``[loss * n, correct,
    correct5, n]`` cross the processes once per ``evaluate()``, in f64;
    without it, with a mesh, each rank evaluates its ``globalize`` rows and
    the sums cross the data axis once. Rank 0 alone writes ``scores.tsv`` and the
    checkpoints, which hold whole tensors (the model axis's shards
    gathered); every rank enters ``save`` and meets the others at a barrier
    after it, and ``resume`` gives each rank its shards."""

    def __init__(self, bundle: ModelBundle, cfg: TrainConfig, steps_per_epoch: int, mesh=None,
                 save_dir: Optional[str] = None, logger: Optional[PhaseLogger] = None,
                 arch_args: Optional[dict] = None, globalize=None,
                 eval_local_metrics: bool = False, save_every_steps: int = 0,
                 device=None) -> None:
        self.bundle = bundle
        self.cfg = cfg
        self.device = resolve_device(device)
        # Architecture flags saved with the checkpoint, so that resume can
        # rebuild the model (reference args.py:79-80 arch_resume_names).
        self.arch_args = dict(arch_args) if arch_args else None
        self.save_dir = save_dir
        self.log = logger or PhaseLogger(enabled=False)
        self.print_freq = cfg.print_freq
        self.steps_per_epoch = int(steps_per_epoch)
        self.optimizer = make_optimizer(cfg, self.steps_per_epoch)
        self.mesh = mesh
        self.eval_local_metrics = bool(eval_local_metrics)
        self.data_axis, self.model_axis = (("data", "model") if mesh is None
                                           else mesh.mesh_dim_names)
        self.data_size = 1 if mesh is None else axis_size(mesh, self.data_axis)
        self.shardings = {} if mesh is None else param_shardings(
            dict(bundle.module.named_parameters()), mesh, self.model_axis)
        # Rank 0 writes the files of a mesh's run; every rank meets at a barrier after.
        self.writer = mesh is None or multihost.process_index() == 0
        if globalize is None and mesh is not None:
            def globalize(images, labels):
                return (shard_batch(mesh, images, self.data_axis),
                        shard_batch(mesh, labels, self.data_axis))
        self.globalize = globalize or (lambda images, labels: (images, labels))
        self.init_fn, self.step_fn = make_sharded_train_step(
            bundle, mesh, self.optimizer, self.data_axis, self.model_axis, device=self.device)
        self.state = self.init_fn(cfg.seed)
        self.start_epoch = 0
        self.best_err1 = float("inf")
        self.best_epoch = -1
        self.save_every_steps = int(save_every_steps)
        self.resume_skip_steps = 0  # set by resume() from a mid-epoch checkpoint

    def _whole(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole tensors of this rank's shards (collective along the model
        axis where a parameter is sharded)."""
        return gather_full(self.mesh, {n: t.detach() for n, t in tensors.items()},
                           self.shardings, self.model_axis)

    def variables(self) -> Dict[str, torch.Tensor]:
        """The model's ``state_dict`` entries (parameters and BatchNorm
        statistics) as they stand, on the device, whole (with parameters
        sharded over the model axis, every rank of it must call this)."""
        return {**self._whole(self.state.params),
                **{n: t.detach() for n, t in self.state.buffers.items()}}

    def load_variables(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Overwrite the parameters and statistics in place with whole
        tensors, each rank taking its shards (device and memory format
        kept); the optimizer state stays."""
        mine = take_shards(self.mesh, {n: torch.as_tensor(state_dict[n])
                                       for n in self.state.params if n in state_dict},
                           self.shardings, self.model_axis)
        with torch.no_grad():
            for n, t in {**self.state.params, **self.state.buffers}.items():
                if n in state_dict:
                    t.copy_(mine.get(n, state_dict[n]))

    # -- persistence --------------------------------------------------------

    def save(self, epoch: int, is_best: bool, mid_epoch_step: int = 0) -> None:
        """``mid_epoch_step > 0`` marks an epoch in progress: resume()
        re-enters ``epoch`` skipping that many batches (an epoch-end save
        stores 0, and resume starts at ``epoch + 1``). With a mesh every
        rank enters it: the shards are gathered, rank 0 writes, and the ranks
        meet at a barrier."""
        if not self.save_dir:
            return
        variables = convert.jax_variables(self.variables(), self.bundle.module)
        opt = {"count": np.asarray(self.state.opt_state["count"], np.int64)}
        for slot in SLOTS[self.optimizer.kind]:
            opt[slot] = self._whole(self.state.opt_state[slot])
        blob = {
            "params": variables["params"],
            "batch_stats": variables.get("batch_stats", {}),
            "opt": opt,
            "rng": self.state.generator.get_state().numpy(),
            "step": np.asarray(self.state.step),
            "epoch": np.asarray(epoch),
            "mid_epoch_step": np.asarray(int(mid_epoch_step)),
            "best_err1": np.asarray(self.best_err1),
            "best_epoch": np.asarray(self.best_epoch),
            "arch": self.bundle.name,
        }
        if self.arch_args:
            blob["arch_args"] = dict(self.arch_args)
        if self.writer:
            save_checkpoint(blob, self.save_dir, is_best=is_best)
        if self.mesh is not None:
            # utils.checkpoint has no barrier of its own (Orbax's had): no rank
            # may go on, or resume, before rank 0's files are whole.
            multihost.barrier()

    @staticmethod
    def peek_arch_args(save_dir: str) -> Optional[dict]:
        """A checkpoint's saved architecture flags, read without building a
        model: callers restore them into their CLI args before
        ``create_model`` (the reference's ``arch_resume_names`` flow,
        ``generate_gp_training_data_cifar.py:97-123``)."""
        blob = restore_checkpoint(save_dir)
        if blob is None or "arch_args" not in blob:
            return None
        return {k: (v.item() if hasattr(v, "item") else v) for k, v in blob["arch_args"].items()}

    def resume(self) -> bool:
        """Restore the state and position from ``save_dir`` (the reference's
        resume, ``generate_gp_training_data_cifar.py:97-123``)."""
        if not self.save_dir:
            return False
        blob = restore_checkpoint(self.save_dir)
        if blob is None:
            return False
        self.load_variables(convert.from_jax(
            {"params": blob["params"], "batch_stats": blob.get("batch_stats") or {}},
            self.bundle.module))
        opt = self.state.opt_state
        with torch.no_grad():
            for slot in SLOTS[self.optimizer.kind]:
                saved = take_shards(self.mesh, {n: torch.from_numpy(np.asarray(
                    blob["opt"][slot][n])) for n in opt[slot]}, self.shardings,
                    self.model_axis)
                for n, t in opt[slot].items():
                    t.copy_(saved[n])
        opt["count"] = int(blob["opt"]["count"])
        self.state.generator.set_state(torch.from_numpy(np.asarray(blob["rng"], np.uint8)))
        self.state = self.state._replace(step=int(blob.get("step", 0)))
        mid = int(blob.get("mid_epoch_step", 0))
        if mid > 0:
            # Mid-epoch checkpoint: re-enter the same epoch and skip the
            # batches already trained (fit() consumes resume_skip_steps).
            self.start_epoch = int(blob["epoch"])
            self.resume_skip_steps = mid
        else:
            self.start_epoch = int(blob["epoch"]) + 1
            self.resume_skip_steps = 0
        self.best_err1 = float(blob["best_err1"])
        self.best_epoch = int(blob["best_epoch"])
        return True

    # -- loops --------------------------------------------------------------

    def train_epoch(self, loader, epoch: int = 0, print_freq: int = 0,
                    step_offset: int = 0) -> Tuple[float, float]:
        """One pass over ``loader``; returns (mean loss, top-1 error %).
        ``print_freq > 0`` prints the stock ImageNet trainer's per-batch line
        (Time / Data / Loss / Prec@1 / Prec@5, ``generate_gp_training_data_
        imagenet.py:281-296``). The step's metrics come to the host in one
        copy per step, the JAX harness's one ``device_get``. With a mesh the
        loader's batches go through ``globalize`` and the meters count the
        global batch."""
        loss_m, top1_m, top5_m = AverageMeter(), AverageMeter(), AverageMeter()
        batch_t, data_t = AverageMeter(), AverageMeter()
        steps = len(loader) if hasattr(loader, "__len__") else None
        end = time.time()
        for i, (images, labels) in enumerate(loader):
            data_t.update(time.time() - end)
            images, labels = self.globalize(images, labels)
            self.state, metrics = self.step_fn(self.state, images, labels)
            n = int(len(labels)) * self.data_size   # the global batch
            loss, top1, top5 = torch.stack([metrics["loss"], metrics["top1"],
                                            metrics["top5"]]).tolist()
            loss_m.update(loss, n)
            top1_m.update(top1, n)
            top5_m.update(top5, n)
            batch_t.update(time.time() - end)
            end = time.time()
            if self.save_every_steps:
                pos = step_offset + i + 1  # the position within the whole epoch
                # No save ON the epoch's last batch: the epoch-end save follows,
                # and a resume from mid == steps would enter an empty epoch. A
                # loader without a length falls back to steps_per_epoch, which
                # must then be its true batch count (fit() catches an overstated one).
                last = step_offset + steps if steps is not None else (
                    self.steps_per_epoch or None)
                if pos % self.save_every_steps == 0 and (last is None or pos < last):
                    self.save(epoch, is_best=False, mid_epoch_step=pos)
            if print_freq and i % print_freq == 0:
                total = f"/{steps}" if steps is not None else ""
                print(
                    f"Epoch: [{epoch}][{i}{total}]\t"
                    f"Time {batch_t.val:.3f} ({batch_t.avg:.3f})\t"
                    f"Data {data_t.val:.3f} ({data_t.avg:.3f})\t"
                    f"Loss {loss_m.val:.4f} ({loss_m.avg:.4f})\t"
                    f"Prec@1 {100 * top1_m.val:.3f} ({100 * top1_m.avg:.3f})\t"
                    f"Prec@5 {100 * top5_m.val:.3f} ({100 * top5_m.avg:.3f})"
                )
        self._last_epoch_batches = loss_m.count  # fit()'s zero-batch guard
        return loss_m.avg, 100.0 * (1.0 - top1_m.avg)

    @torch.no_grad()
    def evaluate(self, loader) -> Tuple[float, float, float]:
        """(mean loss, top-1 error %, top-5 error %) of the eval-mode model;
        with a mesh, of every rank's batches (one collective)."""
        loss_sum, correct, correct5, total = 0.0, 0, 0, 0
        variables = self.variables()
        for images, labels in loader:
            if self.eval_local_metrics:
                if len(labels) == 0:
                    continue
            elif self.mesh is not None:
                images, labels = self.globalize(images, labels)
            x = torch.as_tensor(np.ascontiguousarray(images)).to(self.device, torch.float32)
            y = torch.as_tensor(np.asarray(labels)).to(self.device, torch.int64)
            logits = self.bundle.logits(variables, x).float()
            k = min(5, logits.shape[-1])
            loss, top1, top5 = torch.stack([
                F.cross_entropy(logits, y),
                (logits.argmax(-1) == y).sum().float(),
                (logits.topk(k, dim=-1).indices == y[:, None]).any(-1).sum().float(),
            ]).tolist()
            n = int(y.shape[0])
            loss_sum += loss * n
            correct += int(top1)
            correct5 += int(top5)
            total += n
        if self.mesh is not None:
            # ONE collective: over every process (each evaluated its own
            # batches), else over the data axis (each its globalize rows).
            sums = all_reduce_sum(self.mesh, torch.tensor(
                [loss_sum, correct, correct5, total], dtype=torch.float64),
                None if self.eval_local_metrics else self.data_axis).tolist()
            loss_sum, correct, correct5, total = sums[0], int(sums[1]), int(sums[2]), int(sums[3])
        err1 = 100.0 * (1.0 - correct / max(total, 1))
        err5 = 100.0 * (1.0 - correct5 / max(total, 1))
        return loss_sum / max(total, 1), err1, err5

    def fit(self, train_loader, val_loader, epochs: Optional[int] = None) -> List[Dict]:
        """The epoch loop; returns the per-epoch rows, also written to
        ``scores.tsv`` (rewritten each epoch, as the reference's
        ``generate_gp_training_data_cifar.py:181,208-212``)."""
        epochs = epochs if epochs is not None else self.cfg.epochs
        history: List[Dict] = []
        since_best = 0
        for epoch in range(self.start_epoch, epochs):
            skip = self.resume_skip_steps
            self.resume_skip_steps = 0  # only the resumed epoch skips
            # A callable train_loader is an epoch -> iterable factory (e.g.
            # data.imagenet_train.epoch_batches, reshuffled per epoch); one with
            # a `skip` parameter drops trained batches before decoding them,
            # else islice discards them after.
            loader, skipped_in_factory = train_loader, False
            if callable(train_loader):
                if skip and _factory_accepts_skip(train_loader):
                    loader = train_loader(epoch, skip=skip)
                    skipped_in_factory = True
                else:
                    loader = train_loader(epoch)
            if hasattr(loader, "set_epoch"):
                # A stateful loader (ArrayLoader) re-derives its shuffle from
                # (seed, epoch): a resumed process replays the same order.
                loader.set_epoch(epoch)
            if skip and not skipped_in_factory:
                loader = itertools.islice(iter(loader), skip, None)
            with self.log.phase("train_epoch", epoch=epoch):
                train_loss, train_err = self.train_epoch(loader, epoch=epoch,
                                                         print_freq=self.print_freq,
                                                         step_offset=skip)
            if skip and not self._last_epoch_batches:
                # The mid-epoch position equals or passes the loader's true
                # length: steps_per_epoch overstated a length-less loader's
                # batch count when it was saved. Its row would be bogus.
                raise RuntimeError(
                    f"resumed epoch {epoch} skipped {skip} batches but the "
                    f"loader yielded none beyond them; steps_per_epoch "
                    f"({self.steps_per_epoch}) overstates the true batch "
                    "count — give the loader a __len__ (or correct "
                    "steps_per_epoch) so mid-epoch saves suppress the "
                    "epoch-final position")
            with self.log.phase("val_epoch", epoch=epoch):
                val_loss, val_err, val_err5 = self.evaluate(val_loader)
            is_best = val_err < self.best_err1
            if is_best:
                self.best_err1 = val_err
                self.best_epoch = epoch
                since_best = 0
            else:
                since_best += 1
            row = {
                "epoch": epoch,
                "train_loss": round(train_loss, 5),
                "train_err1": round(train_err, 3),
                "val_loss": round(val_loss, 5),
                "val_err1": round(val_err, 3),
                "val_err5": round(val_err5, 3),
                "best_err1": round(self.best_err1, 3),
                "best_epoch": self.best_epoch,
            }
            history.append(row)
            self._write_scores(history)
            self.save(epoch, is_best)
            self.log.emit(row)
            if self.cfg.patience and since_best >= self.cfg.patience:
                break  # early stop (reference :232-233)
        return history

    def _write_scores(self, history: List[Dict]) -> None:
        if not self.save_dir or not self.writer:
            return   # rank 0 owns scores.tsv on the shared filesystem
        os.makedirs(self.save_dir, exist_ok=True)
        cols = list(history[0].keys())
        lines = ["\t".join(cols)] + ["\t".join(str(row[c]) for c in cols) for row in history]
        with open(os.path.join(self.save_dir, "scores.tsv"), "w") as f:
            f.write("\n".join(lines) + "\n")
