"""The classification train step (port of ``parallel/train_step.py`` of the
JAX package), on one device or on a ("data", "model") mesh of ranks.

``step_fn`` is the JAX step: a train-mode forward (BatchNorm on batch
statistics, its running statistics updated as flax updates them; dropout
and stochastic depth drawing from the state's generator), f32 logits, mean
softmax cross-entropy on integer labels, its gradient, one optimizer update
and the batch's loss, top-1 and top-5. The state's tensors are updated in
place, as the JAX step donates its state.

On a mesh (``parallel.mesh.make_mesh``) the step does what the JAX step's
placement annotations make XLA do, with the collectives written out. Each
rank steps its rows of the global batch. BatchNorm normalizes by the
global batch's statistics (``models.common.global_batch_stats``: one
differentiable all-reduce over "data" per layer). The gradients, the
metrics' sums and the row count cross "data" in one flat all-reduce, so
the update is the global mean's. Along "model", each rank keeps only its
slice of every sharded parameter (:func:`param_shardings`) and of its
optimizer slots: the forward all-gathers the whole weights in one
collective, and each rank keeps its slice of the whole gradient, which is
the same on every rank of the axis.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from network_interpretation_imagenet_tpu_torch.device import resolve_device
from network_interpretation_imagenet_tpu_torch.models import ModelBundle
from network_interpretation_imagenet_tpu_torch.models.common import (
    Draws,
    drawing,
    global_batch_stats,
)
from network_interpretation_imagenet_tpu_torch.parallel.mesh import (
    all_gather_dim0,
    all_reduce_sum,
    axis_index,
    axis_size,
    differentiable_sum,
    shard_dim0,
)


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]    # trainable parameters, torch names (a rank's shards)
    buffers: Dict[str, torch.Tensor]   # BatchNorm running statistics
    opt_state: Dict[str, Any]          # the optimizer's count and slots
    step: int
    generator: torch.Generator         # dropout's and stochastic depth's draws


def metrics_of(logits: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Mean cross-entropy, top-1 and top-5 (``k = min(5, classes)``) of f32
    logits, as 0-d tensors on their device (JAX ``train_step.py:112-121``)."""
    k = min(5, logits.shape[-1])
    hit1 = (logits.argmax(-1) == labels).float()
    hitk = (logits.topk(k, dim=-1).indices == labels[:, None]).any(-1).float()
    return {"loss": F.cross_entropy(logits, labels), "top1": hit1.mean(), "top5": hitk.mean()}


def param_shardings(params: Dict[str, torch.Tensor], mesh, model_axis: str = "model",
                    min_shard_dim: int = 32) -> Dict[str, Optional[int]]:
    """The JAX package's sharding rule (``train_step.py:35-51``) on torch
    names: a 4-D (conv, OIHW) or 2-D (``Linear``, [out, in]) parameter
    shards its output channels, dim 0, over ``model_axis`` when that axis is
    larger than 1 and divides them and they number at least
    ``min_shard_dim``; everything else (biases, BatchNorm) replicates.
    Returns each name's sharded dim, 0 or None. (The JAX kernels hold their
    output channels last: HWIO, and [in, out] for a dense kernel.)"""
    msize = axis_size(mesh, model_axis)

    def rule(t: torch.Tensor) -> Optional[int]:
        shape = tuple(t.shape)
        if msize > 1 and len(shape) in (2, 4) and shape[0] % msize == 0 \
                and shape[0] >= min_shard_dim:
            return 0
        return None

    return {n: rule(t) for n, t in params.items()}


def gather_full(mesh, tensors: Dict[str, torch.Tensor], shardings: Dict[str, Optional[int]],
                model_axis: str = "model") -> Dict[str, torch.Tensor]:
    """``tensors`` (a rank's shards) as whole tensors, from one all-gather
    over ``model_axis`` of the sharded ones (collective along that axis)."""
    sharded = [n for n in tensors if shardings.get(n) is not None]
    whole = dict(tensors)
    for n, t in zip(sharded, all_gather_dim0(mesh, [tensors[n] for n in sharded], model_axis)):
        whole[n] = t
    return whole


def take_shards(mesh, tensors: Dict[str, torch.Tensor], shardings: Dict[str, Optional[int]],
                model_axis: str = "model") -> Dict[str, torch.Tensor]:
    """This rank's slices of whole ``tensors`` (views of them)."""
    return {n: shard_dim0(mesh, t, model_axis) if shardings.get(n) is not None else t
            for n, t in tensors.items()}


def make_sharded_train_step(bundle: ModelBundle, mesh=None, optimizer=None,
                            data_axis: str = "data", model_axis: str = "model", *,
                            device=None) -> Tuple[Callable, Callable]:
    """``(init_fn, step_fn)`` of a cross-entropy classification step on
    ``device`` (the card unless ``"cpu"`` is asked for), ``optimizer`` a
    :class:`~train.harness.Optimizer`.

    ``init_fn(seed, state_dict=None) -> TrainState``: a copy of
    ``state_dict`` (else ``bundle.init(seed)``) on the device, on a mesh
    each sharded parameter's slice for this rank, a fresh optimizer state
    (its slots shaped as the parameters they follow), step 0 and a
    generator seeded with ``seed`` (alike on every rank).
    ``step_fn(state, images, labels, draws=None) -> (state, metrics)``: one
    optimizer step on NHWC ``images`` (computed in the parameters' dtype:
    f32, or f64 for a reference step) and integer ``labels`` (numpy arrays
    or tensors); ``metrics`` holds 0-d device tensors. ``draws`` replaces
    the generator's draws (a :class:`~models.common.Draws` with injected
    decisions; on a mesh they are the global batch's).

    With ``mesh`` None this is the single-device step. On a mesh it is
    collective (every rank calls it, a world of 1 included): ``images`` and
    ``labels`` are this rank's rows of the global batch, every rank of the
    data axis holding as many (else every rank raises a ``ValueError``),
    and ``metrics`` are the global batch's."""
    dev = resolve_device(device)
    # The structure functional_call runs: the state's tensors replace its own.
    net = copy.deepcopy(bundle.module).to(dev).train()
    # Train-only heads the JAX model lacks (optional_prefixes) stay out of training.
    optional = getattr(net, "optional_prefixes", ())
    names = [n for n, _ in net.named_parameters() if not n.startswith(optional)]
    shardings = ({n: None for n in names} if mesh is None else
                 param_shardings(dict(net.named_parameters()), mesh, model_axis))

    def layout(t: torch.Tensor) -> torch.Tensor:
        if dev.type == "cuda" and t.dim() == 4:   # convolutions run channels_last
            t = t.contiguous(memory_format=torch.channels_last)
        return t

    def place(t: torch.Tensor) -> torch.Tensor:
        return layout(t.detach().to(dev, copy=True))

    def init_fn(seed: int, state_dict: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        sd = state_dict if state_dict is not None else bundle.init(seed)
        full = {n: sd[n] for n in names}
        local = full if mesh is None else take_shards(mesh, full, shardings, model_axis)
        params = {n: place(local[n]).requires_grad_() for n in names}
        buffers = {n: place(sd[n]) for n, _ in net.named_buffers()
                   if not n.startswith(optional)}
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed))
        return TrainState(params, buffers, optimizer.init(params), 0, generator)

    def step_fn(state: TrainState, images, labels, draws: Optional[Draws] = None):
        dtype = next(iter(state.params.values())).dtype
        x = torch.as_tensor(images).to(dev, dtype, non_blocking=True)
        y = torch.as_tensor(labels).to(dev, torch.int64, non_blocking=True)
        if mesh is None:
            with drawing(net, draws if draws is not None else Draws(state.generator)):
                out = torch.func.functional_call(net, {**state.params, **state.buffers}, (x,))
            logits = (out[-1] if isinstance(out, tuple) else out).to(
                torch.promote_types(dtype, torch.float32))   # f32 logits (f64 in a reference)
            metrics = metrics_of(logits, y)
            params = list(state.params.values())
            grads = torch.autograd.grad(metrics["loss"], params)
            optimizer.update(grads, state.opt_state, params)
            return (state._replace(step=state.step + 1),
                    {k: v.detach() for k, v in metrics.items()})
        grads, metrics = _mesh_grads(state, x, y, draws)
        optimizer.update(grads, state.opt_state, [state.params[n] for n in names])
        return state._replace(step=state.step + 1), metrics

    def _mesh_grads(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                    draws: Optional[Draws]) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
        """This rank's slices of the global mean's gradients, and the global
        batch's metrics."""
        d, r = axis_size(mesh, data_axis), axis_index(mesh, data_axis)
        leaves = dict(state.params)   # the sharded ones replaced by their whole tensors
        sharded = {n: p.detach() for n, p in state.params.items() if shardings[n] is not None}
        for n, t in gather_full(mesh, sharded, shardings, model_axis).items():
            leaves[n] = layout(t).requires_grad_()
        base = draws if draws is not None else Draws(state.generator)
        with drawing(net, Draws(base.generator, base.injected, rows=(r, d))), \
                global_batch_stats(net, differentiable_sum(mesh, data_axis)):
            out = torch.func.functional_call(net, {**leaves, **state.buffers}, (x,))
        logits = (out[-1] if isinstance(out, tuple) else out).to(
            torch.promote_types(x.dtype, torch.float32))
        local = metrics_of(logits, y)
        grads = torch.autograd.grad(local["loss"], [leaves[n] for n in names])
        n_local = float(y.shape[0])
        sums = torch.stack([local[k].detach() * n_local for k in ("loss", "top1", "top5")]
                           + [local["loss"].new_tensor(n_local)]).to(x.dtype)
        # ONE all-reduce over "data": every gradient, the metrics' sums, the row count.
        total = all_reduce_sum(mesh, torch.cat([g.reshape(-1) for g in grads] + [sums]),
                               data_axis)
        count = float(total[-1])
        if count != n_local * d:
            raise ValueError(f"the global batch must divide evenly over the {d} ranks of "
                             f"{data_axis!r}: this rank stepped {int(n_local)} of "
                             f"{int(count)} rows")
        mean = total[:-4] / d
        out_grads, off = [], 0
        for n, g in zip(names, grads):
            whole = mean[off:off + g.numel()].view(g.shape)
            off += g.numel()
            out_grads.append(whole if shardings[n] is None
                             else shard_dim0(mesh, whole, model_axis))
        metrics = {k: total[-4 + i] / count for i, k in enumerate(("loss", "top1", "top5"))}
        return out_grads, metrics

    return init_fn, step_fn
