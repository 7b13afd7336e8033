"""The classification train step (port of ``parallel/train_step.py`` of the
JAX package), on one device.

``step_fn`` is the JAX step: a train-mode forward (BatchNorm on batch
statistics, its running statistics updated as flax updates them; dropout
and stochastic depth drawing from the state's generator), f32 logits, mean
softmax cross-entropy on integer labels, its gradient, one optimizer update
and the batch's loss, top-1 and top-5. The state's tensors are updated in
place, as the JAX step donates its state. The mesh and its shardings
(data and tensor parallelism) wait for ROADMAP.md section A, item 7.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from network_interpretation_imagenet_tpu_torch.device import resolve_device
from network_interpretation_imagenet_tpu_torch.models import ModelBundle
from network_interpretation_imagenet_tpu_torch.models.common import Draws, drawing

MESH_NOT_PORTED = ("a device mesh (data or model parallelism) is not ported yet "
                   "(ROADMAP.md section A, item 7): train on one device")


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]    # trainable parameters, torch names
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


def make_sharded_train_step(bundle: ModelBundle, mesh=None, optimizer=None, *,
                            device=None) -> Tuple[Callable, Callable]:
    """``(init_fn, step_fn)`` of a cross-entropy classification step on
    ``device`` (the card unless ``"cpu"`` is asked for), ``optimizer`` a
    :class:`~train.harness.Optimizer`.

    ``init_fn(seed, state_dict=None) -> TrainState``: a copy of
    ``state_dict`` (else ``bundle.init(seed)``) on the device, a fresh
    optimizer state, step 0 and a generator seeded with ``seed``.
    ``step_fn(state, images, labels, draws=None) -> (state, metrics)``: one
    optimizer step on NHWC ``images`` (computed in the parameters' dtype:
    f32, or f64 for a reference step) and integer ``labels`` (numpy arrays
    or tensors); ``metrics`` holds 0-d device tensors. ``draws`` replaces
    the generator's draws (a :class:`~models.common.Draws` with injected
    decisions). ``mesh`` must be None (ROADMAP.md section A, item 7)."""
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    dev = resolve_device(device)
    # The structure functional_call runs: the state's tensors replace its own.
    net = copy.deepcopy(bundle.module).to(dev).train()
    # Train-only heads the JAX model lacks (optional_prefixes) stay out of training.
    optional = getattr(net, "optional_prefixes", ())
    names = [n for n, _ in net.named_parameters() if not n.startswith(optional)]

    def place(t: torch.Tensor) -> torch.Tensor:
        t = t.detach().to(dev, copy=True)
        if dev.type == "cuda" and t.dim() == 4:   # convolutions run channels_last
            t = t.contiguous(memory_format=torch.channels_last)
        return t

    def init_fn(seed: int, state_dict: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        sd = state_dict if state_dict is not None else bundle.init(seed)
        params = {n: place(sd[n]).requires_grad_() for n in names}
        buffers = {n: place(sd[n]) for n, _ in net.named_buffers()
                   if not n.startswith(optional)}
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed))
        return TrainState(params, buffers, optimizer.init(params), 0, generator)

    def step_fn(state: TrainState, images, labels, draws: Optional[Draws] = None):
        dtype = next(iter(state.params.values())).dtype
        x = torch.as_tensor(images).to(dev, dtype, non_blocking=True)
        y = torch.as_tensor(labels).to(dev, torch.int64, non_blocking=True)
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

    return init_fn, step_fn
