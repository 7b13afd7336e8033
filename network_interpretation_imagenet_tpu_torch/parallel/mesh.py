"""The device mesh over ``torch.distributed`` (port of ``parallel/mesh.py`` of
the JAX package).

A JAX mesh is an array of devices inside one process. Here each rank is one
process holding one device, and the ranks of a process group (NCCL between
cards, gloo on the CPU or for ranks that share one card) are laid out as a
("data", "model") :class:`~torch.distributed.device_mesh.DeviceMesh`.

The sharded functions (``parallel.sharded_engine`` and the ``mesh=`` of the
explanation functions) are collective: every rank of the mesh calls them
with the same replicated inputs, evaluates its slice of the data axis, and
gets the whole result back from one all-gather (:func:`all_gather_rows`).
Ranks along the model axis compute the same slice, as a JAX ``shard_map``
whose specs name only the data axis replicates it over the model axis.
The sharded train step (``parallel.train_step``) uses the rest: an axis's
process group, a differentiable all-reduce (BatchNorm's statistics), and
the all-gather and slice of tensors sharded along dim 0 (parameters split
over the model axis).

A collective that fails raises :class:`CollectiveError`, which no sweep
catches per image: a failing rank fails the run, and a rank left waiting on
a dead peer raises when the process group's timeout ends. Inputs that differ
across ranks raise :class:`ReplicationError` on every rank alike.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from network_interpretation_imagenet_tpu_torch.device import resolve_device


class CollectiveError(RuntimeError):
    """A collective failed: the run cannot go on."""


class ReplicationError(ValueError):
    """The ranks passed different inputs to a sharded call. Every rank sees
    every rank's fingerprint in the same all-gather, so every rank raises it
    for the same call and the ranks stay in step: a sweep fails that image
    and goes on, as the JAX package's fails an image whose result spans
    other processes' devices."""


def make_mesh(devices: Optional[Sequence[int]] = None, model_parallel: int = 1,
              data_axis: str = "data", model_axis: str = "model", *,
              device=None) -> DeviceMesh:
    """("data", "model") mesh over the given ranks (default: the whole world).

    ``model_parallel`` splits the ranks between the data axis and the model
    axis; a count it does not divide falls back to pure data parallelism
    (model = 1), as the JAX package's does. In a process with no process
    group, a world of one is started first, on ``device``'s type (the card
    unless ``"cpu"`` is asked for): NCCL for a card, gloo for the CPU."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    n = len(ranks)
    if n % model_parallel != 0:
        model_parallel = 1
    layout = torch.tensor(ranks, dtype=torch.int64).reshape(n // model_parallel, model_parallel)
    return DeviceMesh(dev.type, layout, mesh_dim_names=(data_axis, model_axis))


def axis_size(mesh: DeviceMesh, axis: str = "data") -> int:
    """The number of ranks along ``axis`` (JAX's ``mesh.shape[axis]``)."""
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_index(mesh: DeviceMesh, axis: str = "data") -> int:
    """This rank's coordinate along ``axis``."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    return int(mesh.get_local_rank(axis))


def mesh_size(mesh) -> int:
    """All ranks of the mesh (1 for ``None``): a mesh of one runs the
    single-device paths, as in the JAX package."""
    return 1 if mesh is None else int(mesh.mesh.numel())


def _local_slice(mesh: DeviceMesh, total: int, axis: str) -> slice:
    d = axis_size(mesh, axis)
    if total % d:
        raise ValueError(f"a leading axis of {total} does not split over {d} ranks of {axis!r}")
    n = total // d
    r = axis_index(mesh, axis)
    return slice(r * n, (r + 1) * n)


def shard_batch(mesh: DeviceMesh, x, axis: str = "data"):
    """This rank's slice of ``x``'s leading axis, which ``axis`` must divide."""
    return x[_local_slice(mesh, int(x.shape[0]), axis)]


def replicate(mesh: DeviceMesh, tree):
    """``tree`` as every rank holds it: a process holds its own copy, and
    the inputs of the sharded functions are replicated by contract (each
    rank passes the same values). Each sharded call compares the ranks'
    inputs in its all-gather (:func:`all_gather_rows`)."""
    return tree


def _fingerprint(values) -> torch.Tensor:
    """float64 sums that tell replicated inputs apart: per value its sum and
    its sum weighted by a ramp (the same values in another order differ)."""
    out = []
    for v in values:
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        t = t.detach().reshape(-1).to(torch.float64)
        ramp = torch.arange(1, t.numel() + 1, dtype=torch.float64, device=t.device)
        out += [t.sum().cpu(), (t * ramp).sum().cpu()]
    return torch.stack(out) if out else torch.zeros(0, dtype=torch.float64)


def _through_host(group) -> bool:
    """gloo's collectives take host tensors here (outcomes, statistics and a
    train step's gradients cross through the host); NCCL's stay on the card."""
    return dist.get_backend(group) != "nccl"


def _wire(group) -> torch.device:
    """Where a collective's buffer lives: the host for gloo, the card for NCCL."""
    return (torch.device("cpu") if _through_host(group)
            else torch.device("cuda", torch.cuda.current_device()))


def axis_group(mesh: DeviceMesh, axis: str = "data"):
    """The process group of this rank's ranks along ``axis``."""
    return mesh.get_group(axis)


def _all_reduce(value: torch.Tensor, group, what: str) -> torch.Tensor:
    """``value`` summed over ``group``, on its device (a new tensor)."""
    t = value.detach().to(_wire(group), copy=True)
    try:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    except Exception as e:  # noqa: BLE001 - re-raised as the run's failure
        raise CollectiveError(f"all_reduce over {what!r} failed: {e!r}") from e
    return t.to(value.device)


class _SumOverRanks(torch.autograd.Function):
    """An all-reduce sum whose backward all-reduces the gradient: the
    gradient of a sum of every rank's objective with respect to a value that
    each rank's sum term shares."""

    @staticmethod
    def forward(ctx, value, group, what):
        ctx.group, ctx.what = group, what
        return _all_reduce(value, group, what)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group, ctx.what), None, None


def differentiable_sum(mesh: DeviceMesh, axis: str = "data") -> Callable[[torch.Tensor],
                                                                         torch.Tensor]:
    """``t -> t`` summed over ``axis``, differentiably (the backward sums the
    gradients over the same ranks): the reduction of BatchNorm's statistics
    in a sharded train step (``models.common.global_batch_stats``)."""
    group = axis_group(mesh, axis)
    return lambda t: _SumOverRanks.apply(t, group, axis)


def shard_dim0(mesh: DeviceMesh, t: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """This rank's slice of ``t`` along dim 0, which ``axis`` must divide (a
    parameter's output channels, sharded over the model axis)."""
    return t[_local_slice(mesh, int(t.shape[0]), axis)]


def all_gather_dim0(mesh: DeviceMesh, shards: Sequence[torch.Tensor],
                    axis: str = "model") -> List[torch.Tensor]:
    """The whole tensors whose dim-0 slices the ranks along ``axis`` hold,
    each the ranks' ``shards`` concatenated along dim 0 in rank order, on
    its shard's device and dtype: ONE all-gather of every shard packed flat
    (on the card with NCCL, through the host with gloo)."""
    if not shards:
        return []
    group = axis_group(mesh, axis)
    d = axis_size(mesh, axis)
    flat = torch.cat([t.detach().reshape(-1).to(_wire(group)) for t in shards])
    parts = [torch.empty_like(flat) for _ in range(d)]
    try:
        dist.all_gather(parts, flat, group=group)
    except Exception as e:  # noqa: BLE001 - re-raised as the run's failure
        raise CollectiveError(f"all_gather over {axis!r} failed: {e!r}") from e
    out, off = [], 0
    for t in shards:
        size = t.numel()
        full = torch.cat([p[off:off + size].view(t.shape) for p in parts])
        out.append(full.to(t.device, t.dtype))
        off += size
    return out


def all_gather_rows(mesh: DeviceMesh, tensors: Sequence[torch.Tensor], axis: str = "data",
                    fingerprint: Sequence = ()) -> List[torch.Tensor]:
    """Every rank's ``tensors`` (leading axis n_local, any dtype exact in
    float64) concatenated along the leading axis in rank order, on each
    tensor's device, from ONE all-gather over ``axis``: the tensors travel
    packed into one float64 buffer (on the card with NCCL, through the host
    with gloo). ``fingerprint`` values (the call's replicated inputs) ride
    in the same buffer; ranks that passed different inputs raise
    :class:`ReplicationError` on every rank, since every rank sees every
    fingerprint."""
    group = axis_group(mesh, axis)
    d = axis_size(mesh, axis)
    fp = _fingerprint(fingerprint)
    dev = _wire(group)
    flat = torch.cat([fp.to(dev)] + [t.detach().reshape(-1).to(dev, torch.float64)
                                     for t in tensors])
    parts = [torch.empty_like(flat) for _ in range(d)]
    try:
        dist.all_gather(parts, flat, group=group)
    except Exception as e:  # noqa: BLE001 - re-raised as the run's failure
        raise CollectiveError(f"all_gather over {axis!r} failed: {e!r}") from e
    nf = fp.numel()
    bits = [p[:nf].view(torch.int64) for p in parts]   # bit for bit: NaN equals NaN
    if nf and any(not torch.equal(b, bits[0]) for b in bits[1:]):
        raise ReplicationError(
            "the ranks passed different inputs to a sharded call, which takes the same "
            "replicated inputs on every rank (an image stride per process, as --multihost "
            "gives, cannot meet a mesh that spans those processes)")
    out, off = [], nf
    for t in tensors:
        size = t.numel()
        rows = [p[off:off + size].reshape(t.shape) for p in parts]
        out.append(torch.cat(rows).to(t.device, t.dtype))
        off += size
    return out


def all_reduce_sum(mesh: DeviceMesh, value: torch.Tensor,
                   axis: Optional[str] = "data") -> torch.Tensor:
    """``value`` summed over ``axis`` (JAX's ``psum``), on its device; with
    ``axis`` None over every process of the world (the default group)."""
    return _all_reduce(value, None if axis is None else axis_group(mesh, axis),
                       axis or "world")


def pad_rows(x: torch.Tensor, total: int, fill=None) -> torch.Tensor:
    """``x`` with its leading axis padded to ``total`` by repeats of row 0
    (``fill=None``) or by rows of ``fill``."""
    pad = total - int(x.shape[0])
    if pad <= 0:
        return x
    if fill is None:
        extra = x[:1].expand(pad, *x.shape[1:])
    else:
        extra = torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, extra])


def map_sharded(mesh: Optional[DeviceMesh], fn: Callable, batched: Sequence,
                fills: Optional[Sequence] = None, axis: str = "data"):
    """Run ``fn(*local)`` on this rank's slice of the leading axis of the
    ``batched`` tensors (N each) and return its output(s) for all N, on
    every rank: the padded axis (``fills[i]`` for tensor i, None to repeat
    its first row) shards over ``axis``, each rank runs its slice, one
    all-gather brings the rest, and the pad is trimmed. ``fn`` returns a
    tensor or a tuple of tensors with a leading axis of the local count.
    With ``mesh`` None ``fn`` runs on everything. The inputs are checked
    replicated in the same all-gather."""
    if mesh is None:
        return fn(*batched)
    n = int(batched[0].shape[0])
    d = axis_size(mesh, axis)
    total = -(-n // d) * d
    fills = [None] * len(batched) if fills is None else list(fills)
    padded = [pad_rows(t, total, f) for t, f in zip(batched, fills)]
    local = [shard_batch(mesh, t, axis) for t in padded]
    out = fn(*local)
    single = isinstance(out, torch.Tensor)
    outs = [out] if single else list(out)
    gathered = [g[:n] for g in all_gather_rows(mesh, outs, axis, fingerprint=batched)]
    return gathered[0] if single else tuple(gathered)
