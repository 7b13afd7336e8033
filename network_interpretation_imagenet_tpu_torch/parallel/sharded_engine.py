"""Mask-parallel masked-forward evaluation over a mesh (port of
``parallel/sharded_engine.py`` of the JAX package).

The mask-sample axis is this workload's scaling dimension: K masks shard
over the mesh's data axis. Each function is collective: every rank calls it
with the same replicated inputs (weights, image, segments, starts or ids,
target); the K axis pads to a multiple of the data-axis size (window starts
with 0, knockout rows with image 0 and ids -1, both marked invalid), each
rank builds its slice's masks and runs them through ``logits_fn`` in one
forward, and one all-gather gives every rank the whole trimmed outcomes.
The survive count of the single-image functions is an all-reduce (SUM).

On the card, window masks are built by B1 (``ops.masked_batch``, one launch
per image run of a rank's slice) and ``logits_fn`` is the engine's folded
plan (``engine.folded_logits``: B2 for an ImageNet ResNet); knockout masks
are the plain ops of ``ops.masking``, as in the engine's knockout path.

The outcomes travel as one float64 buffer per call (with a fingerprint of
the call's inputs, so ranks that passed different inputs all raise
``mesh.ReplicationError``): with NCCL the all-gather runs on the card, with
gloo the few KB cross through the host. The masked forwards stay on the
device either way.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.ops import masking
from network_interpretation_imagenet_tpu_torch.ops.masked_batch import masked_batch
from network_interpretation_imagenet_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce_sum,
    axis_size,
    shard_batch,
)


def _device(variables) -> torch.device:
    return next(iter(variables.values())).device


def _to(dev, array, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array, dtype)).to(dev)


def _outcomes(logits: torch.Tensor, targets: torch.Tensor):
    """(prediction == target, softmax probability of the target) per row."""
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    hit = torch.argmax(logits, dim=-1) == targets
    return hit, probs.gather(1, targets[:, None])[:, 0]


def _pad(a: np.ndarray, total: int, fill) -> np.ndarray:
    if total == len(a):
        return a
    extra = np.empty((total - len(a), *a.shape[1:]), a.dtype)
    extra[...] = fill
    return np.concatenate([a, extra])


def _window_batch(images_t, segs_t, firsts_t, widths_t, img_idx: np.ndarray,
                  compute_dtype) -> torch.Tensor:
    """Masked images of (image, first) pairs in ``compute_dtype``: one B1
    launch per run of one image, into its slice of the batch."""
    k = len(img_idx)
    batch = torch.empty((k, *images_t.shape[1:]), dtype=compute_dtype, device=images_t.device)
    start = 0
    while start < k:
        i = int(img_idx[start])
        end = start
        while end < k and img_idx[end] == i:
            end += 1
        masked_batch(images_t[i], segs_t[i], firsts_t[start:end], widths_t[i:i + 1],
                     compute_dtype, out=batch[start:end])
        start = end
    return batch


def _knockout_batch(images_t, segs_t, ids_t, img_idx_t, compute_dtype) -> torch.Tensor:
    masks = masking.knockout_masks(segs_t[img_idx_t], ids_t)
    return (images_t[img_idx_t] * masks[..., None].to(torch.float32)).to(compute_dtype)


@torch.inference_mode()
def _eval_rows(mesh, logits_fn, variables, images, segments, rows: np.ndarray, targets,
               valid: np.ndarray, build, compute_dtype, data_axis, fingerprint):
    """The shared body: this rank's slice of ``rows`` (image index first),
    its masked batch from ``build``, one forward, one all-gather. Returns
    (survived bool[T], prob_target f32[T], local survive-count tensor)."""
    dev = _device(variables)
    images_t = _to(dev, images, np.float32)
    segs_t = _to(dev, segments, np.int32)
    targets_t = _to(dev, targets, np.int64)
    local = shard_batch(mesh, rows, data_axis)
    local_valid = _to(dev, shard_batch(mesh, valid, data_axis), bool)
    img_idx = local[:, 0]
    img_idx_t = _to(dev, img_idx, np.int64)
    imgs = build(images_t, segs_t, local, img_idx, img_idx_t)
    hit, prob = _outcomes(logits_fn(variables, imgs), targets_t[img_idx_t])
    survived = hit & local_valid
    surv_all, prob_all = all_gather_rows(mesh, [survived, prob], data_axis,
                                         fingerprint=fingerprint)
    return surv_all.cpu().numpy(), prob_all.cpu().numpy(), survived.sum()


def sharded_window_eval(mesh, logits_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                        variables: Any, image, segments, firsts, width: int, target: int,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        data_axis: str = "data") -> Tuple[np.ndarray, np.ndarray, int]:
    """K window masks sharded over the mesh's data axis: (survived bool[K],
    prob_target f32[K], survive count), the count summed across ranks by an
    all-reduce. ``image`` f32[H, W, C] and ``segments`` int32[H, W] host
    arrays, ``firsts`` int32[K]."""
    firsts = np.asarray(firsts, np.int32).reshape(-1)
    k = len(firsts)
    total = -(-k // axis_size(mesh, data_axis)) * axis_size(mesh, data_axis)
    rows = np.stack([np.zeros(total, np.int32), _pad(firsts, total, 0)], axis=1)
    widths = np.asarray([int(width)], np.int32)

    def build(images_t, segs_t, local, img_idx, img_idx_t):
        return _window_batch(images_t, segs_t, _to(images_t.device, local[:, 1], np.int32),
                             _to(images_t.device, widths, np.int32), img_idx, compute_dtype)

    survived, probs, local_count = _eval_rows(
        mesh, logits_fn, variables, np.asarray(image, np.float32)[None],
        np.asarray(segments, np.int32)[None], rows, [int(target)], np.arange(total) < k, build,
        compute_dtype, data_axis, (image, segments, firsts, width, target))
    count = all_reduce_sum(mesh, local_count, data_axis)
    return survived[:k], probs[:k], int(count)


def sharded_window_eval_multi(mesh, logits_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                              variables: Any, images, segments, firsts, widths, targets,
                              compute_dtype: torch.dtype = torch.bfloat16,
                              data_axis: str = "data") -> Tuple[np.ndarray, np.ndarray]:
    """N images x K window masks sharded over the data axis: the N*K grid
    flattens image-major to (image, first) pairs, as the engine's
    ``eval_window_masks_multi`` does, and each rank evaluates its slice of
    pairs against the replicated image and segment stacks. Returns
    (survived bool[N, K], prob_target f32[N, K])."""
    images = np.asarray(images, np.float32)
    segments = np.asarray(segments, np.int32)
    firsts = np.asarray(firsts, np.int32)
    widths = np.asarray(widths, np.int32).reshape(-1)
    targets = np.asarray(targets, np.int32).reshape(-1)
    n, k = firsts.shape
    d = axis_size(mesh, data_axis)
    total = -(-(n * k) // d) * d
    pairs = np.stack([np.repeat(np.arange(n, dtype=np.int32), k), firsts.reshape(-1)], axis=1)
    pairs = _pad(pairs, total, 0)

    def build(images_t, segs_t, local, img_idx, img_idx_t):
        return _window_batch(images_t, segs_t, _to(images_t.device, local[:, 1], np.int32),
                             _to(images_t.device, widths, np.int32), img_idx, compute_dtype)

    survived, probs, _ = _eval_rows(mesh, logits_fn, variables, images, segments, pairs,
                                    targets, np.ones(total, bool), build, compute_dtype,
                                    data_axis, (images, segments, firsts, widths, targets))
    return survived[:n * k].reshape(n, k), probs[:n * k].reshape(n, k)


def sharded_knockout_eval(mesh, logits_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                          variables: Any, image, segments, knock_ids, target: int,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          data_axis: str = "data") -> Tuple[np.ndarray, np.ndarray, int]:
    """K knockout masks (int32[K, M] ids; -1 knocks nothing) sharded over the
    data axis: the knockout twin of :func:`sharded_window_eval`."""
    knock_ids = np.asarray(knock_ids, np.int32)
    knock_ids = knock_ids.reshape(len(knock_ids), -1)
    k, m = knock_ids.shape
    total = -(-k // axis_size(mesh, data_axis)) * axis_size(mesh, data_axis)
    rows = np.concatenate([np.zeros((total, 1), np.int32), _pad(knock_ids, total, -1)], axis=1)

    def build(images_t, segs_t, local, img_idx, img_idx_t):
        return _knockout_batch(images_t, segs_t, _to(images_t.device, local[:, 1:], np.int32),
                               img_idx_t, compute_dtype)

    survived, probs, local_count = _eval_rows(
        mesh, logits_fn, variables, np.asarray(image, np.float32)[None],
        np.asarray(segments, np.int32)[None], rows, [int(target)], np.arange(total) < k, build,
        compute_dtype, data_axis, (image, segments, knock_ids, target))
    count = all_reduce_sum(mesh, local_count, data_axis)
    return survived[:k], probs[:k], int(count)


def sharded_knockout_eval_multi(mesh, logits_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                                variables: Any, images, segments, knock_ids, targets,
                                compute_dtype: torch.dtype = torch.bfloat16,
                                data_axis: str = "data") -> Tuple[np.ndarray, np.ndarray]:
    """N images x K knockout masks (int32[N, K, M]) sharded over the data
    axis; (survived bool[N, K], prob_target f32[N, K]): the knockout twin of
    :func:`sharded_window_eval_multi`. Pad rows knock nothing out of image
    0 and are trimmed."""
    images = np.asarray(images, np.float32)
    segments = np.asarray(segments, np.int32)
    knock_ids = np.asarray(knock_ids, np.int32)
    targets = np.asarray(targets, np.int32).reshape(-1)
    n, k, m = knock_ids.shape
    d = axis_size(mesh, data_axis)
    total = -(-(n * k) // d) * d
    rows = np.concatenate([np.repeat(np.arange(n, dtype=np.int32), k)[:, None],
                           knock_ids.reshape(n * k, m)], axis=1)
    if total > n * k:
        fill = np.full((total - n * k, m + 1), -1, np.int32)
        fill[:, 0] = 0   # image 0, knocking nothing out
        rows = np.concatenate([rows, fill])

    def build(images_t, segs_t, local, img_idx, img_idx_t):
        return _knockout_batch(images_t, segs_t, _to(images_t.device, local[:, 1:], np.int32),
                               img_idx_t, compute_dtype)

    survived, probs, _ = _eval_rows(mesh, logits_fn, variables, images, segments, rows,
                                    targets, np.ones(total, bool), build, compute_dtype,
                                    data_axis, (images, segments, knock_ids, targets))
    return survived[:n * k].reshape(n, k), probs[:n * k].reshape(n, k)
