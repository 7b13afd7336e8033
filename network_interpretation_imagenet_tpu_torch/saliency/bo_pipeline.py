"""BO-driven saliency, the reference's flagship path (port of
``saliency/bo_pipeline.py`` of the JAX package).

Segment the image, bound the search space to ``[0, 0.6·S]``, run GP-EI BO
over window starts (3 pre-samples + 10 iterations), sum the evaluated
windows' survive labels into the heatmap. The fused loop
(:class:`bo.loop.FusedWindowBO`) runs the whole active-learning loop on the
device, as one CUDA graph on the card; ``fused=False`` runs the host loop.
With a mesh the fused loop shards over its data axis: the proposals of one
image, or the images of a batch (see ``bo.loop``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.bo.loop import (
    BOResult,
    FusedWindowBO,
    bayesian_optimize,
    make_fused_window_bo,
    next_pow2,
    window_draws,
)
from network_interpretation_imagenet_tpu_torch.config import BOConfig
from network_interpretation_imagenet_tpu_torch.ops import aggregate
from network_interpretation_imagenet_tpu_torch.parallel.mesh import axis_size, pad_rows
from network_interpretation_imagenet_tpu_torch.saliency.engine import (
    MaskEvalResult,
    SaliencyEngine,
)
from network_interpretation_imagenet_tpu_torch.saliency.pipeline import SaliencyOutput
from network_interpretation_imagenet_tpu_torch.utils import logging as trace


def fused_runner(engine: SaliencyEngine, max_candidates: int, cfg: BOConfig, q: int,
                 batch_images: bool = False, mesh=None,
                 data_axis: str = "data") -> FusedWindowBO:
    """The fused runner of this engine, static config and mesh, built once
    and kept in ``engine.fused_runners`` (with the CUDA graphs it captures)."""
    key = (max_candidates, cfg.n_pre_samples, cfg.n_iters, cfg.alpha, cfg.epsilon,
           tuple(cfg.lengthscale_grid), q, batch_images, mesh, data_axis)
    if key not in engine.fused_runners:
        engine.fused_runners[key] = make_fused_window_bo(
            engine.masked_outcomes, max_candidates, n_pre_samples=cfg.n_pre_samples,
            n_iters=cfg.n_iters, alpha=cfg.alpha, epsilon=cfg.epsilon,
            lengthscale_grid=cfg.lengthscale_grid, proposals_per_iter=q,
            batch_images=batch_images, compute_dtype=engine.compute_dtype,
            device=engine.device, mesh=mesh, data_axis=data_axis)
    return engine.fused_runners[key]


def _assemble_output(segments, num_segments, width, target, bo_res) -> SaliencyOutput:
    """Heatmap + SaliencyOutput from one image's BO trace (host; span
    ``bo.heatmap``). The reference sums the labels of all BO-written mask
    PNGs (``bayesian_active_learning_imagenet.py:312-344``)."""
    with trace.span("bo.heatmap"):
        heat = aggregate.summed_superpixel_labels_np(
            segments, bo_res.xp.astype(np.int32), width, bo_res.survived)
    return SaliencyOutput(
        segments=segments,
        num_segments=num_segments,
        eval=MaskEvalResult(
            survived=bo_res.survived,
            preds=np.where(bo_res.survived, target, -1),
            prob_target=bo_res.yp.astype(np.float32),
            prob_max=np.full_like(bo_res.yp, np.nan, dtype=np.float32),
        ),
        heatmap=heat,
        firsts=bo_res.xp.astype(np.int32),
        width=width,
    )


def _traces(xs, ys, survived, count: int):
    """BOResults from the fused runner's device outputs ([N, M] each): one
    device-to-host copy for all of them (span ``bo.fetch``), which waits
    for the loop."""
    with trace.span("bo.fetch"):
        host = torch.stack([xs, ys, survived.float()]).cpu().numpy()
    return [BOResult(xp=host[0, i, :count].astype(int), yp=host[1, i, :count],
                     survived=host[2, i, :count] > 0.5) for i in range(host.shape[1])]


def bo_window_saliency(
    engine: SaliencyEngine,
    image,
    segments: np.ndarray,
    cfg: BOConfig = BOConfig(),
    window_fraction: float = 0.4,
    seed: int = 0,
    target: Optional[int] = None,
    fused: bool = True,
    proposals_per_iter: int = 1,
    draws=None,
    mesh=None,
) -> Tuple[SaliencyOutput, BOResult]:
    """BO saliency of one image: the aggregate output and the BO trace.

    ``fused=True`` runs the on-device loop (on the card eagerly at the first
    call of an image shape, then as a replayed CUDA graph; see
    :class:`bo.loop.FusedWindowBO`); its random integers come from a CPU
    ``torch.Generator`` seeded with ``seed``, or from ``draws``
    (``n_pre_samples + n_iters·q`` integers in [0, upper]) when given.
    ``fused=False`` runs the host loop, whose draws are numpy's
    ``RandomState(seed)`` as in the JAX package. ``mesh`` (fused only; every
    rank calls with the same inputs): each forward's starts shard over the
    mesh's data axis, so pair it with ``proposals_per_iter`` >= the ranks.

    Traced as span ``bo.call``, a request's root (its request id is the
    span's own unless a caller's span is open), over ``bo.draws``, the
    runner's spans (``bo.upload``, ``bo.replay``, ``bo.eager``,
    ``bo.capture``), ``bo.fetch`` and ``bo.heatmap``."""
    if mesh is not None and not fused:
        raise ValueError("bo_window_saliency: mesh= shards the fused loop; pass fused=True")
    with trace.span("bo.call"):
        segments = np.asarray(segments, np.int32)
        s = int(segments.max()) + 1
        width = int(window_fraction * s)
        upper = int(0.6 * s)  # reference firstIndex_upperbound (:467)
        if target is None:
            target, _ = engine.predict_one(image)

        if fused:
            q = int(proposals_per_iter)
            run = fused_runner(engine, next_pow2(upper + 1), cfg, q, mesh=mesh)
            if draws is None:
                with trace.span("bo.draws"):
                    draws = window_draws(torch.Generator().manual_seed(int(seed)), upper,
                                         run.max_obs)
            xs, ys, survived, count = run(np.asarray(image, np.float32), segments, width, target,
                                          upper, draws)
            bo_res = _traces(xs[None], ys[None], survived[None], count)[0]
        else:

            def objective(indices: np.ndarray):
                res = engine.eval_window_masks(image, segments, indices, width, target)
                return res.prob_target, res.survived

            bo_res = bayesian_optimize(
                objective, upper=upper, n_pre_samples=cfg.n_pre_samples, n_iters=cfg.n_iters,
                seed=seed, alpha=cfg.alpha, epsilon=cfg.epsilon,
                lengthscale_grid=cfg.lengthscale_grid, device=engine.device)

        return _assemble_output(segments, s, width, target, bo_res), bo_res


def _multi_geometry(segments_list, window_fraction: float):
    """Per-image window geometry: segment maps as int32, segment counts,
    window widths and EI candidate uppers (the reference's 0.6·S)."""
    segs = [np.asarray(s, np.int32) for s in segments_list]
    ss = [int(s.max()) + 1 for s in segs]
    widths = np.asarray([int(window_fraction * s) for s in ss], np.int32)
    uppers = np.asarray([int(0.6 * s) for s in ss], np.int32)
    return segs, ss, widths, uppers


def _multi_draws(seed: int, per_image_seeds, uppers, count: int) -> torch.Tensor:
    """int64[N, count]. With ``per_image_seeds`` image j draws from a
    generator seeded with ``per_image_seeds[j]``, so its trace is the one a
    single-image call with that seed gives; otherwise all images draw in
    turn from one generator seeded with ``seed`` (image 0's draws are then
    a single call's with ``seed``)."""
    n = len(uppers)
    if per_image_seeds is not None:
        if len(per_image_seeds) != n:
            raise ValueError(f"per_image_seeds length {len(per_image_seeds)} != image count {n}")
        gens = [torch.Generator().manual_seed(int(s)) for s in per_image_seeds]
    else:
        gens = [torch.Generator().manual_seed(int(seed))] * n
    return torch.stack([window_draws(g, int(u), count) for g, u in zip(gens, uppers)])


def _collect_multi_outputs(xs_d, ys_d, survived_d, count: int, segs, ss, widths, targets,
                           n: int) -> list:
    """One device-to-host copy, assembled into N (SaliencyOutput, BOResult) pairs."""
    return [(_assemble_output(segs[i], ss[i], int(widths[i]), int(targets[i]), tr), tr)
            for i, tr in enumerate(_traces(xs_d, ys_d, survived_d, count)[:n])]


def bo_window_saliency_multi_async(
    engine: SaliencyEngine,
    images,
    segments_list,
    cfg: BOConfig = BOConfig(),
    window_fraction: float = 0.4,
    seed: int = 0,
    targets=None,
    proposals_per_iter: int = 1,
    per_image_seeds=None,
    mesh=None,
    data_axis: str = "data",
):
    """Enqueue :func:`bo_window_saliency_multi`'s fused program and return a
    ``collect()`` closure that waits for it (one device-to-host copy).

    The N active-learning loops run as one program on N same-shape images
    (host arrays, or an f32 [N, H, W, C] tensor on the engine's device):
    every iteration's forward batches N·q masked images. ``targets`` may be
    host ints or a device tensor (the sweep's deferred predict), read by the
    host only in ``collect()``, which returns N (SaliencyOutput, BOResult)
    pairs. With ``per_image_seeds`` (int[N]) image j's trace equals a
    :func:`bo_window_saliency` call with seed ``per_image_seeds[j]`` (up to
    the rounding of a forward at another batch size); see
    :func:`_multi_draws` for the draws without it. The image axis is not
    padded: the runner captures one graph per image count and shape.

    ``mesh`` (every rank calling with the same inputs): the image axis pads
    to a multiple of the data-axis size with repeats of image 0 (its
    geometry, target and draws) and shards; each rank runs its slice of the
    loops, with no collective inside, and one all-gather after the loop
    gives every rank all N traces."""
    segs, ss, widths, uppers = _multi_geometry(segments_list, window_fraction)
    n = len(segs)
    if not isinstance(images, torch.Tensor):
        images = np.asarray(np.stack(images), np.float32)
    if targets is None:
        targets = np.asarray(engine.predict(images).argmax(axis=1), np.int64)
    elif not isinstance(targets, torch.Tensor):
        targets = np.asarray(targets, np.int64)
    run = fused_runner(engine, next_pow2(int(uppers.max()) + 1), cfg, int(proposals_per_iter),
                       batch_images=True, mesh=mesh, data_axis=data_axis)
    draws = _multi_draws(seed, per_image_seeds, uppers, run.max_obs)
    operands = [images, np.stack(segs), widths, targets, uppers, draws]
    if mesh is not None:
        d = axis_size(mesh, data_axis)
        total = -(-n // d) * d
        operands = [pad_rows(torch.as_tensor(a), total) for a in operands]
    xs_d, ys_d, survived_d, count = run(*operands)

    def collect():
        host_targets = targets.cpu().numpy() if isinstance(targets, torch.Tensor) else targets
        return _collect_multi_outputs(xs_d, ys_d, survived_d, count, segs, ss, widths,
                                      host_targets, n)

    return collect


def bo_window_saliency_multi(
    engine: SaliencyEngine,
    images,
    segments_list,
    cfg: BOConfig = BOConfig(),
    window_fraction: float = 0.4,
    seed: int = 0,
    targets=None,
    proposals_per_iter: int = 1,
    per_image_seeds=None,
    mesh=None,
    data_axis: str = "data",
):
    """Fused BO saliency over N same-shape images in one program: dispatch
    and collect at once (see :func:`bo_window_saliency_multi_async`).
    Returns a list of N (SaliencyOutput, BOResult) pairs."""
    return bo_window_saliency_multi_async(
        engine, images, segments_list, cfg, window_fraction=window_fraction, seed=seed,
        targets=targets, proposals_per_iter=proposals_per_iter,
        per_image_seeds=per_image_seeds, mesh=mesh, data_axis=data_axis)()
