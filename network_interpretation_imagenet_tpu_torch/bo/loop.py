"""GP-EI Bayesian optimization over the window start (port of ``bo/loop.py``
of the JAX package).

Two drivers:

  * :func:`bayesian_optimize`, the host loop over a user-supplied batched
    objective. Its random draws come from ``np.random.RandomState(seed)``
    exactly as in the JAX package, so the two packages draw the same numbers;
    each proposal (GP sweep + EI argmax) runs on the given device.
  * :class:`FusedWindowBO` (``make_fused_window_bo``), the whole
    active-learning loop as one device program: observations in fixed-size
    device buffers, the GP a carried inverse-Cholesky state per lengthscale
    (``gp.exact.incremental_*``), an exact EI argmax over all candidates, the
    duplicate → resample rule, and each batch of starts evaluated through B1
    (``ops.masked_batch``) and the classifier. Nothing in it waits for the
    device: the observation count at iteration i is ``n_pre + i·q``, known to
    the host, so every buffer index is a Python int, and the random integers
    come in as one tensor (:func:`window_draws`). On the card the program is
    captured once per input shape as one CUDA graph and replayed.

With a mesh (``parallel.make_mesh``) the fused loop shards over its data
axis in one of two ways, as in the JAX package. One image: each batch of
starts (the pre-samples, each iteration's q proposals) pads with 0 to a
multiple of the data-axis size, each rank evaluates its slice, and an
all-gather gives every rank all outcomes; the GP refit and the proposals
replicate. That loop has a collective inside, so it runs eagerly on the card
under every backend, with no CUDA graph: gloo's collectives cannot be
captured, and NCCL's would tie a graph to one communicator. N images
(``batch_images``): each rank runs its N/d loops with no collective inside,
as one CUDA graph on the card at any world size, and one all-gather after
the loop brings every rank all N traces.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.bo.acquisition import (
    ei_over_candidates,
    expected_improvement,
)
from network_interpretation_imagenet_tpu_torch.config import BOConfig
from network_interpretation_imagenet_tpu_torch.device import resolve_device
from network_interpretation_imagenet_tpu_torch.gp import exact
from network_interpretation_imagenet_tpu_torch.gp.kernels import full_f32
from network_interpretation_imagenet_tpu_torch.ops.masked_batch import masked_batch
from network_interpretation_imagenet_tpu_torch.parallel.mesh import (
    all_gather_rows,
    axis_size,
    shard_batch,
)
from network_interpretation_imagenet_tpu_torch.saliency.engine import outcomes
from network_interpretation_imagenet_tpu_torch.utils import logging as trace

LENGTHSCALE_GRID = BOConfig.lengthscale_grid
MAX_GRAPHS = 4   # input shapes whose CUDA graph a runner keeps; the least recently used goes


@dataclasses.dataclass
class BOResult:
    xp: np.ndarray        # [n_obs] sampled start indices (order of evaluation)
    yp: np.ndarray        # [n_obs] objective values (target-class prob)
    survived: np.ndarray  # bool[n_obs] per-sample survive labels


# ---------------------------------------------------------------------------
# Host-driven general loop
# ---------------------------------------------------------------------------


def bayesian_optimize(
    objective: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]],
    upper: int,
    n_pre_samples: int = 3,
    n_iters: int = 10,
    seed: int = 0,
    alpha: float = 1e-5,
    epsilon: float = 1e-7,
    lengthscale_grid=LENGTHSCALE_GRID,
    device=None,
) -> BOResult:
    """Maximize ``objective`` over integer starts in [0, upper] (inclusive).

    ``objective(indices int[K]) -> (scores f32[K], survived bool[K])``; the
    pre-samples go in as one batch. The proposals run on ``device`` (the
    card unless ``"cpu"`` is given)."""
    rng = np.random.RandomState(seed)
    pre = rng.randint(0, upper + 1, size=n_pre_samples)
    scores, survived = objective(pre)
    xs = list(pre.tolist())
    ys = list(np.asarray(scores, np.float64).tolist())
    labels = list(np.asarray(survived, bool).tolist())

    propose = _host_propose_fn(upper, tuple(lengthscale_grid), float(alpha),
                               resolve_device(device))
    for _ in range(n_iters):
        nxt = propose(xs, ys)
        # Duplicate -> random resample (reference BO.py:178-180).
        if np.any(np.abs(np.asarray(xs) - nxt) <= epsilon):
            nxt = int(rng.randint(0, upper + 1))
        s, lab = objective(np.asarray([nxt]))
        xs.append(nxt)
        ys.append(float(s[0]))
        labels.append(bool(lab[0]))

    return BOResult(xp=np.asarray(xs), yp=np.asarray(ys), survived=np.asarray(labels))


def _host_propose_fn(upper: int, lengthscale_grid: tuple, alpha: float, device: torch.device):
    """GP refit (lengthscale sweep) + EI argmax over the candidates
    0..upper. The JAX package pads the candidates to a power of two for its
    compile cache and masks the pad with -inf; the argmax is the same
    without the pad."""
    candidates = torch.arange(upper + 1, dtype=torch.float32, device=device)[:, None]
    ls_grid = torch.tensor(lengthscale_grid, dtype=torch.float32, device=device)

    def propose(xs, ys) -> int:
        x_obs = torch.tensor(xs, dtype=torch.float32).to(device)
        y_obs = torch.tensor(ys, dtype=torch.float32).to(device)
        fit = exact.fit_lengthscale_sweep(x_obs[:, None], y_obs, ls_grid, noise=alpha,
                                          normalize_y=True)
        ei = ei_over_candidates(fit, candidates, y_obs, greater_is_better=True)
        return int(torch.argmax(ei))

    return propose


# ---------------------------------------------------------------------------
# The fused on-device loop
# ---------------------------------------------------------------------------


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (min 8): the candidate count of a fused
    runner, so images with nearby segment counts share one runner."""
    return max(8, 1 << (max(int(n), 1) - 1).bit_length())


def window_draws(generator: torch.Generator, upper: int, count: int) -> torch.Tensor:
    """int64[count], uniform in [0, upper], from a CPU generator: the fused
    loop's random integers, the pre-samples first, then one resample value
    per (iteration, proposal)."""
    return torch.randint(0, int(upper) + 1, (int(count),), generator=generator)


OutcomesFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


class FusedWindowBO:
    """The fused BO runner of one static configuration (``max_candidates``
    bounds the starts; candidates above each image's ``upper`` are masked
    out). Build it once and reuse it across images.

    ``outcomes_fn(images[B, H, W, C], targets int64[B]) -> (prob_target
    f32[B], survived bool[B])`` runs the classifier on a masked batch in
    ``compute_dtype``, on the device, without a host copy.

    Called as ``run(image, segments, width, target, upper, draws)``, or with
    ``batch_images=True`` as ``run(images[N], segments[N], widths (N ints),
    targets[N], uppers[N], draws[N, D])``: N independent loops whose
    forwards batch N·q masked images, each image's slice written by its own
    B1 launch. ``draws`` holds ``n_pre_samples + n_iters·q`` integers in
    [0, upper] per image (:func:`window_draws`). Returns ``(xs, ys,
    survived, count)``: device tensors of ``count`` observations in
    evaluation order ([N, count] when batched) and the int ``count``.

    On the card the first call of each input shape
    runs the program eagerly and returns its result; that run loads the
    kernels, makes the shared-memory opt-ins and warms the cuDNN and cuBLAS
    handles. The second call of that shape captures the program as one CUDA
    graph, and it and every later call replay the graph on a copy of their
    inputs. The windows' widths, like every other per-image value, are device
    inputs (B1 reads its width on the device), so one graph serves all images
    of a shape, and a one-shot call costs one eager run and no capture. A
    runner keeps the graphs of its last ``MAX_GRAPHS`` shapes. A failed
    capture raises. On the CPU the program runs eagerly (``cuda_graph``
    is False). Traced as spans ``bo.upload`` (the input copies), then
    ``bo.replay`` (the static inputs' copies and the replay), or ``bo.eager``
    or ``bo.capture``.

    ``mesh``: the collective runner of every rank (same inputs on each; see
    the module docstring). With ``batch_images`` the image count must split
    over the data axis (``bo_window_saliency_multi`` pads it); without, the
    starts of each forward shard and the runner never captures a graph."""

    def __init__(self, outcomes_fn: OutcomesFn, max_candidates: int, n_pre_samples: int = 3,
                 n_iters: int = 10, alpha: float = 1e-5, epsilon: float = 1e-7,
                 lengthscale_grid=LENGTHSCALE_GRID, proposals_per_iter: int = 1,
                 batch_images: bool = False, compute_dtype: torch.dtype = torch.float32,
                 device=None, mesh=None, data_axis: str = "data") -> None:
        self.device = resolve_device(device)
        self.mesh, self.data_axis = mesh, data_axis
        # One image on a mesh: the starts of each forward shard over it.
        self.proposal_mesh = None if batch_images else mesh
        self.outcomes_fn = outcomes_fn
        self.n_pre, self.n_iters = int(n_pre_samples), int(n_iters)
        self.q = int(proposals_per_iter)
        self.max_obs = self.n_pre + self.n_iters * self.q
        self.alpha, self.epsilon = float(alpha), float(epsilon)
        self.batch_images = batch_images
        self.compute_dtype = compute_dtype
        self.cuda_graph = self.device.type == "cuda" and self.proposal_mesh is None
        self.ls_grid = torch.tensor(lengthscale_grid, dtype=torch.float32, device=self.device)
        self.cand = torch.arange(max_candidates, dtype=torch.float32, device=self.device)
        # input shapes -> None (run once, eagerly) or (CUDAGraph, static inputs, static outputs)
        self.graphs = collections.OrderedDict()

    @torch.inference_mode()
    def __call__(self, images, segments, widths, targets, uppers, draws):
        if not self.batch_images:
            images, segments, widths, targets, uppers, draws = (
                torch.as_tensor(t)[None]
                for t in (images, segments, widths, targets, uppers, draws))
        dev = self.device
        with trace.span("bo.upload"):
            inputs = (torch.as_tensor(images).to(dev, torch.float32).contiguous(),
                      torch.as_tensor(segments).to(dev, torch.int32).contiguous(),
                      torch.as_tensor(np.asarray(widths)).to(dev, torch.int32).reshape(-1),
                      torch.as_tensor(targets).to(dev, torch.int64).reshape(-1),
                      torch.as_tensor(uppers).to(dev, torch.float32).reshape(-1),
                      torch.as_tensor(draws).to(dev, torch.float32))
        if len({t.shape[0] for t in inputs}) != 1:
            raise ValueError("fused BO: images, segments, widths, targets, uppers and draws "
                             "must have one entry per image")
        if inputs[5].shape[1] != self.max_obs:
            raise ValueError(f"fused BO: {inputs[5].shape[1]} draws per image, need "
                             f"{self.max_obs} (n_pre_samples + n_iters * q)")
        if self.batch_images and self.mesh is not None:
            # Image sharding: this rank's loops, then one all-gather.
            local = tuple(shard_batch(self.mesh, t, self.data_axis) for t in inputs)
            out = self._on_card(local) if self.cuda_graph else self._eager(local)
            xs, ys, survived = all_gather_rows(self.mesh, list(out), self.data_axis,
                                               fingerprint=inputs)
            return xs, ys, survived, self.max_obs
        xs, ys, survived = self._on_card(inputs) if self.cuda_graph else self._eager(inputs)
        if not self.batch_images:
            xs, ys, survived = xs[0], ys[0], survived[0]
        return xs, ys, survived, self.max_obs

    def _eager(self, inputs):
        """The program run outside a graph: span ``bo.eager``."""
        with trace.span("bo.eager"):
            return self._program(*inputs)

    def _on_card(self, inputs):
        key = tuple(tuple(t.shape) for t in inputs)
        if key not in self.graphs:
            self.graphs[key] = None
            while len(self.graphs) > MAX_GRAPHS:
                self.graphs.popitem(last=False)
            return self._eager(inputs)
        self.graphs.move_to_end(key)
        if self.graphs[key] is None:
            with trace.span("bo.capture"):
                static = tuple(t.clone() for t in inputs)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    out = self._program(*static)
                self.graphs[key] = (graph, static, out)
        graph, static, out = self.graphs[key]
        with trace.span("bo.replay"):
            for s, t in zip(static, inputs):
                s.copy_(t)
            graph.replay()
        # Copies, so a later call's replay cannot overwrite what this one returned.
        return tuple(t.clone() for t in out)

    def _program(self, images, segments, widths, targets, uppers, draws):
        """The loop on [N]-batched device tensors; no host synchronisation
        (but for the all-gathers of a proposal mesh)."""
        n, h, w, c = images.shape
        m, q, dev = self.max_obs, self.q, self.device
        xs = torch.zeros((n, m), device=dev)
        ys = torch.zeros((n, m), device=dev)
        survived = torch.zeros((n, m), dtype=torch.bool, device=dev)
        gp = exact.incremental_init(m, (n, self.ls_grid.shape[0]), device=dev)
        cand_ok = self.cand[None, :] <= uppers[:, None]
        count = 0

        def forward(firsts):
            """[N, k] starts -> (prob_target, survived) [N, k], one forward."""
            k = firsts.shape[1]
            f = firsts.to(torch.int32).contiguous()
            batch = torch.empty((n * k, h, w, c), dtype=self.compute_dtype, device=dev)
            for i in range(n):
                masked_batch(images[i], segments[i], f[i], widths[i:i + 1], self.compute_dtype,
                             out=batch[i * k:(i + 1) * k])
            prob, surv = self.outcomes_fn(batch, targets[:, None].expand(n, k).reshape(-1))
            return prob.view(n, k), surv.view(n, k)

        def eval_starts(firsts):
            """:func:`forward`, or on a proposal mesh: the starts padded with
            0 to a multiple of the data axis, this rank's slice evaluated,
            every slice gathered and the pad trimmed."""
            if self.proposal_mesh is None:
                return forward(firsts)
            k = firsts.shape[1]
            d = axis_size(self.proposal_mesh, self.data_axis)
            total = -(-k // d) * d
            f = torch.cat([firsts, firsts.new_zeros((n, total - k))], dim=1)
            cols = shard_batch(self.proposal_mesh, torch.arange(total, device=dev),
                               self.data_axis)
            prob, surv = forward(f[:, cols])
            prob_all, surv_all = all_gather_rows(self.proposal_mesh, [prob.T, surv.T],
                                                 self.data_axis, fingerprint=(f, targets))
            return prob_all.T[:, :k], surv_all.T[:, :k]

        def record_batch(xs_new):
            nonlocal gp, count
            probs, survs = eval_starts(xs_new)
            for j in range(xs_new.shape[1]):
                xs[:, count] = xs_new[:, j]
                gp = exact.incremental_add(gp, xs[:, None, :], count, xs_new[:, j, None],
                                           self.ls_grid, self.alpha)
                ys[:, count] = probs[:, j]
                survived[:, count] = survs[:, j]
                count += 1

        def propose():
            ei = fused_ei(gp, xs, ys, count, self.cand, self.ls_grid, cand_ok)
            if q == 1:
                return torch.argmax(ei, dim=1, keepdim=True).float()
            # lax.top_k's order: ties go to the lower index.
            return torch.sort(ei, dim=1, descending=True, stable=True).indices[:, :q].float()

        record_batch(draws[:, :self.n_pre])  # all pre-samples: one forward
        for it in range(self.n_iters):
            proposals = propose()
            # Sequential dedup (duplicate -> the next random value), also
            # against the proposals already taken this round.
            active = torch.arange(m, device=dev) < count
            chosen = torch.full((n, q), -1.0, device=dev)
            for j in range(q):
                prop = proposals[:, j:j + 1]
                dup = torch.any(active & (torch.abs(prop - xs) <= self.epsilon), dim=1)
                if j:
                    dup |= torch.any(torch.abs(prop - chosen[:, :j]) <= self.epsilon, dim=1)
                chosen[:, j] = torch.where(dup, draws[:, self.n_pre + it * q + j], prop[:, 0])
            record_batch(chosen)
        return xs, ys, survived


def fused_ei(gp: exact.IncrementalGPState, xs: torch.Tensor, ys: torch.Tensor, count: int,
             cand: torch.Tensor, ls_grid: torch.Tensor, cand_ok: torch.Tensor) -> torch.Tensor:
    """The fused loop's acquisition step for N loops: EI f32[N, C] of every
    candidate given the first ``count`` observations of the buffers ``xs``,
    ``ys`` [N, M] and the carried GP state [N, L, M, M] (-inf where
    ``cand_ok`` is False). The targets are normalized over the valid slots
    (variance floor 1e-12); each loop takes the MLL-argmax lengthscale."""
    n = xs.shape[0]
    valid = (torch.arange(xs.shape[1], device=xs.device) < count).float()
    cnt = torch.clamp(torch.sum(valid), min=1.0)
    mean = torch.sum(ys * valid, dim=1, keepdim=True) / cnt
    var = torch.sum(valid * (ys - mean) ** 2, dim=1, keepdim=True) / cnt
    std = torch.sqrt(torch.clamp(var, min=1e-12))
    std = torch.where(std > 0, std, torch.ones_like(std))
    yn = (ys - mean) / std * valid
    with full_f32():   # one whitened-target matvec per lengthscale, shared by MLL and posterior
        us = (gp.linv @ yn[:, None, :, None])[..., 0]
    mlls = exact.incremental_mll(gp, yn[:, None, :], count, u=us)
    mu_all, sigma_all = exact.incremental_predict(gp, xs[:, None, :], valid, yn[:, None, :],
                                                  cand, ls_grid, u=us)
    best = exact.nanargmax(mlls, dim=1)[:, None, None].expand(n, 1, cand.shape[0])
    mu, sigma = mu_all.gather(1, best)[:, 0], sigma_all.gather(1, best)[:, 0]
    y_obs = torch.where(valid > 0, yn, -torch.inf)
    ei = expected_improvement(mu, sigma, y_obs, greater_is_better=True)
    return torch.where(cand_ok, ei, -torch.inf)


# The JAX package's name for building a runner.
make_fused_window_bo = FusedWindowBO


def logits_outcomes(logits_fn: Callable[[torch.Tensor], torch.Tensor]) -> OutcomesFn:
    """An ``outcomes_fn`` from a function of images to logits: f32 softmax
    probability of the target and argmax == target."""

    def fn(images, targets):
        out = outcomes(logits_fn(images), targets)
        return out[2], out[0] > 0.5

    return fn


def fused_window_bo(logits_fn: Callable[[torch.Tensor], torch.Tensor], image, segments,
                    width: int, target: int, upper: int, max_candidates: int,
                    n_pre_samples: int = 3, n_iters: int = 10,
                    draws: Optional[torch.Tensor] = None, alpha: float = 1e-5,
                    epsilon: float = 1e-7, lengthscale_grid: Sequence[float] = LENGTHSCALE_GRID,
                    proposals_per_iter: int = 1, device=None):
    """One-shot convenience wrapper around :class:`FusedWindowBO`, which
    runs a runner's first call eagerly (callers looping over images build the
    runner once).
    ``draws=None`` takes them from a generator seeded with 0."""
    if draws is None:
        draws = window_draws(torch.Generator().manual_seed(0), upper,
                             n_pre_samples + n_iters * proposals_per_iter)
    run = make_fused_window_bo(logits_outcomes(logits_fn), max_candidates,
                               n_pre_samples=n_pre_samples, n_iters=n_iters, alpha=alpha,
                               epsilon=epsilon, lengthscale_grid=lengthscale_grid,
                               proposals_per_iter=proposals_per_iter, device=device)
    return run(image, segments, width, target, upper, draws)
