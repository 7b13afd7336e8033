"""Learned-mask saliency (Fong & Vedaldi, ICCV 2017, "meaningful
perturbations"): port of ``saliency/learned_mask.py`` of the JAX package.

Find the smallest soft deletion mask that destroys the target prediction,

    min_m  l1 * mean(1 - m) + tv * TV_beta(m) + E_shift[ p_target(Phi(x, m)) ]

with m = sigmoid(p) on a low-res grid (bilinearly upsampled), Phi(x, m) =
m * x + (1 - m) * baseline (the Gaussian-blurred image, or zeros), and the
expectation over ``jitter`` random integer shifts of the upsampled mask.
Each Adam step is one forward and backward of the ``jitter`` shifted images
through ``logits_fn`` (normally ``bundle.logits``, the plain module) on the
weights' device; Adam is optax's (``gp.kron.adam_step``). The shifts come
from a CPU ``torch.Generator`` seeded with ``seed``
(:func:`learned_mask_shifts`), or from the caller (``shifts=``): JAX's
``jax.random`` stream cannot be reproduced, so its tests hand it in.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from network_interpretation_imagenet_tpu_torch.gp.kron import adam_step
from network_interpretation_imagenet_tpu_torch.ops.resize import resize_bilinear
from network_interpretation_imagenet_tpu_torch.saliency.gradient import (
    _image_batch_scaffold,
    as_image,
    variables_device,
)


def gaussian_blur(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of f32 [H, W, C] (zero 'SAME' padding, kernel
    truncated at 2 sigma): the perturbation baseline of the paper."""
    image = image.float()
    radius = max(int(round(2.0 * sigma)), 1)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=image.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / torch.sum(k)
    img = image.permute(2, 0, 1)[:, None]            # [C, 1, H, W]
    out = F.conv2d(img, k[None, None, :, None], padding=(radius, 0))
    out = F.conv2d(out, k[None, None, None, :], padding=(0, radius))
    return out[:, 0].permute(1, 2, 0)


@dataclass(frozen=True)
class LearnedMaskResult:
    heatmap: np.ndarray        # f32[H, W] = 1 - m_up: deleted = important
    mask_lowres: np.ndarray    # f32[mask_size, mask_size], keep-fraction m
    prob_original: float       # p_target(x)
    prob_masked: float         # p_target(Phi(x, m)) at the learned mask
    final_loss: float


def learned_mask_shifts(seed: int, iters: int, jitter: int, max_shift: int) -> torch.Tensor:
    """The per-step integer shifts, int64 [iters, jitter, 2] uniform in
    [-max_shift, max_shift], from a CPU ``torch.Generator``."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(-int(max_shift), int(max_shift) + 1, (int(iters), int(jitter), 2),
                         generator=gen)


def _check(mask_size, iters, jitter, max_shift, baseline):
    if mask_size <= 0 or iters <= 0:
        raise ValueError(f"mask_size/iters must be positive, got {mask_size}/{iters}")
    if jitter < 0 or max_shift < 0:
        raise ValueError(f"jitter/max_shift must be >= 0, got {jitter}/{max_shift}")
    if baseline not in ("blur", "zero"):
        raise ValueError(f"baseline must be 'blur' or 'zero', got {baseline!r}")


def _optimize(logits_fn, variables, image: torch.Tensor, base_img: torch.Tensor, target: int,
              mask_size: int, iters: int, lr: float, l1: float, tv: float, tv_beta: float,
              shifts: torch.Tensor, compute_dtype):
    """The Adam loop of one image: (m f32 [s, s], p_orig, p_masked, last loss)
    as device tensors. ``shifts`` int [iters, J, 2] (host)."""
    h, w = int(image.shape[0]), int(image.shape[1])
    shift_list = [[tuple(int(v) for v in s) for s in step] for step in shifts.tolist()]

    def probs(imgs):
        logits = logits_fn(variables, imgs.to(compute_dtype)).float()
        return torch.softmax(logits, dim=-1)[:, target]

    def masked_prob(p, step_shifts):
        m = torch.sigmoid(p)
        m_up = resize_bilinear(m, (h, w))
        ms = torch.stack([torch.roll(m_up, s, dims=(0, 1)) for s in step_shifts])[..., None]
        return torch.mean(probs(ms * image + (1.0 - ms) * base_img)), m

    def loss_fn(p, step_shifts):
        prob, m = masked_prob(p, step_shifts)
        dy = torch.abs(torch.diff(m, dim=0)) ** tv_beta
        dx = torch.abs(torch.diff(m, dim=1)) ** tv_beta
        tv_term = (torch.sum(dy) + torch.sum(dx)) / (dy.numel() + dx.numel())
        return prob + l1 * torch.mean(1.0 - m) + tv * tv_term

    p = torch.zeros((mask_size, mask_size), dtype=torch.float32, device=image.device) + 2.0
    state: dict = {}
    loss = torch.zeros((), device=image.device)
    with torch.enable_grad():
        for i in range(iters):
            p = p.detach().requires_grad_(True)
            loss = loss_fn(p, shift_list[i])
            (g,) = torch.autograd.grad(loss, p)
            (p,) = adam_step([p.detach()], [g], state, lr)
    with torch.no_grad():
        m = torch.sigmoid(p)
        p_orig = probs(image[None])[0]
        p_masked, _ = masked_prob(p, [(0, 0)])
    return m, p_orig, p_masked, loss.detach()


def learned_mask_saliency(logits_fn: Callable, variables: Any, image, target: int,
                          mask_size: int = 28, iters: int = 150, lr: float = 0.1,
                          l1: float = 0.05, tv: float = 0.1, tv_beta: float = 3.0,
                          jitter: int = 4, max_shift: int = 4, baseline: str = "blur",
                          blur_sigma: float = 10.0, seed: int = 0,
                          compute_dtype: torch.dtype = torch.float32,
                          shifts=None) -> LearnedMaskResult:
    """Optimize a low-res deletion mask for one image (see the module doc).
    ``jitter=0`` is one unshifted forward per step; ``baseline`` is
    ``"blur"`` (the paper's) or ``"zero"`` (this framework's masked-pixel
    value). ``shifts`` [iters, J, 2] replaces the seeded draws."""
    heats, ms, p_orig, p_masked, losses = learned_mask_batch_dispatch(
        logits_fn, variables, as_image(image, variables_device(variables))[None], [target],
        mask_size=mask_size, iters=iters, lr=lr, l1=l1, tv=tv, tv_beta=tv_beta, jitter=jitter,
        max_shift=max_shift, baseline=baseline, blur_sigma=blur_sigma, seeds=[seed],
        compute_dtype=compute_dtype, shifts=None if shifts is None else [shifts])
    return LearnedMaskResult(heatmap=heats[0].cpu().numpy(), mask_lowres=ms[0].cpu().numpy(),
                             prob_original=float(p_orig[0]), prob_masked=float(p_masked[0]),
                             final_loss=float(losses[0]))


def learned_mask_batch_dispatch(logits_fn: Callable, variables: Any, images, targets,
                                mask_size: int = 28, iters: int = 150, lr: float = 0.1,
                                l1: float = 0.05, tv: float = 0.1, tv_beta: float = 3.0,
                                jitter: int = 4, max_shift: int = 4, baseline: str = "blur",
                                blur_sigma: float = 10.0, seeds=None,
                                compute_dtype: torch.dtype = torch.float32, shifts=None):
    """N learned-mask optimizations, one image after another, left on the
    device: ``(heatmaps f32[N, H, W], masks f32[N, s, s], prob_orig f32[N],
    prob_masked f32[N], loss f32[N])``. ``seeds`` (default zeros) give each
    image the shifts of ``learned_mask_saliency(seed=...)``; ``shifts`` (a
    list of N [iters, J, 2]) replaces them."""
    _check(mask_size, iters, jitter, max_shift, baseline)
    dev = variables_device(variables)
    images, targets, seeds, n = _image_batch_scaffold(images, targets, seeds, dev)
    h, w = int(images.shape[1]), int(images.shape[2])
    if n == 0:
        z = torch.zeros((0,), dtype=torch.float32, device=dev)
        return (torch.zeros((0, h, w), dtype=torch.float32, device=dev),
                torch.zeros((0, mask_size, mask_size), dtype=torch.float32, device=dev), z, z, z)
    # jitter 0 is one unshifted copy, as in the JAX package.
    n_jit, n_shift = (max(int(jitter), 1), int(max_shift)) if jitter else (1, 0)
    outs = []
    for i in range(n):
        sh = (learned_mask_shifts(seeds[i], iters, n_jit, n_shift) if shifts is None
              else torch.as_tensor(np.asarray(shifts[i])))
        base = gaussian_blur(images[i], blur_sigma) if baseline == "blur" else \
            torch.zeros_like(images[i])
        m, p_orig, p_masked, loss = _optimize(
            logits_fn, variables, images[i], base, int(targets[i]), int(mask_size), int(iters),
            float(lr), float(l1), float(tv), float(tv_beta), sh, compute_dtype)
        outs.append((1.0 - resize_bilinear(m, (h, w)), m, p_orig, p_masked, loss))
    return tuple(torch.stack(t) for t in zip(*outs))


def learned_mask_saliency_batch(logits_fn: Callable, variables: Any, images, targets,
                                **kwargs) -> list:
    """N images' :class:`LearnedMaskResult`\\ s (:func:`learned_mask_batch_dispatch`
    and one copy to the host)."""
    heats, ms, p_orig, p_masked, losses = (t.cpu().numpy() for t in learned_mask_batch_dispatch(
        logits_fn, variables, images, targets, **kwargs))
    return [LearnedMaskResult(heatmap=heats[i], mask_lowres=ms[i],
                              prob_original=float(p_orig[i]), prob_masked=float(p_masked[i]),
                              final_loss=float(losses[i])) for i in range(len(heats))]
