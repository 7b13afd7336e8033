"""Gradient-, occlusion-, RISE- and CAM-based saliency (port of
``saliency/gradient.py`` of the JAX package).

Every function keeps the JAX package's ``(logits_fn, variables, image,
target)`` signature (the CAMs take the bundle in place of ``logits_fn``).
``variables`` is a state dict; the computation runs on its tensors' device
(an engine's ``variables`` live on the engine's device), and maps come back
as f32 tensors there.

- The gradient methods (``input_gradient``, ``grad_times_input``,
  ``integrated_gradients``, ``smoothgrad``) differentiate ``logits_fn``,
  normally ``bundle.logits``: the plain module, as the JAX package
  differentiates its plain flax model (B2 has no backward kernel there).
  Eval-mode images are independent, so the per-image gradients of a stack
  are one backward of the summed target logits.
- The mask-batched methods (``occlusion_map``, ``rise_map``) take
  ``logits_fn`` for their masked forwards in ``compute_dtype``, normally
  ``engine.folded_logits``: the engine's plan (for an ImageNet ResNet the
  folded net, B2 on the card). ``scorecam`` takes it as ``logits_fn=``
  (default ``bundle.logits``, the plain module, as the JAX package's
  Score-CAM applies its flax module).
- ``gradcam`` and ``scorecam`` find their layer by forward hooks on the
  plain module's submodules, named by the flax paths of the JAX package
  (``layer4_2``, ``layer4_2/conv3``, ``Mixed_7c/branch_pool/bn``,
  ``features_18/0``, ...: each module's ``flax_paths()``, mapped by its
  ``torch_name``), so ``--gradcam-layer`` takes the same strings in both
  packages and the default layer is the same for every arch. Grad-CAM's
  gradient is taken w.r.t. a zero ``delta`` added to the hooked output.

Random draws (SmoothGrad's noise, RISE's cells and offsets) come from a CPU
``torch.Generator`` seeded with ``seed`` (:func:`smoothgrad_noise`,
:func:`rise_draws`), or from the caller (``noise=``, ``draws=``): the JAX
package's ``jax.random`` streams cannot be reproduced, so its tests hand
them in. The JAX package pads mask chunks and image batches to reuse
compiled shapes and caches its compiled programs (``_mask_cfg_key``, the
default gradcam layer per shape); eager PyTorch compiles nothing, so nothing
is padded or cached and the last chunk holds the remainder.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Optional

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.ops.resize import resize_bilinear
from network_interpretation_imagenet_tpu_torch.parallel.mesh import map_sharded


def variables_device(variables) -> torch.device:
    """The device the weights live on, where an attribution runs."""
    return next(iter(variables.values())).device


def as_image(image, device) -> torch.Tensor:
    """A host array or a tensor as f32 on ``device``."""
    if isinstance(image, torch.Tensor):
        return image.to(device, torch.float32)
    return torch.from_numpy(np.ascontiguousarray(image, np.float32)).to(device)


def _one_target(target, device) -> torch.Tensor:
    return torch.tensor([int(target)], dtype=torch.int64, device=device)


def _target_grads(logits_fn: Callable, variables: Any, x: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """∂ logit_{targets[i]} / ∂ x[i] for every image of the stack ``x``, in one
    backward of the summed target logits."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        logits = logits_fn(variables, x).float()
        out = logits.gather(1, targets.reshape(-1, 1)).sum()
        (g,) = torch.autograd.grad(out, x)
    return g


def _grad_mean(logits_fn, variables, stacks: torch.Tensor, targets: torch.Tensor, chunk,
               square: bool = False) -> torch.Tensor:
    """Mean over axis 1 of the gradients of ``stacks`` [N, S, H, W, C] (image
    ``i``'s stack w.r.t. ``targets[i]``) -> [N, H, W, C].

    ``chunk=None`` (or ≥ S) runs one backward over all N·S images; otherwise
    S/``chunk`` backwards of N·``chunk`` images accumulate the sum exactly (the
    gradients combine linearly), which bounds live activations."""
    n, s = int(stacks.shape[0]), int(stacks.shape[1])
    shape = stacks.shape[2:]
    rep = targets.repeat_interleave(s if chunk is None or int(chunk) >= s else int(chunk))
    if chunk is None or int(chunk) >= s:
        g = _target_grads(logits_fn, variables, stacks.reshape(n * s, *shape), rep)
        g = g.reshape(n, s, *shape)
        return torch.mean(g ** 2 if square else g, dim=1)
    chunk = int(chunk)
    if s % chunk:
        raise ValueError(f"chunk {chunk} must divide the step/sample count {s}")
    acc = torch.zeros((n, *shape), dtype=torch.float32, device=stacks.device)
    for off in range(0, s, chunk):
        g = _target_grads(logits_fn, variables,
                          stacks[:, off:off + chunk].reshape(n * chunk, *shape), rep)
        g = g.reshape(n, chunk, *shape)
        acc = acc + torch.sum(g ** 2 if square else g, dim=1)
    return acc / s


# --- gradient methods --------------------------------------------------------------


def _gradient_batch(logits_fn, variables, images: torch.Tensor, targets: torch.Tensor,
                    times_input: bool) -> torch.Tensor:
    g = _target_grads(logits_fn, variables, images, targets)
    return torch.sum(torch.abs(g * images if times_input else g), dim=-1)


def input_gradient(logits_fn: Callable, variables: Any, image, target: int) -> torch.Tensor:
    """|∂ logit_t / ∂ x| summed over channels -> f32[H, W]."""
    dev = variables_device(variables)
    return _gradient_batch(logits_fn, variables, as_image(image, dev)[None],
                           _one_target(target, dev), False)[0]


def grad_times_input(logits_fn: Callable, variables: Any, image, target: int) -> torch.Tensor:
    """|grad ⊙ input| summed over channels -> f32[H, W]."""
    dev = variables_device(variables)
    return _gradient_batch(logits_fn, variables, as_image(image, dev)[None],
                           _one_target(target, dev), True)[0]


def _integrated_batch(logits_fn, variables, images, targets, steps, baseline, step_batch):
    base = torch.zeros_like(images) if baseline is None else as_image(
        baseline, images.device).expand_as(images)
    alphas = (torch.arange(steps, dtype=torch.float32, device=images.device) + 0.5) / steps
    path = base[:, None] + alphas[None, :, None, None, None] * (images - base)[:, None]
    avg = _grad_mean(logits_fn, variables, path, targets, step_batch)
    return torch.sum(torch.abs((images - base) * avg), dim=-1)


def integrated_gradients(logits_fn: Callable, variables: Any, image, target: int,
                         steps: int = 16, baseline=None,
                         step_batch: Optional[int] = None) -> torch.Tensor:
    """Integrated gradients along the straight path from ``baseline``
    (default zeros, the masked-pixel value of this framework) at the
    midpoints of ``steps`` intervals. One backward over all steps;
    ``step_batch`` bounds memory by exact accumulation (:func:`_grad_mean`)."""
    dev = variables_device(variables)
    return _integrated_batch(logits_fn, variables, as_image(image, dev)[None],
                             _one_target(target, dev), int(steps), baseline, step_batch)[0]


def smoothgrad_noise(seed: int, samples: int, shape) -> torch.Tensor:
    """Standard normal draws [samples, *shape] from a CPU ``torch.Generator``
    seeded with ``seed`` (the port's stand-in for ``jax.random.normal``)."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn((int(samples), *shape), generator=gen)


def _smoothgrad_batch(logits_fn, variables, images, targets, samples, noise_sigma, seeds,
                      magnitude, sample_batch, noises=None):
    dev = images.device
    span = torch.clamp(images.amax(dim=(1, 2, 3)) - images.amin(dim=(1, 2, 3)), min=1e-6)
    if noises is None:
        noises = torch.stack([smoothgrad_noise(s, samples, images.shape[1:]) for s in seeds])
    noise = noises.to(dev, torch.float32) * noise_sigma * span[:, None, None, None, None]
    g = _grad_mean(logits_fn, variables, images[:, None] + noise, targets, sample_batch,
                   square=magnitude)
    return torch.sum(torch.abs(g), dim=-1)


def smoothgrad(logits_fn: Callable, variables: Any, image, target: int, samples: int = 16,
               noise_sigma: float = 0.15, seed: int = 0, magnitude: bool = False,
               sample_batch: Optional[int] = None, noise=None) -> torch.Tensor:
    """SmoothGrad (Smilkov et al., 2017): the input gradient averaged over
    Gaussian-noised copies; ``noise_sigma`` is relative to the image's value
    range. ``magnitude=True`` averages squared gradients (SmoothGrad²).
    ``noise`` [samples, H, W, C] replaces the seeded standard normal draws."""
    dev = variables_device(variables)
    img = as_image(image, dev)
    noises = None if noise is None else torch.as_tensor(noise)[None]
    return _smoothgrad_batch(logits_fn, variables, img[None], _one_target(target, dev),
                             int(samples), float(noise_sigma), [int(seed)], bool(magnitude),
                             sample_batch, noises)[0]


# --- mask-batched methods -----------------------------------------------------------


def occlusion_positions(h: int, w: int, patch, stride):
    """(patch, stride, positions int32 [K, 2]) with occlusion's adaptive
    defaults: ``patch=None`` is 32 at 224² scaled to the image side, floor 4
    (a fixed 32 on a 32x32 image admits one position: a constant map);
    ``stride=None`` is ``patch // 2``."""
    if patch is None:
        patch = max(4, int(round(32 * min(int(h), int(w)) / 224.0)))
    if stride is None:
        stride = max(1, patch // 2)
    ys = np.arange(0, h - patch + 1, stride, dtype=np.int32)
    xs = np.arange(0, w - patch + 1, stride, dtype=np.int32)
    pos = np.stack(np.meshgrid(ys, xs, indexing="ij"), -1).reshape(-1, 2)
    if len(pos) == 0:
        # Zero positions would silently return an all-zero heatmap.
        raise ValueError(f"patch {patch} exceeds the {h}x{w} image — no occlusion "
                         "positions (lower --patch)")
    return int(patch), int(stride), pos


def _probs(logits_fn, variables, imgs: torch.Tensor, target) -> torch.Tensor:
    return torch.softmax(logits_fn(variables, imgs).float(), dim=-1)[:, target]


@torch.no_grad()
def occlusion_map(logits_fn: Callable, variables: Any, image, target: int,
                  patch: "int | None" = None, stride: "int | None" = None, batch: int = 64,
                  compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Classic occlusion saliency: a ``patch``² zero window slides over the
    image; each pixel holds the target-probability DROP averaged over the
    patches that cover it. The positions run as masked forwards of ``batch``
    images (see :func:`occlusion_positions` for the adaptive defaults)."""
    dev = variables_device(variables)
    image = as_image(image, dev)
    h, w = int(image.shape[0]), int(image.shape[1])
    patch, stride, pos = occlusion_positions(h, w, patch, stride)
    base_prob = _probs(logits_fn, variables, image[None].to(compute_dtype), target)[0]
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    pos_t = torch.from_numpy(pos).to(dev)
    heat = torch.zeros((h, w), dtype=torch.float32, device=dev)
    count = torch.zeros_like(heat)
    for off in range(0, len(pos), int(batch)):
        py = pos_t[off:off + int(batch), 0][:, None, None]
        px = pos_t[off:off + int(batch), 1][:, None, None]
        inside = (rows >= py) & (rows < py + patch) & (cols >= px) & (cols < px + patch)
        imgs = image[None] * (~inside)[..., None].float()
        probs = _probs(logits_fn, variables, imgs.to(compute_dtype), target)
        cover = inside.float()
        heat += torch.einsum("k,khw->hw", torch.clamp(base_prob - probs, min=0.0), cover)
        count += cover.sum(dim=0)
    return heat / torch.clamp(count, min=1.0)


def rise_draws(seed: int, chunks: int, batch: int, grid: int, keep_prob: float,
               cell_h: int, cell_w: int):
    """RISE's random draws from a CPU ``torch.Generator`` seeded with ``seed``:
    (cells f32 [chunks, batch, grid, grid] of Bernoulli(keep_prob), offsets
    oy in [0, cell_h) and ox in [0, cell_w), int64 [chunks, batch])."""
    gen = torch.Generator().manual_seed(int(seed))
    cells = (torch.rand((chunks, batch, grid, grid), generator=gen) < keep_prob).float()
    oy = torch.randint(0, int(cell_h), (chunks, batch), generator=gen)
    ox = torch.randint(0, int(cell_w), (chunks, batch), generator=gen)
    return cells, oy, ox


@torch.no_grad()
def rise_map(logits_fn: Callable, variables: Any, image, target: int, num_masks: int = 1000,
             grid: int = 7, keep_prob: float = 0.5, batch: int = 250, seed: int = 0,
             compute_dtype: torch.dtype = torch.bfloat16, draws=None) -> torch.Tensor:
    """RISE (Petsiuk et al., 2018): random ``grid``² Bernoulli(keep_prob)
    patterns, bilinearly upsampled with a random sub-cell shift into soft
    [0, 1] masks; the map is the target-probability-weighted sum of the
    masks over ``N·keep_prob``. ``num_masks`` rounds up to a multiple of
    ``batch``. ``draws`` (see :func:`rise_draws`) replaces the seeded ones."""
    dev = variables_device(variables)
    image = as_image(image, dev)
    h, w = int(image.shape[0]), int(image.shape[1])
    grid, batch = int(grid), int(batch)
    chunks = -(-int(num_masks) // batch)
    # One extra cell, so that a random sub-cell shift always leaves a full crop.
    ch, cw = -(-h // grid), -(-w // grid)
    up_h, up_w = (grid + 1) * ch, (grid + 1) * cw
    cells, oy, ox = rise_draws(seed, chunks, batch, grid, keep_prob, ch, cw) \
        if draws is None else draws
    cells = torch.as_tensor(cells).to(dev, torch.float32)
    oy, ox = (torch.as_tensor(o).to(dev, torch.int64) for o in (oy, ox))
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    lanes = torch.arange(batch, device=dev)[:, None, None]
    heat = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for c in range(chunks):
        big = resize_bilinear(cells[c], (up_h, up_w))   # [B, up_h, up_w]
        crop = big[lanes, (oy[c][:, None] + rows)[:, :, None], (ox[c][:, None] + cols)[:, None, :]]
        probs = _probs(logits_fn, variables, (image[None] * crop[..., None]).to(compute_dtype),
                       target)
        heat += torch.einsum("k,khw->hw", probs, crop)
    return heat / (float(chunks * batch) * keep_prob)


# --- CAMs ---------------------------------------------------------------------------


def _submodule(bundle, path: str) -> torch.nn.Module:
    return bundle.module.get_submodule(bundle.module.torch_name(path))


def _capture(bundle, variables, image: torch.Tensor) -> dict:
    """One forward of ``image`` with a hook on every module of the JAX
    model's (``bundle.module.flax_paths()``: every module whose output
    ``capture_intermediates`` records there): {path: NHWC f32 [1, h, w, c]
    activation, or the output as it is where it is not a feature map}."""
    acts, hooks = {}, []
    for path in bundle.module.flax_paths():
        def hook(mod, inp, out, path=path):
            out = out.detach().float()
            acts[path] = out.permute(0, 2, 3, 1) if out.dim() == 4 else out
        hooks.append(_submodule(bundle, path).register_forward_hook(hook))
    try:
        with torch.no_grad():
            bundle.logits(variables, image[None])
    finally:
        for h in hooks:
            h.remove()
    return acts


def _layer_menu(acts: dict) -> list:
    """``(path, shape)`` of every captured 4D output, in the JAX package's
    order: its intermediates flatten as sorted nested dicts, a block's own
    output (its ``__call__`` entry) before its children's."""
    order = sorted((p for p, a in acts.items() if a.dim() == 4),
                   key=lambda p: p.split("/") + ["__call__"])
    return [(p, tuple(acts[p].shape)) for p in order]


def gradcam_target_layers(bundle, variables, image) -> list:
    """Every module whose eval-mode output is a 4D feature map, as
    ``("path/like/this", (B, h, w, c))`` pairs: the menu for :func:`gradcam`'s
    ``layer=`` argument. One forward."""
    return _layer_menu(_capture(bundle, variables, as_image(image, variables_device(variables))))


def _default_gradcam_layer(layers: list) -> str:
    """The canonical "last conv block": smallest spatial extent, then most
    channels, then the LATEST stage by natural segment order (layer4_1 beats
    layer4_0), then the composite block output (shortest path) over its
    inner convs."""
    def nat(seg: str):
        return tuple(int(t) if t.isdigit() else t for t in re.split(r"(\d+)", seg))

    min_spatial = min(s[1] * s[2] for _, s in layers)
    cands = [(n, s) for n, s in layers if s[1] * s[2] == min_spatial]
    max_ch = max(s[3] for _, s in cands)
    cands = [(n, s) for n, s in cands if s[3] == max_ch]
    top = max(cands, key=lambda ns: nat(ns[0].split("/")[0]))[0].split("/")[0]
    cands = [(n, s) for n, s in cands if n.split("/")[0] == top]
    return min(cands, key=lambda ns: len(ns[0]))[0]


def _resolve_layer_activation(bundle, variables, image: torch.Tensor,
                              layer: Optional[str]) -> tuple:
    """One capture forward serves the menu and the activation: ``layer=None``
    picks :func:`_default_gradcam_layer`, a named layer is checked against the
    menu. Returns ``(layer, act)`` with ``act`` NHWC f32 [1, h', w', c]."""
    acts = _capture(bundle, variables, image)
    layers = _layer_menu(acts)
    if not layers:
        raise ValueError("model exposes no 4D intermediate feature maps")
    if layer is None:
        layer = _default_gradcam_layer(layers)
    elif layer not in {n for n, _ in layers}:
        raise ValueError(f"unknown layer {layer!r}; available: {[n for n, _ in layers]}")
    return layer, acts[layer]


def gradcam(bundle, variables: Any, image, target: int,
            layer: Optional[str] = None) -> torch.Tensor:
    """Grad-CAM (Selvaraju et al., 2017): cam = ReLU(Σ_c w_c·A_c), w the
    spatial mean of ∂logit_t/∂A, bilinearly upsampled to the input. A is the
    output of ``layer`` (default: the deepest conv block, see
    :func:`_default_gradcam_layer`); the gradient is w.r.t. a zero ``delta``
    added to that output by a forward hook."""
    dev = variables_device(variables)
    image = as_image(image, dev)
    layer, act = _resolve_layer_activation(bundle, variables, image, layer)
    delta = torch.zeros_like(act, requires_grad=True)
    handle = _submodule(bundle, layer).register_forward_hook(
        lambda mod, inp, out: out + delta.permute(0, 3, 1, 2).to(out.dtype))
    try:
        with torch.enable_grad():
            out = bundle.logits(variables, image[None]).float()[0, target]
            (grads,) = torch.autograd.grad(out, delta)
    finally:
        handle.remove()
    weights = torch.mean(grads, dim=(1, 2))   # [1, c]
    cam = torch.relu(torch.einsum("bhwc,bc->bhw", act, weights))[0]
    return resize_bilinear(cam, image.shape[:2])


@torch.no_grad()
def scorecam(bundle, variables: Any, image, target: int, layer: Optional[str] = None,
             channels: int = 64, batch: int = 64, compute_dtype: torch.dtype = torch.bfloat16,
             logits_fn: Optional[Callable] = None) -> torch.Tensor:
    """Score-CAM (Wang et al., 2020), gradient-free: each of the top
    ``channels`` activation channels at ``layer`` (by spatial max; same menu
    and default as :func:`gradcam`), min-max normalized and upsampled,
    becomes a soft mask over the input; its masked forward's target logit
    scores it, and cam = ReLU(Σ_k softmax(s)_k·A_k). Constant (dead) channels
    are left out of the softmax. The masked forwards run ``batch`` at a time
    (at most ``channels``) through ``logits_fn`` (default ``bundle.logits``;
    ``engine.folded_logits`` runs them through B2)."""
    if int(channels) <= 0:
        raise ValueError(f"channels must be positive, got {channels}")
    if int(batch) <= 0:
        raise ValueError(f"batch must be positive, got {batch}")
    logits_fn = bundle.logits if logits_fn is None else logits_fn
    dev = variables_device(variables)
    image = as_image(image, dev)
    _, act = _resolve_layer_activation(bundle, variables, image, layer)
    k = min(int(channels), int(act.shape[-1]))
    batch = min(int(batch), k)
    h, w = int(image.shape[0]), int(image.shape[1])
    a = act[0]   # [h', w', c]
    # lax.top_k puts the lower index first on ties: a stable descending sort.
    idx = torch.sort(torch.amax(a, dim=(0, 1)), descending=True, stable=True).indices[:k]
    up = resize_bilinear(a[:, :, idx].permute(2, 0, 1), (h, w))   # [k, h, w]
    mn = up.amin(dim=(1, 2), keepdim=True)
    mx = up.amax(dim=(1, 2), keepdim=True)
    active = (mx > mn)[:, 0, 0]
    masks = (up - mn) / torch.where(mx > mn, mx - mn, torch.ones_like(mx))
    scores = torch.cat([
        logits_fn(variables, (image[None] * masks[off:off + batch, :, :, None])
                  .to(compute_dtype)).float()[:, target]
        for off in range(0, k, batch)])
    scores = torch.where(active, scores, torch.full_like(scores, -float("inf")))
    weights = torch.where(active.any(), torch.softmax(scores, dim=0), torch.zeros_like(scores))
    return torch.relu(torch.einsum("k,khw->hw", weights, up))


# --- sweep entries -------------------------------------------------------------------

#: Methods :func:`attribute_batch` runs as one stacked backward over N images.
BATCHABLE_METHODS = ("gradient", "grad_input", "integrated", "smoothgrad", "gradcam")

#: Per-image methods whose work is batched over MASKS; a sweep runs them one
#: image after another (:func:`mask_method_batch`), so live memory stays at
#: one image's mask chunk.
MASK_BATCHED_METHODS = ("occlusion", "rise", "scorecam")


def _mask_one_body(logits_fn, bundle, method: str, *, patch: "int | None" = None,
                   stride: "int | None" = None, rise_masks: int = 1000, rise_grid: int = 7,
                   rise_keep_prob: float = 0.5, mask_batch: Optional[int] = None,
                   gradcam_layer: Optional[str] = None, scorecam_channels: int = 64,
                   compute_dtype: torch.dtype = torch.bfloat16):
    """``(variables, image, target, seed) -> f32[H, W]`` for a
    :data:`MASK_BATCHED_METHODS` method, hyperparameters closed over.
    ``mask_batch=None`` keeps each method's one-shot chunk (occlusion and
    scorecam 64, rise 250). RISE's masks are a function of (seed,
    mask_batch, rise_masks), so ``mask_batch`` is a hyperparameter there."""
    if method not in MASK_BATCHED_METHODS:
        raise ValueError(f"unknown mask-batched method {method!r}; choose "
                         f"from {MASK_BATCHED_METHODS}")
    if method == "scorecam" and bundle is None:
        raise ValueError("method='scorecam' needs bundle=")
    if method == "occlusion":
        b = 64 if mask_batch is None else int(mask_batch)
        return lambda v, img, t, s: occlusion_map(logits_fn, v, img, t, patch=patch,
                                                  stride=stride, batch=b,
                                                  compute_dtype=compute_dtype)
    if method == "rise":
        b = 250 if mask_batch is None else int(mask_batch)
        return lambda v, img, t, s: rise_map(logits_fn, v, img, t, num_masks=rise_masks,
                                             grid=rise_grid, keep_prob=rise_keep_prob, batch=b,
                                             seed=s, compute_dtype=compute_dtype)
    b = 64 if mask_batch is None else int(mask_batch)
    return lambda v, img, t, s: scorecam(bundle, v, img, t, layer=gradcam_layer,
                                         channels=scorecam_channels, batch=b,
                                         compute_dtype=compute_dtype, logits_fn=logits_fn)


def mask_method_one_fn(logits_fn, bundle, method: str, **kw):
    """The per-image ``(variables, image, target, seed) -> f32[H, W]``
    function of a :data:`MASK_BATCHED_METHODS` method (see
    :func:`_mask_one_body`)."""
    return _mask_one_body(logits_fn, bundle, method, **kw)


def _image_batch_scaffold(images, targets, seeds, device):
    """Validation shared by the image-batched entries: f32 [N, H, W, C]
    images, int64 [N] targets and seeds (default zeros) on ``device``.
    Returns ``(images, targets, seeds, n)``. Nothing is padded: the JAX
    package's power-of-two buckets only reuse compiled shapes."""
    images = as_image(images, device)
    if images.dim() != 4:
        raise ValueError(f"images must be [N, H, W, C], got {tuple(images.shape)}")
    n = int(images.shape[0])
    targets = torch.as_tensor(np.asarray(targets, np.int64) if not isinstance(
        targets, torch.Tensor) else targets, dtype=torch.int64).to(device).reshape(-1)
    seeds = [0] * n if seeds is None else [int(s) for s in np.asarray(seeds).reshape(-1)]
    if tuple(targets.shape) != (n,) or len(seeds) != n:
        raise ValueError(f"targets/seeds must be [N={n}], got {tuple(targets.shape)} / "
                         f"{len(seeds)}")
    return images, targets, seeds, n


def image_sharded(mesh, data_axis: str, fn: Callable, images: torch.Tensor,
                  targets: torch.Tensor, seeds: list):
    """``fn(images, targets, seeds)`` of the image-batched entries, sharded
    over ``mesh``'s data axis when one is given (every rank passing the
    same inputs): the image axis pads to a multiple of the axis size with
    image 0, target 0 and seed 0, each rank runs its slice, and one
    all-gather gives every rank all N outputs (JAX's ``shard_map`` over the
    image axis). Each image keeps its own seed, whatever rank runs it."""
    if mesh is None:
        return fn(images, targets, seeds)
    return map_sharded(mesh, lambda im, tg, sd: fn(im, tg, [int(v) for v in sd.tolist()]),
                       [images, targets, torch.tensor(seeds, dtype=torch.int64)],
                       fills=[None, 0, 0], axis=data_axis)


def mask_method_batch(logits_fn, variables, images, targets, method: str, *, bundle=None,
                      seeds=None, mesh=None, data_axis: str = "data", **kw) -> torch.Tensor:
    """N images' mask-batched attributions -> f32[N, H, W], one image after
    another (the JAX package's ``lax.map``): live memory stays at one image's
    mask chunk. Hyperparameters as in :func:`_mask_one_body`. ``mesh``
    shards the image axis (:func:`image_sharded`)."""
    dev = variables_device(variables)
    images, targets, seeds, n = _image_batch_scaffold(images, targets, seeds, dev)
    if n == 0:
        return torch.zeros((0, *images.shape[1:3]), dtype=torch.float32, device=dev)
    one = _mask_one_body(logits_fn, bundle, method, **kw)

    def run(imgs, tgts, sds):
        return torch.stack([one(variables, imgs[i], int(tgts[i]), sds[i])
                            for i in range(imgs.shape[0])])

    return image_sharded(mesh, data_axis, run, images, targets, seeds)


def default_gradcam_layer(bundle, variables, image_shape) -> str:
    """The layer ``gradcam(layer=None)`` picks for ``bundle`` at
    ``image_shape`` (H, W, C): one capture forward of a zero image."""
    menu = gradcam_target_layers(bundle, variables, np.zeros(image_shape, np.float32))
    if not menu:
        raise ValueError(f"{bundle.name}: no 4D intermediate feature map — gradcam needs a "
                         "conv stage")
    return _default_gradcam_layer(menu)


def attribute_batch(logits_fn: Callable, variables: Any, images, targets,
                    method: str = "gradient", *, bundle=None, steps: int = 16,
                    samples: int = 16, noise_sigma: float = 0.15, magnitude: bool = False,
                    gradcam_layer: Optional[str] = None, seeds=None,
                    step_batch: Optional[int] = None,
                    sample_batch: Optional[int] = None, mesh=None,
                    data_axis: str = "data") -> torch.Tensor:
    """N images' attribution maps -> f32[N, H, W]: the gradient methods as one
    stacked backward over the N images (``step_batch`` / ``sample_batch``
    bound it at N·chunk concurrent backwards), Grad-CAM one image after
    another at one resolved layer. ``seeds`` (default zeros) feed SmoothGrad
    only; each image's result equals the single-image function's. ``mesh``
    shards the image axis (:func:`image_sharded`)."""
    if method not in BATCHABLE_METHODS:
        raise ValueError(f"unknown batchable method {method!r}; choose "
                         f"from {BATCHABLE_METHODS}")
    dev = variables_device(variables)
    images, targets, seeds, n = _image_batch_scaffold(images, targets, seeds, dev)
    if n == 0:
        return torch.zeros((0, *images.shape[1:3]), dtype=torch.float32, device=dev)
    if method == "gradcam":
        if bundle is None:
            raise ValueError("method='gradcam' needs bundle=")
        if gradcam_layer is None:
            gradcam_layer = default_gradcam_layer(bundle, variables, tuple(images.shape[1:]))

    def run(imgs, tgts, sds):
        if method in ("gradient", "grad_input"):
            return _gradient_batch(logits_fn, variables, imgs, tgts, method == "grad_input")
        if method == "integrated":
            return _integrated_batch(logits_fn, variables, imgs, tgts, int(steps), None,
                                     step_batch)
        if method == "smoothgrad":
            return _smoothgrad_batch(logits_fn, variables, imgs, tgts, int(samples),
                                     float(noise_sigma), sds, bool(magnitude), sample_batch)
        return torch.stack([gradcam(bundle, variables, imgs[i], int(tgts[i]),
                                    layer=gradcam_layer) for i in range(imgs.shape[0])])

    return image_sharded(mesh, data_axis, run, images, targets, seeds)

