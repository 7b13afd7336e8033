"""The plain reference of a window-saliency explanation, in f32 PyTorch and NumPy.

It imports nothing of the program under test. Given the inputs and weights the
harness made, it works out again everything the program derives from them:

- the display image and its Felzenszwalb segments (a frozen plain copy of the
  port's numpy implementation, with the union-find written over Python lists);
- the window starts of each image (numpy's ``RandomState``, the sampler the
  port's sweep documents);
- the classifier's logits: the config's family of nets, each in a module
  of its own under ``portbench/nets/`` (found by ``spec.net``), written with
  ``F.conv2d`` and eval-mode BatchNorm on :class:`PlainNet`, in f32 with
  TF32 off;
- the survive outcomes, the summed-label heatmap and the bbox / IOU row.

``quantize="fp8"`` computes the same net in float8 e4m3 (per-tensor scales):
every weight and every activation between operations is rounded to it, the
products accumulating in f32. That is the control, the precision below the
bf16 that the configurations state.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
FP8_MAX = 448.0   # largest finite float8 e4m3fn


# ---------------------------------------------------------------------------
# The network: the config's family (``portbench/nets/<net>.py``, found by
# ``spec.net``) gives the shapes, the head's keys, the residual branches'
# last BatchNorms and a :class:`PlainNet`; the weights, the calibration and
# the fp8 rounding are the same for every family.

def make_weights(net, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded f32 weights on ``device`` for the family module ``net``, from
    one generator in one draw over ``net.state_shapes(cfg)`` in its order:
    He normal convolutions, BatchNorm scales 1 + 0.1 n and shifts 0.1 n, a
    head (``net.HEAD``: weight, bias) of std ``head_gain``/sqrt(fan-in). The
    last BatchNorm of each residual branch (``net.residual_bn_keys(cfg)``)
    has its scale times ``residual_scale`` (the config's ``init``), as a
    trained net's are small: with scale 1 a deep BatchNorm net is chaotic,
    and an ulp at the input moves its logits by a tenth of their spread.
    Running statistics are set by :func:`calibrate`."""
    init = cfg["init"]
    shapes = net.state_shapes(cfg)
    head_weight, head_bias = net.HEAD
    residual = net.residual_bn_keys(cfg)
    sizes = [int(np.prod(s)) for s in shapes.values()]
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        t = flat[off:off + n].view(shape)
        off += n
        if name.endswith("running_mean"):
            t = torch.zeros(shape, device=device)
        elif name.endswith("running_var"):
            t = torch.ones(shape, device=device)
        elif name == head_weight:
            t = t * (init["head_gain"] / np.sqrt(shape[1]))
        elif name == head_bias:
            t = t * 0.01
        elif len(shape) == 4:
            t = t * np.sqrt(2.0 / np.prod(shape[1:]))
        elif name in residual:
            t = init["residual_scale"] * (1.0 + 0.1 * t)
        elif name.endswith(".weight"):
            t = 1.0 + 0.1 * t
        else:
            t = 0.1 * t
        out[name] = t.contiguous()
    return out


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one per-tensor scale, back in f32."""
    scale = torch.clamp(t.abs().amax(), min=1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class PlainNet:
    """The f32 forward of a state dict, NHWC normalized images -> f32
    logits, with TF32 off. A family subclasses it and writes ``forward``
    (NCHW f32 -> logits) from :meth:`conv_bn` and :meth:`linear`, passing
    every other activation it makes through ``self.q``.

    ``quantize="fp8"`` rounds every weight and every activation between
    operations to float8 e4m3 (the control). With ``calibrating`` set (see
    :func:`calibrate`) every BatchNorm uses the batch's biased statistics and
    stores them as its running statistics."""

    def __init__(self, cfg: dict, state: Dict[str, torch.Tensor], quantize: str = "none"):
        if quantize not in ("none", "fp8"):
            raise ValueError(f"unknown quantize {quantize!r}")
        self.cfg, self.state = cfg, state
        self.q = _fp8 if quantize == "fp8" else (lambda t: t)
        self.calibrating = False

    def conv_bn(self, x, conv, bn, stride=1, padding=0, groups=1, eps=BN_EPS):
        """The bias-free convolution ``conv`` (a key prefix), then the
        eval-mode BatchNorm ``bn``."""
        x = self.q(F.conv2d(x, self.q(self.state[conv + ".weight"]), None, stride, padding, 1,
                            groups))
        s = self.state
        if self.calibrating:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            s[bn + ".running_mean"].copy_(mean)
            s[bn + ".running_var"].copy_(var)
        scale = s[bn + ".weight"] / torch.sqrt(s[bn + ".running_var"] + eps)
        shift = s[bn + ".bias"] - s[bn + ".running_mean"] * scale
        return self.q(x * scale[None, :, None, None] + shift[None, :, None, None])

    def linear(self, x, weight: str, bias: str):
        """The head: pooled features times the weight, plus the bias."""
        return x @ self.q(self.state[weight]).t() + self.state[bias]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def __call__(self, images_nhwc: torch.Tensor) -> torch.Tensor:
        with _no_tf32():
            return self.forward(self.q(images_nhwc.float().permute(0, 3, 1, 2).contiguous()))


class _no_tf32:
    """TF32 off for cuDNN and matmuls inside the block, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


def calibrate(net, cfg: dict, state: Dict[str, torch.Tensor], images_nhwc: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics to its batch statistics on
    ``images_nhwc`` (one f32 forward of the family ``net``'s ``Plain``), so
    that the logits are not saturated, then shift the head's bias so that
    each class's mean logit over those images is 0: the pooled features are
    non-negative, and without the shift their common part makes the same few
    classes win on every image. The first step is frozen from
    ``chip_smoke.py:1993`` (``calibrated_state_dict``), which does it
    through the program's module in training mode."""
    plain = net.Plain(cfg, state)
    plain.calibrating = True
    plain(images_nhwc)
    plain.calibrating = False
    state[net.HEAD[1]] -= plain(images_nhwc).mean(dim=0)


# ---------------------------------------------------------------------------
# The explanation's host steps.

def normalize_to_uint8(x) -> np.ndarray:
    """Min-max scale to [0, 255] uint8. Frozen from
    ``network_interpretation_imagenet_tpu_torch/ops/aggregate.py:104``."""
    x = np.asarray(x, np.float32)
    x = x - x.min()
    denom = max(float(x.max()), float(np.finfo(np.float32).tiny))
    return (x / denom * 255.0).astype(np.uint8)


def relabel_sequential(labels: np.ndarray) -> np.ndarray:
    """Contiguous 0..S-1 labels in raster first-occurrence order. Frozen from
    ``network_interpretation_imagenet_tpu_torch/segment/common.py:15``."""
    flat = np.asarray(labels).ravel()
    first = np.full(int(flat.max()) + 1, -1, np.int64)
    first[flat[::-1]] = np.arange(flat.size - 1, -1, -1)
    present = np.nonzero(first >= 0)[0]
    order = np.argsort(first[present], kind="stable")
    remap = np.full(first.size, -1, np.int32)
    remap[present[order]] = np.arange(len(present), dtype=np.int32)
    return remap[np.asarray(labels)].astype(np.int32)


def _edges_8conn(h: int, w: int):
    """8-connected edges, pixel raster-major, then right / down / down-right /
    down-left. Frozen from
    ``network_interpretation_imagenet_tpu_torch/segment/felzenszwalb.py:92``."""
    idx = np.arange(h * w, dtype=np.int32).reshape(h, w)
    n = h * w
    a4 = np.full((n, 4), -1, np.int32)
    b4 = np.full((n, 4), -1, np.int32)
    flat = idx.ravel()
    for d, (sa, sb) in enumerate((
        ((slice(None), slice(None, -1)), (slice(None), slice(1, None))),
        ((slice(None, -1), slice(None)), (slice(1, None), slice(None))),
        ((slice(None, -1), slice(None, -1)), (slice(1, None), slice(1, None))),
        ((slice(None, -1), slice(1, None)), (slice(1, None), slice(None, -1))),
    )):
        m = np.zeros((h, w), bool)
        m[sa] = True
        a4[flat[m.ravel()], d] = idx[sa].ravel()
        b4[flat[m.ravel()], d] = idx[sb].ravel()
    valid = a4.ravel() >= 0
    return a4.ravel()[valid], b4.ravel()[valid]


def felzenszwalb(image_u8: np.ndarray, scale: float, sigma: float, min_size: int) -> np.ndarray:
    """Felzenszwalb-Huttenlocher over 8-connected edges with f32 merge
    thresholds: int32[H, W] contiguous labels. Frozen from
    ``network_interpretation_imagenet_tpu_torch/segment/felzenszwalb.py:118``
    (``_felzenszwalb_numpy``) and ``:79`` (``_smooth``); the union-find runs on
    Python lists, and ``internal + scale / size`` is rounded to f32 only where
    the f64 sum lies within a relative 1e-6 of the edge's weight."""
    from scipy import ndimage

    img = np.asarray(image_u8)
    if img.ndim == 2:
        img = img[:, :, None]
    img = img.astype(np.float32) / 255.0
    if sigma > 0:
        out = np.empty_like(img)
        for ch in range(img.shape[2]):
            ndimage.gaussian_filter(img[:, :, ch], sigma, output=out[:, :, ch], mode="reflect")
        img = out
    h, w, c = img.shape
    a, b = _edges_8conn(h, w)
    flat = img.reshape(-1, c)
    weights = np.sqrt(((flat[a] - flat[b]) ** 2).sum(axis=1))
    order = np.argsort(weights, kind="stable")
    a, b, weights = a[order].tolist(), b[order].tolist(), weights[order].tolist()
    n = h * w
    inv = (np.float32(scale) / np.arange(1, n + 1, dtype=np.float32)).tolist()
    parent = list(range(n))
    size = [1] * n
    internal = [0.0] * n

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    def merge(ra, rb, wt):
        if size[ra] < size[rb]:
            ra, rb = rb, ra
        parent[rb] = ra
        size[ra] += size[rb]
        internal[ra] = wt

    def within(wt, t):  # wt <= f32(t), t an f64 sum of two f32 values
        return wt <= t or (wt - t < 1e-6 * t and float(np.float32(t)) == wt)

    for i in range(len(a)):
        ra, rb = find(a[i]), find(b[i])
        if ra == rb:
            continue
        wt = weights[i]
        if within(wt, internal[ra] + inv[size[ra] - 1]) and \
                within(wt, internal[rb] + inv[size[rb] - 1]):
            merge(ra, rb, wt)
    for i in range(len(a)):
        ra, rb = find(a[i]), find(b[i])
        if ra != rb and (size[ra] < min_size or size[rb] < min_size):
            merge(ra, rb, weights[i])
    roots = np.array([find(p) for p in range(n)], np.int32)
    return relabel_sequential(roots.reshape(h, w))


def segment_scale(h: int, w: int, scale) -> float:
    """The area-adaptive Felzenszwalb scale ``max(1, 100 * H * W / 224^2)``
    where the traffic leaves it unset (the port's ``SegmentConfig.scale``)."""
    return float(scale) if scale is not None else max(1.0, 100.0 * h * w / (224.0 * 224.0))


def window_starts(seed: int, num: int, total_segments: int, width: int) -> np.ndarray:
    """int32[num] starts uniform over ``[1, max(S - width, 1)]`` from
    ``RandomState(seed)``: the reference's ``randint(1, S - width)``."""
    hi = max(int(total_segments) - int(width), 1)
    return np.random.RandomState(seed).randint(1, hi + 1, size=num).astype(np.int32)


def masked_images(image: torch.Tensor, segments: torch.Tensor, firsts: torch.Tensor,
                  width: int) -> torch.Tensor:
    """f32 [K, H, W, C]: the normalized image with every pixel outside the
    window ``[first, first + width)`` of segments set to 0."""
    keep = (segments[None] >= firsts[:, None, None]) & (segments[None] < (firsts + width)[:, None, None])
    return image[None] * keep[..., None].float()


def summed_heatmap(segments: np.ndarray, firsts: np.ndarray, width: int,
                   survived: np.ndarray) -> np.ndarray:
    """f32[H, W]: each pixel sums the survive labels of the windows that keep it."""
    seg = np.asarray(segments, np.int64)
    s = int(seg.max()) + 1
    heat = np.zeros(s, np.float64)
    for f, alive in zip(np.asarray(firsts, np.int64), np.asarray(survived, bool)):
        if alive:
            heat[f:min(f + int(width), s)] += 1.0
    return heat.astype(np.float32)[seg]


def largest_box(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """[x, y, w, h] of the largest-area bounding box among the 8-connected
    components of ``mask`` (the first on ties, in raster order of the
    components' first pixels); zeros for an empty mask."""
    from scipy import ndimage

    lab, n = ndimage.label(np.asarray(mask, bool), structure=np.ones((3, 3), int))
    best, best_area = (0, 0, 0, 0), 0
    for sl in ndimage.find_objects(lab):
        bw, bh = sl[1].stop - sl[1].start, sl[0].stop - sl[0].start
        if bw * bh > best_area:
            best, best_area = (sl[1].start, sl[0].start, bw, bh), bw * bh
    return best


def iou(box_a, box_b) -> float:
    """IOU of two [x, y, w, h] boxes with the +1-pixel corner convention."""
    a = np.asarray(box_a, np.float64)
    b = np.asarray(box_b, np.float64)
    a = np.array([a[0], a[1], a[0] + a[2], a[1] + a[3]])
    b = np.array([b[0], b[1], b[0] + b[2], b[1] + b[3]])
    xa, ya = max(a[0], b[0]), max(a[1], b[1])
    xb, yb = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, xb - xa + 1) * max(0.0, yb - ya + 1)
    area_a = (a[2] - a[0] + 1) * (a[3] - a[1] + 1)
    area_b = (b[2] - b[0] + 1) * (b[3] - b[1] + 1)
    return float(inter / (area_a + area_b - inter))


def localization_iou(heat: np.ndarray, gt_xywh, threshold: int) -> float:
    """Heatmap -> uint8 -> ``> threshold`` -> largest component's box -> IOU."""
    return iou(largest_box(normalize_to_uint8(heat) > threshold), gt_xywh)


# ---------------------------------------------------------------------------
# GP-EI over window starts: the choices of the flagship explanation's loop.

def bo_draws(seed: int, upper: int, count: int) -> np.ndarray:
    """int64[count] uniform in [0, upper] from a CPU ``torch.Generator``
    seeded with ``seed``: the pre-samples first, then one stand-in start per
    iteration for a proposal already observed."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, int(upper) + 1, (int(count),), generator=g).numpy()


def gp_ei(xs, ys, upper: int, lengthscales, alpha: float):
    """Per lengthscale of the grid, ``(mll, ei[0..upper])`` of an exact GP
    (RBF kernel, outputscale 1, noise ``alpha`` on the diagonal) on the
    observations ``(xs, ys)``, the targets normalized by their mean and
    population std (floored at 1e-6), and the closed-form expected
    improvement over the best normalized target at every integer start in
    ``[0, upper]``; in float64."""
    from scipy.special import ndtr

    x = np.asarray(xs, np.float64)
    y = np.asarray(ys, np.float64)
    std = np.sqrt(max(float(np.mean((y - y.mean()) ** 2)), 1e-12))
    yn = (y - y.mean()) / std
    cand = np.arange(int(upper) + 1, dtype=np.float64)
    out = []
    for ls in lengthscales:
        k = np.exp(-0.5 * ((x[:, None] - x[None, :]) / ls) ** 2) + alpha * np.eye(len(x))
        try:
            chol = np.linalg.cholesky(k)
        except np.linalg.LinAlgError:
            out.append((float("nan"), None))
            continue
        u = np.linalg.solve(chol, yn)
        mll = -0.5 * float(u @ u) - float(np.sum(np.log(np.diag(chol)))) \
            - 0.5 * len(x) * np.log(2.0 * np.pi)
        ks = np.exp(-0.5 * ((cand[:, None] - x[None, :]) / ls) ** 2)
        v = np.linalg.solve(chol, ks.T)
        mu = v.T @ u
        sigma = np.sqrt(np.clip(1.0 - np.sum(v * v, axis=0), 0.0, None))
        gain = mu - yn.max()
        safe = np.where(sigma > 0, sigma, 1.0)
        z = gain / safe
        ei = np.where(sigma > 0, gain * ndtr(z) + safe * np.exp(-0.5 * z * z) / np.sqrt(2 * np.pi),
                      0.0)
        out.append((mll, ei))
    return out


def ei_choice_ok(xs, ys, chosen: float, draw: float, upper: int, lengthscales, alpha: float,
                 epsilon: float, mll_slack: float, regret: float) -> bool:
    """Whether ``chosen`` is what GP-EI on ``(xs, ys)`` proposes: a start
    whose EI is within ``regret`` (relative) of the best under a lengthscale
    whose log marginal likelihood is within ``mll_slack`` of the grid's best
    (``None``: any lengthscale of the grid), or ``draw`` where such a
    proposal was already observed (within ``epsilon``)."""
    fits = gp_ei(xs, ys, upper, lengthscales, alpha)
    mlls = np.array([m for m, _ in fits])
    if np.all(np.isnan(mlls)):
        return False
    best = np.nanmax(mlls)
    for mll, ei in fits:
        if ei is None or (mll_slack is not None and not mll >= best - mll_slack):
            continue
        top = ei.max()
        near = np.nonzero(ei >= top - regret * max(abs(top), 1e-300))[0]
        for c in near:
            seen = np.any(np.abs(np.asarray(xs, np.float64) - c) <= epsilon)
            if (not seen and abs(chosen - c) <= epsilon) or (seen and chosen == draw):
                return True
    return False


def bo_trajectory(evaluate, draws: np.ndarray, n_pre: int, n_iters: int, upper: int,
                  lengthscales, alpha: float, epsilon: float, propose: str = "ei"):
    """The GP-EI loop itself (the control's: its own choices): ``evaluate``
    maps int starts to (prob_target, survived) arrays; the pre-samples are
    ``draws[:n_pre]``, then each iteration the EI argmax under the best
    lengthscale, or its draw where that start was already observed.
    ``propose="draw"`` is the fault of a loop without GP-EI: each
    iteration takes its draw."""
    xs = [float(v) for v in draws[:n_pre]]
    p, s = evaluate(np.asarray(xs, np.int64))
    ys, surv = list(p), list(s)
    for it in range(n_iters):
        if propose == "draw":
            prop = float(draws[n_pre + it])
        else:
            fits = gp_ei(xs, ys, upper, lengthscales, alpha)
            mlls = np.array([m if not np.isnan(m) else -np.inf for m, _ in fits])
            ei = fits[int(np.argmax(mlls))][1]
            prop = float(np.argmax(ei)) if ei is not None else float(draws[n_pre + it])
        if np.any(np.abs(np.asarray(xs) - prop) <= epsilon):
            prop = float(draws[n_pre + it])
        p, s = evaluate(np.asarray([prop], np.int64))
        xs.append(prop)
        ys.append(float(p[0]))
        surv.append(bool(s[0]))
    return np.asarray(xs), np.asarray(ys), np.asarray(surv, bool)
