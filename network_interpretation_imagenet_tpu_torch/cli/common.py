"""Shared CLI plumbing (port of the part of ``cli/common.py`` that the
ported CLIs use): flags, image and engine resolution, artifact writers.

The flag names are the JAX package's. ``--device {cuda,cpu}`` takes the
place of ``--platform``; the flags that served only XLA's compilation cache,
``--local-devices`` and the loaders of other datasets are not here. PIL is
imported only where an image is read or written.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.config import DATASETS, SegmentConfig
from network_interpretation_imagenet_tpu_torch.models.resnet_imagenet import ARCHS


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    g = p.add_argument_group("data")
    g.add_argument("--data", default=None,
                   help="ImageNet-localization root (LOC_val_solution.csv + synset dirs) or "
                        "a class-subdirectory image folder; none: a synthetic image")
    g.add_argument("--dataset", default="imagenet", choices=["imagenet"])
    g.add_argument("--synthetic", action="store_true",
                   help="use a deterministic synthetic image (no dataset needed)")
    g.add_argument("--eval_img_index", type=int, default=1,
                   help="index of the evaluation image, 1-based (reference flag)")

    g = p.add_argument_group("model")
    g.add_argument("--arch", "-a", default="resnet18", choices=ARCHS)
    g.add_argument("--ckpt", default=None,
                   help="torch state dict (.pth / .pth.tar, torchvision keys) to load")
    g.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    g.add_argument("--mask-batch", type=int, default=1024)
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the engine runs (the card unless cpu is asked for)")

    g = p.add_argument_group("segmentation")
    g.add_argument("--segmenter", default="felzenszwalb", choices=["felzenszwalb", "slic"],
                   help="felzenszwalb (host) or slic (k-means on --device)")
    # None = area-adaptive: the reference's scale=100 calibrated at 224^2.
    g.add_argument("--scale", type=float, default=None)
    g.add_argument("--sigma", type=float, default=0.5)
    g.add_argument("--min_size", type=int, default=None,
                   help="default: the reference's 50 for imagenet")
    g.add_argument("--n_segments", type=int, default=48, help="slic: target superpixel count")

    g = p.add_argument_group("masks")
    g.add_argument("--num_mask_samples", type=int, default=100)
    g.add_argument("--window_fraction", type=float, default=0.4)
    g.add_argument("--num_masked_superpixels", type=int, default=1)

    g = p.add_argument_group("output")
    g.add_argument("--out", default="./outputs", help="artifact directory")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--save-pngs", action="store_true",
                   help="also write per-mask PNGs like the reference ./masks dir")
    return p


def add_bo_flags(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("bayesian optimization")
    g.add_argument("--n_iters", type=int, default=10)
    g.add_argument("--n_pre_samples", type=int, default=3)
    g.add_argument("--fused", dest="fused", action="store_true", default=False,
                   help="run the fused on-device BO loop (a CUDA graph on the card)")
    g.add_argument("--no-fused", dest="fused", action="store_false",
                   help="use the host-driven BO loop (default, as in the JAX package)")


def add_method_flags(p: argparse.ArgumentParser, rise_masks: int = 500, sg_samples: int = 16,
                     lm_iters: int = 150, lm_jitter: int = 4) -> None:
    """Per-method attribution hyperparameters, shared by the CLIs that
    dispatch through ``compare_saliency_methods.heatmap`` (occlusion_saliency,
    compare_saliency_methods, attribution_sanity); each CLI may change the
    defaults through the keyword arguments."""
    g = p.add_argument_group("attribution method hyperparameters")
    # None = resolution-adaptive (32 at 224^2 scaled to the image side, floor
    # 4; stride = patch // 2): a fixed 32 on a 32x32 input has one position.
    g.add_argument("--patch", type=int, default=None,
                   help="occlusion: patch side (default: 32 at 224^2 scaled linearly, floor 4)")
    g.add_argument("--stride", type=int, default=None,
                   help="occlusion: stride (default: patch // 2)")
    g.add_argument("--ig-steps", type=int, default=16, help="integrated/xrai: path steps")
    g.add_argument("--sg-samples", type=int, default=sg_samples,
                   help="smoothgrad: noisy copies averaged (one batched backward)")
    g.add_argument("--sg-sigma", type=float, default=0.15,
                   help="smoothgrad: Gaussian noise sigma relative to the image's value range")
    g.add_argument("--sg-squared", action="store_true",
                   help="smoothgrad: average squared gradients (SmoothGrad^2)")
    g.add_argument("--rise-masks", type=int, default=rise_masks,
                   help="rise: random soft masks (rounded up to a batch multiple)")
    g.add_argument("--rise-grid", type=int, default=7, help="rise: low-res Bernoulli grid size")
    g.add_argument("--rise-keep", type=float, default=0.5, help="rise: per-cell keep probability")
    g.add_argument("--gradcam-layer", default=None,
                   help="module path for gradcam/scorecam (default: deepest conv block; "
                        "'list' prints the menu in occlusion_saliency)")
    g.add_argument("--scorecam-channels", type=int, default=64,
                   help="scorecam: top-K activation channels scored by masked forwards")
    g.add_argument("--xrai-scales", default="auto",
                   help="xrai: comma list of felzenszwalb scales for the oversegmentation "
                        "ladder, or 'auto' (the paper's 224^2 ladder 50,100,150,250,500 "
                        "area-scaled to the input size)")
    g.add_argument("--lm-mask-size", type=int, default=28,
                   help="meaningful: low-res mask grid side")
    g.add_argument("--lm-iters", type=int, default=lm_iters)
    g.add_argument("--lm-l1", type=float, default=0.05, help="meaningful: deletion-area weight")
    g.add_argument("--lm-tv", type=float, default=0.1, help="meaningful: mean-TV smoothness weight")
    g.add_argument("--lm-jitter", type=int, default=lm_jitter,
                   help="meaningful: shifted copies per step")
    g.add_argument("--lm-baseline", default="blur", choices=["blur", "zero"])


def parse_xrai_scales(spec: str):
    """``--xrai-scales`` -> a list of floats, or None for 'auto' (the callee
    then takes ``xrai.adaptive_scales`` for its resolution)."""
    if spec is None or spec.strip().lower() in ("auto", ""):
        return None
    return [float(s) for s in spec.split(",")]


def add_gp_flags(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("gp surrogate")
    g.add_argument("--gp-mode", default="train", choices=["train", "eval", "train+eval"],
                   help="reference gp_regression.py Train/Eval switch")
    g.add_argument("--grid_size", type=int, default=30)
    g.add_argument("--gp_iters", type=int, default=20)
    g.add_argument("--gp_lr", type=float, default=0.1)
    g.add_argument("--gp-ckpt", default="./gp_saved_checkpoints")


def segment_config(args) -> SegmentConfig:
    min_size = 50 if args.min_size is None else args.min_size  # reference :150
    return SegmentConfig(method=args.segmenter, scale=args.scale, sigma=args.sigma,
                         min_size=min_size, n_segments=args.n_segments)


@functools.lru_cache(maxsize=4)
def _dataset(data_dir: str):
    """The dataset at ``data_dir``, parsed once per process (multi-image
    runs read one image per index)."""
    if os.path.exists(os.path.join(data_dir, "LOC_val_solution.csv")):
        from network_interpretation_imagenet_tpu_torch.data.imagenet_loc import (
            ImagenetLocalizationDataset,
        )

        return ImagenetLocalizationDataset(data_dir)
    # Plain class-subdirectory layout (the reference's ImageFolder path): no gt boxes.
    from network_interpretation_imagenet_tpu_torch.data.image_folder import ImageFolderDataset

    return ImageFolderDataset(data_dir)


def resolve_image(args) -> Tuple[np.ndarray, np.ndarray, Optional[int], Optional[np.ndarray]]:
    """-> (normalized f32 HWC image, display uint8 HWC, label?, gt_bbox?)."""
    from network_interpretation_imagenet_tpu_torch.ops import preprocess

    spec = DATASETS[args.dataset]
    if args.synthetic or not args.data:
        from network_interpretation_imagenet_tpu_torch.data.synthetic import (
            synthetic_imagenet_image,
        )

        base = synthetic_imagenet_image(args.seed + args.eval_img_index, spec.image_size)
        img = preprocess.normalize(torch.from_numpy(base), spec.mean, spec.std).numpy()
        label, gt = None, None
    else:
        # The reference counts images 1-based.
        img, label, gt = _dataset(args.data)[max(args.eval_img_index - 1, 0)]
    disp = preprocess.to_display_uint8(torch.from_numpy(img)).numpy()
    return img, disp, label, gt


def _state_dict(path: str) -> dict:
    """A torch state dict from ``.pth`` / ``.pth.tar``: the top level or its
    ``state_dict`` entry, with DataParallel's ``module.`` prefix stripped."""
    if not path.endswith((".pth", ".pth.tar")):
        raise ValueError(f"--ckpt {path}: only torch state dicts (.pth, .pth.tar) are read "
                         "so far; the other checkpoint formats wait for ROADMAP A15")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("state_dict", blob)
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def build_engine(args):
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    bundle = create_model(args.arch, args.dataset, dtype=dtype)
    if args.ckpt:
        state_dict = _state_dict(args.ckpt)
    else:
        print("[warn] no --ckpt: random-initialized weights", file=sys.stderr)
        state_dict = bundle.init(args.seed)
    return SaliencyEngine(bundle, state_dict, mask_batch=args.mask_batch, device=args.device)


def segment_display(disp: np.ndarray, cfg: SegmentConfig, device=None) -> np.ndarray:
    """Segment a display image; SLIC runs on ``device`` (a CLI's ``--device``)."""
    from network_interpretation_imagenet_tpu_torch.segment.common import segment_image

    return segment_image(disp, cfg, device)


def fidelity_entries(engine, image, heatmap, target: int, gt_bbox) -> dict:
    """``--fidelity``'s payload entries: deletion and insertion AUC (one
    batched forward of both curves), and the pointing game with a gt box."""
    from network_interpretation_imagenet_tpu_torch.saliency.eval_metrics import (
        deletion_insertion_auc,
        pointing_game,
    )

    fm = deletion_insertion_auc(engine, image, heatmap, int(target))
    entries = {"deletion_auc": round(fm["deletion_auc"], 4),
               "insertion_auc": round(fm["insertion_auc"], 4)}
    if gt_bbox is not None:
        entries["pointing_game_hit"] = bool(pointing_game(heatmap, gt_bbox))
    return entries

# --- artifacts -------------------------------------------------------------


def write_heatmap_png(path: str, heat: np.ndarray) -> None:
    from network_interpretation_imagenet_tpu_torch.ops import aggregate, colormap

    _imwrite(path, colormap.apply_jet(aggregate.normalize_to_uint8_np(heat)))


def _imwrite(path: str, bgr: np.ndarray) -> None:
    """Write a BGR (or gray) uint8 image, as ``cv2.imwrite`` would, with PIL."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(bgr[:, :, ::-1].copy() if bgr.ndim == 3 else bgr).save(path)


def save_mask_npz(path: str, **arrays) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **arrays)


def save_mask_pngs(out_dir: str, masks: np.ndarray, labels: np.ndarray) -> None:
    """Reference artifact parity: ``masks/mask_{i}_{0|1}.png``, 255 = keep."""
    os.makedirs(out_dir, exist_ok=True)
    for i, (m, lab) in enumerate(zip(masks, labels)):
        _imwrite(os.path.join(out_dir, f"mask_{i}_{int(lab)}.png"), m.astype(np.uint8) * 255)


def emit_result(out_dir: str, name: str, payload: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(payload, f, indent=2, default=str)
    print(json.dumps(payload, default=str))
