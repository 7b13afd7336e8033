"""Shared CLI plumbing (port of the part of ``cli/common.py`` that the
ported CLIs use): flags, image and engine resolution, artifact writers.

The flag names are the JAX package's. ``--device {cuda,cpu}`` takes the
place of ``--platform``; the flags that served only XLA's compilation cache
and ``--local-devices`` are not here. PIL is imported only where an image is
read or written.
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
from network_interpretation_imagenet_tpu_torch.models import ALL_ARCHS

# Architecture flags restored from a checkpoint on --resume, so that the
# rebuilt model matches the saved weights (the reference's arch_resume_names).
ARCH_RESUME_NAMES = ("arch", "depth", "death_mode", "death_rate", "growth_rate", "bn_size",
                     "compression")


def apply_arch_resume(args, arch_args: Optional[dict]) -> None:
    """Overwrite ``args``' architecture flags from a checkpoint's saved
    ``arch_args`` (nothing where the checkpoint has none)."""
    for name in ARCH_RESUME_NAMES:
        if arch_args and name in arch_args:
            val = arch_args[name]
            setattr(args, name, val.item() if hasattr(val, "item") else val)


def build_parser(description: str, dataset_default: str = "imagenet") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    g = p.add_argument_group("data")
    g.add_argument("--data", default=None,
                   help="imagenet: an ImageNet-localization root (LOC_val_solution.csv + "
                        "synset dirs) or a class-subdirectory image folder; mnist: the IDX "
                        "files' directory; cifar*: the python pickles' directory; none: a "
                        "synthetic image")
    g.add_argument("--dataset", default=dataset_default, choices=sorted(DATASETS))
    g.add_argument("--synthetic", action="store_true",
                   help="use a deterministic synthetic image (no dataset needed)")
    g.add_argument("--eval_img_index", type=int, default=1,
                   help="index of the evaluation image, 1-based (reference flag)")
    g.add_argument("--workers", "-j", type=int, default=4,
                   help="decode/prefetch threads for real-data sweeps "
                        "(reference DataLoader num_workers; 0 = serial)")

    g = p.add_argument_group("model")
    g.add_argument("--arch", "-a", default="resnet18", choices=ALL_ARCHS)
    g.add_argument("--depth", "-d", type=int, default=56,
                   help="depth of the CIFAR resnet / densenet")
    g.add_argument("--death-mode", default="none", choices=["none", "linear", "uniform"])
    g.add_argument("--death-rate", type=float, default=0.5)
    g.add_argument("--growth-rate", type=int, default=12, help="DenseNet growth rate")
    g.add_argument("--bn-size", type=int, default=4, help="DenseNet bottleneck ratio")
    g.add_argument("--compression", type=float, default=0.5, help="DenseNet compression ratio")
    g.add_argument("--ckpt", default=None,
                   help="weights: a weights artifact (a directory or .msgpack from "
                        "cli.convert_checkpoint, either package's), a torch checkpoint "
                        "(.pth / .pth.tar / .tar, torchvision's or the reference's keys) or "
                        "a checkpoint directory (utils.checkpoint)")
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
                   help="default: the reference's per dataset, 50 imagenet, 5 mnist, 10 cifar")
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
    min_size = args.min_size
    if min_size is None:  # the reference's per-dataset defaults
        min_size = (5 if args.dataset == "mnist" else 10 if args.dataset.startswith("cifar")
                    else 50)
    return SegmentConfig(method=args.segmenter, scale=args.scale, sigma=args.sigma,
                         min_size=min_size, n_segments=args.n_segments)


@functools.lru_cache(maxsize=4)
def _cached_dataset(data_dir: str, raw_u8: bool = False):
    """The dataset at ``data_dir``, parsed once per process (multi-image
    runs read one image per index): ImageNet localization where
    ``LOC_val_solution.csv`` exists, else a class-subdirectory folder (the
    reference's ImageFolder path, no gt boxes). ``raw_u8`` yields uint8
    images for the sweep's uint8 wire."""
    if os.path.exists(os.path.join(data_dir, "LOC_val_solution.csv")):
        from network_interpretation_imagenet_tpu_torch.data.imagenet_loc import (
            ImagenetLocalizationDataset,
        )

        return ImagenetLocalizationDataset(data_dir, raw_u8=raw_u8)
    from network_interpretation_imagenet_tpu_torch.data.image_folder import ImageFolderDataset

    return ImageFolderDataset(data_dir, raw_u8=raw_u8)


@functools.lru_cache(maxsize=4)
def _cached_arrays(dataset: str, data_dir: str):
    """The MNIST or CIFAR test set at ``data_dir``, read once per process."""
    from network_interpretation_imagenet_tpu_torch.data import loaders

    if dataset == "mnist":
        return loaders.load_mnist_dir(data_dir, train=False)
    load = loaders.load_cifar100_dir if dataset.startswith("cifar100") else loaders.load_cifar10_dir
    return load(data_dir, train=False)


def resolve_image(args) -> Tuple[np.ndarray, np.ndarray, Optional[int], Optional[np.ndarray]]:
    """-> (normalized f32 HWC image, display uint8 image, label?, gt_bbox?).
    The display is HWC, or HW gray for MNIST; the synthetic image keeps its
    first channel for a one-channel dataset."""
    from network_interpretation_imagenet_tpu_torch.ops import preprocess

    spec = DATASETS[args.dataset]
    if args.synthetic or not args.data:
        from network_interpretation_imagenet_tpu_torch.data.synthetic import (
            synthetic_imagenet_image,
        )

        base = synthetic_imagenet_image(args.seed + args.eval_img_index, spec.image_size)
        base = base[:, :, :spec.channels]
        img = preprocess.normalize(torch.from_numpy(np.ascontiguousarray(base)), spec.mean,
                                   spec.std).numpy()
        disp = preprocess.to_display_uint8(torch.from_numpy(img)).numpy()
        return img, (disp[:, :, 0] if spec.channels == 1 else disp), None, None
    i = max(args.eval_img_index - 1, 0)  # the reference counts images 1-based
    if args.dataset == "imagenet":
        img, label, gt = _cached_dataset(args.data)[i]
        return img, preprocess.to_display_uint8(torch.from_numpy(img)).numpy(), label, gt
    xs, ys = _cached_arrays(args.dataset, args.data)
    if args.dataset == "mnist":
        img = xs[i]
        return img, (img[:, :, 0] * 255).astype(np.uint8), int(ys[i]), None
    img = preprocess.normalize(torch.from_numpy(xs[i]), spec.mean, spec.std).numpy()
    return img, preprocess.to_display_uint8(torch.from_numpy(img)).numpy(), int(ys[i]), None


def build_engine(args, num_classes: Optional[int] = None):
    """The engine of ``--arch`` on ``--device``, its weights from ``--ckpt``:
    a weights artifact (through ``utils.convert.from_jax``), a torch
    checkpoint (``utils.convert.convert_checkpoint``) or a checkpoint
    directory holding flax-style ``params`` / ``batch_stats``
    (``utils.checkpoint``); seeded random weights without one."""
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
    from network_interpretation_imagenet_tpu_torch.utils import convert

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    bundle = create_model(args.arch, args.dataset, num_classes=num_classes, dtype=dtype,
                          depth=args.depth, death_mode=args.death_mode,
                          death_rate=args.death_rate, growth_rate=args.growth_rate,
                          bn_size=args.bn_size, compression=args.compression)
    ckpt = args.ckpt
    if ckpt and convert.is_weights_artifact(ckpt):
        variables, meta = convert.load_weights_artifact(ckpt)
        if meta.get("arch") and meta["arch"] != args.arch:
            raise ValueError(f"--ckpt artifact was converted for arch {meta['arch']!r} "
                             f"but --arch is {args.arch!r}")
        state_dict = convert.from_jax(variables, bundle.module)
    elif ckpt and ckpt.endswith((".pth.tar", ".pth", ".tar")):
        state_dict = convert.convert_checkpoint(ckpt, args.arch, depth=args.depth,
                                                bn_size=args.bn_size)
    elif ckpt:
        from network_interpretation_imagenet_tpu_torch.utils.checkpoint import restore_checkpoint

        blob = restore_checkpoint(os.path.dirname(ckpt) or ".", os.path.basename(ckpt))
        if blob is None:
            raise FileNotFoundError(f"--ckpt {ckpt}: no checkpoint there")
        variables = {"params": blob["params"]}
        if "batch_stats" in blob:
            variables["batch_stats"] = blob["batch_stats"]
        state_dict = convert.from_jax(variables, bundle.module)
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
