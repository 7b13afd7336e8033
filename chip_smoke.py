#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives network_interpretation_imagenet_tpu_torch's main path at full width
(ResNet-101, 224x224, bf16, seeded random weights), every other classifier
of the JAX package at its published size, and holds every hand-written
kernel against its plain PyTorch version on the card:

  1. device: torch/CUDA versions, the card's name and power limit;
  2. build: compiles csrc/*.cu from the checkout (one nvcc per source, in
     parallel) into the package's _build/;
  3. B1 masked_batch vs its plain version, bf16 and f32, bit-exact, at the
     random-window chunk (K=256), the BO loop's K = 1 and 3 with the width
     read on the device, and into an out= slice of a larger buffer; and at
     the new archs' shapes, 28x28x1 (MNIST: the generic C=1 instance),
     32x32x3 (CIFAR) and 299x299x3 (Inception-v3: H*W*C not a multiple of
     8, so scalar loads at row ends and scalar stores), each at K = 256
     (the engine's chunk), 1,000 and 1,024, with device time, plain time
     and bytes bound at 1,024;
  4. B2 bottleneck_chain vs its plain version at all four ResNet-101 stage
     shapes with the real block counts, block by block within bf16
     tolerance, at B = 1 and 3 (the single-image BO loop's), 8 and 24 (the
     N=8 loop's), 32 and 256, 4 and 12 (the sweep's flushes of 4 images: a
     predict or a BO iteration, the BO pre-samples) and 100 (the window
     CLIs' default chunk); f32 at B = 1, 2 and 256 (the f32 sweep's
     predicts and chunk) at all four shapes and at B=4 at two; per stage at B=256 its
     time, TFLOP/s, share of its bound, the floor of three launches per
     block and a bf16 cuDNN yardstick; at the BO's batches the same
     yardstick eager, and (last of all, [B2 graphs]) with the kernel as CUDA
     graph replays; the built library's SASS must hold HGMMA (wgmma)
     instructions;
  5. the random-window path: Felzenszwalb -> predict_one ->
     random_window_saliency (1024 masks) -> localization_score, with the
     launch counters reset just before and read just after, then
     kernel-path vs plain-path logits of the whole model on 32 masked images;
  6. timings of that path: warm masked-forward evals/s and p50 latency;
  7. the BO path (bo_window_saliency, 3 + 10 evaluations), from an empty
     runner cache, each call with the counters reset just before and read
     just after: the first call runs eagerly (B1 11, B2 44), the second
     captures one CUDA graph (B1 11, B2 44) and replays it, the third only
     replays (no launch from Python); the replays must equal the eager run,
     the scores must match the random-window engine's on the same starts,
     and a profiler trace of one replay must hold B1 and B2. The host loop
     (B1 11, B2 44); the GP's and EI's proposals on the card vs the CPU on
     the same observations; bo_window_saliency_multi at N=8 with per-image
     seeds (B1 88, B2 44), every image's scores against the engine's;
     [bo timing]: warm p50 latencies (graph, eager, host loop), streams of
     16 distinct images from an empty cache (single calls, and N=8 calls),
     the device's busy share of one replay, the GP step per iteration;
  8. the flagship CLI on the card (main, or explain where PIL or matplotlib
     is missing), counters held (B1 11, B2 48);
  9. [gen]: the random-mask generator's compute (100 window masks and the
     minimal-mask threshold bank) on its own engine (B1 1, B2 12), and its
     parts timed warm;
 10. [resnet18]: the CLIs' default model, ResNet-18 (no B2): its bf16
     folded plan against the plain eval-mode net in f32 (folded_vs_plain),
     and the generator's compute with no --arch (B1 1, B2 0);
 11. [knockout]: knockout_saliency, 1024 masks at M = 1 and 5 (B1 0, B2 16
     each; the heatmap against the bank-free sum), and masked evals/s;
 12. [multi]: eval_window_masks_multi, N=8 x K=128 (B1 8, B2 16), every
     chunk the model receives bit-exact against masked_batch_plain, survive
     agreement with the single-image calls, evals/s;
 13. [gp]: the Kronecker pixel GP (fit + posterior at 224x224, and N=8 in one
     batch) and the variational GP (30 steps, 4,096 pixels, 50,176
     predicted) on the card against the CPU, run with TF32 allowed so that
     the GP's own full-f32 guard is what holds: the same lengthscale, errors
     within stated tolerances, times and the card's busy time;
 14. [gp cli]: gp_superpixel_data_imagenet's compute end to end (B1 1, B2 8);
 15. [attr]: the attribution family at ResNet-101 224 on the seed-0
     synthetic image, with BatchNorm statistics measured on 8 other
     synthetic images (the init's leave every softmax saturated).
     Occlusion (169 positions in chunks of 64), RISE (1000 masks in chunks
     of 250), Score-CAM (64 channels) and deletion_insertion_auc (2 x 33
     images) through B2, in bf16 and in f32 (B2's f32 instance), each with
     its launches held (B1 0; B2 16, 16, 4 and 4) and held against the same
     call through the folded net's plain path on the card: every masked
     forward's logits against the plain path's on the same input (bf16
     within B2_TOL, f32 within B2_F32_TOL of max |plain logit|), each map
     within ATTR_B2_TOL of max |plain map| (a bf16 map that bf16 cannot
     resolve, further from its f32 version than its own maximum, is
     printed only), each AUC within ATTR_AUC_TOL of its curve's range;
     with a profiler trace of a bf16 RISE call that must
     hold B2 kernels; IG,
     SmoothGrad, Grad-CAM, XRAI and the learned mask through the plain
     module (B2 0): f32 on the card against f32 on the CPU (ATTR_F32_TOL of
     max |CPU map| and Spearman ATTR_F32_RHO; the learned mask's first-step
     loss and p(target) within ATTR_LM_TOL)
     and bf16 against f32 on the card (Spearman |rank| correlation printed);
     every map finite and not constant; each method's warm ms;
 16. [attr cli]: compare_saliency_methods --synthetic (its default
     ResNet-18, all 16 methods, 2 images; B2 0), occlusion_saliency --arch
     resnet101 with attr's weights (B1 0, B2 12), attribution_sanity (ResNet-18; B1 0, B2 0) and
     the flagship CLI with --fidelity (B1 11, B2 52);
 17. [slic]: SLIC labels on the card against the CPU (k-means, then the
     connectivity pass and the relabelling), and its time on the card;
 18. [resnext] (run after [resnet18]): Wide-ResNet-50-2 and ResNeXt-50
     32x4d, each folded_vs_plain on 32 masked images and 1024 window masks
     on its own engine (B1 4; B2 16 for Wide, 0 for ResNeXt, whose grouped
     3x3 B2 does not run) with evals/s; Wide-ResNet-101-2's plan at B=4
     (B2 48: its stage 3 is one chain of 22 blocks); Wide-ResNet-50-2's four
     chain shapes (C = 2P, P up to 1024) block by block against the plain
     version and timed at B=256 against bf16 cuDNN and the chain bound, and
     a 22-block chain at C=1024, P=512 block by block;
 19. [sweep] (run before [B2 graphs]): the val-set sweep on 8 synthetic
     images at ResNet-101 bf16, every lane with its launches held: the
     flushes' batched predicts at B = 4 and 12 through B2 against the plain
     path (within 0.05 x max |logit|, as in [main]); streaming windows (1024 masks; each row against the per-image path on
     the same host-sampled starts: target, segments, survival and heatmap
     exact), image_batch=4 windows (bf16 agreement with streaming printed),
     knockouts streaming and at image_batch=4, a journal cut after 3 images
     and resumed (rows and heatmaps equal the uninterrupted run's), the
     device idle share of one streaming sweep, f32 batched rows against
     streaming rows (exact), the BO sweep at image_batch=4 (agreement with
     single-image calls printed), RISE and input-gradient attribution
     sweeps, and the CLI's window, --bo and --attribute rise lanes (4
     images, their own engines);
 20. [B2 graphs], last: B2 and its bf16 cuDNN yardstick as CUDA graph
     replays at the BO's batches and at the attribution family's 41, 64,
     66 and 250 (each of these also checked block by block against the
     plain version at B2_TOL), with the chain bound at each batch;
 21. [zoo] (run after [sweep]): every arch the JAX package explains beyond
     the ImageNet ResNets, at published width and depth with seeded random
     weights, each on its own bf16 engine (its eval-mode module, no B2):
     the MNIST CNN (28x28x1), the CIFAR ResNet-56 and DenseNet-BC-100 k=12
     (cifar10+, 32x32), VGG-16-BN, AlexNet, SqueezeNet 1.1, DenseNet-121,
     GoogLeNet, MobileNetV2, ShuffleNetV2 x1.0, MNASNet 1.0 (224x224) and
     Inception-v3 (299x299). Per arch: the engine's bf16 plan against the
     plain module in f32 on 32 window-masked images (ZOO_TOL of max |logit|)
     and the f32 module on the card against the CPU on 8 (ZOO_F32_TOL);
     B1 bit for bit against its plain version at each of the window path's
     chunks, on the arch's own segments and starts; 1,024 window masks (B1
     4, B2 0) and 1,024 knockouts at M=1 (B1 0, B2 0), with their evals/s
     (median, fastest and slowest of 5-100 warm calls);
 22. [bo zoo]: bo_window_saliency at DenseNet-121 224 bf16 from an empty
     runner cache: the first call eager (B1 11, B2 0), the second captures
     and replays (B1 11, B2 0), the third only replays (B1 0, B2 0); the
     replays equal the eager run;
 23. [gen mnist], [gen cifar]: the two generators' gp-data compute (1,000
     knockouts, M = 1 and 5; B1 0, B2 0) on their own engines, from a
     weights artifact the port wrote (read back bit for bit), with their
     result JSON.

Any failure raises and exits non-zero. The line before the last is the
kernels' JSON record, the last line {"ok": true, "device": {...}}. Without a
CUDA device it exits non-zero and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time
import types

import numpy as np

MASK_BATCH = 256
NUM_SAMPLES = 1024
SEED = 0
H100_BF16_FLOPS = 989e12     # dense tensor-core peak, SXM (NVIDIA data sheet)
H100_BYTES_PER_S = 3.35e12   # HBM3 (NVIDIA data sheet)
STAGES_101 = ((56, 256, 64, 2), (28, 512, 128, 3), (14, 1024, 256, 22), (7, 2048, 512, 2))
SWEEP_BATCH = 4              # the [sweep] phase's image_batch for the flushed lanes
CLI_MASKS = 100              # the CLIs' default --num_mask_samples: one chunk of 100
# B2's block-by-block batches: the BO loops', 32, the main path's chunk, and
# every batch the sweep's lanes give it (a flush's predict and BO iteration
# at SWEEP_BATCH, its BO pre-samples at 3 * SWEEP_BATCH, the CLIs' chunk).
B2_BATCHES = (1, 3, SWEEP_BATCH, 8, 3 * SWEEP_BATCH, 24, 32, CLI_MASKS, MASK_BATCH)
B2_F32_BATCHES = (1, 2, MASK_BATCH)   # the f32 sweep lane's: predicts at 1 and 2, its chunk
B2_TOL = 2e-2                # bf16: rtol = atol; one bf16 ulp is 2^-8 relative
B2_F32_TOL = 1e-4            # f32 instance: summation order only
BO_IMAGES = 8                # bo_window_saliency_multi's N
BO_BATCHES = (1, 3, 8, 24)   # the BO loops' forwards: single image, and N=8 images
BO_SCORE_TOL = 0.05          # a BO score vs the engine's at another batch (bf16 rounding)
MULTI_K = 128                # masks per image of the N=8 multi-image window grid
# Wide-ResNet-50-2's chains (H, C, P, blocks): C = 2P, P = 2 * planes.
WIDE_STAGES_50 = ((56, 256, 128, 2), (28, 512, 256, 3), (14, 1024, 512, 5), (7, 2048, 1024, 2))
SWEEP_IMAGES = 8             # the [sweep] phase's synthetic images
# GP card vs CPU on this script's inputs. Errors read on an H100 with full
# f32 products: Kronecker 3.1e-5, -ELBO 1.5e-4, p(y=1) 5.9e-4; with the
# variational fit's backward left to TF32, p(y=1) 1.6e-3 and -ELBO 2.1e-4.
GP_TOL = 1e-4                # Kronecker GP: relative to the tensor's scale
VGP_LOSS_TOL = 5e-4          # variational GP's -ELBO history: relative
VGP_PROB_TOL = 1e-3          # its p(y=1): absolute
NET_TOL = 2e-2               # a bf16 folded plan vs its plain f32 net: x max|logit| (2^-8 = 3.9e-3)
# Occlusion's last chunk (169 = 2 x 64 + 41), occlusion / Score-CAM chunks,
# both fidelity curves, RISE chunks.
ATTR_BATCHES = (41, 64, 66, 250)
ATTR_B2_TOL = 2e-2           # a B2-path map vs the plain path's: x max |plain map|
ATTR_AUC_TOL = 2e-2          # a fidelity AUC, B2 path vs plain path: x the curve's range
# Gradient maps, f32 card vs f32 CPU: max err x max |CPU map|, and the
# Spearman |rank| correlation. The two sum in other orders, and on these
# random weights an f32 gradient map is itself far from float64's: on the
# CPU, IG (4 steps) 4.6e-2 max / 2.9e-2 L2 off, Spearman 0.9989; SmoothGrad
# 2.5e-2 / 1.3e-2, 0.9996. The card's first run read IG 4.4e-2 off the CPU.
ATTR_F32_TOL = 1e-1
ATTR_F32_RHO = 0.99
# The learned mask's first-step loss and p(target), card vs CPU: relative.
# (After 3 steps the CPU's own f32 mask is Spearman 0.82 from float64's, its
# loss 2.8 % off: Adam's near-sign steps amplify the gradients' rounding.)
ATTR_LM_TOL = 1e-3
# B1 at the new archs' shapes: MNIST, CIFAR, Inception-v3; K the engine's
# chunk (the [zoo] window path's launches), the generators' default and 1,024.
B1_SHAPES = ((28, 28, 1), (32, 32, 3), (299, 299, 3))
B1_KS = (MASK_BATCH, 1000, 1024)
# [zoo]: (arch, dataset, create_model kwargs) at published width and depth.
ZOO = (("mnist_cnn", "mnist", {}), ("resnet", "cifar10+", {"depth": 56}),
       ("densenet", "cifar10+", {"depth": 100}), ("vgg16_bn", "imagenet", {}),
       ("alexnet", "imagenet", {}), ("squeezenet1_1", "imagenet", {}),
       ("densenet121", "imagenet", {}), ("googlenet", "imagenet", {}),
       ("mobilenet_v2", "imagenet", {}), ("shufflenet_v2_x1_0", "imagenet", {}),
       ("mnasnet1_0", "imagenet", {}), ("inception_v3", "imagenet", {}))
ZOO_TOL = 0.05               # a bf16 plan vs the plain f32 module: x max |logit|, as [main]
ZOO_F32_TOL = 1e-4           # the f32 module, card vs CPU: x max |logit|, as [main]'s f32 engine
PKG = "network_interpretation_imagenet_tpu_torch"


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps):
    """Mean device milliseconds per call, CUDA events around ``reps`` warm calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps, prefix):
    """Mean device milliseconds of the kernels whose symbol starts with
    ``prefix``, over the last ``reps`` of ``reps + 1`` warm calls under
    torch.profiler (a trace may lose its first kernel). For a kernel shorter
    than its wrapper's host cost, back-to-back CUDA-event timing measures the
    host instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps + 1):
            fn()
        torch.cuda.synchronize()
    launches = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA and prefix in e.name),
                      key=lambda e: e.time_range.start)
    if len(launches) < reps:
        raise AssertionError(f"profiler saw {len(launches)} {prefix} kernels in {reps + 1} calls")
    return sum(e.device_time for e in launches[-reps:]) / reps / 1e3


def conv_us(x, ws):
    """Median device microseconds of each of a block's three B2 launches
    (1x1 reduce, 3x3, 1x1 expand), from the second of two chain calls under
    torch.profiler (a trace may lose its first kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import bottleneck_chain

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            bottleneck_chain(x, ws)
        torch.cuda.synchronize()
    launches = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA and "b2_conv" in e.name),
                      key=lambda e: e.time_range.start)
    times = [e.device_time for e in launches[-3 * (len(ws) // 6):]]  # 3 per block
    return [float(np.median(times[i::3])) for i in range(3)] if times else [0.0] * 3


def synthetic_image(seed, size=224):
    """Coloured shapes on a gradient (uint8 HWC) and the gt box of the largest one."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / (size - 1.0)
    img = np.stack([0.2 + 0.5 * xx, 0.3 + 0.4 * yy, 0.6 - 0.3 * xx * yy], axis=-1)
    for _ in range(60):  # small ellipses: background texture for the segmenter
        cy, cx, ry, rx = rng.rand(4) * (1.0, 1.0, 0.08, 0.08) + (0, 0, 0.02, 0.02)
        img[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1] = rng.rand(3)
    gt = (58, 46, 104, 116)  # x, y, w, h
    img[gt[1]:gt[1] + gt[3], gt[0]:gt[0] + gt[2]] = (0.9, 0.2, 0.1)
    img[gt[1] + 20:gt[1] + 60, gt[0] + 30:gt[0] + 80] = (0.95, 0.85, 0.1)
    img = img + rng.normal(0, 0.02, img.shape)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8), gt


def b2_weights(rng, c, p, n, dtype, device):
    """Folded random weights for n blocks (residual branch scaled 0.3)."""
    import torch

    from network_interpretation_imagenet_tpu_torch.models.common import fold_bn

    ws = []
    for _ in range(n):
        for shape, out in (((c, p), p), ((3, 3, p, p), p), ((p, c), c)):
            std = np.sqrt(2.0 / np.prod(shape[:-1])) * (0.3 if out == c else 1.0)
            w, b = fold_bn(rng.randn(*shape).astype(np.float32) * std,
                           rng.rand(out) + 0.5, rng.randn(out) * 0.1,
                           rng.randn(out) * 0.1, rng.rand(out) + 0.5)
            ws += [torch.from_numpy(w).to(device, dtype).contiguous(),
                   torch.from_numpy(b).to(device)]
    return ws


def b2_costs(h, c, p, n, batch):
    """(operations, bytes, floor ms) of one chain call. The bytes count x read
    and y written once, and the weights and biases once per block (the chain
    bound). The floor charges each of a block's three convolutions
    max(operations / peak, its own bytes / bandwidth): the least time of a
    design that keeps three launches per block, with t1 and t2 in device
    memory."""
    m = batch * h * h
    flops = (4 * c * p + 18 * p * p) * m * n   # reduce 2mcp + 3x3 18mp^2 + expand 2mpc
    nbytes = 2 * m * c * 2 + n * ((2 * c * p + 9 * p * p) * 2 + (2 * p + c) * 4)
    convs = ((2 * m * c * p, (m * c + m * p + c * p) * 2 + 4 * p),                # 1x1 reduce
             (18 * m * p * p, (2 * m * p + 9 * p * p) * 2 + 4 * p),                # 3x3
             (2 * m * p * c, (m * p + 2 * m * c + p * c) * 2 + 4 * c))             # 1x1 expand
    floor = n * sum(max(f / H100_BF16_FLOPS, b / H100_BYTES_PER_S) for f, b in convs) * 1e3
    return flops, nbytes, floor


def sass_hgmma(so_path):
    """Counts the HGMMA (wgmma) instructions in a built library's SASS, with
    the CUDA toolkit's cuobjdump or the copy Triton ships."""
    import glob
    import os
    import shutil

    tools = [shutil.which("cuobjdump"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")]
    try:
        import triton

        tools += glob.glob(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia",
                                        "bin", "cuobjdump"))
    except ImportError:
        pass
    tool = next((t for t in tools if t and os.path.isfile(t)), None)
    if tool is None:
        raise RuntimeError("no cuobjdump found for the SASS check")
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout
    return sum("HGMMA" in line for line in sass.splitlines())


def check_chain(x, ws, tol):
    """Kernel vs plain, block by block on the kernel's own input: each block's
    max |kernel - plain| must stay within ``tol`` * max |plain|. (The two sum
    in different orders, so a bf16 intermediate can round one ulp apart; that
    moves an output by up to ulps of the intermediates' magnitude, not of its
    own value, hence the tensor's scale.) Returns the worst block error, the
    count of elements outside the elementwise rtol = atol = ``tol`` test, and
    the whole chain's error (reported, not held: it compounds over blocks)."""
    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import (
        bottleneck_chain,
        bottleneck_chain_plain,
    )

    chain_err = (bottleneck_chain(x, ws).float()
                 - bottleneck_chain_plain(x, ws).float()).abs().max().item()
    block_err, outside = 0.0, 0
    for i in range(len(ws) // 6):
        y = bottleneck_chain(x, ws[6 * i:6 * i + 6])
        a, b = y.float(), bottleneck_chain_plain(x, ws[6 * i:6 * i + 6]).float()
        err = (a - b).abs()
        scale = b.abs().max().item()
        if not err.max().item() <= tol * scale:
            raise AssertionError(f"B2 block {i}: max err {err.max().item()} > {tol} * {scale}")
        block_err = max(block_err, err.max().item())
        outside += int((err > tol + tol * b.abs()).sum().item())
        x = y
    return block_err, outside, chain_err


def cudnn_chain(x, ws):
    """Yardstick only (the port never calls it): the same blocks as bf16
    cuDNN convolutions on channels_last tensors. Returns a closure that runs
    them, with the weights laid out for cuDNN beforehand."""
    import torch
    import torch.nn.functional as F

    cl = torch.channels_last
    blocks = []
    for i in range(len(ws) // 6):
        w1, b1, w3, b3, w2, b2 = ws[6 * i:6 * i + 6]
        blocks.append((w1.t()[:, :, None, None].contiguous(memory_format=cl), b1.to(x.dtype),
                       w3.permute(3, 2, 0, 1).contiguous(memory_format=cl), b3.to(x.dtype),
                       w2.t()[:, :, None, None].contiguous(memory_format=cl), b2.to(x.dtype)))

    def run():
        y = x.permute(0, 3, 1, 2)
        for w1, b1, w3, b3, w2, b2 in blocks:
            t = torch.relu(F.conv2d(y, w1, b1))
            t = torch.relu(F.conv2d(t, w3, b3, padding=1))
            y = torch.relu(F.conv2d(t, w2, b2) + y)
        return y

    return run


def graphed(fn):
    """``fn`` captured as one CUDA graph (after two warm-up calls on a side
    stream); time its ``replay`` for device time without Python's launch cost."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def busy_ms(fn):
    """One call of ``fn`` under torch.profiler: (wall ms to the end of a
    device sync, ms covered by the union of its device intervals)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    union, reach = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA):
        if b > reach:
            union += b - max(a, reach)
            reach = b
    return wall * 1e3, union / 1e3


def device_breakdown(fn):
    """Runs ``fn`` once under torch.profiler; returns (wall s, device ms by
    group, the six largest "other" kernels) with groups B1, B2 and everything
    else (cuDNN, elementwise, copies), summed over device-side events only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups = {"B2 bottleneck_chain": 0.0, "B1 masked_batch": 0.0, "other": 0.0}
    others = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host ops: their kernels appear as device events of their own
        # The kernels' symbols carry their id as a prefix (b2_conv_wgmma, b2_conv_f32,
        # b1_masked_batch), so a rename inside a family cannot move them into "other".
        group = ("B2 bottleneck_chain" if "b2_conv" in e.key else
                 "B1 masked_batch" if "b1_masked_batch" in e.key else "other")
        groups[group] += e.device_time_total / 1e3
        if group == "other":
            others[e.key[:60]] = others.get(e.key[:60], 0.0) + e.device_time_total / 1e3
    if sum(groups.values()) > 0 and not (groups["B2 bottleneck_chain"] > 0
                                         and groups["B1 masked_batch"] > 0):
        raise AssertionError(f"profile: device time seen, but no B1 or B2 kernel in it: {groups}")
    top = sorted(others.items(), key=lambda kv: -kv[1])[:6]
    return wall, groups, top


def p50_ms(fn, reps):
    """Median host milliseconds of ``reps`` warm calls that end in a device
    sync (each BO call ends in its device-to-host copy)."""
    import torch

    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def replay_ms(graph, reps):
    """Mean device milliseconds of one replay of a captured CUDA graph."""
    return time_ms(graph.replay, reps)


def replay_trace(graph):
    """One replay of a captured CUDA graph under torch.profiler. Returns
    (wall ms from replay() to the end of the device sync, the trace's device
    span from the first interval's start to the last one's end, ms covered by
    the union of its device intervals, device ms by group), all from this one
    profiled call. The busy share is union / span: the wall also holds the
    profiler's own start and stop. Raises unless the trace holds B1 and B2
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = []
    groups = {"B2 bottleneck_chain": 0.0, "B1 masked_batch": 0.0, "other": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        group = ("B2 bottleneck_chain" if "b2_conv" in e.name else
                 "B1 masked_batch" if "b1_masked_batch" in e.name else "other")
        groups[group] += (e.time_range.end - e.time_range.start) / 1e3
    if not (groups["B2 bottleneck_chain"] > 0 and groups["B1 masked_batch"] > 0):
        raise AssertionError(f"graph replay trace: no B1 or no B2 kernel in it: {groups}")
    union, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > reach:
            union += b - max(a, reach)
            reach = b
    span = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3
    return wall * 1e3, span, union / 1e3, groups


def counted(by_path, path, fn, want_b1, want_b2):
    """Runs ``fn`` with the kernels' launch counters set to 0 just before and
    read just after; records them under ``path`` and raises unless they are
    B1 ``want_b1`` and B2 ``want_b2``."""
    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import bottleneck_chain
    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import masked_batch

    masked_batch.launches = 0
    bottleneck_chain.launches = 0
    result = fn()
    got = {"masked_batch": masked_batch.launches, "bottleneck_chain": bottleneck_chain.launches}
    if got != {"masked_batch": want_b1, "bottleneck_chain": want_b2}:
        raise AssertionError(f"{path}: launched {got}, want B1 {want_b1} and B2 {want_b2}")
    by_path[path] = got
    return result


def ei_card_vs_cpu(xp, yp, n_pre, upper, dev):
    """The fused loop's and the host loop's acquisition on the card and on
    the CPU for the same observations (a BO trace), at every iteration.
    Returns (max |EI card - EI CPU|, iterations whose argmax is held, their
    count, near-ties skipped): an iteration is held to the same argmax
    unless the CPU's top two stand closer than twice the EI error."""
    import torch

    from network_interpretation_imagenet_tpu_torch.bo import acquisition, loop
    from network_interpretation_imagenet_tpu_torch.gp import exact

    m = len(xp)
    n_cand = loop.next_pow2(upper + 1)
    eis = {}
    for d in (dev, torch.device("cpu")):
        grid = torch.tensor(loop.LENGTHSCALE_GRID, device=d)
        cand = torch.arange(n_cand, dtype=torch.float32, device=d)
        xs = torch.tensor(xp, dtype=torch.float32, device=d)[None]
        ys = torch.tensor(yp, dtype=torch.float32, device=d)[None]
        slots = torch.arange(m, device=d)
        gp = exact.incremental_init(m, (1, grid.shape[0]), device=d)
        out = []
        for i in range(m - 1):
            buf = torch.where(slots <= i, xs, torch.zeros_like(xs))
            gp = exact.incremental_add(gp, buf[:, None, :], i, xs[:, i, None], grid, 1e-5)
            if i + 1 >= n_pre:
                ys_n = torch.where(slots < i + 1, ys, torch.zeros_like(ys))
                out.append(loop.fused_ei(gp, buf, ys_n, i + 1, cand, grid,
                                         cand[None] <= upper)[0].cpu())
        for n in range(n_pre, m):
            fit = exact.fit_lengthscale_sweep(xs[0, :n, None], ys[0, :n], grid)
            out.append(acquisition.ei_over_candidates(fit, cand[:upper + 1, None], ys[0, :n]).cpu())
        eis[d.type] = out
    err, held, ties = 0.0, 0, 0
    for card, cpu in zip(eis["cuda"], eis["cpu"]):
        ok = torch.isfinite(cpu)
        if not torch.equal(ok, torch.isfinite(card)):
            raise AssertionError("EI: the card and the CPU disagree on which candidates are finite")
        e = (card[ok] - cpu[ok]).abs().max().item()
        err = max(err, e)
        top = torch.topk(cpu, 2)
        if top.values[0] - top.values[1] <= 2 * e:
            ties += 1
            continue
        held += 1
        if int(torch.argmax(card)) != int(top.indices[0]):
            raise AssertionError(f"EI: the card proposes {int(torch.argmax(card))}, the CPU "
                                 f"{int(top.indices[0])}")
    return err, held, ties


def bo_phase(engine, image, segments, target, smi, by_path):
    """The BO path at full ResNet-101 bf16 (see the module docstring, 7).
    Records each BO path's launches in ``by_path``."""
    import torch

    from network_interpretation_imagenet_tpu_torch.bo.loop import make_fused_window_bo, next_pow2
    from network_interpretation_imagenet_tpu_torch.config import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        BOConfig,
        SegmentConfig,
    )
    from network_interpretation_imagenet_tpu_torch.ops.preprocess import (
        normalize,
        to_display_uint8,
    )
    from network_interpretation_imagenet_tpu_torch.saliency.bo_pipeline import (
        bo_window_saliency,
        bo_window_saliency_multi,
        fused_runner,
    )
    from network_interpretation_imagenet_tpu_torch.segment.common import segment_image_batch

    cfg = BOConfig()
    n_obs, n_fwd = cfg.n_pre_samples + cfg.n_iters, 1 + cfg.n_iters
    s = int(segments.max()) + 1
    upper = int(0.6 * s)

    def explain(**kw):
        return bo_window_saliency(engine, image, segments, cfg, seed=SEED, target=target, **kw)

    def check(trace, what, up=upper):
        if len(trace.xp) != n_obs or trace.xp.max() > up or trace.xp.min() < 0:
            raise AssertionError(f"{what}: starts {trace.xp.tolist()} (want {n_obs} in [0, {up}])")
        if not (np.isfinite(trace.yp).all() and (trace.yp >= 0).all() and (trace.yp <= 1).all()):
            raise AssertionError(f"{what}: scores {trace.yp.tolist()} outside [0, 1]")

    def score_err(img, segs, out, trace, tgt, what):
        """A trace's scores and survive labels against the random-window
        engine's on the same starts (one forward of all 13, B1 and B2 at
        another batch): labels equal, scores within BO_SCORE_TOL."""
        res = engine.eval_window_masks(img, segs, trace.xp, out.width, tgt)
        err = float(np.abs(res.prob_target - trace.yp).max())
        if not (err <= BO_SCORE_TOL and np.array_equal(res.survived, trace.survived)):
            raise AssertionError(f"{what}: scores {trace.yp.tolist()} vs the engine's "
                                 f"{res.prob_target.tolist()} on the same starts")
        return err

    # The path as users run it, from an empty cache: the first call of the
    # shape runs eagerly, the second captures the graph and replays it, the
    # third replays it (no Python launch).
    engine.fused_runners.clear()
    first_ms = []

    def timed_explain():
        t0 = time.perf_counter()
        result = explain()
        first_ms.append((time.perf_counter() - t0) * 1e3)
        return result

    out, eager = counted(by_path, "bo_fused_first_call", timed_explain, n_fwd, 4 * n_fwd)
    check(eager, "fused eager")
    _, graph = counted(by_path, "bo_fused_capture", timed_explain, n_fwd, 4 * n_fwd)
    _, replayed = counted(by_path, "bo_fused_replay", explain, 0, 0)
    check(graph, "fused graph")
    ys_err = float(np.abs(graph.yp - eager.yp).max())
    if not (np.array_equal(graph.xp, eager.xp) and np.array_equal(graph.survived, eager.survived)
            and ys_err <= 1e-6):
        raise AssertionError(f"graph replay {graph.xp.tolist()} vs eager {eager.xp.tolist()}, "
                             f"ys err {ys_err}")
    if not (np.array_equal(replayed.xp, graph.xp) and np.array_equal(replayed.yp, graph.yp)):
        raise AssertionError("a second replay differs from the first")
    eng_err = score_err(image, segments, out, graph, target, "fused graph")
    run = fused_runner(engine, next_pow2(upper + 1), cfg, 1)
    (replay_graph, _, _), = (e for e in run.graphs.values() if e is not None)
    wall, span, union, groups = replay_trace(replay_graph)
    replay_events_ms = replay_ms(replay_graph, 10)
    log(f"[bo] S={s} upper={upper} width={out.width} target={target}: first call (eager) xp "
        f"{eager.xp.tolist()} yp {[round(float(v), 4) for v in eager.yp]} survived "
        f"{int(eager.survived.sum())}/{n_obs}; launches first call / capture / replay "
        + " / ".join(json.dumps(by_path[k]) for k in
                     ("bo_fused_first_call", "bo_fused_capture", "bo_fused_replay"))
        + f"; replays equal the eager run (ys err {ys_err:.3g}); scores vs the engine on the "
        f"same starts: max err {eng_err:.3g}; replay trace kernels by name "
        + json.dumps({k: round(v, 3) for k, v in groups.items()}))

    # The host loop.
    _, host = counted(by_path, "bo_host_loop", lambda: explain(fused=False), n_fwd, 4 * n_fwd)
    check(host, "host loop")
    log(f"[bo] host loop xp {host.xp.tolist()} survived {int(host.survived.sum())}/{n_obs}; "
        f"launches {json.dumps(by_path['bo_host_loop'])}")

    # GP and EI on the card vs the CPU, on the graph run's observations.
    ei_err, held, ties = ei_card_vs_cpu(graph.xp, graph.yp, cfg.n_pre_samples, upper,
                                        torch.device("cuda"))
    log(f"[bo] GP + EI card vs CPU on the trace: max EI err {ei_err:.3g}; same proposal in "
        f"{held} steps, {ties} near-ties not held")

    # 2 x N distinct images (image 0 is the path's); N in one program, per-image seeds.
    pool = [image] + [
        normalize(torch.from_numpy(synthetic_image(SEED + i)[0].astype(np.float32) / 255.0),
                  IMAGENET_MEAN, IMAGENET_STD).numpy() for i in range(1, 2 * BO_IMAGES)]
    pool_segs = [segments] + segment_image_batch(
        [to_display_uint8(torch.from_numpy(im)).numpy() for im in pool[1:]], SegmentConfig())
    pool_targets = [target] + engine.predict(np.stack(pool[1:])).argmax(axis=1).tolist()

    def multi(first, seed0):
        sl = slice(first, first + BO_IMAGES)
        return bo_window_saliency_multi(
            engine, pool[sl], pool_segs[sl], cfg, targets=pool_targets[sl],
            per_image_seeds=[seed0 + i for i in range(BO_IMAGES)])

    results = counted(by_path, "bo_multi_first_call", lambda: multi(0, SEED),
                      BO_IMAGES * n_fwd, 4 * n_fwd)
    multi_err = 0.0
    for i, (o, tr) in enumerate(results):
        check(tr, f"multi image {i}", int(0.6 * o.num_segments))
        multi_err = max(multi_err, score_err(pool[i], pool_segs[i], o, tr, pool_targets[i],
                                             f"multi image {i}"))
    first = results[0][1]
    if not np.array_equal(first.xp[:cfg.n_pre_samples], graph.xp[:cfg.n_pre_samples]):
        raise AssertionError(f"multi image 0 pre-samples {first.xp.tolist()} vs the single call's "
                             f"{graph.xp.tolist()}")
    agree = float(np.mean(first.xp == graph.xp))
    log(f"[bo] multi N={BO_IMAGES}: segments {[int(g.max()) + 1 for g in pool_segs[:BO_IMAGES]]}; "
        f"launches {json.dumps(by_path['bo_multi_first_call'])}; every image's scores vs the "
        f"engine on the same starts: max err {multi_err:.3g}; image 0's pre-samples equal the "
        f"single call's, {agree:.3f} of its {n_obs} starts equal (bf16 at batch {BO_IMAGES} "
        f"rounds otherwise than at batch 1: reported, not held)")

    # Warm timings: the same image (the program does the same work for any
    # image of the shape, so a replay's time does not depend on the image).
    lat = {"graph": p50_ms(explain, 10), "host": p50_ms(lambda: explain(fused=False), 5)}
    run.cuda_graph = False   # the same runner, eager
    lat["eager"] = p50_ms(explain, 5)
    run.cuda_graph = True

    # Streams of distinct images from an empty cache, capture included: one
    # call per image, then multi calls alternating the two sets of N.
    engine.fused_runners.clear()
    stream = []
    for i in range(len(pool)):
        t0 = time.perf_counter()
        bo_window_saliency(engine, pool[i], pool_segs[i], cfg, seed=SEED + i,
                           target=pool_targets[i])
        stream.append((time.perf_counter() - t0) * 1e3)
    runners = len(engine.fused_runners)
    engine.fused_runners.clear()
    multi_stream = []
    for call in range(8):
        t0 = time.perf_counter()
        multi(BO_IMAGES * (call % 2), SEED + 100 * call)
        multi_stream.append((time.perf_counter() - t0) * 1e3)

    # The GP step alone: fused loops whose classifier is a stub, 10 and 5
    # iterations, as graphs; the slope is one iteration's GP update,
    # acquisition, dedup and B1 launch at K=1.
    def stub(imgs, tgts):
        prob = torch.sigmoid(imgs[:, imgs.shape[1] // 2, imgs.shape[2] // 2, 0].float())
        return prob, prob > 0.5

    gp_ms = {}
    for iters in (10, 5):
        r = make_fused_window_bo(stub, next_pow2(upper + 1), cfg.n_pre_samples, iters,
                                 compute_dtype=engine.compute_dtype, device="cuda")
        args = (image, segments, out.width, target, upper,
                torch.zeros(r.max_obs, dtype=torch.int64))
        r(*args)   # eager
        r(*args)   # capture
        (g, _, _), = (e for e in r.graphs.values() if e is not None)
        gp_ms[iters] = replay_ms(g, 20)
    gp_per_iter = (gp_ms[10] - gp_ms[5]) / 5
    warm = multi_stream[4:]
    log(f"[bo timing] {smi}: bo_window_saliency (ResNet-101 224 bf16, {cfg.n_pre_samples} + "
        f"{cfg.n_iters} evaluations) warm p50 ms: graph {lat['graph']:.2f}, eager "
        f"{lat['eager']:.2f}, host loop {lat['host']:.2f}; from an empty cache: first call "
        f"(eager) {first_ms[0]:.2f} ms, second (capture + replay) {first_ms[1]:.2f} ms")
    log(f"[bo timing] {smi}: stream of {len(pool)} distinct images from an empty cache "
        f"({runners} runners), one bo_window_saliency each: mean {np.mean(stream):.2f} ms, p50 "
        f"{np.median(stream):.2f} ms; per call " + ", ".join(f"{v:.1f}" for v in stream))
    log(f"[bo timing] {smi}: bo_window_saliency_multi N={BO_IMAGES}, 8 calls alternating 2 sets "
        f"of distinct images from an empty cache: {np.mean(multi_stream) / BO_IMAGES:.2f} ms per "
        f"image over all 8 calls, {np.median(warm) / BO_IMAGES:.2f} ms per image warm (p50 of "
        f"calls 5-8); per call " + ", ".join(f"{v:.1f}" for v in multi_stream))
    log(f"[bo timing] {smi}: one graph replay {replay_events_ms:.3f} ms (CUDA events, no "
        f"profiler); one replay's trace: device span {span:.3f} ms, busy {union:.3f} ms (union "
        f"of its intervals), busy share {union / span:.4f} (profiled wall {wall:.3f} ms); GP "
        f"step (stub classifier, graph) "
        f"{gp_per_iter:.4f} ms per iteration (10 iterations {gp_ms[10]:.3f} ms, 5 iterations "
        f"{gp_ms[5]:.3f} ms)")
    return pool[:BO_IMAGES], pool_segs[:BO_IMAGES], pool_targets[:BO_IMAGES]


def cli_phase(by_path):
    """The flagship CLI on the card: main where PIL and matplotlib import
    (it writes the figures), else explain (the whole computation). Its
    engine is its own, so its fused runner's call is a first call (eager):
    B1 11, and B2 4 x (11 + the prediction's forward)."""
    import tempfile

    from network_interpretation_imagenet_tpu_torch.cli import (
        bayesian_active_learning_imagenet as cli,
    )

    try:
        import matplotlib  # noqa: F401
        import PIL  # noqa: F401

        missing = None
    except ImportError as e:
        missing = str(e)
    with tempfile.TemporaryDirectory() as out:
        argv = ["--synthetic", "--arch", "resnet101", "--fused", "--out", out]
        t0 = time.perf_counter()
        if missing is None:
            with contextlib.redirect_stdout(io.StringIO()):  # main prints its payload
                counted(by_path, "cli", lambda: cli.main(argv), 11, 48)
            with open(f"{out}/bo_result.json") as f:
                payload = json.load(f)
            how = "main (PIL and matplotlib import; artifacts written)"
        else:
            payload, _ = counted(by_path, "cli", lambda: cli.explain(cli.parse_args(argv)), 11, 48)
            how = f"explain only, no artifacts ({missing})"
        seconds = time.perf_counter() - t0
    if len(payload["bo_xp"]) != 13 or not all(0.0 <= v <= 1.0 for v in payload["bo_yp"]):
        raise AssertionError(f"cli payload {payload}")
    log(f"[cli] {how}: {len(payload['bo_xp'])} evaluations, num_segments "
        f"{payload['num_segments']}, {seconds:.2f} s with the engine build; launches "
        + json.dumps(by_path["cli"]))


def quiet(fn):
    """Runs ``fn`` with its standard output (a CLI's prints) swallowed."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def gen_phase(engine, smi, by_path):
    """The random-mask generator's compute (cli/generate_gp_training_data_imagenet)
    on the synthetic image, ResNet-101 bf16 on its own engine: the prediction,
    100 window masks (one chunk) and minimal_mask_search's one bank forward:
    B1 1, B2 4 x 3. Its parts are then timed warm on the main engine."""
    import tempfile

    from network_interpretation_imagenet_tpu_torch.cli import common
    from network_interpretation_imagenet_tpu_torch.cli import (
        generate_gp_training_data_imagenet as gen,
    )
    from network_interpretation_imagenet_tpu_torch.saliency.pipeline import (
        minimal_mask_search,
        random_window_saliency,
    )

    with tempfile.TemporaryDirectory() as tmp:
        args = gen.parse_args(["--synthetic", "--arch", "resnet101", "--out", tmp])
        t0 = time.perf_counter()
        payload, result = counted(by_path, "gen", lambda: quiet(lambda: gen.compute(args)), 1, 12)
        seconds = time.perf_counter() - t0
    out, thr = result["out"], result["threshold"]
    levels, keep = payload["levels"], payload["keeps_prediction"]
    if not (np.isfinite(out.heatmap).all() and len(levels) == len(keep) > 0
            and (thr is None or thr in levels)):
        raise AssertionError(f"gen payload {payload}")
    image = common.resolve_image(args)[0]
    target, segments = payload["target"], result["segments"]
    parts = {"predict": p50_ms(lambda: engine.predict_one(image), 3),
             f"{args.num_mask_samples} window masks": p50_ms(lambda: random_window_saliency(
                 engine, image, segments, num_samples=args.num_mask_samples, target=target), 3),
             f"bank of {len(levels)} levels": p50_ms(lambda: minimal_mask_search(
                 engine, image, out.heatmap, target), 3)}
    log(f"[gen] {smi}: compute {seconds * 1e3:.1f} ms with its engine build; S={out.num_segments} "
        f"survived {payload['correct_pred_count']}/{args.num_mask_samples}; {len(levels)} levels, "
        f"threshold {thr}, {sum(keep)} keep the prediction; launches {json.dumps(by_path['gen'])}; "
        "warm parts on the main engine (p50 ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))


def folded_vs_plain(arch, x):
    """``arch``'s bf16 FoldedResNet against its plain eval-mode net in f32 on
    the f32 masked images ``x`` (on the card), seed-SEED weights: logits
    within NET_TOL of their scale, and the same argmax wherever the plain
    net's top two stand further apart than twice that error. Returns
    (bundle, state dict, a summary for the log line)."""
    import torch

    from network_interpretation_imagenet_tpu_torch.models import FoldedResNet, create_model

    bundle = create_model(arch, "imagenet", dtype=torch.bfloat16)
    sd = bundle.init(SEED)
    folded = FoldedResNet(sd, bundle.module.stage_sizes, torch.bfloat16, x.device)
    net = bundle.module
    net.load_state_dict(sd)
    net = net.eval().to(x.device)
    xb = x.to(torch.bfloat16)
    with torch.inference_mode():
        got, want = folded(xb), net(x)
        ms = {"folded bf16": time_ms(lambda: folded(xb), 10),
              "plain f32": time_ms(lambda: net(x), 10)}
    net.cpu()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    top2 = torch.topk(want, 2).values
    held = (top2[:, 0] - top2[:, 1]) > 2 * err
    same = got.argmax(-1) == want.argmax(-1)
    if not torch.isfinite(got).all() or err > NET_TOL * scale or not same[held].all():
        raise AssertionError(f"{arch}: folded bf16 vs plain f32 err {err} (max |logit| "
                             f"{scale}), argmax equal on {int(same[held].sum())} of "
                             f"{int(held.sum())} held images")
    n = x.shape[0]
    return bundle, sd, (
        f"folded bf16 vs plain f32, {n} masked images: max logit err {err:.4g} (max |logit| "
        f"{scale:.4g}, {err / scale:.3g} of it), argmax equal on {int(same[held].sum())}/"
        f"{int(held.sum())} held images ({int(same.sum())}/{n} in all); forward of {n} (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))


def masked_images(normalized, segments, firsts, width, n=32):
    """The main path's first ``n`` window-masked images, f32 on the card."""
    import torch

    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import masked_batch_plain

    dev = torch.device("cuda")
    return masked_batch_plain(torch.from_numpy(normalized).to(dev),
                              torch.from_numpy(segments).to(dev),
                              torch.from_numpy(firsts[:n]).to(dev), width, torch.float32)


def resnet18_phase(normalized, segments, firsts, width, smi, by_path):
    """The CLIs' default model, ResNet-18 (BasicBlock stages: every block is
    a cuDNN conv, no B2): folded_vs_plain on 32 masked images of the main
    path. Then the generator's compute with no --arch: B1 1, B2 0."""
    import tempfile

    from network_interpretation_imagenet_tpu_torch.cli import (
        generate_gp_training_data_imagenet as gen,
    )

    _, _, summary = folded_vs_plain("resnet18", masked_images(normalized, segments, firsts,
                                                              width))
    with tempfile.TemporaryDirectory() as tmp:
        args = gen.parse_args(["--synthetic", "--out", tmp])
        if args.arch != "resnet18":
            raise AssertionError(f"the CLIs' default arch is {args.arch}")
        t0 = time.perf_counter()
        payload, result = counted(by_path, "gen_resnet18",
                                  lambda: quiet(lambda: gen.compute(args)), 1, 0)
        seconds = time.perf_counter() - t0
    levels, keep = payload["levels"], payload["keeps_prediction"]
    if not (np.isfinite(result["out"].heatmap).all() and len(levels) == len(keep) > 0):
        raise AssertionError(f"gen (default arch) payload {payload}")
    log(f"[resnet18] {smi}: {summary}; generator compute with no --arch {seconds * 1e3:.1f} ms "
        f"with its engine build, {len(levels)} levels, threshold {result['threshold']}; "
        "launches " + json.dumps(by_path["gen_resnet18"]))


def resnext_phase(normalized, segments, firsts, width, smi, by_path):
    """ResNeXt and Wide-ResNet at 224 bf16 (see the module docstring, 19)."""
    import torch

    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import bottleneck_chain
    from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine

    dev = torch.device("cuda")
    x = masked_images(normalized, segments, firsts, width)
    chunks = NUM_SAMPLES // MASK_BATCH
    parts = []
    for arch, path, chains in (("wide_resnet50_2", "wide_resnet50_2_window", 4),
                               ("resnext50_32x4d", "resnext50_window", 0)):
        bundle, sd, summary = folded_vs_plain(arch, x)
        engine = SaliencyEngine(bundle, sd, mask_batch=MASK_BATCH, device="cuda")
        target = engine.predict_one(normalized)[0]
        counted(by_path, path, lambda: engine.eval_window_masks(
            normalized, segments, firsts[:NUM_SAMPLES], width, target), chunks, chains * chunks)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            engine.eval_window_masks(normalized, segments, firsts[:NUM_SAMPLES], width, target)
            ts.append(time.perf_counter() - t0)
        parts.append(f"{arch}: {summary}; {NUM_SAMPLES / float(np.median(ts)):.1f} masked "
                     f"evals/s ({NUM_SAMPLES} masks, mask_batch {MASK_BATCH}), launches "
                     + json.dumps(by_path[path]))
        del engine, bundle, sd
    _, _, summary = counted(by_path, "wide_resnet101_2_forward",
                            lambda: folded_vs_plain("wide_resnet101_2", x[:4]), 0, 4 * 12)
    parts.append(f"wide_resnet101_2 (stage 3 a chain of 22 blocks): {summary}, launches "
                 + json.dumps(by_path["wide_resnet101_2_forward"]))
    log(f"[resnext] {smi}: " + "; ".join(parts))
    torch.cuda.empty_cache()

    # Wide-ResNet's chain shapes (C = 2P), block by block and timed at B=256.
    rng = np.random.RandomState(SEED + 2)
    total = {"kernel": 0.0, "cudnn": 0.0, "bound": 0.0}
    for h, c, p, n in WIDE_STAGES_50:
        ws = b2_weights(rng, c, p, n, torch.bfloat16, dev)
        xb = torch.from_numpy(np.abs(rng.randn(MASK_BATCH, h, h, c)).astype(np.float32)
                              ).to(dev, torch.bfloat16)
        block_err, outside, chain_err = check_chain(xb, ws, B2_TOL)
        flops, nbytes, floor = b2_costs(h, c, p, n, MASK_BATCH)
        bound = max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
        ms = time_ms(lambda: bottleneck_chain(xb, ws), 10)
        cudnn_ms = time_ms(cudnn_chain(xb, ws), 10)
        for key, v in (("kernel", ms), ("cudnn", cudnn_ms), ("bound", bound)):
            total[key] += v
        log(f"[resnext] Wide B2 B={MASK_BATCH} H={h} C={c} P={p} blocks={n}: worst block err "
            f"{block_err:.4g} (tol {B2_TOL} x max|plain|; {outside} of {xb.numel() * n} outside "
            f"elementwise), whole-chain err {chain_err:.4g}; kernel {ms:.4f} ms, "
            f"{flops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.3f} of the chain bound {bound:.4f} ms "
            f"({flops:.4g} flop, {nbytes} bytes), 3-launch floor {floor:.4f} ms; yardstick bf16 "
            f"cuDNN chain {cudnn_ms:.4f} ms")
        del xb, ws
    # Wide-ResNet-101-2's stage 3: 22 chained blocks at C=1024, P=512.
    ws = b2_weights(rng, 1024, 512, 22, torch.bfloat16, dev)
    xb = torch.from_numpy(np.abs(rng.randn(4, 14, 14, 1024)).astype(np.float32)
                          ).to(dev, torch.bfloat16)
    block_err, _, chain_err = check_chain(xb, ws, B2_TOL)
    log(f"[resnext] {smi}: Wide-ResNet-50-2 chains per forward of {MASK_BATCH}: kernel "
        f"{total['kernel']:.4f} ms, yardstick bf16 cuDNN {total['cudnn']:.4f} ms, chain bound "
        f"{total['bound']:.4f} ms; Wide-ResNet-101-2 stage 3 (22 blocks) at B=4: worst block "
        f"err {block_err:.4g}, whole-chain err {chain_err:.4g}")
    torch.cuda.empty_cache()


def sweep_phase(engine, smi, by_path):
    """The val-set sweep's lanes at ResNet-101 224 bf16 (see the module
    docstring, 20)."""
    import tempfile

    import torch

    from network_interpretation_imagenet_tpu_torch.cli import saliency_sweep as sweep_cli
    from network_interpretation_imagenet_tpu_torch.config import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        BOConfig,
        SegmentConfig,
    )
    from network_interpretation_imagenet_tpu_torch.ops import aggregate, masking
    from network_interpretation_imagenet_tpu_torch.ops.preprocess import normalize
    from network_interpretation_imagenet_tpu_torch.saliency import sweep
    from network_interpretation_imagenet_tpu_torch.saliency.bo_pipeline import bo_window_saliency
    from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
    from network_interpretation_imagenet_tpu_torch.saliency.journal import SweepJournal
    from network_interpretation_imagenet_tpu_torch.segment.common import segment_image

    data = []
    for i in range(SWEEP_IMAGES):
        u8, gt = synthetic_image(SEED + 10 + i)
        data.append((normalize(torch.from_numpy(u8.astype(np.float32) / 255.0), IMAGENET_MEAN,
                               IMAGENET_STD).numpy(), None, gt))
    seg_cfg = SegmentConfig()
    n, chunks, flushes = SWEEP_IMAGES, NUM_SAMPLES // MASK_BATCH, SWEEP_IMAGES // SWEEP_BATCH
    lines = []

    # A flush's batched predict (B=4) and the BO pre-sample forward (B=12)
    # through B2, against the folded net's plain path on the same images.
    x = torch.from_numpy(np.stack([d[0] for d in data])).to("cuda")
    x = torch.cat([x, x[:SWEEP_BATCH].flip(2)])
    for b in (SWEEP_BATCH, 3 * SWEEP_BATCH):
        got = engine.predict_logits_device(x[:b])
        with torch.inference_mode():
            want = engine.model(x[:b].to(engine.compute_dtype), plain=True)
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        if not (torch.isfinite(got).all() and err <= 0.05 * scale):
            raise AssertionError(f"sweep: predict at B={b} through B2 vs plain err {err} "
                                 f"(max |logit| {scale})")
        lines.append(f"predict at B={b} through B2 vs plain: max logit err {err:.4g} "
                     f"(max |logit| {scale:.4g})")
    del x
    kw = dict(num_mask_samples=NUM_SAMPLES, seed=SEED, keep_heatmaps=True)

    def rows(res):
        return sorted(({k: v for k, v in r.items() if k != "seconds"} for r in res.per_image),
                      key=lambda r: r["index"])

    def run(path, fn, b1, b2):
        """A sweep with its launches held; raises unless every image was explained."""
        res = counted(by_path, path, fn, b1, b2)
        if res.images_explained != n or res.images_failed or not all(
                np.isfinite(h).all() for h in res.heatmaps.values()):
            raise AssertionError(f"{path}: {res.images_explained} of {n} explained, "
                                 f"{res.images_failed} failed")
        lines.append(f"{path} {res.evals_per_sec:.1f} evals/s, p50 {res.p50_latency_s:.4f} s "
                     f"per image, launches " + json.dumps(by_path[path]))
        return res

    stream = run("sweep_window_stream", lambda: sweep.saliency_sweep(engine, data, seg_cfg, **kw),
                 n * chunks, n * (1 + chunks) * 4)
    # Each row against the per-image path: the same host-sampled starts
    # (RandomState(SEED + index)) through eval_window_masks.
    for row in stream.per_image:
        i = row["index"]
        seg = segment_image(aggregate.normalize_to_uint8_np(data[i][0]), seg_cfg)
        s = int(seg.max()) + 1
        width = int(0.4 * s)
        first = masking.sample_window_starts_host(SEED + i, NUM_SAMPLES, s, width)
        target = engine.predict_one(data[i][0])[0]
        r = engine.eval_window_masks(data[i][0], seg, first, width, target)
        heat = aggregate.summed_superpixel_labels_np(seg, first, width, r.survived)
        if (row["target"], row["num_segments"], row["survival"]) != (
                target, s, float(np.mean(r.survived))) or not np.array_equal(
                heat, stream.heatmaps[i]):
            raise AssertionError(f"sweep stream: image {i}'s row differs from the per-image path")
    batch = run("sweep_window_batch", lambda: sweep.saliency_sweep(
        engine, data, seg_cfg, image_batch=SWEEP_BATCH, **kw), n * chunks,
        (flushes + n * chunks) * 4)
    agree = np.mean([np.array_equal(batch.heatmaps[i], stream.heatmaps[i]) for i in range(n)])
    same_rows = np.mean([a == b for a, b in zip(rows(batch), rows(stream))])
    lines.append(f"bf16 batched vs streaming: heatmaps equal on {agree:.3f}, rows on "
                 f"{same_rows:.3f} of the images")
    ko = run("sweep_knockout", lambda: sweep.saliency_sweep(engine, data, seg_cfg,
                                                             mode="knockout", **kw),
             0, n * (1 + chunks) * 4)
    ko_batch = run("sweep_knockout_batch", lambda: sweep.saliency_sweep(
        engine, data, seg_cfg, mode="knockout", image_batch=SWEEP_BATCH, **kw),
        0, (flushes + n * chunks) * 4)
    ko_agree = np.mean([np.array_equal(ko_batch.heatmaps[i], ko.heatmaps[i]) for i in range(n)])
    lines.append(f"bf16 batched vs streaming knockouts: heatmaps equal on {ko_agree:.3f} of "
                 "the images")
    with tempfile.TemporaryDirectory() as tmp:
        j = SweepJournal(f"{tmp}/j.jsonl", keep_heatmaps=True, config={"k": NUM_SAMPLES})
        sweep.saliency_sweep(engine, data, seg_cfg, max_images=3, journal=j, **kw)
        j.close()
        j = SweepJournal(f"{tmp}/j.jsonl", resume=True, keep_heatmaps=True,
                         config={"k": NUM_SAMPLES})
        resumed = sweep.saliency_sweep(engine, data, seg_cfg, journal=j, **kw)
        j.close()
    if rows(resumed) != rows(stream) or any(not np.array_equal(resumed.heatmaps[i],
                                                               stream.heatmaps[i])
                                            for i in range(n)):
        raise AssertionError("sweep: the journal resumed after 3 images differs from the "
                             "uninterrupted run")
    lines.append("journal cut after 3 images and resumed: rows and heatmaps equal the "
                 "uninterrupted run's")
    wall, busy = busy_ms(lambda: sweep.saliency_sweep(engine, data, seg_cfg, **kw))
    lines.append(f"one streaming sweep under the profiler: wall {wall:.1f} ms, device busy "
                 f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}")

    # f32: the batched flush's rows equal the streaming path's exactly.
    e32 = SaliencyEngine(engine.bundle, engine.bundle.init(SEED), mask_batch=MASK_BATCH,
                         compute_dtype=torch.float32, device="cuda")
    kw32 = dict(num_mask_samples=MASK_BATCH, seed=SEED, keep_heatmaps=True)
    s32 = sweep.saliency_sweep(e32, data[:2], seg_cfg, **kw32)
    b32 = sweep.saliency_sweep(e32, data[:2], seg_cfg, image_batch=2, **kw32)
    if rows(s32) != rows(b32) or any(not np.array_equal(s32.heatmaps[i], b32.heatmaps[i])
                                     for i in range(2)):
        raise AssertionError("sweep f32: batched rows differ from streaming rows")
    lines.append(f"f32, 2 images x {MASK_BATCH} masks: batched rows and heatmaps equal the "
                 "streaming ones")
    del e32
    torch.cuda.empty_cache()

    bo_cfg = BOConfig()
    fw = 1 + bo_cfg.n_iters   # forwards per BO loop: the pre-samples, then one per iteration
    engine.fused_runners.clear()   # each flush runs eagerly or captures: every launch counted
    bo = run("sweep_bo", lambda: sweep.bo_saliency_sweep(
        engine, data, seg_cfg, bo_cfg, image_batch=SWEEP_BATCH, seed=SEED, keep_heatmaps=True),
        flushes * SWEEP_BATCH * fw, flushes * (1 + fw) * 4)
    same_best = []
    for row in bo.per_image:
        i = row["index"]
        seg = segment_image(aggregate.normalize_to_uint8_np(data[i][0]), seg_cfg)
        out, tr = bo_window_saliency(engine, data[i][0], seg, bo_cfg, seed=SEED + i,
                                     target=row["target"])
        same_best.append(row["best_start"] == int(tr.xp[np.argmax(tr.yp)])
                         and np.array_equal(out.heatmap, bo.heatmaps[i]))
    lines.append(f"BO rows (N={SWEEP_BATCH} flushes, bf16) equal to single-image "
                 f"bo_window_saliency(seed=SEED+index) on {np.mean(same_best):.3f} of the images")
    rise = run("sweep_attr_rise", lambda: sweep.attribution_sweep(
        engine, data, method="rise", image_batch=SWEEP_BATCH, keep_heatmaps=True),
        0, (flushes + n * 4) * 4)
    grad = run("sweep_attr_gradient", lambda: sweep.attribution_sweep(
        engine, data, method="gradient", image_batch=SWEEP_BATCH, keep_heatmaps=True),
        0, flushes * 4)
    del ko, ko_batch, rise, grad

    # The CLI: its own ResNet-101 engine per lane, 4 synthetic images.
    base = ["--synthetic", "--arch", "resnet101", "--num-images", "4"]
    for path, extra, b1, b2 in (
            ("sweep_cli_window", [], 4, 4 * 2 * 4),   # 100 masks: one chunk of 1024
            ("sweep_cli_bo", ["--bo", "--image-batch", "4"], 4 * fw, 4 + 4 * fw),
            ("sweep_cli_attr_rise", ["--attribute", "rise", "--image-batch", "4"], 0,
             (1 + 4 * 2) * 4)):   # 500 RISE masks: two chunks of 250
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            counted(by_path, path, lambda: quiet(lambda: sweep_cli.main(
                base + extra + ["--out", tmp])), b1, b2)
            seconds = time.perf_counter() - t0
            with open(f"{tmp}/sweep_result.json") as f:
                payload = json.load(f)
        if payload["images_explained"] != 4 or payload["images_failed"]:
            raise AssertionError(f"{path}: payload {payload}")
        lines.append(f"{path} {seconds:.2f} s with its engine build, "
                     f"{payload['evals_per_sec']:.1f} evals/s, launches "
                     + json.dumps(by_path[path]))
    log(f"[sweep] {smi}: ResNet-101 224 bf16, {n} synthetic images, {NUM_SAMPLES} masks, "
        f"mask_batch {MASK_BATCH}: " + "; ".join(lines))


def knockout_phase(engine, image, segments, target, smi, by_path):
    """knockout_saliency with the target given, 1024 masks at M = 1 and 5:
    4 chunks of 256, each built by plain torch ops (no B1) and run through
    B2 in all 4 stages: B1 0, B2 16 for each M. Then the masked evals/s of
    eval_knockout_masks alone (median of 3)."""
    from network_interpretation_imagenet_tpu_torch.ops import aggregate
    from network_interpretation_imagenet_tpu_torch.saliency.pipeline import knockout_saliency

    chunks = -(-NUM_SAMPLES // MASK_BATCH)
    parts = []
    for m in (1, 5):
        t0 = time.perf_counter()
        ko = counted(by_path, f"knockout_m{m}", lambda: knockout_saliency(
            engine, image, segments, NUM_SAMPLES, num_knockout=m, seed=SEED, target=target),
            0, 4 * chunks)
        wall = (time.perf_counter() - t0) * 1e3
        ids = ko.knock_ids
        if ids.shape != (NUM_SAMPLES, m) or not (0 <= ids.min() and ids.max() < ko.num_segments):
            raise AssertionError(f"knockout M={m}: ids {ids.shape} in [{ids.min()}, {ids.max()}]")
        heat = aggregate.summed_knockout_labels_np(segments, ids, ko.eval.survived)
        if not np.array_equal(heat, ko.heatmap):
            raise AssertionError(f"knockout M={m}: heatmap differs from the bank-free sum")
        ts = []
        engine.eval_knockout_masks(image, segments, ids, target)
        for _ in range(3):
            t0 = time.perf_counter()
            engine.eval_knockout_masks(image, segments, ids, target)
            ts.append(time.perf_counter() - t0)
        parts.append(f"M={m}: {NUM_SAMPLES / float(np.median(ts)):.1f} masked evals/s, "
                     f"knockout_saliency {wall:.1f} ms (first call, host mask bank included), "
                     f"survived {int(ko.eval.survived.sum())}/{NUM_SAMPLES}, launches "
                     + json.dumps(by_path[f"knockout_m{m}"]))
    log(f"[knockout] {smi}: ResNet-101 224 bf16, mask_batch {MASK_BATCH}: " + "; ".join(parts))


def multi_phase(engine, images, segs, targets, single_rate, smi, by_path):
    """eval_window_masks_multi over N=8 images x K=128 (4 chunks of 256,
    two image runs each: B1 8, B2 16). Every chunk the model receives is
    held bit for bit against masked_batch_plain of its rows; survive labels
    are compared with 8 single-image calls (reported: bf16 at another batch
    composition may round otherwise)."""
    import torch

    from network_interpretation_imagenet_tpu_torch.ops import aggregate, masking
    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import masked_batch_plain

    n, k = len(images), MULTI_K
    widths = np.array([int(0.4 * (int(g.max()) + 1)) for g in segs], np.int32)
    firsts = np.stack([masking.sample_window_starts_host(SEED + i, k, int(segs[i].max()) + 1,
                                                         widths[i]) for i in range(n)])
    model, batches = engine.model, []

    def recording(x, plain=False):
        batches.append(x.clone())
        return model(x, plain)

    image_of = np.repeat(np.arange(n), k)
    starts = range(0, n * k, MASK_BATCH)
    runs = sum(len(set(image_of[off:off + MASK_BATCH])) for off in starts)  # B1 launches
    engine.model = recording
    try:
        results = counted(by_path, "multi_window", lambda: engine.eval_window_masks_multi(
            images, segs, firsts, widths, targets), runs, 4 * len(starts))
    finally:
        engine.model = model
    dev = torch.device("cuda")
    flat = firsts.reshape(-1)
    for c, got in enumerate(batches):
        rows = range(c * MASK_BATCH, min((c + 1) * MASK_BATCH, n * k))
        want = torch.cat([masked_batch_plain(
            torch.from_numpy(images[i]).to(dev), torch.from_numpy(segs[i]).to(dev),
            torch.from_numpy(flat[[r for r in rows if image_of[r] == i]]).to(dev),
            int(widths[i]), engine.compute_dtype) for i in sorted(set(image_of[list(rows)]))])
        if not torch.equal(got, want):
            raise AssertionError(f"multi: chunk {c}'s B1 batch differs from masked_batch_plain")
    singles = [engine.eval_window_masks(images[i], segs[i], firsts[i], int(widths[i]), targets[i])
               for i in range(n)]
    agree = float(np.mean([np.mean(r.survived == s.survived) for r, s in zip(results, singles)]))
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.eval_window_masks_multi(images, segs, firsts, widths, targets)
        ts.append(time.perf_counter() - t0)
    rate = n * k / float(np.median(ts))
    log(f"[multi] {smi}: eval_window_masks_multi N={n} x K={k}, mask_batch {MASK_BATCH}: "
        f"launches {json.dumps(by_path['multi_window'])}; {len(batches)} chunk batches equal "
        f"masked_batch_plain bit for bit; survive agreement with {n} single-image calls "
        f"{agree:.4f}; {rate:.1f} masked evals/s (single image, 1024 masks: {single_rate:.1f})")
    return [aggregate.summed_superpixel_labels_np(segs[i], firsts[i], widths[i],
                                                  results[i].survived) for i in range(n)]


def gp_phase(heat, heats, smi):
    """gp_checks with TF32 allowed for the process's matmuls, so that each
    GP function's own full-f32 guard is what keeps its products (and the
    fits' backward) in f32; the guards must leave the setting as they found
    it."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        gp_checks(heat, heats, smi)
        if not torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("a GP function left TF32 switched off")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def gp_checks(heat, heats, smi):
    """The pixel-GP surrogates at full size on the card against the CPU:
    the Kronecker GP's fit_adam + posterior on one 224^2 heatmap (the same
    lengthscale, unless the CPU's best two stand within twice the sweep's
    card-vs-CPU error; mean and variance within GP_TOL of their scale),
    fit_posterior_batch on N=8 heatmaps, and the variational GP's 30 Adam
    steps on 4,096 pixels + predict_proba over all 50,176 (losses within
    VGP_LOSS_TOL relative, probabilities within VGP_PROB_TOL)."""
    import torch

    from network_interpretation_imagenet_tpu_torch.cli.gp_classification import training_points
    from network_interpretation_imagenet_tpu_torch.gp import kron, variational

    def rel(a, b):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, (time.perf_counter() - t0) * 1e3

    heat = heat.astype(np.float32)
    runs = {}
    for d in ("cuda", "cpu"):
        def kron_fit(d=d):
            params, losses = kron.fit_adam(heat, device=d)
            return params, losses, *kron.posterior(params, heat, device=d)

        kron_fit()   # warm-up
        runs[d] = timed(kron_fit)
    kron_wall, kron_busy = busy_ms(lambda: kron.posterior(kron.fit_adam(heat, device="cuda")[0],
                                                          heat, device="cuda"))
    (p_card, l_card, m_card, v_card), card_ms = runs["cuda"]
    (p_cpu, l_cpu, m_cpu, v_cpu), cpu_ms = runs["cpu"]
    scores = {d: kron._sweep(*kron._factored(kron.LENGTHSCALE_GRID, *heat.shape, d),
                             torch.from_numpy(heat).to(d)[None])[0][0].cpu().double()
              for d in ("cuda", "cpu")}
    score_err = (scores["cuda"] - scores["cpu"]).abs().max().item()
    best2 = torch.sort(scores["cpu"]).values[:2]
    held = (best2[1] - best2[0]).item() > 2 * score_err
    same_ls = float(p_card.log_lengthscale) == float(p_cpu.log_lengthscale)
    errs = {"mean": rel(m_card, m_cpu), "var": rel(v_card, v_cpu), "losses": rel(l_card, l_cpu)}
    if (held and not same_ls) or max(errs.values()) > GP_TOL:
        raise AssertionError(f"Kronecker GP: card vs CPU lengthscale {same_ls} (held {held}), "
                             f"errors {errs}")
    log(f"[gp] {smi}: Kronecker GP fit_adam (20 steps) + posterior at 224x224: card "
        f"{card_ms:.2f} ms, CPU {cpu_ms:.2f} ms; lengthscale "
        f"{np.exp(float(p_card.log_lengthscale)):g} on both "
        + ("(held" if held else "(a near-tie, not held") + f": best two -MLL "
        f"{best2[0].item():.2f} / {best2[1].item():.2f}, sweep err {score_err:.3g}); max rel err "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; one card call under the profiler: wall {kron_wall:.2f} ms, device busy "
        f"{kron_busy:.3f} ms (union of its intervals)")

    ys = np.stack(heats).astype(np.float32)
    batch = {}
    for d in ("cuda", "cpu"):
        kron.fit_posterior_batch(ys, device=d)
        batch[d] = timed(lambda d=d: kron.fit_posterior_batch(ys, device=d))
    (pb, mb, vb, lb), batch_ms = batch["cuda"]
    (pc, mc, vc, _), batch_cpu_ms = batch["cpu"]
    same = sum(float(a.log_lengthscale) == float(b.log_lengthscale) for a, b in zip(pb, pc))
    berr = {"mean": rel(mb, mc), "var": rel(vb, vc)}
    if max(berr.values()) > GP_TOL:
        raise AssertionError(f"Kronecker GP batch: card vs CPU errors {berr}")
    log(f"[gp] {smi}: fit_posterior_batch N={len(ys)} at 224x224: card {batch_ms:.2f} ms "
        f"({batch_ms / len(ys):.2f} ms per image), CPU {batch_cpu_ms:.2f} ms; same lengthscale "
        f"for {same}/{len(ys)} images; max rel err mean {berr['mean']:.3g}, var {berr['var']:.3g}")

    n = heat.shape[0]
    x, y = training_points(heat, heat > 0, "median", 4096, SEED)
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    all_x = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float32)
    vgp = {}
    for d in ("cuda", "cpu"):
        def vgp_fit(d=d):
            model, losses = variational.fit_adam(
                variational.init_model(n, 10, n / 8.0, device=d), x, y, iters=30)
            return losses, variational.predict_proba(model, all_x)

        vgp_fit()
        vgp[d] = timed(vgp_fit)
    vgp_wall, vgp_busy = busy_ms(lambda: vgp_fit("cuda"))
    (vl_card, pr_card), vgp_ms = vgp["cuda"]
    (vl_cpu, pr_cpu), vgp_cpu_ms = vgp["cpu"]
    loss_err = rel(vl_card, vl_cpu)
    prob_err = (pr_card.cpu() - pr_cpu).abs().max().item()
    if not (torch.isfinite(pr_card).all() and loss_err <= VGP_LOSS_TOL
            and prob_err <= VGP_PROB_TOL):
        raise AssertionError(f"variational GP: card vs CPU loss err {loss_err}, "
                             f"prob err {prob_err}")
    log(f"[gp] {smi}: variational GP fit_adam (30 steps, {len(x)} pixels, 10x10 inducing) + "
        f"predict_proba over {n * n} pixels: card {vgp_ms:.2f} ms, CPU {vgp_cpu_ms:.2f} ms; "
        f"max rel loss err {loss_err:.3g}, max prob err {prob_err:.3g}; -ELBO "
        f"{vl_card[0].item():.2f} -> {vl_card[-1].item():.2f}; one card call under the "
        f"profiler: wall {vgp_wall:.2f} ms, device busy {vgp_busy:.3f} ms")


def b2_graph_phase(cases, smi):
    """B2 and its bf16 cuDNN yardstick at the BO's batches and the
    attribution family's (ATTR_BATCHES) as CUDA graph replays: eager cuDNN at
    small batches is bound by Python's launches, a replay shows each chain's
    device time. Run last, so that the captures' memory pools cannot touch
    the paths' timings."""
    import torch

    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import bottleneck_chain

    per_batch = {}
    rng = np.random.RandomState(SEED + 1)
    cases = list(cases)
    for batch in ATTR_BATCHES:
        for h, c, p, n in STAGES_101:
            ws = b2_weights(rng, c, p, n, torch.bfloat16, "cuda")
            x = torch.from_numpy(np.abs(rng.randn(batch, h, h, c)).astype(np.float32)
                                 ).to("cuda", torch.bfloat16)
            block_err, _, _ = check_chain(x, ws, B2_TOL)
            log(f"[B2 graphs] B={batch} H={h} C={c} P={p} blocks={n}: worst block err "
                f"{block_err:.4g} (tol {B2_TOL} x max|plain|)")
            cases.append((batch, x, ws))
    for batch, x, ws in cases:
        b2 = time_ms(graphed(lambda: bottleneck_chain(x, ws)).replay, 20)
        cudnn = time_ms(graphed(cudnn_chain(x, ws)).replay, 20)
        h, c = x.shape[1], x.shape[3]
        flops, nbytes, _ = b2_costs(h, c, ws[0].shape[1], len(ws) // 6, batch)
        bound = max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
        per_batch[batch] = [v + d for v, d in zip(per_batch.get(batch, (0.0,) * 3),
                                                  (b2, cudnn, bound))]
    log(f"[B2 graphs] {smi}: per ResNet-101 forward (4 chains) as CUDA graph replays: "
        + "; ".join(f"B={b}: kernel {v[0]:.4f} ms, bf16 cuDNN {v[1]:.4f} ms, chain bound "
                    f"{v[2]:.4f} ms" for b, v in per_batch.items()))


def gp_cli_phase(by_path):
    """gp_superpixel_data_imagenet's compute end to end on the synthetic
    image (ResNet-101 bf16, its own engine, 100 window masks, the Kronecker
    GP on the card): B1 1, B2 4 x 2."""
    import tempfile

    from network_interpretation_imagenet_tpu_torch.cli import gp_superpixel_data_imagenet as gps

    with tempfile.TemporaryDirectory() as tmp:
        args = gps.parse_args(["--synthetic", "--arch", "resnet101", "--out", tmp])
        t0 = time.perf_counter()
        payload, result = counted(by_path, "gp_cli", lambda: quiet(lambda: gps.compute(args)),
                                  1, 8)
        seconds = time.perf_counter() - t0
    if not (np.isfinite(result["mean"]).all() and np.isfinite(result["var"]).all()
            and payload["gp_loss_last"] < payload["gp_loss_first"]):
        raise AssertionError(f"gp cli payload {payload}")
    log(f"[gp cli] compute {seconds:.2f} s with its engine build; launches "
        f"{json.dumps(by_path['gp_cli'])}; payload {json.dumps(payload)}")


def host(t):
    """A tensor (any device) or an array as a float64 numpy array."""
    return t.detach().float().cpu().numpy().astype(np.float64) if hasattr(t, "detach") \
        else np.asarray(t, np.float64)


def check_map(name, heat):
    """Raises unless ``heat`` is finite and not constant."""
    h = host(heat)
    if not np.isfinite(h).all() or np.ptp(h) == 0:
        raise AssertionError(f"[attr] {name}: non-finite or constant map")
    return h


def rel_err(got, want):
    g, w = host(got), host(want)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def b2_device_ms(fn):
    """One call of ``fn`` under torch.profiler: (device ms of b2_ kernels,
    device ms of all kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    b2 = total = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total += e.device_time
            if "b2_conv" in e.name:
                b2 += e.device_time
    return b2 / 1e3, total / 1e3


def calibrated_state_dict(bundle, seeds):
    """``bundle.init(SEED)`` with every BatchNorm's running statistics set to
    its batch statistics on the synthetic images of ``seeds`` (the plain
    module in training mode, one forward on the card). The init's statistics
    (0 and 1) leave ResNet-101's logits near 5e4, where every softmax is 0 or
    1 and every probability-based map is constant."""
    import torch

    from network_interpretation_imagenet_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
    from network_interpretation_imagenet_tpu_torch.ops.preprocess import normalize

    net = bundle.module
    net.load_state_dict(bundle.init(SEED))
    net.cuda()
    batch = torch.stack([normalize(torch.from_numpy(synthetic_image(s)[0].astype(np.float32)
                                                    / 255.0), IMAGENET_MEAN, IMAGENET_STD)
                         for s in seeds]).cuda()
    bns = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None   # a cumulative average: one batch's statistics
    net.train()
    with torch.no_grad():
        net(batch)
    net.eval()
    for m in bns:
        m.momentum = 0.1
    sd = {k: t.detach().clone() for k, t in net.state_dict().items()}
    net.cpu()
    return sd


def attr_phase(normalized, display, smi, by_path):
    """The attribution family at full width (see the module docstring, 15)."""
    import torch

    from network_interpretation_imagenet_tpu_torch.models import create_model, resnet_imagenet
    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import (
        bottleneck_chain,
        bottleneck_chain_plain,
    )
    from network_interpretation_imagenet_tpu_torch.saliency import gradient as g
    from network_interpretation_imagenet_tpu_torch.saliency import learned_mask, xrai
    from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
    from network_interpretation_imagenet_tpu_torch.saliency.eval_metrics import (
        deletion_insertion_auc,
    )
    from network_interpretation_imagenet_tpu_torch.saliency.sanity import spearman_abs

    bundle = create_model("resnet101", "imagenet", dtype=torch.bfloat16)
    b32 = create_model("resnet101", "imagenet", dtype=torch.float32)
    sd = calibrated_state_dict(bundle, range(1, 9))
    engines = {d: SaliencyEngine(b, sd, mask_batch=MASK_BATCH, device="cuda")
               for d, b in (("bf16", bundle), ("f32", b32))}
    engine = engines["bf16"]
    v = engine.variables
    target = engine.predict_one(normalized)[0]
    image = torch.from_numpy(normalized).cuda()

    def plain_fn(e):
        """Engine ``e``'s masked-forward logits_fn through its folded net with
        the chains' plain version."""
        @torch.inference_mode()
        def fn(variables, x):
            return e.model(x.to(e.compute_dtype).contiguous(), plain=True)
        return fn

    def as_engine(e, logits_fn):
        """``e`` with ``logits_fn`` as its predict_logits_device (fidelity)."""
        return types.SimpleNamespace(device=e.device, predict_logits_device=lambda imgs: logits_fn(
            e.variables, torch.as_tensor(imgs).to(e.device, torch.float32)))

    # Per forward, (path, dtype) -> worst max |a - b| / max |b| of the logits:
    # "b2" B2 vs the plain path; for bf16 also "b2_f32" B2 and "plain_f32"
    # the plain path, each vs the f32 engine's plain path on the same input.
    fwd = {}

    def held(e, key):
        """``e.folded_logits`` with each forward's logits held against the
        plain path (and a bf16 forward's against the f32 plain path) on the
        same input, the worst of the call's forwards kept in ``fwd``."""
        plain, plain32 = plain_fn(e), plain_fn(engines["f32"])

        def note(name, a, b):
            err = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
            fwd[key + (name,)] = max(fwd.get(key + (name,), 0.0), err)

        def fn(variables, x):
            x = x.to(e.compute_dtype)   # one rounded input for all three
            got = e.folded_logits(variables, x)
            want = plain(variables, x)
            note("b2", got, want)
            if e.compute_dtype == torch.bfloat16:
                exact = plain32(engines["f32"].variables, x)
                note("b2_f32", got, exact)
                note("plain_f32", want, exact)
            return got
        return fn

    # The first chain call of each dtype and shape on these paths: its input
    # and weights, checked block by block after the counted runs.
    chain_inputs = {}

    def recording_chain(x, ws):
        chain_inputs.setdefault((x.dtype, tuple(x.shape)), (x, ws))
        return bottleneck_chain(x, ws)

    def masked(e):
        """The B2 paths of engine ``e``: (name, B2 launches, call(logits_fn))."""
        b, w, dt = e.bundle, e.variables, e.compute_dtype
        return [
            ("occlusion", 16, lambda f: g.occlusion_map(f, w, image, target, batch=64,
                                                        compute_dtype=dt)),
            ("rise", 16, lambda f: g.rise_map(f, w, image, target, num_masks=1000, batch=250,
                                              seed=SEED, compute_dtype=dt)),
            ("scorecam", 4, lambda f: g.scorecam(b, w, image, target, channels=64, batch=64,
                                                 compute_dtype=dt, logits_fn=f)),
        ]

    heat = check_map("gradient", g.input_gradient(b32.logits, v, image, target))
    maps, errs, aucs = {}, {}, {}
    resnet_imagenet.bottleneck_chain = recording_chain
    try:
        for d, e in engines.items():
            suffix = "" if d == "bf16" else "_f32"
            for name, b2, run in masked(e):
                got = counted(by_path, f"attr_{name}{suffix}", lambda: run(held(e, (name, d))),
                              0, b2)
                want = run(plain_fn(e))
                maps[name, d] = (check_map(f"{name} {d}", got),
                                 check_map(f"{name} {d} plain", want))
                errs[name, d] = rel_err(got, want)
            fid = counted(by_path, f"attr_fidelity{suffix}", lambda: deletion_insertion_auc(
                as_engine(e, held(e, ("fidelity", d))), normalized, heat, target), 0, 4)
            fid_plain = deletion_insertion_auc(as_engine(e, plain_fn(e)), normalized, heat,
                                               target)
            aucs[d] = (fid, max(abs(fid[k + "_auc"] - fid_plain[k + "_auc"])
                                / np.ptp(fid_plain[k + "_curve"])
                                for k in ("deletion", "insertion")))
    finally:
        resnet_imagenet.bottleneck_chain = bottleneck_chain
    # The kernel check: every chain shape these paths ran, block by block on
    # the activations the path gave it (bf16 within B2_TOL, f32 within
    # B2_F32_TOL of max |plain block output|), so nothing compounds. Whole
    # forwards: f32 logits within B2_F32_TOL of the plain path's; in bf16 a
    # forward's rounding compounds over 101 layers of a random net in both
    # paths, so its B2 logits are held no further from the f32 plain path
    # than twice the plain bf16 path is, plus B2_TOL (a wrong kernel is off
    # by the logits' own scale). Maps within ATTR_B2_TOL, except a bf16 map
    # further from its own f32 version than its maximum (occlusion here, a
    # difference of probabilities near 1e-3): printed only. AUCs within
    # ATTR_AUC_TOL of their curve's range.
    fails, chain_worst = [], {}
    for (dt, shape), (x, ws) in chain_inputs.items():
        tol = B2_TOL if dt == torch.bfloat16 else B2_F32_TOL
        worst = 0.0
        for k in range(len(ws) // 6):
            a = bottleneck_chain(x, ws[6 * k:6 * k + 6]).float()
            b = bottleneck_chain_plain(x, ws[6 * k:6 * k + 6]).float()
            worst = max(worst, ((a - b).abs().max() / b.abs().max()).item())
            x = a.to(dt)
        name = "bf16" if dt == torch.bfloat16 else "f32"
        chain_worst[name, shape[0]] = max(chain_worst.get((name, shape[0]), 0.0), worst)
        if not worst <= tol:
            fails.append(f"chain {name} {shape}: worst block {worst:.4g} > {tol}")
    for (path, d, kind), err in fwd.items():
        if kind == "b2" and d == "f32" and not err <= B2_F32_TOL:
            fails.append(f"{path} f32: a forward's B2 logits vs plain {err:.4g}")
        if kind == "b2_f32" and not err <= 2 * fwd[path, d, "plain_f32"] + B2_TOL:
            fails.append(f"{path} bf16: a forward's B2 logits {err:.4g} from f32, the plain "
                         f"path's {fwd[path, d, 'plain_f32']:.4g}")
    lines = []
    for name, _, _ in masked(engine):
        noise = rel_err(maps[name, "bf16"][1], maps[name, "f32"][1])
        for d in engines:
            if (d == "f32" or noise <= 1.0) and not errs[name, d] <= ATTR_B2_TOL:
                fails.append(f"{name} {d}: B2 map vs plain {errs[name, d]:.4g}")
        lines.append(f"{name} {errs[name, 'bf16']:.3g} bf16 (plain bf16 vs f32 {noise:.3g}"
                     + (", not held" if noise > 1.0 else "") + f"), {errs[name, 'f32']:.3g} f32")
    for d, (fid, auc_err) in aucs.items():
        if not auc_err <= ATTR_AUC_TOL:
            fails.append(f"fidelity {d}: B2 AUC vs plain {auc_err:.4g} of the curve's range")
    fid = aucs["bf16"][0]
    log(f"[attr] {smi}: B2 on these paths' own activations, worst block err / max|plain| by "
        "dtype and batch: " + ", ".join(f"{d} B={b} {w:.3g}" for (d, b), w in chain_worst.items())
        + "; per forward, worst max err / max|reference logit| (B2 vs plain; bf16 also B2 and "
        "plain vs the f32 plain path): " + "; ".join(
            f"{p} {d} {k} {err:.3g}" for (p, d, k), err in fwd.items())
        + "; maps, max err / max|plain map|: " + "; ".join(lines)
        + f"; deletion / insertion AUC bf16 {fid['deletion_auc']:.4f} / "
        f"{fid['insertion_auc']:.4f} (curve ranges {np.ptp(fid['deletion_curve']):.4g} / "
        f"{np.ptp(fid['insertion_curve']):.4g}), B2 vs plain {aucs['bf16'][1]:.3g} bf16, "
        f"{aucs['f32'][1]:.3g} f32 of the curve's range")
    if fails:
        raise AssertionError("[attr] " + "; ".join(fails))
    ms = {}
    for name, _, run in masked(engine):
        ms[name] = p50_ms(lambda: run(engine.folded_logits), 3)
    ms["fidelity (2 x 33 images)"] = p50_ms(
        lambda: deletion_insertion_auc(engine, normalized, heat, target), 3)
    rise_b2, rise_all = b2_device_ms(lambda: masked(engine)[1][2](engine.folded_logits))
    if rise_all > 0 and rise_b2 == 0:
        raise AssertionError("[attr] profile of rise_map: device time but no b2_ kernel")
    state_mb = sum(t.numel() * t.element_size() for t in v.values()) / 2**20
    log(f"[attr] {smi}: ResNet-101 224, BatchNorm statistics from 8 synthetic images, target "
        f"{target}; the engine's state dict on the card (the differentiable path's weights, "
        f"beside its folded plan) {state_mb:.1f} MiB; launches " + json.dumps(
            {p: by_path[p] for p in by_path if p.startswith("attr_")})
        + f"; rise_map under the profiler: b2_ kernels {rise_b2:.3f} of {rise_all:.3f} device ms")

    # The differentiable path: the plain module, no B2.
    v_cpu = {k: t.cpu() for k, t in v.items()}

    def methods(bundle_, variables, img, small):
        n = dict(steps=4, samples=4, iters=1, jitter=2) if small else \
            dict(steps=16, samples=16, iters=150, jitter=4)
        return {
            "integrated": lambda: g.integrated_gradients(bundle_.logits, variables, img, target,
                                                         steps=n["steps"]),
            "smoothgrad": lambda: g.smoothgrad(bundle_.logits, variables, img, target,
                                               samples=n["samples"], seed=SEED),
            "gradcam": lambda: g.gradcam(bundle_, variables, img, target),
            "xrai": lambda: xrai.xrai_saliency(bundle_.logits, variables, img, target, display,
                                               steps=n["steps"]),
            "meaningful": lambda: learned_mask.learned_mask_saliency(
                bundle_.logits, variables, img, target, iters=n["iters"], jitter=n["jitter"],
                seed=SEED, compute_dtype=bundle_.dtype),
        }

    def maps(fns):
        """{name: (compared map, heatmap, the learned mask's result or None)}."""
        out = {}
        for name, fn in fns.items():
            r = fn()
            out[name] = (r.attribution, r.heatmap, None) if name == "xrai" else \
                (r.heatmap, r.heatmap, r) if name == "meaningful" else (r, r, None)
        return out

    f32_card = counted(by_path, "attr_gradients", lambda: maps(methods(b32, v, image, True)), 0, 0)
    f32_cpu = maps(methods(b32, v_cpu, torch.from_numpy(normalized), True))
    card_lines, strays = [], []
    for name, (m, heat, res) in f32_card.items():
        check_map(name, heat)
        err, cpu = rel_err(m, f32_cpu[name][0]), host(f32_cpu[name][0])
        l2 = float(np.linalg.norm(host(m) - cpu) / np.linalg.norm(cpu))
        r = spearman_abs(host(m), cpu)
        line = f"{name} {err:.3g} (L2 {l2:.3g}, Spearman {r:.5f})"
        if res is None:
            if err > ATTR_F32_TOL or r < ATTR_F32_RHO:
                strays.append(name)
        else:
            # The learned mask: Adam's first step is close to lr * sign(g), so
            # a cell whose gradient the card and the CPU round to opposite signs
            # moves by +-lr; its loss and probability are what stay comparable.
            cres = f32_cpu[name][2]
            loss_err = abs(res.final_loss - cres.final_loss) / abs(cres.final_loss)
            prob_err = abs(res.prob_original - cres.prob_original) / cres.prob_original
            if loss_err > ATTR_LM_TOL or prob_err > ATTR_LM_TOL:
                strays.append(name)
            line += f", loss {loss_err:.3g} and p(target) {prob_err:.3g} relative"
        card_lines.append(line)
    log("[attr] f32 card vs f32 CPU (IG/XRAI 4 steps, SmoothGrad 4 samples, learned mask 1 "
        "step; max err / max|CPU map|): " + ", ".join(card_lines))
    if strays:
        raise AssertionError(f"[attr] f32 card vs CPU beyond {ATTR_F32_TOL} or Spearman "
                             f"{ATTR_F32_RHO}: {strays}")
    full = {"bf16": maps(methods(bundle, v, image, False)),
            "f32": maps(methods(b32, v, image, False))}
    rho = {name: spearman_abs(host(full["bf16"][name][1]), host(full["f32"][name][1]))
           for name in full["f32"]}
    for name, (_, heat, _) in full["bf16"].items():
        check_map(name + " bf16", heat)
    for name, fn in methods(bundle, v, image, False).items():
        ms[name] = p50_ms(fn, 2)
    ms["gradient"] = p50_ms(lambda: g.input_gradient(bundle.logits, v, image, target), 3)
    log(f"[attr] {smi}: differentiable path (plain module, launches "
        + json.dumps(by_path["attr_gradients"]) + "); bf16 vs f32 on the card at the "
        "defaults, Spearman |rank| correlation of the heatmaps: "
        + ", ".join(f"{k} {r:.4f}" for k, r in rho.items()))
    log(f"[attr] {smi}: warm ms per call (p50, bf16, defaults: occlusion 169 positions in "
        "chunks of 64, RISE 1000 masks in chunks of 250, Score-CAM 64 channels, IG and XRAI "
        "16 steps, SmoothGrad 16 samples, learned mask 150 steps x 4 shifts): "
        + ", ".join(f"{k} {t:.2f}" for k, t in ms.items()))
    return sd


def attr_cli_phase(by_path, calibrated):
    """The attribution CLIs on the card (see the module docstring, 16); the
    occlusion CLI reads ``calibrated`` (attr_phase's ResNet-101 state dict)
    through --ckpt, so that its map is not constant."""
    import tempfile

    import torch

    from network_interpretation_imagenet_tpu_torch.cli import attribution_sanity
    from network_interpretation_imagenet_tpu_torch.cli import (
        bayesian_active_learning_imagenet as bal,
    )
    from network_interpretation_imagenet_tpu_torch.cli import compare_saliency_methods as compare
    from network_interpretation_imagenet_tpu_torch.cli import occlusion_saliency

    parts = []
    with tempfile.TemporaryDirectory() as tmp:
        args = compare.parse_args(["--synthetic", "--num-images", "2", "--out", tmp])
        t0 = time.perf_counter()
        # B1: per image one window chunk and the BO host loop's 11 (ResNet-18: no B2).
        payload = counted(by_path, "cli_compare", lambda: quiet(lambda: compare.compute(args)),
                          24, 0)
        seconds = time.perf_counter() - t0
        ms = payload["methods"]
        if (payload["images_used"] != 2 or len(ms) != 16 or not all(
                np.isfinite([m["mean_deletion_auc"], m["mean_insertion_auc"]]).all()
                for m in ms.values())):
            raise AssertionError(f"compare payload {payload}")
        parts.append(f"compare_saliency_methods (ResNet-18, 16 methods, 2 images) {seconds:.2f} s, "
                     f"launches {json.dumps(by_path['cli_compare'])}, ranking "
                     + ",".join(payload["ranking"]) + "; s/img "
                     + ", ".join(f"{k} {m['seconds_per_image']:.3f}" for k, m in ms.items()))

        ckpt = f"{tmp}/resnet101_calibrated.pth"
        torch.save({"state_dict": {k: t.cpu() for k, t in calibrated.items()}}, ckpt)
        args = occlusion_saliency.parse_args(["--synthetic", "--arch", "resnet101", "--ckpt", ckpt,
                                              "--out", tmp])
        t0 = time.perf_counter()
        # B2: the prediction, the unoccluded forward and one chunk of 169 (--mask-batch 1024).
        payload, heat, _ = counted(by_path, "cli_occlusion",
                                   lambda: quiet(lambda: occlusion_saliency.compute(args)), 0, 12)
        check_map("occlusion_saliency", heat)
        parts.append(f"occlusion_saliency (ResNet-101) {time.perf_counter() - t0:.2f} s, "
                     f"heat range {payload['heat_range']}")

        args = attribution_sanity.parse_args(["--synthetic", "--out", tmp])
        t0 = time.perf_counter()
        payload = counted(by_path, "cli_sanity",
                          lambda: quiet(lambda: attribution_sanity.compute(args)), 0, 0)
        last = {m: rows[-1]["spearman"] for m, rows in payload["methods"].items()}
        if len(payload["stages"]) != 11 or not all(np.isfinite(list(last.values()))):
            raise AssertionError(f"sanity payload {payload}")
        parts.append(f"attribution_sanity (ResNet-18, 11 stages) {time.perf_counter() - t0:.2f} "
                     "s, Spearman after full randomization " + json.dumps(last))

        argv = ["--synthetic", "--arch", "resnet101", "--fused", "--fidelity", "--out", tmp]
        t0 = time.perf_counter()
        payload, _ = counted(by_path, "cli_fidelity",
                             lambda: quiet(lambda: bal.explain(bal.parse_args(argv))), 11, 52)
        if not (0.0 <= payload["deletion_auc"] <= 1.0 and 0.0 <= payload["insertion_auc"] <= 1.0):
            raise AssertionError(f"flagship --fidelity payload {payload}")
        parts.append(f"flagship --fidelity {time.perf_counter() - t0:.2f} s, deletion / insertion "
                     f"AUC {payload['deletion_auc']} / {payload['insertion_auc']}")
    torch.cuda.synchronize()
    log("[attr cli] " + "; ".join(parts) + "; launches "
        + json.dumps({p: by_path[p] for p in ("cli_occlusion", "cli_sanity", "cli_fidelity")}))


def slic_phase(display, smi):
    """SLIC on the card against the CPU (see the module docstring, 17)."""
    import torch

    from network_interpretation_imagenet_tpu_torch.config import SegmentConfig
    from network_interpretation_imagenet_tpu_torch.segment import slic
    from network_interpretation_imagenet_tpu_torch.segment.common import segment_image

    card = slic.slic(display, device="cuda").cpu().numpy()
    cpu = slic.slic(display, device="cpu").numpy()
    cfg = SegmentConfig(method="slic")
    seg_card, seg_cpu = segment_image(display, cfg, "cuda"), segment_image(display, cfg, "cpu")
    differ, seg_differ = int((card != cpu).sum()), int((seg_card != seg_cpu).sum())
    if differ > 0.001 * card.size or seg_differ > 0.001 * card.size:
        raise AssertionError(f"[slic] card vs CPU: {differ} k-means labels, {seg_differ} "
                             "segment labels differ")
    torch.cuda.synchronize()
    kmeans = time_ms(lambda: slic.slic(display, device="cuda"), 5)
    seg = p50_ms(lambda: segment_image(display, cfg, "cuda"), 5)
    log(f"[slic] {smi}: 224x224, 48 segments, 10 iterations: k-means labels differing card vs CPU "
        f"{differ} of {card.size}, segment labels {seg_differ} ({int(seg_card.max()) + 1} "
        f"segments); k-means on the card {kmeans:.3f} ms (device), segment_image with the host "
        f"pass {seg:.3f} ms (p50)")


def b1_shapes(smi):
    """B1 at the new archs' image shapes (see the module docstring, 3): each
    against its plain version bit for bit, bf16 and f32, at K = 256 (the
    engine's chunk, which [zoo]'s window paths launch), 1,000 (the
    generators' default, not a multiple of any group) and 1,024; device
    time, plain time and the bytes bound at K = 1,024 bf16. Returns one
    record per shape for the kernels line."""
    import torch

    from network_interpretation_imagenet_tpu_torch.ops import masking
    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import (
        masked_batch,
        masked_batch_plain,
    )

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 3)
    records = []
    for h, w, c in B1_SHAPES:
        hh, ww = np.mgrid[0:h, 0:w]
        cell = max(h // 7, 1)
        seg_np = ((hh // cell) * (w // cell + 1) + ww // cell).astype(np.int32)
        s = int(seg_np.max()) + 1
        width = max(1, int(0.4 * s))
        image = torch.from_numpy(rng.randn(h, w, c).astype(np.float32)).to(dev)
        seg = torch.from_numpy(seg_np).to(dev)
        for k in B1_KS:
            firsts = torch.from_numpy(masking.sample_window_starts_host(SEED, k, s, width)).to(dev)
            for dt in (torch.float32, torch.bfloat16):
                if not torch.equal(masked_batch(image, seg, firsts, width, dt),
                                   masked_batch_plain(image, seg, firsts, width, dt)):
                    raise AssertionError(f"B1 {dt} {h}x{w}x{c} K={k}: kernel differs from its "
                                         "plain version")
        ms = kernel_ms(lambda: masked_batch(image, seg, firsts, width, torch.bfloat16), 20,
                       "b1_masked_batch")
        plain_ms = time_ms(lambda: masked_batch_plain(image, seg, firsts, width,
                                                      torch.bfloat16), 20)
        nbytes = k * h * w * c * 2 + h * w * (c * 4 + 4) + k * 4
        bound = nbytes / H100_BYTES_PER_S * 1e3
        records.append({"shape": [h, w, c], "k": k, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": "bytes"})
        log(f"[B1] {smi}: {h}x{w}x{c} S={s}, K = {' and '.join(map(str, B1_KS))}: bit-exact "
            f"bf16+f32; at K={k} bf16 kernel {ms:.4f} ms (device time), plain {plain_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({nbytes} bytes), {bound / ms:.3f} of bound")
        del image, seg, firsts
    return records


def zoo_image(dataset, size):
    """(normalized f32 HWC, display uint8) of the synthetic image at
    ``size``^2 for ``dataset`` (one gray channel for MNIST), as the CLIs'
    resolve_image makes them."""
    import torch

    from network_interpretation_imagenet_tpu_torch.config import DATASETS
    from network_interpretation_imagenet_tpu_torch.ops.preprocess import (
        normalize,
        to_display_uint8,
    )

    spec = DATASETS[dataset]
    img_u8, _ = synthetic_image(SEED, size)
    base = np.ascontiguousarray(img_u8[:, :, :spec.channels].astype(np.float32) / 255.0)
    normalized = normalize(torch.from_numpy(base), spec.mean, spec.std).numpy()
    display = to_display_uint8(torch.from_numpy(normalized)).numpy()
    return normalized, (display[:, :, 0] if spec.channels == 1 else display)


def zoo_phase(smi, by_path):
    """Every new arch at full width and depth (see the module docstring, 21)."""
    import torch

    from network_interpretation_imagenet_tpu_torch.cli.common import segment_config
    from network_interpretation_imagenet_tpu_torch.models import ModulePlan, create_model
    from network_interpretation_imagenet_tpu_torch.ops import masking
    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import (
        masked_batch,
        masked_batch_plain,
    )
    from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
    from network_interpretation_imagenet_tpu_torch.segment.common import segment_image

    dev = torch.device("cuda")
    chunks = -(-NUM_SAMPLES // MASK_BATCH)
    rates = {}
    for arch, dataset, kw in ZOO:
        t_arch = time.perf_counter()
        bundle = create_model(arch, dataset, dtype=torch.bfloat16, **kw)
        sd = bundle.init(SEED)
        normalized, display = zoo_image(dataset, bundle.input_size)
        args = types.SimpleNamespace(dataset=dataset, segmenter="felzenszwalb", scale=None,
                                     sigma=0.5, min_size=None, n_segments=48)
        segments = segment_image(display, segment_config(args))
        s = int(segments.max()) + 1
        width = max(1, int(0.4 * s))
        firsts = masking.sample_window_starts_host(SEED, NUM_SAMPLES, s, width)
        knock = masking.sample_knockout_ids_host(SEED, NUM_SAMPLES, 1, s)
        engine = SaliencyEngine(bundle, sd, mask_batch=MASK_BATCH, device="cuda")
        target = engine.predict_one(normalized)[0]
        # B1 at every chunk the window path below gives it, on this arch's own
        # segments and starts: bit for bit against its plain version.
        image_t, seg_t = (torch.from_numpy(normalized).to(dev),
                          torch.from_numpy(segments).to(dev))
        firsts_t = torch.from_numpy(firsts).to(dev)
        for off in range(0, NUM_SAMPLES, MASK_BATCH):
            part = firsts_t[off:off + MASK_BATCH]
            if not torch.equal(masked_batch(image_t, seg_t, part, width, engine.compute_dtype),
                               masked_batch_plain(image_t, seg_t, part, width,
                                                  engine.compute_dtype)):
                raise AssertionError(f"[zoo] {arch}: B1 chunk at {off} differs from its plain "
                                     "version")
        # The engine's bf16 plan against the plain module in f32, 32 masked images.
        x = masked_batch_plain(image_t, seg_t, firsts_t[:32], width, torch.float32)
        f32 = ModulePlan(bundle.module, sd, torch.float32, dev)
        with torch.inference_mode():
            got, want = engine.model(x.to(torch.bfloat16)), f32(x)
            cpu = ModulePlan(bundle.module, sd, torch.float32, "cpu")(x[:8].cpu())
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        err32 = (want[:8].cpu() - cpu).abs().max().item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        if not (torch.isfinite(got).all() and err <= ZOO_TOL * scale
                and err32 <= ZOO_F32_TOL * cpu.abs().max().item()):
            raise AssertionError(f"[zoo] {arch}: bf16 plan vs f32 module err {err} (max |logit| "
                                 f"{scale}), f32 card vs CPU err {err32}")
        del f32, cpu, x, image_t, seg_t, firsts_t
        res = counted(by_path, f"zoo_{arch}_window", lambda: engine.eval_window_masks(
            normalized, segments, firsts, width, target), chunks, 0)
        ko = counted(by_path, f"zoo_{arch}_knockout", lambda: engine.eval_knockout_masks(
            normalized, segments, knock, target), 0, 0)
        if not (np.isfinite(res.prob_target).all() and np.isfinite(ko.prob_target).all()):
            raise AssertionError(f"[zoo] {arch}: non-finite outcomes")

        win = zoo_rate(lambda: engine.eval_window_masks(normalized, segments, firsts, width,
                                                        target))
        kor = zoo_rate(lambda: engine.eval_knockout_masks(normalized, segments, knock, target))
        rates[arch] = {"window": win, "knockout": kor}
        h = bundle.input_size
        log(f"[zoo] {smi}: {arch} ({dataset}, {h}x{h}x{bundle.input_channels}, S={s}, "
            f"target {target}): bf16 plan vs plain f32 module, 32 masked images, max logit err "
            f"{err:.4g} ({err / scale:.3g} of max |logit| {scale:.4g}), argmax agreement "
            f"{agree:.3f}; B1 bit-exact at its {chunks} chunks; f32 card vs CPU, 8 images, "
            f"{err32:.3g}; {NUM_SAMPLES} window masks {win['p50']:.1f} evals/s (range "
            f"{win['min']:.1f}-{win['max']:.1f} over {win['calls']} calls, survived "
            f"{int(res.survived.sum())}), {NUM_SAMPLES} knockouts M=1 {kor['p50']:.1f} evals/s "
            f"(range {kor['min']:.1f}-{kor['max']:.1f} over {kor['calls']} calls, survived "
            f"{int(ko.survived.sum())}), mask_batch {MASK_BATCH}; launches window {json.dumps(by_path[f'zoo_{arch}_window'])}, "
            f"knockout {json.dumps(by_path[f'zoo_{arch}_knockout'])}; "
            f"{time.perf_counter() - t_arch:.1f} s")
        del engine, bundle, sd
        torch.cuda.empty_cache()
    log(f"[zoo] {smi}: evals/s (median, range, calls) " + json.dumps(rates))


def zoo_rate(fn):
    """evals/s of ``fn`` (one call evaluates NUM_SAMPLES masks and waits for
    its results on the host): the median over as many warm calls as fill
    about half a second (5 to 100; a small net's call lasts a few ms), with
    the fastest and slowest call."""
    t0 = time.perf_counter()
    fn()
    calls = int(min(100, max(5, 0.5 / (time.perf_counter() - t0))))
    ts = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    r = NUM_SAMPLES / np.asarray(ts)
    return {"p50": round(float(np.median(r)), 1), "min": round(float(r.min()), 1),
            "max": round(float(r.max()), 1), "calls": calls}


def bo_zoo_phase(image, segments, smi, by_path):
    """bo_window_saliency at DenseNet-121 (see the module docstring, 22)."""
    import torch

    from network_interpretation_imagenet_tpu_torch.config import BOConfig
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.saliency.bo_pipeline import bo_window_saliency
    from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine

    cfg = BOConfig()
    n_fwd = 1 + cfg.n_iters
    bundle = create_model("densenet121", "imagenet", dtype=torch.bfloat16)
    engine = SaliencyEngine(bundle, bundle.init(SEED), mask_batch=MASK_BATCH, device="cuda")
    target = engine.predict_one(image)[0]

    def explain():
        return bo_window_saliency(engine, image, segments, cfg, seed=SEED, target=target)

    _, eager = counted(by_path, "bo_zoo_first_call", explain, n_fwd, 0)
    _, graph = counted(by_path, "bo_zoo_capture", explain, n_fwd, 0)
    t0 = time.perf_counter()
    _, replayed = counted(by_path, "bo_zoo_replay", explain, 0, 0)
    replay_ms = (time.perf_counter() - t0) * 1e3
    ys_err = float(np.abs(graph.yp - eager.yp).max())
    if not (np.array_equal(graph.xp, eager.xp) and np.array_equal(graph.survived, eager.survived)
            and ys_err <= 1e-6 and np.array_equal(replayed.xp, graph.xp)
            and np.array_equal(replayed.yp, graph.yp)):
        raise AssertionError(f"[bo zoo] replay {graph.xp.tolist()} vs eager {eager.xp.tolist()}, "
                             f"ys err {ys_err}")
    log(f"[bo zoo] {smi}: densenet121 224 bf16, target {target}: xp {eager.xp.tolist()} survived "
        f"{int(eager.survived.sum())}/{len(eager.xp)}; replays equal the eager run (ys err "
        f"{ys_err:.3g}); a warm replayed call {replay_ms:.2f} ms; launches first call / capture / "
        "replay " + " / ".join(json.dumps(by_path[k]) for k in
                               ("bo_zoo_first_call", "bo_zoo_capture", "bo_zoo_replay")))
    del engine
    torch.cuda.empty_cache()


def gen_small_phase(smi, by_path):
    """The MNIST and CIFAR generators (see the module docstring, 23)."""
    import tempfile

    import torch

    from network_interpretation_imagenet_tpu_torch.cli import generate_gp_training_data_cifar
    from network_interpretation_imagenet_tpu_torch.cli import generate_gp_training_data_mnist
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.utils import convert

    for name, gen, arch, dataset in (("mnist", generate_gp_training_data_mnist, "mnist_cnn",
                                      "mnist"),
                                     ("cifar", generate_gp_training_data_cifar, "resnet",
                                      "cifar10+")):
        with tempfile.TemporaryDirectory() as tmp:
            bundle = create_model(arch, dataset)
            sd = bundle.init(SEED)
            art = f"{tmp}/weights"
            convert.save_weights_artifact(convert.jax_variables(sd, bundle.module), art,
                                          meta={"arch": arch, "dataset": dataset})
            back = convert.from_jax(convert.load_weights_artifact(art)[0], bundle.module)
            if not all(torch.equal(back[k], sd[k]) for k in sd):
                raise AssertionError(f"[gen {name}] the artifact does not read back bit for bit")
            args = gen.parse_args(["--synthetic", "--ckpt", art, "--out", f"{tmp}/out"])
            t0 = time.perf_counter()
            payload, result = counted(by_path, f"gen_{name}",
                                      lambda: quiet(lambda: gen.compute(args)), 0, 0)
            seconds = time.perf_counter() - t0
        out = result["out"]
        if not (np.isfinite(out.heatmap).all() and out.masks.shape[0] == args.num_mask_samples
                and payload["num_segments"] == out.num_segments
                and payload["correct_pred_count"] == int(out.eval.survived.sum())):
            raise AssertionError(f"[gen {name}] payload {payload}")
        log(f"[gen {name}] {smi}: {arch} ({args.dataset}, {args.dtype}), weights from a port-"
            f"written artifact ({len(sd)} tensors, read back bit for bit); {args.num_mask_samples}"
            f" knockouts of M={args.num_masked_superpixels}; compute {seconds * 1e3:.1f} ms with "
            f"its engine build; payload " + json.dumps({k: v for k, v in payload.items()
                                                         if k != "masks_npz"})
            + f"; launches {json.dumps(by_path[f'gen_{name}'])}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from network_interpretation_imagenet_tpu_torch.config import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        SegmentConfig,
    )
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.ops import _cuda_build, masking
    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import (
        bottleneck_chain,
        bottleneck_chain_plain,
        chain_plan,
    )
    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import (
        masked_batch,
        masked_batch_plain,
    )
    from network_interpretation_imagenet_tpu_torch.ops.preprocess import (
        normalize,
        to_display_uint8,
    )
    from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
    from network_interpretation_imagenet_tpu_torch.saliency.pipeline import (
        localization_score,
        random_window_saliency,
    )
    from network_interpretation_imagenet_tpu_torch.segment.common import segment_image

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} card {kind} x{torch.cuda.device_count()}")
    log(f"[device] {smi}")

    # 2. build
    t0 = time.perf_counter()
    compile_s = _cuda_build.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s wall; per source "
        + json.dumps({k: round(v, 2) for k, v in compile_s.items()}))
    for name in compile_s:
        with open(f"{_cuda_build.BUILD_DIR}/{name}.log") as f:
            for line in f:
                if "Used" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")
                if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                    raise AssertionError(f"{name}: ptxas spills registers: {line.strip()}")
    hgmma = sass_hgmma(_cuda_build.so_path("bottleneck_chain"))
    log(f"[build] bottleneck_chain SASS: {hgmma} HGMMA instructions")
    if hgmma == 0:
        raise AssertionError("B2's library holds no HGMMA: its bf16 kernels do not use wgmma")

    # 3. B1 against its plain version (K = the main path's chunk)
    rng = np.random.RandomState(SEED)
    hh, ww = np.mgrid[0:224, 0:224]
    seg_np = ((hh // 16) * 14 + ww // 16).astype(np.int32)  # 196 segments
    s = int(seg_np.max()) + 1
    width = int(0.4 * s)
    firsts_np = masking.sample_window_starts_host(SEED, MASK_BATCH, s, width)
    firsts_np[-1] = s - 3  # this window runs past the last segment
    image = torch.from_numpy(rng.randn(224, 224, 3).astype(np.float32)).to(dev)
    seg = torch.from_numpy(seg_np).to(dev)
    firsts = torch.from_numpy(firsts_np).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        got = masked_batch(image, seg, firsts, width, dt)
        want = masked_batch_plain(image, seg, firsts, width, dt)
        if not torch.equal(got, want):
            raise AssertionError(f"B1 {dt}: kernel differs from its plain version")
        # The BO loop's batches: K = 1 and 3 with the width read on the device,
        # and one image's slice of a larger buffer.
        width_dev = torch.tensor([width], dtype=torch.int32, device=dev)
        for k in (1, 3):
            if not torch.equal(masked_batch(image, seg, firsts[-k:], width_dev, dt),
                               masked_batch_plain(image, seg, firsts[-k:], width, dt)):
                raise AssertionError(f"B1 {dt} K={k}: kernel differs from its plain version")
        buf = torch.zeros((6, 224, 224, 3), dtype=dt, device=dev)
        masked_batch(image, seg, firsts[:3], width_dev, dt, out=buf[3:])
        if not torch.equal(buf[3:], want[:3]) or buf[:3].any():
            raise AssertionError(f"B1 {dt}: out= slice differs from the default")
    b1_by_shape = b1_shapes(smi)
    b1_ms = kernel_ms(lambda: masked_batch(image, seg, firsts, width, torch.bfloat16), 50,
                      "b1_masked_batch")
    b1_plain_ms = time_ms(lambda: masked_batch_plain(image, seg, firsts, width,
                                                     torch.bfloat16), 50)
    b1_bytes = MASK_BATCH * 224 * 224 * 3 * 2 + 224 * 224 * (3 * 4 + 4) + MASK_BATCH * 4
    b1_bound_ms = b1_bytes / H100_BYTES_PER_S * 1e3
    log(f"[B1] K={MASK_BATCH}, 1 and 3 (width on the device), and an out= slice, 224x224x3 "
        f"S={s}: bit-exact bf16+f32; kernel {b1_ms:.4f} ms (device time), "
        f"plain {b1_plain_ms:.4f} ms, bound {b1_bound_ms:.4f} ms ({b1_bytes} bytes), "
        f"{b1_bound_ms / b1_ms:.3f} of bound")

    # 4. B2 against its plain version at the four ResNet-101 stage shapes
    small = {b: [0.0, 0.0, 0.0] for b in BO_BATCHES}  # B2 ms, chain bound, cuDNN per forward
    small_cases = []   # (batch, x, ws) of the BO's batches, for the graph yardstick at the end
    b2 = {"ms": 0.0, "plain_ms": 0.0, "cudnn_ms": 0.0, "floor_ms": 0.0, "flops": 0, "bytes": 0,
          "block_err": 0.0}
    for batch in B2_BATCHES:
        for h, c, p, n in STAGES_101:
            ws = b2_weights(rng, c, p, n, torch.bfloat16, dev)
            x = torch.from_numpy(np.abs(rng.randn(batch, h, h, c)).astype(np.float32)
                                 ).to(dev, torch.bfloat16)
            block_err, outside, chain_err = check_chain(x, ws, B2_TOL)
            b2["block_err"] = max(b2["block_err"], block_err)
            line = (f"[B2] B={batch} H={h} C={c} P={p} blocks={n}: worst block err "
                    f"{block_err:.4g} (tol {B2_TOL} x max|plain|; {outside} of "
                    f"{x.numel() * n} outputs outside elementwise rtol=atol={B2_TOL}), "
                    f"whole-chain err {chain_err:.4g}")
            if batch == MASK_BATCH:
                flops, nbytes, floor = b2_costs(h, c, p, n, batch)
                bound = max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
                ms = time_ms(lambda: bottleneck_chain(x, ws), 10)
                plain_ms = time_ms(lambda: bottleneck_chain_plain(x, ws), 3)
                cudnn_ms = time_ms(cudnn_chain(x, ws), 10)
                for key, v in (("ms", ms), ("plain_ms", plain_ms), ("cudnn_ms", cudnn_ms),
                               ("floor_ms", floor), ("flops", flops), ("bytes", nbytes)):
                    b2[key] += v
                us = conv_us(x, ws)
                line += (f"; kernel {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s, "
                         f"{bound / ms:.3f} of the chain bound {bound:.4f} ms ({flops:.4g} "
                         f"flop, {nbytes} bytes), 3-launch floor {floor:.4f} ms; plain (cuDNN "
                         f"f32) {plain_ms:.4f} ms; yardstick bf16 cuDNN chain {cudnn_ms:.4f} ms; "
                         f"per block reduce / 3x3 / expand "
                         + " / ".join(f"{u:.1f}" for u in us) + " us")
            elif batch in BO_BATCHES:  # the BO loop's forwards
                flops, nbytes, _ = b2_costs(h, c, p, n, batch)
                bound = max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
                ms = time_ms(lambda: bottleneck_chain(x, ws), 20)
                cudnn_ms = time_ms(cudnn_chain(x, ws), 20)
                small[batch] = [v + d for v, d in zip(small[batch], (ms, bound, cudnn_ms))]
                small_cases.append((batch, x, ws))
                grids = [cp.grid for cp in chain_plan(batch, h, h, c, p)]
                line += (f"; kernel {ms:.4f} ms ({ms / (3 * n) * 1e3:.1f} us per launch), chain "
                         f"bound {bound:.4f} ms, yardstick bf16 cuDNN chain {cudnn_ms:.4f} ms, "
                         "blocks per launch reduce / 3x3 / expand "
                         + " / ".join(map(str, grids)))
            log(line)
            del x, ws
    log(f"[B2] {smi}: total per forward of {MASK_BATCH}: kernel {b2['ms']:.4f} ms, yardstick "
        f"bf16 cuDNN {b2['cudnn_ms']:.4f} ms, 3-launch floor {b2['floor_ms']:.4f} ms; "
        + "; ".join(f"per forward of {b}: kernel {v[0]:.4f} ms, chain bound {v[1]:.4f} ms, "
                    f"yardstick bf16 cuDNN {v[2]:.4f} ms (eager)" for b, v in small.items()))
    f32_cases = [(4, (h, c, p, 2)) for h, c, p, _ in (STAGES_101[0], STAGES_101[3])]
    f32_cases += [(batch, stage) for batch in B2_F32_BATCHES for stage in STAGES_101]
    for batch, (h, c, p, n) in f32_cases:
        ws = b2_weights(rng, c, p, n, torch.float32, dev)
        x = torch.from_numpy(np.abs(rng.randn(batch, h, h, c)).astype(np.float32)).to(dev)
        block_err, outside, chain_err = check_chain(x, ws, B2_F32_TOL)
        log(f"[B2] f32 B={batch} H={h} C={c} P={p} blocks={n}: worst block err "
            f"{block_err:.4g} (tol {B2_F32_TOL} x max|plain|; {outside} outside elementwise), "
            f"whole-chain err {chain_err:.4g}")
        del x, ws
    torch.cuda.synchronize()

    # 5. the main path at full width
    img_u8, gt = synthetic_image(SEED)
    normalized = normalize(torch.from_numpy(img_u8.astype(np.float32) / 255.0),
                           IMAGENET_MEAN, IMAGENET_STD).numpy()
    display = to_display_uint8(torch.from_numpy(normalized)).numpy()
    bundle = create_model("resnet101", "imagenet", dtype=torch.bfloat16)
    engine = SaliencyEngine(bundle, bundle.init(SEED), mask_batch=MASK_BATCH, device="cuda")
    masked_batch.launches = 0
    bottleneck_chain.launches = 0
    t0 = time.perf_counter()
    segments = segment_image(display, SegmentConfig())
    target, logits = engine.predict_one(normalized)
    out = random_window_saliency(engine, normalized, segments, num_samples=NUM_SAMPLES,
                                 seed=SEED, target=target)
    iou, box = localization_score(out.heatmap, gt)
    main_s = time.perf_counter() - t0
    launches = {"masked_batch": masked_batch.launches,
                "bottleneck_chain": bottleneck_chain.launches}
    chunks = -(-NUM_SAMPLES // MASK_BATCH)
    forwards = 1 + chunks
    log(f"[main] S={out.num_segments} width={out.width} target={target} "
        f"survived={int(out.eval.survived.sum())}/{NUM_SAMPLES} box={box.tolist()} "
        f"gt={list(gt)} iou={iou:.4f} in {main_s:.3f} s; launches {json.dumps(launches)}")
    if launches["masked_batch"] != chunks:
        raise AssertionError(f"B1 launched {launches['masked_batch']} times, want {chunks}")
    if launches["bottleneck_chain"] != 4 * forwards:
        raise AssertionError(f"B2 launched {launches['bottleneck_chain']} times, "
                             f"want {4 * forwards}")
    if not (np.isfinite(logits).all() and np.isfinite(out.heatmap).all()):
        raise AssertionError("non-finite logits or heatmap")
    if out.heatmap.shape != (224, 224) or not 0.0 <= iou <= 1.0:
        raise AssertionError(f"heatmap {out.heatmap.shape}, iou {iou}")

    with torch.inference_mode():
        image_t = torch.from_numpy(normalized).to(dev)
        seg_t = torch.from_numpy(np.asarray(segments, np.int32)).to(dev)
        imgs = masked_batch(image_t, seg_t, torch.from_numpy(out.firsts[:32]).to(dev),
                            out.width, torch.bfloat16)
        k_logits = engine.model(imgs)
        p_logits = engine.model(imgs, plain=True)
    model_err = (k_logits - p_logits).abs().max().item()
    model_scale = p_logits.abs().max().item()
    agree = (k_logits.argmax(-1) == p_logits.argmax(-1)).float().mean().item()
    log(f"[main] ResNet-101 logits, kernel vs plain path, 32 masked images: max err "
        f"{model_err:.4g} (max |logit| {model_scale:.4g}), argmax agreement {agree:.4f}")
    if not torch.isfinite(k_logits).all() or model_err > 0.05 * model_scale:
        raise AssertionError("whole-model logits: kernel path strays from the plain path")

    # f32 parity mode: the f32 kernel instances on the card vs the plain
    # versions on the CPU, same weights, 16 masked images.
    sd = bundle.init(SEED)
    e32 = {d: SaliencyEngine(bundle, sd, mask_batch=16, compute_dtype=torch.float32,
                             device=d) for d in ("cuda", "cpu")}
    before = (masked_batch.launches, bottleneck_chain.launches)
    r32 = {d: e.eval_window_masks(normalized, segments, out.firsts[:16], out.width, target)
           for d, e in e32.items()}
    if (masked_batch.launches - before[0], bottleneck_chain.launches - before[1]) != (1, 4):
        raise AssertionError("the f32 engine on the card did not run B1 once and B2 4 times")
    with torch.inference_mode():
        l32 = {}
        for d, e in e32.items():
            x = masked_batch(torch.from_numpy(normalized).to(d),
                             torch.from_numpy(np.asarray(segments, np.int32)).to(d),
                             torch.from_numpy(out.firsts[:16]).to(d), out.width, torch.float32)
            l32[d] = e.model(x).cpu()
    err32 = (l32["cuda"] - l32["cpu"]).abs().max().item()
    scale32 = l32["cpu"].abs().max().item()
    log(f"[main] f32 engine, card (kernels) vs CPU (plain versions), 16 masked images: "
        f"max logit err {err32:.4g} (max |logit| {scale32:.4g}), preds equal "
        f"{bool(np.array_equal(r32['cuda'].preds, r32['cpu'].preds))}")
    if not err32 <= 1e-4 * scale32 or not np.array_equal(r32["cuda"].preds, r32["cpu"].preds):
        raise AssertionError("f32 engine: the card strays from the CPU")

    # 6. timings
    def evals_per_s(mb):
        engine.mask_batch = mb
        engine.eval_window_masks(normalized, segments, out.firsts, out.width, target)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            engine.eval_window_masks(normalized, segments, out.firsts, out.width, target)
            ts.append(time.perf_counter() - t0)
        return NUM_SAMPLES / float(np.median(ts))

    rates = {mb: evals_per_s(mb) for mb in (128, 256, 512)}
    engine.mask_batch = MASK_BATCH
    lat = []
    for i in range(5):
        t0 = time.perf_counter()
        random_window_saliency(engine, normalized, segments, num_samples=NUM_SAMPLES,
                               seed=SEED + i, target=target)
        lat.append(time.perf_counter() - t0)
    log(f"[timing] {smi}: masked-forward evals/s (ResNet-101 224 bf16, {NUM_SAMPLES} masks) "
        + ", ".join(f"mask_batch {mb}: {r:.1f}" for mb, r in rates.items())
        + f"; random_window_saliency p50 {np.median(lat) * 1e3:.2f} ms "
        f"({NUM_SAMPLES} masks, mask_batch {MASK_BATCH}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; total {time.perf_counter() - t_start:.1f} s")

    # B2's bound: the four chain calls of one forward at the main path's batch.
    b2_ops_ms = b2["flops"] / H100_BF16_FLOPS * 1e3
    b2_bytes_ms = b2["bytes"] / H100_BYTES_PER_S * 1e3
    wall, groups, top = device_breakdown(lambda: engine.eval_window_masks(
        normalized, segments, out.firsts, out.width, target))
    busy = sum(groups.values())
    log(f"[profile] {smi}: eval_window_masks ({NUM_SAMPLES} masks, mask_batch {MASK_BATCH}) "
        f"wall {wall * 1e3:.2f} ms; device ms by group "
        + json.dumps({k: round(v, 3) for k, v in groups.items()})
        + (f"; device busy {busy / (wall * 1e3):.3f} of wall" if busy > 0
           else "; device time not measured (the profiler saw none)"))
    log("[profile] largest other kernels (ms): "
        + json.dumps({k: round(v, 3) for k, v in top}))

    paths = {"random_window": launches}
    seg_np = np.asarray(segments, np.int32)
    pool, pool_segs, pool_targets = bo_phase(engine, normalized, seg_np, target, smi, paths)
    cli_phase(paths)
    gen_phase(engine, smi, paths)
    resnet18_phase(normalized, seg_np, out.firsts, out.width, smi, paths)
    resnext_phase(normalized, seg_np, out.firsts, out.width, smi, paths)
    knockout_phase(engine, normalized, seg_np, target, smi, paths)
    heats = multi_phase(engine, pool, pool_segs, pool_targets, rates[MASK_BATCH], smi, paths)
    gp_phase(out.heatmap, heats, smi)
    gp_cli_phase(paths)
    calibrated = attr_phase(normalized, display, smi, paths)
    attr_cli_phase(paths, calibrated)
    slic_phase(display, smi)
    sweep_phase(engine, smi, paths)
    zoo_phase(smi, paths)
    bo_zoo_phase(normalized, seg_np, smi, paths)
    gen_small_phase(smi, paths)
    b2_graph_phase(small_cases, smi)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    by_path = {name: {path: counts[name] for path, counts in paths.items()} for name in launches}

    kernels = [
        {"name": "masked_batch", "route": "cuda", "source": f"{PKG}/csrc/masked_batch.cu",
         "replaces": "network_interpretation_imagenet_tpu/ops/pallas_masking.py:49",
         "launches": sum(by_path["masked_batch"].values()),
         "launches_by_path": by_path["masked_batch"], "max_abs_err": 0.0, "ms": b1_ms,
         "plain_ms": b1_plain_ms, "bound_ms": b1_bound_ms, "bound_by": "bytes",
         "library_ms": None, "by_shape": b1_by_shape},
        {"name": "bottleneck_chain", "route": "cuda",
         "source": f"{PKG}/csrc/bottleneck_chain.cu",
         "replaces": "network_interpretation_imagenet_tpu/ops/pallas_bottleneck.py:105",
         "launches": sum(by_path["bottleneck_chain"].values()),
         "launches_by_path": by_path["bottleneck_chain"], "max_abs_err": b2["block_err"],
         "ms": b2["ms"], "plain_ms": b2["plain_ms"], "bound_ms": max(b2_ops_ms, b2_bytes_ms),
         "bound_by": "operations" if b2_ops_ms >= b2_bytes_ms else "bytes",
         "library_ms": None},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
