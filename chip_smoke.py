#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives network_interpretation_imagenet_tpu_torch's main path at full width
(ResNet-101, 224x224, bf16, seeded random weights) and holds every
hand-written kernel against its plain PyTorch version on the card:

  1. device: torch/CUDA versions, the card's name and power limit;
  2. build: compiles csrc/*.cu from the checkout (one nvcc per source, in
     parallel) into the package's _build/;
  3. B1 masked_batch vs its plain version, bf16 and f32, bit-exact;
  4. B2 bottleneck_chain vs its plain version at all four ResNet-101 stage
     shapes with the real block counts, block by block within bf16
     tolerance, at B = 3 (ragged against every tile), 32 and 256 (and f32 at
     two shapes); per stage at B=256 its time, TFLOP/s, share of its bound,
     the floor of three launches per block and a bf16 cuDNN yardstick; the
     built library's SASS must hold HGMMA (wgmma) instructions;
  5. the main path: Felzenszwalb -> predict_one -> random_window_saliency
     (1024 masks) -> localization_score, with the launch counters reset
     just before and read just after, then kernel-path vs plain-path
     logits of the whole model on 32 masked images;
  6. timings: warm masked-forward evals/s and p50 per-image latency.

Any failure raises and exits non-zero. The line before the last is the
kernels' JSON record, the last line {"ok": true, "device": {...}}. Without a
CUDA device it exits non-zero and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

MASK_BATCH = 256
NUM_SAMPLES = 1024
SEED = 0
H100_BF16_FLOPS = 989e12     # dense tensor-core peak, SXM (NVIDIA data sheet)
H100_BYTES_PER_S = 3.35e12   # HBM3 (NVIDIA data sheet)
STAGES_101 = ((56, 256, 64, 2), (28, 512, 128, 3), (14, 1024, 256, 22), (7, 2048, 512, 2))
B2_BATCHES = (3, 32, MASK_BATCH)
B2_TOL = 2e-2                # bf16: rtol = atol; one bf16 ulp is 2^-8 relative
B2_F32_TOL = 1e-4            # f32 instance: summation order only
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
    flops = 34 * m * p * p * n
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
    b1_ms = kernel_ms(lambda: masked_batch(image, seg, firsts, width, torch.bfloat16), 50,
                      "b1_masked_batch")
    b1_plain_ms = time_ms(lambda: masked_batch_plain(image, seg, firsts, width,
                                                     torch.bfloat16), 50)
    b1_bytes = MASK_BATCH * 224 * 224 * 3 * 2 + 224 * 224 * (3 * 4 + 4) + MASK_BATCH * 4
    b1_bound_ms = b1_bytes / H100_BYTES_PER_S * 1e3
    log(f"[B1] K={MASK_BATCH} 224x224x3 S={s}: bit-exact bf16+f32; kernel {b1_ms:.4f} ms "
        f"(device time), "
        f"plain {b1_plain_ms:.4f} ms, bound {b1_bound_ms:.4f} ms ({b1_bytes} bytes), "
        f"{b1_bound_ms / b1_ms:.3f} of bound")

    # 4. B2 against its plain version at the four ResNet-101 stage shapes
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
            log(line)
            del x, ws
    log(f"[B2] {smi}: total per forward of {MASK_BATCH}: kernel {b2['ms']:.4f} ms, yardstick "
        f"bf16 cuDNN {b2['cudnn_ms']:.4f} ms, 3-launch floor {b2['floor_ms']:.4f} ms")
    for h, c, p, n in (STAGES_101[0], STAGES_101[3]):
        ws = b2_weights(rng, c, p, 2, torch.float32, dev)
        x = torch.from_numpy(np.abs(rng.randn(4, h, h, c)).astype(np.float32)).to(dev)
        block_err, outside, chain_err = check_chain(x, ws, B2_F32_TOL)
        log(f"[B2] f32 B=4 H={h} C={c} P={p} blocks=2: worst block err {block_err:.4g} "
            f"(tol {B2_F32_TOL} x max|plain|; {outside} outside elementwise), "
            f"whole-chain err {chain_err:.4g}")
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

    kernels = [
        {"name": "masked_batch", "route": "cuda", "source": f"{PKG}/csrc/masked_batch.cu",
         "replaces": "network_interpretation_imagenet_tpu/ops/pallas_masking.py:49",
         "launches": launches["masked_batch"], "max_abs_err": 0.0, "ms": b1_ms,
         "plain_ms": b1_plain_ms, "bound_ms": b1_bound_ms, "bound_by": "bytes",
         "library_ms": None},
        {"name": "bottleneck_chain", "route": "cuda",
         "source": f"{PKG}/csrc/bottleneck_chain.cu",
         "replaces": "network_interpretation_imagenet_tpu/ops/pallas_bottleneck.py:105",
         "launches": launches["bottleneck_chain"], "max_abs_err": b2["block_err"],
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
