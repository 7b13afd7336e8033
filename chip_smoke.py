#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives network_interpretation_imagenet_tpu_torch's main path at full width
(ResNet-101, 224x224, bf16, seeded random weights) and holds every
hand-written kernel against its plain PyTorch version on the card:

  1. device: torch/CUDA versions, the card's name and power limit;
  2. build: compiles csrc/*.cu from the checkout (one nvcc per source, in
     parallel) into the package's _build/;
  3. B1 masked_batch vs its plain version, bf16 and f32, bit-exact, at the
     random-window chunk (K=256), the BO loop's K = 1 and 3 with the width
     read on the device, and into an out= slice of a larger buffer;
  4. B2 bottleneck_chain vs its plain version at all four ResNet-101 stage
     shapes with the real block counts, block by block within bf16
     tolerance, at B = 1 and 3 (the single-image BO loop's), 8 and 24 (the
     N=8 loop's), 32 and 256 (and f32 at two shapes); per stage at B=256 its
     time, TFLOP/s, share of its bound, the floor of three launches per
     block and a bf16 cuDNN yardstick; the built library's SASS must hold
     HGMMA (wgmma) instructions;
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
     is missing), counters held (B1 11, B2 48).

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

import numpy as np

MASK_BATCH = 256
NUM_SAMPLES = 1024
SEED = 0
H100_BF16_FLOPS = 989e12     # dense tensor-core peak, SXM (NVIDIA data sheet)
H100_BYTES_PER_S = 3.35e12   # HBM3 (NVIDIA data sheet)
STAGES_101 = ((56, 256, 64, 2), (28, 512, 128, 3), (14, 1024, 256, 22), (7, 2048, 512, 2))
B2_BATCHES = (1, 3, 8, 24, 32, MASK_BATCH)
B2_TOL = 2e-2                # bf16: rtol = atol; one bf16 ulp is 2^-8 relative
B2_F32_TOL = 1e-4            # f32 instance: summation order only
BO_IMAGES = 8                # bo_window_saliency_multi's N
BO_BATCHES = (1, 3, 8, 24)   # the BO loops' forwards: single image, and N=8 images
BO_SCORE_TOL = 0.05          # a BO score vs the engine's at another batch (bf16 rounding)
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
    small = {b: [0.0, 0.0] for b in BO_BATCHES}  # B2 ms and chain bound per forward
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
                small[batch] = [v + d for v, d in zip(small[batch], (ms, bound))]
                grids = [cp.grid for cp in chain_plan(batch, h, h, c, p)]
                line += (f"; kernel {ms:.4f} ms ({ms / (3 * n) * 1e3:.1f} us per launch), chain "
                         f"bound {bound:.4f} ms, blocks per launch reduce / 3x3 / expand "
                         + " / ".join(map(str, grids)))
            log(line)
            del x, ws
    log(f"[B2] {smi}: total per forward of {MASK_BATCH}: kernel {b2['ms']:.4f} ms, yardstick "
        f"bf16 cuDNN {b2['cudnn_ms']:.4f} ms, 3-launch floor {b2['floor_ms']:.4f} ms; "
        + "; ".join(f"per forward of {b}: kernel {v[0]:.4f} ms, chain bound {v[1]:.4f} ms"
                    for b, v in small.items()))
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

    paths = {"random_window": launches}
    bo_phase(engine, normalized, np.asarray(segments, np.int32), target, smi, paths)
    cli_phase(paths)
    by_path = {name: {path: counts[name] for path, counts in paths.items()} for name in launches}

    kernels = [
        {"name": "masked_batch", "route": "cuda", "source": f"{PKG}/csrc/masked_batch.cu",
         "replaces": "network_interpretation_imagenet_tpu/ops/pallas_masking.py:49",
         "launches": sum(by_path["masked_batch"].values()),
         "launches_by_path": by_path["masked_batch"], "max_abs_err": 0.0, "ms": b1_ms,
         "plain_ms": b1_plain_ms, "bound_ms": b1_bound_ms, "bound_by": "bytes",
         "library_ms": None},
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
