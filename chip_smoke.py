#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --ptrain-witness   # only the f32 parting witness (see 27)
    python3 chip_smoke.py --b2                # only B2's checks and timings, both instances (b2_only)
    python3 chip_smoke.py --b1                # only B1's checks and timings (see b1_only)
    python3 chip_smoke.py --pool              # only the build and [pool] (see pool_only)
    python3 chip_smoke.py --epilogue          # only the build and [epilogue] (see epilogue_only)
    python3 chip_smoke.py --zoo-grad          # only the build and [zoo grad] (see zoo_grad_only)

Drives network_interpretation_imagenet_tpu_torch's main path at full width
(ResNet-101, 224x224, bf16, seeded random weights), every other classifier
of the JAX package at its published size, and holds every hand-written
kernel against its plain PyTorch version on the card:

  1. device: torch/CUDA versions, the card's name and power limit;
  2. build: compiles csrc/*.cu from the checkout (one nvcc per source, in
     parallel) into the package's _build/;
  3. B1 masked_batch vs its plain version, bf16 and f32, bit-exact, at the
     random-window chunk (K=256), the BO loop's K = 1 and 3 with the width
     read on the device, [serve]'s buckets K = 32 and 1,024 (groups of 4,
     and of 64 with the table of starts full), and into an out= slice of a
     larger buffer; and at
     the new archs' shapes, 28x28x1 (MNIST: the generic C=1 instance),
     32x32x3 (CIFAR) and 299x299x3 (Inception-v3: H*W*C odd, so rows start
     at every residue mod 16 bytes), each at K = 256 (the engine's chunk),
     1,000 and 1,024; at all four shapes, into out= slices big[j:j+K] of a
     NaN-filled buffer for j = 0..7 and K = 1, 3, 7, 256, 1,000 and 1,024,
     the rest of the buffer left untouched; at the new archs' shapes from
     an image that is one of a stacked pair (at 299x299x3 its base off
     16-byte alignment); device time, plain time and bytes bound at
     224x224x3 K=256 bf16 and K = 256 and 32 f32 (aligned rows), at the new
     shapes at K = 1,024 bf16, and at 299x299x3 at K = 256 and 1,024 in
     bf16 and f32; the SASS of every b1_masked_batch
     instance must hold 128-bit global stores (STG.E.128);
  4. B2 bottleneck_chain vs its plain version at all four ResNet-101 stage
     shapes with the real block counts, block by block within bf16
     tolerance, at B = 1 and 3 (the single-image BO loop's), 8 and 24 (the
     N=8 loop's), 32 and 256, 4 and 12 (the sweep's flushes of 4 images: a
     predict or a BO iteration, the BO pre-samples) and 100 (the window
     CLIs' default chunk), 1024 ([serve]'s /eval_windows bucket), and 2, 6
     and 512 ([parallel]'s: a rank's BO forwards and its half of 1,024
     masks); f32 (B2's f32 instance, within B2_F32_TOL) at
     B = 1, 2, 32 ([serve]'s f32 artifact) and 256 (the f32 sweep's
     predicts and chunk), 3, 8 and 24 (the f32 BO loops') at all four
     shapes and at B=4 at two; per stage at B=256 its
     time, TFLOP/s, share of its bound, the floor of three launches per
     block and a bf16 cuDNN yardstick; at the BO's batches the same
     yardstick eager, each launch's plan (N tile, K splits, blocks) and the
     microseconds each of a block's three launches adds, and at B = 1, 3
     and 8 (split-K plans) two eager calls and a CUDA graph replay of every
     chain held bitwise equal; the f32 instance per stage at B2_F32_TIMED
     as CUDA graph replays and at B=256 eagerly: ms, TFLOP/s, share of the
     f32 bound (H100_F32_FLOPS), the cuDNN f32 yardstick (TF32 off), each
     launch's plan and microseconds, and every f32 chain whose plan splits
     K held bitwise equal (eager, eager, replay); and (last of all, [B2
     graphs]) with the kernel as CUDA graph replays; the built library's
     SASS must hold HGMMA (wgmma) instructions, and its b2_conv_f32
     instances FFMAs and no tensor-core instruction (no TF32);
  5. the random-window path: Felzenszwalb -> predict_one ->
     random_window_saliency (1024 masks) -> localization_score, with the
     launch counters reset just before and read just after (B1 once a
     chunk, B2 4 and E1 13 a forward, P1 none), then
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
     the device's busy share of one replay and B2's ms and share of it, the
     GP step per iteration;
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
     version at B=256, timed eagerly against bf16 cuDNN and the chain bound,
     and at B=1 (split-K plans), timed as CUDA graph replays against bf16
     cuDNN's, and a 22-block chain at C=1024, P=512 block by block;
 19. [sweep] (run before [B2 graphs]): the val-set sweep on 8 synthetic
     images at ResNet-101 bf16, every lane with its launches held: the
     flushes' batched predicts at B = 4 and 12 through B2 against the plain
     path (within 0.05 x max |logit|, as in [main]); streaming windows (1024 masks; each row against the per-image path on
     the same host-sampled starts: target, segments, survival and heatmap
     exact), the same streaming sweep under
     torch.cuda.set_sync_debug_mode("error") from each image's segmentation
     to the end of its dispatch (nothing may raise; rows equal),
     image_batch=4 windows (bf16 agreement with streaming printed),
     knockouts streaming and at image_batch=4, a journal cut after 3 images
     and resumed (rows and heatmaps equal the uninterrupted run's), the
     device idle share of one streaming sweep and the share of its collects
     that found their image done (``ready``), then two Inception-v3 images
     at 299^2 streamed the same way (rows equal to the per-image path, no
     sync from segmentation to dispatch, idle and ready shares), f32 batched rows against
     streaming rows (exact), the BO sweep at image_batch=4 (agreement with
     single-image calls printed), RISE and input-gradient attribution
     sweeps, and the CLI's window, --bo and --attribute rise lanes (4
     images, their own engines);
 20. [B2 graphs], last: B2 and its bf16 cuDNN yardstick as CUDA graph
     replays at the BO's batches and at the attribution family's 41, 64,
     66 and 250 (each of these also checked block by block against the
     plain version at B2_TOL), with their ratio and the chain bound at each
     batch;
 21. [zoo] (run after [sweep]): every arch the JAX package explains beyond
     the ImageNet ResNets, at published width and depth with seeded random
     weights, each on its own bf16 engine (its eval-mode module, no B2):
     the MNIST CNN (28x28x1), the CIFAR ResNet-56 and DenseNet-BC-100 k=12
     (cifar10+, 32x32), VGG-16-BN, AlexNet, SqueezeNet 1.1, DenseNet-121,
     DenseNet-201, GoogLeNet, MobileNetV2, ShuffleNetV2 x1.0, MNASNet 1.0
     (224x224) and Inception-v3 (299x299). Per arch: the engine's bf16 plan against the
     plain module in f32 on 32 window-masked images (ZOO_TOL of max |logit|)
     and the f32 module on the card against the CPU on 8 (ZOO_F32_TOL);
     B1 bit for bit against its plain version at each of the window path's
     chunks, on the arch's own segments and starts; 1,024 window masks (B1
     4, B2 0) and 1,024 knockouts at M=1 (B1 0, B2 0), with their evals/s
     (median, fastest and slowest of 5-100 warm calls); then [zoo grad]:
     the f32 input gradient of DenseNet-201, DenseNet-121, DenseNet-BC-100
     and ResNet-56 (ZOO_GRAD) on the card and on the CPU against the CPU's
     float64, on ZOO_GRAD_BATCH noisy copies of the arch's synthetic image,
     of the logits weighted by a seeded random matrix, BatchNorm on the
     batch's statistics (the card's relative L2 error at most ZOO_GRAD_RATIO
     times the CPU's f32 one, or ZOO_F32_TOL): their backwards run through
     the library's channels_last average pools (DenseNet's transitions and
     head, the CIFAR ResNet's shortcuts and head);
 22. [bo zoo]: bo_window_saliency at DenseNet-121 224 bf16 from an empty
     runner cache: the first call eager (B1 11, B2 0), the second captures
     and replays (B1 11, B2 0), the third only replays (B1 0, B2 0); the
     replays equal the eager run;
 23. [gen mnist], [gen cifar]: the two generators' gp-data compute (1,000
     knockouts, M = 1 and 5; B1 0, B2 0) on their own engines, from a
     weights artifact the port wrote (read back bit for bit), with their
     result JSON;
 24. [serve] (run before [B2 graphs]): the serving stack. The main engine
     (ResNet-101 224 bf16) exported with window buckets 1024, 256 and 32,
     knockout_m 5, the attribution methods gradient, integrated, gradcam,
     occlusion, rise and xrai (image batch 4) and a BO artifact (candidate
     buckets 32 and 64, image batch 4) in one directory, its weights read
     back bit for bit; a ResNet-50 f32 artifact at bucket 32 beside it. Both
     behind one make_http_server registry on 127.0.0.1 port 0, warmed up
     (kernel builds, every BO shape captured), every endpoint driven through
     SaliencyClient with its launches held: /eval_windows on 1,000 starts
     (B1 1, B2 4; equal to the server's own call, its logits within
     SERVE_LOGIT_TOL x max |logit| of the engine's plan in chunks of 256;
     every B1 launch of these checks, bf16 K = 1,024, 256 and 32 and f32
     K = 32, kept as served and held bit for bit against its plain version
     in bf16 and f32), window /explain
     (B1 2, B2 8) and knockout /explain (0 / 4) and /eval_knockouts (0 / 4)
     equal to the in-process path, BO /explain (a replay, 0 / 0; equal to
     bo_window_saliency) and /explain_batch N=4 (0 / 0; equal to
     explain_many, scores held against the engine's at the same starts)
     with B1 and B2 in each replay's profiler trace, /attribute for each
     method (occlusion 0 / 16 and rise 0 / 32 exactly equal to the library
     call on the engine, the others within ATTR_B2_TOL) and
     /attribute_batch (0 / 0; equal to attribute_many; each bf16 row equal
     to its image's batch of 4 repeats, within SERVE_BF16_ATTR_TOL of the
     batch-1 map, and at least SERVE_BF16_ATTR_RHO in Spearman |rank| to it
     and to the f32 map); the f32 artifact's labels and heatmaps
     exactly the library engine's (B1 3, B2 12) and its /attribute_batch
     within SERVE_F32_ATTR_TOL of per-image maps; p50 per endpoint as the
     client's, the service call's on the same body without HTTP and the
     device call's; three device calls from a fresh thread per call
     against the device thread; /metrics p50 and device_call_ms, and peak
     memory at bucket 1024; 8 concurrent clients on a cold
     dynamic-batch server (captures while serving), every response its
     serial one; cli.export_serving --bo and cli.serve as subprocesses on
     the MNIST CNN: one query, SIGTERM, exit 0;
 25. [train] (run after [serve]): training on the card. One ResNet-50
     224 step (stock SGD, B=8) from the same parameters in f32 on the card,
     f32 on the CPU and f64 on the card: both f32 losses within
     TRAIN_LOSS_TOL of the f64 one, the card's update (all tensors as one
     vector) no further from the f64 update in relative L2 than
     TRAIN_UPDATE_TOL x the CPU's, its running statistics within
     TRAIN_STATS_TOL; resume under torch.use_deterministic_algorithms
     (ResNet-50 224 B=16, 4 steps, a save every 2): two uninterrupted runs
     and one cut after 3 steps and resumed from its save, every parameter,
     statistic and slot bit for bit equal; cli.main -a resnet50
     --synthetic --limit-images 2048 -b 256 --epochs 2 (16 steps and
     validation, B1 0, B2 0) with its meter's per-step times, images/s and
     peak memory, and the same 16 steps through Trainer.train_epoch under
     the profiler for the device's idle share; the handoff: the run's
     model_best through --ckpt into a bf16 engine, predict and 1,024 window
     masks (B1 1, B2 8), B1 bit-exact on the handoff's masks and B2 block by
     block within B2_TOL on the trained folded weights at B = 1,024 and 1,
     window evals/s against a random-weight ResNet-50 engine; the MNIST
     train-nn -> gp-data chain (1,000 knockouts, B1 0, B2 0; then 1,000
     window masks on the trained CNN at 28x28x1, B1 1) and CIFAR train -d 110
     --death-mode linear -> gp-data (B1 0, B2 0);
 26. [parallel] (run after [train]): multi-GPU explanation on
     torch.distributed, its ranks spawned as processes of this script
     (``--parallel-worker``), each printing its B1/B2 launches. A world of 1
     on NCCL: the four sharded evals (1,024 windows and 1,024 knockouts on
     one image, the 8 x 128 window and knockout grids; ResNet-101 224 bf16,
     one forward each) against the engine's unsharded path (survive
     agreement >= PARALLEL_AGREE, prob_target within PARALLEL_PROB_TOL), 256
     windows at ResNet-50 f32 (labels equal, prob_target within
     PARALLEL_F32_TOL), and evals/s of the sharded call against
     eval_window_masks at mask_batch 1,024 and 256 (the collective's cost).
     Two ranks on gloo sharing the card: cli.saliency_sweep --multihost on 8
     synthetic images x 1,024 masks (rows, heatmaps and their boxes equal to
     the single-process sweep's, run here first), --data-parallel with the
     GP-surrogate pass (each image's masks 512 / 512; survival within
     1 - PARALLEL_AGREE of the single-process rows, the mesh's GP fits
     against unsharded fits of the same heatmaps within GP_TOL), --bo
     --data-parallel at --image-batch 4, and through the API the BO loop
     with its images and with its proposals (q = 2) sharded (every score
     against the engine's on the same start within BO_SCORE_TOL), an input
     gradient (SERVE_BF16_ATTR_TOL, SERVE_BF16_ATTR_RHO) and RISE
     (ATTR_B2_TOL) against the unsharded calls; merged evals/s and each
     rank's p50. Every rank's launches sum under the path "parallel".
 27. [parallel train] (run after [parallel]): multi-GPU training, its ranks
     ``--parallel-worker --task train`` processes. A world of 1 on NCCL:
     from one state, step 1 of ResNet-50 224 f32 (TF32 off) at
     B=PTRAIN_BATCH meshless, on the mesh (every collective runs: the
     BatchNorm all-reduces and the flat gradient all-reduce) and meshless
     in f64: the mesh step's loss within TRAIN_LOSS_TOL of the f64 step's,
     its update no further from the f64 update than TRAIN_UPDATE_TOL x the
     meshless step's (relative L2, all tensors), its running statistics
     within TRAIN_STATS_TOL; then PTRAIN_STEPS steps each f32 way for ms
     per step. Two
     gloo ranks sharing the card: cli.main PTRAIN_ARGV --multihost against
     the same argv in this process first, both under deterministic
     algorithms: per-epoch losses within
     PTRAIN_LOSS_RTOL, val_err1 within one image, rank 0 alone writing the
     scores, result and checkpoints, each rank's ms per step and the merged
     images/s; the two-rank model_best in a bf16 engine on both ranks,
     1,024 windows through sharded_window_eval against the unsharded engine
     (PARALLEL_AGREE, PARALLEL_PROB_TOL; B1 bit-exact on the rank's masks,
     B2 block by block within B2_TOL at B = 512 and 1; on rank 0, an f32
     engine of the same model_best holds B2's f32 instance block by block
     within B2_F32_TOL at B = 512 and 1); a run cut mid-epoch
     and resumed on both ranks under torch.use_deterministic_algorithms
     (global B=PTRAIN_RESUME_BATCH, 4 steps, a save every 2) equal to the
     uninterrupted one bit for bit; and one step on the data axis (mesh
     (2, 1), each rank half the rows) and one on the model axis (mesh
     (1, 2)), at B=PTRAIN_TP_BATCH, each held to the f64 step as the
     world-1 step is, with each rank's parameter and slot bytes. Every
     rank's handoff launches sum under the path "parallel train".
 28. [pool] (run after [zoo]): P1 pool_nhwc, Inception-v3's 13 pools a
     forward (models/inception.py:POOLS), against its plain version (the
     library's F.avg_pool2d / F.max_pool2d) at each of their 10 shapes, at
     B = 1 and 256 in bf16 and f32: max bit-exact, average within 1 ulp of
     the output type (the share of elements that differ printed), and at
     B = 1 an input autograd records: the kernel's forward and backward (two
     launches), its gradient held the same way to the library's NCHW
     backward (its channels_last avg_pool2d backward is wrong on torch
     2.11.0+cu128); the SASS
     of its eight instances holds 16-byte global loads and stores only; an
     NCHW input raises and launches nothing; each shape at B=256 timed
     (device time) beside its bytes bound, the plain version (CUDA events)
     and the library's kernel (device time), and the 13 pools of a forward
     of 256 summed in bf16, at most POOL_FORWARD_MS; one forward of
     Inception-v3's bf16 module plan at 299^2 launches it 13 times, its
     plan.forward span reads pool_launches 13, and its logits equal the
     same plan's on the library's pools; that forward at B=256 timed with
     the kernel and with the library's pools (CUDA events). [zoo]'s
     Inception-v3 paths count 13 launches a forward through counted(),
     every other path 0.
 29. [epilogue] (run after [pool]): E1 epilogue_nhwc, the bias, residual
     and ReLU after each eager convolution of the folded ResNet plan,
     against its plain twin at every epilogue shape of ResNeXt-101 32x8d
     and ResNet-101 (as one B=1 forward of each through the plain twin
     records them), at B = 1 and 256 in bf16 and f32: equal to the bit; the SASS of its four
     instances holds 16-byte global loads and stores only; an NCHW input
     raises and launches nothing; each shape at B=256 in bf16 timed (device
     time) beside its bytes bound, the plain twin (CUDA events) and the
     library's sequence the plan ran before (the broadcast bias add_, ReLU,
     the residual add; CUDA events), and the 100 epilogues of a ResNeXt-101
     forward of 256 and the 13 of a ResNet-101 one summed, at least
     EPILOGUE_BOUND_SHARE of their bound; one bf16 ResNeXt-101 forward of
     256 launches E1 100 times, its plan.forward span reads epilogues 100,
     its logits equal those of plain=True (the plain twin; cuDNN's
     convolutions alike), and it takes at most EPILOGUE_FORWARD_MS (CUDA
     events, beside plain=True's); a ResNet-101 forward's span reads 13.
     ``--b1`` runs 1., 2. and 3. alone and then [B1 zoo]: Inception-v3's
     1,024 window masks and knockouts (evals/s as [zoo]) and B1's device
     time in one 1,024-mask window call.
     ``--ptrain-witness`` runs PTRAIN_ARGV in this process at lr 0.01 and
     0.001 from the seeded init, from it written as a weights artifact,
     and from two copies with every weight moved one ulp (random signs,
     through --pretrained), and prints how far the histories part: the
     spread of two f32 runs that PTRAIN_LOSS_RTOL must cover.

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
H100_F32_FLOPS = 67e12       # float32 on the CUDA cores, outside the tensor cores, SXM (data sheet)
H100_BYTES_PER_S = 3.35e12   # HBM3 (NVIDIA data sheet)
STAGES_101 = ((56, 256, 64, 2), (28, 512, 128, 3), (14, 1024, 256, 22), (7, 2048, 512, 2))
SWEEP_BATCH = 4              # the [sweep] phase's image_batch for the flushed lanes
CLI_MASKS = 100              # the CLIs' default --num_mask_samples: one chunk of 100
# B2's block-by-block batches: the BO loops', 32, the main path's chunk, and
# every batch the sweep's lanes give it (a flush's predict and BO iteration
# at SWEEP_BATCH, its BO pre-samples at 3 * SWEEP_BATCH, the CLIs' chunk).
B2_BATCHES = (1, 2, 3, SWEEP_BATCH, 6, 8, 3 * SWEEP_BATCH, 24, 32, CLI_MASKS, MASK_BATCH,
              512,           # [parallel]: a rank's half of 1,024 masks
              1024)          # [serve]'s /eval_windows bucket
# ([parallel]'s BO: a rank's 2 images of a flush of 4 give 2 x 3 pre-samples
# and 2 x 1 per iteration; its proposals, q = 2 over 2 ranks, 1 and 3 -> 4 / 2.)
# The f32 sweep lane's: predicts at 1 and 2, its chunk; [serve]'s f32 artifact's bucket, 32;
# the f32 BO loops' (--dtype float32): 1 and 3, and 8 and 24 at N=8.
B2_F32_BATCHES = (1, 2, 3, 8, 24, 32, MASK_BATCH)
# [B2]'s f32 timings: per stage as CUDA graph replays at the BO's batches and
# [serve]'s f32 bucket, eagerly at MASK_BATCH.
B2_F32_TIMED = (1, 3, 8, 24, 32)
B2_TOL = 2e-2                # bf16: rtol = atol; one bf16 ulp is 2^-8 relative
B2_F32_TOL = 1e-4            # f32 instance: summation order only
BO_IMAGES = 8                # bo_window_saliency_multi's N
BO_BATCHES = (1, 3, 8, 24)   # the BO loops' forwards: single image, and N=8 images
BO_REPEAT_BATCHES = (1, 3, 8)   # [B2]: eager, eager and replay held bitwise equal (split plans)
BO_SCORE_TOL = 0.05          # a BO score vs the engine's at another batch (bf16 rounding)
MULTI_K = 128                # masks per image of the N=8 multi-image window grid
# Wide-ResNet-50-2's chains (H, C, P, blocks): C = 2P, P = 2 * planes.
WIDE_STAGES_50 = ((56, 256, 128, 2), (28, 512, 256, 3), (14, 1024, 512, 5), (7, 2048, 1024, 2))
SWEEP_IMAGES = 8             # the [sweep] phase's synthetic images
# GP card vs CPU on this script's inputs. Errors read on an H100 with full
# f32 products: Kronecker 3.1e-5, -ELBO 1.5e-4, p(y=1) 5.9e-4; with the
# variational fit's backward left to TF32, p(y=1) 1.6e-3 and -ELBO 2.1e-4.
SERVE_BUCKETS = (1024, 256, 32)   # [serve]: the engine artifact's window buckets (defaults)
SERVE_KNOCKOUT_M = 5
SERVE_ATTR = ("gradient", "integrated", "gradcam", "occlusion", "rise", "xrai")
SERVE_ATTR_B2 = {"occlusion": 16, "rise": 32}   # B2 launches per served call (4 per forward)
SERVE_N = 4                  # the attribution and BO artifacts' image batch
SERVE_BO_BUCKETS = (32, 64)
SERVE_F32_BUCKET = 32        # the f32 ResNet-50 artifact's one bucket
SERVE_EVAL_K = 1000          # /eval_windows starts: one call at bucket 1024
SERVE_B1_KS = (32, 1024)     # the served B1 launches' K beyond the engine's chunk of 256
SERVE_LOGIT_TOL = 1e-5       # bucket-1024 logits vs chunks of 256: x max |logit| (reads 7.3e-7)
SERVE_REQS = 20              # warm requests per endpoint for a p50
SERVE_CLIENTS = 8
SERVE_F32_ATTR_TOL = 1e-3    # an f32 gradient map at batch 4 vs batch 1: x max |map|
SERVE_BF16_ATTR_TOL = 0.25   # a bf16 gradient map at batch 4 vs batch 1: x max |map| (reads 0.14-0.16)
SERVE_BF16_ATTR_RHO = 0.9    # its Spearman |rank| with batch 1 (reads 0.962) and f32 (0.921)
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
# B1 into out= slices big[j:j+K], j = 0..B1_SLICE_OFFSETS - 1: every residue
# of a row's address mod 16 bytes (8 in bf16, 4 in f32).
B1_SLICE_OFFSETS = 8
B1_SLICE_KS = (1, 3, 7, MASK_BATCH, 1000, 1024)
# [zoo]: (arch, dataset, create_model kwargs) at published width and depth.
ZOO = (("mnist_cnn", "mnist", {}), ("resnet", "cifar10+", {"depth": 56}),
       ("densenet", "cifar10+", {"depth": 100}), ("vgg16_bn", "imagenet", {}),
       ("alexnet", "imagenet", {}), ("squeezenet1_1", "imagenet", {}),
       ("densenet121", "imagenet", {}), ("densenet201", "imagenet", {}),
       ("googlenet", "imagenet", {}),
       ("mobilenet_v2", "imagenet", {}), ("shufflenet_v2_x1_0", "imagenet", {}),
       ("mnasnet1_0", "imagenet", {}), ("inception_v3", "imagenet", {}))
ZOO_TOL = 0.05               # a bf16 plan vs the plain f32 module: x max |logit|, as [main]
ZOO_F32_TOL = 1e-4           # the f32 module, card vs CPU: x max |logit|, as [main]'s f32 engine
# [zoo grad]: the nets whose input gradient runs through the library's average pools.
ZOO_GRAD = (("densenet201", "imagenet", {}), ("densenet121", "imagenet", {}),
            ("densenet", "cifar10+", {"depth": 100}), ("resnet", "cifar10+", {"depth": 56}))
ZOO_GRAD_BATCH = 4
ZOO_GRAD_RATIO = 10.0        # [zoo grad]: the card's f32 error over the CPU's, both against float64
PKG = "network_interpretation_imagenet_tpu_torch"
POOL_FORWARD_MS = 2.5        # [pool]: the 13 pools of a forward of 256, bf16 (library's: ~16.7)
EPILOGUE_FORWARD_MS = 36.0   # [epilogue]: a ResNeXt-101 forward of 256, bf16 (59.5 before E1)
EPILOGUE_BOUND_SHARE = 0.8   # [epilogue]: the bytes bound over E1's time, that forward's 100
E1_PER_DENSE_FORWARD = 13    # E1 a forward of a dense Bottleneck ResNet: the stem, 3 x 4 stage heads
PARALLEL_IMAGES = 8          # [parallel]: synthetic images of the sweeps, and the multi grid's N
PARALLEL_MULTI_K = 128
PARALLEL_F32_K = 256         # the f32 check's windows: one forward of the f32 sweep's chunk
PARALLEL_AGREE = 0.99        # bf16: survive agreement, sharded (one forward) vs the engine's chunks
PARALLEL_PROB_TOL = 2e-2     # bf16: prob_target, sharded vs the engine's
PARALLEL_F32_TOL = 1e-5      # f32: prob_target, sharded vs the engine's


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


def kernel_ms(fn, reps, prefix, tries=3):
    """Mean device milliseconds of the kernels whose symbol starts with
    ``prefix``, over the last ``reps`` of ``2 * reps`` warm calls under
    torch.profiler. A trace may lose the kernels launched while its tracing
    starts (a kernel of a few microseconds: 4 of 21 seen lost on the H100),
    so the first ``reps`` calls are a lead-in, and a trace that still holds
    fewer than ``reps`` is taken again, ``tries`` times in all. For a kernel
    shorter than its wrapper's host cost, back-to-back CUDA-event timing
    measures the host instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2 * reps):
                fn()
            torch.cuda.synchronize()
        launches = sorted((e for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           and prefix in e.name),
                          key=lambda e: e.time_range.start)
        if len(launches) >= reps:
            return sum(e.device_time for e in launches[-reps:]) / reps / 1e3
        seen.append(len(launches))
    raise AssertionError(f"profiler saw {seen} {prefix} kernels in {tries} traces of "
                         f"{2 * reps} calls each")


def conv_us(x, ws):
    """Median device microseconds that each of a block's three B2 launches
    (1x1 reduce, 3x3, 1x1 expand) adds to the chain, from the second of two
    chain calls under torch.profiler (a trace may lose its first kernel): a
    launch's end minus the later of its start and the previous launch's end.
    (A launch may start before the previous one ends, its blocks prefetching
    weights and then waiting; its own span would count that wait twice.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import bottleneck_chain

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            bottleneck_chain(x, ws)
        torch.cuda.synchronize()
    launches = sorted(((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and "b2_conv" in e.name))
    added = [end - max(start, prev_end) for (start, end), (_, prev_end)
             in zip(launches[1:], launches)]
    times = added[-3 * (len(ws) // 6):]  # 3 per block
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


def b2_costs(h, c, p, n, batch, f32=False):
    """(operations, bytes, floor ms) of one chain call in bf16 (``f32``:
    the f32 instance, 4-byte activations and weights, the CUDA cores' rate).
    The bytes count x read and y written once, and the weights and biases
    once per block (the chain bound). The floor charges each of a block's
    three convolutions max(operations / peak, its own bytes / bandwidth):
    the least time of a design that keeps three launches per block, with t1
    and t2 in device memory."""
    m = batch * h * h
    e, rate = (4, H100_F32_FLOPS) if f32 else (2, H100_BF16_FLOPS)
    flops = (4 * c * p + 18 * p * p) * m * n   # reduce 2mcp + 3x3 18mp^2 + expand 2mpc
    nbytes = 2 * m * c * e + n * ((2 * c * p + 9 * p * p) * e + (2 * p + c) * 4)
    convs = ((2 * m * c * p, (m * c + m * p + c * p) * e + 4 * p),                # 1x1 reduce
             (18 * m * p * p, (2 * m * p + 9 * p * p) * e + 4 * p),                # 3x3
             (2 * m * p * c, (m * p + 2 * m * c + p * c) * e + 4 * c))             # 1x1 expand
    floor = n * sum(max(f / rate, b / H100_BYTES_PER_S) for f, b in convs) * 1e3
    return flops, nbytes, floor


def chain_bound(flops, nbytes, f32=False):
    """The chain bound in ms: the larger of the operations over the card's
    peak (bf16 tensor cores, or f32 on the CUDA cores) and the bytes over
    HBM's rate."""
    return max(flops / (H100_F32_FLOPS if f32 else H100_BF16_FLOPS),
               nbytes / H100_BYTES_PER_S) * 1e3


def sass_text(so_path):
    """A built library's SASS, from the CUDA toolkit's cuobjdump or the copy
    Triton ships."""
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
    return subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout


def sass_hgmma(so_path):
    """Counts the HGMMA (wgmma) instructions in a built library's SASS."""
    return sum("HGMMA" in line for line in sass_text(so_path).splitlines())


def sass_b1_stores(so_path):
    """{kernel symbol: [128-bit global stores, narrower global stores]} for
    every b1_masked_batch instance in a built library's SASS."""
    counts, fn = {}, None
    for line in sass_text(so_path).splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if "b1_masked_batch" in fn:
                counts[fn] = [0, 0]
        elif fn in counts:
            op = next((t for t in line.split() if t.startswith("STG")), None)
            if op is not None:
                counts[fn][0 if op.split(".")[-1] == "128" else 1] += 1
    return counts


def sass_f32_ops(so_path):
    """{kernel symbol: {"FFMA": n, "LDS.128": n, "MMA": n}} for every
    b2_conv_f32 instance in a built library's SASS: its FMAs, its 16-byte
    shared loads, and any tensor-core instruction (HMMA, HGMMA: TF32 in any
    form would be one)."""
    counts, fn = {}, None
    for line in sass_text(so_path).splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if "b2_conv_f32" in fn:
                counts[fn] = {"FFMA": 0, "LDS.128": 0, "MMA": 0}
        elif fn in counts:
            op = next((t for t in line.split() if t.isupper() and t[:1].isalpha()
                       and not t.startswith("R")), "")
            if op == "FFMA":
                counts[fn]["FFMA"] += 1
            elif op.startswith("LDS") and op.endswith(".128"):
                counts[fn]["LDS.128"] += 1
            elif op.split(".")[0].endswith("MMA"):   # HMMA, HGMMA, IMMA, ...
                counts[fn]["MMA"] += 1
    return counts


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


def plan_str(batch, h, c, p, dtype=None):
    """A block's three launch plans, reduce / 3x3 / expand, each as its N
    tile x K splits on its grid of blocks (``dtype``: the instance's, bf16
    by default)."""
    import torch

    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import chain_plan

    plans = chain_plan(batch, h, h, c, p, dtype=dtype or torch.bfloat16)
    return " / ".join(f"{cp.bn}x{cp.splits} on {cp.grid}" for cp in plans)


def b2_repeatable(x, ws):
    """Two eager calls and one CUDA graph replay of a chain must be bitwise
    equal: a split launch sums its K slices' partials in split order,
    whichever block arrives last, so no arrival order may show."""
    import torch

    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import bottleneck_chain

    a, b = bottleneck_chain(x, ws), bottleneck_chain(x, ws)
    captured = []
    graph = graphed(lambda: captured.append(bottleneck_chain(x, ws)))
    graph.replay()
    torch.cuda.synchronize()
    if not (torch.equal(a, b) and torch.equal(a, captured[-1])):
        raise AssertionError(f"B2 at B={x.shape[0]} H={x.shape[1]}: eager, eager and replayed "
                             "outputs differ")


def b2_phase(rng, smi):
    """4. B2 against its plain version at the four ResNet-101 stage shapes,
    every batch of B2_BATCHES (see the module docstring). Returns the totals
    per forward of MASK_BATCH and the (batch, x, ws) of the BO's batches."""
    import torch

    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import (
        bottleneck_chain,
        bottleneck_chain_plain,
    )

    dev = torch.device("cuda")
    small = {b: [0.0, 0.0, 0.0] for b in BO_BATCHES}  # B2 ms, chain bound, cuDNN per forward
    small_cases = []   # (batch, x, ws) of the BO's batches, for the graph yardstick at the end
    b2 = {"ms": 0.0, "plain_ms": 0.0, "cudnn_ms": 0.0, "floor_ms": 0.0, "flops": 0, "bytes": 0,
          "block_err": 0.0}
    for batch in B2_BATCHES:
        for h, c, p, n in STAGES_101:
            ws = b2_weights(rng, c, p, n, torch.bfloat16, dev)
            if batch > MASK_BATCH:   # host draws of this size would take seconds
                gen = torch.Generator(device=dev).manual_seed(batch * h)
                x = torch.randn((batch, h, h, c), generator=gen, device=dev).abs_().to(
                    torch.bfloat16)
            else:
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
                bound = chain_bound(flops, nbytes)
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
                bound = chain_bound(flops, nbytes)
                ms = time_ms(lambda: bottleneck_chain(x, ws), 20)
                cudnn_ms = time_ms(cudnn_chain(x, ws), 20)
                small[batch] = [v + d for v, d in zip(small[batch], (ms, bound, cudnn_ms))]
                small_cases.append((batch, x, ws))
                if batch in BO_REPEAT_BATCHES:
                    b2_repeatable(x, ws)
                    line += "; eager, eager and replay bitwise equal"
                us = conv_us(x, ws)
                line += (f"; kernel {ms:.4f} ms ({ms / (3 * n) * 1e3:.1f} us per launch), chain "
                         f"bound {bound:.4f} ms, yardstick bf16 cuDNN chain {cudnn_ms:.4f} ms; "
                         f"plan reduce / 3x3 / expand (N tile x splits on blocks) "
                         f"{plan_str(batch, h, c, p)}; per block reduce / 3x3 / expand "
                         + " / ".join(f"{u:.1f}" for u in us) + " us")
            log(line)
            del x, ws
    log(f"[B2] {smi}: total per forward of {MASK_BATCH}: kernel {b2['ms']:.4f} ms, yardstick "
        f"bf16 cuDNN {b2['cudnn_ms']:.4f} ms, 3-launch floor {b2['floor_ms']:.4f} ms; "
        + "; ".join(f"per forward of {b}: kernel {v[0]:.4f} ms, chain bound {v[1]:.4f} ms, "
                    f"yardstick bf16 cuDNN {v[2]:.4f} ms (eager)" for b, v in small.items()))
    b2["f32_block_err"], b2["f32"] = b2_f32_phase(rng, smi)
    torch.cuda.synchronize()
    return b2, small_cases


def b2_f32_phase(rng, smi):
    """4, B2's f32 instance: every ResNet-101 chain shape block by block
    within B2_F32_TOL at every batch of B2_F32_BATCHES (and at B=4 at two
    shapes); every chain whose plan splits K held bitwise equal over two
    eager calls and a graph replay; per stage at B2_F32_TIMED as CUDA graph
    replays, and at MASK_BATCH eagerly with the plain version's time: kernel
    ms, TFLOP/s, share of the f32 chain bound (67 TFLOP/s on the CUDA cores),
    the yardstick cuDNN f32 chain (TF32 off), each launch's plan and the
    microseconds each launch adds. Returns the worst block error and the
    timed records by shape."""
    import torch

    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import (
        bottleneck_chain,
        bottleneck_chain_plain,
        chain_plan,
    )

    dev = torch.device("cuda")
    cases = [(4, (h, c, p, 2)) for h, c, p, _ in (STAGES_101[0], STAGES_101[3])]
    cases += [(batch, stage) for batch in B2_F32_BATCHES for stage in STAGES_101]
    worst, records, per_batch = 0.0, [], {}
    for batch, (h, c, p, n) in cases:
        ws = b2_weights(rng, c, p, n, torch.float32, dev)
        x = torch.from_numpy(np.abs(rng.randn(batch, h, h, c)).astype(np.float32)).to(dev)
        block_err, outside, chain_err = check_chain(x, ws, B2_F32_TOL)
        worst = max(worst, block_err)
        line = (f"[B2] f32 B={batch} H={h} C={c} P={p} blocks={n}: worst block err "
                f"{block_err:.4g} (tol {B2_F32_TOL} x max|plain|; {outside} outside elementwise), "
                f"whole-chain err {chain_err:.4g}")
        if any(cp.splits > 1 for cp in chain_plan(batch, h, h, c, p, dtype=torch.float32)):
            b2_repeatable(x, ws)
            line += "; eager, eager and replay bitwise equal"
        if batch == MASK_BATCH or batch in B2_F32_TIMED:
            flops, nbytes, floor = b2_costs(h, c, p, n, batch, f32=True)
            bound = chain_bound(flops, nbytes, f32=True)
            rec = {"dtype": "float32", "batch": batch, "H": h, "C": c, "P": p, "blocks": n,
                   "bound_ms": bound, "bound_by": "operations" if flops / H100_F32_FLOPS
                   >= nbytes / H100_BYTES_PER_S else "bytes", "flops": flops, "bytes": nbytes}
            if batch == MASK_BATCH:
                rec.update(timing="eager", ms=time_ms(lambda: bottleneck_chain(x, ws), 5),
                           library_ms=time_ms(cudnn_chain(x, ws), 5),
                           plain_ms=time_ms(lambda: bottleneck_chain_plain(x, ws), 3))
            else:
                rec.update(timing="graph replay",
                           ms=time_ms(graphed(lambda: bottleneck_chain(x, ws)).replay, 20),
                           library_ms=time_ms(graphed(cudnn_chain(x, ws)).replay, 20))
            records.append(rec)
            total = per_batch.setdefault(batch, {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                                                 "flops": 0, "timing": rec["timing"]})
            for key in ("ms", "library_ms", "bound_ms", "flops"):
                total[key] += rec[key]
            ms = rec["ms"]
            line += (f"; {rec['timing']}: kernel {ms:.4f} ms, {flops / ms / 1e9:.2f} TFLOP/s, "
                     f"{bound / ms:.3f} of the f32 chain bound {bound:.4f} ms ({flops:.4g} flop, "
                     f"{nbytes} bytes), 3-launch floor {floor:.4f} ms; yardstick cuDNN f32 chain "
                     f"{rec['library_ms']:.4f} ms"
                     + (f"; plain {rec['plain_ms']:.4f} ms" if "plain_ms" in rec else "")
                     + f"; plan reduce / 3x3 / expand (N tile x splits on blocks) "
                     f"{plan_str(batch, h, c, p, torch.float32)}; per block reduce / 3x3 / "
                     "expand " + " / ".join(f"{u:.1f}" for u in conv_us(x, ws)) + " us")
        log(line)
        del x, ws
    log(f"[B2] f32 {smi}: per ResNet-101 forward (4 chains): "
        + "; ".join(f"B={b} ({v['timing']}): kernel {v['ms']:.4f} ms, "
                    f"{v['flops'] / v['ms'] / 1e9:.2f} TFLOP/s, {v['bound_ms'] / v['ms']:.3f} of "
                    f"the f32 bound {v['bound_ms']:.4f} ms, cuDNN f32 {v['library_ms']:.4f} ms "
                    f"(kernel / cuDNN {v['ms'] / v['library_ms']:.3f})"
                    for b, v in per_batch.items()))
    return worst, records


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


def union_ms(spans):
    """Milliseconds covered by the union of (start, end) intervals in
    microseconds. A B2 launch's interval starts early and overlaps the
    previous B2 launch's (programmatic dependent launch), so a sum of
    kernel durations would count its wait twice."""
    union, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > reach:
            union += b - max(a, reach)
            reach = b
    return union / 1e3


def kernel_group(name):
    """B1, B2 or "other". The kernels' symbols carry their id as a prefix
    (b2_conv_wgmma, b2_conv_f32, b1_masked_batch), so a rename inside a
    family cannot move them into "other"."""
    return ("B2 bottleneck_chain" if "b2_conv" in name else
            "B1 masked_batch" if "b1_masked_batch" in name else "other")


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
    return wall * 1e3, union_ms((e.time_range.start, e.time_range.end) for e in prof.events()
                                if e.device_type == torch.autograd.DeviceType.CUDA)


def device_breakdown(fn):
    """Runs ``fn`` once under torch.profiler; returns (wall s, device ms by
    group, the six largest "other" kernels) with groups B1, B2 and everything
    else (cuDNN, elementwise, copies): each group the union of its device-side
    intervals (union_ms), each "other" kernel the sum of its durations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = {"B2 bottleneck_chain": [], "B1 masked_batch": [], "other": []}
    others = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host ops: their kernels appear as device events of their own
        group = kernel_group(e.name)
        spans[group].append((e.time_range.start, e.time_range.end))
        if group == "other":
            others[e.name[:60]] = others.get(e.name[:60], 0.0) + e.device_time / 1e3
    groups = {group: union_ms(s) for group, s in spans.items()}
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


def replay_trace(graph, tries=3):
    """One replay of a captured CUDA graph under torch.profiler. Returns
    (wall ms from replay() to the end of the device sync, the trace's device
    span from the first interval's start to the last one's end, ms covered by
    the union of its device intervals, device ms by group), all from this one
    profiled call. The busy share is union / span: the wall also holds the
    profiler's own start and stop. A trace may lose the kernels launched while
    its tracing starts (see kernel_ms), so a replay whose trace lacks B1 or B2
    is traced again, ``tries`` times in all; raises if none holds both."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            graph.replay()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_group = {"B2 bottleneck_chain": [], "B1 masked_batch": [], "other": []}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_group[kernel_group(e.name)].append((e.time_range.start, e.time_range.end))
        groups = {group: union_ms(s) for group, s in by_group.items()}
        if groups["B2 bottleneck_chain"] > 0 and groups["B1 masked_batch"] > 0:
            break
    else:
        raise AssertionError(f"graph replay trace: no B1 or no B2 kernel in {tries} traces: "
                             f"{groups}")
    spans = [ab for s in by_group.values() for ab in s]
    span = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3
    return wall * 1e3, span, union_ms(spans), groups


def counted(by_path, path, fn, want_b1, want_b2, want_p1=0, want_e1=None):
    """Runs ``fn`` with the kernels' launch counters set to 0 just before and
    read just after; records them under ``path`` and raises unless they are
    B1 ``want_b1``, B2 ``want_b2``, P1 ``want_p1`` (13 a forward of
    Inception-v3, 0 on every other net) and E1 ``want_e1``: by default
    E1_PER_DENSE_FORWARD for each 4 B2 launches (a dense Bottleneck ResNet's
    forward runs a B2 chain in each of its 4 stages); a net without chains
    gives its own (ResNet-18 17 a forward, ResNeXt-50 49)."""
    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import bottleneck_chain
    from network_interpretation_imagenet_tpu_torch.ops.epilogue_nhwc import epilogue_nhwc
    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import masked_batch
    from network_interpretation_imagenet_tpu_torch.ops.pool_nhwc import pool_nhwc

    if want_e1 is None:
        if want_b2 % 4:
            raise ValueError(f"{path}: B2 {want_b2} is not 4 a forward; give want_e1")
        want_e1 = want_b2 // 4 * E1_PER_DENSE_FORWARD
    masked_batch.launches = 0
    bottleneck_chain.launches = 0
    pool_nhwc.launches = 0
    epilogue_nhwc.launches = 0
    result = fn()
    got = {"masked_batch": masked_batch.launches, "bottleneck_chain": bottleneck_chain.launches,
           "pool_nhwc": pool_nhwc.launches, "epilogue_nhwc": epilogue_nhwc.launches}
    if got != {"masked_batch": want_b1, "bottleneck_chain": want_b2, "pool_nhwc": want_p1,
               "epilogue_nhwc": want_e1}:
        raise AssertionError(f"{path}: launched {got}, want B1 {want_b1}, B2 {want_b2}, "
                             f"P1 {want_p1} and E1 {want_e1}")
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
        f"of its intervals), busy share {union / span:.4f} (profiled wall {wall:.3f} ms), B2 "
        f"{groups['B2 bottleneck_chain']:.3f} ms of it ({n_fwd} forwards), share of the span "
        f"{groups['B2 bottleneck_chain'] / span:.4f}; GP "
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
                                  lambda: quiet(lambda: gen.compute(args)), 1, 0,
                                  want_e1=3 * 17)   # predict, one chunk, the threshold search
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

    from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine

    x = masked_images(normalized, segments, firsts, width)
    chunks = NUM_SAMPLES // MASK_BATCH
    parts = []
    for arch, path, chains, e1 in (("wide_resnet50_2", "wide_resnet50_2_window", 4, 13),
                                   ("resnext50_32x4d", "resnext50_window", 0, 1 + 3 * 16)):
        bundle, sd, summary = folded_vs_plain(arch, x)
        engine = SaliencyEngine(bundle, sd, mask_batch=MASK_BATCH, device="cuda")
        target = engine.predict_one(normalized)[0]
        counted(by_path, path, lambda: engine.eval_window_masks(
            normalized, segments, firsts[:NUM_SAMPLES], width, target), chunks, chains * chunks,
            want_e1=e1 * chunks)
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

    wide_chains(smi)


def wide_chains(smi):
    """Wide-ResNet's chain shapes (C = 2P): Wide-ResNet-50-2's four block by
    block at B=256 (timed eagerly against bf16 cuDNN and the chain bound) and
    at B=1 (split plans; timed as CUDA graph replays, with each launch's
    plan), and Wide-ResNet-101-2's stage 3, 22 chained blocks at C=1024,
    P=512, block by block at B=4."""
    import torch

    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import bottleneck_chain

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 2)
    rng1 = np.random.RandomState(SEED + 3)   # the B=1 inputs: a stream of their own
    total = {"kernel": 0.0, "cudnn": 0.0, "bound": 0.0}
    small = {"kernel": 0.0, "cudnn": 0.0, "bound": 0.0}
    for h, c, p, n in WIDE_STAGES_50:
        ws = b2_weights(rng, c, p, n, torch.bfloat16, dev)
        xb = torch.from_numpy(np.abs(rng.randn(MASK_BATCH, h, h, c)).astype(np.float32)
                              ).to(dev, torch.bfloat16)
        block_err, outside, chain_err = check_chain(xb, ws, B2_TOL)
        flops, nbytes, floor = b2_costs(h, c, p, n, MASK_BATCH)
        bound = chain_bound(flops, nbytes)
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
        x1 = torch.from_numpy(np.abs(rng1.randn(1, h, h, c)).astype(np.float32)
                              ).to(dev, torch.bfloat16)
        block_err, outside, chain_err = check_chain(x1, ws, B2_TOL)
        flops, nbytes, _ = b2_costs(h, c, p, n, 1)
        bound = chain_bound(flops, nbytes)
        ms = time_ms(graphed(lambda: bottleneck_chain(x1, ws)).replay, 20)
        cudnn_ms = time_ms(graphed(cudnn_chain(x1, ws)).replay, 20)
        for key, v in (("kernel", ms), ("cudnn", cudnn_ms), ("bound", bound)):
            small[key] += v
        log(f"[resnext] Wide B2 B=1 H={h} C={c} P={p} blocks={n}: worst block err "
            f"{block_err:.4g} (tol {B2_TOL} x max|plain|; {outside} of {x1.numel() * n} outside "
            f"elementwise), whole-chain err {chain_err:.4g}; graph replays: kernel {ms:.4f} ms, "
            f"bf16 cuDNN chain {cudnn_ms:.4f} ms, chain bound {bound:.4f} ms; plan reduce / 3x3 "
            f"/ expand (N tile x splits on blocks) {plan_str(1, h, c, p)}")
        del xb, x1, ws
    # Wide-ResNet-101-2's stage 3: 22 chained blocks at C=1024, P=512.
    ws = b2_weights(rng, 1024, 512, 22, torch.bfloat16, dev)
    xb = torch.from_numpy(np.abs(rng.randn(4, 14, 14, 1024)).astype(np.float32)
                          ).to(dev, torch.bfloat16)
    block_err, _, chain_err = check_chain(xb, ws, B2_TOL)
    log(f"[resnext] {smi}: Wide-ResNet-50-2 chains per forward of {MASK_BATCH}: kernel "
        f"{total['kernel']:.4f} ms, yardstick bf16 cuDNN {total['cudnn']:.4f} ms, chain bound "
        f"{total['bound']:.4f} ms; per forward of 1 as graph replays: kernel "
        f"{small['kernel']:.4f} ms, bf16 cuDNN {small['cudnn']:.4f} ms, chain bound "
        f"{small['bound']:.4f} ms; Wide-ResNet-101-2 stage 3 (22 blocks) at B=4: worst block "
        f"err {block_err:.4g}, whole-chain err {chain_err:.4g}")
    del xb, ws
    # The f32 instance at Wide-ResNet-50-2's four chains, B=256.
    f32 = {"kernel": 0.0, "cudnn": 0.0, "bound": 0.0}
    for h, c, p, n in WIDE_STAGES_50:
        ws = b2_weights(rng, c, p, n, torch.float32, dev)
        x = torch.from_numpy(np.abs(rng.randn(MASK_BATCH, h, h, c)).astype(np.float32)).to(dev)
        block_err, outside, chain_err = check_chain(x, ws, B2_F32_TOL)
        flops, nbytes, _ = b2_costs(h, c, p, n, MASK_BATCH, f32=True)
        bound = chain_bound(flops, nbytes, f32=True)
        ms = time_ms(lambda: bottleneck_chain(x, ws), 3)
        cudnn_ms = time_ms(cudnn_chain(x, ws), 3)
        for key, v in (("kernel", ms), ("cudnn", cudnn_ms), ("bound", bound)):
            f32[key] += v
        log(f"[resnext] Wide B2 f32 B={MASK_BATCH} H={h} C={c} P={p} blocks={n}: worst block "
            f"err {block_err:.4g} (tol {B2_F32_TOL} x max|plain|; {outside} outside "
            f"elementwise), whole-chain err {chain_err:.4g}; kernel {ms:.4f} ms, "
            f"{flops / ms / 1e9:.2f} TFLOP/s, {bound / ms:.3f} of the f32 chain bound "
            f"{bound:.4f} ms; yardstick cuDNN f32 chain {cudnn_ms:.4f} ms")
        del x, ws
    log(f"[resnext] {smi}: Wide-ResNet-50-2 f32 chains per forward of {MASK_BATCH}: kernel "
        f"{f32['kernel']:.4f} ms, cuDNN f32 {f32['cudnn']:.4f} ms, f32 chain bound "
        f"{f32['bound']:.4f} ms ({f32['bound'] / f32['kernel']:.3f} of it)")
    torch.cuda.empty_cache()


def sync_free_sweep(engine, data, seg_cfg, **kw):
    """One streaming sweep with ``torch.cuda.set_sync_debug_mode("error")``
    on from each image's segmentation to the end of its dispatch, and off in
    the collect, which waits by design: a synchronising call there fails the
    image, and this raises with the error the sweep logged."""
    import io

    import torch

    from network_interpretation_imagenet_tpu_torch.saliency import sweep
    from network_interpretation_imagenet_tpu_torch.utils.logging import PhaseLogger

    segment, collect = sweep.segment_image, engine.collect

    def checked_segment(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        return segment(*args, **kwargs)

    def unchecked_collect(handle):
        torch.cuda.set_sync_debug_mode(0)
        return collect(handle)

    out = io.StringIO()
    sweep.segment_image, engine.collect = checked_segment, unchecked_collect
    try:
        res = sweep.saliency_sweep(engine, data, seg_cfg, logger=PhaseLogger(out), **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        sweep.segment_image, engine.collect = segment, collect
    if res.images_failed or res.images_explained != len(data):
        failed = [line for line in out.getvalue().splitlines() if "image_failed" in line]
        raise AssertionError(f"sweep under sync debug mode: {res.images_explained} of "
                             f"{len(data)} explained; {failed}")
    return res


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
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.segment.common import segment_image
    from network_interpretation_imagenet_tpu_torch.utils import logging as trace

    def ready_share():
        """The share of the traced sweep's collects whose image was done as
        the collect began (``sweep.collect``'s ``ready``)."""
        ready = [sp.attrs["ready"] for sp in trace.spans()
                 if sp.name == "sweep.collect" and sp.attrs and "ready" in sp.attrs]
        trace.clear()
        return (f"collects ready {np.mean(ready):.3f} of {len(ready)}" if ready
                else "no collect carried ready")

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

    def as_per_image(eng, images, res, name):
        """Each streaming row against the per-image path: the same
        host-sampled starts (RandomState(SEED + index)) through
        eval_window_masks; target, segments, survival and heatmap exact."""
        for row in res.per_image:
            i = row["index"]
            seg = segment_image(aggregate.normalize_to_uint8_np(images[i][0]), seg_cfg)
            s = int(seg.max()) + 1
            width = int(0.4 * s)
            first = masking.sample_window_starts_host(SEED + i, NUM_SAMPLES, s, width)
            target = eng.predict_one(images[i][0])[0]
            r = eng.eval_window_masks(images[i][0], seg, first, width, target)
            heat = aggregate.summed_superpixel_labels_np(seg, first, width, r.survived)
            if (row["target"], row["num_segments"], row["survival"]) != (
                    target, s, float(np.mean(r.survived))) or not np.array_equal(
                    heat, res.heatmaps[i]):
                raise AssertionError(f"{name}: image {i}'s row differs from the per-image path")

    stream = run("sweep_window_stream", lambda: sweep.saliency_sweep(engine, data, seg_cfg, **kw),
                 n * chunks, n * (1 + chunks) * 4)
    as_per_image(engine, data, stream, "sweep stream")
    checked = sync_free_sweep(engine, data, seg_cfg, **kw)
    if rows(checked) != rows(stream):
        raise AssertionError("sweep stream under the sync check: rows differ")
    lines.append(f"sync debug mode 'error' from each image's segmentation to the end of its "
                 f"dispatch: {n} images, nothing raised")
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
    trace.clear()
    wall, busy = busy_ms(lambda: sweep.saliency_sweep(engine, data, seg_cfg, **kw))
    lines.append(f"one streaming sweep under the profiler: wall {wall:.1f} ms, device busy "
                 f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}, {ready_share()}")

    # Inception-v3 at 299^2 (the module plan, no B2): two images streamed,
    # the stretch from segmentation to dispatch free of syncs, and each row
    # equal to the per-image path.
    inc = create_model("inception_v3", "imagenet", dtype=torch.bfloat16)
    e_inc = SaliencyEngine(inc, inc.init(SEED), mask_batch=MASK_BATCH, device="cuda")
    data_inc = []
    for i in range(2):
        u8, gt = synthetic_image(SEED + 30 + i, size=299)
        data_inc.append((normalize(torch.from_numpy(u8.astype(np.float32) / 255.0),
                                   IMAGENET_MEAN, IMAGENET_STD).numpy(), None, gt))
    inc_stream = sweep.saliency_sweep(e_inc, data_inc, seg_cfg, **kw)
    as_per_image(e_inc, data_inc, inc_stream, "sweep stream inception_v3")
    inc_checked = sync_free_sweep(e_inc, data_inc, seg_cfg, **kw)
    if rows(inc_checked) != rows(inc_stream) or any(
            not np.array_equal(inc_checked.heatmaps[i], inc_stream.heatmaps[i]) for i in range(2)):
        raise AssertionError("sweep stream inception_v3 under the sync check: rows differ")
    trace.clear()
    wall, busy = busy_ms(lambda: sweep.saliency_sweep(e_inc, data_inc, seg_cfg, **kw))
    lines.append(f"inception_v3 299^2, 2 images: rows equal the per-image path, no sync from "
                 f"segmentation to dispatch; under the profiler wall {wall:.1f} ms, busy "
                 f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}, {ready_share()}")
    del e_inc, inc, inc_stream, inc_checked
    torch.cuda.empty_cache()

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
        bound = chain_bound(flops, nbytes)
        per_batch[batch] = [v + d for v, d in zip(per_batch.get(batch, (0.0,) * 3),
                                                  (b2, cudnn, bound))]
    log(f"[B2 graphs] {smi}: per ResNet-101 forward (4 chains) as CUDA graph replays: "
        + "; ".join(f"B={b}: kernel {v[0]:.4f} ms, bf16 cuDNN {v[1]:.4f} ms (kernel / cuDNN "
                    f"{v[0] / v[1]:.3f}), chain bound {v[2]:.4f} ms" for b, v in per_batch.items()))


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
    device ms of all kernels), each the union of their intervals (union_ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return (union_ms((a, b) for a, b, name in spans if "b2_conv" in name),
            union_ms((a, b) for a, b, _ in spans))


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
        # B1: per image one window chunk and the BO host loop's 11 (ResNet-18: no B2);
        # E1: 17 in each of ResNet-18's 68 forwards.
        payload = counted(by_path, "cli_compare", lambda: quiet(lambda: compare.compute(args)),
                          24, 0, want_e1=68 * 17)
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
        payload = counted(by_path, "cli_sanity",   # E1: ResNet-18's prediction
                          lambda: quiet(lambda: attribution_sanity.compute(args)), 0, 0,
                          want_e1=17)
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


def b1_slices(image, seg, s, width, dt):
    """B1 into out= slices big[j:j+K] of one NaN-filled buffer, for j = 0 ..
    B1_SLICE_OFFSETS - 1 (every residue of the rows' addresses) and K in
    B1_SLICE_KS: each slice bit for bit against the plain version, the rest
    of the buffer untouched."""
    import torch

    from network_interpretation_imagenet_tpu_torch.ops import masking
    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import (
        masked_batch,
        masked_batch_plain,
    )

    big = torch.empty((B1_SLICE_OFFSETS - 1 + max(B1_SLICE_KS), *image.shape), dtype=dt,
                      device=image.device)
    for k in B1_SLICE_KS:
        firsts = torch.from_numpy(masking.sample_window_starts_host(SEED + k, k, s, width)).to(
            image.device)
        want = masked_batch_plain(image, seg, firsts, width, dt)
        for j in range(B1_SLICE_OFFSETS):
            big.fill_(float("nan"))
            masked_batch(image, seg, firsts, width, dt, out=big[j:j + k])
            if not (torch.equal(big[j:j + k], want) and torch.isnan(big[:j]).all()
                    and torch.isnan(big[j + k:]).all()):
                raise AssertionError(f"B1 {dt} {tuple(image.shape)} K={k}: the out= slice at "
                                     f"mask {j} differs from the plain version, or the buffer "
                                     "around it was written")
    del big


def b1_time(image, seg, firsts, width, dt, smi, label):
    """B1's device time, its plain version's time and its bytes bound on
    one input, logged; returns the record for the kernels line."""
    import torch

    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import (
        masked_batch,
        masked_batch_plain,
    )

    h, w, c = image.shape
    k = firsts.numel()
    ms = kernel_ms(lambda: masked_batch(image, seg, firsts, width, dt), 50, "b1_masked_batch")
    plain_ms = time_ms(lambda: masked_batch_plain(image, seg, firsts, width, dt), 20)
    nbytes = k * h * w * c * dt.itemsize + h * w * (c * 4 + 4) + k * 4
    bound = nbytes / H100_BYTES_PER_S * 1e3
    name = "bf16" if dt == torch.bfloat16 else "f32"
    log(f"[B1] {smi}: {h}x{w}x{c} {label}, K={k} {name}: kernel {ms:.5f} ms (device time), "
        f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({nbytes} bytes), {bound / ms:.3f} "
        "of bound")
    return {"shape": [h, w, c], "k": k, "dtype": name, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes"}


def b1_shapes(smi):
    """B1 at the new archs' image shapes (see the module docstring, 3): each
    against its plain version bit for bit, bf16 and f32, at K = 256 (the
    engine's chunk, which [zoo]'s window paths launch), 1,000 (the
    generators' default, not a multiple of any group) and 1,024, into out=
    slices at every residue, and from an image off 16-byte alignment;
    device time, plain time and the bytes bound at K = 1,024 bf16, and at
    299x299x3 (rows off alignment) at K = 256 and 1,024 in both dtypes.
    Returns one record per timing for the kernels line."""
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
        # The second image of a stacked pair: at 299x299x3 its base is 12
        # bytes past a 16-byte boundary, as images_t[1] of a multi-image call.
        pair = torch.stack([image, image])
        firsts = {k: torch.from_numpy(masking.sample_window_starts_host(SEED, k, s, width)).to(dev)
                  for k in B1_KS}
        for k in B1_KS:
            for dt in (torch.float32, torch.bfloat16):
                want = masked_batch_plain(image, seg, firsts[k], width, dt)
                if not (torch.equal(masked_batch(image, seg, firsts[k], width, dt), want)
                        and torch.equal(masked_batch(pair[1], seg, firsts[k], width, dt), want)):
                    raise AssertionError(f"B1 {dt} {h}x{w}x{c} K={k}: kernel differs from its "
                                         "plain version")
        for dt in (torch.float32, torch.bfloat16):
            b1_slices(image, seg, s, width, dt)
        log(f"[B1] {smi}: {h}x{w}x{c} S={s}, K = {' and '.join(map(str, B1_KS))}: bit-exact "
            f"bf16+f32, also from an image at {pair[1].data_ptr() % 16} bytes past a 16-byte "
            f"boundary; out= slices at masks 0-{B1_SLICE_OFFSETS - 1}, K = "
            f"{', '.join(map(str, B1_SLICE_KS))}: bit-exact, the buffer around untouched")
        timed = ([(k, dt) for k in (MASK_BATCH, 1024) for dt in (torch.bfloat16, torch.float32)]
                 if h * w * c % 8 else [(1024, torch.bfloat16)])
        records += [b1_time(image, seg, firsts[k], width, dt, smi, f"S={s}") for k, dt in timed]
        del image, seg, firsts, pair
        torch.cuda.empty_cache()
    return records


def b1_phase(rng, smi):
    """3.: B1 against its plain version at the main path's 224x224x3 (K =
    256, the BO loop's 1 and 3 with the width on the device, [serve]'s
    buckets, out= slices) and at b1_shapes'; then its timings, at 224x224x3
    K=256 in bf16 (the main path's) and in f32 at K = 256 and 32 ([serve]'s
    f32 artifact, the generators). Returns (ms, plain ms, bound ms) at
    224x224x3 K=256 bf16 and the records of every other timing."""
    import torch

    from network_interpretation_imagenet_tpu_torch.ops import masking
    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import (
        masked_batch,
        masked_batch_plain,
    )

    dev = torch.device("cuda")
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
        # [serve]'s buckets: K = 32 (target inference, the f32 artifact) and
        # 1,024 (/eval_windows), whose launch plans (groups of 4, and of 64 with
        # the table of starts full) no other K at this shape gives.
        for k in SERVE_B1_KS:
            fk = torch.from_numpy(masking.sample_window_starts_host(SEED + k, k, s, width)).to(dev)
            if not torch.equal(masked_batch(image, seg, fk, width, dt),
                               masked_batch_plain(image, seg, fk, width, dt)):
                raise AssertionError(f"B1 {dt} K={k}: kernel differs from its plain version")
        buf = torch.zeros((6, 224, 224, 3), dtype=dt, device=dev)
        masked_batch(image, seg, firsts[:3], width_dev, dt, out=buf[3:])
        if not torch.equal(buf[3:], want[:3]) or buf[:3].any():
            raise AssertionError(f"B1 {dt}: out= slice differs from the default")
        b1_slices(image, seg, s, width, dt)
    by_shape = b1_shapes(smi)
    ms = kernel_ms(lambda: masked_batch(image, seg, firsts, width, torch.bfloat16), 50,
                   "b1_masked_batch")
    plain_ms = time_ms(lambda: masked_batch_plain(image, seg, firsts, width, torch.bfloat16), 50)
    nbytes = MASK_BATCH * 224 * 224 * 3 * 2 + 224 * 224 * (3 * 4 + 4) + MASK_BATCH * 4
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    log(f"[B1] {smi}: K={MASK_BATCH}, 1 and 3 (width on the device), "
        f"{' and '.join(map(str, SERVE_B1_KS))} ([serve]'s buckets), out= slices at masks "
        f"0-{B1_SLICE_OFFSETS - 1}, 224x224x3 S={s}: bit-exact bf16+f32; K={MASK_BATCH} bf16 "
        f"kernel {ms:.4f} ms (device time), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({nbytes} bytes), {bound_ms / ms:.3f} of bound")
    for k in (MASK_BATCH, 32):
        by_shape.append(b1_time(image, seg, firsts[:k], width, torch.float32, smi, f"S={s}"))
    return ms, plain_ms, bound_ms, by_shape


def b1_zoo(smi):
    """[B1 zoo] (``--b1``): Inception-v3 (299x299x3, bf16, seeded random
    weights) as [zoo] runs it: evals/s of 1,024 window masks (B1's 4
    launches of K=256) and of 1,024 knockouts (no B1), and B1's device time
    in one 1,024-mask window call."""
    import torch

    arch, dataset, kw = ZOO[-1]
    z = zoo_setup(arch, dataset, kw)
    chunks = -(-NUM_SAMPLES // MASK_BATCH)

    def window():
        return z.engine.eval_window_masks(z.normalized, z.segments, z.firsts, z.width, z.target)

    b1_call = chunks * kernel_ms(window, chunks, "b1_masked_batch")
    win = zoo_rate(window)
    kor = zoo_rate(lambda: z.engine.eval_knockout_masks(z.normalized, z.segments, z.knock,
                                                         z.target))
    log(f"[B1 zoo] {smi}: {arch} ({dataset}, {z.bundle.input_size}x{z.bundle.input_size}x"
        f"{z.bundle.input_channels}, S={z.s}): B1 in one {NUM_SAMPLES}-mask window call "
        f"{b1_call:.4f} ms ({chunks} launches, device time); {NUM_SAMPLES} window masks "
        f"{win['p50']:.1f} evals/s (range {win['min']:.1f}-{win['max']:.1f} over {win['calls']} "
        f"calls), {NUM_SAMPLES} knockouts M=1 {kor['p50']:.1f} evals/s (range {kor['min']:.1f}-"
        f"{kor['max']:.1f} over {kor['calls']} calls)")
    del z
    torch.cuda.empty_cache()


def sass_accesses(so_path, prefix):
    """{kernel symbol: [128-bit global loads, narrower ones, 128-bit global
    stores, narrower ones]} for every instance of the kernel ``prefix`` in a
    built library's SASS (p1_pool_nhwc: the three kinds and the max pool's
    gradient, bf16 and f32; e1_epilogue_nhwc: with and without a residual,
    bf16 and f32)."""
    counts, fn = {}, None
    for line in sass_text(so_path).splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if prefix in fn:
                counts[fn] = [0, 0, 0, 0]
        elif fn in counts:
            op = next((t for t in line.split() if t.startswith(("LDG", "STG"))), None)
            if op is not None:
                counts[fn][(2 if op.startswith("STG") else 0)
                           + ("128" not in op.split("."))] += 1
    return counts


def ulps_apart(got, want):
    """Elementwise distance in units in the last place of two same-dtype
    float tensors (bf16 or f32), from their bit patterns mapped onto one
    ordered integer line."""
    import torch

    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[got.dtype]
    top = 1 << (8 * got.element_size() - 1)

    def line(t):
        i = t.contiguous().view(bits).to(torch.int64)
        return torch.where(i < 0, -(i + top), i)

    return (line(got) - line(want)).abs()


def pool_phase(smi):
    """28. [pool]: P1 against its plain version at Inception-v3's pool
    shapes, its timings, and the module plan's 13 launches a forward.
    Returns (the 13 pools' kernel, bound, plain and library ms in a forward
    of 256 in bf16, and the records of every shape)."""
    import torch

    from network_interpretation_imagenet_tpu_torch.models import ModulePlan, create_model
    from network_interpretation_imagenet_tpu_torch.models import inception
    from network_interpretation_imagenet_tpu_torch.ops import _cuda_build
    from network_interpretation_imagenet_tpu_torch.ops.pool_nhwc import (
        out_side,
        pool_nhwc,
        pool_nhwc_plain,
    )
    from network_interpretation_imagenet_tpu_torch.utils import logging as trace

    accesses = sass_accesses(_cuda_build.so_path("pool_nhwc"), "p1_pool_nhwc")
    log(f"[pool] pool_nhwc SASS: {len(accesses)} p1_pool_nhwc instances, global [128-bit loads, "
        "narrower, 128-bit stores, narrower] " + json.dumps(sorted(accesses.values())))
    if len(accesses) != 8 or any(a[0] == 0 or a[1] or a[2] == 0 or a[3]
                                 for a in accesses.values()):
        raise AssertionError(f"P1's library: an instance with accesses narrower than 16 bytes "
                             f"{accesses}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = list(dict.fromkeys((r, side, c) for _, r, side, c in inception.POOLS))
    by_shape, timed = [], {}
    for reduce, side, c in shapes:
        out = out_side(side, reduce)
        for batch in (1, MASK_BATCH):
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((batch, c, side, side), generator=gen, device=dev).to(dt)
                x = x.contiguous(memory_format=torch.channels_last)
                before = pool_nhwc.launches
                got = pool_nhwc(x, reduce)
                want = pool_nhwc_plain(x, reduce)
                torch.cuda.synchronize()
                if (pool_nhwc.launches != before + 1 or got.shape != want.shape
                        or not got.is_contiguous(memory_format=torch.channels_last)):
                    raise AssertionError(f"[pool] {reduce} {tuple(x.shape)} {dt}: no launch, or "
                                         f"a result of shape {tuple(got.shape)}, strides "
                                         f"{got.stride()}")
                ulps = ulps_apart(got, want)
                differ = (ulps > 0).float().mean().item()
                if (reduce == "max" and not torch.equal(got, want)) or ulps.max().item() > 1:
                    raise AssertionError(f"[pool] {reduce} {tuple(x.shape)} {dt}: kernel and "
                                         f"plain {ulps.max().item()} ulp apart, share {differ}")
                rec = {"reduce": reduce, "shape": [batch, side, side, c], "dtype": str(dt),
                       "max_ulps": int(ulps.max().item()), "share_differing": differ}
                if batch == 1:
                    # Recorded by autograd: the kernel's forward and backward
                    # (two launches) against the library's backward, same
                    # tolerances. The library's is taken on NCHW copies: its
                    # channels_last avg_pool2d backward reads wrong on torch
                    # 2.11.0+cu128 (up to 2.0 off, gradients of magnitude
                    # ~1.7), where the NCHW one agrees with the CPU's.
                    leaf = x.detach().requires_grad_(True)
                    g = torch.randn(want.shape, generator=gen, device=dev).to(dt).contiguous(
                        memory_format=torch.channels_last)
                    before = pool_nhwc.launches
                    got_g, = torch.autograd.grad(pool_nhwc(leaf, reduce), leaf, g)
                    launched = pool_nhwc.launches - before
                    nchw = x.detach().contiguous().requires_grad_(True)
                    want_g, = torch.autograd.grad(pool_nhwc_plain(nchw, reduce), nchw,
                                                  g.contiguous())
                    gulps = ulps_apart(got_g, want_g)
                    rec["grad_max_ulps"] = int(gulps.max().item())
                    rec["grad_share_differing"] = (gulps > 0).float().mean().item()
                    if launched != 2 or (reduce == "max" and not torch.equal(got_g, want_g)) \
                            or rec["grad_max_ulps"] > 1:
                        raise AssertionError(f"[pool] {reduce} {tuple(x.shape)} {dt} gradient: "
                                             f"{launched} launches, {rec['grad_max_ulps']} ulp "
                                             f"from the library's")
                    del leaf, nchw, g, got_g, want_g, gulps
                if batch == MASK_BATCH:
                    nbytes = batch * c * (side * side + out * out) * x.element_size()
                    rec["bound_ms"] = nbytes / H100_BYTES_PER_S * 1e3
                    rec["ms"] = kernel_ms(lambda: pool_nhwc(x, reduce), 20, "p1_pool_nhwc")
                    rec["plain_ms"] = time_ms(lambda: pool_nhwc_plain(x, reduce), 20)
                    rec["library_ms"] = kernel_ms(lambda: pool_nhwc_plain(x, reduce), 20,
                                                  "avg_pool2d" if reduce == "avg" else "max_pool")
                    timed[(reduce, side, c, dt)] = rec
                by_shape.append(rec)
                log(f"[pool] {smi}: {reduce} {batch}x{side}x{side}x{c} -> {out}x{out} {dt}: "
                    f"max {rec['max_ulps']} ulp, share differing {differ:.3g}"
                    + (f"; gradient max {rec['grad_max_ulps']} ulp, share differing "
                       f"{rec['grad_share_differing']:.3g}" if batch == 1 else "")
                    + (f"; kernel {rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                       f"({rec['bound_ms'] / rec['ms']:.3f} of bound), plain {rec['plain_ms']:.4f}"
                       f" ms, library {rec['library_ms']:.4f} ms" if batch == MASK_BATCH else ""))
                del x, got, want, ulps
        torch.cuda.empty_cache()

    # On the card an NCHW input raises, naming its shape; nothing launches.
    x = torch.randn((2, 64, 35, 35), generator=gen, device=dev)
    before = pool_nhwc.launches
    for reduce in ("avg", "max"):
        try:
            pool_nhwc(x, reduce)
        except ValueError as e:
            if "(2, 64, 35, 35)" not in str(e):
                raise
        else:
            raise AssertionError(f"[pool] an NCHW {reduce} input on the card did not raise")
    if pool_nhwc.launches != before:
        raise AssertionError("[pool] an NCHW input launched the kernel")

    total = {k: sum(timed[(r, side, c, torch.bfloat16)][k] for _, r, side, c in inception.POOLS)
             for k in ("ms", "bound_ms", "plain_ms", "library_ms")}
    log(f"[pool] {smi}: the 13 pools of a forward of {MASK_BATCH}, bf16: kernel "
        f"{total['ms']:.4f} ms, bound {total['bound_ms']:.4f} ms "
        f"({total['bound_ms'] / total['ms']:.3f} of bound), plain {total['plain_ms']:.4f} ms, "
        f"library {total['library_ms']:.4f} ms")
    if total["ms"] > POOL_FORWARD_MS:
        raise AssertionError(f"[pool] the 13 pools take {total['ms']:.3f} ms a forward of "
                             f"{MASK_BATCH}, above {POOL_FORWARD_MS}")

    # The module plan: one bf16 forward launches the kernel 13 times and its
    # span says so; its logits against the same plan on the library's pools.
    bundle = create_model("inception_v3", "imagenet", dtype=torch.bfloat16)
    plan = ModulePlan(bundle.module, bundle.init(SEED), torch.bfloat16, dev)
    img = torch.randn((MASK_BATCH, 299, 299, 3), generator=gen, device=dev).to(torch.bfloat16)
    library = {"_avg3": lambda t: pool_nhwc_plain(t, "avg"),
               "_max3s2": lambda t: pool_nhwc_plain(t, "max")}
    saved = {name: getattr(inception, name) for name in library}
    with torch.inference_mode():
        trace.clear()
        trace.enable()
        before = pool_nhwc.launches
        try:
            got = plan(img[:2])
        finally:
            trace.disable()
        spans = [sp.attrs.get("pool_launches") for sp in trace.spans()
                 if sp.name == "plan.forward"]
        trace.clear()
        launched = pool_nhwc.launches - before
        kernel_fwd = time_ms(lambda: plan(img), 5)
        try:
            for name, fn in library.items():
                setattr(inception, name, fn)
            want = plan(img[:2])
            library_fwd = time_ms(lambda: plan(img), 5)
        finally:
            for name, fn in saved.items():
                setattr(inception, name, fn)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"[pool] {smi}: inception_v3 bf16 plan at 299^2: {launched} launches a forward, span "
        f"pool_launches {spans}; logits vs the library's pools equal {torch.equal(got, want)}, "
        f"max err {err:.4g} (max |logit| {scale:.4g}); forward of {MASK_BATCH} "
        f"{kernel_fwd:.3f} ms, on the library's pools {library_fwd:.3f} ms (CUDA events)")
    if launched != len(inception.POOLS) or spans != [len(inception.POOLS)] or \
            not torch.equal(got, want):
        raise AssertionError(f"[pool] the plan: {launched} launches, spans' pool_launches "
                             f"{spans}, logit err {err} of {scale}")
    del plan, img
    torch.cuda.empty_cache()
    return total, by_shape


def pool_only() -> int:
    """``--pool``: only the build and [pool] (1., 2., 28.), for a first
    check of the pool kernel, or to compare two trees of the port on one
    card in one call. Prints no result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    _, smi = device_and_build()
    pool_phase(smi)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    return 0


def epilogue_phase(smi):
    """29. [epilogue]: E1 against its plain twin at every epilogue shape of
    ResNeXt-101 and ResNet-101, its timings, and the folded plan's launches
    and logits. Returns (the kernel, bound, plain and library ms of the 100
    epilogues of a ResNeXt-101 forward of 256 in bf16, and the records of
    every shape)."""
    import torch

    from network_interpretation_imagenet_tpu_torch.models import FoldedResNet, create_model
    from network_interpretation_imagenet_tpu_torch.ops import _cuda_build
    from network_interpretation_imagenet_tpu_torch.ops.epilogue_nhwc import (
        epilogue_nhwc,
        epilogue_nhwc_plain,
    )
    from network_interpretation_imagenet_tpu_torch.utils import logging as trace

    accesses = sass_accesses(_cuda_build.so_path("epilogue_nhwc"), "e1_epilogue_nhwc")
    log(f"[epilogue] epilogue_nhwc SASS: {len(accesses)} e1_epilogue_nhwc instances, global "
        "[128-bit loads, narrower, 128-bit stores, narrower] "
        + json.dumps(sorted(accesses.values())))
    if len(accesses) != 4 or any(a[0] == 0 or a[1] or a[2] == 0 or a[3]
                                 for a in accesses.values()):
        raise AssertionError(f"E1's library: an instance with accesses narrower than 16 bytes "
                             f"{accesses}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # Each net's epilogues, (H, W, C, residual) in order, as one bf16 forward
    # at 224^2 through the plain twin runs them.
    plans, forwards = {}, {}
    for arch in ("resnext101_32x8d", "resnet101"):
        bundle = create_model(arch, "imagenet", dtype=torch.bfloat16)
        plan = plans[arch] = FoldedResNet(bundle.init(SEED), bundle.module.stage_sizes,
                                          torch.bfloat16, dev)
        seen = forwards[arch] = []

        def spy(y, bias, res=None, seen=seen):
            seen.append((y.shape[2], y.shape[3], y.shape[1], res is not None))
            return epilogue_nhwc_plain(y, bias, res)

        plan._epilogue = lambda device, plain, spy=spy: spy
        with torch.inference_mode():
            plan(torch.zeros((1, 224, 224, 3), dtype=torch.bfloat16, device=dev))
        del plan._epilogue, bundle
    shapes = list(dict.fromkeys(sh for fwd in forwards.values() for sh in fwd))
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    by_shape, timed = [], {}
    for h, w, c, residual in shapes:
        for batch in (1, MASK_BATCH):
            for dt in (torch.bfloat16, torch.float32):
                def make():
                    t = torch.randn((batch, c, h, w), generator=gen, device=dev).to(dt)
                    return t.contiguous(memory_format=torch.channels_last)

                y, res = make(), make() if residual else None
                bias = torch.randn(c, generator=gen, device=dev)
                before = epilogue_nhwc.launches
                got = epilogue_nhwc(y.clone(), bias, res)
                want = epilogue_nhwc_plain(y.clone(), bias, res)
                torch.cuda.synchronize()
                launched = epilogue_nhwc.launches - before
                same = torch.equal(got.view(bits[dt]), want.view(bits[dt]))
                if launched != 1 or not same:
                    raise AssertionError(f"[epilogue] {tuple(y.shape)} {dt} residual {residual}: "
                                         f"{launched} launches, equal to the plain twin's bits "
                                         f"{same}, max err {(got - want).abs().max().item()}")
                rec = {"shape": [batch, h, w, c], "residual": residual, "dtype": str(dt),
                       "bit_equal": same}
                if batch == MASK_BATCH and dt == torch.bfloat16:
                    nbytes = batch * h * w * c * y.element_size() * (3 if residual else 2) + 4 * c
                    rec["bound_ms"] = nbytes / H100_BYTES_PER_S * 1e3
                    rec["ms"] = kernel_ms(lambda: epilogue_nhwc(y, bias, res), 20,
                                          "e1_epilogue_nhwc")
                    rec["plain_ms"] = time_ms(lambda: epilogue_nhwc_plain(y, bias, res), 20)
                    b16 = bias.to(dt).view(1, -1, 1, 1)
                    rec["library_ms"] = time_ms(
                        (lambda: torch.relu(y.add_(b16))) if res is None else
                        (lambda: torch.relu(y.add_(b16) + res)), 20)
                    timed[(h, w, c, residual)] = rec
                by_shape.append(rec)
                log(f"[epilogue] {smi}: {batch}x{h}x{w}x{c}{' + residual' if residual else ''} "
                    f"{dt}: bit-equal to the plain twin"
                    + (f"; kernel {rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                       f"({rec['bound_ms'] / rec['ms']:.3f} of bound), plain {rec['plain_ms']:.4f}"
                       f" ms, library {rec['library_ms']:.4f} ms" if "ms" in rec else ""))
                del y, res, got, want
        torch.cuda.empty_cache()

    # On the card an NCHW input raises, naming its shape; nothing launches.
    x = torch.randn((2, 64, 9, 9), generator=gen, device=dev)
    before = epilogue_nhwc.launches
    try:
        epilogue_nhwc(x, torch.zeros(64, device=dev))
    except ValueError as e:
        if "(2, 64, 9, 9)" not in str(e):
            raise
    else:
        raise AssertionError("[epilogue] an NCHW input on the card did not raise")
    if epilogue_nhwc.launches != before:
        raise AssertionError("[epilogue] an NCHW input launched the kernel")

    totals = {}
    for arch, fwd in forwards.items():
        totals[arch] = {k: sum(timed[sh][k] for sh in fwd)
                        for k in ("ms", "bound_ms", "plain_ms", "library_ms")}
        t = totals[arch]
        log(f"[epilogue] {smi}: the {len(fwd)} epilogues of a {arch} forward of {MASK_BATCH}, "
            f"bf16: kernel {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_ms'] / t['ms']:.3f} of bound), plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms']:.4f} ms")
    share = totals["resnext101_32x8d"]["bound_ms"] / totals["resnext101_32x8d"]["ms"]
    if share < EPILOGUE_BOUND_SHARE:
        raise AssertionError(f"[epilogue] ResNeXt-101's epilogues at {share:.3f} of their bound, "
                             f"below {EPILOGUE_BOUND_SHARE}")

    # The folded plans: a bf16 forward's span counts its launches; ResNeXt-101's
    # logits against plain=True's, and its forward of 256 timed both ways.
    img = torch.randn((MASK_BATCH, 224, 224, 3), generator=gen, device=dev).to(torch.bfloat16)
    parts = []
    for arch, fwd in forwards.items():
        plan = plans.pop(arch)
        with torch.inference_mode():
            trace.clear()
            trace.enable()
            before = epilogue_nhwc.launches
            try:
                got = plan(img)
            finally:
                trace.disable()
            launched = epilogue_nhwc.launches - before
            spans = [sp.attrs.get("epilogues") for sp in trace.spans()
                     if sp.name == "plan.forward"]
            trace.clear()
            e1_ms = time_ms(lambda: plan(img), 5)
            if launched != len(fwd) or spans != [len(fwd)]:
                raise AssertionError(f"[epilogue] {arch}: {launched} launches a forward, spans' "
                                     f"epilogues {spans}, want {len(fwd)}")
            part = (f"{arch} bf16 plan at 224^2: {launched} launches a forward of {MASK_BATCH}, "
                    f"span epilogues {spans}; forward {e1_ms:.3f} ms (CUDA events)")
            if arch == "resnext101_32x8d":
                want = plan(img, plain=True)
                plain_ms = time_ms(lambda: plan(img, plain=True), 5)
                err = (got - want).abs().max().item()
                part += (f", plain=True {plain_ms:.3f} ms; logits vs plain=True equal "
                         f"{torch.equal(got, want)}, max err {err:.4g} (max |logit| "
                         f"{want.abs().max().item():.4g})")
                if not torch.isfinite(got).all() or not torch.equal(got, want):
                    raise AssertionError(f"[epilogue] {arch}: logits vs plain=True err {err}")
                if e1_ms > EPILOGUE_FORWARD_MS:
                    raise AssertionError(f"[epilogue] {arch}: a forward of {MASK_BATCH} takes "
                                         f"{e1_ms:.3f} ms, above {EPILOGUE_FORWARD_MS}")
        parts.append(part)
        del plan, got
        torch.cuda.empty_cache()
    log(f"[epilogue] {smi}: " + "; ".join(parts))
    del img
    torch.cuda.empty_cache()
    return totals["resnext101_32x8d"], by_shape


def epilogue_only() -> int:
    """``--epilogue``: only the build and [epilogue] (1., 2., 29.), for a
    first check of E1, or to compare two trees of the port on one card in
    one call. Prints no result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    _, smi = device_and_build()
    epilogue_phase(smi)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    return 0


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


def zoo_setup(arch, dataset, kw):
    """One [zoo] arch at full width and depth, seeded random weights, on its
    own bf16 engine: a namespace of the bundle, its weights, the normalized
    synthetic image, its Felzenszwalb segments, S, the window width,
    NUM_SAMPLES window starts and knockout ids, the engine and the image's
    target."""
    import torch

    from network_interpretation_imagenet_tpu_torch.cli.common import segment_config
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.ops import masking
    from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
    from network_interpretation_imagenet_tpu_torch.segment.common import segment_image

    bundle = create_model(arch, dataset, dtype=torch.bfloat16, **kw)
    sd = bundle.init(SEED)
    normalized, display = zoo_image(dataset, bundle.input_size)
    args = types.SimpleNamespace(dataset=dataset, segmenter="felzenszwalb", scale=None,
                                 sigma=0.5, min_size=None, n_segments=48)
    segments = segment_image(display, segment_config(args))
    s = int(segments.max()) + 1
    width = max(1, int(0.4 * s))
    engine = SaliencyEngine(bundle, sd, mask_batch=MASK_BATCH, device="cuda")
    return types.SimpleNamespace(
        bundle=bundle, sd=sd, normalized=normalized, segments=segments, s=s,
        width=width, firsts=masking.sample_window_starts_host(SEED, NUM_SAMPLES, s, width),
        knock=masking.sample_knockout_ids_host(SEED, NUM_SAMPLES, 1, s), engine=engine,
        target=engine.predict_one(normalized)[0])


def zoo_phase(smi, by_path):
    """Every new arch at full width and depth (see the module docstring, 21)."""
    import torch

    from network_interpretation_imagenet_tpu_torch.models import ModulePlan
    from network_interpretation_imagenet_tpu_torch.models.inception import POOLS
    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import (
        masked_batch,
        masked_batch_plain,
    )

    dev = torch.device("cuda")
    chunks = -(-NUM_SAMPLES // MASK_BATCH)
    rates = {}
    for arch, dataset, kw in ZOO:
        t_arch = time.perf_counter()
        z = zoo_setup(arch, dataset, kw)
        # B1 at every chunk the window path below gives it, on this arch's own
        # segments and starts: bit for bit against its plain version.
        image_t, seg_t = (torch.from_numpy(z.normalized).to(dev),
                          torch.from_numpy(z.segments).to(dev))
        firsts_t = torch.from_numpy(z.firsts).to(dev)
        for off in range(0, NUM_SAMPLES, MASK_BATCH):
            part = firsts_t[off:off + MASK_BATCH]
            dt = z.engine.compute_dtype
            if not torch.equal(masked_batch(image_t, seg_t, part, z.width, dt),
                               masked_batch_plain(image_t, seg_t, part, z.width, dt)):
                raise AssertionError(f"[zoo] {arch}: B1 chunk at {off} differs from its plain "
                                     "version")
        # The engine's bf16 plan against the plain module in f32, 32 masked images.
        x = masked_batch_plain(image_t, seg_t, firsts_t[:32], z.width, torch.float32)
        f32 = ModulePlan(z.bundle.module, z.sd, torch.float32, dev)
        with torch.inference_mode():
            got, want = z.engine.model(x.to(torch.bfloat16)), f32(x)
            cpu = ModulePlan(z.bundle.module, z.sd, torch.float32, "cpu")(x[:8].cpu())
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        err32 = (want[:8].cpu() - cpu).abs().max().item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        if not (torch.isfinite(got).all() and err <= ZOO_TOL * scale
                and err32 <= ZOO_F32_TOL * cpu.abs().max().item()):
            raise AssertionError(f"[zoo] {arch}: bf16 plan vs f32 module err {err} (max |logit| "
                                 f"{scale}), f32 card vs CPU err {err32}")
        del f32, cpu, x, image_t, seg_t, firsts_t
        pools = len(POOLS) * chunks if arch == "inception_v3" else 0
        res = counted(by_path, f"zoo_{arch}_window", lambda: z.engine.eval_window_masks(
            z.normalized, z.segments, z.firsts, z.width, z.target), chunks, 0, pools)
        ko = counted(by_path, f"zoo_{arch}_knockout", lambda: z.engine.eval_knockout_masks(
            z.normalized, z.segments, z.knock, z.target), 0, 0, pools)
        if not (np.isfinite(res.prob_target).all() and np.isfinite(ko.prob_target).all()):
            raise AssertionError(f"[zoo] {arch}: non-finite outcomes")

        win = zoo_rate(lambda: z.engine.eval_window_masks(z.normalized, z.segments, z.firsts,
                                                          z.width, z.target))
        kor = zoo_rate(lambda: z.engine.eval_knockout_masks(z.normalized, z.segments, z.knock,
                                                            z.target))
        rates[arch] = {"window": win, "knockout": kor}
        h = z.bundle.input_size
        log(f"[zoo] {smi}: {arch} ({dataset}, {h}x{h}x{z.bundle.input_channels}, S={z.s}, "
            f"target {z.target}): bf16 plan vs plain f32 module, 32 masked images, max logit err "
            f"{err:.4g} ({err / scale:.3g} of max |logit| {scale:.4g}), argmax agreement "
            f"{agree:.3f}; B1 bit-exact at its {chunks} chunks; f32 card vs CPU, 8 images, "
            f"{err32:.3g}; {NUM_SAMPLES} window masks {win['p50']:.1f} evals/s (range "
            f"{win['min']:.1f}-{win['max']:.1f} over {win['calls']} calls, survived "
            f"{int(res.survived.sum())}), {NUM_SAMPLES} knockouts M=1 {kor['p50']:.1f} evals/s "
            f"(range {kor['min']:.1f}-{kor['max']:.1f} over {kor['calls']} calls, survived "
            f"{int(ko.survived.sum())}), mask_batch {MASK_BATCH}; launches window {json.dumps(by_path[f'zoo_{arch}_window'])}, "
            f"knockout {json.dumps(by_path[f'zoo_{arch}_knockout'])}; "
            f"{time.perf_counter() - t_arch:.1f} s")
        del z
        torch.cuda.empty_cache()
    log(f"[zoo] {smi}: evals/s (median, range, calls) " + json.dumps(rates))


def _batch_statistics(bundle, x):
    """``bundle.init(SEED)`` with every BatchNorm's running statistics set to
    its batch statistics on ``x`` (a copy of the module in training mode,
    one forward on the CPU), so that activations are normalized, as a
    trained net's are."""
    import copy

    import torch

    net = copy.deepcopy(bundle.module)
    net.load_state_dict(bundle.init(SEED))
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None   # a cumulative average: one batch's statistics
    net.train()
    with torch.no_grad():
        net(x)
    return {k: t.detach().clone() for k, t in net.state_dict().items()}


def zoo_grad_phase(smi):
    """[zoo grad] (see the module docstring, 21): per arch of ZOO_GRAD, the
    f32 input gradient on the card (``bundle.logits``) and on the CPU, each
    against the CPU's float64 gradient, in relative L2 error. Even with
    BatchNorm on the batch's statistics an f32 gradient of these nets is
    off float64's by 0.2-0.7 % on the CPU (ReLU kinks that rounding flips),
    and two right f32 routes differ up to 3.5 times in that error (the CPU's
    pools channels_last or on NCHW copies, DenseNet-121), so the card's
    error may be at most ZOO_GRAD_RATIO times the CPU's, or ZOO_F32_TOL
    where that is larger: a wrong backward (the library's channels_last
    average pool backward has read 0.7-2.0 off at 3x3 windows on the card)
    errs by tens of per cent. Where the card's is not, the card runs again with every average
    pool on an NCHW-contiguous copy of its input (the library's NCHW
    backward) and logs that error beside it; after every arch, raises
    naming those that failed. Returns {arch: (card err, CPU err)}."""
    import torch
    import torch.nn.functional as F

    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.models import densenet, resnet_cifar

    def nchw_pool(x, window):
        return F.avg_pool2d(x.contiguous(), window, window)

    out, failed = {}, []
    for arch, dataset, kw in ZOO_GRAD:
        bundle = create_model(arch, dataset, **kw)
        normalized, _ = zoo_image(dataset, bundle.input_size)
        g = torch.Generator().manual_seed(SEED)
        x = torch.from_numpy(normalized)[None] + 0.1 * torch.randn(
            ZOO_GRAD_BATCH, *normalized.shape, generator=g)
        w = torch.randn(ZOO_GRAD_BATCH, bundle.num_classes, generator=g)
        sd = _batch_statistics(bundle, x)

        def grad(device, dtype=torch.float32):
            xi = x.to(device, dtype, copy=True).requires_grad_(True)
            if dtype == torch.float32:
                logits = bundle.logits(sd, xi)
            else:
                state = {k: v.to(dtype) if v.is_floating_point() else v for k, v in sd.items()}
                logits = torch.func.functional_call(bundle.module.eval(), state, (xi,))
            (logits * w.to(device, dtype)).sum().backward()
            return xi.grad.cpu().double()

        exact = grad("cpu", torch.float64)

        def err(a):
            return ((a - exact).norm() / exact.norm()).item()

        card, cpu = grad("cuda"), grad("cpu")
        e_card, e_cpu = err(card), err(cpu)
        limit = max(ZOO_F32_TOL, ZOO_GRAD_RATIO * e_cpu)
        out[arch] = (e_card, e_cpu)
        note = ""
        if not (torch.isfinite(card).all() and e_card <= limit):
            failed.append(arch)
            saved = densenet.avg_pool, resnet_cifar.avg_pool
            densenet.avg_pool = resnet_cifar.avg_pool = nchw_pool
            try:
                e_nchw = err(grad("cuda"))
            finally:
                densenet.avg_pool, resnet_cifar.avg_pool = saved
            note = f"; FAILS; with the pools on NCHW copies the card's err is {e_nchw:.3g}"
        scale = exact.abs().max().item()
        log(f"[zoo grad] {smi}: {arch} ({dataset}, {ZOO_GRAD_BATCH} x "
            f"{'x'.join(map(str, normalized.shape))}, BatchNorm on the batch's statistics): input "
            f"gradient against the CPU's float64, relative L2 err card f32 {e_card:.3g}, CPU f32 "
            f"{e_cpu:.3g} (limit {limit:.3g}); max |err| card {(card - exact).abs().max().item():.3g}"
            f", CPU {(cpu - exact).abs().max().item():.3g} of max |gradient| {scale:.4g}" + note)
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"[zoo grad] the card's input gradient beyond {ZOO_GRAD_RATIO:g} "
                             f"times the CPU's f32 error: {', '.join(failed)}")
    return out


def zoo_grad_only() -> int:
    """``--zoo-grad``: only the build and [zoo grad] (1., 2., 21.'s
    gradients). Prints no result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    _, smi = device_and_build()
    zoo_grad_phase(smi)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    return 0


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


TRAIN_ARGV = ["-a", "resnet50", "--synthetic", "--limit-images", "2048", "-b", "256",
              "--epochs", "2", "-p", "1"]   # cli.main's stock flags, one meter line per step
TRAIN_CHECK_BATCH = 8        # the card step against the CPU step
TRAIN_LOSS_TOL = 1e-5        # f32 loss vs the f64 step's: relative
TRAIN_UPDATE_TOL = 2.0       # the card's update error vs f64: x the CPU's (rel L2, all tensors)
TRAIN_STATS_TOL = 1e-4       # the card's running statistics vs f64: x each tensor's scale
HANDOFF_MASKS = 1024         # the trained checkpoint's window masks, one chunk of 1,024


def chain_inputs(plan, x):
    """The folded net's eager blocks run on NHWC ``x`` with the plain
    versions of the epilogues and the chains: [(each stage's chain input
    NHWC, its chain weights)]."""
    import torch

    from network_interpretation_imagenet_tpu_torch.models.common import max_pool_same
    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import (
        bottleneck_chain_plain,
    )
    from network_interpretation_imagenet_tpu_torch.ops.epilogue_nhwc import epilogue_nhwc_plain

    out = []
    with torch.inference_mode():
        y = max_pool_same(plan._conv(x.permute(0, 3, 1, 2), plan.stem, epilogue_nhwc_plain), 3, 2)
        for blocks, chain in plan.stages:
            for block in blocks:
                y = plan._block(y, block, epilogue_nhwc_plain)
            if chain:
                out.append((y.permute(0, 2, 3, 1), chain))
                y = bottleneck_chain_plain(y.permute(0, 2, 3, 1), chain).permute(0, 3, 1, 2)
    return out


def step_meter(stdout):
    """The per-step seconds of Trainer.train_epoch's meter lines (-p 1)."""
    return [float(line.split("\tTime ")[1].split(" ")[0]) for line in stdout.splitlines()
            if line.startswith("Epoch: [") and "\tTime " in line]


class Cut(Exception):
    """The interruption :func:`cut_loader` raises."""


def cut_loader(x, y, batch, after):
    """A shuffled ``ArrayLoader`` whose epochs raise :class:`Cut` at batch
    ``after`` (a run cut mid-epoch)."""
    from network_interpretation_imagenet_tpu_torch.data.loaders import ArrayLoader

    class CutLoader(ArrayLoader):
        def __iter__(self):
            for i, item in enumerate(super().__iter__()):
                if i == after:
                    raise Cut
                yield item

    return CutLoader(x, y, batch, shuffle=True)


@contextlib.contextmanager
def deterministic():
    """torch.use_deterministic_algorithms (warn-only, its warnings muted)
    within the block: a run repeats itself bit for bit."""
    import os
    import warnings

    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)


def step_errors(after, ref, base, loss=None, ref_loss=None):
    """How far a run's state ``after`` lies from the f64 run's ``ref``, both
    from ``base`` (CPU f64 tensors by name): the update, all parameters as
    one vector, in relative L2 (``update``, with the ``worst`` tensor), the
    running statistics' max error x each tensor's scale (``stats``) and,
    given, the loss's relative error."""
    num = den = 0.0
    worst = (0.0, "")
    for k, t in ref.items():
        if k.endswith(("running_mean", "running_var")):
            continue
        want = t - base[k]
        d = float((after[k] - base[k] - want).norm()) ** 2
        num, den = num + d, den + float(want.norm()) ** 2
        worst = max(worst, ((d ** 0.5) / max(float(want.norm()), 1e-30), k))
    stats = max(float((after[k] - ref[k]).abs().max() / ref[k].abs().max().clamp_min(1e-30))
                for k in ref if k.endswith(("running_mean", "running_var")))
    out = {"update": (num / den) ** 0.5, "worst": worst, "stats": stats}
    if loss is not None:
        out["loss"] = abs(loss - ref_loss) / abs(ref_loss)
    return out


def train_phase(normalized, segments, smi, by_path):
    """[train]: training on the card, and its checkpoint explained (see the
    module docstring, 25)."""
    import os
    import tempfile
    import warnings

    import torch

    from network_interpretation_imagenet_tpu_torch.cli import common
    from network_interpretation_imagenet_tpu_torch.cli import main as train_cli
    from network_interpretation_imagenet_tpu_torch.config import TrainConfig
    from network_interpretation_imagenet_tpu_torch.data.loaders import ArrayLoader
    from network_interpretation_imagenet_tpu_torch.data.synthetic import (
        synthetic_classification_batch,
    )
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import (
        masked_batch,
        masked_batch_plain,
    )
    from network_interpretation_imagenet_tpu_torch.parallel import make_sharded_train_step
    from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
    from network_interpretation_imagenet_tpu_torch.saliency.pipeline import (
        random_window_saliency,
    )
    from network_interpretation_imagenet_tpu_torch.train import Trainer, make_optimizer

    t_phase = time.perf_counter()
    stock = TrainConfig(lr=0.1, momentum=0.9, weight_decay=1e-4)

    # 1. one ResNet-50 f32 step on the card against the CPU step, same parameters,
    # each held to an f64 step on the card (a ReLU net's f32 gradient is only as
    # good as its rounding lets it be; the card must be no worse than the CPU)
    bundle = create_model("resnet50", "imagenet", num_classes=8)
    sd = bundle.init(SEED)
    x, y = synthetic_classification_batch(SEED, TRAIN_CHECK_BATCH, 224, 3, 8)
    after, metrics = {}, {}
    for name, dev, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                             ("f64", "cuda", torch.float64)):
        init, step = make_sharded_train_step(bundle, None, make_optimizer(stock, 8), device=dev)
        start = {k: v.to(dtype) if v.is_floating_point() else v for k, v in sd.items()}
        state, m = step(init(SEED, start), x, y)
        after[name] = {k: t.detach().cpu().double() for k, t in
                       {**state.params, **state.buffers}.items()
                       if not k.endswith("num_batches_tracked")}
        metrics[name] = {k: float(v) for k, v in m.items()}
        del state, init, step
    base = {k: v.double() for k, v in sd.items()}
    errs = {name: step_errors(after[name], after["f64"], base, metrics[name]["loss"],
                              metrics["f64"]["loss"]) for name in ("card", "cpu")}
    e_card, e_cpu = errs["card"], errs["cpu"]
    log(f"[train] ResNet-50 224 B={TRAIN_CHECK_BATCH}, one stock SGD step from the same "
        f"parameters, f32 on the card and on the CPU, each against f64 on the card: loss "
        f"{metrics['card']['loss']:.7f} / {metrics['cpu']['loss']:.7f} / "
        f"{metrics['f64']['loss']:.7f} (rel err card {e_card['loss']:.3g}, CPU "
        f"{e_cpu['loss']:.3g}; tol {TRAIN_LOSS_TOL}); the update, all tensors as one vector, "
        f"rel L2 err card {e_card['update']:.3g}, CPU {e_cpu['update']:.3g} (tol: the card within "
        f"{TRAIN_UPDATE_TOL} x the CPU's); worst tensor card {e_card['worst'][0]:.3g} "
        f"({e_card['worst'][1]}), CPU {e_cpu['worst'][0]:.3g} ({e_cpu['worst'][1]}); running "
        f"statistics max err x scale card {e_card['stats']:.3g}, CPU {e_cpu['stats']:.3g}; "
        f"top1/top5 {metrics['card']['top1']}/{metrics['card']['top5']}")
    if not (e_card["loss"] <= TRAIN_LOSS_TOL and e_cpu["loss"] <= TRAIN_LOSS_TOL
            and e_card["update"] <= TRAIN_UPDATE_TOL * e_cpu["update"]
            and e_card["stats"] <= TRAIN_STATS_TOL):
        raise AssertionError("[train] the card's step strays from the CPU's")
    del after

    # 2. resume equality under deterministic algorithms: two uninterrupted runs
    # and one cut after 3 of 4 steps, resumed from its save at step 2
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    xr, yr = synthetic_classification_batch(SEED + 1, 64, 224, 3, 8)
    val = ArrayLoader(xr[:16], yr[:16], 16)

    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            def trainer(name):
                return Trainer(create_model("resnet50", "imagenet", num_classes=8),
                               TrainConfig(lr=0.1, epochs=1), 4, save_dir=f"{tmp}/{name}",
                               save_every_steps=2)

            runs = {}
            for name in ("whole", "again"):
                t = trainer(name)
                t.fit(ArrayLoader(xr, yr, 16, shuffle=True), val)
                runs[name] = t.variables()
            try:
                trainer("cut").fit(cut_loader(xr, yr, 16, 3), val)
                raise AssertionError("[train] the cut run was not cut")
            except Cut:
                pass
            resumed = trainer("cut")
            if not (resumed.resume() and resumed.resume_skip_steps == 2):
                raise AssertionError("[train] no mid-epoch checkpoint to resume")
            resumed.fit(ArrayLoader(xr, yr, 16, shuffle=True), val)
            runs["resumed"] = resumed.variables()
        finally:
            torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split("\n")[0][:120] for w in seen
                     if "deterministic" in str(w.message)})

    def diff(a, b):
        return max((runs[a][k].float() - runs[b][k].float()).abs().max().item()
                   for k in runs[a] if not k.endswith("num_batches_tracked"))

    again_err, resume_err = diff("whole", "again"), diff("whole", "resumed")
    log(f"[train] resume under torch.use_deterministic_algorithms (ResNet-50 224 f32, B=16, 4 "
        f"steps, a save every 2; cut after 3, resumed from step 2): max |uninterrupted - again| "
        f"{again_err:.3g}, max |uninterrupted - resumed| {resume_err:.3g}; ops without a "
        f"deterministic version: {nondet or 'none'}")
    if resume_err != 0.0 or again_err != 0.0:
        raise AssertionError("[train] resumed training is not update-for-update identical")

    # 3. the timed run: cli.main, the user's command, its meter's per-step times;
    # then the same 16 steps under the profiler for the device's idle share
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = counted(by_path, "train_cli",
                         lambda: train_cli.main(TRAIN_ARGV + ["--save", tmp]), 0, 0)
        cli_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = step_meter(out.getvalue())
        with open(f"{tmp}/imagenet_train_result.json") as f:
            result = json.load(f)
        if rc != 0 or len(steps) != 16 or result["epochs_run"] != 2 or not all(
                np.isfinite(r[k]) for r in result["history"] for k in ("train_loss", "val_loss")):
            raise AssertionError(f"[train] cli.main rc {rc}, {len(steps)} steps, {result}")
        warm = float(np.median(steps[1:]))
        log(f"[train] {smi}: cli.main {' '.join(TRAIN_ARGV)} (TF32 off): {cli_s:.1f} s with the "
            f"data and checkpoints; per step (its meter, host sync to host sync) first "
            f"{steps[0] * 1e3:.1f} ms, warm median {warm * 1e3:.1f} ms (range "
            f"{min(steps[1:]) * 1e3:.1f}-{max(steps[1:]) * 1e3:.1f}), {256 / warm:.1f} images/s;"
            f" peak memory {peak:.2f} GiB; history "
            + json.dumps([{k: r[k] for k in ("train_loss", "val_loss", "val_err1")}
                          for r in result["history"]]))
        ckpt = os.path.join(result["save_dir"], "model_best")

        xs, ys = synthetic_classification_batch(SEED, 2048, 224, 3, 8)
        t = Trainer(create_model("resnet50", "imagenet", num_classes=8),
                    TrainConfig(lr=0.1, epochs=2), 8)
        loader = ArrayLoader(xs, ys, 256, shuffle=True)

        def two_epochs():
            for epoch in range(2):
                loader.set_epoch(epoch)
                t.train_epoch(loader, epoch)

        wall_ms, busy = busy_ms(two_epochs)
        log(f"[train] the same 16 steps through Trainer.train_epoch under the profiler: wall "
            f"{wall_ms:.1f} ms, device busy {busy:.1f} ms, idle share "
            f"{1 - busy / wall_ms:.3f}" if busy > 0 else
            "[train] device time not measured (the profiler saw none)")
        del t, loader, xs, ys

        # 4. the handoff: model_best through --ckpt into a bf16 engine, 1,024 window masks
        args = common.build_parser("handoff").parse_args(
            ["--arch", "resnet50", "--ckpt", ckpt, "--mask-batch", str(HANDOFF_MASKS)])
        engine = common.build_engine(args, num_classes=8)
    rnd = create_model("resnet50", "imagenet", num_classes=8, dtype=torch.bfloat16)
    random_engine = SaliencyEngine(rnd, rnd.init(SEED), mask_batch=HANDOFF_MASKS, device="cuda")

    def handoff():
        target, _ = engine.predict_one(normalized)
        return target, random_window_saliency(engine, normalized, segments,
                                              num_samples=HANDOFF_MASKS, seed=SEED, target=target)

    target, hout = counted(by_path, "train_handoff", handoff, 1, 8)
    if not np.isfinite(hout.heatmap).all():
        raise AssertionError("[train] handoff heatmap not finite")
    dev = torch.device("cuda")
    image_t = torch.from_numpy(normalized).to(dev)
    seg_t = torch.from_numpy(np.asarray(segments, np.int32)).to(dev)
    firsts = torch.from_numpy(hout.firsts).to(dev)
    masked = masked_batch(image_t, seg_t, firsts, hout.width, torch.bfloat16)
    if not torch.equal(masked, masked_batch_plain(image_t, seg_t, firsts, hout.width,
                                                  torch.bfloat16)):
        raise AssertionError("[train] B1 differs from its plain version on the handoff's masks")
    worst = 0.0
    for batch_x in (masked, image_t[None].to(torch.bfloat16)):
        for x_in, chain in chain_inputs(engine.model, batch_x):
            block_err, _, _ = check_chain(x_in.contiguous(), chain, B2_TOL)
            worst = max(worst, block_err)
    del masked
    rates = {}
    for name, e in (("trained", engine), ("random", random_engine)):
        e.eval_window_masks(normalized, segments, hout.firsts, hout.width, target)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            e.eval_window_masks(normalized, segments, hout.firsts, hout.width, target)
            ts.append(time.perf_counter() - t0)
        rates[name] = HANDOFF_MASKS / float(np.median(ts))
    folded_bn = sum(1 for k in engine.variables if k.endswith("running_var")
                    and not torch.allclose(engine.variables[k].float(),
                                           torch.ones_like(engine.variables[k].float())))
    log(f"[train] handoff: model_best -> --ckpt -> bf16 engine (B2's weights folded from "
        f"{folded_bn} trained BatchNorm statistics), {HANDOFF_MASKS} window masks: target "
        f"{target}, survived {int(hout.eval.survived.sum())}/{HANDOFF_MASKS}; launches "
        f"{json.dumps(by_path['train_handoff'])}; B1 bit-exact at K={HANDOFF_MASKS}; B2 block by "
        f"block on the trained folded weights at B={HANDOFF_MASKS} and 1, worst block err "
        f"{worst:.4g} (tol {B2_TOL} x max|plain|); window evals/s trained {rates['trained']:.1f}"
        f", random weights {rates['random']:.1f} (median of 5)")
    del engine, random_engine
    torch.cuda.empty_cache()

    # 5. the generators: train -> gp-data from the trained checkpoint
    from network_interpretation_imagenet_tpu_torch.cli import generate_gp_training_data_cifar
    from network_interpretation_imagenet_tpu_torch.cli import generate_gp_training_data_mnist

    for name, gen, mode, extra, ckpt_dir in (
            ("mnist", generate_gp_training_data_mnist, "train-nn", ["--epochs", "1"],
             "saved_checkpoints/mnist"),
            ("cifar", generate_gp_training_data_cifar, "train",
             ["--epochs", "1", "-d", "110", "--death-mode", "linear"],
             "saved_checkpoints/cifar10+-resnet-110")):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            counted(by_path, f"train_gen_{name}_train",
                    lambda: quiet(lambda: gen.main(["--mode", mode, "--out", tmp] + extra)), 0, 0)
            train_s = time.perf_counter() - t0
            with open(f"{tmp}/{name}_train_result.json") as f:
                trained = json.load(f)
            args = gen.parse_args(["--synthetic", "--ckpt", f"{tmp}/{ckpt_dir}/model_best",
                                   "--out", f"{tmp}/gp"] + extra[2:])
            t0 = time.perf_counter()
            payload, res = counted(by_path, f"train_gen_{name}",
                                   lambda: quiet(lambda: gen.compute(args)), 0, 0)
            gp_s = time.perf_counter() - t0
            if not (np.isfinite(res["out"].heatmap).all()
                    and payload["num_segments"] == res["out"].num_segments):
                raise AssertionError(f"[train] {name} gp-data payload {payload}")
            windows = ""
            if name == "mnist":   # B1 at 28x28x1 on the trained CNN: 1,000 window masks
                e = quiet(lambda: common.build_engine(args))
                image = common.resolve_image(args)[0]
                w = counted(by_path, "train_gen_mnist_windows", lambda: random_window_saliency(
                    e, image, res["segments"], num_samples=1000, seed=SEED, target=res["target"]),
                    1, 0)
                windows = (f"; 1,000 window masks on its engine survived "
                           f"{int(w.eval.survived.sum())}, launches "
                           + json.dumps(by_path["train_gen_mnist_windows"]))
        log(f"[train] {name}: --mode {mode} {' '.join(extra)} {train_s:.2f} s ("
            + json.dumps({k: v for k, v in trained.items() if k not in ("history", "save_dir")})
            + f"), then gp-data from its model_best {gp_s:.2f} s: {args.num_mask_samples} "
            f"knockouts of M={args.num_masked_superpixels}, survived "
            f"{payload['correct_pred_count']}; launches {json.dumps(by_path[f'train_gen_{name}'])}"
            + windows)
    log(f"[train] phase {time.perf_counter() - t_phase:.1f} s")


def serve_phase(engine, image, segments, target, smi, by_path):
    """[serve]: the serving stack on the card (see the module docstring, 24),
    its artifacts in a temporary directory removed afterwards."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="serve_")
    try:
        serve_checks(tmp, engine, image, segments, target, smi, by_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def serve_checks(tmp, engine, image, segments, target, smi, by_path):
    import os
    import re
    import signal
    import threading

    import torch

    from network_interpretation_imagenet_tpu_torch import serving
    from network_interpretation_imagenet_tpu_torch.config import BOConfig
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.ops import aggregate, masking
    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import (
        masked_batch,
        masked_batch_plain,
    )
    from network_interpretation_imagenet_tpu_torch.saliency import gradient as g
    from network_interpretation_imagenet_tpu_torch.saliency import xrai
    from network_interpretation_imagenet_tpu_torch.saliency.bo_pipeline import bo_window_saliency
    from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
    from network_interpretation_imagenet_tpu_torch.saliency.sanity import spearman_abs
    from network_interpretation_imagenet_tpu_torch.serving_client import (
        SaliencyClient,
        _array_fields,
    )
    from network_interpretation_imagenet_tpu_torch.serving_http import make_http_server
    from network_interpretation_imagenet_tpu_torch.utils.convert import from_jax, msgpack_loads

    t_phase = time.perf_counter()
    d101, d50 = f"{tmp}/resnet101", f"{tmp}/resnet50"
    s = int(segments.max()) + 1
    width = int(0.4 * s)

    # 1. Export ResNet-101 bf16 (window, knockout, attribution and BO in one
    # directory) and ResNet-50 f32 at bucket 32; the weights read back bit for bit.
    t0 = time.perf_counter()
    serving.export_engine(engine, d101, batch_sizes=SERVE_BUCKETS, knockout_m=SERVE_KNOCKOUT_M,
                          attribution=SERVE_ATTR, attribution_batches=(SERVE_N,))
    bo_manifest = serving.export_bo_engine(engine, d101, candidate_buckets=SERVE_BO_BUCKETS,
                                           image_batches=(SERVE_N,), include_weights=False)
    export_s = time.perf_counter() - t0
    with open(f"{d101}/{serving.WEIGHTS}", "rb") as f:
        blob = f.read()
    back = from_jax(msgpack_loads(blob), engine.bundle.module)
    if not all(torch.equal(back[k], v.cpu()) for k, v in engine.variables.items()
               if not k.endswith("num_batches_tracked")):
        raise AssertionError("[serve] variables.msgpack does not read back bit for bit")
    b50 = create_model("resnet50", "imagenet", dtype=torch.float32)
    e50 = SaliencyEngine(b50, b50.init(SEED), mask_batch=SERVE_F32_BUCKET,
                         compute_dtype=torch.float32, device="cuda")
    serving.export_engine(e50, d50, batch_sizes=(SERVE_F32_BUCKET,), attribution=("gradient",),
                          attribution_batches=(SERVE_N,))

    # 2. Load both behind one server (a registry: /m/r50/... is the f32 one) and warm up.
    httpd = make_http_server({"r101": d101, "r50": d50}, "127.0.0.1", 0, dynamic_batch=True,
                             device="cuda")
    t0 = time.perf_counter()
    programs = sum(svc.warmup() for svc in httpd.services.values())
    warm_s = time.perf_counter() - t0
    log(f"[serve] {smi}: exported ResNet-101 bf16 (buckets {list(SERVE_BUCKETS)}, knockout_m "
        f"{SERVE_KNOCKOUT_M}, attribution {list(SERVE_ATTR)} with image batch {SERVE_N}, BO "
        f"candidate buckets {bo_manifest['candidate_buckets']} and image batch {SERVE_N}) in "
        f"{export_s:.2f} s, {len(blob)} bytes of weights read back bit for bit; warmup of "
        f"{programs} programs (both models) in {warm_s:.2f} s")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    host, port = httpd.server_address[:2]
    client = SaliencyClient(host, port)
    svc = httpd.services["r101"]
    srv, bo = svc.engine_server, svc.bo_server

    def heat_of(resp):
        return np.asarray(resp["heatmap"], np.float32)

    # Every served B1 launch of the checks below keeps its inputs and output,
    # to be held against the plain version: the buckets' padded starts on the
    # synthetic image's own segments, as the service builds them.
    served_b1, real_b1 = [], serving.masked_batch

    def recording_b1(image_t, seg_t, firsts_t, width_, dt=torch.bfloat16, out=None):
        got = real_b1(image_t, seg_t, firsts_t, width_, dt, out=out)
        served_b1.append((image_t, seg_t, firsts_t.clone(), width_, dt, got.clone()))
        return got

    serving.masked_batch = recording_b1
    try:
        # 3. Every endpoint through the client, held against the in-process calls.
        firsts = masking.sample_window_starts_host(SEED, SERVE_EVAL_K, s, width)
        ev = counted(by_path, "serve_eval_windows",
                     lambda: client.eval_windows(image, segments, firsts, width, target), 1, 4)
        res = srv.eval_window_masks(image, segments, firsts, width, target)
        if not (ev["preds"] == res.preds.tolist() and ev["prob_target"] ==
                res.prob_target.tolist() and ev["survived"] == res.survived.tolist()):
            raise AssertionError("[serve] /eval_windows differs from the server's own call")
        with torch.inference_mode():    # served bf16 logits vs the library's plan in its chunks
            got = torch.from_numpy(srv.logits_for_windows(image, segments, firsts, width))
            img_t = torch.from_numpy(image).cuda()
            seg_t = torch.from_numpy(segments).cuda()
            want = torch.cat([engine.model(masked_batch(
                img_t, seg_t, torch.from_numpy(firsts[o:o + MASK_BATCH]).cuda(), width,
                torch.bfloat16)).float().cpu() for o in range(0, len(firsts), MASK_BATCH)])
        logit_err = (got - want).abs().max().item()
        logit_scale = want.abs().max().item()
        lib = engine.eval_window_masks(image, segments, firsts, width, target)
        if not logit_err <= SERVE_LOGIT_TOL * logit_scale:
            raise AssertionError(f"[serve] bucket-1024 logits vs the library's: {logit_err}")
        log(f"[serve] /eval_windows {SERVE_EVAL_K} starts (bucket 1024): equal to the server's "
            f"own call; logits vs the engine's plan in chunks of {MASK_BATCH}: max err "
            f"{logit_err:.4g} (max |logit| {logit_scale:.4g}, tol {SERVE_LOGIT_TOL}x); preds "
            "agree with "
            f"engine.eval_window_masks on {float(np.mean(lib.preds == res.preds)):.4f}; launches "
            + json.dumps(by_path["serve_eval_windows"]))

        w = counted(by_path, "serve_explain_window",
                    lambda: client.explain(image, segments=segments, mode="window", seed=SEED),
                    2, 8)
        w_firsts = masking.sample_window_starts_host(SEED, 100, s, width)
        w_target = int(srv.logits_for_windows(image, segments, np.zeros(1, np.int32), s)[0]
                       .argmax())   # the server's inference: the full-width window, bucket 32
        w_res = srv.eval_window_masks(image, segments, w_firsts, width, w_target)
        w_heat = aggregate.summed_superpixel_labels_np(segments, w_firsts, width, w_res.survived)
        lib_res = engine.eval_window_masks(image, segments, w_firsts, width, w_target)
        if not (np.array_equal(heat_of(w), w_heat) and w["target"] == w_target):
            raise AssertionError("[serve] window /explain differs from the in-process path")
        ko = counted(by_path, "serve_explain_knockout",
                     lambda: client.explain(image, segments=segments, mode="knockout",
                                            seed=SEED, target=target,
                                            num_knockout=SERVE_KNOCKOUT_M), 0, 4)
        ids = masking.sample_knockout_ids_host(SEED, 100, SERVE_KNOCKOUT_M, s)
        ko_res = srv.eval_knockout_masks(image, segments, ids, target)
        if not np.array_equal(heat_of(ko), aggregate.summed_knockout_labels_np(
                segments, ids, ko_res.survived)):
            raise AssertionError("[serve] knockout /explain differs from the in-process path")
        kv = counted(by_path, "serve_eval_knockouts",
                     lambda: client.eval_knockouts(image, segments, ids, target), 0, 4)
        if kv["preds"] != ko_res.preds.tolist():
            raise AssertionError("[serve] /eval_knockouts differs from the server's own call")
        log(f"[serve] window /explain (target inferred, 100 masks) and knockout /explain "
            f"(M={SERVE_KNOCKOUT_M}) equal the in-process path (inferred target {w_target}, "
            f"predict_one's {target}); window labels vs "
            f"engine.eval_window_masks agree on {float(np.mean(lib_res.survived == w_res.survived)):.4f}; "
            "launches " + json.dumps({k: by_path[k] for k in (
                "serve_explain_window", "serve_explain_knockout", "serve_eval_knockouts")}))

        b = counted(by_path, "serve_explain_bo",
                    lambda: client.explain(image, segments=segments, seed=SEED, target=target),
                    0, 0)
        out, tr = bo.explain(image, segments, seed=SEED, target=target)
        lib_out, lib_tr = bo_window_saliency(engine, image, segments, BOConfig(), seed=SEED,
                                             target=target)
        yp_err = float(np.abs(tr.yp - lib_tr.yp).max())
        if not (b["xp"] == tr.xp.tolist() and np.array_equal(heat_of(b), out.heatmap)
                and np.array_equal(tr.xp, lib_tr.xp) and yp_err <= 1e-6):
            raise AssertionError(f"[serve] BO /explain {b['xp']} vs in-process {tr.xp.tolist()} "
                                 f"vs bo_window_saliency {lib_tr.xp.tolist()}")
        run = bo.runners[(1, int(bo_manifest["candidate_buckets"][0]))]
        (graph, _, _), = (e for e in run.graphs.values() if e is not None)
        _, _, _, groups = replay_trace(graph)
        images = [image] + [image * (0.5 + 0.1 * i) for i in range(1, SERVE_N)]
        eb = counted(by_path, "serve_explain_batch",
                     lambda: client.explain_batch(np.stack(images), segments=np.stack(
                         [segments] * SERVE_N), seeds=list(range(SERVE_N)),
                         targets=[target] * SERVE_N), 0, 0)
        many, calls = bo.explain_many(images, [segments] * SERVE_N,
                                      per_image_seeds=list(range(SERVE_N)),
                                      targets=[target] * SERVE_N)
        if calls != 1 or [r["xp"] for r in eb] != [t.xp.tolist() for _, t in many]:
            raise AssertionError("[serve] /explain_batch differs from explain_many")
        agree, score = 0, 0.0
        for i, (o, t) in enumerate(many):
            agree += t.xp.tolist() == bo.explain(images[i], segments, seed=i,
                                                 target=target)[1].xp.tolist()
            r = engine.eval_window_masks(images[i], segments, t.xp, o.width, target)
            score = max(score, float(np.abs(r.prob_target - t.yp).max()))
            if not np.array_equal(r.survived, t.survived):
                raise AssertionError(f"[serve] /explain_batch image {i}: labels vs the engine's")
        if score > BO_SCORE_TOL:
            raise AssertionError(f"[serve] /explain_batch scores vs the engine's: {score}")
        (bgraph, _, _), = (e for e in bo.runners[(SERVE_N, int(bo_manifest["candidate_buckets"][0]))]
                           .graphs.values() if e is not None)
        _, _, _, bgroups = replay_trace(bgraph)
        log(f"[serve] BO /explain (replay) equals the in-process call and bo_window_saliency "
            f"(yp err {yp_err:.3g}); its replay trace by kernel " + json.dumps(
                {k: round(v, 3) for k, v in groups.items()})
            + f"; /explain_batch N={SERVE_N} equals explain_many (1 device call), "
            f"{agree}/{SERVE_N} traces equal to single explains, scores vs the engine on the "
            f"same starts max err {score:.3g}; its replay trace " + json.dumps(
                {k: round(v, 3) for k, v in bgroups.items()}) + "; launches "
            + json.dumps({k: by_path[k] for k in ("serve_explain_bo", "serve_explain_batch")}))

        cfg, bl, v = srv.attribution_config, engine.bundle.logits, engine.variables

        def library_map(method):
            """The library's call on the main engine with the artifact's settings."""
            if method == "gradient":
                return g.input_gradient(bl, v, image, target)
            if method == "integrated":
                return g.integrated_gradients(bl, v, image, target, steps=cfg["ig_steps"])
            if method == "gradcam":
                return g.gradcam(engine.bundle, v, image, target, layer=cfg["gradcam_layer"])
            if method == "occlusion":
                return g.occlusion_map(engine.folded_logits, v, image, target,
                                       patch=cfg["occ_patch"], stride=cfg["occ_stride"],
                                       batch=cfg["mask_batch"], compute_dtype=torch.bfloat16)
            if method == "rise":
                return g.rise_map(engine.folded_logits, v, image, target,
                                  num_masks=cfg["rise_masks"], grid=cfg["rise_grid"],
                                  keep_prob=cfg["rise_keep"], batch=cfg["mask_batch"], seed=SEED,
                                  compute_dtype=torch.bfloat16)
            return xrai.xrai_attribution(bl, v, image, target, steps=srv.xrai_config["steps"])

        attr_errs = {}
        for method in SERVE_ATTR:
            want_b2 = SERVE_ATTR_B2.get(method, 0)
            a = counted(by_path, f"serve_attr_{method}",
                        lambda: client.attribute(image, method, target=target, seed=SEED),
                        0, want_b2)
            lib_map = library_map(method).detach().cpu().numpy()
            got_map = np.asarray(a["attribution"] if method == "xrai" else a["heatmap"],
                                 np.float32)
            err = rel_err(got_map, lib_map)
            attr_errs[method] = err
            exact = method in ("occlusion", "rise")
            if not (np.isfinite(got_map).all() and (err == 0.0 if exact else
                                                    err <= ATTR_B2_TOL)):
                raise AssertionError(f"[serve] /attribute {method}: err {err} x max |map|")
        ab = counted(by_path, "serve_attribute_batch",
                     lambda: client.attribute_batch(np.stack(images), "gradient",
                                                    targets=[target] * SERVE_N), 0, 0)
        ab_lib, _ = srv.attribute_many(np.stack(images), [target] * SERVE_N, "gradient")
        ab_err = max(rel_err(heat_of(r), ab_lib[i]) for i, r in enumerate(ab))
        # Witnesses of the bf16 batch's maps, image by image: image i alone at
        # batch 1 (other cuDNN plans), image i repeated N times (the batch's
        # own plans: its row must equal the batch's), and the f32 map of the
        # same weights (what both bf16 maps approximate).
        b32 = create_model("resnet101", "imagenet", dtype=torch.float32)
        wit = {"single": [], "same_plan": [], "single_f32": [], "batch_f32": [],
               "rho_single": [], "rho_single_f32": [], "rho_batch_f32": []}
        for i, r in enumerate(ab):
            got_i = heat_of(r)
            single = srv.attribute(images[i], target, "gradient")
            same_plan = srv.attribute_many(np.stack([images[i]] * SERVE_N),
                                           [target] * SERVE_N, "gradient")[0][0]
            f32_map = g.input_gradient(b32.logits, v, images[i], target).detach().cpu().numpy()
            for key, val in (("single", rel_err(got_i, single)),
                             ("same_plan", rel_err(got_i, same_plan)),
                             ("single_f32", rel_err(single, f32_map)),
                             ("batch_f32", rel_err(got_i, f32_map)),
                             ("rho_single", spearman_abs(got_i, single)),
                             ("rho_single_f32", spearman_abs(single, f32_map)),
                             ("rho_batch_f32", spearman_abs(got_i, f32_map))):
                wit[key].append(float(val))
        log(f"[serve] /attribute vs the library call on the engine (x max |map|; occlusion and "
            f"rise exactly): " + json.dumps({k: float(f"{v:.3g}") for k, v in attr_errs.items()})
            + f"; /attribute_batch N={SERVE_N} (bf16 gradient) vs attribute_many {ab_err:.3g}; "
            "per image, max err x max |map| vs: the same image at batch 1, the same image "
            f"repeated {SERVE_N} times, and the f32 map (batch-1 map vs f32 beside it); "
            "Spearman |rank| batch vs batch 1, batch 1 vs f32, batch vs f32: " + json.dumps(
                {k: [float(f"{x:.4g}") for x in xs] for k, xs in wit.items()})
            + "; launches " + json.dumps({m: by_path[f"serve_attr_{m}"] for m in SERVE_ATTR}))
        if not ab_err <= ATTR_B2_TOL:
            raise AssertionError(f"[serve] /attribute_batch vs attribute_many: {ab_err}")
        if max(wit["same_plan"]) != 0.0:
            raise AssertionError("[serve] a bf16 /attribute_batch row differs from its image's "
                                 f"batch at the same plans: {wit['same_plan']}")
        # The gap to batch 1 is bf16 rounding under other cuDNN plans: the
        # batch's maps rank pixels like the f32 map as closely as batch 1's do.
        if not (max(wit["single"]) <= SERVE_BF16_ATTR_TOL
                and min(wit["rho_single"] + wit["rho_batch_f32"]) >= SERVE_BF16_ATTR_RHO):
            raise AssertionError(f"[serve] bf16 /attribute_batch vs per-image maps beyond "
                                 f"{SERVE_BF16_ATTR_TOL}, or Spearman vs per-image or f32 "
                                 f"maps below {SERVE_BF16_ATTR_RHO}: {wit}")

        # The f32 artifact (ResNet-50, bucket 32) through the registry: labels and
        # heatmaps exactly against the library engine at the same chunks.
        c50 = SaliencyClient(host, port, model="r50")
        f_firsts = masking.sample_window_starts_host(SEED, 3 * SERVE_F32_BUCKET, s, width)
        f_ev = counted(by_path, "serve_f32_eval_windows",
                       lambda: c50.eval_windows(image, segments, f_firsts, width, 1), 3, 12)
        f_lib = e50.eval_window_masks(image, segments, f_firsts, width, 1)
        f_prob = float(np.abs(np.asarray(f_ev["prob_target"]) - f_lib.prob_target).max())
        f_w = c50.explain(image, segments=segments, mode="window", seed=SEED,
                          num_samples=3 * SERVE_F32_BUCKET)
        f_wres = e50.eval_window_masks(image, segments, f_firsts, width, f_w["target"])
        if not (f_ev["preds"] == f_lib.preds.tolist() and f_prob <= 1e-6
                and f_w["target"] == e50.predict_one(image)[0]
                and np.array_equal(heat_of(f_w), aggregate.summed_superpixel_labels_np(
                    segments, f_firsts, width, f_wres.survived))):
            raise AssertionError("[serve] the f32 artifact differs from the library engine")
        f_ab = c50.attribute_batch(np.stack(images), "gradient", targets=[1] * SERVE_N)
        f_ab_err = max(rel_err(heat_of(r), heat_of(c50.attribute(images[i], "gradient",
                                                                 target=1)))
                       for i, r in enumerate(f_ab))
        if not f_ab_err <= SERVE_F32_ATTR_TOL:
            raise AssertionError(f"[serve] f32 /attribute_batch vs per-image: {f_ab_err}")
        log(f"[serve] f32 ResNet-50 artifact (/m/r50/, bucket {SERVE_F32_BUCKET}): /eval_windows "
            f"preds and window /explain target and heatmap equal the library engine's, "
            f"prob err {f_prob:.3g}; /attribute_batch N={SERVE_N} vs per-image /attribute "
            f"{f_ab_err:.3g} x max |map| (tol {SERVE_F32_ATTR_TOL}); launches "
            + json.dumps(by_path["serve_f32_eval_windows"]))
        serving.masked_batch = real_b1
        b1_seen = {}
        for image_t, seg_t, f_t, wd, dt, got in served_b1:
            for odt in (torch.bfloat16, torch.float32):   # the served dtype and the other
                ker = got if odt == dt else real_b1(image_t, seg_t, f_t, wd, odt)
                if not torch.equal(ker, masked_batch_plain(image_t, seg_t, f_t, wd, odt)):
                    raise AssertionError(f"[serve] B1 {odt} K={len(f_t)} (served in {dt}): "
                                         "kernel differs from its plain version")
            key = f"K={len(f_t)} {str(dt).split('.')[-1]}"
            b1_seen[key] = b1_seen.get(key, 0) + 1
        missing = {f"K={k} bfloat16" for k in SERVE_B1_KS} - set(b1_seen)
        if missing or "K=32 float32" not in b1_seen:
            raise AssertionError(f"[serve] the checks made no served B1 launch at {missing}")
        log("[serve] every B1 launch of the checks above, as served (launches by K and dtype "
            + json.dumps(b1_seen) + "), bit-exact against masked_batch_plain in bf16 and f32 "
            "on the synthetic image's segments and the buckets' padded starts")
        served_b1.clear()

        # 7. p50 per endpoint (warm): the client's, the service call on the body the
        # client sends (decode, device work, encode; no HTTP), and the device call alone.
        def p50(fn, reps=SERVE_REQS):
            fn()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            return float(np.median(ts)) * 1e3

        img_f = _array_fields("image", image, np.float32)
        seg_f = _array_fields("segments", segments, np.int32)
        imgs_f = _array_fields("images", np.stack(images), np.float32)
        one = {**img_f, **seg_f, "seed": SEED, "target": target}
        endpoints = {   # name: (client call, service call, device call, requests)
            "/eval_windows 1000": (
                lambda: client.eval_windows(image, segments, firsts, width, target),
                lambda: svc.eval_windows({**img_f, **seg_f, "width": width, "target": target,
                                          **_array_fields("firsts", firsts, np.int32)}),
                lambda: srv.eval_window_masks(image, segments, firsts, width, target),
                SERVE_REQS),
            "/explain window 100": (
                lambda: client.explain(image, segments=segments, mode="window", seed=SEED,
                                       target=target),
                lambda: svc.explain({**one, "mode": "window"}),
                lambda: srv.eval_window_masks(image, segments, w_firsts, width, target),
                SERVE_REQS),
            "/explain knockout 100": (
                lambda: client.explain(image, segments=segments, mode="knockout", seed=SEED,
                                       target=target, num_knockout=SERVE_KNOCKOUT_M),
                lambda: svc.explain({**one, "mode": "knockout",
                                     "num_knockout": SERVE_KNOCKOUT_M}),
                lambda: srv.eval_knockout_masks(image, segments, ids, target), SERVE_REQS),
            "/explain bo": (
                lambda: client.explain(image, segments=segments, seed=SEED, target=target),
                lambda: svc.explain(dict(one)),
                lambda: bo.explain(image, segments, seed=SEED, target=target), SERVE_REQS),
            f"/explain_batch N={SERVE_N}": (
                lambda: client.explain_batch(np.stack(images), segments=np.stack(
                    [segments] * SERVE_N), targets=[target] * SERVE_N),
                lambda: svc.explain_batch({**imgs_f, **_array_fields(
                    "segments", np.stack([segments] * SERVE_N), np.int32),
                    "targets": [target] * SERVE_N}),
                lambda: bo.explain_many(images, [segments] * SERVE_N,
                                        per_image_seeds=list(range(SERVE_N)),
                                        targets=[target] * SERVE_N), SERVE_REQS),
            f"/attribute_batch gradient N={SERVE_N}": (
                lambda: client.attribute_batch(np.stack(images), "gradient",
                                               targets=[target] * SERVE_N),
                lambda: svc.attribute_batch({**imgs_f, "method": "gradient",
                                             "targets": [target] * SERVE_N}),
                lambda: srv.attribute_many(np.stack(images), [target] * SERVE_N, "gradient"),
                5),
        }
        for method in SERVE_ATTR:
            endpoints[f"/attribute {method}"] = (
                lambda m=method: client.attribute(image, m, target=target),
                lambda m=method: svc.attribute({**img_f, "method": m, "target": target}),
                (lambda m=method: srv.xrai(image, target)) if method == "xrai" else
                (lambda m=method: srv.attribute(image, target, m)), 5)
        lat = {name: [p50(f, n) for f in fns] for name, (*fns, n) in endpoints.items()}
        # Why one device thread: the same device calls from a fresh thread per
        # call (the per-request handler threads' way) and on the device thread.
        def fresh(fn):
            box = []
            t = threading.Thread(target=lambda: box.append(fn()))
            t.start()
            t.join()
            return box[0]

        thread_calls = {
            "predict B=1": lambda: srv.engine.predict(image[None]),
            "window 100": lambda: srv.eval_window_masks(image, segments, w_firsts, width,
                                                        target),
            "occlusion": lambda: srv.attribute(image, target, "occlusion"),
        }
        threads_ms = {name: [p50(lambda: run(fn), 10) for run in (
            fresh, svc._device_thread.run)] for name, fn in thread_calls.items()}
        log(f"[serve] {smi}: device calls from a fresh thread per call / on the device thread, "
            "p50 ms: " + json.dumps({k: [round(v, 2) for v in vs]
                                     for k, vs in threads_ms.items()}))
        snap = client.metrics()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        client.eval_windows(image, segments, firsts, width, target)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[serve] {smi}: p50 ms (warm; {SERVE_REQS} requests, attribution 5) as client / "
            "service call (no HTTP) / device call: " + json.dumps(
                {k: [round(v, 2) for v in vs] for k, vs in lat.items()})
            + f"; BO /explain: HTTP + JSON add {lat['/explain bo'][0] - lat['/explain bo'][2]:.2f}"
            f" ms to the in-process replay; peak device memory at bucket 1024 {peak:.2f} GiB")
        log(f"[serve] {smi}: /metrics p50 ms " + json.dumps(
            {k: round(v["latency_seconds"]["p50"] * 1e3, 2)
             for k, v in snap["endpoints"].items() if "latency_seconds" in v})
            + "; device_call_ms " + json.dumps(snap.get("device_call_ms", {}))
            + "; dynamic_batch " + json.dumps(snap.get("dynamic_batch", {})))
    finally:
        serving.masked_batch = real_b1
        served_b1.clear()
        httpd.shutdown()
        httpd.server_close()

    # 4. Concurrent clients with dynamic batching on a cold server: the first
    # BO groups run eagerly and capture while window and eval requests wait
    # on the device lock; every response equals its serial one.
    cold = make_http_server(d101, "127.0.0.1", 0, dynamic_batch=True, device="cuda")
    threading.Thread(target=cold.serve_forever, daemon=True).start()
    host, port = cold.server_address[:2]
    serial_window = heat_of(w)
    serial_ev = ev
    solo = {i: bo.explain(image, segments, seed=100 + i, target=target)[1].xp.tolist()
            for i in range(SERVE_CLIENTS)}
    grouped = {i: bo.explain_batch([image], [segments], per_image_seeds=[100 + i],
                                   targets=[target])[0][1].xp.tolist()
               for i in range(SERVE_CLIENTS)}
    results, errors = {}, []

    def worker(i):
        try:
            c = SaliencyClient(host, port)
            results[i] = (c.explain(image, segments=segments, seed=100 + i, target=target),
                          c.explain(image, segments=segments, mode="window", seed=SEED),
                          c.eval_windows(image, segments, firsts, width, target))
            c.close()
        except Exception as e:   # every error fails the phase below
            errors.append((i, repr(e)))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    conc_s = time.perf_counter() - t0
    stats = dict(cold.service._batcher.stats)
    captured = sum(e is not None for run in cold.service.bo_server.runners.values()
                   for e in run.graphs.values())
    cold.shutdown()
    cold.server_close()
    if errors or len(results) != SERVE_CLIENTS:
        raise AssertionError(f"[serve] concurrent clients failed: {errors}")
    how = {"single": 0, "coalesced": 0}
    for i, (rb, rw, re_) in results.items():
        how["single"] += rb["xp"] == solo[i]
        how["coalesced"] += rb["xp"] == grouped[i]
        if rb["xp"] not in (solo[i], grouped[i]):
            raise AssertionError(f"[serve] concurrent BO /explain {i}: {rb['xp']} is neither its "
                                 f"single ({solo[i]}) nor its batched ({grouped[i]}) answer")
        if not (np.array_equal(heat_of(rw), serial_window) and re_ == serial_ev):
            raise AssertionError(f"[serve] concurrent client {i}: window or eval response "
                                 "differs from the serial one")
    log(f"[serve] {SERVE_CLIENTS} concurrent clients x (BO /explain, window /explain, "
        f"/eval_windows) on a cold dynamic-batch server: no error, every response its serial "
        f"one (BO traces equal to the single call's: {how['single']}, to the coalesced call's "
        f"at N={SERVE_N}: {how['coalesced']}), in {conc_s:.2f} s; "
        f"batcher {json.dumps(stats)}; {captured} BO graphs captured while serving")

    # 5. The CLIs as subprocesses on a small net: export --bo, serve, one
    # query, SIGTERM.
    small = f"{tmp}/mnist"
    env = dict(os.environ, PYTHONPATH=os.getcwd() + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    exp = subprocess.run([sys.executable, "-m", f"{PKG}.cli.export_serving", "--arch",
                          "mnist_cnn", "--dataset", "mnist", "--dtype", "float32",
                          "--batch-sizes", "32", "--bo", "--candidate-buckets", "16",
                          "--bo-image-batches", "2", "--out", small],
                         capture_output=True, text=True, env=env)
    if exp.returncode != 0:
        raise AssertionError(f"[serve] cli.export_serving: rc {exp.returncode}: "
                             f"{exp.stderr[-2000:]}")
    proc = subprocess.Popen([sys.executable, "-m", f"{PKG}.cli.serve", "--artifact", small,
                             "--port", "0", "--warmup"], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    lines = []
    try:
        url = None
        deadline = time.time() + 120
        while url is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line.rstrip())
            m = re.search(r"http://([^:]+):(\d+)", line)
            url = (m.group(1), int(m.group(2))) if m else None
        if url is None:
            raise AssertionError("[serve] cli.serve printed no URL: " + " | ".join(lines))
        mnist_img = np.random.RandomState(SEED).rand(28, 28, 1).astype(np.float32)
        mnist_seg = ((np.arange(28)[:, None] // 7) * 4 + np.arange(28)[None, :] // 7
                     ).astype(np.int32)
        q = SaliencyClient(*url).explain(mnist_img, segments=mnist_seg, seed=SEED)
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
    finally:
        with contextlib.suppress(ProcessLookupError):
            if proc.poll() is None:
                proc.kill()
    if proc.returncode != 0 or "draining" not in rest or len(q["xp"]) != 13:
        raise AssertionError(f"[serve] cli.serve: rc {proc.returncode}, output {rest!r}")
    log(f"[serve] cli.export_serving --bo and cli.serve --warmup as subprocesses (MNIST CNN, "
        f"f32): {lines[0] if lines else ''}; one BO /explain answered ({len(q['xp'])} "
        f"evaluations), SIGTERM drained, exit 0, in {time.perf_counter() - t0:.2f} s")
    log(f"[serve] phase {time.perf_counter() - t_phase:.1f} s")


def _parallel_spawn(argvs, timeout):
    """Runs ``--parallel-worker`` processes of this script, one per argv, and
    returns the JSON line each prints last; a worker that fails or outlives
    ``timeout`` fails the phase (and every worker is stopped)."""
    import os

    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-worker",
                               *argv], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"[parallel] worker {p.args[3:]} exited {p.returncode}:\n"
                                 f"{out[-2000:]}\n{err[-6000:]}")
    return [json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
            for out, _ in outs]


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _launches():
    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import bottleneck_chain
    from network_interpretation_imagenet_tpu_torch.ops.epilogue_nhwc import epilogue_nhwc
    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import masked_batch

    return {"masked_batch": masked_batch.launches, "bottleneck_chain": bottleneck_chain.launches,
            "epilogue_nhwc": epilogue_nhwc.launches}


def _reset_launches():
    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import bottleneck_chain
    from network_interpretation_imagenet_tpu_torch.ops.epilogue_nhwc import epilogue_nhwc
    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import masked_batch

    masked_batch.launches = 0
    bottleneck_chain.launches = 0
    epilogue_nhwc.launches = 0


def _dense_e1(where, launches):
    """Raises unless ``launches`` (of dense Bottleneck ResNets only) hold
    E1_PER_DENSE_FORWARD E1 launches for each 4 B2 launches."""
    b2, e1 = launches["bottleneck_chain"], launches["epilogue_nhwc"]
    if b2 % 4 or e1 != b2 // 4 * E1_PER_DENSE_FORWARD:
        raise AssertionError(f"{where}: B2 {b2} and E1 {e1} launches, want "
                             f"{E1_PER_DENSE_FORWARD} E1 a forward of 4 B2")


def _parallel_images(seeds):
    """Normalized synthetic images, their Felzenszwalb segments and displays."""
    import torch

    from network_interpretation_imagenet_tpu_torch.config import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        SegmentConfig,
    )
    from network_interpretation_imagenet_tpu_torch.ops.preprocess import (
        normalize,
        to_display_uint8,
    )
    from network_interpretation_imagenet_tpu_torch.segment.common import segment_image

    imgs, segs = [], []
    for seed in seeds:
        u8, _ = synthetic_image(seed)
        x = normalize(torch.from_numpy(u8.astype(np.float32) / 255.0), IMAGENET_MEAN,
                      IMAGENET_STD).numpy()
        imgs.append(x)
        segs.append(np.asarray(segment_image(to_display_uint8(torch.from_numpy(x)).numpy(),
                                             SegmentConfig()), np.int32))
    return np.stack(imgs), segs


def _agree(got, want):
    """(survive agreement, max |prob_target difference|) of two outcome sets."""
    return (float(np.mean(np.asarray(got[0]) == np.asarray(want[0]))),
            float(np.abs(np.asarray(got[1], np.float64) - np.asarray(want[1])).max()))


def parallel_world1(port):
    """A world of 1 on NCCL: the four sharded evals at full width against
    the engine, the f32 check, and evals/s. Prints one JSON line."""
    import torch
    import torch.distributed as dist

    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.ops import masking
    from network_interpretation_imagenet_tpu_torch.parallel import (
        make_mesh,
        multihost,
        sharded_knockout_eval,
        sharded_knockout_eval_multi,
        sharded_window_eval,
        sharded_window_eval_multi,
    )
    from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    assert multihost.initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    mesh = make_mesh()
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "mesh": list(mesh.shape)}
    bundle = create_model("resnet101", "imagenet", dtype=torch.bfloat16)
    engine = SaliencyEngine(bundle, bundle.init(SEED), mask_batch=MASK_BATCH)
    imgs, segs = _parallel_images(range(SEED + 200, SEED + 200 + PARALLEL_IMAGES))
    targets = engine.predict(imgs).argmax(axis=1).astype(np.int32)
    ss = [int(sg.max()) + 1 for sg in segs]
    widths = np.asarray([int(0.4 * s) for s in ss], np.int32)
    img, seg, s, width, target = imgs[0], segs[0], ss[0], int(widths[0]), int(targets[0])
    firsts = masking.sample_window_starts_host(SEED, NUM_SAMPLES, s, width)
    ids = masking.sample_knockout_ids_host(SEED, NUM_SAMPLES, 1, s)
    mfirsts = np.stack([masking.sample_window_starts_host(SEED + i, PARALLEL_MULTI_K, ss[i],
                                                          int(widths[i]))
                        for i in range(PARALLEL_IMAGES)])
    mids = np.stack([masking.sample_knockout_ids_host(SEED + i, PARALLEL_MULTI_K, 1, ss[i])
                     for i in range(PARALLEL_IMAGES)])
    lg = (engine.folded_logits, engine.variables)
    calls = {
        "window": lambda: sharded_window_eval(mesh, *lg, img, seg, firsts, width, target),
        "knockout": lambda: sharded_knockout_eval(mesh, *lg, img, seg, ids, target),
        "window_multi": lambda: sharded_window_eval_multi(mesh, *lg, imgs, np.stack(segs),
                                                          mfirsts, widths, targets),
        "knockout_multi": lambda: sharded_knockout_eval_multi(mesh, *lg, imgs, np.stack(segs),
                                                              mids, targets)}
    _reset_launches()
    got = {k: fn() for k, fn in calls.items()}
    launches = _launches()
    refs = {"window": engine.eval_window_masks(img, seg, firsts, width, target),
            "knockout": engine.eval_knockout_masks(img, seg, ids, target)}
    for k, ref in (("window_multi", engine.eval_window_masks_multi(imgs, segs, mfirsts, widths,
                                                                   targets)),
                   ("knockout_multi", engine.eval_knockout_masks_multi(imgs, segs, mids,
                                                                       targets))):
        refs[k] = types.SimpleNamespace(survived=np.stack([r.survived for r in ref]),
                                        prob_target=np.stack([r.prob_target for r in ref]))
    out["checks"] = {}
    for k, ref in refs.items():
        agree, err = _agree(got[k], (ref.survived, ref.prob_target))
        out["checks"][k] = {"agree": agree, "prob_err": err}
        if not (agree >= PARALLEL_AGREE and err <= PARALLEL_PROB_TOL):
            raise AssertionError(f"world 1 {k}: agreement {agree}, prob_target err {err}")
    for k in ("window", "knockout"):
        if got[k][2] != int(got[k][0].sum()):
            raise AssertionError(f"world 1 {k}: count {got[k][2]} != {int(got[k][0].sum())}")

    def rate(fn, reps=3):
        fn()
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return NUM_SAMPLES / float(np.median(ts))

    out["evals_per_s"] = {"sharded": rate(calls["window"])}
    for mb in (NUM_SAMPLES, MASK_BATCH):
        engine.mask_batch = mb
        out["evals_per_s"][f"engine_mask_batch_{mb}"] = rate(
            lambda: engine.eval_window_masks(img, seg, firsts, width, target))
    del engine
    torch.cuda.empty_cache()

    b50 = create_model("resnet50", "imagenet", dtype=torch.float32)
    e50 = SaliencyEngine(b50, b50.init(SEED), mask_batch=PARALLEL_F32_K,
                         compute_dtype=torch.float32)
    t50 = int(e50.predict(img[None]).argmax())
    f = firsts[:PARALLEL_F32_K]
    before = _launches()
    sharded = sharded_window_eval(mesh, e50.folded_logits, e50.variables, img, seg, f, width,
                                  t50, compute_dtype=torch.float32)
    for k, v in _launches().items():
        launches[k] += v - before[k]
    ref = e50.eval_window_masks(img, seg, f, width, t50)
    err = float(np.abs(sharded[1] - ref.prob_target).max())
    out["checks"]["f32_resnet50"] = {"labels_equal": bool(np.array_equal(sharded[0],
                                                                          ref.survived)),
                                     "prob_err": err}
    if not (np.array_equal(sharded[0], ref.survived) and err <= PARALLEL_F32_TOL):
        raise AssertionError(f"world 1 f32: {out['checks']['f32_resnet50']}")
    out["launches"] = launches
    dist.destroy_process_group()
    print(json.dumps(out))
    return 0


def parallel_world2(rank, port, workdir):
    """One rank of two on gloo sharing the card: the BO loop's two
    shardings and two attributions through the API, each against its
    unsharded call on this rank, then the sweep CLI's runs of
    ``workdir/runs.json``. Prints one JSON line."""
    import os

    import torch
    import torch.distributed as dist

    from network_interpretation_imagenet_tpu_torch.cli import saliency_sweep as sweep_cli
    from network_interpretation_imagenet_tpu_torch.config import BOConfig
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.parallel import make_mesh, multihost
    from network_interpretation_imagenet_tpu_torch.saliency import bo_pipeline, gradient
    from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
    from network_interpretation_imagenet_tpu_torch.saliency.sanity import spearman_abs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    coordinator = f"127.0.0.1:{port}"
    assert multihost.initialize_distributed(coordinator, 2, rank, backend="gloo")
    out = {"rank": rank, "backend": dist.get_backend(), "runs": {}}
    # The API's checks first: the sweeps below then find this process's
    # libraries warm, as the single-process sweep does.
    mesh = make_mesh()
    bundle = create_model("resnet101", "imagenet", dtype=torch.bfloat16)
    engine = SaliencyEngine(bundle, bundle.init(SEED), mask_batch=MASK_BATCH)
    imgs, segs = _parallel_images(range(SEED + 300, SEED + 300 + SWEEP_BATCH))
    targets = engine.predict(imgs).argmax(axis=1)
    seeds = [SEED + i for i in range(SWEEP_BATCH)]
    cfg = BOConfig()
    _reset_launches()
    multi = bo_pipeline.bo_window_saliency_multi(engine, list(imgs), segs, cfg, targets=targets,
                                                 per_image_seeds=seeds, mesh=mesh)
    single = bo_pipeline.bo_window_saliency(engine, imgs[0], segs[0], cfg, seed=SEED,
                                            target=int(targets[0]), proposals_per_iter=2,
                                            mesh=mesh)
    grad = gradient.attribute_batch(engine.bundle.logits, engine.variables, imgs, targets,
                                    "gradient", mesh=mesh)
    rise = gradient.mask_method_batch(engine.folded_logits, engine.variables, imgs, targets,
                                      "rise", bundle=engine.bundle, seeds=seeds, mesh=mesh)
    out["api_launches"] = _launches()
    # The unsharded calls, and the engine's scores at the sharded runs' starts.
    multi_ref = bo_pipeline.bo_window_saliency_multi(engine, list(imgs), segs, cfg,
                                                     targets=targets, per_image_seeds=seeds)
    single_ref = bo_pipeline.bo_window_saliency(engine, imgs[0], segs[0], cfg, seed=SEED,
                                                target=int(targets[0]), proposals_per_iter=2)
    score_err, same = 0.0, []
    traces = [(j, o, tr, tr_ref) for j, ((o, tr), (_, tr_ref)) in enumerate(zip(multi,
                                                                                multi_ref))]
    traces.append((0, single[0], single[1], single_ref[1]))   # the proposal-sharded loop
    for j, o, tr, tr_ref in traces:
        want = engine.eval_window_masks(imgs[j], segs[j], tr.xp.astype(np.int32), o.width,
                                        int(targets[j])).prob_target
        score_err = max(score_err, float(np.abs(tr.yp - want).max()))
        same.append(bool(np.array_equal(tr.xp, tr_ref.xp)))
    out["bo"] = {"score_err": score_err, "same_trace_as_unsharded": same}
    if not score_err <= BO_SCORE_TOL:
        raise AssertionError(f"rank {rank} BO: a sharded score strays {score_err}")
    grad_ref = gradient.attribute_batch(engine.bundle.logits, engine.variables, imgs, targets,
                                        "gradient")
    rise_ref = gradient.mask_method_batch(engine.folded_logits, engine.variables, imgs,
                                          targets, "rise", bundle=engine.bundle, seeds=seeds)
    g, gr = grad.float().cpu().numpy(), grad_ref.float().cpu().numpy()
    r, rr = rise.float().cpu().numpy(), rise_ref.float().cpu().numpy()
    out["attr"] = {
        "gradient_err": float(np.abs(g - gr).max() / np.abs(gr).max()),
        "gradient_rho": min(spearman_abs(g[i], gr[i]) for i in range(len(g))),
        "rise_err": float(np.abs(r - rr).max() / np.abs(rr).max())}
    a = out["attr"]
    if not (a["gradient_err"] <= SERVE_BF16_ATTR_TOL and a["gradient_rho"] >= SERVE_BF16_ATTR_RHO
            and a["rise_err"] <= ATTR_B2_TOL):
        raise AssertionError(f"rank {rank} attributions with a mesh: {a}")
    join = ["--coordinator", coordinator, "--num-processes", "2", "--process-id", str(rank),
            "--dist-backend", "gloo"]
    with open(os.path.join(workdir, "runs.json")) as f:
        runs = json.load(f)
    del engine
    torch.cuda.empty_cache()
    for name, argv in runs.items():
        _reset_launches()
        t0 = time.perf_counter()
        rc = quiet(lambda: sweep_cli.main(argv + join + ["--out", os.path.join(workdir, name)]))
        out["runs"][name] = {"rc": rc, "seconds": time.perf_counter() - t0,
                             "launches": _launches()}
        if rc != 0:
            raise AssertionError(f"rank {rank} {name}: exit {rc}")

    dist.destroy_process_group()
    print(json.dumps(out))
    return 0


def parallel_worker(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--dir", default=None)
    ap.add_argument("--task", default="explain", choices=["explain", "train"])
    args = ap.parse_args(argv)
    if args.task == "train":
        return (ptrain_world1(args.port) if args.world == 1
                else ptrain_world2(args.rank, args.port, args.dir))
    if args.world == 1:
        return parallel_world1(args.port)
    return parallel_world2(args.rank, args.port, args.dir)


def _journal_rows(path):
    with open(path) as f:
        return {r["index"]: r for r in map(json.loads, f) if r.get("event") == "image_done"}


def parallel_phase(smi, by_path):
    """[parallel]: see the module docstring, item 26."""
    import tempfile

    from network_interpretation_imagenet_tpu_torch.cli import saliency_sweep as sweep_cli
    from network_interpretation_imagenet_tpu_torch.gp import kron
    from network_interpretation_imagenet_tpu_torch.saliency.pipeline import localization_score

    t_phase = time.perf_counter()
    lines = []
    w1 = _parallel_spawn([["--world", "1", "--port", str(_free_port())]], 600)[0]
    launches = dict(w1["launches"])
    ev = w1["evals_per_s"]
    lines.append(f"world 1 ({w1['backend']}, mesh {w1['mesh']}): "
                 + ", ".join(f"{k} agreement {v.get('agree', v.get('labels_equal'))} "
                             f"prob_target err {v['prob_err']:.3g}"
                             for k, v in w1["checks"].items())
                 + f"; launches {json.dumps(w1['launches'])}; evals/s (ResNet-101 224 bf16, "
                 f"{NUM_SAMPLES} windows): sharded {ev['sharded']:.1f}, engine mask_batch "
                 f"{NUM_SAMPLES} {ev[f'engine_mask_batch_{NUM_SAMPLES}']:.1f}, mask_batch "
                 f"{MASK_BATCH} {ev[f'engine_mask_batch_{MASK_BATCH}']:.1f}")

    base = ["--synthetic", "--arch", "resnet101", "--num-images", str(PARALLEL_IMAGES),
            "--num_mask_samples", str(NUM_SAMPLES), "--gp-heatmaps"]
    runs = {"multihost": base + ["--multihost"],
            "data_parallel": base + ["--data-parallel"],
            "bo": ["--synthetic", "--arch", "resnet101", "--num-images", str(PARALLEL_IMAGES),
                   "--bo", "--image-batch", str(SWEEP_BATCH), "--data-parallel", "--no-journal"]}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        if quiet(lambda: sweep_cli.main(base + ["--out", f"{tmp}/single"])) != 0:
            raise AssertionError("the single-process sweep failed")
        single_s = time.perf_counter() - t0
        with open(f"{tmp}/runs.json", "w") as f:
            json.dump(runs, f)
        port = _free_port()
        t0 = time.perf_counter()
        ranks = _parallel_spawn([["--world", "2", "--rank", str(r), "--port", str(port),
                                  "--dir", tmp] for r in range(2)], 900)
        world2_s = time.perf_counter() - t0
        for rk in ranks:
            for run in list(rk["runs"].values()) + [{"launches": rk["api_launches"]}]:
                for k, v in run["launches"].items():
                    launches[k] += v

        def result(name):
            with open(f"{tmp}/{name}/sweep_result.json") as f:
                return json.load(f)

        single = result("single")
        single_rows = _journal_rows(f"{tmp}/single/sweep_journal.jsonl")
        with np.load(f"{tmp}/single/gp_heatmaps.npz") as z:
            single_heat = dict(zip(z["indices"].tolist(), z["heatmaps"]))
        # --multihost: each image whole on one rank, so rows and heatmaps equal.
        merged = result("multihost")
        counts = ("images_total", "images_explained", "images_skipped_misclassified",
                  "images_failed")
        if any(merged[k] != single[k] for k in counts) or merged["process_count"] != 2:
            raise AssertionError(f"--multihost merge {merged} vs single {single}")
        rank_p50 = []
        for r in range(2):
            with open(f"{tmp}/multihost/sweep_result.rank{r}.json") as f:
                part = json.load(f)
            rank_p50.append(part["p50_latency_s"])
            with np.load(f"{tmp}/multihost/gp_heatmaps.rank{r}.npz") as z:
                for i, heat in zip(z["indices"].tolist(), z["heatmaps"]):
                    gt = (58, 46, 104, 116)
                    if not (np.array_equal(heat, single_heat[i]) and np.array_equal(
                            localization_score(heat, gt)[1],
                            localization_score(single_heat[i], gt)[1])):
                        raise AssertionError(f"--multihost image {i}: heatmap differs")
            for row in part["per_image"]:
                want = single_rows[row["index"]]
                if any(row[k] != want[k] for k in ("target", "num_segments", "survival")):
                    raise AssertionError(f"--multihost row {row} vs {want}")
        # --data-parallel: 512 / 512 masks per image, bf16.
        dp = result("data_parallel")
        dp_rows = _journal_rows(f"{tmp}/data_parallel/sweep_journal.rank0.jsonl")
        worst = max(abs(dp_rows[i]["survival"] - single_rows[i]["survival"]) for i in dp_rows)
        if dp["images_explained"] != single["images_explained"] or worst > 1 - PARALLEL_AGREE:
            raise AssertionError(f"--data-parallel rows: worst survival gap {worst}")
        with np.load(f"{tmp}/data_parallel/gp_heatmaps.npz") as z:
            heats = z["heatmaps"]
            gp_mean = z["gp_mean"]
        _, ref_mean, _, _ = kron.fit_posterior_batch(heats, iters=20)
        ref_mean = ref_mean.cpu().numpy()
        gp_err = float(np.abs(gp_mean - ref_mean).max() / max(1.0, np.abs(ref_mean).max()))
        if not gp_err <= GP_TOL:
            raise AssertionError(f"--data-parallel GP pass with a mesh: error {gp_err}")
        bo = result("bo")
        if bo["images_explained"] != PARALLEL_IMAGES or bo["images_failed"]:
            raise AssertionError(f"--bo --data-parallel: {bo}")
    if not (launches["masked_batch"] > 0 and launches["bottleneck_chain"] > 0):
        raise AssertionError(f"[parallel]: B1 or B2 never launched: {launches}")
    _dense_e1("[parallel]", launches)
    by_path["parallel"] = launches
    for rk in ranks:
        lines.append(f"rank {rk['rank']} ({rk['backend']}): " + ", ".join(
            f"{name} {run['seconds']:.2f} s launches {json.dumps(run['launches'])}"
            for name, run in rk["runs"].items())
            + f"; API launches {json.dumps(rk['api_launches'])}, BO {json.dumps(rk['bo'])}, "
            f"attributions {json.dumps(rk['attr'])}")
    lines.append(f"single-process sweep {single_s:.2f} s ({single['evals_per_sec']:.1f} evals/s, "
                 f"p50 {single['p50_latency_s'] * 1e3:.1f} ms); two gloo ranks on one card "
                 f"{world2_s:.2f} s: --multihost merged {merged['evals_per_sec']:.1f} evals/s, "
                 f"pooled p50 {merged['p50_latency_s'] * 1e3:.1f} ms, per-rank p50 "
                 + " / ".join(f"{p * 1e3:.1f}" for p in rank_p50)
                 + f" ms; --data-parallel {dp['evals_per_sec']:.1f} evals/s, worst survival gap "
                 f"{worst:.4f}, GP pass with the mesh vs unsharded {gp_err:.3g}; --bo "
                 f"--data-parallel {bo['evals_per_sec']:.1f} evals/s")
    log(f"[parallel] {smi}: " + "; ".join(lines)
        + f"; launches {json.dumps(launches)}; {time.perf_counter() - t_phase:.1f} s")


PTRAIN_STEPS = 8             # [parallel train], world 1: timed steps from one state, each way
PTRAIN_BATCH = 256           # its batch: [train]'s configuration (ResNet-50 224 f32, TF32 off)
PTRAIN_LR = 0.01             # SGD: at the stock 0.1 the timed steps' loss blows up
# The two-rank CLI run and its single-process twin, each under deterministic algorithms (so
# the gap between them is the same in every run): 8 steps an epoch at global B=128, at lr
# 0.001 (at 0.01 epoch 1's train loss read 1.338 on two ranks and 2.134 in one process;
# --ptrain-witness measures how far two f32 runs part at each rate: PERF.md section 6).
PTRAIN_ARGV = ["-a", "resnet50", "--synthetic", "--limit-images", "1024", "-b", "128",
               "--epochs", "2", "--lr", "0.001", "-p", "1"]
PTRAIN_VAL = 256             # its val images: the last max(1024 // 4, 128)
PTRAIN_LOSS_RTOL = 2e-2      # per-epoch losses, two ranks vs one process (16 f32 steps apart)
PTRAIN_TP_BATCH = 32         # the data axis's and the model axis's one step
PTRAIN_RESUME_BATCH = 16     # the two-rank resume check: 8 rows a rank, 4 steps, a save every 2


def _run_steps(bundle, mesh, sd, x, y, dtype, steps, lr=PTRAIN_LR):
    """``steps`` SGD steps of ``bundle`` from ``sd`` on the global batch
    ``x, y`` (on ``mesh`` each rank steps its rows; None: the meshless
    step): (each step's loss, each step's ms, the whole parameters and
    statistics after step 1, as CPU f64, this rank's parameter and slot
    bytes)."""
    import torch

    from network_interpretation_imagenet_tpu_torch.config import TrainConfig
    from network_interpretation_imagenet_tpu_torch.parallel import make_sharded_train_step
    from network_interpretation_imagenet_tpu_torch.parallel.mesh import shard_batch
    from network_interpretation_imagenet_tpu_torch.parallel.train_step import (
        gather_full,
        param_shardings,
    )
    from network_interpretation_imagenet_tpu_torch.train import make_optimizer

    cfg = TrainConfig(lr=lr, momentum=0.9, weight_decay=1e-4)
    init, step = make_sharded_train_step(bundle, mesh, make_optimizer(cfg, 1000), device="cuda")
    state = init(SEED, {k: v.to(dtype) if v.is_floating_point() else v for k, v in sd.items()})
    xd = torch.as_tensor(x).to("cuda", dtype)
    yd = torch.as_tensor(y).to("cuda")
    if mesh is not None:
        xd, yd = shard_batch(mesh, xd), shard_batch(mesh, yd)
    losses, ms, after = [], [], None
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, xd, yd)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        if after is None:   # step 1, the one held to f64 (outside the timing)
            params = {n: p.detach() for n, p in state.params.items()}
            if mesh is not None:
                params = gather_full(mesh, params, param_shardings(
                    dict(bundle.module.named_parameters()), mesh))
            after = {k: t.double().cpu() for k, t in {**params, **state.buffers}.items()
                     if not k.endswith("num_batches_tracked")}
    local = {"param_bytes": sum(p.numel() * p.element_size() for p in state.params.values()),
             "slot_bytes": sum(t.numel() * t.element_size()
                               for t in state.opt_state["trace"].values())}
    return losses, ms, after, local


def ptrain_world1(port):
    """[parallel train], a world of 1 on NCCL: from one state, ResNet-50 224
    at B=PTRAIN_BATCH, PTRAIN_STEPS f32 steps meshless and on the mesh, and
    one meshless f64 step (the referee of both f32 runs' step 1). Prints
    one JSON line."""
    import torch
    import torch.distributed as dist

    from network_interpretation_imagenet_tpu_torch.data.synthetic import (
        synthetic_classification_batch,
    )
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.parallel import make_mesh, multihost

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    assert multihost.initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    mesh = make_mesh()
    bundle = create_model("resnet50", "imagenet", num_classes=8)
    sd = bundle.init(SEED)
    x, y = synthetic_classification_batch(SEED, PTRAIN_BATCH, 224, 3, 8)
    out = {"backend": dist.get_backend(), "mesh": list(mesh.shape), "runs": {}}
    after = {}
    for name, m, dtype, steps in (("plain", None, torch.float32, PTRAIN_STEPS),
                                  ("mesh", mesh, torch.float32, PTRAIN_STEPS),
                                  ("f64", None, torch.float64, 1)):
        torch.cuda.reset_peak_memory_stats()
        losses, ms, after[name], _ = _run_steps(bundle, m, sd, x, y, dtype, steps)
        out["runs"][name] = {"losses": losses, "ms": ms,
                             "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        torch.cuda.empty_cache()
    base = {k: v.double() for k, v in sd.items()}
    f64_loss = out["runs"]["f64"]["losses"][0]
    out["errors"] = {name: step_errors(after[name], after["f64"], base,
                                       out["runs"][name]["losses"][0], f64_loss)
                     for name in ("plain", "mesh")}
    out["mesh_vs_plain"] = max(float((after["mesh"][k] - after["plain"][k]).abs().max())
                               for k in after["plain"])
    out["grad_bytes"] = sum(p.numel() * 4 for p in bundle.module.parameters())
    dist.destroy_process_group()
    print(json.dumps(out))
    return 0


def _recording_writes(fn):
    """(``fn()``, the base names of the files it opened for writing)."""
    import builtins
    import os

    written, real_open = set(), builtins.open

    def recording_open(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+"):
            written.add(os.path.basename(str(file)))
        return real_open(file, mode, *a, **k)

    builtins.open = recording_open
    try:
        return fn(), sorted(written)
    finally:
        builtins.open = real_open


def ptrain_world2(rank, port, workdir):
    """[parallel train], one rank of two on gloo sharing the card:
    cli.main --multihost (the argv of ``workdir/train_argv.json``), its
    model_best explained through the sharded engine, a mid-epoch resume
    under deterministic algorithms, and one step on the data axis and one
    on the model axis. Prints one JSON line."""
    import os

    import torch
    import torch.distributed as dist

    from network_interpretation_imagenet_tpu_torch.cli import common
    from network_interpretation_imagenet_tpu_torch.cli import main as train_cli
    from network_interpretation_imagenet_tpu_torch.config import TrainConfig
    from network_interpretation_imagenet_tpu_torch.data.loaders import ArrayLoader
    from network_interpretation_imagenet_tpu_torch.data.synthetic import (
        synthetic_classification_batch,
    )
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.ops import masking
    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import (
        masked_batch,
        masked_batch_plain,
    )
    from network_interpretation_imagenet_tpu_torch.parallel import (
        make_mesh,
        multihost,
        sharded_window_eval,
    )
    from network_interpretation_imagenet_tpu_torch.train import Trainer

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    coordinator = f"127.0.0.1:{port}"
    assert multihost.initialize_distributed(coordinator, 2, rank, backend="gloo")
    out = {"rank": rank, "backend": dist.get_backend()}

    # 1. the user's command: cli.main --multihost, rank 0 alone writing, under
    # deterministic algorithms as its single-process twin
    with open(os.path.join(workdir, "train_argv.json")) as f:
        argv = json.load(f)
    join = ["--multihost", "--coordinator", coordinator, "--num-processes", "2",
            "--process-id", str(rank), "--dist-backend", "gloo",
            "--save", os.path.join(workdir, "multi")]
    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout), deterministic():
        rc, written = _recording_writes(lambda: train_cli.main(argv + join))
    out["cli"] = {"rc": rc, "written": written, "seconds": time.perf_counter() - t0,
                  "steps_s": step_meter(stdout.getvalue()),
                  "losses": meter_losses(stdout.getvalue())}
    if rc != 0:
        raise AssertionError(f"rank {rank}: cli.main --multihost exited {rc}")

    # 2. the handoff: the two-rank model_best through --ckpt into a bf16 engine,
    # 1,024 windows sharded over the two ranks
    mesh = make_mesh()
    args = common.build_parser("handoff").parse_args(
        ["--arch", "resnet50", "--ckpt", os.path.join(workdir, "multi", "imagenet-resnet50",
                                                       "model_best"),
         "--mask-batch", str(HANDOFF_MASKS)])
    engine = common.build_engine(args, num_classes=8)
    imgs, segs = _parallel_images([SEED])
    img, seg = imgs[0], segs[0]
    s = int(seg.max()) + 1
    width = int(0.4 * s)
    firsts = masking.sample_window_starts_host(SEED, HANDOFF_MASKS, s, width)
    _reset_launches()
    target, _ = engine.predict_one(img)
    got = sharded_window_eval(mesh, engine.folded_logits, engine.variables, img, seg, firsts,
                              width, target)
    out["handoff_launches"] = _launches()
    ref = engine.eval_window_masks(img, seg, firsts, width, target)
    agree, err = _agree(got, (ref.survived, ref.prob_target))
    dev = torch.device("cuda")
    image_t = torch.from_numpy(img).to(dev)
    seg_t = torch.from_numpy(np.asarray(seg, np.int32)).to(dev)
    mine = torch.from_numpy(firsts[rank * HANDOFF_MASKS // 2:(rank + 1) * HANDOFF_MASKS // 2]
                            ).to(dev)
    masked = masked_batch(image_t, seg_t, mine, width, torch.bfloat16)
    b1_exact = bool(torch.equal(masked, masked_batch_plain(image_t, seg_t, mine, width,
                                                           torch.bfloat16)))
    worst = 0.0
    for batch_x in (masked, image_t[None].to(torch.bfloat16)):
        for x_in, chain in chain_inputs(engine.model, batch_x):
            worst = max(worst, check_chain(x_in.contiguous(), chain, B2_TOL)[0])
    out["handoff"] = {"target": int(target), "agree": agree, "prob_err": err,
                      "count": int(got[2]), "b1_exact": b1_exact, "b2_block_err": worst}
    if not (agree >= PARALLEL_AGREE and err <= PARALLEL_PROB_TOL and b1_exact):
        raise AssertionError(f"rank {rank} handoff: {out['handoff']}")
    del engine, masked
    torch.cuda.empty_cache()
    if rank == 0:
        # B2's f32 instance on the same sane trained weights: an f32 engine
        # from model_best (--dtype float32), block by block at B2_F32_TOL on
        # this rank's masked batch and on the single image (check_chain raises).
        args32 = common.build_parser("handoff").parse_args(
            ["--arch", "resnet50", "--dtype", "float32", "--ckpt",
             os.path.join(workdir, "multi", "imagenet-resnet50", "model_best"),
             "--mask-batch", str(HANDOFF_MASKS)])
        engine32 = common.build_engine(args32, num_classes=8)
        worst32 = 0.0
        for batch_x in (masked_batch(image_t, seg_t, mine, width, torch.float32), image_t[None]):
            for x_in, chain in chain_inputs(engine32.model, batch_x):
                worst32 = max(worst32, check_chain(x_in.contiguous(), chain, B2_F32_TOL)[0])
        out["handoff"]["b2_f32_block_err"] = worst32
        del engine32
        torch.cuda.empty_cache()

    # 3. a mid-epoch resume on both ranks under deterministic algorithms
    xr, yr = synthetic_classification_batch(SEED + 1, 4 * PTRAIN_RESUME_BATCH, 224, 3, 8)
    val = ArrayLoader(xr[:PTRAIN_RESUME_BATCH], yr[:PTRAIN_RESUME_BATCH], PTRAIN_RESUME_BATCH)

    def trainer(name):
        return Trainer(create_model("resnet50", "imagenet", num_classes=8),
                       TrainConfig(lr=0.1, epochs=1), 4, mesh=mesh,
                       save_dir=os.path.join(workdir, f"resume_{name}"), save_every_steps=2)

    with deterministic():
        whole = trainer("whole")
        whole.fit(ArrayLoader(xr, yr, PTRAIN_RESUME_BATCH, shuffle=True), val)
        try:
            trainer("cut").fit(cut_loader(xr, yr, PTRAIN_RESUME_BATCH, 3), val)
            raise AssertionError("the cut run was not cut")
        except Cut:
            pass
        resumed = trainer("cut")
        if not (resumed.resume() and resumed.resume_skip_steps == 2):
            raise AssertionError(f"rank {rank}: no mid-epoch checkpoint to resume")
        resumed.fit(ArrayLoader(xr, yr, PTRAIN_RESUME_BATCH, shuffle=True), val)
        a, b = whole.variables(), resumed.variables()
    out["resume_err"] = max((a[k].float() - b[k].float()).abs().max().item()
                            for k in a if not k.endswith("num_batches_tracked"))
    del whole, resumed, a, b
    torch.cuda.empty_cache()

    # 4. the data axis and the model axis through the API: one step on mesh
    # (2, 1), each rank its half of the rows, and one on mesh (1, 2), against
    # the meshless step, each held to the meshless f64 step
    tp = make_mesh(model_parallel=2)
    bundle = create_model("resnet50", "imagenet", num_classes=8)
    sd = bundle.init(SEED)
    x, y = synthetic_classification_batch(SEED + 2, PTRAIN_TP_BATCH, 224, 3, 8)
    runs = {}
    for name, m, dtype in (("dp", mesh, torch.float32), ("tp", tp, torch.float32),
                           ("plain", None, torch.float32), ("f64", None, torch.float64)):
        runs[name] = _run_steps(bundle, m, sd, x, y, dtype, 1, lr=0.1)
    base = {k: v.double() for k, v in sd.items()}
    out["tp"] = {"mesh": list(tp.shape), "dp_mesh": list(mesh.shape), **{
        name: {**step_errors(runs[name][2], runs["f64"][2], base, runs[name][0][0],
                             runs["f64"][0][0]), **runs[name][3]}
        for name in ("dp", "tp", "plain")}}
    dist.destroy_process_group()
    print(json.dumps(out))
    return 0


def meter_losses(stdout):
    """The per-step losses of Trainer.train_epoch's meter lines (-p 1)."""
    return [float(line.split("\tLoss ")[1].split(" ")[0]) for line in stdout.splitlines()
            if line.startswith("Epoch: [") and "\tLoss " in line]


def parallel_train_phase(smi, by_path):
    """[parallel train]: see the module docstring, item 27. Each part's line
    is printed before its checks."""
    import tempfile

    import torch

    from network_interpretation_imagenet_tpu_torch.cli import main as train_cli

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()   # the ranks' processes need the card's memory
    w1 = _parallel_spawn([["--task", "train", "--world", "1", "--port", str(_free_port())]],
                         900)[0]
    runs, errs = w1["runs"], w1["errors"]
    ms = {k: float(np.median(runs[k]["ms"][1:])) for k in ("plain", "mesh")}
    log(f"[parallel train] {smi}: world 1 ({w1['backend']}, mesh {w1['mesh']}), ResNet-50 224 "
        f"f32 B={PTRAIN_BATCH}, {PTRAIN_STEPS} SGD steps at lr {PTRAIN_LR} from one state on one "
        f"device-resident batch, step 1 against one f64 step: loss rel err meshless "
        f"{errs['plain']['loss']:.3g}, mesh {errs['mesh']['loss']:.3g} (tol {TRAIN_LOSS_TOL}); "
        f"update rel L2 err meshless {errs['plain']['update']:.3g}, mesh "
        f"{errs['mesh']['update']:.3g} (tol: the mesh within {TRAIN_UPDATE_TOL} x the "
        f"meshless); worst tensor meshless {errs['plain']['worst'][0]:.3g} "
        f"({errs['plain']['worst'][1]}), mesh {errs['mesh']['worst'][0]:.3g} "
        f"({errs['mesh']['worst'][1]}); running statistics max err x scale meshless "
        f"{errs['plain']['stats']:.3g}, mesh {errs['mesh']['stats']:.3g} (tol "
        f"{TRAIN_STATS_TOL}); max |mesh - meshless| after step 1 {w1['mesh_vs_plain']:.3g}; "
        f"ms per step (warm median) meshless {ms['plain']:.1f}, mesh "
        f"{ms['mesh']:.1f} ({ms['mesh'] / ms['plain']:.3f}x; the mesh adds one flat all-reduce "
        f"of {w1['grad_bytes']} bytes of gradients, 2 x 53 BatchNorm all-reduces and BatchNorm "
        f"as tensor operations), per step meshless "
        f"{[round(v, 1) for v in runs['plain']['ms']]}, mesh "
        f"{[round(v, 1) for v in runs['mesh']['ms']]}; peak GiB meshless "
        f"{runs['plain']['peak_gib']:.2f}, mesh {runs['mesh']['peak_gib']:.2f}, f64 "
        f"{runs['f64']['peak_gib']:.2f} (one step); losses meshless "
        f"{[round(v, 6) for v in runs['plain']['losses']]}, mesh "
        f"{[round(v, 6) for v in runs['mesh']['losses']]}, f64 step 1 "
        f"{runs['f64']['losses'][0]:.6f} in {runs['f64']['ms'][0]:.1f} ms")
    if not (errs["mesh"]["loss"] <= TRAIN_LOSS_TOL and errs["plain"]["loss"] <= TRAIN_LOSS_TOL
            and errs["mesh"]["update"] <= TRAIN_UPDATE_TOL * errs["plain"]["update"]
            and errs["mesh"]["stats"] <= TRAIN_STATS_TOL):
        raise AssertionError(f"[parallel train] the world-1 mesh step strays: {errs}")

    with tempfile.TemporaryDirectory() as tmp:
        stdout = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout), deterministic():
            rc = counted(by_path, "parallel_train_cli",
                         lambda: train_cli.main(PTRAIN_ARGV + ["--save", f"{tmp}/single"]), 0, 0)
        single_s = time.perf_counter() - t0
        single_steps, single_losses = step_meter(stdout.getvalue()), meter_losses(
            stdout.getvalue())
        if rc != 0:
            raise AssertionError(f"[parallel train] the single-process run exited {rc}")
        with open(f"{tmp}/train_argv.json", "w") as f:
            json.dump(PTRAIN_ARGV, f)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        port = _free_port()
        ranks = _parallel_spawn([["--task", "train", "--world", "2", "--rank", str(r),
                                  "--port", str(port), "--dir", tmp] for r in range(2)], 900)
        world2_s = time.perf_counter() - t0
        results = {}
        for name in ("single", "multi"):
            with open(f"{tmp}/{name}/imagenet_train_result.json") as f:
                results[name] = json.load(f)
    rows = list(zip(results["multi"]["history"], results["single"]["history"]))
    loss_err = max(abs(m[k] - s[k]) / abs(s[k]) for m, s in rows
                   for k in ("train_loss", "val_loss"))
    # One val image moves the error rate by 100 / PTRAIN_VAL: a prediction on a
    # decision boundary may flip between two f32 trajectories 16 steps apart.
    err1_gap = max(abs(m["val_err1"] - s["val_err1"]) for m, s in rows)
    rank0, rank1 = ranks[0]["cli"], ranks[1]["cli"]
    gb = int(PTRAIN_ARGV[PTRAIN_ARGV.index("-b") + 1])
    single_ms = float(np.median(single_steps[1:])) * 1e3
    rank_ms = [float(np.median(rk["cli"]["steps_s"][1:])) * 1e3 for rk in ranks]

    def hist(name):
        return json.dumps([{k: r[k] for k in ("train_loss", "val_loss", "val_err1")}
                           for r in results[name]["history"]])

    log(f"[parallel train] cli.main {' '.join(PTRAIN_ARGV)}: single process {single_s:.1f} s, "
        f"warm median {single_ms:.1f} ms a step, {gb / single_ms * 1e3:.1f} images/s; two gloo "
        f"ranks on one card ({world2_s:.1f} s for the ranks' whole work) --multihost "
        f"{rank0['seconds']:.1f} s: per-rank warm median "
        + " / ".join(f"{v:.1f}" for v in rank_ms)
        + f" ms a step, merged {gb / max(rank_ms) * 1e3:.1f} images/s "
        f"({single_ms / max(rank_ms):.3f}x the single process); worst per-epoch loss rel err "
        f"{loss_err:.3g} (tol {PTRAIN_LOSS_RTOL}), val_err1 gap {err1_gap:.3f} (tol one image "
        f"of {PTRAIN_VAL}); two ranks {hist('multi')}, one process {hist('single')}; per-step "
        f"losses one process {single_losses}, rank 0 {rank0['losses']}; rank 0 wrote "
        f"{rank0['written']}, rank 1 {rank1['written'] or 'nothing'}")
    if not (len(rows) == 2 and loss_err <= PTRAIN_LOSS_RTOL
            and err1_gap <= 100.0 / PTRAIN_VAL + 1e-9
            and {"scores.tsv", "imagenet_train_result.json"} <= set(rank0["written"])
            and not rank1["written"]):
        raise AssertionError("[parallel train] two ranks vs one process: see the line above")
    for rk in ranks:
        tp, h = rk["tp"], rk["handoff"]
        log(f"[parallel train] rank {rk['rank']} ({rk['backend']}): resumed mid-epoch under "
            f"deterministic algorithms, max |uninterrupted - resumed| {rk['resume_err']:.3g}; "
            f"one ResNet-50 step at B={PTRAIN_TP_BATCH} on the data axis {tp['dp_mesh']} and on "
            f"the model axis {tp['mesh']}: model-axis parameter "
            f"bytes {tp['tp']['param_bytes']} of {tp['plain']['param_bytes']} "
            f"({tp['tp']['param_bytes'] / tp['plain']['param_bytes']:.3f}), slot bytes "
            f"{tp['tp']['slot_bytes']} of {tp['plain']['slot_bytes']}; against f64 (data axis / "
            f"model axis / meshless): loss {tp['dp']['loss']:.3g} / {tp['tp']['loss']:.3g} / "
            f"{tp['plain']['loss']:.3g}, update {tp['dp']['update']:.3g} / "
            f"{tp['tp']['update']:.3g} / {tp['plain']['update']:.3g}, statistics "
            f"{tp['dp']['stats']:.3g} / {tp['tp']['stats']:.3g} / {tp['plain']['stats']:.3g} "
            f"(tol: loss {TRAIN_LOSS_TOL}, update {TRAIN_UPDATE_TOL} x the meshless, statistics "
            f"{TRAIN_STATS_TOL}); handoff (model_best -> bf16 "
            f"engine, {HANDOFF_MASKS} windows sharded) target {h['target']}, survive agreement "
            f"{h['agree']} with the unsharded engine, prob_target err {h['prob_err']:.3g}, B1 "
            f"bit-exact {h['b1_exact']}, B2 worst block err {h['b2_block_err']:.4g} (tol "
            f"{B2_TOL} x max|plain|, at B = {HANDOFF_MASKS // 2} and 1)"
            + (f", B2's f32 instance on an f32 engine of the same model_best worst block err "
               f"{h['b2_f32_block_err']:.4g} (tol {B2_F32_TOL} x max|plain|)"
               if "b2_f32_block_err" in h else "")
            + f"; launches {json.dumps(rk['handoff_launches'])}")
        if rk["rank"] == 0 and "b2_f32_block_err" not in h:
            raise AssertionError("[parallel train] rank 0 held no f32 B2 check on model_best")
        if rk["resume_err"] != 0.0:
            raise AssertionError(f"[parallel train] rank {rk['rank']}: the resumed two-rank run "
                                 f"differs by {rk['resume_err']}")
        for axis in ("dp", "tp"):
            if not (tp[axis]["loss"] <= TRAIN_LOSS_TOL and tp[axis]["stats"] <= TRAIN_STATS_TOL
                    and tp[axis]["update"] <= TRAIN_UPDATE_TOL * tp["plain"]["update"]):
                raise AssertionError(f"[parallel train] rank {rk['rank']}: the {axis} mesh's "
                                     f"step strays: {tp}")
    launches = {k: sum(rk["handoff_launches"][k] for rk in ranks)
                for k in ("masked_batch", "bottleneck_chain", "epilogue_nhwc")}
    if not (launches["masked_batch"] > 0 and launches["bottleneck_chain"] > 0):
        raise AssertionError(f"[parallel train]: B1 or B2 never launched: {launches}")
    _dense_e1("[parallel train]", launches)
    by_path["parallel train"] = launches
    log(f"[parallel train] launches {json.dumps(launches)}; "
        f"{time.perf_counter() - t_phase:.1f} s")


def ptrain_witness() -> int:
    """``--ptrain-witness``: PTRAIN_ARGV in this process at lr 0.01 and
    0.001, from cli.main's seeded init ("seeded"), from the same weights
    through a weights artifact and --pretrained ("artifact"), and from two
    copies of them with every parameter moved one ulp, each with its own
    random signs ("ulp a", "ulp b"). Prints each run's history and its
    per-epoch losses' relative gaps from the artifact run: how far two f32
    runs part when only their rounding differs."""
    import os
    import tempfile

    import torch

    from network_interpretation_imagenet_tpu_torch.cli import main as train_cli
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.utils import convert

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    bundle = create_model("resnet50", "imagenet", num_classes=8)   # --synthetic's 8 classes
    sd = bundle.init(0)   # cli.main's init at its default --seed 0
    params = dict(bundle.module.named_parameters())
    gen = torch.Generator().manual_seed(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        inits = {"seeded": None}
        for name in ("artifact", "ulp a", "ulp b"):
            moved = dict(sd)
            if name != "artifact":
                for k in params:
                    toward = torch.where(torch.rand(sd[k].shape, generator=gen) < 0.5,
                                         -float("inf"), float("inf"))
                    moved[k] = torch.nextafter(sd[k], toward)
            inits[name] = os.path.join(tmp, name.replace(" ", "_"))
            convert.save_weights_artifact(convert.jax_variables(moved, bundle.module),
                                          inits[name], {"arch": "resnet50"})
        for lr in ("0.01", "0.001"):
            argv = list(PTRAIN_ARGV)
            argv[argv.index("--lr") + 1] = lr
            hist = {}
            for name, path in inits.items():
                save = os.path.join(tmp, f"lr{lr}_{name.replace(' ', '_')}")
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = train_cli.main(argv + ["--save", save]
                                        + (["--pretrained", path] if path else []))
                if rc != 0:
                    raise AssertionError(f"[ptrain witness] {name} at lr {lr} exited {rc}")
                with open(os.path.join(save, "imagenet_train_result.json")) as f:
                    hist[name] = [{k: r[k] for k in ("train_loss", "val_loss", "val_err1")}
                                  for r in json.load(f)["history"]]
                torch.cuda.empty_cache()
            gaps = {name: [{k: round((r[k] - b[k]) / abs(b[k]), 6)
                            for k in ("train_loss", "val_loss")}
                           for r, b in zip(h, hist["artifact"])]
                    for name, h in hist.items() if name != "artifact"}
            log(f"[ptrain witness] {smi}: cli.main {' '.join(argv)}, one process each: "
                f"histories {json.dumps(hist)}; per-epoch (run - artifact) / |artifact| "
                f"{json.dumps(gaps)}")
    log(f"[ptrain witness] {time.perf_counter() - t0:.1f} s")
    print(smi)
    return 0


def device_and_build():
    """1. and 2.: logs the versions and the card, builds csrc/*.cu, holds
    ptxas to no spills and B2's SASS to HGMMA; returns the card's name and
    its nvidia-smi name and power limit."""
    import torch

    from network_interpretation_imagenet_tpu_torch.ops import _cuda_build

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
    f32_ops = sass_f32_ops(_cuda_build.so_path("bottleneck_chain"))
    log("[build] bottleneck_chain SASS, b2_conv_f32 instances (FFMA, LDS.128, tensor-core "
        "instructions): " + json.dumps(sorted(tuple(v.values()) for v in f32_ops.values())))
    if not f32_ops or any(v["FFMA"] == 0 or v["MMA"] for v in f32_ops.values()):
        raise AssertionError(f"B2's f32 instances must run FFMAs and no tensor-core (TF32) "
                             f"instruction: {f32_ops}")
    stores = sass_b1_stores(_cuda_build.so_path("masked_batch"))
    log(f"[build] masked_batch SASS: {len(stores)} b1_masked_batch instances, global stores "
        "[128-bit, narrower] " + json.dumps(sorted(stores.values())))
    if not stores or any(wide == 0 for wide, _ in stores.values()):
        raise AssertionError(f"B1's library: an instance without 128-bit global stores {stores}")
    return kind, smi


def b2_only() -> int:
    """``--b2``: only B2's checks and timings (1., 2., 4. with the f32
    instance's, Wide-ResNet's chains of 18. in bf16 and f32, 20.), then the
    f32 instance's end-to-end lines (f32_end_to_end), for comparing two trees
    of the port on one card in one call. Prints no result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    _, smi = device_and_build()
    _, small_cases = b2_phase(np.random.RandomState(SEED), smi)
    wide_chains(smi)
    b2_graph_phase(small_cases, smi)
    del small_cases
    f32_end_to_end(smi)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    return 0


def f32_end_to_end(smi):
    """``--b2``'s end-to-end lines for B2's f32 instance (the parity mode,
    ``--dtype float32``), ResNet-101 224x224 f32, TF32 off, on the synthetic
    image: ``eval_window_masks`` on NUM_SAMPLES window masks in chunks of
    MASK_BATCH (evals/s, median of 3 warm calls), and the flagship
    ``bo_window_saliency`` (default BOConfig) as a warm graph replay (host
    ms to its device-to-host copy, median of 5). Each path's B2 launches
    are held."""
    import torch

    from network_interpretation_imagenet_tpu_torch.config import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        BOConfig,
        SegmentConfig,
    )
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import bottleneck_chain
    from network_interpretation_imagenet_tpu_torch.ops.preprocess import (
        normalize,
        to_display_uint8,
    )
    from network_interpretation_imagenet_tpu_torch.saliency.bo_pipeline import bo_window_saliency
    from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
    from network_interpretation_imagenet_tpu_torch.saliency.pipeline import random_window_saliency
    from network_interpretation_imagenet_tpu_torch.segment.common import segment_image

    img_u8, _ = synthetic_image(SEED)
    normalized = normalize(torch.from_numpy(img_u8.astype(np.float32) / 255.0),
                           IMAGENET_MEAN, IMAGENET_STD).numpy()
    segments = np.asarray(segment_image(to_display_uint8(torch.from_numpy(normalized)).numpy(),
                                        SegmentConfig()), np.int32)
    bundle = create_model("resnet101", "imagenet", dtype=torch.float32)
    engine = SaliencyEngine(bundle, bundle.init(SEED), mask_batch=MASK_BATCH,
                            compute_dtype=torch.float32, device="cuda")
    target, _ = engine.predict_one(normalized)
    out = random_window_saliency(engine, normalized, segments, num_samples=NUM_SAMPLES,
                                 seed=SEED, target=target)
    bottleneck_chain.launches = 0
    res = engine.eval_window_masks(normalized, segments, out.firsts, out.width, target)
    window_launches = bottleneck_chain.launches
    if window_launches != 4 * -(-NUM_SAMPLES // MASK_BATCH) or not np.isfinite(
            res.prob_target).all():
        raise AssertionError(f"f32 windows: B2 launched {window_launches} times, or "
                             "non-finite scores")
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.eval_window_masks(normalized, segments, out.firsts, out.width, target)
        ts.append(time.perf_counter() - t0)
    rates = sorted(NUM_SAMPLES / t for t in ts)

    def explain():
        return bo_window_saliency(engine, normalized, segments, BOConfig(), seed=SEED,
                                  target=target)

    bottleneck_chain.launches = 0
    explain()            # the shape's first call runs eagerly
    eager_launches = bottleneck_chain.launches
    explain()            # the second captures the graph and replays it
    if eager_launches == 0:
        raise AssertionError("the f32 BO path launched no B2")
    bo_ms = p50_ms(explain, 5)
    log(f"[B2 f32 e2e] {smi}: ResNet-101 224 f32 eval_window_masks ({NUM_SAMPLES} masks, "
        f"mask_batch {MASK_BATCH}, B2 launches {window_launches}): {rates[1]:.1f} evals/s "
        f"(median of 3; {rates[0]:.1f}-{rates[2]:.1f}); bo_window_saliency f32 (B2 launches "
        f"{eager_launches} eager) warm replay p50 {bo_ms:.3f} ms (5 calls)")
    del engine
    torch.cuda.empty_cache()


def b1_only() -> int:
    """``--b1``: only B1's checks and timings (1., 2., 3.) and [B1 zoo], for
    comparing two trees of the port on one card in one call. Prints no
    result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    _, smi = device_and_build()
    b1_phase(np.random.RandomState(SEED), smi)
    b1_zoo(smi)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    return 0


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
    from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import bottleneck_chain
    from network_interpretation_imagenet_tpu_torch.ops.epilogue_nhwc import epilogue_nhwc
    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import masked_batch
    from network_interpretation_imagenet_tpu_torch.ops.pool_nhwc import pool_nhwc
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

    kind, smi = device_and_build()

    # 3. B1 against its plain version
    rng = np.random.RandomState(SEED)
    b1_ms, b1_plain_ms, b1_bound_ms, b1_by_shape = b1_phase(rng, smi)

    # 4. B2 against its plain version at the four ResNet-101 stage shapes
    b2, small_cases = b2_phase(rng, smi)

    # 5. the main path at full width
    img_u8, gt = synthetic_image(SEED)
    normalized = normalize(torch.from_numpy(img_u8.astype(np.float32) / 255.0),
                           IMAGENET_MEAN, IMAGENET_STD).numpy()
    display = to_display_uint8(torch.from_numpy(normalized)).numpy()
    bundle = create_model("resnet101", "imagenet", dtype=torch.bfloat16)
    engine = SaliencyEngine(bundle, bundle.init(SEED), mask_batch=MASK_BATCH, device="cuda")
    masked_batch.launches = 0
    bottleneck_chain.launches = 0
    pool_nhwc.launches = 0
    epilogue_nhwc.launches = 0
    t0 = time.perf_counter()
    segments = segment_image(display, SegmentConfig())
    target, logits = engine.predict_one(normalized)
    out = random_window_saliency(engine, normalized, segments, num_samples=NUM_SAMPLES,
                                 seed=SEED, target=target)
    iou, box = localization_score(out.heatmap, gt)
    main_s = time.perf_counter() - t0
    launches = {"masked_batch": masked_batch.launches,
                "bottleneck_chain": bottleneck_chain.launches, "pool_nhwc": pool_nhwc.launches,
                "epilogue_nhwc": epilogue_nhwc.launches}
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
    if launches["pool_nhwc"]:
        raise AssertionError(f"P1 launched {launches['pool_nhwc']} times on ResNet-101")
    if launches["epilogue_nhwc"] != E1_PER_DENSE_FORWARD * forwards:
        raise AssertionError(f"E1 launched {launches['epilogue_nhwc']} times, "
                             f"want {E1_PER_DENSE_FORWARD * forwards}")
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
    before = (masked_batch.launches, bottleneck_chain.launches, epilogue_nhwc.launches)
    r32 = {d: e.eval_window_masks(normalized, segments, out.firsts[:16], out.width, target)
           for d, e in e32.items()}
    if (masked_batch.launches - before[0], bottleneck_chain.launches - before[1],
            epilogue_nhwc.launches - before[2]) != (1, 4, E1_PER_DENSE_FORWARD):
        raise AssertionError("the f32 engine on the card did not run B1 once, B2 4 times and "
                             f"E1 {E1_PER_DENSE_FORWARD} times")
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
    zoo_grad_phase(smi)
    pool_total, pool_by_shape = pool_phase(smi)
    e1_total, e1_by_shape = epilogue_phase(smi)
    bo_zoo_phase(normalized, seg_np, smi, paths)
    gen_small_phase(smi, paths)
    serve_phase(engine, normalized, seg_np, target, smi, paths)
    train_phase(normalized, seg_np, smi, paths)
    parallel_phase(smi, paths)
    parallel_train_phase(smi, paths)
    b2_graph_phase(small_cases, smi)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    # P1's count is kept where counted() or [main] read it; the spawned
    # [parallel] ranks run ResNets and report B1, B2 and E1 only.
    by_path = {name: {path: counts[name] for path, counts in paths.items() if name in counts}
               for name in launches}

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
         "library_ms": None, "f32_max_abs_err": b2["f32_block_err"], "f32_by_shape": b2["f32"]},
        {"name": "pool_nhwc", "route": "cuda", "source": f"{PKG}/csrc/pool_nhwc.cu",
         "replaces": None, "launches": sum(by_path["pool_nhwc"].values()),
         "launches_by_path": by_path["pool_nhwc"],
         "max_ulps": max(r["max_ulps"] for r in pool_by_shape), "ms": pool_total["ms"],
         "plain_ms": pool_total["plain_ms"], "bound_ms": pool_total["bound_ms"],
         "bound_by": "bytes", "library_ms": pool_total["library_ms"],
         "by_shape": pool_by_shape},
        {"name": "epilogue_nhwc", "route": "cuda", "source": f"{PKG}/csrc/epilogue_nhwc.cu",
         "replaces": None, "launches": sum(by_path["epilogue_nhwc"].values()),
         "launches_by_path": by_path["epilogue_nhwc"],
         "bit_equal": all(r["bit_equal"] for r in e1_by_shape), "ms": e1_total["ms"],
         "plain_ms": e1_total["plain_ms"], "bound_ms": e1_total["bound_ms"],
         "bound_by": "bytes", "library_ms": e1_total["library_ms"], "by_shape": e1_by_shape},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        sys.exit(parallel_worker(sys.argv[2:]))
    if sys.argv[1:] == ["--ptrain-witness"]:
        sys.exit(ptrain_witness())
    if sys.argv[1:] == ["--b2"]:
        sys.exit(b2_only())
    if sys.argv[1:] == ["--b1"]:
        sys.exit(b1_only())
    if sys.argv[1:] == ["--pool"]:
        sys.exit(pool_only())
    if sys.argv[1:] == ["--epilogue"]:
        sys.exit(epilogue_only())
    if sys.argv[1:] == ["--zoo-grad"]:
        sys.exit(zoo_grad_only())
    sys.exit(main())
