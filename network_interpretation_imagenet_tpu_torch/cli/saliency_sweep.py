"""Val-set saliency sweep CLI (port of ``cli/saliency_sweep.py`` of the JAX
package): superpixel-mask, BO or attribution saliency over many images,
reporting mean IOU, survival, p50 latency and evals per second; per-image
failures and misclassifications are skipped and counted, not fatal (the
reference aborts, ``bayesian_active_learning_imagenet.py:221``).

    python -m network_interpretation_imagenet_tpu_torch.cli.saliency_sweep \\
        --data tests/fixtures/imagenet_loc | --synthetic [--num-images 8] \\
        [--mode knockout | --bo | --attribute METHOD] [--image-batch N] \\
        [--journal PATH --resume] [--gp-heatmaps] [--device cpu] --out outputs

Several processes, one per device (``torch.distributed``):

* ``--multihost`` strides the images across processes (process i sweeps
  images i, i+P, ...): each writes ``sweep_result.rank<i>.json`` (and a
  rank-suffixed journal and GP artifacts) and rank 0 merges them into
  ``sweep_result.json``. The process group comes from ``--coordinator
  host:port --num-processes P --process-id i``, or from torchrun's
  environment; without either it exits 2.
* ``--data-parallel`` shards each image's masks (the BO and attribution
  lanes: each flush's images) over a mesh of every process
  (``parallel.make_mesh``); every rank sweeps the same images and rank 0
  writes the result. Started by torchrun (or the coordinator flags); in a
  lone process the mesh is a world of one.
* Both: the mesh spans every process while each sweeps its own stride, so
  no sharded call meets replicated inputs and every image fails (counted,
  the run goes on), as in the JAX package, whose mesh then spans every
  process's devices and cannot fetch a result.

``--dist-backend`` overrides the process group's backend (NCCL on the card,
gloo on the CPU): gloo lets two ranks share one card, which NCCL refuses.

:func:`compute` runs the sweep and the GP-surrogate passes; :func:`main`
writes ``sweep_result.json`` (the JAX package's keys), the journal and the
GP artifacts (``gp_heatmaps.npz``, ``gp_class_heatmaps.npz``).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.cli import common
from network_interpretation_imagenet_tpu_torch.config import DATASETS
from network_interpretation_imagenet_tpu_torch.utils.logging import PhaseLogger

ATTRIBUTE_METHODS = ("gradient", "grad_input", "integrated", "smoothgrad", "gradcam",
                     "meaningful", "xrai", "occlusion", "rise", "scorecam")


def _synthetic_dataset(args, spec, n, raw_u8: bool = False):
    from network_interpretation_imagenet_tpu_torch.data.synthetic import synthetic_imagenet_image
    from network_interpretation_imagenet_tpu_torch.ops import preprocess

    for i in range(n):
        base = synthetic_imagenet_image(args.seed + i, spec.image_size)
        if spec.channels == 1:
            base = base[:, :, :1]
        if raw_u8:  # uint8 wire: /255 and normalize happen on the device
            yield np.round(base * 255.0).astype(np.uint8), None, None
            continue
        yield preprocess.normalize(torch.from_numpy(base), spec.mean, spec.std).numpy(), None, None


def parse_args(argv=None):
    p = common.build_parser(__doc__)
    p.add_argument("--num-images", type=int, default=8)
    p.add_argument("--bbox_threshold", type=int, default=180)
    p.add_argument("--trace", action="store_true", help="emit per-phase JSON logs")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard each image's mask batch over every process (a mesh of the "
                        "process group: torchrun's, or the coordinator flags')")
    p.add_argument("--image-batch", type=int, default=1,
                   help="fuse this many images' mask banks into one forward")
    p.add_argument("--mode", default="window", choices=["window", "knockout"],
                   help="mask family: contiguous windows (ImageNet reference semantics) or "
                        "random-segment knockouts (MNIST/CIFAR reference semantics)")
    p.add_argument("--num-knockout", type=int, default=1,
                   help="(--mode knockout) segments zeroed per mask "
                        "(reference: 1 for MNIST, 5 for CIFAR)")
    common.add_gp_flags(p)
    p.add_argument("--gp-heatmaps", action="store_true",
                   help="fit an exact Kronecker pixel-GP to every explained image's heatmap "
                        "in batched programs (mean + uncertainty maps -> gp_heatmaps.npz)")
    p.add_argument("--gp-class-heatmaps", action="store_true",
                   help="fit the grid-inducing probit classification GP to every explained "
                        "image's median-binarized heatmap in batched programs "
                        "(survive-probability maps -> gp_class_heatmaps.npz)")
    p.add_argument("--gp-class-iters", type=int, default=30,
                   help="(--gp-class-heatmaps) ELBO Adam iterations (the reference's "
                        "gp_classification count; --gp_iters stays the regression pass's 20)")
    p.add_argument("--bo", action="store_true",
                   help="drive the sweep with the flagship GP-EI BO path (one fused program "
                        "per flush) instead of random window masks")
    p.add_argument("--attribute", default=None, metavar="METHOD", choices=ATTRIBUTE_METHODS,
                   help="drive the sweep with a per-image attribution method instead of "
                        "masks: the gradient family runs every --image-batch images' "
                        "backwards as one stacked program (--ig-steps/--sg-samples/"
                        "--sg-sigma/--gradcam-layer); 'meaningful' = learned deletion masks "
                        "(--lm-*); occlusion/rise/scorecam run their masked forwards image "
                        "by image (--patch/--stride, --rise-*, --scorecam-channels, "
                        "--attr-mask-batch)")
    p.add_argument("--attr-mask-batch", type=int, default=None,
                   help="(--attribute occlusion/rise/scorecam) per-image forward chunk; "
                        "default keeps each method's one-shot default (occlusion/scorecam 64, "
                        "rise 250). For rise this is part of the random stream")
    common.add_method_flags(p)
    common.add_bo_flags(p)
    p.add_argument("--proposals-per-iter", type=int, default=1,
                   help="(--bo) q-batched BO proposals per GP refit")
    p.add_argument("--fidelity", action="store_true",
                   help="score every explained image's heatmap for faithfulness: "
                        "deletion/insertion AUC (one batched forward per image) + pointing "
                        "game where gt boxes exist; means land in sweep_result.json")
    p.add_argument("--fidelity-steps", type=int, default=32, help="(--fidelity) curve resolution")
    p.add_argument("--uint8-wire", action="store_true",
                   help="(--bo / --attribute) upload images as raw uint8 (1/4 the f32 bytes "
                        "per flush) and run /255 + normalize on the device; only the "
                        "batched-flush lanes support it")
    p.add_argument("--heatmap-wire", default="f32", choices=("f32", "f16", "u8"),
                   help="(--attribute) fetch each flush's heatmaps as f16 (half the bytes, "
                        "<=2^-11 rounding) or min-max u8 (a quarter; bbox/IOU exact, fidelity "
                        "ranks coarsen to 256 levels) instead of lossless f32")
    p.add_argument("--journal", default=None, metavar="PATH",
                   help="per-image outcome journal (JSONL) enabling --resume "
                        "(default <out>/sweep_journal.jsonl)")
    p.add_argument("--no-journal", dest="journal", action="store_const", const="",
                   help="disable the sweep journal")
    p.add_argument("--resume", action="store_true",
                   help="restore finished images from the journal and sweep only the rest "
                        "(per-image seeds derive from dataset indices, so results match an "
                        "uninterrupted run)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process sweep: join torch.distributed from torchrun's "
                        "environment (or the --coordinator/--num-processes/--process-id "
                        "flags), stride the image axis across processes, write per-rank "
                        "results, and merge on rank 0")
    p.add_argument("--coordinator", default=None, help="(--multihost) coordinator host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="the process group's backend (default: nccl with --device cuda, "
                        "gloo with --device cpu); gloo lets ranks share one card")
    args = p.parse_args(argv)
    if args.bo and args.attribute:
        p.error("--bo and --attribute are mutually exclusive sweep drivers")
    if args.uint8_wire and not (args.bo or args.attribute):
        p.error("--uint8-wire needs a batched-flush lane (--bo/--attribute); "
                "the window/knockout driver normalizes host-side")
    if args.heatmap_wire != "f32" and not args.attribute:
        p.error("--heatmap-wire applies to --attribute sweeps only")
    if args.heatmap_wire != "f32" and args.attribute == "meaningful":
        p.error("--heatmap-wire: 'meaningful' keeps its f32 tuple state")
    if args.heatmap_wire == "u8" and args.attribute == "xrai":
        p.error("--heatmap-wire=u8 destroys the sign of xrai's "
                "attributions; use f16 (sign-preserving) or f32")
    return args


def keeps_heatmaps(args) -> bool:
    return bool(args.gp_heatmaps or args.gp_class_heatmaps)


def journal_config(args) -> dict:
    """The row-affecting settings stamped into the journal, key for key the
    JAX package's: a ``--resume`` under other settings would average
    incomparable rows, so the journal refuses it."""
    jconfig = {
        "bo": bool(args.bo), "mode": args.mode,
        "num_mask_samples": args.num_mask_samples,
        "window_fraction": args.window_fraction,
        "num_knockout": args.num_knockout,
        # The JAX package's SegmentConfig also carries max_segments, a static
        # bound of its compiled shapes (256 from every CLI); stamping it
        # keeps the two packages' journals interchangeable.
        "segmenter": {**dataclasses.asdict(common.segment_config(args)), "max_segments": 256},
        "seed": args.seed, "dataset": args.dataset, "arch": args.arch,
        "bbox_threshold": args.bbox_threshold,
        "fidelity_steps": args.fidelity_steps if args.fidelity else 0,
        "n_iters": args.n_iters, "n_pre_samples": args.n_pre_samples,
        "proposals_per_iter": args.proposals_per_iter,
        # A journal that never saved heatmaps cannot feed a GP pass.
        "keep_heatmaps": keeps_heatmaps(args),
    }
    # The keys below are stamped only when on, as in the JAX package, so a
    # journal written without them keeps resuming.
    if args.uint8_wire:
        jconfig["uint8_wire"] = True
    if args.attribute:
        jconfig.update({
            "attribute": args.attribute,
            "ig_steps": args.ig_steps, "sg_samples": args.sg_samples,
            "sg_sigma": args.sg_sigma, "sg_squared": bool(args.sg_squared),
            "gradcam_layer": args.gradcam_layer,
        })
        if args.heatmap_wire != "f32":
            jconfig["heatmap_wire"] = args.heatmap_wire
        if args.attribute == "xrai":
            jconfig.update({"xrai_scales": args.xrai_scales})
        if args.attribute == "occlusion":
            jconfig.update({"patch": args.patch, "stride": args.stride})
        if args.attribute == "rise":
            # The chunk is part of rise's random stream.
            jconfig.update({"rise_masks": args.rise_masks, "rise_grid": args.rise_grid,
                            "rise_keep": args.rise_keep,
                            "attr_mask_batch": args.attr_mask_batch})
        if args.attribute == "scorecam":
            jconfig.update({"scorecam_channels": args.scorecam_channels})
        if args.attribute == "meaningful":
            jconfig.update({"lm_mask_size": args.lm_mask_size, "lm_iters": args.lm_iters,
                            "lm_l1": args.lm_l1, "lm_tv": args.lm_tv,
                            "lm_jitter": args.lm_jitter, "lm_baseline": args.lm_baseline})
    return jconfig


def _world():
    """(rank, process count) of this run (0, 1 without a process group)."""
    from network_interpretation_imagenet_tpu_torch.parallel import multihost

    return multihost.process_index(), multihost.process_count()


def _open_journal(args):
    """The sweep journal (None with --no-journal); rank-suffixed in a run of
    several processes (each journals, and resumes, its own work)."""
    if args.journal == "":
        return None
    from network_interpretation_imagenet_tpu_torch.saliency.journal import SweepJournal

    path = args.journal or os.path.join(args.out, "sweep_journal.jsonl")
    rank, count = _world()
    if count > 1:
        root, ext = os.path.splitext(path)
        path = f"{root}.rank{rank}{ext}"
    return SweepJournal(path, resume=args.resume, keep_heatmaps=keeps_heatmaps(args),
                        config=journal_config(args))


def _dataset(args, spec, journal, indices=None):
    """(dataset iterable, dataset_indices): with ``--data`` the localization
    or image-folder dataset read ahead by ``--workers`` threads, journaled-done
    images never decoded; otherwise the synthetic images. ``indices``: this
    process's stride of a multi-process sweep."""
    from network_interpretation_imagenet_tpu_torch.data.prefetch import prefetch

    if not (args.data and args.dataset == "imagenet"):
        dataset = _synthetic_dataset(args, spec, args.num_images, raw_u8=args.uint8_wire)
        if indices is not None:
            stride = set(indices)
            dataset = (item for i, item in enumerate(dataset) if i in stride)
        return dataset, indices
    dataset = common._cached_dataset(args.data, raw_u8=args.uint8_wire)
    n_total = min(len(dataset), args.num_images)
    base = [i for i in (range(n_total) if indices is None else indices) if i < n_total]
    if journal is not None and journal.done:
        # A resumed sweep must not re-decode the images it only skips;
        # positions then map to dataset indices (seeds stay index-derived).
        base = indices = [i for i in base if i not in journal.done]
    elif indices is not None:
        indices = base
    return prefetch(dataset, num_workers=args.workers, indices=base), indices


def _gp_surrogate_pass(res, base_chunk, fields_fn) -> dict:
    """Stack the kept heatmaps and run ``fields_fn(heats, chunk)`` (chunked
    batched fits); returns the artifact's arrays and the pass's seconds."""
    idxs = sorted(res.heatmaps)
    heats = np.stack([res.heatmaps[i] for i in idxs]).astype(np.float32)
    t0 = time.perf_counter()
    fields = fields_fn(heats, base_chunk)
    return {"indices": np.asarray(idxs), "heatmaps": heats, **fields}, \
        time.perf_counter() - t0


def _kron_fields(args, device, mesh):
    from network_interpretation_imagenet_tpu_torch.gp import kron

    def fields(heats, chunk):
        params, means, vars_ = [], [], []
        for lo in range(0, len(heats), chunk):
            p_c, m_c, v_c, _ = kron.fit_posterior_batch(heats[lo:lo + chunk], iters=args.gp_iters,
                                                        lr=args.gp_lr, device=device, mesh=mesh)
            params.extend(p_c)
            means.append(m_c.cpu().numpy())
            vars_.append(v_c.cpu().numpy())
        return {"gp_mean": np.concatenate(means), "gp_var": np.concatenate(vars_),
                "lengthscales": np.asarray([float(np.exp(float(p.log_lengthscale)))
                                            for p in params])}

    return fields


def _class_fields(args, device, mesh):
    from network_interpretation_imagenet_tpu_torch.gp import variational as vgp

    def fields(heats, chunk):
        n_img, h, w = heats.shape
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        coords = np.stack([yy.ravel(), xx.ravel()], axis=1).astype(np.float32)
        flat = heats.reshape(n_img, -1)
        ys = (flat > np.median(flat, axis=1, keepdims=True)).astype(np.float32)  # median split
        model = vgp.init_model(max(h, w), grid_size=min(args.grid_size, 10), device=device)
        probs = []
        for lo in range(0, n_img, chunk):
            _, p_c, _ = vgp.fit_predict_batch(model, coords, ys[lo:lo + chunk],
                                              iters=args.gp_class_iters, lr=args.gp_lr,
                                              return_models=False, mesh=mesh)
            probs.append(p_c.cpu().numpy())
        return {"survive_proba": np.concatenate(probs).reshape(n_img, h, w)}

    return fields


def run_sweep(args, engine, dataset, dataset_indices, journal, mesh=None):
    """The sweep ``args`` ask for: attribution, BO, or window/knockout."""
    from network_interpretation_imagenet_tpu_torch.saliency import sweep

    spec = DATASETS[args.dataset]
    common_kw = dict(bbox_threshold=args.bbox_threshold, max_images=args.num_images,
                     seed=args.seed, logger=PhaseLogger(enabled=args.trace),
                     keep_heatmaps=keeps_heatmaps(args), dataset_indices=dataset_indices,
                     journal=journal, fidelity_steps=args.fidelity_steps if args.fidelity else 0,
                     mesh=mesh)
    normalize = (spec.mean, spec.std) if args.uint8_wire else None
    if args.attribute:
        return sweep.attribution_sweep(
            engine, dataset, method=args.attribute, image_batch=max(args.image_batch, 1),
            steps=args.ig_steps, samples=args.sg_samples, noise_sigma=args.sg_sigma,
            magnitude=args.sg_squared, gradcam_layer=args.gradcam_layer,
            lm_cfg={"mask_size": args.lm_mask_size, "iters": args.lm_iters, "l1": args.lm_l1,
                    "tv": args.lm_tv, "jitter": args.lm_jitter, "baseline": args.lm_baseline}
            if args.attribute == "meaningful" else None,
            xrai_scales=common.parse_xrai_scales(args.xrai_scales)
            if args.attribute == "xrai" else None,
            normalize=normalize, heatmap_wire=args.heatmap_wire, patch=args.patch,
            stride=args.stride, rise_masks=args.rise_masks, rise_grid=args.rise_grid,
            rise_keep_prob=args.rise_keep, mask_batch=args.attr_mask_batch,
            scorecam_channels=args.scorecam_channels, **common_kw)
    if args.bo:
        from network_interpretation_imagenet_tpu_torch.config import BOConfig

        return sweep.bo_saliency_sweep(
            engine, dataset, common.segment_config(args),
            bo_cfg=BOConfig(n_iters=args.n_iters, n_pre_samples=args.n_pre_samples),
            window_fraction=args.window_fraction, image_batch=max(args.image_batch, 1),
            proposals_per_iter=args.proposals_per_iter, normalize=normalize, **common_kw)
    return sweep.saliency_sweep(
        engine, dataset, common.segment_config(args), num_mask_samples=args.num_mask_samples,
        window_fraction=args.window_fraction, image_batch=args.image_batch, mode=args.mode,
        num_knockout=args.num_knockout, **common_kw)


def compute(args):
    """Run the sweep and the GP-surrogate passes. Returns ``(payload, res,
    artifacts)``: the result JSON (the JAX package's keys), the
    ``SweepResult``, and ``{name: arrays}`` of the GP passes' npz files.
    In a multi-process run (see :func:`main`) these are this process's."""
    from network_interpretation_imagenet_tpu_torch.parallel import make_mesh, multihost
    from network_interpretation_imagenet_tpu_torch.parallel.mesh import axis_size

    engine = common.build_engine(args)
    mesh = make_mesh(device=args.device) if args.data_parallel else None
    strided = (list(multihost.process_strided_indices(args.num_images))
               if args.multihost else None)
    journal = _open_journal(args)
    try:
        dataset, indices = _dataset(args, DATASETS[args.dataset], journal, strided)
        res = run_sweep(args, engine, dataset, indices, journal, mesh)
    finally:
        if journal is not None:
            journal.close()
    # Scalar fields only: per-image rows and heatmaps stay out of the JSON.
    payload = {f.name: getattr(res, f.name) for f in dataclasses.fields(res)
               if f.name not in ("per_image", "heatmaps")}
    payload["per_image_count"] = res.images_explained
    artifacts = {}
    passes = ((args.gp_heatmaps, "gp_heatmaps", 32, _kron_fields),
              (args.gp_class_heatmaps, "gp_class_heatmaps", 16, _class_fields))
    for on, key, chunk, fields_fn in passes:
        if on and res.heatmaps:
            # One batched program per chunk of images: the whole sweep's fits
            # (the reference fits one image per process,
            # gp_superpixel_data_imagenet.py:578-663). On a mesh the chunk
            # grows with the data axis, so each rank still fits ~chunk grids.
            if mesh is not None:
                chunk *= axis_size(mesh, "data")
            artifacts[key], seconds = _gp_surrogate_pass(res, chunk,
                                                         fields_fn(args, engine.device, mesh))
            payload[key] = {"images": len(artifacts[key]["indices"]),
                            "seconds": round(seconds, 3), "artifact": f"{key}.npz"}
    return payload, res, artifacts


def write_artifacts(args, payload, artifacts) -> None:
    os.makedirs(args.out, exist_ok=True)
    for key, arrays in artifacts.items():
        np.savez_compressed(os.path.join(args.out, f"{key}.npz"), **arrays)
    common.emit_result(args.out, "sweep_result.json", payload)


def _join(args) -> bool:
    """Join the process group of a multi-process run (--multihost or
    --data-parallel). False when --multihost finds no coordinator."""
    from network_interpretation_imagenet_tpu_torch.parallel import multihost

    if not (args.multihost or args.data_parallel):
        return True
    joined = multihost.initialize_distributed(args.coordinator, args.num_processes,
                                              args.process_id, backend=args.dist_backend,
                                              device=args.device)
    if args.multihost and not joined:
        return False
    if args.multihost and multihost.process_count() > 1:
        multihost.clear_stale_rank_result(args.out)
        # init_process_group is no barrier: without one, rank 0's merge could
        # read another rank's stale file of an earlier run.
        multihost.barrier()
    return True


def _merge(args, payload, artifacts):
    """Rank 0's payload of a --multihost run: every rank's result merged,
    with this run's per-rank GP artifacts listed."""
    from network_interpretation_imagenet_tpu_torch.parallel import multihost

    count = multihost.process_count()
    merged = multihost.merge_rank_results(args.out, count)
    gp_infos = {k: payload.get(k) for k in ("gp_heatmaps", "gp_class_heatmaps")}
    payload = {f.name: getattr(merged, f.name) for f in dataclasses.fields(merged)
               if f.name not in ("per_image", "heatmaps")}
    payload["per_image_count"] = merged.images_explained
    payload["process_count"] = count
    for key, info in gp_infos.items():
        if info is not None:
            # This run's ranks only: a glob would take an earlier, larger
            # world's stale rank files.
            info["artifacts"] = [f"{key}.rank{r}.npz" for r in range(count)
                                 if os.path.exists(os.path.join(args.out, f"{key}.rank{r}.npz"))]
            payload[key] = info
    return payload


def main(argv=None) -> int:
    args = parse_args(argv)
    if not _join(args):
        # No coordinator anywhere: refusing beats N processes each sweeping
        # every image as rank 0, racing on --out.
        print("error: --multihost could not initialize torch.distributed — pass "
              "--coordinator/--num-processes/--process-id or set MASTER_ADDR, MASTER_PORT, "
              "WORLD_SIZE and RANK (torchrun)", file=sys.stderr)
        return 2
    payload, res, artifacts = compute(args)
    rank, count = _world()
    if count > 1 and args.multihost:
        from network_interpretation_imagenet_tpu_torch.parallel import multihost

        os.makedirs(args.out, exist_ok=True)
        for key, arrays in artifacts.items():
            payload[key]["artifact"] = f"{key}.rank{rank}.npz"
            np.savez_compressed(os.path.join(args.out, f"{key}.rank{rank}.npz"), **arrays)
        multihost.write_rank_result(args.out, res)
        if rank != 0:
            return 0
        common.emit_result(args.out, "sweep_result.json", _merge(args, payload, artifacts))
        return 0
    if rank != 0:
        return 0   # --data-parallel: every rank holds the same result; rank 0 writes it
    write_artifacts(args, payload, artifacts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
