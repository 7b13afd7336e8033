"""Export a serving artifact for a classifier (serving.py; port of
``cli/export_serving.py`` of the JAX package).

Writes the manifest(s) and the weights (``variables.msgpack``, the JAX
package's layout) that ``cli.serve`` loads. ``--ckpt`` takes every weights
format ``cli.common.build_engine`` reads; without one the weights are
seeded random::

    python -m network_interpretation_imagenet_tpu_torch.cli.export_serving \
        --arch resnet50 --ckpt resnet50.pth.tar --out ./artifact \
        --batch-sizes 1024,256,32 [--bo --bo-image-batches 4]
"""

from __future__ import annotations

import sys

from network_interpretation_imagenet_tpu_torch.cli import common


def main(argv=None) -> int:
    p = common.build_parser(__doc__.splitlines()[0])
    p.add_argument("--batch-sizes", default="1024,256,32",
                   help="comma-separated mask-batch buckets to export")
    p.add_argument("--no-weights", action="store_true",
                   help="exclude weights from the artifact (pass variables "
                        "at load time instead)")
    p.add_argument("--knockout-m", type=int, default=0,
                   help="also export knockout-mask forwards with M "
                        "knockouts per mask (reference MNIST=1 / CIFAR=5 "
                        "semantics; m<=M requests pad with the -1 sentinel)")
    p.add_argument("--attribution", default="",
                   help="comma-separated attribution programs to bundle "
                        "(gradient, grad_input, integrated, smoothgrad, "
                        "gradcam, scorecam, occlusion, rise, meaningful, "
                        "xrai), served by "
                        "ExportedSaliencyServer.attribute / POST /attribute "
                        "(xrai: signed IG on the device + host greedy "
                        "ranking, ExportedSaliencyServer.xrai)")
    p.add_argument("--attribution-batches", default="",
                   help="comma-separated N: also serve image-BATCHED "
                        "gradient-family attributions (one stacked backward "
                        "of up to N images, POST /attribute_batch)")
    p.add_argument("--gradcam-layer", default=None,
                   help="intermediate layer for the gradcam export "
                        "(default: the deepest conv stage, resolved at "
                        "export time)")
    p.add_argument("--ig-steps", type=int, default=16,
                   help="integrated-gradients path steps")
    p.add_argument("--sg-samples", type=int, default=16,
                   help="smoothgrad noise samples")
    p.add_argument("--sg-sigma", type=float, default=0.15,
                   help="smoothgrad relative noise sigma")
    p.add_argument("--bo", action="store_true",
                   help="also export the fused BO loop (the full "
                        "active-learning explanation, one CUDA graph per "
                        "shape on the card)")
    p.add_argument("--candidate-buckets", default="32,64",
                   help="pow-2 BO candidate buckets to export with --bo")
    p.add_argument("--bo-image-batches", default="",
                   help="comma-separated image-batch sizes: also export "
                        "image-BATCHED fused BO loops (N loops whose "
                        "forwards batch the N images, served by "
                        "explain_batch; e.g. 16)")
    common.add_bo_flags(p)
    args = p.parse_args(argv)
    if args.bo_image_batches.strip() and not args.bo:
        p.error("--bo-image-batches requires --bo (it sizes the image-"
                "batched fused-BO exports)")

    from network_interpretation_imagenet_tpu_torch import serving

    engine = common.build_engine(args)
    batch_sizes = tuple(
        int(b.strip()) for b in args.batch_sizes.split(",") if b.strip()
    )
    manifest = serving.export_engine(
        engine, args.out, batch_sizes=batch_sizes,
        include_weights=not args.no_weights,
        knockout_m=args.knockout_m,
        attribution=tuple(
            m.strip() for m in args.attribution.split(",") if m.strip()
        ),
        attribution_batches=tuple(
            int(b.strip()) for b in args.attribution_batches.split(",")
            if b.strip()
        ),
        attribution_cfg={
            "ig_steps": args.ig_steps, "sg_samples": args.sg_samples,
            "sg_sigma": args.sg_sigma, "gradcam_layer": args.gradcam_layer,
        },
    )
    if args.bo:
        from network_interpretation_imagenet_tpu_torch.config import BOConfig

        bo_manifest = serving.export_bo_engine(
            engine, args.out,
            bo_cfg=BOConfig(n_iters=args.n_iters,
                            n_pre_samples=args.n_pre_samples),
            candidate_buckets=tuple(
                int(b.strip()) for b in args.candidate_buckets.split(",")
                if b.strip()
            ),
            image_batches=tuple(
                int(b.strip()) for b in args.bo_image_batches.split(",")
                if b.strip()
            ),
            include_weights=False,  # shared variables.msgpack already written
        )
        manifest = {**manifest, "bo": bo_manifest["bo"],
                    "bo_files": bo_manifest["files"]}
    common.emit_result(args.out, "export_result.json", {
        "artifact": args.out, **manifest,
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
