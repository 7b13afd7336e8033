"""Sanity-check attribution methods by cascading parameter randomization
(Adebayo et al., NeurIPS 2018): port of ``cli/attribution_sanity.py`` of the
JAX package.

For each method, re-randomize the classifier's modules one at a time from
the output side (cumulatively) and report the Spearman rank correlation of
each stage's heatmap against the trained model's. Sound methods decay
toward 0; a method that stays near 1 under a random network explains the
image, not the model.

    python -m network_interpretation_imagenet_tpu_torch.cli.attribution_sanity \\
        --data tests/fixtures/imagenet_loc --methods gradient,integrated,gradcam \\
        [--device cpu] --out outputs

:func:`compute` returns the ``sanity_check.json`` payload (the JAX
package's keys); :func:`main` prints the table and writes it.
"""

from __future__ import annotations

from network_interpretation_imagenet_tpu_torch.cli import common
from network_interpretation_imagenet_tpu_torch.cli.compare_saliency_methods import (
    METHODS,
    heatmap,
)
from network_interpretation_imagenet_tpu_torch.saliency import sanity
from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine

# Methods without the engine's mask machinery: the default set.
_DEFAULT = "gradient,grad_input,integrated,smoothgrad,gradcam"


def parse_args(argv=None):
    p = common.build_parser(__doc__)
    p.add_argument("--methods", default=_DEFAULT, help=f"comma list from {','.join(METHODS)}")
    common.add_method_flags(p, sg_samples=8, lm_iters=50, lm_jitter=2)
    common.add_bo_flags(p)
    args = p.parse_args(argv)
    args.method_list = list(dict.fromkeys(m.strip() for m in args.methods.split(",")
                                          if m.strip()))
    unknown = [m for m in args.method_list if m not in METHODS]
    if unknown:
        p.error(f"unknown methods {unknown}; choose from {METHODS}")
    return args


def compute(args) -> dict:
    methods = args.method_list
    image, disp, _, _ = common.resolve_image(args)
    engine = common.build_engine(args)
    segments = common.segment_display(disp, common.segment_config(args), args.device)
    target = int(engine.predict_one(image)[0])
    bundle = engine.bundle
    stages = sanity.randomization_stages(bundle)
    random_vars = sanity.fresh_random_variables(bundle, args.seed)
    base = {m: heatmap(m, engine, image, disp, segments, target, args) for m in methods}
    report = {m: [] for m in methods}
    done = []
    # Stage-outer: each spliced state dict builds one engine, shared by the methods.
    for stage in stages:
        done.append(stage)
        rand = sanity.randomize_modules(engine.variables, random_vars, done, bundle)
        eng = SaliencyEngine(bundle, rand, mask_batch=args.mask_batch,
                             compute_dtype=engine.compute_dtype, device=engine.device)
        for m in methods:
            heat = heatmap(m, eng, image, disp, segments, target, args)
            report[m].append({"randomized_through": stage,
                              "spearman": round(sanity.spearman_abs(base[m], heat), 4)})
    return {"target": target, "stages": stages, "methods": report}


def main(argv=None):
    args = parse_args(argv)
    payload = compute(args)
    stages, report = payload["stages"], payload["methods"]
    width = max(len(s) for s in stages)
    print(f"{'stage (cumulative)':>{width + 4}}  " + "  ".join(f"{m:>11}" for m in report))
    for i, s in enumerate(stages):
        print(f"{s:>{width + 4}}  " + "  ".join(f"{report[m][i]['spearman']:>11.3f}"
                                               for m in report))
    common.emit_result(args.out, "sanity_check.json", payload)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
