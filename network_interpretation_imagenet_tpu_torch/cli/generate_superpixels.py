"""Superpixel demo CLI (reference ``generate_superpixels.py:1-32``): segment
one or two images and save a boundary-marked side-by-side figure. It runs
no model.

    python -m network_interpretation_imagenet_tpu_torch.cli.generate_superpixels \\
        --data tests/fixtures/imagenet_loc [--images a.jpg b.jpg] --out outputs

Without ``--images`` it segments the images ``--eval_img_index`` and the one
after it. :func:`compute` segments; :func:`main` also writes
``superpixels.png`` (matplotlib) and ``superpixels.json``.
"""

from __future__ import annotations

import copy
import os

import numpy as np

from network_interpretation_imagenet_tpu_torch.cli import common


def parse_args(argv=None):
    p = common.build_parser(__doc__)
    p.add_argument("--images", nargs="*", default=[], help="image file paths")
    return p.parse_args(argv)


def compute(args):
    """Returns ``(payload, result)``: the JSON payload (without the figure's
    path), and the display images with their label maps."""
    cfg = common.segment_config(args)
    if args.images:
        from PIL import Image

        displays = []
        for path in args.images[:2]:
            with Image.open(path) as f:
                displays.append(np.asarray(f.convert("RGB")))
    else:
        second = copy.copy(args)
        second.eval_img_index = args.eval_img_index + 1
        displays = [common.resolve_image(a)[1] for a in (args, second)]
    segments = [common.segment_display(disp, cfg, args.device) for disp in displays]
    counts = [int(seg.max()) + 1 for seg in segments]
    for i, n in enumerate(counts):
        print(f"image {i}: {n} segments")
    return {"segments": counts, "method": cfg.method}, {"displays": displays,
                                                         "segments": segments}


def write_artifacts(args, payload, result) -> None:
    from network_interpretation_imagenet_tpu_torch.saliency.viz import mark_boundaries, save_panels

    out = os.path.join(args.out, "superpixels.png")
    save_panels(out, [mark_boundaries(d, s) for d, s in zip(result["displays"],
                                                             result["segments"])],
                [f"img{i}: {n} segments ({payload['method']})"
                 for i, n in enumerate(payload["segments"])])
    common.emit_result(args.out, "superpixels.json", {"figure": out, **payload})


def main(argv=None):
    args = parse_args(argv)
    write_artifacts(args, *compute(args))


if __name__ == "__main__":
    main()
