"""Torch checkpoint -> the weights artifact (port of
``cli/convert_checkpoint.py`` of the JAX package)::

    python -m network_interpretation_imagenet_tpu_torch.cli.convert_checkpoint \\
        --ckpt resnet101.pth --arch resnet101 --out weights/resnet101

reads a torch checkpoint once (``utils.convert.convert_checkpoint``) and
writes the JAX package's artifact directory: ``weights.msgpack`` (the
variables in the JAX layout, ``utils.convert.jax_variables``) and
``meta.json`` (the arch flags). Both packages' CLIs take it as ``--ckpt``.
``--verify`` reads it back and checks every array bit for bit. ``--fetch``
downloads torchvision's published checkpoint for ``--arch`` first; it needs
network access and fails with a message without it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

# torchvision's published checkpoints (its 0.13-era default weights), by arch.
TORCHVISION_URLS = {
    "alexnet": "https://download.pytorch.org/models/alexnet-owt-7be5be79.pth",
    "vgg11": "https://download.pytorch.org/models/vgg11-8a719046.pth",
    "vgg13": "https://download.pytorch.org/models/vgg13-19584684.pth",
    "vgg16": "https://download.pytorch.org/models/vgg16-397923af.pth",
    "vgg19": "https://download.pytorch.org/models/vgg19-dcbb9e9d.pth",
    "vgg11_bn": "https://download.pytorch.org/models/vgg11_bn-6002323d.pth",
    "vgg13_bn": "https://download.pytorch.org/models/vgg13_bn-abd245e5.pth",
    "vgg16_bn": "https://download.pytorch.org/models/vgg16_bn-6c64b313.pth",
    "vgg19_bn": "https://download.pytorch.org/models/vgg19_bn-c79401a0.pth",
    "resnet18": "https://download.pytorch.org/models/resnet18-f37072fd.pth",
    "resnet34": "https://download.pytorch.org/models/resnet34-b627a593.pth",
    "resnet50": "https://download.pytorch.org/models/resnet50-0676ba61.pth",
    "resnet101": "https://download.pytorch.org/models/resnet101-63fe2227.pth",
    "resnet152": "https://download.pytorch.org/models/resnet152-394f9c45.pth",
    "resnext50_32x4d": "https://download.pytorch.org/models/resnext50_32x4d-7cdf4587.pth",
    "resnext101_32x8d": "https://download.pytorch.org/models/resnext101_32x8d-8ba56ff5.pth",
    "wide_resnet50_2": "https://download.pytorch.org/models/wide_resnet50_2-95faca4d.pth",
    "wide_resnet101_2": "https://download.pytorch.org/models/wide_resnet101_2-32ee1156.pth",
    "squeezenet1_0": "https://download.pytorch.org/models/squeezenet1_0-b66bff10.pth",
    "squeezenet1_1": "https://download.pytorch.org/models/squeezenet1_1-b8a52dc0.pth",
    "densenet121": "https://download.pytorch.org/models/densenet121-a639ec97.pth",
    "densenet169": "https://download.pytorch.org/models/densenet169-b2777c0a.pth",
    "densenet201": "https://download.pytorch.org/models/densenet201-c1103571.pth",
    "inception_v3": "https://download.pytorch.org/models/inception_v3_google-0cc3c7bd.pth",
    "googlenet": "https://download.pytorch.org/models/googlenet-1378be20.pth",
    "mobilenet_v2": "https://download.pytorch.org/models/mobilenet_v2-b0353104.pth",
    "shufflenet_v2_x0_5": "https://download.pytorch.org/models/shufflenetv2_x0.5-f707e7126e.pth",
    "shufflenet_v2_x1_0": "https://download.pytorch.org/models/shufflenetv2_x1-5666bf0f80.pth",
    "mnasnet0_5": "https://download.pytorch.org/models/mnasnet0.5_top1_67.823-3ffadce67e.pth",
    "mnasnet1_0": "https://download.pytorch.org/models/mnasnet1.0_top1_73.512-f206786ef8.pth",
}


def fetch_torchvision_checkpoint(arch: str, dest_dir: str) -> str:
    """Download torchvision's checkpoint of ``arch`` into ``dest_dir`` (kept
    there; a second call reuses it). Raises ``RuntimeError`` where the
    download fails, as it does on a host without network access."""
    import urllib.error
    import urllib.request

    if arch not in TORCHVISION_URLS:
        raise ValueError(f"no published torchvision URL for arch {arch!r}; "
                         f"known: {sorted(TORCHVISION_URLS)}")
    url = TORCHVISION_URLS[arch]
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, os.path.basename(url))
    if os.path.exists(dest):
        return dest
    try:
        urllib.request.urlretrieve(url, dest + ".tmp")
    except (urllib.error.URLError, OSError) as e:
        raise RuntimeError(f"could not fetch {url}: {e}. On a host without network access, "
                           "download the file elsewhere and pass it as --ckpt.") from e
    os.replace(dest + ".tmp", dest)
    return dest


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", default=None, help="torch .pth / .pth.tar to convert")
    p.add_argument("--fetch", action="store_true",
                   help="download torchvision's checkpoint for --arch first (needs network)")
    p.add_argument("--arch", "-a", required=True)
    p.add_argument("--dataset", default="imagenet")
    p.add_argument("--depth", "-d", type=int, default=56,
                   help="depth of the CIFAR resnet / densenet")
    p.add_argument("--growth-rate", type=int, default=12)
    p.add_argument("--bn-size", type=int, default=4)
    p.add_argument("--compression", type=float, default=0.5)
    p.add_argument("--out", required=True,
                   help="artifact directory to write (weights.msgpack + meta.json)")
    p.add_argument("--verify", action="store_true",
                   help="after writing, read the artifact back and check every array bit "
                        "for bit")
    args = p.parse_args(argv)

    from network_interpretation_imagenet_tpu_torch.utils import convert

    ckpt = args.ckpt
    if args.fetch:
        ckpt = fetch_torchvision_checkpoint(args.arch, os.path.join(args.out, "_torch_src"))
        print(f"fetched {ckpt}")
    if not ckpt:
        p.error("--ckpt (or --fetch) is required")

    state_dict = convert.convert_checkpoint(ckpt, args.arch, depth=args.depth,
                                            bn_size=args.bn_size)
    module = convert.meta_module(args.arch, args.depth, args.bn_size, dataset=args.dataset,
                                 growth_rate=args.growth_rate, compression=args.compression)
    variables = convert.jax_variables(state_dict, module)
    meta = convert.save_weights_artifact(variables, args.out, meta={
        "arch": args.arch, "dataset": args.dataset, "depth": args.depth,
        "growth_rate": args.growth_rate, "bn_size": args.bn_size,
        "compression": args.compression, "source": os.path.basename(ckpt)})
    leaves = list(_leaves(variables))
    if args.verify:
        reloaded = list(_leaves(convert.load_weights_artifact(args.out)[0]))
        assert len(leaves) == len(reloaded)
        for a, b in zip(leaves, reloaded):
            np.testing.assert_array_equal(a, b)
        print(f"verified {len(leaves)} leaves bit-identical")
    print(json.dumps({"out": args.out, "meta": meta,
                      "params": sum(int(np.prod(a.shape)) for a in leaves)}))
    return 0


def _leaves(tree):
    """The arrays of nested dicts in sorted-key order (as jax.tree.leaves)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k])
        else:
            yield tree[k]


if __name__ == "__main__":
    sys.exit(main())
