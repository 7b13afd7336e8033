"""Weights across the two packages.

:func:`resnet_from_jax` is the inverse of the JAX package's
``utils/convert.py:convert_resnet_imagenet``: flax ``{params, batch_stats}``
(numpy arrays) of an ImageNet ResNet -> this package's torchvision-keyed
``state_dict``.

  * conv kernel HWIO [kH, kW, I, O] -> weight OIHW [O, I, kH, kW] (a grouped
    kernel, flax's [kH, kW, I/g, O], becomes torch's [O, I/g, kH, kW] by the
    same transpose)
  * dense kernel [in, out]         -> weight [out, in]
  * BatchNorm scale / bias / mean / var -> weight / bias / running_mean / running_var
  * ``layer{s}_{b}`` -> ``layer{s}.{b}``; ``downsample_conv`` / ``downsample_bn``
    -> ``downsample.0`` / ``downsample.1``
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_RENAME = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}


def torch_name(flax_path) -> str:
    parts = []
    for p in flax_path:
        if p.startswith("layer") and "_" in p:
            parts.append(p.replace("_", "."))
        else:
            parts.append(_RENAME.get(p, p))
    return ".".join(parts)


def resnet_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    stats = variables.get("batch_stats", {})

    def walk(params, stats, path):
        if "kernel" in params:
            k = np.asarray(params["kernel"], np.float32)
            w = np.transpose(k, (3, 2, 0, 1)) if k.ndim == 4 else k.T
            sd[torch_name(path) + ".weight"] = torch.from_numpy(np.ascontiguousarray(w))
            if "bias" in params:
                sd[torch_name(path) + ".bias"] = torch.from_numpy(
                    np.asarray(params["bias"], np.float32).copy())
            return
        if "scale" in params:
            name = torch_name(path)
            for src, dst in (("scale", "weight"), ("bias", "bias")):
                sd[f"{name}.{dst}"] = torch.from_numpy(np.asarray(params[src], np.float32).copy())
            for src, dst in (("mean", "running_mean"), ("var", "running_var")):
                sd[f"{name}.{dst}"] = torch.from_numpy(np.asarray(stats[src], np.float32).copy())
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
            return
        for key in params:
            walk(params[key], stats.get(key, {}), path + (key,))

    walk(variables["params"], stats, ())
    return sd
