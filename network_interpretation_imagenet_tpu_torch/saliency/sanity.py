"""Attribution sanity checks (Adebayo et al., NeurIPS 2018): port of
``saliency/sanity.py`` of the JAX package.

Cascading parameter randomization: re-randomize the classifier one top-level
module at a time, output side first, and measure how far each method's
heatmap moves (Spearman rank correlation of |heat| against the trained
model's map). Modules are named as the JAX package names them (``fc``,
``layer4_2``, ..., ``bn1``, ``conv1``; for the zoo ``fc2``, ``conv12``, ...,
``Mixed_7c``); a module's state-dict entries are every key of the torch
modules that compute it (:func:`module_names`), BatchNorm running
statistics included, so a randomized BatchNorm keeps no trained statistics.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch
from scipy.stats import rankdata


def spearman_abs(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation of |a| vs |b| (flattened), ties averaged.
    Constant inputs have no ranking: 0.0 rather than NaN."""
    x = np.abs(np.asarray(a, np.float64)).ravel()
    y = np.abs(np.asarray(b, np.float64)).ravel()
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {x.shape} vs {y.shape}")
    if np.ptp(x) == 0 or np.ptp(y) == 0:
        return 0.0
    rx = rankdata(x) - (len(x) + 1) / 2.0
    ry = rankdata(y) - (len(y) + 1) / 2.0
    denom = np.sqrt((rx ** 2).sum() * (ry ** 2).sum())
    return float((rx * ry).sum() / denom) if denom else 0.0


def _host(heat) -> np.ndarray:
    return heat.detach().cpu().numpy() if isinstance(heat, torch.Tensor) else np.asarray(heat)


def fresh_random_variables(bundle, seed: int = 0) -> dict:
    """A full re-draw from the model's own init distribution (the paper's
    randomization source): ``bundle.init(seed + 7919)``, on the CPU."""
    return bundle.init(int(seed) + 7919)


def module_names(module) -> dict:
    """{state-dict key: the JAX package's top-level module name} for every
    key of ``module`` that the JAX model has (``layer4.2.conv1.weight`` ->
    ``layer4_2``, VGG's ``features.3.weight`` -> ``conv1``, ``fc.bias`` ->
    ``fc``), from the module's ``flax_paths`` and ``torch_name``. Keys of
    train-only heads the JAX model lacks (Inception's ``AuxLogits``) have
    none."""
    owner = {module.torch_name(p): p.split("/")[0] for p in module.flax_paths()}
    return {k: owner[k.rpartition(".")[0]] for k in module.state_dict()
            if k.rpartition(".")[0] in owner}


def randomization_stages(bundle) -> list:
    """Top-level module names, output side first: the module definition
    order (``conv1``, ``bn1``, ``layer1_0``, ..., ``fc``) reversed."""
    return list(reversed(list(dict.fromkeys(module_names(bundle.module).values()))))


def randomize_modules(variables: dict, random_variables: dict, modules: Sequence[str],
                      bundle) -> dict:
    """``variables`` with every entry of ``modules`` (``bundle``'s top-level
    names) taken from ``random_variables`` (moved to its tensor's device),
    weights and BatchNorm statistics alike."""
    modules = set(modules)
    names = module_names(bundle.module)
    return {k: (random_variables[k].to(v.device, v.dtype)
                if names.get(k) in modules and k in random_variables else v)
            for k, v in variables.items()}


def cascading_randomization(heatmap_fn: Callable[[Any], np.ndarray], bundle, variables: dict,
                            seed: int = 0, stages: Sequence[str] = None,
                            random_variables: dict = None) -> dict:
    """The cascading test for one method. ``heatmap_fn(variables) -> heat``;
    returns ``{"stages": [(module, spearman_vs_trained), ...]}`` with modules
    randomized cumulatively from the output side (the last row is the fully
    random network). ``random_variables`` shares one draw across methods."""
    if random_variables is None:
        random_variables = fresh_random_variables(bundle, seed)
    base = _host(heatmap_fn(variables))
    if stages is None:
        stages = randomization_stages(bundle)
    rows, done = [], []
    for stage in stages:
        done.append(stage)
        heat = _host(heatmap_fn(randomize_modules(variables, random_variables, done, bundle)))
        rows.append((stage, spearman_abs(base, heat)))
    return {"stages": rows}
