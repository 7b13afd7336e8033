"""Serving artifacts for the masked-forward engine and the fused BO loop
(port of ``serving.py`` of the JAX package).

The JAX package exports StableHLO per bucket, so that a serving host runs
no model code and compiles nothing cold. The port cannot export StableHLO,
and ``torch.export`` would drop its kernels (B1 and B2 launch through
``ctypes``, they are not torch ops). Its artifact is therefore the JAX
package's manifest and weights without the program files:

  * ``manifest.json`` (:func:`export_engine`) and ``bo_manifest.json``
    (:func:`export_bo_engine`) hold every key of the JAX package's
    manifests with its values. The program-file maps keep their keys
    (buckets, methods, image batches) with the value ``null``, and
    ``export_platform`` reads ``"cuda"`` or ``"cpu"`` (recorded, not
    enforced: nothing is lowered per platform). One entry is added,
    ``"model"``: ``create_model``'s arguments, without which a CIFAR
    ``resnet`` of depth 56 and one of depth 110 look alike. The BO
    manifest's ``"bo"`` also records ``alpha``, ``epsilon`` and
    ``lengthscale_grid``, which the JAX package bakes into its programs.
  * ``variables.msgpack``: the weights in the JAX package's layout, written
    by the port's own codec (``utils.convert.msgpack_dumps``), byte for byte
    what the JAX package writes for the same variables.

:func:`load_exported` and :func:`load_exported_bo` rebuild the programs from
the port's modules (``create_model`` -> ``from_jax`` -> ``SaliencyEngine``)
on the device the caller names (the card unless ``device="cpu"``), so every
served forward runs the engine's plan: B1 builds each window bucket and B2
runs the ImageNet ResNets' chains. ``warmup()`` is the compile step: it
builds the kernels, runs every bucket once and brings every exported BO
shape to a captured CUDA graph. The loaders also read an artifact the JAX
package wrote (its ``.stablehlo`` files are ignored) wherever
``create_model``'s call follows from ``arch``, ``num_classes`` and
``input_channels``: the ImageNet zoo and ``mnist_cnn``.

Random draws: the served BO loop draws from a CPU ``torch.Generator``
seeded with the request's seed (``bo.loop.window_draws``), SmoothGrad,
RISE and the learned mask as the port's functions do, so a served result
equals the port's library call with that seed, and the JAX package's only
when its draws are handed in. Window and knockout requests sample on the
host with numpy in both packages.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Any, Sequence

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.bo.loop import (
    make_fused_window_bo,
    next_pow2,
    window_draws,
)
from network_interpretation_imagenet_tpu_torch.config import BOConfig
from network_interpretation_imagenet_tpu_torch.models import create_model
from network_interpretation_imagenet_tpu_torch.ops import aggregate, masking
from network_interpretation_imagenet_tpu_torch.ops.masked_batch import masked_batch
from network_interpretation_imagenet_tpu_torch.saliency import gradient as g
from network_interpretation_imagenet_tpu_torch.saliency import learned_mask as lm
from network_interpretation_imagenet_tpu_torch.saliency import xrai as xrai_mod
from network_interpretation_imagenet_tpu_torch.saliency.bo_pipeline import (
    _assemble_output,
    _collect_multi_outputs,
    _multi_geometry,
    _traces,
)
from network_interpretation_imagenet_tpu_torch.saliency.engine import (
    MaskEvalResult,
    SaliencyEngine,
)
from network_interpretation_imagenet_tpu_torch.segment.felzenszwalb import felzenszwalb_ladder
from network_interpretation_imagenet_tpu_torch.utils.convert import (
    from_jax,
    jax_variables,
    msgpack_dumps,
    msgpack_loads,
)

MANIFEST = "manifest.json"
WEIGHTS = "variables.msgpack"
BO_MANIFEST = "bo_manifest.json"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# create_model's keyword arguments that the "model" entry records.
_MODEL_KEYS = ("depth", "death_mode", "death_rate", "growth_rate", "bn_size", "compression")
# Archs whose create_model call needs more than the JAX manifest holds.
_NEEDS_MODEL_ENTRY = ("resnet", "densenet")
# The manifest keys that fix a served model's engine (both artifact kinds).
_ENGINE_KEYS = ("arch", "num_classes", "input_size", "input_channels", "compute_dtype",
                "weights", "model")


def _flatten_batches(total: int, buckets: Sequence[int]) -> Sequence[int]:
    """Cover `total` masks with exported bucket sizes, minimizing dispatches
    first and padding second: one padded 256-call beats eight 32-calls for a
    255-mask tail."""
    bs = sorted(set(int(b) for b in buckets), reverse=True)

    @functools.lru_cache(maxsize=None)
    def plan(r: int):
        if r == 0:
            return ()
        best = None
        for b in bs:
            cand = (b,) if b >= r else (b,) * (r // b) + plan(r % b)
            key = (len(cand), sum(cand))
            if best is None or key < best[0]:
                best = (key, cand)
        return best[1]

    return list(plan(int(total)))


def _dtype_name(dtype: torch.dtype) -> str:
    return {v: k for k, v in _DTYPES.items()}[dtype]


def _model_entry(bundle) -> dict:
    """The manifest's ``"model"`` entry: ``create_model``'s arguments."""
    if bundle.create_args is None:
        raise ValueError(f"bundle {bundle.name!r} was not made by models.create_model: an "
                         "artifact records create_model's arguments to rebuild it")
    return {**bundle.create_args,
            "transform_input": bool(getattr(bundle.module, "transform_input", False)),
            "dtype": _dtype_name(bundle.dtype)}


def _jax_dataset(manifest: dict) -> str:
    """The dataset a JAX-written manifest's arch was made for, from its input
    channels and native size (its num_classes is passed explicitly)."""
    if manifest["arch"] == "mnist_cnn" or int(manifest["input_channels"]) == 1:
        return "mnist"
    native = int(manifest.get("native_input_size", manifest["input_size"]))
    return "cifar10" if native == 32 else "imagenet"


def _bundle_from_manifest(manifest: dict):
    """The ``ModelBundle`` a manifest describes: from its ``"model"`` entry,
    or, for a JAX-written manifest without one, from ``arch``,
    ``num_classes`` and ``input_channels``."""
    arch = manifest["arch"]
    model = manifest.get("model")
    if model is None:
        if arch in _NEEDS_MODEL_ENTRY:
            raise ValueError(
                f"manifest has no 'model' entry, and arch {arch!r} needs one: its depth and "
                "widths are not in a JAX-written manifest (re-export with this package's "
                "serving.export_engine)")
        model = {"dataset": _jax_dataset(manifest), "dtype": manifest["compute_dtype"]}
    if model["dtype"] not in _DTYPES:
        raise ValueError(f"unsupported dtype {model['dtype']!r}; choose from {sorted(_DTYPES)}")
    bundle = create_model(arch, model["dataset"], num_classes=int(manifest["num_classes"]),
                          dtype=_DTYPES[model["dtype"]],
                          **{k: model[k] for k in _MODEL_KEYS if k in model})
    if hasattr(bundle.module, "transform_input") and "transform_input" in model:
        bundle.module.transform_input = bool(model["transform_input"])
    if bundle.input_channels != int(manifest["input_channels"]):
        raise ValueError(f"arch {arch!r} on {model['dataset']!r} takes "
                         f"{bundle.input_channels} channels, the manifest says "
                         f"{manifest['input_channels']}")
    return bundle


def _write_weights(engine, out_dir: str) -> None:
    """``variables.msgpack``: the engine's weights in the JAX package's layout."""
    with open(os.path.join(out_dir, WEIGHTS), "wb") as f:
        f.write(msgpack_dumps(jax_variables(engine.variables, engine.bundle.module)))


def export_engine(
    engine,
    out_dir: str,
    batch_sizes: Sequence[int] = (1024, 256, 32),
    include_weights: bool = True,
    input_size: int = None,
    knockout_m: int = 0,
    attribution: Sequence[str] = (),
    attribution_cfg: dict = None,
    attribution_batches: Sequence[int] = (),
) -> dict:
    """Write the engine artifact: ``variables.msgpack`` (unless
    ``include_weights=False``) and ``manifest.json``; returns the manifest.

    The arguments are the JAX package's. ``batch_sizes`` are the window
    buckets; ``knockout_m > 0`` adds knockout forwards of M knockouts per
    mask (fewer per request pad with the -1 sentinel); ``input_size``
    serves another resolution than the arch's native one (every zoo net is
    globally pooled); ``attribution`` names the served attribution methods
    (gradient, grad_input, integrated, smoothgrad, gradcam, scorecam,
    occlusion, rise, meaningful, xrai), ``attribution_cfg`` their fixed
    hyperparameters (unknown keys are refused; the Grad-CAM layer is
    resolved here and recorded; ``occ_patch`` and ``xrai_scales`` stay
    ``None`` = adaptive where not given, XRAI's scales resolved for the
    input size), ``attribution_batches`` the image batches ``attribute_many``
    runs the gradient family at."""
    bundle = engine.bundle
    os.makedirs(out_dir, exist_ok=True)
    h = w = int(input_size) if input_size else bundle.input_size
    c = bundle.input_channels
    buckets = sorted(set(int(b) for b in batch_sizes), reverse=True)
    files = {str(b): None for b in buckets}
    knockout_m = int(knockout_m)
    knockout_files = {str(b): None for b in buckets} if knockout_m > 0 else {}

    attribution = tuple(attribution)
    if attribution_batches and not attribution:
        raise ValueError("attribution_batches needs attribution=[...] methods to export")
    attr_files, attr_cfg, attr_batched, xrai_entry = {}, {}, {}, {}
    if attribution:
        supported = ("gradient", "grad_input", "integrated", "smoothgrad", "gradcam",
                     "scorecam", "occlusion", "rise", "meaningful", "xrai")
        unknown = [m for m in attribution if m not in supported]
        if unknown:
            raise ValueError(f"unsupported attribution methods {unknown}; "
                             f"choose from {supported}")
        attr_cfg = {
            # gradient family
            "ig_steps": 16, "sg_samples": 16, "sg_sigma": 0.15, "gradcam_layer": None,
            # mask-batched methods; occ None = resolution-adaptive at the input size
            "mask_batch": 64, "occ_patch": None, "occ_stride": None,
            "rise_masks": 500, "rise_grid": 7, "rise_keep": 0.5, "scorecam_channels": 64,
            # learned deletion mask (Fong-Vedaldi)
            "lm_mask_size": 28, "lm_iters": 150, "lm_lr": 0.1, "lm_l1": 0.05, "lm_tv": 0.1,
            "lm_jitter": 4, "lm_baseline": "blur",
            # XRAI's host ranking; None -> xrai.adaptive_scales for the input size
            "xrai_scales": None, "xrai_min_area": 4,
        }
        bad_keys = set(attribution_cfg or {}) - set(attr_cfg)
        if bad_keys:
            # A typo'd hyperparameter would be recorded as if the server honoured it.
            raise ValueError(f"unknown attribution_cfg keys {sorted(bad_keys)}; "
                             f"supported: {sorted(attr_cfg)}")
        attr_cfg.update(attribution_cfg or {})
        if attr_cfg["gradcam_layer"] is None and {"gradcam", "scorecam"} & set(attribution):
            attr_cfg["gradcam_layer"] = g.default_gradcam_layer(
                bundle, engine.variables, (h, w, c))
        if "xrai" in attribution:
            if attr_cfg["xrai_scales"] is None:
                attr_cfg["xrai_scales"] = [float(s) for s in xrai_mod.adaptive_scales(h, w)]
            xrai_entry = {"file": None,
                          "scales": [float(s) for s in attr_cfg["xrai_scales"]],
                          "min_area": int(attr_cfg["xrai_min_area"]),
                          "steps": int(attr_cfg["ig_steps"])}
        attr_files = {m: None for m in dict.fromkeys(m for m in attribution if m != "xrai")}
        for nb in sorted(set(int(b) for b in attribution_batches)):
            if nb < 2:
                raise ValueError(f"attribution_batches entries must be >= 2 (got {nb}); "
                                 "the per-image program already covers N=1")
            for method in dict.fromkeys(m for m in attribution
                                        if m in g.BATCHABLE_METHODS):
                attr_batched.setdefault(method, {})[str(nb)] = None

    if include_weights:
        _write_weights(engine, out_dir)
    manifest = {
        "arch": bundle.name,
        "num_classes": bundle.num_classes,
        "input_size": h,
        "native_input_size": bundle.input_size,
        "input_channels": c,
        "compute_dtype": _dtype_name(engine.compute_dtype),
        "batch_sizes": sorted(files, key=int, reverse=True),
        "files": files,
        "knockout_m": knockout_m,
        "knockout_files": knockout_files,
        "attribution": {"files": attr_files, "config": attr_cfg,
                        "batched_files": attr_batched, "xrai": xrai_entry},
        "weights": WEIGHTS if include_weights else None,
        "export_platform": engine.device.type,
        "model": _model_entry(bundle),
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def _load_engine(path: str, manifest: dict, variables, device, mask_batch: int):
    """The engine an artifact describes, on ``device`` (None: the card)."""
    bundle = _bundle_from_manifest(manifest)
    if variables is None:
        wpath = manifest.get("weights")
        if not wpath:
            raise ValueError("artifact has no bundled weights; pass variables=")
        with open(os.path.join(path, wpath), "rb") as f:
            variables = msgpack_loads(f.read())
    # The JAX package's layout (as the artifact holds it), or a port state dict.
    state_dict = from_jax(variables, bundle.module) if "params" in variables else variables
    return SaliencyEngine(bundle, state_dict, mask_batch=mask_batch,
                          compute_dtype=_DTYPES[manifest["compute_dtype"]], device=device)


def _read_manifest(path: str, name: str) -> dict:
    with open(os.path.join(path, name)) as f:
        return json.load(f)


def same_engine(a: dict, b: dict) -> bool:
    """Whether two manifests (an engine and a BO artifact, say) describe the
    same model, weights and compute dtype, so that one engine serves both."""
    return all(a.get(k) == b.get(k) for k in _ENGINE_KEYS)


class _Served:
    """What both servers share: the manifest, the engine and its checks.
    ``engine``: one already loaded for the same model (:func:`same_engine`),
    so that a directory holding both artifact kinds keeps one copy of the
    weights on the device; None loads the artifact's own."""

    def __init__(self, path: str, manifest: dict, variables, device, mask_batch: int,
                 engine=None) -> None:
        self.manifest = manifest
        self.engine = engine or _load_engine(path, manifest, variables, device, mask_batch)
        self.device = self.engine.device
        # The port's state dict on the engine's device (the JAX servers' device weights).
        self.variables = self.engine.variables
        self.num_classes = int(manifest["num_classes"])
        self.shape = (int(manifest["input_size"]),) * 2 + (int(manifest["input_channels"]),)

    def _image(self, image) -> np.ndarray:
        """An f32 image of the artifact's shape (the JAX package's exported
        programs check it too), copied: a decoded request's array is read-only."""
        image = np.array(image, np.float32)
        if image.shape != self.shape:
            raise ValueError(f"image shape {image.shape} != the artifact's {self.shape}")
        return image

    def _segments(self, segments) -> np.ndarray:
        segments = np.array(segments, np.int32)
        if segments.shape != self.shape[:2]:
            raise ValueError(f"segments shape {segments.shape} != the artifact's "
                             f"{self.shape[:2]}")
        return segments

    def _check_target(self, target) -> None:
        if not 0 <= int(target) < self.num_classes:
            raise ValueError(f"target {target} out of range [0, {self.num_classes})")


class ExportedSaliencyServer(_Served):
    """Serves window and knockout evaluations and attributions from an
    engine artifact directory, with the outcome contract of
    ``SaliencyEngine.eval_window_masks`` (a :class:`MaskEvalResult` trimmed
    to K). Each bucket call is one B1 launch into one ``[bucket, H, W, C]``
    buffer (the tail padded with ``pad_value`` rows, which the forward keeps
    apart from the true rows and the result drops) and one forward of the
    engine's plan at the bucket's batch."""

    def __init__(self, path: str, variables: Any = None, device=None, engine=None) -> None:
        manifest = _read_manifest(path, MANIFEST)
        super().__init__(path, manifest, variables, device,
                         max(int(b) for b in manifest["files"]), engine)
        self.buckets = sorted((int(b) for b in self.manifest["files"]), reverse=True)
        self.knockout_m = int(self.manifest.get("knockout_m", 0))
        self.ko_buckets = sorted((int(b) for b in self.manifest.get("knockout_files", {})),
                                 reverse=True)
        attr = self.manifest.get("attribution") or {}
        self.attribution_config = attr.get("config", {})
        self._attr_methods = tuple(sorted(attr.get("files", {})))
        self._attr_batched = {m: sorted(int(n) for n in per_n)
                              for m, per_n in attr.get("batched_files", {}).items()}
        self.xrai_config = attr.get("xrai") or None

    @torch.inference_mode()
    def _chunked_logits(self, buckets, rows: np.ndarray, pad_value: int, forward) -> np.ndarray:
        """Cover K rows with fewest-dispatch bucket chunks (the tail padded
        with ``pad_value`` rows), then one device-to-host copy, trimmed to K."""
        k = len(rows)
        outs, off = [], 0
        for b in _flatten_batches(k, buckets):
            chunk = rows[off:off + b]
            off += len(chunk)
            if len(chunk) < b:
                pad = np.full((b - len(chunk),) + rows.shape[1:], pad_value, np.int32)
                chunk = np.concatenate([chunk, pad])
            outs.append(forward(torch.from_numpy(np.array(chunk, np.int32)).to(self.device)))
            if off >= k:
                break
        return torch.cat(outs).cpu().numpy()[:k]

    def _upload(self, image, segments):
        return (torch.from_numpy(self._image(image)).to(self.device),
                torch.from_numpy(self._segments(segments)).to(self.device))

    def warmup(self) -> int:
        """Run every served program once on zeros, so the first request is
        served warm: this builds the kernels (B1, B2) and warms cuDNN and
        cuBLAS at each bucket. Returns the number of programs run."""
        image = np.zeros(self.shape, np.float32)
        segments = np.zeros(self.shape[:2], np.int32)
        n = 0
        for b in self.buckets:
            self.logits_for_windows(image, segments, np.zeros(b, np.int32), 1)
            n += 1
        for b in self.ko_buckets:
            self.logits_for_knockouts(image, segments,
                                      np.full((b, self.knockout_m), -1, np.int32))
            n += 1
        for method in self._attr_methods:
            self.attribute(image, 0, method)
            n += 1
        for method, sizes in self._attr_batched.items():
            for nb in sizes:
                self.attribute_many(np.zeros((nb,) + self.shape, np.float32), [0] * nb, method)
                n += 1
        if self.xrai_config:
            self._xrai_attribution(image, 0)
            n += 1
        return n

    def logits_for_windows(self, image, segments, firsts, width: int) -> np.ndarray:
        """f32 [K, num_classes] logits for K window masks."""
        firsts = np.asarray(firsts, np.int32).reshape(-1)
        if len(firsts) == 0:  # the engine's contract: K=0 gives an empty typed result
            return np.zeros((0, self.num_classes), np.float32)
        image_t, seg_t = self._upload(image, segments)
        cd, model = self.engine.compute_dtype, self.engine.model

        def forward(chunk):
            return model(masked_batch(image_t, seg_t, chunk, int(width), cd)).float()

        return self._chunked_logits(self.buckets, firsts, 0, forward)

    @staticmethod
    def _result_from_logits(logits: np.ndarray, target: int):
        z = logits - logits.max(axis=-1, keepdims=True)
        probs = np.exp(z) / np.exp(z).sum(axis=-1, keepdims=True)
        preds = logits.argmax(axis=-1).astype(np.int32)
        return MaskEvalResult(survived=preds == target, preds=preds,
                              prob_target=probs[:, target].astype(np.float32),
                              prob_max=probs.max(axis=-1).astype(np.float32))

    def eval_window_masks(self, image, segments, firsts, width: int, target: int):
        """Drop-in substitute for ``SaliencyEngine.eval_window_masks``."""
        return self._result_from_logits(
            self.logits_for_windows(image, segments, firsts, width), target)

    def logits_for_knockouts(self, image, segments, knock_ids) -> np.ndarray:
        """f32 [K, num_classes] logits for K knockout masks (``knock_ids``
        int32[K, m], m at most the exported ``knockout_m``; short rows pad
        with the -1 sentinel, which knocks out nothing). The masks are plain
        torch ops, as in the engine's knockout path."""
        if not self.ko_buckets:
            raise ValueError("artifact has no knockout forwards; re-export with "
                             "knockout_m=M (CLI: --knockout-m)")
        knock_ids = np.asarray(knock_ids, np.int32)
        if knock_ids.ndim != 2:
            raise ValueError(f"knock_ids must be [K, m], got {knock_ids.shape}")
        k, m = knock_ids.shape
        if m > self.knockout_m:
            raise ValueError(f"knock_ids has m={m} knockouts per mask but the artifact was "
                             f"exported with knockout_m={self.knockout_m}; re-export")
        if k == 0:
            return np.zeros((0, self.num_classes), np.float32)
        if m < self.knockout_m:
            knock_ids = np.concatenate(
                [knock_ids, np.full((k, self.knockout_m - m), -1, np.int32)], axis=1)
        image_t, seg_t = self._upload(image, segments)
        cd, model = self.engine.compute_dtype, self.engine.model

        def forward(chunk):
            masks = masking.knockout_masks(seg_t, chunk)
            return model((image_t[None] * masks[..., None].to(torch.float32)).to(cd)).float()

        return self._chunked_logits(self.ko_buckets, knock_ids, -1, forward)

    def eval_knockout_masks(self, image, segments, knock_ids, target: int):
        """Drop-in substitute for ``SaliencyEngine.eval_knockout_masks``."""
        return self._result_from_logits(
            self.logits_for_knockouts(image, segments, knock_ids), target)

    @property
    def attribution_methods(self) -> tuple:
        """The attribution methods this artifact serves (empty unless
        exported with ``attribution=...``; XRAI apart, see :meth:`xrai`)."""
        return self._attr_methods

    def _method_fn(self, method: str):
        """``(image, target, seed) -> f32 tensor [H, W]``: the gradient
        methods and the CAMs' captures through ``bundle.logits`` (the plain
        module, differentiable), the masked forwards of occlusion, RISE and
        Score-CAM through the engine's plan (B2 on the card)."""
        cfg, bundle, v = self.attribution_config, self.engine.bundle, self.variables
        cd, folded = self.engine.compute_dtype, self.engine.folded_logits
        if method == "gradient":
            return lambda img, t, s: g.input_gradient(bundle.logits, v, img, t)
        if method == "grad_input":
            return lambda img, t, s: g.grad_times_input(bundle.logits, v, img, t)
        if method == "integrated":
            return lambda img, t, s: g.integrated_gradients(bundle.logits, v, img, t,
                                                            steps=cfg["ig_steps"])
        if method == "smoothgrad":
            return lambda img, t, s: g.smoothgrad(bundle.logits, v, img, t,
                                                  samples=cfg["sg_samples"],
                                                  noise_sigma=cfg["sg_sigma"], seed=s)
        if method == "gradcam":
            return lambda img, t, s: g.gradcam(bundle, v, img, t, layer=cfg["gradcam_layer"])
        if method == "scorecam":
            return lambda img, t, s: g.scorecam(bundle, v, img, t, layer=cfg["gradcam_layer"],
                                                channels=cfg["scorecam_channels"],
                                                batch=cfg["mask_batch"], compute_dtype=cd,
                                                logits_fn=folded)
        if method == "occlusion":
            return lambda img, t, s: g.occlusion_map(folded, v, img, t, patch=cfg["occ_patch"],
                                                     stride=cfg["occ_stride"],
                                                     batch=cfg["mask_batch"], compute_dtype=cd)
        if method == "rise":
            return lambda img, t, s: g.rise_map(folded, v, img, t, num_masks=cfg["rise_masks"],
                                                grid=cfg["rise_grid"],
                                                keep_prob=cfg["rise_keep"],
                                                batch=cfg["mask_batch"], seed=s,
                                                compute_dtype=cd)
        return lambda img, t, s: lm.learned_mask_batch_dispatch(
            bundle.logits, v, img[None], [t], mask_size=int(cfg["lm_mask_size"]),
            iters=int(cfg["lm_iters"]), lr=float(cfg["lm_lr"]), l1=float(cfg["lm_l1"]),
            tv=float(cfg["lm_tv"]), tv_beta=3.0, jitter=int(cfg["lm_jitter"]), max_shift=4,
            baseline=cfg["lm_baseline"], blur_sigma=10.0, seeds=[s], compute_dtype=cd)[0][0]

    def _check_method(self, method: str) -> None:
        if method not in self._attr_methods:
            raise ValueError(f"artifact has no {method!r} attribution program (available: "
                             f"{list(self.attribution_methods)}); re-export with "
                             "attribution=[...] (CLI: --attribution)")

    def attribute(self, image, target: int, method: str, seed: int = 0) -> np.ndarray:
        """f32 [H, W] attribution heatmap of ``method`` with the artifact's
        hyperparameters (``self.attribution_config``); ``seed`` feeds the
        stochastic methods (smoothgrad, rise, meaningful)."""
        self._check_method(method)
        self._check_target(target)
        heat = self._method_fn(method)(self._image(image), int(target), int(seed))
        return heat.detach().cpu().numpy().astype(np.float32)

    def attribute_many(self, images, targets, method: str, seeds=None):
        """N attribution heatmaps with the strategy chosen in one place: for
        N > 1 and an exported image batch of at least N (a gradient-family
        method), one stacked backward over the N images
        (``gradient.attribute_batch``; nothing is padded, as eager PyTorch
        reuses no compiled shape), else N :meth:`attribute` calls. Returns
        ``(f32[N, H, W], device_calls)``."""
        images = np.array(images, np.float32)   # a copy: a decoded request is read-only
        if images.ndim != 4:
            raise ValueError(f"images must be [N, H, W, C], got {images.shape}")
        n = int(images.shape[0])
        targets = [int(t) for t in targets]
        seeds = [0] * n if seeds is None else [int(x) for x in seeds]
        if len(targets) != n or len(seeds) != n:
            raise ValueError(f"targets/seeds must have length N={n}, got "
                             f"{len(targets)}/{len(seeds)}")
        if n == 0:
            return np.zeros((0,) + self.shape[:2], np.float32), 0
        if n == 1 or not any(b >= n for b in self._attr_batched.get(method, ())):
            return np.stack([self.attribute(images[i], targets[i], method, seed=seeds[i])
                             for i in range(n)]), n
        bad = [t for t in targets if not 0 <= t < self.num_classes]
        if bad:
            raise ValueError(f"targets {bad} out of range [0, {self.num_classes})")
        self._check_method(method)
        if images.shape[1:] != self.shape:
            raise ValueError(f"images shape {images.shape[1:]} != the artifact's {self.shape}")
        cfg = self.attribution_config
        heats = g.attribute_batch(self.engine.bundle.logits, self.variables, images, targets,
                                  method, bundle=self.engine.bundle, steps=cfg["ig_steps"],
                                  samples=cfg["sg_samples"], noise_sigma=cfg["sg_sigma"],
                                  gradcam_layer=cfg["gradcam_layer"], seeds=seeds)
        return heats.detach().cpu().numpy().astype(np.float32), 1

    def _xrai_attribution(self, image, target: int) -> np.ndarray:
        return xrai_mod.xrai_attribution(self.engine.bundle.logits, self.variables,
                                         self._image(image), int(target),
                                         steps=int(self.xrai_config["steps"])).cpu().numpy()

    def xrai(self, image, target: int, display=None, seed: int = 0):
        """Full XRAI: the signed multi-baseline IG on the engine's device, then
        the Felzenszwalb ladder and the greedy density ranking on the host,
        with the scales and min_area fixed at export (``self.xrai_config``).
        ``display`` is the uint8 image the ladder segments (default: ``image``
        min-max scaled). ``seed`` is unused (XRAI draws nothing), as in the
        JAX package. Returns :class:`saliency.xrai.XraiResult`."""
        if not self.xrai_config:
            raise ValueError("artifact has no XRAI program; re-export with "
                             "attribution=['xrai', ...] (CLI: --attribution xrai)")
        self._check_target(target)
        attr = np.asarray(self._xrai_attribution(image, target), np.float32)
        if display is None:
            display = aggregate.normalize_to_uint8_np(np.asarray(image))
        seg_maps = felzenszwalb_ladder(display, self.xrai_config["scales"], sigma=0.5)
        heat, n = xrai_mod.greedy_region_ranking(attr, seg_maps,
                                                 min_area=int(self.xrai_config["min_area"]))
        return xrai_mod.XraiResult(heatmap=heat, attribution=attr, num_regions=n)


def load_exported(path: str, variables: Any = None, device=None,
                  engine=None) -> ExportedSaliencyServer:
    return ExportedSaliencyServer(path, variables, device, engine)


# ---------------------------------------------------------------------------
# Fused-BO artifact: the flagship active-learning loop
# ---------------------------------------------------------------------------


def export_bo_engine(
    engine,
    out_dir: str,
    bo_cfg=None,
    candidate_buckets: Sequence[int] = (32, 64),
    proposals_per_iter: int = 1,
    include_weights: bool = True,
    image_batches: Sequence[int] = (),
) -> dict:
    """Write the fused-BO artifact's ``bo_manifest.json`` (and the weights
    unless ``include_weights=False``): one loop per power-of-two candidate
    bucket, a batch-1 predict, and with ``image_batches`` an image-batched
    loop per (N, bucket) and an N-image predict, as the JAX package
    exports. Returns the manifest."""
    bo_cfg = bo_cfg or BOConfig()
    bundle = engine.bundle
    os.makedirs(out_dir, exist_ok=True)
    cbs = sorted({next_pow2(int(cb)) for cb in candidate_buckets})
    # Power-of-two image batches, without the candidate buckets' min-8 floor.
    n_batches = sorted({1 << (int(n) - 1).bit_length() for n in image_batches if int(n) > 0})
    if include_weights:
        _write_weights(engine, out_dir)
    manifest = {
        "arch": bundle.name,
        "num_classes": bundle.num_classes,
        "input_size": bundle.input_size,
        "input_channels": bundle.input_channels,
        "compute_dtype": _dtype_name(engine.compute_dtype),
        "bo": {"n_pre_samples": bo_cfg.n_pre_samples, "n_iters": bo_cfg.n_iters,
               "proposals_per_iter": proposals_per_iter, "alpha": bo_cfg.alpha,
               "epsilon": bo_cfg.epsilon,
               "lengthscale_grid": [float(x) for x in bo_cfg.lengthscale_grid]},
        "candidate_buckets": [str(cb) for cb in cbs],
        "files": {str(cb): None for cb in cbs},
        "image_batches": [str(n) for n in n_batches],
        "batched_files": {str(n): {str(cb): None for cb in cbs} for n in n_batches},
        "batched_predicts": {str(n): None for n in n_batches},
        "predict": None,
        # A weights blob already in the directory (an export_engine call into
        # the same directory) is referenced even when this export wrote none.
        "weights": WEIGHTS
        if include_weights or os.path.exists(os.path.join(out_dir, WEIGHTS)) else None,
        "export_platform": engine.device.type,
        "model": _model_entry(bundle),
    }
    with open(os.path.join(out_dir, BO_MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ExportedBOServer(_Served):
    """Serves BO saliency explanations from a fused-BO artifact.

    ``explain(image, segments, ...)`` is ``bo_pipeline.bo_window_saliency``
    (fused) at the smallest exported candidate bucket of at least upper+1.
    The server owns one runner (``bo.loop.FusedWindowBO``) per exported
    shape, (image batch, candidate bucket): each sees one input shape, so
    each keeps its one CUDA graph and none is evicted
    (``bo.loop.MAX_GRAPHS`` bounds the shapes of one runner) or recaptured
    while serving. :meth:`warmup` captures them all."""

    def __init__(self, path: str, variables: Any = None, device=None, engine=None) -> None:
        super().__init__(path, _read_manifest(path, BO_MANIFEST), variables, device, 256,
                         engine)
        bo = self.manifest["bo"]
        self.buckets = sorted(int(cb) for cb in self.manifest["files"])
        self._batched = {int(n): sorted(int(cb) for cb in per)
                         for n, per in self.manifest.get("batched_files", {}).items()}
        self._batched_predicts = sorted(int(n) for n in self.manifest.get("batched_predicts", {}))
        defaults = BOConfig()
        eng = self.engine

        def runner(cb, batch_images):
            return make_fused_window_bo(
                eng.masked_outcomes, cb, n_pre_samples=int(bo["n_pre_samples"]),
                n_iters=int(bo["n_iters"]), alpha=float(bo.get("alpha", defaults.alpha)),
                epsilon=float(bo.get("epsilon", defaults.epsilon)),
                lengthscale_grid=tuple(bo.get("lengthscale_grid", defaults.lengthscale_grid)),
                proposals_per_iter=int(bo["proposals_per_iter"]), batch_images=batch_images,
                compute_dtype=eng.compute_dtype, device=eng.device)

        # (image batch, candidate bucket) -> runner; image batch 1 is the single-image loop.
        self.runners = {(1, cb): runner(cb, False) for cb in self.buckets}
        self.runners.update({(n, cb): runner(cb, True)
                             for n, cbs in self._batched.items() for cb in cbs})

    def warmup(self) -> int:
        """Run every program once on zeros (the predicts) and bring every
        loop to its captured CUDA graph (on the card: an eager call that
        loads the kernels and warms the libraries, then the capture; on the
        CPU one eager call). Returns the program count."""
        image = np.zeros(self.shape, np.float32)
        segments = np.zeros(self.shape[:2], np.int32)
        self.predict_logits(image)
        n = 1
        for (nb, _), run in self.runners.items():
            draws = window_draws(torch.Generator().manual_seed(0), 1, run.max_obs)
            args = (image, segments, 1, 0, 1, draws) if not run.batch_images else (
                np.stack([image] * nb), np.stack([segments] * nb), [1] * nb, [0] * nb,
                [1] * nb, torch.stack([draws] * nb))
            for _ in range(2 if run.cuda_graph else 1):
                run(*args)
            n += 1
        for nb in self._batched_predicts:
            self.engine.predict(np.zeros((nb,) + self.shape, np.float32))
            n += 1
        return n

    def predict_logits(self, image) -> np.ndarray:
        """f32 [num_classes] logits of one image (the engine's plan at B=1)."""
        return self.engine.predict(self._image(image)[None])[0]

    def predict_logits_batch(self, images) -> np.ndarray:
        """f32 [n, num_classes] logits at the smallest exported image batch
        of at least n (padded by repeating image 0), else n batch-1 calls."""
        images = np.asarray(images, np.float32)
        n = images.shape[0]
        usable = [b for b in self._batched_predicts if b >= n]
        if not usable:
            return np.stack([self.predict_logits(img) for img in images])
        if images.shape[1:] != self.shape:
            raise ValueError(f"images shape {images.shape[1:]} != the artifact's {self.shape}")
        if usable[0] > n:
            images = np.concatenate([images, np.repeat(images[:1], usable[0] - n, axis=0)])
        return self.engine.predict(images)[:n]

    def explain(self, image, segments, window_fraction: float = 0.4, seed: int = 0,
                target: Any = None, draws=None):
        """-> (SaliencyOutput, BOResult), the ``bo_window_saliency``
        contract. The loop's random integers come from a CPU generator seeded
        with ``seed``, or from ``draws`` where given."""
        image, segments = self._image(image), self._segments(segments)
        s = int(segments.max()) + 1
        width = int(window_fraction * s)
        upper = int(0.6 * s)
        usable = [b for b in self.buckets if b >= upper + 1]
        if not usable:
            raise ValueError(f"image needs a candidate bucket >= {upper + 1}; exported "
                             f"buckets: {self.buckets} — re-export with a larger bucket")
        if target is None:
            target = int(self.predict_logits(image).argmax())
        run = self.runners[(1, usable[0])]
        if draws is None:
            draws = window_draws(torch.Generator().manual_seed(int(seed)), upper, run.max_obs)
        xs, ys, survived, count = run(image, segments, width, int(target), upper, draws)
        bo_res = _traces(xs[None], ys[None], survived[None], count)[0]
        return _assemble_output(segments, s, width, int(target), bo_res), bo_res

    def explain_many(self, images, segments_list, window_fraction: float = 0.4,
                     per_image_seeds=None, targets=None):
        """Explain N images with the strategy chosen in one place: the
        image-batched loop when N > 1 and some exported image batch holds N,
        else N :meth:`explain` calls. ``targets`` and ``per_image_seeds`` are
        required. Returns ``(outs, device_calls)``."""
        n = len(segments_list)
        if targets is None or per_image_seeds is None:
            raise ValueError("explain_many needs explicit targets and per_image_seeds "
                             "(infer targets first)")
        if n > 1 and any(b >= n for b in self._batched):
            return self.explain_batch(images, segments_list, window_fraction=window_fraction,
                                      targets=targets, per_image_seeds=per_image_seeds), 1
        return [self.explain(images[i], segments_list[i], window_fraction=window_fraction,
                             seed=int(per_image_seeds[i]), target=targets[i])
                for i in range(n)], n

    def explain_batch(self, images, segments_list, window_fraction: float = 0.4,
                      seed: int = 0, targets=None, per_image_seeds=None):
        """Explain N images with one image-batched loop at the smallest
        exported image batch of at least N and the smallest candidate bucket
        of at least max(upper)+1, padded by repeating entry 0. Image i draws
        from a generator seeded with ``per_image_seeds[i]`` (default
        ``seed + i``), so its result is a single :meth:`explain` call's with
        that seed (up to the rounding of a forward at another batch size).
        Returns a list of N (SaliencyOutput, BOResult) pairs."""
        if not self._batched:
            raise ValueError("artifact has no image-batched BO programs; re-export with "
                             "image_batches=(N,...) (CLI: --bo-image-batches)")
        segs, ss, widths, uppers = _multi_geometry(
            [self._segments(s) for s in segments_list], window_fraction)
        n = len(segs)
        if n == 0:
            return []
        images = np.stack([self._image(im) for im in images])
        usable_n = [b for b in sorted(self._batched) if b >= n]
        if not usable_n:
            raise ValueError(f"batch of {n} images needs an exported image batch >= {n}; "
                             f"exported: {sorted(self._batched)}")
        n_pad = usable_n[0]
        need = int(uppers.max()) + 1
        usable_cb = [b for b in self._batched[n_pad] if b >= need]
        if not usable_cb:
            raise ValueError(f"image needs a candidate bucket >= {need}; exported buckets: "
                             f"{self._batched[n_pad]} — re-export with a larger bucket")
        seeds = ([seed + i for i in range(n)] if per_image_seeds is None
                 else [int(x) for x in per_image_seeds])
        if len(seeds) != n:
            raise ValueError(f"per_image_seeds length {len(seeds)} != image count {n}")
        reps = n_pad - n

        def pad(a):
            return np.concatenate([a, np.repeat(a[:1], reps, axis=0)]) if reps else a

        images, segs_arr = pad(images), pad(np.stack(segs))
        widths, uppers = pad(widths), pad(uppers)
        targets = (self.engine.predict(images).argmax(axis=1) if targets is None
                   else pad(np.asarray(targets, np.int64)))
        run = self.runners[(n_pad, usable_cb[0])]
        draws = torch.stack([window_draws(torch.Generator().manual_seed(int(sd)), int(u),
                                          run.max_obs)
                             for sd, u in zip(seeds + [seeds[0]] * reps, uppers)])
        xs_d, ys_d, survived_d, count = run(images, segs_arr, widths, targets, uppers, draws)
        return _collect_multi_outputs(xs_d, ys_d, survived_d, count, segs, ss, widths,
                                      targets, n)


def load_exported_bo(path: str, variables: Any = None, device=None,
                     engine=None) -> ExportedBOServer:
    return ExportedBOServer(path, variables, device, engine)
