"""The masked-forward engine (port of ``saliency/engine.py`` of the JAX package).

The image, its segment map and the folded model live on the device. Each
chunk of up to ``mask_batch`` window starts runs three steps in order on the
current stream, with no synchronisation: B1 (``ops.masked_batch``) builds the
masked batch in ``compute_dtype``; the model runs (its stride-1 blocks through
B2, ``ops.bottleneck_chain``); f32 softmax/argmax give survived, preds,
prob_target and prob_max. :meth:`SaliencyEngine.collect` then makes one
device-to-host copy of all chunks' outcomes.

Chunks are ``mask_batch`` long and the last one holds the remainder: the JAX
package pads the remainder to a power of two only to reuse XLA's compiled
shapes, which eager PyTorch has no need for; the outcomes are the same.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.device import resolve_device
from network_interpretation_imagenet_tpu_torch.models import FoldedResNet, ModelBundle
from network_interpretation_imagenet_tpu_torch.ops.masked_batch import masked_batch


@dataclasses.dataclass
class MaskEvalResult:
    """Per-mask outcomes for a bank of K masks (numpy)."""

    survived: np.ndarray     # bool[K]: masked prediction still == target
    preds: np.ndarray        # int32[K] argmax class
    prob_target: np.ndarray  # f32[K] softmax prob of the target class
    prob_max: np.ndarray     # f32[K] max softmax prob

    @property
    def labels(self) -> np.ndarray:
        """1/0 labels as the reference encodes them in mask filenames."""
        return self.survived.astype(np.int32)


def outcomes(logits: torch.Tensor, target) -> torch.Tensor:
    """f32 [4, B]: survived, preds, prob_target, prob_max (preds as exact f32
    integers, so one copy brings all four back). ``target`` is an int, or an
    int64 tensor of one target or of B (gathered on the device, never read
    by the host)."""
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    preds = torch.argmax(logits, dim=-1)
    if isinstance(target, torch.Tensor):
        prob_target = probs.gather(1, target.reshape(-1, 1).expand(probs.shape[0], 1))[:, 0]
    else:
        prob_target = probs[:, target]
    return torch.stack([(preds == target).float(), preds.float(), prob_target,
                        probs.max(dim=-1).values])


class SaliencyEngine:
    """Masked forwards of one classifier, weights folded once on ``device``.

    ``device=None`` means the card, and raises without one; pass
    ``device="cpu"`` to run on the CPU. ``compute_dtype=None`` takes the
    bundle's dtype. TF32 is switched off for cuDNN and matmuls, so an f32
    engine computes in full f32."""

    def __init__(self, bundle: ModelBundle, state_dict, mask_batch: int = 256,
                 compute_dtype: torch.dtype = None, device=None) -> None:
        self.device = resolve_device(device)
        self.bundle = bundle
        self.mask_batch = int(mask_batch)
        self.compute_dtype = bundle.dtype if compute_dtype is None else compute_dtype
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.model = FoldedResNet(state_dict, bundle.module.stage_sizes,
                                  self.compute_dtype, self.device)
        # bo_pipeline.fused_runner's runners (and their CUDA graphs), by static config.
        self.fused_runners: dict = {}

    def _to_device(self, array, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array, dtype)).to(self.device)

    @torch.inference_mode()
    def predict(self, images) -> np.ndarray:
        """Batched unmasked forward: NHWC f32 [B, H, W, C] -> f32 logits [B, classes]."""
        x = self._to_device(images, np.float32).to(self.compute_dtype)
        return self.model(x).cpu().numpy()

    def predict_one(self, image) -> Tuple[int, np.ndarray]:
        logits = self.predict(np.asarray(image)[None])[0]
        return int(logits.argmax()), logits

    def eval_window_masks(self, image, segments, firsts, width: int,
                          target: int) -> MaskEvalResult:
        """Evaluate K contiguous-window masks in ceil(K / mask_batch) forwards."""
        return self.collect(
            self.eval_window_masks_async(image, segments, firsts, width, target))

    @torch.inference_mode()
    def eval_window_masks_async(self, image, segments, firsts, width: int, target: int):
        """Enqueue K window-mask evaluations; returns a handle for :meth:`collect`."""
        image_t = self._to_device(image, np.float32)
        seg_t = self._to_device(segments, np.int32)
        firsts_t = self._to_device(firsts, np.int32)
        outs: List[torch.Tensor] = []
        for off in range(0, firsts_t.shape[0], self.mask_batch):
            imgs = masked_batch(image_t, seg_t, firsts_t[off:off + self.mask_batch],
                                int(width), self.compute_dtype)
            outs.append(outcomes(self.model(imgs), int(target)))
        return outs

    @torch.inference_mode()
    def masked_outcomes(self, images: torch.Tensor, target) -> Tuple[torch.Tensor, torch.Tensor]:
        """The fused BO loop's forward: a device batch of masked images in
        ``compute_dtype`` -> (prob_target f32[B], survived bool[B]) on the
        device, with no host copy. ``target`` is an int or an int64 tensor of
        one target or one per image."""
        out = outcomes(self.model(images), target)
        return out[2], out[0] > 0.5

    def collect(self, handle) -> MaskEvalResult:
        """Wait for an ``*_async`` handle: one device-to-host copy."""
        if not handle:
            z = np.zeros(0)
            return MaskEvalResult(z.astype(bool), z.astype(np.int32),
                                  z.astype(np.float32), z.astype(np.float32))
        out = torch.cat(handle, dim=1).cpu().numpy()
        return MaskEvalResult(survived=out[0] > 0.5, preds=out[1].astype(np.int32),
                              prob_target=out[2].copy(), prob_max=out[3].copy())
