"""The masked-forward engine (port of ``saliency/engine.py`` of the JAX package).

The image, its segment map and the folded model live on the device. Each
chunk of up to ``mask_batch`` masks runs three steps in order on the current
stream, with no synchronisation: the masked batch is built in
``compute_dtype``; the model's inference plan runs (``models.inference_plan``:
for an ImageNet ResNet the folded net, whose stride-1 Bottleneck blocks run
through B2, ``ops.bottleneck_chain``; for every other arch the eval-mode
module in ``compute_dtype``); f32 softmax/argmax give survived,
preds, prob_target and prob_max. :meth:`SaliencyEngine.collect` then makes
one device-to-host copy of all chunks' outcomes.

On the card a single image's handle (:class:`Outcomes`) carries an event
recorded behind its last chunk, and :meth:`SaliencyEngine.collect` waits for
that event alone: the join and the copy run on a side stream, so work
queued on the current stream after the image keeps the card busy while the
host waits. :meth:`SaliencyEngine.upload_async` is the matching upload: from
pinned memory, with no wait.

Window masks are built by B1 (``ops.masked_batch``): one launch per chunk
for one image, and one launch per image run of a chunk, into a slice of the
chunk, on the multi-image grid. Knockout and mask-bank chunks are plain
torch ops, as they are plain XLA in the JAX package.

Chunks are ``mask_batch`` long and the last one holds the remainder: the JAX
package pads the remainder (and the image axis of the multi-image grid) to a
power of two only to reuse XLA's compiled shapes, which eager PyTorch has no
need for; the outcomes, trimmed there to the true K and N*K, are the same.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.device import resolve_device
from network_interpretation_imagenet_tpu_torch.models import ModelBundle, inference_plan
from network_interpretation_imagenet_tpu_torch.ops import masking
from network_interpretation_imagenet_tpu_torch.ops.masked_batch import masked_batch
from network_interpretation_imagenet_tpu_torch.utils import logging as trace


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


class Outcomes(list):
    """The outcome chunks of one image's ``*_async`` call, a list as
    :meth:`SaliencyEngine.collect` takes it; ``done`` is the event recorded
    on the stream behind the last chunk (None off the card)."""

    done = None


def fetch(t: torch.Tensor, after=None) -> np.ndarray:
    """A tensor on any device as a numpy array: from the card, one
    device-to-host copy, traced as span ``engine.fetch``. It waits for the
    whole stream, or with ``after`` (a CUDA event recorded behind ``t``) for
    that event alone (:func:`_fetch_after`)."""
    with trace.span("engine.fetch"):
        if after is None:
            return t.detach().cpu().numpy()
        return _fetch_after([t.detach()], after)


_COPY_STREAMS: dict = {}   # device -> the side stream event-gated copies run on


def _fetch_after(chunks: list, event) -> np.ndarray:
    """``chunks`` (one tensor, or several joined along dim 1) in host memory
    once ``event`` has completed. The join and the copy into pinned memory
    run on the device's side stream behind that event alone, and the host
    waits for the side stream only, so work queued on the current stream
    after the event keeps running. The chunks stay referenced until the side
    stream is done with them, so the caching allocator needs no
    ``record_stream``."""
    device = chunks[0].device
    stream = _COPY_STREAMS.get(device)
    if stream is None:
        stream = _COPY_STREAMS[device] = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        stream.wait_event(event)
        t = chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=1)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
    stream.synchronize()
    return host.numpy()


class SaliencyEngine:
    """Masked forwards of one classifier, weights folded once on ``device``.

    ``device=None`` means the card, and raises without one; pass
    ``device="cpu"`` to run on the CPU. ``compute_dtype=None`` takes the
    bundle's dtype. TF32 is switched off for cuDNN and matmuls, so an f32
    engine computes in full f32. ``variables`` is the state dict on the
    engine's device (f32), which the attribution methods take with
    ``bundle.logits`` (the differentiable path) or :meth:`folded_logits`;
    ``model`` is its inference plan (``models.inference_plan``)."""

    def __init__(self, bundle: ModelBundle, state_dict, mask_batch: int = 256,
                 compute_dtype: torch.dtype = None, device=None) -> None:
        self.device = resolve_device(device)
        self.bundle = bundle
        self.mask_batch = int(mask_batch)
        self.compute_dtype = bundle.dtype if compute_dtype is None else compute_dtype
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.variables = {k: torch.as_tensor(v).to(self.device) for k, v in state_dict.items()}
        self.model = inference_plan(bundle, self.variables, self.compute_dtype, self.device)
        # bo_pipeline.fused_runner's runners (and their CUDA graphs), by static config.
        self.fused_runners: dict = {}

    def _to_device(self, array, dtype) -> torch.Tensor:
        """A host array as numpy ``dtype``, or a tensor as the same torch
        dtype, contiguous on the engine's device. A copy from host memory (a
        synchronising one from pageable memory to the card) is traced as
        span ``engine.upload``; a tensor on the engine's device needs none."""
        if isinstance(array, torch.Tensor) and (array.device.type != "cpu"
                                                or self.device.type == "cpu"):
            return array.to(self.device, _TORCH_DTYPE[np.dtype(dtype)]).contiguous()
        with trace.span("engine.upload"):
            if not isinstance(array, torch.Tensor):
                array = torch.from_numpy(np.ascontiguousarray(array, dtype))
            return array.to(self.device, _TORCH_DTYPE[np.dtype(dtype)]).contiguous()

    def upload_async(self, array, dtype) -> torch.Tensor:
        """A host array as a contiguous tensor of numpy ``dtype`` on the
        engine's device, with no wait: on the card the copy runs from pinned
        memory (the caching host allocator keeps the pinned block until the
        copy has run), so it is no ``engine.upload`` span."""
        t = torch.from_numpy(np.ascontiguousarray(array, dtype))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _outcomes(self, outs: List[torch.Tensor]) -> Outcomes:
        """One image's outcome chunks as an :class:`Outcomes` handle, on the
        card with an event recorded behind them on the current stream."""
        handle = Outcomes(outs)
        if self.device.type == "cuda":
            handle.done = torch.cuda.Event()
            handle.done.record(torch.cuda.current_stream(self.device))
        return handle

    @torch.inference_mode()
    def folded_logits(self, variables, images: torch.Tensor) -> torch.Tensor:
        """The masked forwards' ``logits_fn(variables, images)``: ``images``
        (NHWC, cast to the compute dtype) through :attr:`model` -> f32 logits
        (B2 on the card for an ImageNet ResNet). No gradient. ``variables``
        must be this engine's own, the weights its plan was built from."""
        if variables is not self.variables:
            raise ValueError("folded_logits runs the engine's own weights: pass engine.variables")
        return self.model(images.to(self.compute_dtype).contiguous())

    @torch.inference_mode()
    def predict_logits_device(self, images) -> torch.Tensor:
        """Batched unmasked forward, NHWC f32 [B, H, W, C] (host or device) ->
        f32 logits [B, classes] left on the device, so a caller can keep
        argmax targets there."""
        return self.model(self._to_device(images, np.float32).to(self.compute_dtype))

    def predict(self, images) -> np.ndarray:
        """Batched unmasked forward: NHWC f32 [B, H, W, C] -> f32 logits [B, classes]."""
        return fetch(self.predict_logits_device(images))

    def predict_one(self, image) -> Tuple[int, np.ndarray]:
        logits = self.predict(np.asarray(image)[None])[0]
        return int(logits.argmax()), logits

    def eval_window_masks(self, image, segments, firsts, width: int,
                          target: int) -> MaskEvalResult:
        """Evaluate K contiguous-window masks in ceil(K / mask_batch) forwards."""
        return self.collect(
            self.eval_window_masks_async(image, segments, firsts, width, target))

    @torch.inference_mode()
    def eval_window_masks_async(self, image, segments, firsts, width: int, target):
        """Enqueue K window-mask evaluations; returns an :class:`Outcomes`
        handle for :meth:`collect`. ``target`` is an int or a device tensor of
        one target (the argmax of :meth:`predict_logits_device`, never read
        by the host)."""
        image_t = self._to_device(image, np.float32)
        seg_t = self._to_device(segments, np.int32)
        firsts_t = self._to_device(firsts, np.int32)
        target = self._targets(target) if isinstance(target, torch.Tensor) else int(target)
        outs: List[torch.Tensor] = []
        for off in range(0, firsts_t.shape[0], self.mask_batch):
            imgs = masked_batch(image_t, seg_t, firsts_t[off:off + self.mask_batch],
                                int(width), self.compute_dtype)
            outs.append(outcomes(self.model(imgs), target))
        return self._outcomes(outs)

    @torch.inference_mode()
    def masked_outcomes(self, images: torch.Tensor, target) -> Tuple[torch.Tensor, torch.Tensor]:
        """The fused BO loop's forward: a device batch of masked images in
        ``compute_dtype`` -> (prob_target f32[B], survived bool[B]) on the
        device, with no host copy. ``target`` is an int or an int64 tensor of
        one target or one per image."""
        out = outcomes(self.model(images), target)
        return out[2], out[0] > 0.5

    def collect(self, handle) -> MaskEvalResult:
        """Wait for an ``*_async`` handle: one device-to-host copy, behind
        the handle's event alone where it has one (:func:`_fetch_after`),
        else behind the whole stream."""
        if not handle:
            z = np.zeros(0)
            return MaskEvalResult(z.astype(bool), z.astype(np.int32),
                                  z.astype(np.float32), z.astype(np.float32))
        done = getattr(handle, "done", None)
        if done is None:
            out = fetch(torch.cat(handle, dim=1))
        else:
            with trace.span("engine.fetch"):
                out = _fetch_after(handle, done)
        return MaskEvalResult(survived=out[0] > 0.5, preds=out[1].astype(np.int32),
                              prob_target=out[2].copy(), prob_max=out[3].copy())

    def eval_knockout_masks(self, image, segments, knock_ids, target: int) -> MaskEvalResult:
        """Evaluate K knockout masks (int32[K, M] ids; -1 knocks nothing) in
        ceil(K / mask_batch) forwards."""
        return self.collect(self.eval_knockout_masks_async(image, segments, knock_ids, target))

    def eval_knockout_masks_async(self, image, segments, knock_ids, target):
        """Enqueue K knockout-mask evaluations (int32[K, M] or [K] ids, host
        or device); returns an :class:`Outcomes` handle for :meth:`collect`.
        This is the multi-image grid with N = 1; ``target`` is an int or a
        device tensor of one target."""
        ids = _ids(knock_ids)
        targets = target.reshape(1) if isinstance(target, torch.Tensor) else [target]
        return self._outcomes(self.eval_knockout_masks_multi_async(
            image[None], segments[None], ids.reshape(1, ids.shape[0], -1), targets)[0])

    def _targets(self, targets) -> torch.Tensor:
        """int64[N] targets on the device, from host values or a device tensor
        (for example the argmax of :meth:`predict_logits_device`), never read
        back by the host."""
        if isinstance(targets, torch.Tensor):
            return targets.to(self.device, torch.int64).reshape(-1)
        return torch.from_numpy(np.asarray(targets, np.int64).reshape(-1)).to(self.device)

    @torch.inference_mode()
    def eval_knockout_masks_multi_async(self, images, segments, knock_ids, targets):
        """Enqueue the N*K knockout grid: images f32[N, H, W, C] (host or
        device), segments int32[N, H, W], knock_ids int32[N, K, M] and
        targets [N] (host or device). The grid is flattened image-major and
        cut into ``mask_batch`` chunks; each chunk's [mask_batch, H, W] masks
        are built on the device and dropped after its forward. Returns
        ``(handle, n, k)`` for :meth:`collect_multi`."""
        ids = _ids(knock_ids)
        n, k, m = ids.shape
        images_t = self._to_device(images, np.float32)
        segs_t = self._to_device(segments, np.int32)
        targets_t = self._targets(targets)
        ids_t = self._to_device(ids.reshape(n * k, m), np.int32)
        image_of = torch.arange(n, device=self.device).repeat_interleave(k)
        outs: List[torch.Tensor] = []
        for off in range(0, n * k, self.mask_batch):
            idx = image_of[off:off + self.mask_batch]
            masks = masking.knockout_masks(segs_t[idx], ids_t[off:off + self.mask_batch])
            imgs = (images_t[idx] * masks[..., None].to(torch.float32)).to(self.compute_dtype)
            outs.append(outcomes(self.model(imgs), targets_t[idx]))
        return outs, n, k

    def eval_knockout_masks_multi(self, images, segments, knock_ids,
                                  targets) -> List[MaskEvalResult]:
        """K knockout masks for each of N images; a list of N results."""
        return self.collect_multi(
            *self.eval_knockout_masks_multi_async(images, segments, knock_ids, targets))

    @torch.inference_mode()
    def eval_window_masks_multi_async(self, images, segments, firsts, widths, targets):
        """Enqueue the N*K window grid: images f32[N, H, W, C] (host or
        device), segments int32[N, H, W], firsts int32[N, K], widths int32[N],
        targets [N] (host or device). Each ``mask_batch`` chunk of the
        image-major grid is built by B1, one launch per image run of the
        chunk into its slice of the chunk, that image's width read on the
        device. Returns ``(handle, n, k)`` for :meth:`collect_multi`."""
        firsts = np.asarray(firsts, np.int32)
        n, k = firsts.shape
        images_t = self._to_device(images, np.float32)
        segs_t = self._to_device(segments, np.int32)
        targets_t = self._targets(targets)
        widths_t = self._to_device(np.asarray(widths, np.int32).reshape(n), np.int32)
        firsts_t = self._to_device(firsts.reshape(-1), np.int32)
        image_of = torch.arange(n, device=self.device).repeat_interleave(k)
        outs: List[torch.Tensor] = []
        for off in range(0, n * k, self.mask_batch):
            end = min(off + self.mask_batch, n * k)
            batch = torch.empty((end - off, *images_t.shape[1:]), dtype=self.compute_dtype,
                                device=self.device)
            for i in range(off // k, (end - 1) // k + 1):
                a, b = max(off, i * k), min(end, (i + 1) * k)
                masked_batch(images_t[i], segs_t[i], firsts_t[a:b], widths_t[i:i + 1],
                             self.compute_dtype, out=batch[a - off:b - off])
            outs.append(outcomes(self.model(batch), targets_t[image_of[off:end]]))
        return outs, n, k

    def eval_window_masks_multi(self, images, segments, firsts, widths,
                                targets) -> List[MaskEvalResult]:
        """K window masks for each of N images; a list of N results, each
        equal to the single-image call's."""
        return self.collect_multi(
            *self.eval_window_masks_multi_async(images, segments, firsts, widths, targets))

    def collect_multi(self, handle, n: int, k: int) -> List[MaskEvalResult]:
        """Wait for a ``*_multi_async`` handle (one device-to-host copy) and
        split the N*K outcomes into N results."""
        res = self.collect(handle)
        return [MaskEvalResult(survived=res.survived[i * k:(i + 1) * k],
                               preds=res.preds[i * k:(i + 1) * k],
                               prob_target=res.prob_target[i * k:(i + 1) * k],
                               prob_max=res.prob_max[i * k:(i + 1) * k]) for i in range(n)]

    @torch.inference_mode()
    def eval_mask_bank(self, image, masks, target: int) -> MaskEvalResult:
        """Evaluate an explicit bool[K, H, W] mask bank (host or device), one
        chunk uploaded per forward (the threshold search)."""
        image_t = self._to_device(image, np.float32)
        outs: List[torch.Tensor] = []
        for off in range(0, len(masks), self.mask_batch):
            chunk = self._to_device(masks[off:off + self.mask_batch], bool)
            imgs = masking.apply_masks(image_t, chunk).to(self.compute_dtype)
            outs.append(outcomes(self.model(imgs), int(target)))
        return self.collect(outs)


def _ids(knock_ids):
    """Knockout ids as they came if a tensor, else as an int32 array."""
    return knock_ids if isinstance(knock_ids, torch.Tensor) else np.asarray(knock_ids, np.int32)


_TORCH_DTYPE = {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32,
                np.dtype(bool): torch.bool}
