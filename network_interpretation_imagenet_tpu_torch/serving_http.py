"""Explanation-as-a-service: a stdlib HTTP/JSON endpoint over serving
artifacts (port of ``serving_http.py`` of the JAX package).

``serving.export_engine`` / ``export_bo_engine`` write artifacts, and this
server exposes them over HTTP with no framework (``http.server`` only). The
endpoints, the wire format, the status codes and the error messages are the
JAX package's.

Endpoints (JSON in/out):

* ``GET /healthz`` — artifact kind + manifest.
* ``GET /metrics`` — per-endpoint request/error counts and p50/p90/p99/max
  latency over a bounded window, the device sections' durations
  (``device_call_ms``) and the dynamic batcher's counters.
* ``POST /explain`` — one image -> saliency explanation. ``"mode"``:
  ``"bo"`` (default on BO artifacts: ``ExportedBOServer.explain``, the
  fused loop, a CUDA graph replay on the card), ``"window"`` (default
  otherwise: K = ``num_samples`` window masks in bucketed forwards, B1 and
  the engine's plan, and the summed heatmap on the host) or ``"knockout"``
  (``num_knockout`` segments per mask; needs ``knockout_m``).
* ``POST /explain_batch`` — BO artifact only: N images in one request; one
  image-batched loop when N > 1 and an exported ``image_batches`` entry
  holds N (``ExportedBOServer.explain_many`` decides, as for the dynamic
  batcher), else N single loops; image i draws with ``seeds[i]`` (default
  ``seed + i``) either way.
* ``POST /eval_windows`` — engine artifact: explicit ``firsts``/``width``/
  ``target`` -> per-mask survive/prob arrays.
* ``POST /eval_knockouts`` — engine artifact with ``knockout_m``:
  ``knock_ids`` int32[K, m] -> the same per-mask arrays.
* ``POST /attribute`` — engine artifact exported with
  ``attribution=[...]``: one image + ``"method"`` -> ``heatmap_b64``
  f32[H, W]; optional ``"target"`` (inferred when absent) and ``"seed"``.
  ``method="xrai"`` adds ``num_regions`` and ``attribution_b64``; an
  optional ``"display"`` (uint8) feeds its Felzenszwalb ladder.
* ``POST /attribute_batch`` — N images + ``"method"``: one stacked backward
  when N > 1 and an ``attribution_batches`` entry holds N
  (``attribute_many`` decides), else N calls.

Arrays travel as nested JSON lists or as base64 raw little-endian bytes
(``"image_b64"`` + ``"image_shape"``; f32 images, int32 segments). Images
may also come as raw uint8 (``"image_u8_b64"``, scaled to [0, 1] here, with
an optional ``"normalize": {"mean", "std"}``) or as the original JPEG
(``"image_jpeg_b64"``), which gets the port's eval transform
(``data.transform.pil_eval_transform``; ``"preprocess": {"crop", "mean",
"std"}``). Without ``"segments"`` the server segments with Felzenszwalb
(scale 100, sigma 0.5, min_size 50) or the request's ``"segment"`` dict.

**One device, one thread.** Every device call, uploads included, runs on
one long-lived :class:`DeviceThread` (one shared by every model of a
registry), one call at a time. The HTTP layer is threaded, a new thread per request, and two things forbid device calls from
those threads: PyTorch rebuilds its per-thread library state in each new
thread (tens of milliseconds a request on the H100), and the fused BO loop
captures a CUDA graph at a shape's second call, in the global capture mode,
so a CUDA call from another thread during a capture would invalidate it.
Request decoding, host segmentation (SLIC, which runs on the device, goes to
the device thread) and JSON encoding stay off the device. A capture that
fails raises; nothing retries it eagerly. ``SaliencyService.warmup``
(``cli.serve --warmup``) captures every exported shape, on the device
thread, before the server accepts a request.
"""

from __future__ import annotations

import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from network_interpretation_imagenet_tpu_torch import serving as serving_mod


def _decode_array(body: dict, key: str, dtype) -> "np.ndarray | None":
    """Array from ``key`` (nested lists) or ``key_b64`` + ``key_shape``."""
    if f"{key}_b64" in body:
        raw = base64.b64decode(body[f"{key}_b64"])
        arr = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder("<"))
        shape = body.get(f"{key}_shape")
        return arr.reshape(shape) if shape is not None else arr
    if key in body:
        return np.asarray(body[key], dtype)
    return None


def _decode_image(body: dict, key: str) -> "np.ndarray | None":
    """Image array from ``key``: f32 (lists or ``_b64``), raw uint8 via
    ``{key}_u8_b64`` (4× smaller; scaled to [0,1] server-side with an
    optional ``"normalize": {"mean": [...], "std": [...]}`` applied after
    the /255), or ORIGINAL JPEG bytes via ``{key}_jpeg_b64`` (a b64 string,
    or a list of them for the batch key) — the server then runs the full
    bit-exact torchvision eval transform (resize → center-crop → /255 →
    mean/std), tuned by ``"preprocess": {"crop", "mean", "std"}``
    (defaults: 224, ImageNet stats), so clients ship the file untouched
    and never reimplement preprocessing. JPEG decodes as RGB (3-channel
    models only)."""
    if f"{key}_jpeg_b64" in body:
        from io import BytesIO

        from PIL import Image

        from network_interpretation_imagenet_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
        from network_interpretation_imagenet_tpu_torch.data.transform import pil_eval_transform

        if body.get("normalize") is not None:
            raise ValueError(
                f"'normalize' applies only to u8 arrays ({key}_u8_b64); "
                "JPEG images take mean/std inside 'preprocess'")
        pp = body.get("preprocess") or {}
        crop = int(pp.get("crop", 224))
        mean = pp.get("mean", IMAGENET_MEAN)
        std = pp.get("std", IMAGENET_STD)

        def one(b64s: str) -> np.ndarray:
            try:
                img = Image.open(
                    BytesIO(base64.b64decode(b64s))).convert("RGB")
            except (OSError, ValueError) as e:
                # UnidentifiedImageError/truncated-file OSError and
                # binascii.Error are malformed CLIENT input → ValueError so
                # the handler's 400 tuple catches it (not a 500).
                raise ValueError(
                    f"invalid JPEG bytes in {key}_jpeg_b64: {e}") from e
            return pil_eval_transform(img, crop, mean, std)

        blobs = body[f"{key}_jpeg_b64"]
        if isinstance(blobs, str):
            return one(blobs)
        return np.stack([one(b) for b in blobs])
    if body.get("preprocess") is not None:
        raise ValueError(
            f"'preprocess' applies only to JPEG images ({key}_jpeg_b64); "
            "decoded arrays use 'normalize' (u8) or arrive preprocessed "
            "(f32)")
    if f"{key}_u8_b64" in body:
        raw = base64.b64decode(body[f"{key}_u8_b64"])
        arr = np.frombuffer(raw, np.uint8).astype(np.float32) / 255.0
        shape = body.get(f"{key}_shape")
        if shape is not None:
            arr = arr.reshape(shape)
        norm = body.get("normalize")
        if norm is not None:
            mean = np.asarray(norm["mean"], np.float32)
            std = np.asarray(norm["std"], np.float32)
            arr = (arr - mean) / std
        return arr
    if body.get("normalize") is not None and (
            key in body or f"{key}_b64" in body):
        # Silently skipping the normalization would run the model on
        # un-preprocessed pixels and return a confidently wrong heatmap.
        raise ValueError(
            f"'normalize' applies only to uint8 images ({key}_u8_b64); "
            "float images must arrive preprocessed")
    return _decode_array(body, key, np.float32)


def _encode_array(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {
        "b64": base64.b64encode(
            arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        ).decode("ascii"),
        "shape": list(arr.shape),
        "dtype": str(arr.dtype),
    }


def _segment_for(body: dict, image: np.ndarray, device=None, on_device=None) -> np.ndarray:
    """The request's segment map: Felzenszwalb on the host, or SLIC on
    ``device``, run through ``on_device`` (the service's device thread)."""
    from network_interpretation_imagenet_tpu_torch.config import SegmentConfig
    from network_interpretation_imagenet_tpu_torch.ops.aggregate import normalize_to_uint8_np
    from network_interpretation_imagenet_tpu_torch.segment.common import segment_image

    cfg = SegmentConfig(**body.get("segment", {}))
    disp = normalize_to_uint8_np(image)
    if disp.ndim == 3 and disp.shape[2] == 1:
        disp = disp[:, :, 0]
    if cfg.method == "slic":
        return on_device(lambda: segment_image(disp, cfg, device))
    return segment_image(disp, cfg)


class ServiceMetrics:
    """Thread-safe per-endpoint request counters + bounded latency window.

    ``window`` bounds memory per endpoint; quantiles are over the last
    ``window`` requests (a serving process handles few, long device calls,
    so a small sliding window tracks current behavior better than
    lifetime aggregates).
    """

    def __init__(self, window: int = 512):
        import collections

        self._lock = threading.Lock()
        self._window = window
        self._t_start = time.time()
        self._stats: dict = {}
        self._deque = collections.deque

    def observe(self, endpoint: str, code: int, seconds: float) -> None:
        with self._lock:
            st = self._stats.setdefault(
                endpoint,
                {"count": 0, "errors_4xx": 0, "errors_5xx": 0,
                 "lat": self._deque(maxlen=self._window)},
            )
            st["count"] += 1
            if 400 <= code < 500:
                st["errors_4xx"] += 1
            elif code >= 500:
                st["errors_5xx"] += 1
            st["lat"].append(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            out = {"uptime_seconds": round(time.time() - self._t_start, 3),
                   "endpoints": {}}
            for ep, st in self._stats.items():
                lat = np.asarray(st["lat"], np.float64)
                entry = {
                    "count": st["count"],
                    "errors_4xx": st["errors_4xx"],
                    "errors_5xx": st["errors_5xx"],
                }
                if lat.size:
                    entry["latency_seconds"] = {
                        "window": int(lat.size),
                        "p50": round(float(np.percentile(lat, 50)), 6),
                        "p90": round(float(np.percentile(lat, 90)), 6),
                        "p99": round(float(np.percentile(lat, 99)), 6),
                        "max": round(float(lat.max()), 6),
                    }
                out["endpoints"][ep] = entry
            return out


class DeviceThread:
    """The one long-lived thread that makes every device call of a process's
    services, one call at a time.

    PyTorch keeps per-thread library state on the card (cuDNN's execution
    plans, handles): a device call from a thread that has not made it before
    rebuilds that state. ``ThreadingHTTPServer`` runs each request on a new
    thread, so handler threads calling the device directly pay it on every
    request: on the H100 a B=1 ResNet-101 predict took 59.9 ms from a fresh
    thread against 4.5 ms on this thread, an occlusion map 206.4 ms against
    22.5 (``chip_smoke.py`` ``[serve]``, PERF.md). Running every
    device call here also leaves no other thread to
    touch CUDA while a BO shape's graph is captured. Its queue is the one
    thing that serializes device calls. ``run`` returns the call's result or
    raises its exception in the caller."""

    def __init__(self) -> None:
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="device")
        self._count_lock = threading.Lock()
        self._pending = 0   # calls submitted and not yet returned

    def busy(self) -> bool:
        """Whether a call is running or queued."""
        return self._pending > 0

    def run(self, fn):
        with self._count_lock:
            self._pending += 1
        try:
            return self._pool.submit(fn).result()
        finally:
            with self._count_lock:
                self._pending -= 1


class ServiceOverloadedError(RuntimeError):
    """Load-shed signal: the request was rejected before any work started
    (HTTP layer maps it to 503 so clients can retry with backoff)."""


class _DynamicBatcher:
    """Coalesce concurrent single-image BO ``/explain`` requests into ONE
    image-batched device call.

    The device thread serializes requests, so under concurrency the
    baseline throughput ceiling is one fused BO loop per request. When the artifact
    carries image-batched loops (``export_bo_engine(image_batches=...)``)
    a group of N queued requests runs as one loop whose forwards batch the
    N images. CONTINUOUS batching: the first
    request to arrive on an empty queue becomes the group leader and
    submits a drain of the queue to the device thread — when the device
    was busy, the wait for the thread IS the collection window, so
    everything that queued during the previous batch's run coalesces with
    zero artificial sleep;
    an isolated request on an idle device runs immediately (no added
    latency at C=1). ``wait_s`` only pads the one remaining case — a
    multi-request burst landing on an idle device — so the burst shares
    the first call. Each (image-shape, window_fraction) group runs as one
    ``explain_batch`` device call — images must stack, and the fused loop
    takes one window fraction per call. Followers block on a per-request
    event.

    Target inference for grouped requests goes through the batched predict
    head (one device call for all missing targets), which can differ from
    the single-image head in low-order logit bits on near-tied classes —
    the same documented caveat as ``/explain_batch``. Explicit targets are
    bit-stable.
    """

    def __init__(self, service: "SaliencyService", wait_s: float = 0.005,
                 max_pending: int = 256, max_group: "int | None" = None):
        self._service = service
        self._wait_s = float(wait_s)
        batched = getattr(service.bo_server, "_batched", None) or {}
        self._max_batch = max(batched) if batched else 1
        if max_group is not None:
            # Blast-radius bound: one slow coalesced device call (a cold
            # shape's capture, say) stalls its WHOLE group. Capping the
            # group trades a few extra device calls for proportionally
            # fewer requests exposed to any one slow call.
            self._max_batch = max(1, min(self._max_batch, int(max_group)))
        self._max_pending = int(max_pending)
        self._lock = threading.Lock()
        self._queue: list = []
        self._outstanding = 0  # enqueued AND not yet answered (≠ len(queue))
        self.stats = {"requests": 0, "device_calls": 0, "max_group": 0,
                      "rejected": 0}

    def explain(self, image, segments, wf, seed, target):
        """Single request entry point; returns ``(out, bo_res, target)``
        exactly like the direct ``bo_server.explain`` path."""
        # Per-request validation happens HERE, before the request can join
        # a group — a malformed field must 400 its own request, never
        # poison groupmates.
        req = {"image": np.asarray(image, np.float32),
               "segments": np.asarray(segments, np.int32),
               "wf": float(wf), "seed": int(seed),
               "target": None if target is None else int(target),
               "event": threading.Event(), "result": None, "error": None}
        with self._lock:
            if self._outstanding >= self._max_pending:
                # Backpressure on OUTSTANDING work (queued + in device
                # call), not just the current collection window: each
                # pending request pins its decoded image in memory, so
                # unbounded accumulation behind a slow device would OOM.
                self.stats["rejected"] += 1
                raise ServiceOverloadedError(
                    f"dynamic-batch queue full ({self._max_pending} "
                    "pending explains) — retry with backoff"
                )
            self._outstanding += 1
            self._queue.append(req)
            leader = len(self._queue) == 1
            self.stats["requests"] += 1
        if leader:
            with self._lock:
                solo = len(self._queue) == 1
            if not solo and not self._service._device_thread.busy():
                # A burst landed on an IDLE device: wait the collection
                # window so the whole burst shares the first device call
                # instead of the leader running alone.
                time.sleep(self._wait_s)
            # Continuous batching: the queue is drained when the device
            # thread reaches this call. When the device was busy, everything
            # that queued during the previous batch's run becomes this
            # group — the wait for the thread IS the collection window, so
            # the hot path never sleeps, and an isolated request on an idle
            # device runs immediately (zero added latency at C=1).
            self._service._device_thread.run(self._drain)
        req["event"].wait()
        if req["error"] is not None:
            raise req["error"]
        return req["result"]

    def _drain(self) -> None:
        """On the device thread: take the queue and run it. Arrivals after
        the drain see an empty queue and elect a new leader themselves, so
        no request is left waiting."""
        with self._lock:
            batch, self._queue = self._queue, []
        if batch:
            self._run(batch)

    def _run(self, batch: list) -> None:
        groups: dict = {}
        for r in batch:
            key = (tuple(r["image"].shape), r["wf"])
            groups.setdefault(key, []).append(r)
        for (_, wf), reqs in groups.items():
            for i in range(0, len(reqs), self._max_batch):
                self._run_group(reqs[i:i + self._max_batch], wf)

    def _run_group(self, reqs: list, wf: float) -> None:
        """Run one coalesced group, on the device thread."""
        bo = self._service.bo_server
        n = len(reqs)
        calls = 0
        t_dev = time.perf_counter()
        try:
            images = np.stack([r["image"] for r in reqs])
            segs = [r["segments"] for r in reqs]
            targets = [r["target"] for r in reqs]
            missing = [i for i, t in enumerate(targets) if t is None]
            if missing:
                logits = bo.predict_logits_batch(images[missing])
                for j, i in enumerate(missing):
                    targets[i] = int(logits[j].argmax())
            outs, calls = bo.explain_many(
                images, segs, window_fraction=wf,
                per_image_seeds=[r["seed"] for r in reqs], targets=targets,
            )
            for r, (out, bo_res), t in zip(reqs, outs, targets):
                r["result"] = (out, bo_res, t)
        except Exception:
            # One request's data can fail the whole batched call (e.g. a
            # segment count needing a bigger candidate bucket than the
            # artifact exported). Isolate the offender: re-run each request
            # serially so only ITS error propagates; groupmates still get
            # their answers (at serialized cost for this group only).
            for r in reqs:
                try:
                    t = r["target"]
                    if t is None:
                        t = int(bo.predict_logits(r["image"]).argmax())
                    out, bo_res = bo.explain(
                        r["image"], r["segments"], window_fraction=wf,
                        seed=r["seed"], target=t,
                    )
                    calls += 1
                    r["result"] = (out, bo_res, t)
                except Exception as e:
                    r["error"] = e
        finally:
            # One duration per GROUP (covers predict + explain_many/serial
            # fallback): a slow entry here that lines up with n slow client
            # latencies is the coalesced-call tail signature.
            self._service.record_device_call(time.perf_counter() - t_dev)
            with self._lock:
                self.stats["device_calls"] += calls
                self.stats["max_group"] = max(self.stats["max_group"], n)
                self._outstanding -= n
            for r in reqs:
                r["event"].set()


class SaliencyService:
    """Artifact wrapper the HTTP handler delegates to (also usable
    directly in tests — the transport layer stays trivially thin).

    ``device_thread``: the :class:`DeviceThread` that makes the device
    calls; pass a SHARED one when several services live in one process
    (the multi-model registry): there is one CUDA context per process, so
    device calls across models must serialize on one thread, not one per
    model. ``device``: where the artifacts' engines run (None: the card,
    which raises without one; ``"cpu"`` runs on the CPU)."""

    def __init__(self, artifact_dir: str, device=None,
                 device_thread: "DeviceThread | None" = None):
        import os

        self._device_thread = device_thread or DeviceThread()
        self._batcher = None
        # Device-call durations (seconds, bounded): every BO /explain
        # device section — serialized or coalesced — records here, so a
        # latency tail can be ATTRIBUTED: if the slowest client latencies
        # line up with slow device calls, the tail is the device
        # (one slow coalesced call stalls its whole group); if not, it is
        # host-side queueing. Read via /metrics ("device_call_ms").
        self._call_lock = threading.Lock()
        self.device_call_s: list = []
        # A directory may hold BOTH artifact kinds (export_engine and
        # export_bo_engine share the weights blob when pointed at one dir);
        # load whatever is present — /explain prefers the fused-BO loop,
        # /eval_windows needs the engine artifact. Both servers share one
        # engine when their manifests describe the same model.
        self.bo_server = None
        self.engine_server = None
        if os.path.isfile(os.path.join(artifact_dir, serving_mod.MANIFEST)):
            self.engine_server = serving_mod.load_exported(artifact_dir, device=device)
        if os.path.isfile(os.path.join(artifact_dir, serving_mod.BO_MANIFEST)):
            engine = None
            if self.engine_server is not None:
                with open(os.path.join(artifact_dir, serving_mod.BO_MANIFEST)) as f:
                    if serving_mod.same_engine(self.engine_server.manifest, json.load(f)):
                        engine = self.engine_server.engine
            self.bo_server = serving_mod.load_exported_bo(artifact_dir, device=device,
                                                          engine=engine)
        if self.bo_server is None and self.engine_server is None:
            raise FileNotFoundError(
                f"no {serving_mod.MANIFEST} or {serving_mod.BO_MANIFEST} "
                f"in {artifact_dir!r} — export one with cli.export_serving"
            )
        self.kind = "+".join(
            k for k, s in (("bo", self.bo_server), ("engine", self.engine_server))
            if s is not None
        )
        self._device = (self.engine_server or self.bo_server).device

    def _on_device(self, fn):
        """``fn()`` on the device thread."""
        return self._device_thread.run(fn)

    def record_device_call(self, seconds: float) -> None:
        """Append one device-section duration (bounded; drops after 65536
        entries rather than growing without limit in a long-lived server)."""
        with self._call_lock:
            if len(self.device_call_s) < 65536:
                self.device_call_s.append(float(seconds))

    def device_call_stats(self) -> dict:
        """Summary of recorded device-section durations (ms)."""
        with self._call_lock:
            arr = np.asarray(self.device_call_s, np.float64) * 1e3
        if arr.size == 0:
            return {"count": 0}
        return {
            "count": int(arr.size),
            "p50_ms": round(float(np.percentile(arr, 50)), 1),
            "p95_ms": round(float(np.percentile(arr, 95)), 1),
            "max_ms": round(float(arr.max()), 1),
            "over_1s": int(np.sum(arr > 1000.0)),
        }

    def enable_dynamic_batching(self, wait_ms: float = 5.0,
                                max_pending: int = 256,
                                max_group: "int | None" = None) -> None:
        """Route ``mode='bo'`` ``/explain`` requests through a micro-batcher
        that coalesces concurrent arrivals into one image-batched device
        call (see :class:`_DynamicBatcher`). Requires a fused-BO artifact;
        pays off when it was exported with ``image_batches``. Beyond
        ``max_pending`` queued requests the batcher sheds load
        (:class:`ServiceOverloadedError` → HTTP 503). ``max_group`` caps
        the coalesced group size below the artifact's largest exported
        image batch — the latency-tail blast-radius bound (one slow device
        call stalls at most ``max_group`` requests)."""
        if self.bo_server is None:
            raise ValueError("dynamic batching needs a fused-BO artifact")
        self._batcher = _DynamicBatcher(self, wait_ms / 1000.0, max_pending,
                                        max_group)

    def warmup(self) -> int:
        """Run every served program once (both artifact kinds): the kernels
        build, the libraries warm up and every exported BO shape is captured
        as a CUDA graph, so the first real request is served warm. Returns
        the program count."""
        return self._on_device(lambda: sum(
            server.warmup() for server in (self.engine_server, self.bo_server)
            if server is not None))

    def healthz(self) -> dict:
        out = {"status": "ok", "kind": self.kind}
        if self.bo_server is not None:
            out["bo_manifest"] = self.bo_server.manifest
        if self.engine_server is not None:
            out["manifest"] = self.engine_server.manifest
        return out

    def explain(self, body: dict) -> dict:
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        image = _decode_image(body, "image")
        if image is None:
            raise ValueError("missing 'image' (or 'image_b64'+'image_shape')")
        segments = _decode_array(body, "segments", np.int32)
        if segments is None:
            segments = _segment_for(body, image, self._device, self._on_device)
        seed = int(body.get("seed", 0))
        wf = float(body.get("window_fraction", 0.4))
        target = body.get("target")
        # "bo" (default on BO artifacts) / "window" / "knockout".
        mode = body.get("mode")
        if mode is None:
            mode = "bo" if self.bo_server is not None else "window"
        if mode not in ("bo", "window", "knockout"):
            raise ValueError(f"unknown mode {mode!r} "
                             "(expected 'bo', 'window' or 'knockout')")
        if mode == "bo" and self.bo_server is None:
            raise ValueError("mode='bo' needs a fused-BO artifact")
        if mode != "bo" and self.engine_server is None:
            raise ValueError(f"mode={mode!r} needs an engine artifact")

        if mode == "bo":
            if self._batcher is not None:
                out, bo_res, target = self._batcher.explain(
                    image, segments, wf, seed, target
                )
            else:
                def call():
                    t_dev = time.perf_counter()
                    t = target
                    if t is None:
                        t = int(self.bo_server.predict_logits(image).argmax())
                    out, bo_res = self.bo_server.explain(
                        image, segments, window_fraction=wf, seed=seed,
                        target=t,
                    )
                    self.record_device_call(time.perf_counter() - t_dev)
                    return out, bo_res, t

                out, bo_res, target = self._on_device(call)
            return self._bo_item_json(
                out, bo_res, int(target), bool(body.get("json_arrays"))
            )
        else:
            from network_interpretation_imagenet_tpu_torch.ops.aggregate import (
                summed_knockout_labels_np,
                summed_superpixel_labels_np,
            )
            from network_interpretation_imagenet_tpu_torch.ops.masking import (
                sample_knockout_ids_host,
                sample_window_starts_host,
            )

            s = int(segments.max()) + 1
            k = int(body.get("num_samples", 100))
            def call():
                t = target
                if t is None:
                    # One full-width window (keeps every segment) IS the
                    # unmasked forward — the engine artifact has no separate
                    # predict head.
                    logits = self.engine_server.logits_for_windows(
                        image, segments, np.zeros(1, np.int32), s
                    )
                    t = int(logits[0].argmax())
                if mode == "knockout":
                    m = int(body.get("num_knockout", 1))
                    knock_ids = sample_knockout_ids_host(seed, k, m, s)
                    res = self.engine_server.eval_knockout_masks(
                        image, segments, knock_ids, int(t)
                    )
                    heat = summed_knockout_labels_np(
                        segments, knock_ids, np.asarray(res.survived)
                    )
                else:
                    width = int(wf * s)
                    firsts = sample_window_starts_host(seed, k, s, width)
                    res = self.engine_server.eval_window_masks(
                        image, segments, firsts, width, int(t)
                    )
                    heat = summed_superpixel_labels_np(
                        segments, firsts, width, np.asarray(res.survived)
                    )
                return t, res, heat

            target, res, heat = self._on_device(call)
            resp = {
                "target": int(target),
                "num_segments": s,
                "num_samples": k,
                "survival": float(np.mean(res.survived)),
            }
            if mode == "knockout":
                resp["num_knockout"] = int(body.get("num_knockout", 1))
        enc = _encode_array(np.asarray(heat, np.float32))
        resp["heatmap_b64"] = enc["b64"]
        resp["heatmap_shape"] = enc["shape"]
        if body.get("json_arrays"):
            resp["heatmap"] = np.asarray(heat, np.float32).tolist()
        return resp

    def explain_batch(self, body: dict) -> dict:
        """N images in one request (BO artifacts only). Delegates the
        batched-vs-sequential choice to ``ExportedBOServer.explain_many``
        (ONE device call when N > 1 and an exported
        ``image_batches`` entry fits, else N sequential ``explain`` calls
        — the same rule the dynamic batcher uses). Image i draws from a
        generator seeded with ``seeds[i]`` either way (default ``seeds =
        [seed + i]``), so given EXPLICIT ``targets`` a trajectory is the
        single-image call's up to the rounding of a forward at another
        batch size; inferred targets run through the batched predict
        (padded to the exported image batch) or N batch-1 calls, whose
        logits may differ in low-order bits on near-tied classes."""
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        if self.bo_server is None:
            raise ValueError("/explain_batch needs a fused-BO artifact "
                             "(export with cli.export_serving --bo)")
        images = _decode_image(body, "images")
        if images is None or images.ndim != 4:
            raise ValueError(
                "missing 'images' (or 'images_b64'+'images_shape' [N,H,W,C])"
            )
        n = images.shape[0]
        if n == 0:
            return {"results": []}
        segments = _decode_array(body, "segments", np.int32)
        if segments is None:
            segments = np.stack(
                [_segment_for(body, images[i], self._device, self._on_device)
                 for i in range(n)]
            )
        elif segments.shape[0] != n:
            raise ValueError(
                f"'segments' leading dim {segments.shape[0]} != N={n}"
            )
        wf = float(body.get("window_fraction", 0.4))
        seeds = body.get("seeds")
        if seeds is None:
            seed = int(body.get("seed", 0))
            seeds = [seed + i for i in range(n)]
        elif len(seeds) != n:
            raise ValueError(f"'seeds' length {len(seeds)} != N={n}")
        targets = body.get("targets")
        if targets is not None and len(targets) != n:
            raise ValueError(f"'targets' length {len(targets)} != N={n}")

        def call(targets):
            if targets is None:
                targets = self.bo_server.predict_logits_batch(
                    images
                ).argmax(axis=-1)
            targets = [int(t) for t in targets]
            outs, _ = self.bo_server.explain_many(
                images, list(segments), window_fraction=wf,
                per_image_seeds=[int(s) for s in seeds], targets=targets,
            )
            return targets, outs

        targets, outs = self._on_device(lambda: call(targets))
        json_arrays = bool(body.get("json_arrays"))
        return {"results": [
            self._bo_item_json(out, bo_res, t, json_arrays)
            for t, (out, bo_res) in zip(targets, outs)
        ]}

    @staticmethod
    def _bo_item_json(out, bo_res, target: int, json_arrays: bool) -> dict:
        """One BO explanation as the wire dict — the single source of the
        /explain (mode=bo) and /explain_batch response item format."""
        enc = _encode_array(np.asarray(out.heatmap, np.float32))
        item = {
            "target": int(target),
            "num_segments": int(out.num_segments),
            "best_start": int(bo_res.xp[int(np.argmax(bo_res.yp))]),
            "survival": float(np.mean(bo_res.survived)),
            "xp": [int(x) for x in bo_res.xp],
            "yp": [float(y) for y in bo_res.yp],
            "heatmap_b64": enc["b64"],
            "heatmap_shape": enc["shape"],
        }
        if json_arrays:
            item["heatmap"] = np.asarray(out.heatmap, np.float32).tolist()
        return item

    def eval_windows(self, body: dict) -> dict:
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        if self.engine_server is None:
            raise ValueError("/eval_windows needs an engine artifact "
                             "(this one is a fused-BO artifact)")
        image = _decode_image(body, "image")
        segments = _decode_array(body, "segments", np.int32)
        if image is None or segments is None:
            raise ValueError("missing 'image' or 'segments'")
        firsts = _decode_array(body, "firsts", np.int32)
        if firsts is None:
            raise ValueError("missing 'firsts'")
        width, target = int(body["width"]), int(body["target"])
        res = self._on_device(lambda: self.engine_server.eval_window_masks(
            image, segments, firsts, width, target))
        return self._mask_eval_json(res)

    def attribute(self, body: dict) -> dict:
        """Per-image attribution of the artifact's methods
        (``export_engine(attribution=[...])``). ``"method"`` selects the
        method; ``"target"`` is inferred via the engine's full-width
        window forward when absent; ``"seed"`` feeds stochastic methods
        (smoothgrad, rise, meaningful). ``method="xrai"`` runs the signed
        IG on the device plus the server-side felzenszwalb-ladder greedy ranking
        (``ExportedSaliencyServer.xrai``); an optional ``"display"``
        (uint8, same wire encoding as ``"image"``) feeds the ladder, and
        the response additionally carries the signed attribution and
        ``num_regions``."""
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        if self.engine_server is None:
            raise ValueError("/attribute needs an engine artifact "
                             "(this one is a fused-BO artifact)")
        methods = self.engine_server.attribution_methods
        xrai_ok = getattr(self.engine_server, "xrai_config", None)
        if not methods and not xrai_ok:
            raise ValueError(
                "artifact has no attribution programs; re-export with "
                "--attribution gradient,integrated,..."
            )
        available = list(methods) + (["xrai"] if xrai_ok else [])
        method = body.get("method")
        if method is None:
            raise ValueError(f"missing 'method' (available: {available})")
        if method not in available:
            # Reject BEFORE target inference — an unknown method must not
            # pay (or hold the device thread for) a full padded window-bucket
            # forward just to 400.
            raise ValueError(
                f"artifact has no {method!r} attribution program "
                f"(available: {available}); re-export with "
                "--attribution")
        image = _decode_image(body, "image")
        if image is None:
            raise ValueError("missing 'image' (or 'image_b64'+'image_shape')")
        target = body.get("target")
        seed = int(body.get("seed", 0))
        display = None
        if method == "xrai":
            display = _decode_array(body, "display", np.uint8)
            if display is not None and display.shape[:2] != image.shape[:2]:
                raise ValueError(
                    f"'display' spatial shape {display.shape[:2]} != "
                    f"image {image.shape[:2]}")
        def call(target):
            xres = None
            if target is None:
                # The full-width window (keeps every segment) IS the
                # unmasked forward; a constant-0 segment map makes it
                # image-independent.
                segments = np.zeros(image.shape[:2], np.int32)
                logits = self.engine_server.logits_for_windows(
                    image, segments, np.zeros(1, np.int32), 1
                )
                target = int(logits[0].argmax())
            if method == "xrai":
                xres = self.engine_server.xrai(
                    image, int(target), display=display, seed=seed
                )
                heat = np.asarray(xres.heatmap, np.float32)
            else:
                heat = self.engine_server.attribute(
                    image, int(target), str(method), seed=seed
                )
            return target, xres, heat

        target, xres, heat = self._on_device(lambda: call(target))
        enc = _encode_array(heat)
        resp = {
            "target": int(target),
            "method": str(method),
            "config": self.engine_server.attribution_config,
            "heatmap_b64": enc["b64"],
            "heatmap_shape": enc["shape"],
        }
        if method == "xrai":
            attr_enc = _encode_array(np.asarray(xres.attribution, np.float32))
            resp["num_regions"] = int(xres.num_regions)
            resp["attribution_b64"] = attr_enc["b64"]
            resp["attribution_shape"] = attr_enc["shape"]
            resp["xrai"] = {k: v for k, v in
                            self.engine_server.xrai_config.items()
                            if k != "file"}
        if body.get("json_arrays"):
            resp["heatmap"] = heat.tolist()
        return resp

    def attribute_batch(self, body: dict) -> dict:
        """N images' attribution maps in one request; delegates the
        batched-vs-sequential choice to
        ``ExportedSaliencyServer.attribute_many`` (ONE device call when
        N > 1 and an exported ``attribution_batches`` entry fits)."""
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        if self.engine_server is None:
            raise ValueError("/attribute_batch needs an engine artifact "
                             "(this one is a fused-BO artifact)")
        methods = self.engine_server.attribution_methods
        if not methods:
            raise ValueError(
                "artifact has no attribution programs; re-export with "
                "--attribution gradient,integrated,..."
            )
        method = body.get("method")
        if method is None:
            raise ValueError(f"missing 'method' (available: {list(methods)})")
        if method not in methods:
            raise ValueError(
                f"artifact has no {method!r} attribution program "
                f"(available: {list(methods)}); re-export with "
                "--attribution")
        images = _decode_image(body, "images")
        if images is None or images.ndim != 4:
            raise ValueError(
                "missing 'images' (or 'images_b64'+'images_shape' [N,H,W,C])"
            )
        n = images.shape[0]
        if n == 0:
            return {"results": []}
        seeds = body.get("seeds")
        if seeds is None:
            seed = int(body.get("seed", 0))
            seeds = [seed + i for i in range(n)]
        elif len(seeds) != n:
            raise ValueError(f"'seeds' length {len(seeds)} != N={n}")
        targets = body.get("targets")
        if targets is not None and len(targets) != n:
            raise ValueError(f"'targets' length {len(targets)} != N={n}")
        def call(targets):
            if targets is None:
                # Per-image inference via the full-width window forward
                # (the engine artifact has no batched predict head).
                zero_seg = np.zeros(images.shape[1:3], np.int32)
                targets = [
                    int(self.engine_server.logits_for_windows(
                        images[i], zero_seg, np.zeros(1, np.int32), 1
                    )[0].argmax())
                    for i in range(n)
                ]
            targets = [int(t) for t in targets]
            heats, _ = self.engine_server.attribute_many(
                images, targets, str(method), seeds=[int(x) for x in seeds]
            )
            return targets, heats

        targets, heats = self._on_device(lambda: call(targets))
        json_arrays = bool(body.get("json_arrays"))
        cfg = self.engine_server.attribution_config
        results = []
        for i in range(n):
            enc = _encode_array(np.asarray(heats[i], np.float32))
            item = {"target": targets[i], "method": str(method),
                    "config": cfg, "heatmap_b64": enc["b64"],
                    "heatmap_shape": enc["shape"]}
            if json_arrays:
                item["heatmap"] = np.asarray(heats[i], np.float32).tolist()
            results.append(item)
        return {"results": results}

    def eval_knockouts(self, body: dict) -> dict:
        """Knockout twin of :meth:`eval_windows` — ``knock_ids`` int32[K, m]
        (m ≤ the artifact's exported ``knockout_m``) instead of
        ``firsts``/``width``."""
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        if self.engine_server is None:
            raise ValueError("/eval_knockouts needs an engine artifact "
                             "(this one is a fused-BO artifact)")
        image = _decode_image(body, "image")
        segments = _decode_array(body, "segments", np.int32)
        if image is None or segments is None:
            raise ValueError("missing 'image' or 'segments'")
        knock_ids = _decode_array(body, "knock_ids", np.int32)
        if knock_ids is None:
            raise ValueError("missing 'knock_ids'")
        target = int(body["target"])
        res = self._on_device(lambda: self.engine_server.eval_knockout_masks(
            image, segments, knock_ids, target))
        return self._mask_eval_json(res)

    @staticmethod
    def _mask_eval_json(res) -> dict:
        return {
            "survived": [bool(v) for v in res.survived],
            "preds": [int(v) for v in res.preds],
            "prob_target": [float(v) for v in res.prob_target],
            "prob_max": [float(v) for v in res.prob_max],
        }


_POST_ENDPOINTS = ("/explain", "/explain_batch", "/eval_windows",
                   "/eval_knockouts", "/attribute", "/attribute_batch")


def make_http_server(artifact_dir, host: str = "127.0.0.1",
                     port: int = 0, dynamic_batch: bool = False,
                     batch_wait_ms: float = 5.0,
                     max_pending: int = 256,
                     batch_max_group: "int | None" = None,
                     device=None) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; ``.server_address`` holds
    the bound (host, port) — port 0 picks a free one.

    ``artifact_dir``: a path (single model) or an ``{name: path}`` dict —
    the multi-model registry. Bare endpoints (``/explain`` ...) hit the
    FIRST entry; every model additionally serves under ``/m/<name>/...``
    (same endpoints, plus ``/m/<name>/healthz``). All models share ONE
    :class:`DeviceThread` (one CUDA context per process), and ``/metrics`` keys by
    full request path, so per-model latency/error stats come for free.

    ``dynamic_batch`` coalesces concurrent BO ``/explain`` requests into
    one image-batched device call (continuous batching — see
    :class:`_DynamicBatcher`), shedding load with a 503 past
    ``max_pending`` queued requests; ``batch_max_group`` bounds the
    coalesced group size (latency-tail blast radius); in registry mode it
    applies to every fused-BO-capable model. ``device``: where the
    models run (None: the card, which raises without one)."""
    dirs = ({"default": artifact_dir} if isinstance(artifact_dir, str)
            else dict(artifact_dir))
    if not dirs:
        raise ValueError("artifact_dir registry is empty")
    device_thread = DeviceThread()
    services = {name: SaliencyService(d, device=device, device_thread=device_thread)
                for name, d in dirs.items()}
    default_name = next(iter(dirs))
    service = services[default_name]  # bare-endpoint target
    if dynamic_batch:
        bo_capable = [s for s in services.values() if s.bo_server is not None]
        if not bo_capable:
            raise ValueError("dynamic batching needs a fused-BO artifact")
        for s in bo_capable:
            s.enable_dynamic_batching(batch_wait_ms, max_pending,
                                      batch_max_group)
    metrics = ServiceMetrics()

    def _resolve(path):
        """-> (service, endpoint) — registry prefix ``/m/<name>`` stripped;
        (None, None) on unknown model or endpoint."""
        svc = service
        if path.startswith("/m/"):
            parts = path.split("/", 3)  # ['', 'm', name, endpoint...]
            if len(parts) != 4:
                return None, None
            svc = services.get(parts[2])
            if svc is None:
                return None, None
            path = "/" + parts[3]
        return svc, path

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send_raw(self, code: int, data: bytes):
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _send(self, code: int, payload: dict):
            self._send_raw(code, json.dumps(payload).encode())

        def _drain_body(self):
            """Consume the request body so a reply sent before the client
            finishes streaming doesn't RST the connection and eat it."""
            try:
                length = int(self.headers.get("Content-Length", 0))
                while length > 0:
                    chunk = self.rfile.read(min(length, 1 << 20))
                    if not chunk:
                        break
                    length -= len(chunk)
            except Exception:
                pass

        def do_GET(self):
            svc, ep = _resolve(self.path)
            if svc is not None and ep == "/healthz":
                out = svc.healthz()
                if len(services) > 1:
                    out["models"] = {n: s.kind for n, s in services.items()}
                self._send(200, out)
            elif self.path == "/metrics":
                # /metrics observes only real work (POST endpoints), not
                # itself or health probes.
                snap = metrics.snapshot()
                dev = service.device_call_stats()
                if dev.get("count"):
                    snap["device_call_ms"] = dev
                if service._batcher is not None:
                    snap["dynamic_batch"] = dict(service._batcher.stats)
                named = {n: dict(s._batcher.stats)
                         for n, s in services.items()
                         if s._batcher is not None and s is not service}
                if named:
                    snap["dynamic_batch_models"] = named
                self._send(200, snap)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            t0 = time.perf_counter()
            svc, ep = _resolve(self.path)
            # Endpoint paths ARE the SaliencyService method names
            # ("/explain" -> .explain) — _POST_ENDPOINTS pins the set.
            fn = (getattr(svc, ep[1:]) if svc is not None
                  and ep in _POST_ENDPOINTS else None)
            if fn is None:
                # Route miss is decided WITHOUT parsing the body, so unknown
                # paths never enter the metrics dict and arbitrary client
                # paths can't grow it unboundedly — but the body must still
                # be drained before answering.
                self._drain_body()
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                code, payload = 200, fn(body)
            except ServiceOverloadedError as e:
                # Load shed (dynamic-batch queue full): retryable, so 503
                # — distinct from client errors (400) and crashes (500).
                code, payload = 503, {"error": str(e)}
            except (ValueError, KeyError, TypeError, AttributeError) as e:
                # Malformed client input (wrong JSON shape, bad dtypes,
                # unknown SegmentConfig keys) is a 400, not a 500.
                code, payload = 400, {"error": str(e)}
            except Exception as e:  # surface, don't kill the server
                code, payload = 500, {"error": repr(e)}
            try:
                data = json.dumps(payload).encode()
            except Exception as e:
                # Serialize BEFORE observing so /metrics records the code the
                # client actually receives, not the pre-send intent.
                code, data = 500, json.dumps({"error": repr(e)}).encode()
            metrics.observe(self.path, code, time.perf_counter() - t0)
            try:
                self._send_raw(code, data)
            except Exception:
                pass  # client gone mid-write; nothing left to say

    class _Server(ThreadingHTTPServer):
        # Default listen backlog is 5; a burst of concurrent clients (load
        # tests fire 16+ simultaneous connects) overflows it and the kernel
        # drops the excess SYNs before the accept loop ever sees them — the
        # client stalls in retransmit (or sees RST only when
        # tcp_abort_on_overflow=1). Overload policy belongs to the app layer
        # (503 past --max-pending), so the socket layer must not shed first.
        request_queue_size = 128

    httpd = _Server((host, port), Handler)
    httpd.service = service  # default model, for tests/introspection
    httpd.services = services  # full registry ({name: SaliencyService})
    httpd.metrics = metrics
    return httpd
