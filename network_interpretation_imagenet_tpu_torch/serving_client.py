"""First-party Python client for the HTTP explanation service (port of
``serving_client.py`` of the JAX package, stdlib + numpy only).

``cli.serve`` hosts an artifact, and this client (``http.client`` + base64)
speaks its wire format (``serving_http`` documents it), so callers never
hand-roll the encoding. Responses round-trip through the same base64
little-endian raw arrays.

Features:

* Arrays in/out as numpy — images/segments are encoded to the compact
  ``*_b64`` + ``*_shape`` form; ``heatmap_b64`` responses are decoded back
  to float32 arrays.
* Retry with exponential backoff on **503** (the dynamic batcher's
  load-shed signal) and on transient socket errors; 4xx raises
  immediately (client bugs don't deserve retries).
* Connection reuse per client instance; thread-safe (one connection per
  thread — ``http.client`` connections are not concurrency-safe).

Example::

    client = SaliencyClient("127.0.0.1", 8000)
    client.healthz()["status"]                      # "ok"
    res = client.explain(img, segments=seg, seed=3) # res["heatmap"]: f32[H,W]
    batch = client.explain_batch(imgs, seeds=[1, 2, 3])
"""

from __future__ import annotations

import base64
import json
import threading
import time
from typing import Optional, Sequence

import numpy as np


class ServiceError(RuntimeError):
    """Non-retryable service response (4xx) or exhausted retries.

    ``status``: the HTTP code; **503** after retries means the server kept
    shedding load, **0** means no HTTP response was ever received
    (connection refused / timeout / reset — a dead server, not an
    overloaded one; the transport exception rides ``__cause__``)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


def _b64(arr: np.ndarray, dtype) -> str:
    a = np.ascontiguousarray(np.asarray(arr, dtype))
    return base64.b64encode(a.astype(a.dtype.newbyteorder("<")).tobytes()
                            ).decode("ascii")


def _array_fields(key: str, arr: np.ndarray, dtype) -> dict:
    """The wire's ``{key}_b64`` + ``{key}_shape`` pair for one array."""
    arr = np.asarray(arr, dtype)
    return {f"{key}_b64": _b64(arr, dtype), f"{key}_shape": list(arr.shape)}


def _decode_heatmap(item: dict, key: str = "heatmap") -> None:
    """Replace ``{key}_b64``/``{key}_shape`` with a float32 array in-place."""
    if f"{key}_b64" in item:
        raw = base64.b64decode(item.pop(f"{key}_b64"))
        shape = item.pop(f"{key}_shape")
        item[key] = np.frombuffer(
            raw, dtype=np.dtype(np.float32).newbyteorder("<")
        ).reshape(shape).copy()


class SaliencyClient:
    """Stdlib HTTP client for ``cli.serve`` endpoints.

    ``retries``/``backoff_s``: how many times to retry a 503 (load shed)
    or transient connection error, sleeping ``backoff_s * 2**attempt``
    between tries. ``timeout_s`` is per-request (device calls can be slow
    on a cold artifact — warm the server with ``cli.serve --warmup``).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 timeout_s: float = 600.0, retries: int = 4,
                 backoff_s: float = 0.25, model: Optional[str] = None):
        """``model``: a registry name when the server hosts several
        artifacts (``cli.serve --artifact name=dir ...``) — requests then
        go to ``/m/<model>/...``; None hits the bare (default) model."""
        self._host, self._port = host, int(port)
        self._timeout = float(timeout_s)
        self._retries = int(retries)
        self._backoff = float(backoff_s)
        self._prefix = f"/m/{model}" if model else ""
        self._local = threading.local()

    # -- transport ------------------------------------------------------------

    def _conn(self):
        import http.client

        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(
                self._host, self._port, timeout=self._timeout)
            self._local.conn = conn
        return conn

    def _drop_conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass
            self._local.conn = None

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> dict:
        if path != "/metrics":  # metrics are server-global, not per-model
            path = self._prefix + path
        payload = None if body is None else json.dumps(body)
        last: Optional[Exception] = None
        for attempt in range(self._retries + 1):
            err: Optional[Exception] = None
            r = data = None
            try:
                conn = self._conn()
                conn.request(method, path, payload,
                             {"Content-Type": "application/json"}
                             if payload is not None else {})
                r = conn.getresponse()
                data = r.read()
            except Exception as e:  # transient socket/HTTP state error
                err = e
                self._drop_conn()
            if err is None:
                if r.status == 503:
                    # Load shed (dynamic-batch queue full): retryable.
                    err = ServiceError(503, data.decode(errors="replace"))
                elif r.status >= 400:
                    try:
                        msg = json.loads(data).get("error", "")
                    except Exception:
                        msg = data.decode(errors="replace")
                    raise ServiceError(r.status, msg)  # no retry on 4xx/5xx
                else:
                    return json.loads(data)
            last = err
            if attempt < self._retries:
                time.sleep(self._backoff * (2 ** attempt))
        if isinstance(last, ServiceError):
            raise ServiceError(503, f"retries exhausted: {last}") from last
        # Transport failure (refused/timeout/reset): status 0 = "no HTTP
        # response ever received" so callers don't misread a dead server
        # as load shedding.
        raise ServiceError(
            0, f"retries exhausted, no HTTP response: {last!r}") from last

    def close(self) -> None:
        self._drop_conn()

    # -- endpoints ------------------------------------------------------------

    def healthz(self) -> dict:
        return self._request("GET", "/healthz")

    def metrics(self) -> dict:
        return self._request("GET", "/metrics")

    @staticmethod
    def _image_fields(image, key: str, normalize,
                      preprocess=None) -> dict:
        """JPEG ``bytes`` (or a list of them for the batch key) ship
        untouched — the server runs the bit-exact eval transform, tuned by
        ``preprocess={"crop", "mean", "std"}``; uint8 arrays ride the
        4×-smaller u8 wire (server scales /255 and applies
        ``normalize={"mean": ..., "std": ...}``); anything else is sent as
        f32, already preprocessed."""
        is_jpeg = isinstance(image, (bytes, bytearray)) or (
            isinstance(image, (list, tuple)) and image
            and isinstance(image[0], (bytes, bytearray)))
        if is_jpeg:
            if normalize is not None:
                raise ValueError("JPEG images take preprocess=, not "
                                 "normalize=")
            enc = (base64.b64encode(bytes(image)).decode("ascii")
                   if isinstance(image, (bytes, bytearray)) else
                   [base64.b64encode(bytes(b)).decode("ascii")
                    for b in image])
            out = {f"{key}_jpeg_b64": enc}
            if preprocess is not None:
                out["preprocess"] = preprocess
            return out
        if preprocess is not None:
            raise ValueError("preprocess= applies to JPEG bytes only; "
                             "arrays use normalize= (u8) or arrive "
                             "preprocessed (f32)")
        image = np.asarray(image)
        if image.dtype == np.uint8:
            out = {f"{key}_u8_b64": _b64(image, np.uint8),
                   f"{key}_shape": list(image.shape)}
            if normalize is not None:
                out["normalize"] = {
                    "mean": np.asarray(normalize["mean"], np.float32).tolist(),
                    "std": np.asarray(normalize["std"], np.float32).tolist(),
                }
            return out
        if normalize is not None:
            raise ValueError("normalize= applies to uint8 images only; "
                             "float images must arrive preprocessed")
        return _array_fields(key, image, np.float32)

    def explain(self, image, segments: Optional[np.ndarray] = None,
                mode: Optional[str] = None, seed: int = 0,
                target: Optional[int] = None, window_fraction: float = 0.4,
                normalize: Optional[dict] = None,
                preprocess: Optional[dict] = None, **extra) -> dict:
        """One image → explanation dict with ``heatmap`` as float32[H, W].

        ``image``: preprocessed f32 array, uint8 array (raw-byte wire,
        ``normalize`` applies mean/std server-side after the /255), or
        JPEG ``bytes`` (server runs the full eval transform, tuned by
        ``preprocess={"crop", "mean", "std"}``). ``segments=None`` lets
        the server segment (Felzenszwalb reference defaults, or pass
        ``segment={...}`` through ``extra``)."""
        body = {"seed": int(seed), "window_fraction": float(window_fraction)}
        body.update(self._image_fields(image, "image", normalize, preprocess))
        if segments is not None:
            body.update(_array_fields("segments", segments, np.int32))
        if mode is not None:
            body["mode"] = mode
        if target is not None:
            body["target"] = int(target)
        body.update(extra)
        out = self._request("POST", "/explain", body)
        _decode_heatmap(out)
        return out

    def explain_batch(self, images,
                      segments: Optional[np.ndarray] = None,
                      seeds: Optional[Sequence[int]] = None,
                      targets: Optional[Sequence[int]] = None,
                      seed: int = 0, window_fraction: float = 0.4,
                      normalize: Optional[dict] = None,
                      preprocess: Optional[dict] = None, **extra) -> list:
        """N images → list of explanation dicts (BO artifacts only).
        ``images``: [N,H,W,C] array or a list of JPEG ``bytes``."""
        if not (isinstance(images, (list, tuple)) and images
                and isinstance(images[0], (bytes, bytearray))):
            images = np.asarray(images)
            if images.ndim != 4:
                raise ValueError(
                    f"images must be [N,H,W,C], got {images.shape}")
        body = {"seed": int(seed), "window_fraction": float(window_fraction)}
        body.update(self._image_fields(images, "images", normalize,
                                       preprocess))
        if segments is not None:
            body.update(_array_fields("segments", segments, np.int32))
        if seeds is not None:
            body["seeds"] = [int(s) for s in seeds]
        if targets is not None:
            body["targets"] = [int(t) for t in targets]
        body.update(extra)
        out = self._request("POST", "/explain_batch", body)
        for item in out["results"]:
            _decode_heatmap(item)
        return out["results"]

    def eval_windows(self, image: np.ndarray, segments: np.ndarray,
                     firsts: np.ndarray, width: int, target: int) -> dict:
        """Raw per-mask survive/prob arrays (engine artifacts)."""
        return self._request("POST", "/eval_windows", {
            **_array_fields("image", image, np.float32),
            **_array_fields("segments", segments, np.int32),
            **_array_fields("firsts", firsts, np.int32),
            "width": int(width), "target": int(target),
        })

    def eval_knockouts(self, image: np.ndarray, segments: np.ndarray,
                       knock_ids: np.ndarray, target: int) -> dict:
        """Knockout twin of :meth:`eval_windows` (knockout_m artifacts)."""
        return self._request("POST", "/eval_knockouts", {
            **_array_fields("image", image, np.float32),
            **_array_fields("segments", segments, np.int32),
            **_array_fields("knock_ids", knock_ids, np.int32),
            "target": int(target),
        })

    def attribute(self, image, method: str, target: Optional[int] = None,
                  seed: int = 0, normalize: Optional[dict] = None,
                  preprocess: Optional[dict] = None,
                  display: Optional[np.ndarray] = None, **extra) -> dict:
        """Per-image attribution from the artifact's AOT programs
        (artifacts exported with ``--attribution``). Returns a dict with
        ``heatmap`` float32[H, W]; ``target=None`` lets the server infer
        it. Image wire formats match :meth:`explain` (f32 / uint8 / JPEG
        bytes). For ``method="xrai"`` pass ``display`` (uint8 [H, W, C],
        the image the server's felzenszwalb ladder segments — else the
        server min-max derives one); the result additionally carries
        ``num_regions`` and the signed ``attribution`` array."""
        body = {"method": str(method), "seed": int(seed)}
        body.update(self._image_fields(image, "image", normalize, preprocess))
        if target is not None:
            body["target"] = int(target)
        if display is not None:
            body.update(_array_fields("display", display, np.uint8))
        body.update(extra)
        out = self._request("POST", "/attribute", body)
        _decode_heatmap(out)
        _decode_heatmap(out, "attribution")
        return out

    def attribute_batch(self, images, method: str,
                        targets: Optional[Sequence[int]] = None,
                        seeds: Optional[Sequence[int]] = None,
                        seed: int = 0, normalize: Optional[dict] = None,
                        preprocess: Optional[dict] = None, **extra) -> list:
        """N images' attribution maps (artifacts exported with
        ``--attribution``; ONE device call when exported with
        ``--attribution-batches``). ``images``: [N,H,W,C] array or a list
        of JPEG ``bytes``. Returns a list of dicts with ``heatmap``
        float32[H, W]."""
        if not (isinstance(images, (list, tuple)) and images
                and isinstance(images[0], (bytes, bytearray))):
            images = np.asarray(images)
            if images.ndim != 4:
                raise ValueError(
                    f"images must be [N,H,W,C], got {images.shape}")
        body = {"method": str(method), "seed": int(seed)}
        body.update(self._image_fields(images, "images", normalize,
                                       preprocess))
        if targets is not None:
            body["targets"] = [int(t) for t in targets]
        if seeds is not None:
            body["seeds"] = [int(x) for x in seeds]
        body.update(extra)
        out = self._request("POST", "/attribute_batch", body)
        for item in out["results"]:
            _decode_heatmap(item)
        return out["results"]
