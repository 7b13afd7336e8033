"""The port's HTTP service (network_interpretation_imagenet_tpu_torch/
serving_http.py) against the JAX package's, on the MNIST CNN on the CPU.

The same request bodies go to the JAX package's ``SaliencyService`` and the
port's, both serving one JAX-written artifact: window and knockout
explanations (host-sampled starts and knockouts, the same numpy samplers in
both) give equal targets, survival and heatmaps, the raw evaluation
endpoints equal predictions and survive labels (probabilities within
1e-5), and malformed requests the same error messages; over real sockets
the status codes are 400, 404 and, from a full dynamic batcher, 503. BO
requests coalesced by the dynamic batcher equal their single calls (traces
and heatmaps exactly, scores within 1e-6)."""

import base64
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from http.client import HTTPConnection

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import serving_mnist

from network_interpretation_imagenet_tpu import serving as jserving
from network_interpretation_imagenet_tpu import serving_http as jhttp
from network_interpretation_imagenet_tpu.models import create_model as jcreate_model
from network_interpretation_imagenet_tpu.saliency import SaliencyEngine as JaxEngine
from network_interpretation_imagenet_tpu_torch import serving, serving_http
from network_interpretation_imagenet_tpu_torch.config import BOConfig
from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
from network_interpretation_imagenet_tpu_torch.utils.convert import jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = 4


def _b64(arr):
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def _post(conn, path, body):
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, json.loads(r.read())


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A JAX-written engine artifact (buckets 16 and 4, knockout_m 2, a
    gradient program) and a port-written one holding both kinds (BO at
    candidate bucket 16, image batch 4), same weights."""
    bundle, state_dict, image, segments, firsts = serving_mnist()
    engine = SaliencyEngine(bundle, state_dict, mask_batch=16, compute_dtype=torch.float32,
                            device="cpu")
    jengine = JaxEngine(jcreate_model("mnist_cnn", "mnist"),
                        jax_variables(state_dict, bundle.module), mask_batch=16,
                        compute_dtype=jnp.float32)
    root = tmp_path_factory.mktemp("http")
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    jserving.export_engine(jengine, jax_dir, batch_sizes=(16, 4), knockout_m=2,
                           attribution=("gradient",))
    serving.export_engine(engine, port_dir, batch_sizes=(16, 4), knockout_m=2,
                          attribution=("gradient", "integrated", "xrai"),
                          attribution_cfg={"ig_steps": 4}, attribution_batches=(2,))
    serving.export_bo_engine(engine, port_dir, bo_cfg=BOConfig(n_iters=3, n_pre_samples=2),
                             candidate_buckets=(16,), image_batches=(4,), include_weights=False)
    return dict(image=image, segments=segments, firsts=firsts[:21], jax_dir=jax_dir,
                port_dir=port_dir, root=root,
                jservice=jhttp.SaliencyService(jax_dir),
                service=serving_http.SaliencyService(jax_dir, device="cpu"))


def _image_fields(case):
    return {"image_b64": _b64(case["image"]), "image_shape": [28, 28, 1]}


def _segment_fields(case):
    return {"segments_b64": _b64(case["segments"]), "segments_shape": [28, 28]}


@pytest.mark.parametrize("extra", [
    {"mode": "window", "num_samples": 40, "seed": 1, "target": TARGET, "given_segments": 1},
    {"mode": "window", "num_samples": 21, "seed": 2, "window_fraction": 0.25},
    {"mode": "knockout", "num_samples": 40, "num_knockout": 2, "seed": 3, "target": TARGET,
     "given_segments": 1},
    {"mode": "knockout", "num_samples": 20, "seed": 4, "json_arrays": True},
])
def test_explain_matches_the_jax_service(case, extra):
    """Window and knockout /explain: the same body gives the same target,
    segment count, survival and heatmap in both services (segments given,
    or Felzenszwalb on the server; targets given or inferred)."""
    body = {**_image_fields(case), **{k: v for k, v in extra.items() if k != "given_segments"}}
    if extra.get("given_segments"):
        body.update(_segment_fields(case))
    got, want = case["service"].explain(dict(body)), case["jservice"].explain(dict(body))
    assert got == want
    if "target" in extra:
        assert 0.0 < got["survival"] < 1.0, "all masks alike: a weak test"


def test_eval_endpoints_match_the_jax_service(case):
    body = {**_image_fields(case), **_segment_fields(case),
            "firsts_b64": _b64(case["firsts"]), "firsts_shape": [21], "width": 4,
            "target": TARGET}
    ids = np.stack([case["firsts"] % 16, (case["firsts"] + 3) % 16], 1).astype(np.int32)
    ko_body = {**_image_fields(case), **_segment_fields(case), "knock_ids_b64": _b64(ids[:, :1]),
               "knock_ids_shape": [21, 1], "target": TARGET}
    for fn in ("eval_windows", "eval_knockouts"):
        b = body if fn == "eval_windows" else ko_body
        got, want = getattr(case["service"], fn)(b), getattr(case["jservice"], fn)(b)
        assert got["preds"] == want["preds"] and got["survived"] == want["survived"]
        assert 0 < sum(got["survived"]) < 21
        for key in ("prob_target", "prob_max"):
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5)


# (endpoint, body, whether the test image and segments are added)
BAD_BODIES = [
    ("explain", {"mode": "bogus"}, True),
    ("explain", {}, False),
    ("explain", {"mode": "bo"}, True),
    ("explain_batch", {}, False),
    ("eval_windows", {"width": 2, "target": 0}, False),
    ("eval_windows", {"width": 2, "target": 0}, True),
    ("eval_knockouts", {"knock_ids": [[1, 2, 3]], "target": 0}, True),
    ("attribute", {}, False),
    ("attribute", {"method": "rise"}, False),
    ("attribute_batch", {"method": "gradient"}, False),
    ("explain", {"normalize": {"mean": [0.5], "std": [0.5]}}, True),
    ("explain", {"image_jpeg_b64": _b64(np.zeros(8, np.uint8))}, False),
]


@pytest.mark.parametrize("endpoint,body,with_image", BAD_BODIES)
def test_error_messages_are_the_jax_services(case, endpoint, body, with_image):
    if with_image:
        body = {**_image_fields(case), **_segment_fields(case), **body}
    with pytest.raises(ValueError) as want:
        getattr(case["jservice"], endpoint)(dict(body))
    with pytest.raises(ValueError) as got:
        getattr(case["service"], endpoint)(dict(body))
    def text(e):   # PIL's messages name an object's address
        return re.sub(r"0x[0-9a-f]+", "0x", str(e.value))

    assert text(got) == text(want)


@pytest.fixture
def http(case):
    """The port's HTTP server on port 0 over the two-kind port artifact."""
    httpd = serving_http.make_http_server(case["port_dir"], "127.0.0.1", 0, device="cpu")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield httpd
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_http_status_codes(case, http):
    conn = HTTPConnection(*http.server_address[:2])
    status, resp = _post(conn, "/explain", {"mode": "bogus", **_image_fields(case)})
    assert status == 400 and "unknown mode 'bogus'" in resp["error"]
    status, _ = _post(conn, "/explain", {"mode": "window", "image": [[[0.0]]]})
    assert status == 400    # the artifact's 28x28x1 shape is checked
    for path in ("/nope", "/m/nope/explain"):
        status, resp = _post(conn, path, {})
        assert status == 404 and "unknown path" in resp["error"]
    conn.request("GET", "/healthz")
    health = json.loads(conn.getresponse().read())
    assert health["kind"] == "bo+engine" and health["manifest"]["export_platform"] == "cpu"
    conn.request("GET", "/metrics")
    snap = json.loads(conn.getresponse().read())
    assert snap["endpoints"]["/explain"]["errors_4xx"] == 2
    assert "/nope" not in snap["endpoints"]
    conn.close()


def test_device_calls_run_on_one_device_thread(case, http):
    """Every request's device work runs on the service's one DeviceThread,
    never on the per-request handler threads."""
    svc = http.service
    seen = []
    for server, name in ((svc.engine_server, "eval_window_masks"),
                         (svc.bo_server, "explain")):
        real = getattr(server, name)

        def spy(*a, real=real, **k):
            seen.append(threading.get_ident())
            return real(*a, **k)

        setattr(server, name, spy)
    conn = HTTPConnection(*http.server_address[:2])
    body = {**_image_fields(case), **_segment_fields(case), "target": 2}
    for extra in ({"mode": "window", "num_samples": 8}, {"mode": "bo"}, {"mode": "window"}):
        status, _ = _post(conn, "/explain", {**body, **extra})
        assert status == 200
    conn.close()
    assert len(seen) == 3 and len(set(seen)) == 1 and seen[0] != threading.get_ident()
    assert svc._device_thread.run(threading.get_ident) == seen[0]


def test_device_thread_reports_busy_while_a_call_runs():
    """The dynamic batcher's idle check: busy from submission to return."""
    worker = serving_http.DeviceThread()
    started, release = threading.Event(), threading.Event()
    t = threading.Thread(target=worker.run,
                         args=(lambda: (started.set(), release.wait(10)),))
    assert not worker.busy()
    t.start()
    assert started.wait(10) and worker.busy()
    release.set()
    t.join(10)
    assert not worker.busy()


def test_one_engine_serves_both_artifact_kinds(case, http, tmp_path):
    """A directory holding both manifests of one model loads one engine for
    both servers; a BO manifest of another compute dtype keeps its own."""
    svc = http.service
    assert svc.bo_server.engine is svc.engine_server.engine
    other = tmp_path / "other"
    other.mkdir()
    for name in os.listdir(case["port_dir"]):
        (other / name).write_bytes(open(os.path.join(case["port_dir"], name), "rb").read())
    bo_manifest = json.loads((other / serving.BO_MANIFEST).read_text())
    bo_manifest["compute_dtype"] = "bfloat16"
    (other / serving.BO_MANIFEST).write_text(json.dumps(bo_manifest))
    two = serving_http.SaliencyService(str(other), device="cpu")
    assert two.bo_server.engine is not two.engine_server.engine
    assert two.bo_server.engine.compute_dtype == torch.bfloat16
    assert two.engine_server.engine.compute_dtype == torch.float32


def test_http_bo_batch_and_attribution_endpoints(case, http):
    """/explain (bo), /explain_batch, /attribute (gradient, xrai) and
    /attribute_batch over HTTP equal the servers' own calls."""
    svc = http.service
    conn = HTTPConnection(*http.server_address[:2])
    body = {**_image_fields(case), **_segment_fields(case), "seed": 3, "target": 2}
    status, resp = _post(conn, "/explain", body)
    out, tr = svc.bo_server.explain(case["image"], case["segments"], seed=3, target=2)
    assert status == 200 and resp["xp"] == tr.xp.tolist()
    heat = np.frombuffer(base64.b64decode(resp["heatmap_b64"]), np.float32).reshape(28, 28)
    np.testing.assert_array_equal(heat, out.heatmap)
    images = np.stack([case["image"], case["image"][::-1], case["image"] * 0.5])
    status, resp = _post(conn, "/explain_batch", {
        "images_b64": _b64(images), "images_shape": list(images.shape),
        "segments_b64": _b64(np.stack([case["segments"]] * 3)), "segments_shape": [3, 28, 28],
        "seed": 5, "targets": [2, 2, 2]})
    many, calls = svc.bo_server.explain_many(images, [case["segments"]] * 3,
                                             per_image_seeds=[5, 6, 7], targets=[2, 2, 2])
    assert status == 200 and calls == 1
    assert [r["xp"] for r in resp["results"]] == [t.xp.tolist() for _, t in many]
    status, resp = _post(conn, "/attribute", {**_image_fields(case), "method": "gradient",
                                              "target": TARGET})
    want = svc.engine_server.attribute(case["image"], TARGET, "gradient")
    assert status == 200 and resp["heatmap_b64"] == _b64(want)
    status, resp = _post(conn, "/attribute", {**_image_fields(case), "method": "xrai"})
    assert status == 200 and resp["num_regions"] > 0 and "attribution_b64" in resp
    assert resp["xrai"]["scales"] == svc.engine_server.xrai_config["scales"]
    status, resp = _post(conn, "/attribute_batch", {
        "images_b64": _b64(images[:2]), "images_shape": [2, 28, 28, 1],
        "method": "integrated", "targets": [TARGET, 2]})
    heats, calls = svc.engine_server.attribute_many(images[:2], [TARGET, 2], "integrated",
                                                    seeds=[0, 1])
    assert status == 200 and calls == 1
    assert [r["heatmap_b64"] for r in resp["results"]] == [_b64(h) for h in heats]
    conn.close()


def _bo_server(case, **kw):
    httpd = serving_http.make_http_server(case["port_dir"], "127.0.0.1", 0, dynamic_batch=True,
                                          device="cpu", **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _fire(host, port, bodies):
    out, errs = [None] * len(bodies), []

    def one(i):
        try:
            conn = HTTPConnection(host, port, timeout=120)
            out[i] = _post(conn, "/explain", bodies[i])
            conn.close()
        except Exception as e:   # recorded, the test fails on it
            errs.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errs, errs
    return out


def test_http_dynamic_batching_coalesces_and_matches(case):
    """Four concurrent BO /explain requests on an idle server coalesce
    (the collection window); each answer is its own single explain."""
    httpd = _bo_server(case, batch_wait_ms=300.0)
    try:
        images = [case["image"], case["image"][::-1].copy(), case["image"] * 0.5,
                  case["image"][:, ::-1].copy()]
        bodies = [{"image_b64": _b64(im), "image_shape": [28, 28, 1], **_segment_fields(case),
                   "seed": 10 + i, "target": 2} for i, im in enumerate(images)]
        out = _fire(*httpd.server_address[:2], bodies)
        stats = dict(httpd.service._batcher.stats)
        bo = httpd.service.bo_server
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert all(status == 200 for status, _ in out)
    assert stats["requests"] == 4 and stats["max_group"] >= 2
    assert stats["device_calls"] < 4
    for i, (_, resp) in enumerate(out):
        one, tr = bo.explain(images[i], case["segments"], seed=10 + i, target=2)
        assert resp["xp"] == tr.xp.tolist()
        np.testing.assert_allclose(resp["yp"], tr.yp, rtol=0, atol=1e-6)
        heat = np.frombuffer(base64.b64decode(resp["heatmap_b64"]), np.float32).reshape(28, 28)
        np.testing.assert_array_equal(heat, one.heatmap)


def test_http_full_batcher_sheds_load_with_503(case):
    httpd = _bo_server(case, batch_wait_ms=800.0)
    httpd.service.enable_dynamic_batching(wait_ms=800.0, max_pending=1)
    try:
        body = {**_image_fields(case), **_segment_fields(case), "seed": 1, "target": 2}
        out = _fire(*httpd.server_address[:2], [body] * 3)
        conn = HTTPConnection(*httpd.server_address[:2])
        conn.request("GET", "/metrics")
        snap = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
    codes = sorted(s for s, _ in out)
    assert codes.count(200) >= 1 and codes.count(503) >= 1
    assert codes.count(200) + codes.count(503) == 3
    assert all("queue full" in r["error"] for s, r in out if s == 503)
    assert snap["dynamic_batch"]["rejected"] >= 1 and snap["device_call_ms"]["count"] >= 1
    assert snap["endpoints"]["/explain"]["errors_5xx"] >= 1


def test_wire_helpers_match_jax():
    """Array and image decoding (lists, f32 and u8 base64 with normalize,
    JPEG through the eval transform) and encoding equal the JAX package's."""
    from PIL import Image

    rng = np.random.RandomState(0)
    img = (rng.rand(40, 48, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    jpeg = base64.b64encode(buf.getvalue()).decode()
    arr = rng.rand(5, 4, 3).astype(np.float32)
    bodies = [
        {"image": arr.tolist()},
        {"image_b64": _b64(arr), "image_shape": [5, 4, 3]},
        {"image_u8_b64": _b64(img), "image_shape": [40, 48, 3],
         "normalize": {"mean": [0.5, 0.4, 0.3], "std": [0.2, 0.3, 0.4]}},
        {"image_jpeg_b64": jpeg, "preprocess": {"crop": 32}},
        {"image_jpeg_b64": [jpeg, jpeg]},
    ]
    for body in bodies:
        got = serving_http._decode_image(body, "image")
        want = jhttp._decode_image(body, "image")
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert serving_http._encode_array(arr) == jhttp._encode_array(arr)
    seg = {"segments": [[1, 2], [3, 4]]}
    assert np.array_equal(serving_http._decode_array(seg, "segments", np.int32),
                          jhttp._decode_array(seg, "segments", np.int32))
    display = (rng.rand(28, 28, 1)).astype(np.float32)
    assert np.array_equal(serving_http._segment_for({}, display),
                          jhttp._segment_for({}, display))


def test_serve_cli_sigterm_drains_cleanly(case):
    """cli.serve --device cpu: prints its URL, answers, and on SIGTERM
    drains an in-flight request before exiting 0."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "network_interpretation_imagenet_tpu_torch.cli.serve",
         "--artifact", case["port_dir"], "--port", "0", "--device", "cpu", "--warmup"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    result = {}
    try:
        port, deadline = None, time.time() + 120
        while port is None and time.time() < deadline:
            m = re.search(r"http://[^:]+:(\d+)", proc.stdout.readline() or "")
            port = int(m.group(1)) if m else None
        assert port, "serve CLI never printed its bound port"
        body = {**_image_fields(case), **_segment_fields(case), "mode": "window",
                "num_samples": 400, "seed": 1}

        def fire():
            conn = HTTPConnection("127.0.0.1", port, timeout=120)
            result["resp"] = _post(conn, "/explain", body)
            conn.close()

        t = threading.Thread(target=fire)
        t.start()
        time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
        t.join(timeout=120)
        assert proc.returncode == 0, out
        assert "draining" in out
        status, resp = result["resp"]
        assert status == 200, resp
    finally:
        if proc.poll() is None:
            proc.kill()


def test_serve_cli_defaults_to_the_card(case, monkeypatch):
    from network_interpretation_imagenet_tpu_torch.cli import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--artifact", case["port_dir"], "--port", "0"])
