"""The port's serving client (network_interpretation_imagenet_tpu_torch/
serving_client.py), its multi-model registry and the export CLI, on the
MNIST CNN on the CPU, against real port-0 servers.

The client is the JAX package's wire format in stdlib + numpy: each
package's client also talks to the other package's server, with equal
results. Responses are held exactly against the in-process server calls."""

import json
import os
import socket
import threading
from http.client import HTTPConnection

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import serving_mnist

from network_interpretation_imagenet_tpu import serving as jserving
from network_interpretation_imagenet_tpu import serving_client as jclient
from network_interpretation_imagenet_tpu import serving_http as jhttp
from network_interpretation_imagenet_tpu.models import create_model as jcreate_model
from network_interpretation_imagenet_tpu.saliency import SaliencyEngine as JaxEngine
from network_interpretation_imagenet_tpu_torch import serving
from network_interpretation_imagenet_tpu_torch.config import BOConfig
from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
from network_interpretation_imagenet_tpu_torch.serving_client import SaliencyClient, ServiceError
from network_interpretation_imagenet_tpu_torch.serving_http import make_http_server
from network_interpretation_imagenet_tpu_torch.utils import convert

BO_CFG = BOConfig(n_iters=3, n_pre_samples=2)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    bundle, state_dict, image, segments, firsts = serving_mnist()
    engine = SaliencyEngine(bundle, state_dict, mask_batch=16, compute_dtype=torch.float32,
                            device="cpu")
    root = tmp_path_factory.mktemp("client")
    dual = str(root / "dual")
    serving.export_engine(engine, dual, batch_sizes=(16,), knockout_m=2,
                          attribution=("gradient",), attribution_batches=(2,))
    serving.export_bo_engine(engine, dual, bo_cfg=BO_CFG, candidate_buckets=(16,),
                             image_batches=(4,), include_weights=False)
    return dict(bundle=bundle, state_dict=state_dict, engine=engine, image=image,
                segments=segments, firsts=firsts, root=root, dual=dual)


def _serve(artifacts, **kw):
    httpd = make_http_server(artifacts, "127.0.0.1", 0, device="cpu", **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture
def dual_server(case):
    httpd = _serve(case["dual"])
    try:
        yield httpd
    finally:
        _stop(httpd)


def test_client_round_trips_every_endpoint(case, dual_server):
    svc = dual_server.service
    client = SaliencyClient(*dual_server.server_address[:2])
    img, seg = case["image"], case["segments"]
    assert client.healthz()["status"] == "ok"
    out = client.explain(img, segments=seg, seed=3, target=2)
    want, tr = svc.bo_server.explain(img, seg, seed=3, target=2)
    assert out["heatmap"].dtype == np.float32 and out["xp"] == tr.xp.tolist()
    np.testing.assert_array_equal(out["heatmap"], want.heatmap)
    w = client.explain(img, segments=seg, mode="window", seed=1, num_samples=8)
    assert w["num_samples"] == 8 and w["heatmap"].shape == (28, 28)
    k = client.explain(img, segments=seg, mode="knockout", seed=1, num_samples=8,
                       num_knockout=2)
    assert k["num_knockout"] == 2
    res = client.explain_batch(np.stack([img, img[::-1]]), segments=np.stack([seg, seg]),
                               seeds=[3, 4], targets=[2, 2])
    assert res[0]["xp"] == out["xp"]
    np.testing.assert_allclose(res[0]["yp"], out["yp"], rtol=0, atol=1e-6)
    ev = client.eval_windows(img, seg, case["firsts"][:5], width=4, target=4)
    ref = svc.engine_server.eval_window_masks(img, seg, case["firsts"][:5], 4, 4)
    assert ev["preds"] == ref.preds.tolist() and ev["prob_target"] == ref.prob_target.tolist()
    kv = client.eval_knockouts(img, seg, np.zeros((5, 1), np.int32), target=4)
    assert len(kv["survived"]) == 5
    at = client.attribute(img, "gradient", target=2)
    np.testing.assert_array_equal(at["heatmap"], svc.engine_server.attribute(img, 2, "gradient"))
    ab = client.attribute_batch(np.stack([img, img]), "gradient", targets=[2, 3])
    assert [r["target"] for r in ab] == [2, 3] and ab[0]["heatmap"].shape == (28, 28)
    client.close()


def test_client_uint8_wire_matches_f32(case, dual_server):
    client = SaliencyClient(*dual_server.server_address[:2])
    seg = case["segments"]
    img_u8 = (case["image"] * 255).astype(np.uint8)
    a = client.explain(img_u8, segments=seg, seed=5, target=2)
    b = client.explain(img_u8.astype(np.float32) / 255.0, segments=seg, seed=5, target=2)
    np.testing.assert_array_equal(a["heatmap"], b["heatmap"])
    norm = {"mean": [0.5], "std": [0.25]}
    c = client.explain(img_u8, segments=seg, seed=5, target=2, normalize=norm)
    local = (img_u8.astype(np.float32) / 255.0 - np.float32(0.5)) / np.float32(0.25)
    d = client.explain(local, segments=seg, seed=5, target=2)
    np.testing.assert_array_equal(c["heatmap"], d["heatmap"])
    with pytest.raises(ValueError, match="uint8"):
        client.explain(local, segments=seg, normalize=norm)
    client.close()


def test_client_does_not_retry_4xx(dual_server):
    client = SaliencyClient(*dual_server.server_address[:2], retries=5, backoff_s=0.01)
    with pytest.raises(ServiceError) as ei:
        client.explain(np.zeros((4, 4, 1), np.float32), mode="nope")
    assert ei.value.status == 400
    assert client.metrics()["endpoints"]["/explain"]["count"] == 1
    client.close()


def test_client_dead_server_is_status_zero():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    client = SaliencyClient("127.0.0.1", port, retries=1, backoff_s=0.01, timeout_s=2)
    with pytest.raises(ServiceError) as ei:
        client.healthz()
    assert ei.value.status == 0 and ei.value.__cause__ is not None


def test_client_retries_503_until_accepted(case):
    """Against a dynamic-batch server that holds one pending explain, every
    concurrent client call gets through by 503 backoff-retry."""
    httpd = _serve(case["dual"], dynamic_batch=True, batch_wait_ms=300.0)
    httpd.service.enable_dynamic_batching(wait_ms=300.0, max_pending=1)
    outs, errs = [None] * 3, []
    try:
        host, port = httpd.server_address[:2]

        def fire(i):
            try:
                c = SaliencyClient(host, port, retries=8, backoff_s=0.2)
                outs[i] = c.explain(case["image"], segments=case["segments"], seed=1, target=2)
                c.close()
            except Exception as e:   # recorded, the test fails on it
                errs.append((i, e))

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        stats = dict(httpd.service._batcher.stats)
    finally:
        _stop(httpd)
    assert not errs, errs
    assert all(o is not None and o["xp"] == outs[0]["xp"] for o in outs)
    assert stats["rejected"] >= 1


def test_multi_model_registry(case):
    """Bare endpoints hit the first entry, /m/<name>/ routes per model,
    /healthz lists the registry, an unknown name is a 404 that stays out of
    /metrics, and the client's model= targets a named entry; the models
    share one device thread."""
    bo_dir = str(case["root"] / "bo_only")
    serving.export_bo_engine(case["engine"], bo_dir, bo_cfg=BO_CFG, candidate_buckets=(16,))
    httpd = _serve({"dual": case["dual"], "bo": bo_dir})
    try:
        host, port = httpd.server_address[:2]
        assert httpd.services["dual"]._device_thread is httpd.services["bo"]._device_thread
        health = SaliencyClient(host, port).healthz()
        assert health["models"] == {"dual": "bo+engine", "bo": "bo"}
        named = SaliencyClient(host, port, model="bo")
        assert named.healthz()["kind"] == "bo"
        a = named.explain(case["image"], segments=case["segments"], seed=2, target=2)
        b = SaliencyClient(host, port).explain(case["image"], segments=case["segments"],
                                               seed=2, target=2)
        assert a["xp"] == b["xp"]
        with pytest.raises(ServiceError) as ei:
            named.explain(case["image"], segments=case["segments"], mode="window")
        assert ei.value.status == 400 and "needs an engine artifact" in str(ei.value)
        conn = HTTPConnection(host, port)
        conn.request("POST", "/m/nope/explain", json.dumps({}))
        assert conn.getresponse().status == 404
        conn.close()
        snap = SaliencyClient(host, port).metrics()
        assert "/m/bo/explain" in snap["endpoints"] and "/m/nope/explain" not in snap["endpoints"]
    finally:
        _stop(httpd)


def test_serve_cli_rejects_malformed_registry_specs():
    from network_interpretation_imagenet_tpu_torch.cli import serve

    with pytest.raises(SystemExit):
        serve.main(["--artifact", "resnet=", "--port", "0"])
    with pytest.raises(SystemExit):
        serve.main(["--artifact", "m=a", "--artifact", "m=b", "--port", "0"])


def test_each_packages_client_speaks_the_other_packages_server(case, tmp_path):
    """The port's client against the JAX package's server, and the JAX
    package's client against the port's, on one JAX-written artifact: the
    same window explanations and evaluations."""
    jengine = JaxEngine(jcreate_model("mnist_cnn", "mnist"),
                        convert.jax_variables(case["state_dict"], case["bundle"].module),
                        mask_batch=16, compute_dtype=jnp.float32)
    path = str(tmp_path / "jax")
    jserving.export_engine(jengine, path, batch_sizes=(16,))
    jhttpd = jhttp.make_http_server(path, "127.0.0.1", 0)
    threading.Thread(target=jhttpd.serve_forever, daemon=True).start()
    httpd = _serve(path)
    try:
        ours = SaliencyClient(*jhttpd.server_address[:2])
        theirs = jclient.SaliencyClient(*httpd.server_address[:2])
        img, seg = case["image"], case["segments"]
        a = ours.explain(img, segments=seg, mode="window", seed=4, num_samples=24, target=4)
        b = theirs.explain(img, segments=seg, mode="window", seed=4, num_samples=24, target=4)
        np.testing.assert_array_equal(a.pop("heatmap"), b.pop("heatmap"))
        assert a == b and 0 < a["survival"] < 1
        ea = ours.eval_windows(img, seg, case["firsts"][:16], 4, 4)
        eb = theirs.eval_windows(img, seg, case["firsts"][:16], 4, 4)
        assert ea["preds"] == eb["preds"] and ea["survived"] == eb["survived"]
        np.testing.assert_allclose(ea["prob_target"], eb["prob_target"], rtol=0, atol=1e-5)
    finally:
        _stop(jhttpd)
        _stop(httpd)


def test_export_serving_cli_writes_a_servable_artifact(case, tmp_path):
    """cli.export_serving with --ckpt (a weights artifact), --knockout-m,
    --attribution and --bo, on the CPU; the artifact serves its weights."""
    from network_interpretation_imagenet_tpu_torch.cli import export_serving

    ckpt = str(tmp_path / "w")
    convert.save_weights_artifact(convert.jax_variables(case["state_dict"],
                                                        case["bundle"].module), ckpt,
                                  meta={"arch": "mnist_cnn"})
    out = str(tmp_path / "art")
    args = ["--arch", "mnist_cnn", "--dataset", "mnist", "--dtype", "float32", "--device", "cpu",
            "--ckpt", ckpt, "--out", out, "--batch-sizes", "16,4", "--knockout-m", "1",
            "--attribution", "gradient,integrated", "--ig-steps", "4", "--bo",
            "--candidate-buckets", "16", "--bo-image-batches", "2", "--n_iters", "2",
            "--n_pre_samples", "2"]
    assert export_serving.main(args) == 0
    with open(os.path.join(out, "export_result.json")) as f:
        result = json.load(f)
    assert result["bo"]["n_iters"] == 2 and result["attribution"]["config"]["ig_steps"] == 4
    srv = serving.load_exported(out, device="cpu")
    assert all(torch.equal(srv.variables[k], v) for k, v in case["state_dict"].items()
               if not k.endswith("num_batches_tracked"))
    assert srv.buckets == [16, 4] and srv.knockout_m == 1
    bo = serving.load_exported_bo(out, device="cpu")
    assert bo.buckets == [16] and sorted(bo.runners) == [(1, 16), (2, 16)]
    with pytest.raises(SystemExit):
        export_serving.main(["--bo-image-batches", "2", "--device", "cpu", "--out", out])
