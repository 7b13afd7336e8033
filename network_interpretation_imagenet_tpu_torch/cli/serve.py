"""Serve a saliency artifact over HTTP (stdlib HTTP; port of
``cli/serve.py`` of the JAX package).

Export once with ``cli.export_serving [--bo]``, then::

    python -m network_interpretation_imagenet_tpu_torch.cli.serve \
        --artifact ./artifact --port 8000 --warmup

    curl localhost:8000/healthz
    curl -X POST localhost:8000/explain -d '{"image": [[[...]]]}'

Endpoints and the array wire format are documented in
``network_interpretation_imagenet_tpu_torch.serving_http``. The models run
on the card (``--device cuda``, the default, which raises without one) or,
when asked, on the CPU (``--device cpu``).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--artifact", required=True, action="append",
                   help="directory from cli.export_serving (engine or "
                        "--bo). Repeatable as NAME=DIR for the multi-model "
                        "registry: the first entry answers bare endpoints, "
                        "every entry also serves under /m/NAME/...")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 picks a free port (printed on startup)")
    p.add_argument("--warmup", action="store_true",
                   help="run every served program once (kernel builds, CUDA "
                        "graph captures) before accepting requests "
                        "(first-request latency moves to startup)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the models run (the card unless cpu is asked "
                        "for; raises without a card)")
    p.add_argument("--dynamic-batch", action="store_true",
                   help="coalesce concurrent BO /explain requests into one "
                        "image-batched device call (fused-BO artifact "
                        "exported with --bo-image-batches)")
    p.add_argument("--batch-wait-ms", type=float, default=5.0,
                   help="dynamic-batch collection window: how long the "
                        "first queued request waits for concurrent "
                        "arrivals to join its device call")
    p.add_argument("--max-pending", type=int, default=256,
                   help="dynamic-batch queue bound: beyond this many "
                        "pending explains the service sheds load with a "
                        "retryable 503")
    p.add_argument("--batch-max-group", type=int, default=None,
                   help="cap the coalesced group size below the artifact's "
                        "largest exported image batch — bounds how many "
                        "requests one slow device call can stall (latency-"
                        "tail blast radius)")
    args = p.parse_args(argv)

    from network_interpretation_imagenet_tpu_torch.serving_http import (
        make_http_server,
    )

    if len(args.artifact) == 1 and "=" not in args.artifact[0]:
        artifacts = args.artifact[0]  # single-model (back-compat) shape
    else:
        artifacts = {}
        for i, spec in enumerate(args.artifact):
            name, sep, d = spec.partition("=")
            if sep and not d:
                p.error(f"--artifact {spec!r}: empty directory after '='")
            if not sep:
                name, d = f"model{i}" if i else "default", spec
            if name in artifacts:
                p.error(f"--artifact: duplicate model name {name!r} "
                        f"({artifacts[name]!r} and {d!r})")
            artifacts[name] = d
    httpd = make_http_server(artifacts, args.host, args.port,
                             dynamic_batch=args.dynamic_batch,
                             batch_wait_ms=args.batch_wait_ms,
                             max_pending=args.max_pending,
                             batch_max_group=args.batch_max_group,
                             device=args.device)
    if args.warmup:
        import time

        t0 = time.perf_counter()
        n = sum(s.warmup() for s in httpd.services.values())
        print(f"warmed {n} programs in {time.perf_counter() - t0:.1f}s",
              flush=True)
    host, port = httpd.server_address[:2]
    models = ", ".join(f"{n}:{s.kind}" for n, s in httpd.services.items())
    print(f"serving {models} on "
          f"http://{host}:{port}  endpoints: /healthz /metrics /explain "
          f"/explain_batch /eval_windows /eval_knockouts"
          + (" (+ /m/<name>/... per model)" if len(httpd.services) > 1
             else ""),
          flush=True)
    # Graceful drain: SIGTERM (the orchestrator's stop signal) stops
    # accepting connections but lets in-flight device calls finish —
    # shutdown() must run off the serve_forever thread, so hand it to a
    # helper thread and let serve_forever return normally. Handler threads
    # must be non-daemon (ThreadingHTTPServer defaults them to daemon, and
    # daemon threads are killed at interpreter exit mid-device-call) so
    # server_close() joins them; HTTP/1.0 per-request connections bound
    # the join by the longest in-flight request.
    httpd.daemon_threads = False
    import signal
    import threading

    def _drain(signum, frame):
        print("SIGTERM: draining in-flight requests, no longer accepting",
              flush=True)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _drain)
    except ValueError:
        pass  # non-main thread (embedded use); orchestration handles stop
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
