"""Serving load test: N concurrent HTTP clients against the port's server
(counterpart of tools/serve_load.py).

Measures the serving path end to end (WAV parse, micro-batch coalescing,
device call, WAV encode) and reports requests/s, audio seconds/s, chunks
through the model per second, latency percentiles, the /healthz coalescing
stats and the share of the window the server spent in device calls.  Every
request carries --seconds of audio, i.e. that many
1-s chunks.

Usage, against a running server or with the server in process:

    python -m awm_tpu_torch serve --ckpt runs/x/ckpt_best --port 8787 &
    python -m awm_tpu_torch.tools.serve_load --port 8787 --clients 32 --requests 128
    python -m awm_tpu_torch.tools.serve_load --self-serve --ckpt runs/x/ckpt_best
"""

from __future__ import annotations

import argparse
import http.client
import json
import threading
import time

import numpy as np

from awm_tpu_torch.utils.audio_io import encode_wav_bytes


def healthz(host: str, port: int) -> dict:
    c = http.client.HTTPConnection(host, port, timeout=30)
    c.request("GET", "/healthz")
    return json.loads(c.getresponse().read())


def _path(endpoint: str, i: int) -> str:
    return "/detect" if endpoint == "detect" else f"/embed?message={i % 65536}"


def run_load(host: str, port: int, *, clients: int = 32, requests: int = 128, seconds: int = 4,
             mix=("detect", "embed"), bodies=None) -> dict:
    """Warm up once per endpoint, then `clients` threads send `requests`
    requests in all, alternating over `mix`.  Returns the numbers."""
    if bodies is None:
        rng = np.random.default_rng(0)
        bodies = [encode_wav_bytes(0.2 * rng.standard_normal(16000 * seconds), 16000) for _ in range(8)]
    for ep in mix:
        c = http.client.HTTPConnection(host, port, timeout=600)
        c.request("POST", _path(ep, 1), body=bodies[0], headers={"Content-Length": str(len(bodies[0]))})
        c.getresponse().read()
    before = healthz(host, port)["batching"]
    latencies, errors = [], []
    lock = threading.Lock()
    work = list(range(requests))

    def client():
        c = http.client.HTTPConnection(host, port, timeout=600)
        while True:
            with lock:
                if not work:
                    return
                i = work.pop()
            body = bodies[i % len(bodies)]
            t0 = time.perf_counter()
            try:
                c.request("POST", _path(mix[i % len(mix)], i), body=body,
                          headers={"Content-Length": str(len(body))})
                r = c.getresponse()
                r.read()
                ok = r.status == 200
            except (OSError, http.client.HTTPException):  # counted, the load goes on
                ok = False
                c = http.client.HTTPConnection(host, port, timeout=600)
            dt = time.perf_counter() - t0
            with lock:
                (latencies if ok else errors).append(dt)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    after = healthz(host, port)["batching"]
    lat = np.sort(np.asarray(latencies)) * 1e3
    batches = after["device_batches"] - before["device_batches"]
    chunks = after["batched_chunks"] - before["batched_chunks"]
    device_s = after["device_s"] - before["device_s"]
    pct = lambda q: float(lat[min(len(lat) - 1, int(len(lat) * q))]) if len(lat) else None
    return {
        "clients": clients,
        "requests_ok": len(latencies),
        "errors": len(errors),
        "seconds_per_request": seconds,
        "wall_s": wall,
        "req_per_s": len(latencies) / wall,
        "audio_s_per_s": len(latencies) * seconds / wall,
        "clips_per_s": chunks / wall,
        "latency_p50_ms": pct(0.50),
        "latency_p95_ms": pct(0.95),
        "latency_p99_ms": pct(0.99),
        "device_batches": batches,
        "batched_chunks": chunks,
        "requests_served": after["requests"] - before["requests"],
        "chunks_per_device_batch": chunks / batches if batches else None,
        "device_s": device_s,
        "device_busy_share": device_s / wall,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="serve_load", description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--requests", type=int, default=128, help="total requests")
    ap.add_argument("--seconds", type=int, default=4, help="audio seconds per request")
    ap.add_argument("--mix", default="detect,embed", help="endpoints to alternate between")
    ap.add_argument("--self-serve", action="store_true",
                    help="start the server in this process on a free port over --ckpt (or the "
                         "packaged shapecap weights), run the load, stop it")
    ap.add_argument("--ckpt", help="checkpoint directory of the port, with --self-serve")
    ap.add_argument("--compute-dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--device", default="cuda", help="torch device, with --self-serve")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    args = ap.parse_args(argv)

    host, port, stop = args.host, args.port, None
    if args.self_serve:
        import torch

        from awm_tpu_torch.api import InferenceSession
        from awm_tpu_torch.serve import make_server

        dtype = torch.float32 if args.compute_dtype == "float32" else torch.bfloat16
        sess = (InferenceSession.from_checkpoint(args.ckpt, compute_dtype=dtype, device=args.device)
                if args.ckpt else InferenceSession.from_npz(compute_dtype=dtype, device=args.device))
        httpd, batched = make_server(sess, "127.0.0.1", 0, max_batch=args.max_batch,
                                     max_wait_ms=args.max_wait_ms)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        host, port = httpd.server_address

        def stop():
            httpd.shutdown()
            httpd.server_close()
            batched.close()
    try:
        out = run_load(host, port, clients=args.clients, requests=args.requests, seconds=args.seconds,
                       mix=tuple(args.mix.split(",")))
    finally:
        if stop is not None:
            stop()
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
