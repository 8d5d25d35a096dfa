"""HTTP serving of the embed/detect API (counterpart of awm_tpu/serve.py).

The JAX package's REST surface on the stdlib ThreadingHTTPServer:

    POST /embed?message=N&seed=K&ecc=1   body: WAV bytes -> watermarked WAV bytes
                                         (X-Awm-Watermark-Rms, X-Awm-Messages,
                                         X-Awm-Payloads headers)
    POST /detect?threshold=T&ecc=1       body: WAV bytes -> JSON detection result
    POST /verify?message=N&threshold=T&alpha=A&ecc=1
                                         body: WAV bytes -> JSON authentication
    GET  /healthz                        -> JSON status with the batching stats

HTTP threads decode and encode WAVs only; the model runs on the batcher's
one consumer thread (batching.py), where concurrent requests' chunks share a
device call.  A bad body or query parameter is a 400, an unknown path a 404,
and a failure of the device call a 500 with its message.

Start with:  python -m awm_tpu_torch serve --ckpt runs/x/ckpt_best --port 8787
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from awm_tpu_torch.api import detect_array, verify_array, watermark_array
from awm_tpu_torch.utils.audio_io import decode_wav_bytes, encode_wav_bytes, resample, to_mono


def _decode_wav_bytes(data: bytes, sample_rate: int) -> np.ndarray:
    """Request body -> mono float32 at the session's rate, in memory."""
    wav, sr = decode_wav_bytes(data)
    return resample(to_mono(wav), sr, sample_rate)


def make_handler(session):
    """The request handler class over a session (a BatchedSession in
    serve(); any object with the InferenceSession surface works)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                payload = {"status": "ok", "message_bits": session.message_bits,
                           "sample_rate": session.sample_rate}
                if hasattr(session, "batcher"):
                    payload["batching"] = dict(session.batcher.stats)
                self._json(200, payload)
            else:
                self._json(404, {"error": "unknown endpoint"})

        def do_POST(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length <= 0:
                    return self._json(400, {"error": "empty body; POST WAV bytes"})
                data = self.rfile.read(length)
                wav = _decode_wav_bytes(data, session.sample_rate)
            except Exception as e:
                return self._json(400, {"error": f"could not decode audio: {e}"})
            routes = {"/embed": self._embed, "/detect": self._detect, "/verify": self._verify}
            if url.path not in routes:
                return self._json(404, {"error": "unknown endpoint"})
            try:
                routes[url.path](q, wav)
            except Exception as e:  # the device call failed: the client hears of it
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def _embed(self, q, wav):
            try:
                message: Optional[int] = None
                ecc = q.get("ecc", ["0"])[0] in ("1", "true")
                limit = 2**11 if ecc else 2**session.message_bits
                if "message" in q:
                    message = int(q["message"][0])
                    if not 0 <= message < limit:
                        return self._json(400, {"error": "message out of range"})
                seed = int(q["seed"][0]) if "seed" in q else None
            except ValueError as e:
                return self._json(400, {"error": f"bad query parameter: {e}"})
            res = watermark_array(wav, session, message=message, seed=seed, ecc=ecc)
            out = encode_wav_bytes(res["watermarked_waveform"], session.sample_rate)
            delta = res["delta_waveform"]
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(out)))
            self.send_header("X-Awm-Watermark-Rms", f"{float(np.sqrt((delta**2).mean())):.6g}")
            self.send_header("X-Awm-Messages", ",".join(map(str, res["messages"])))
            if "payloads" in res:
                self.send_header("X-Awm-Payloads", ",".join(map(str, res["payloads"])))
            self.end_headers()
            self.wfile.write(out)

        def _detect(self, q, wav):
            try:
                thr = float(q["threshold"][0]) if "threshold" in q else 0.5
                ecc = q.get("ecc", ["0"])[0] in ("1", "true")
            except ValueError as e:
                return self._json(400, {"error": f"bad query parameter: {e}"})
            r = detect_array(wav, session, thr, ecc=ecc)
            self._json(200, {
                "mean_probability": r["mean_probability"],
                "is_watermarked": r["is_watermarked"],
                "decision": r["decision"],
                "predicted_message": r["predicted_message"],
                "message_confidence": r["message_confidence"],
                **({"ecc": r["ecc"]} if "ecc" in r else {}),
            })

        def _verify(self, q, wav):
            try:
                message = int(q["message"][0])
                ecc = q.get("ecc", ["0"])[0] in ("1", "true")
                limit = 2**11 if ecc else 2**session.message_bits
                if not 0 <= message < limit:
                    return self._json(400, {"error": "message out of range"})
                thr = float(q["threshold"][0]) if "threshold" in q else 0.5
                alpha = float(q["alpha"][0]) if "alpha" in q else 0.01
            except (KeyError, ValueError) as e:
                return self._json(400, {"error": f"need ?message=N (+ optional threshold/alpha): {e}"})
            self._json(200, verify_array(wav, session, message, thr, alpha, ecc=ecc))

    return Handler


class AwmHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog sized for bursty load: the
    stdlib's 5 makes the kernel reset connections beyond it (13 of 32
    simultaneous clients in the JAX package's measurement)."""

    request_queue_size = 128
    daemon_threads = True


def make_server(session, host: str = "127.0.0.1", port: int = 8787, *, max_batch: int = 256,
                max_wait_ms: float = 5.0):
    """(server, batched session) over an InferenceSession; port 0 picks a
    free port (server.server_address).  Run server.serve_forever(); stop with
    server.shutdown(), server.server_close() and batched.close()."""
    from awm_tpu_torch.batching import BatchedSession

    batched = BatchedSession(session, max_batch=max_batch, max_wait_ms=max_wait_ms)
    return AwmHTTPServer((host, port), make_handler(batched)), batched


def serve(session, host: str = "127.0.0.1", port: int = 8787, *, max_batch: int = 256,
          max_wait_ms: float = 5.0):
    """Serve until interrupted."""
    httpd, batched = make_server(session, host, port, max_batch=max_batch, max_wait_ms=max_wait_ms)
    print(f"awm_tpu_torch serving on http://{host}:{httpd.server_address[1]} "
          "(POST /embed, /detect, /verify; GET /healthz)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        batched.close()
