"""The port's serving front end vs the JAX package: the micro-batcher
(batch composition, op purity, failures), the HTTP server against the JAX
package's server over the same fp32 weights, and the tools that drive the
session (demo_eval's quality section, bit_diagnostic, serve_load).

Weights: the packaged shapecap checkpoint, fp32, chunks of CHUNK samples on
the CPU.  Tolerances are stated per test."""

import dataclasses
import http.client
import importlib.util
import io
import json
import os
import threading
import wave

import numpy as np
import pytest
import torch

import torch_assets as ta

from awm_tpu_torch.api import InferenceSession, detect_array, verify_array, watermark_array
from awm_tpu_torch.batching import BatchedSession, MicroBatcher
from awm_tpu_torch.serve import make_server
from awm_tpu_torch.utils.audio_io import encode_wav_bytes

CHUNK = 800


@pytest.fixture(scope="module")
def session():
    return InferenceSession.from_npz(compute_dtype=torch.float32, device="cpu", chunk_len=CHUNK)


def _start(sess, **kw):
    httpd, batched = make_server(sess, "127.0.0.1", 0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, batched


def _stop(httpd, batched):
    httpd.shutdown()
    httpd.server_close()
    batched.close()


@pytest.fixture(scope="module")
def server(session):
    httpd, batched = _start(session, max_wait_ms=100.0)
    yield httpd.server_address, batched
    _stop(httpd, batched)


def _post(addr, path, body):
    c = http.client.HTTPConnection(*addr, timeout=300)
    c.request("POST", path, body=body, headers={"Content-Length": str(len(body))})
    r = c.getresponse()
    return r.status, dict(r.getheaders()), r.read()


def _get(addr, path):
    c = http.client.HTTPConnection(*addr, timeout=30)
    c.request("GET", path)
    r = c.getresponse()
    return r.status, json.loads(r.read())


def _pcm(body):
    with wave.open(io.BytesIO(body)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int32)


def _waves(n, seed=0):
    """n speech-like waveforms of 1.5 to 3 chunks (ragged tails)."""
    chunks, _ = ta.golden_inputs(seed=seed + 11, n=n)
    lengths = np.random.default_rng(seed).integers(int(1.5 * CHUNK), 3 * CHUNK, size=n)
    return [np.resize(c, int(k)).astype(np.float32) for c, k in zip(chunks, lengths)]


def _concurrently(fns):
    out = [None] * len(fns)
    barrier = threading.Barrier(len(fns))

    def run(i):
        barrier.wait()
        out[i] = fns[i]()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


# -- the micro-batcher ----------------------------------------------------------


def test_concurrent_http_requests_equal_unbatched_calls(server, session):
    """Nine clients at once (embed, detect and verify, three each, ragged
    lengths): every response 200 and equal to the same call on the unbatched
    session: the embedded WAV within one int16 LSB, detect and verify
    numbers within 1e-5 (fp32; a request's chunks land in a bucket of
    another size when others ride along), decisions and messages equal.
    /healthz shows fewer device batches than requests, and a bad body gets a
    400 while the server keeps serving."""
    addr, batched = server
    waves = _waves(9)
    bodies = [encode_wav_bytes(w, 16000) for w in waves]
    decoded = [_pcm(b).astype(np.float32) / 32768.0 for b in bodies]
    calls = []
    for i, body in enumerate(bodies):
        path = (f"/embed?message={1000 + i}&seed={i}", "/detect", f"/verify?message={1000 + i}")[i % 3]
        calls.append(lambda p=path, b=body: _post(addr, p, b))
    _, before = _get(addr, "/healthz")
    results = _concurrently(calls)
    _, after = _get(addr, "/healthz")
    for i, (status, headers, body) in enumerate(results):
        assert status == 200, (i, body)
        if i % 3 == 0:
            want = watermark_array(decoded[i], session, message=1000 + i, seed=i)
            assert headers["X-Awm-Messages"] == ",".join(map(str, want["messages"]))
            got_pcm = _pcm(body)
            want_pcm = _pcm(encode_wav_bytes(want["watermarked_waveform"], 16000))
            assert np.abs(got_pcm - want_pcm).max() <= 1
        elif i % 3 == 1:
            got, want = json.loads(body), detect_array(decoded[i], session)
            assert got["decision"] == want["decision"]
            assert got["predicted_message"] == want["predicted_message"]
            assert abs(got["mean_probability"] - want["mean_probability"]) <= 1e-5
            np.testing.assert_allclose(got["message_confidence"], want["message_confidence"], atol=1e-5)
        else:
            got, want = json.loads(body), verify_array(decoded[i], session, 1000 + i)
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                if isinstance(v, float):
                    assert abs(got[k] - v) <= 1e-5, k
                else:
                    assert got[k] == v, k
    reqs = after["batching"]["requests"] - before["batching"]["requests"]
    batches = after["batching"]["device_batches"] - before["batching"]["device_batches"]
    assert reqs >= 9 and batches < reqs, (batches, reqs)
    assert _post(addr, "/detect", b"RIFF and nothing else")[0] == 400
    assert _get(addr, "/healthz")[0] == 200


class _Recorder:
    """A session stand-in that records every device call and checks that a
    call's chunks all come from one op (embed chunks hold 1.0, detect 2.0)."""

    message_bits, sample_rate, chunk_len = 16, 16000, 4

    def __init__(self, fail=False):
        self.calls, self.fail = [], fail

    def embed_chunks(self, chunks, messages):
        self.calls.append(("embed", chunks.shape[0], set(np.unique(chunks))))
        if self.fail:
            raise RuntimeError("device call failed")
        return chunks * 0.5

    def detect_summary(self, chunks, lengths):
        self.calls.append(("detect", chunks.shape[0], set(np.unique(chunks))))
        n = chunks.shape[0]
        return chunks, np.zeros((n, 16)), np.zeros((n, 16)), chunks.mean(axis=1)


def test_embed_and_detect_never_share_a_device_batch():
    """Twelve interleaved embed and detect submissions inside one wait
    window: every device call holds one op's chunks only, the spilled op
    runs in the next window, and each request gets its own rows back."""
    rec = _Recorder()
    mb = MicroBatcher(rec, max_batch=256, max_wait_ms=200.0)
    try:
        fns = []
        for i in range(12):
            if i % 2:
                fns.append(lambda i=i: mb.detect_summary(np.full((i % 3 + 1, 4), 2.0, np.float32))[3])
            else:
                fns.append(lambda i=i: mb.embed_chunks(np.full((i % 3 + 1, 4), 1.0, np.float32),
                                                       np.arange(i % 3 + 1)))
        out = _concurrently(fns)
    finally:
        mb.close()
    for op, _, values in rec.calls:
        assert values == ({1.0} if op == "embed" else {2.0}), rec.calls
    assert len(rec.calls) < 12 and {op for op, *_ in rec.calls} == {"embed", "detect"}
    for i, rows in enumerate(out):
        assert rows.shape[0] == i % 3 + 1
        assert np.all(rows == (2.0 if i % 2 else 0.5))
    assert mb.stats.pop("device_s") > 0
    assert mb.stats == {"requests": 12, "device_batches": len(rec.calls),
                        "batched_chunks": sum(n for _, n, _ in rec.calls)}


def test_session_failure_reaches_every_waiting_request():
    """A device call that raises: every request of its batch gets the
    exception (none hangs, none is answered), and over HTTP the client gets
    a 500 naming it while the server keeps serving."""
    rec = _Recorder(fail=True)
    mb = MicroBatcher(rec, max_wait_ms=200.0)

    def submit():
        try:
            mb.embed_chunks(np.ones((2, 4), np.float32), np.arange(2))
        except RuntimeError as e:
            return str(e)

    try:
        assert _concurrently([submit] * 4) == ["device call failed"] * 4
    finally:
        mb.close()
    assert len(rec.calls) < 4

    httpd, batched = _start(_Recorder(fail=True))
    try:
        status, _, body = _post(httpd.server_address, "/embed?message=3",
                                encode_wav_bytes(np.zeros(10, np.float32), 16000))
        assert status == 500 and "device call failed" in json.loads(body)["error"]
        assert _get(httpd.server_address, "/healthz")[0] == 200
    finally:
        _stop(httpd, batched)


def test_batcher_counts_every_request_under_thread_stress():
    """48 submitting threads with a 1 us switch interval: every request is
    answered with its own rows and counted once (requests, chunks)."""
    import sys

    rec = _Recorder()
    mb = MicroBatcher(rec, max_batch=16, max_wait_ms=2.0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = _concurrently([lambda i=i: mb.embed_chunks(np.full((i % 4 + 1, 4), 1.0, np.float32),
                                                         np.arange(i % 4 + 1)) for i in range(48)])
    finally:
        sys.setswitchinterval(interval)
        mb.close()
    assert not mb._worker.is_alive()
    assert [r.shape[0] for r in out] == [i % 4 + 1 for i in range(48)]
    assert mb.stats["requests"] == 48
    assert mb.stats["batched_chunks"] == sum(i % 4 + 1 for i in range(48)) == sum(n for _, n, _ in rec.calls)


def test_batched_session_routes_only_the_two_device_calls(session):
    """BatchedSession reads attributes through but refuses the session's
    other methods, which would run off the device thread."""
    batched = BatchedSession(session)
    try:
        assert (batched.message_bits, batched.chunk_len) == (16, CHUNK)
        with pytest.raises(AttributeError, match="device thread"):
            batched.embed_detect
    finally:
        batched.close()


# -- the server against the JAX package's ---------------------------------------


@pytest.fixture(scope="module")
def jax_server():
    import jax.numpy as jnp

    from awm_tpu.api import InferenceSession as JSession
    from awm_tpu.batching import BatchedSession as JBatched
    from awm_tpu.serve import AwmHTTPServer, make_handler

    cfg = ta.shapecap_config()
    cfg = dataclasses.replace(cfg, audio_len=CHUNK)
    state, gen, det, _ = ta.jax_state_from_npz(cfg)
    sess = JSession.from_state(cfg, gen, det, state, compute_dtype=jnp.float32)
    batched = JBatched(sess, max_wait_ms=5.0)
    httpd = AwmHTTPServer(("127.0.0.1", 0), make_handler(batched))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield httpd.server_address
    httpd.shutdown()
    batched.close()


def test_responses_match_the_jax_server(server, jax_server):
    """The same WAV bytes POSTed to the JAX server and to the port's over
    the same fp32 weights: the same status codes (200, 400 and 404 cases),
    the same JSON keys and X-Awm-* headers, detect and verify numbers within
    1e-5, decisions and messages equal, and the embedded WAV within one
    int16 LSB."""
    addr = server[0]
    body = encode_wav_bytes(_waves(1, seed=3)[0], 16000)
    requests = ["/embed?message=4321&seed=2", "/embed?message=77&ecc=1&seed=1", "/detect",
                "/detect?threshold=0.4&ecc=1", "/verify?message=4321", "/verify?message=77&ecc=1&alpha=0.05",
                "/embed?message=99999999", "/embed?message=abc", "/detect?threshold=x", "/verify",
                "/verify?message=4000&ecc=1", "/nope"]
    for path in requests:
        got, want = _post(addr, path, body), _post(jax_server, path, body)
        assert got[0] == want[0], path
        if got[0] != 200:
            assert sorted(json.loads(got[2])) == sorted(json.loads(want[2])) == ["error"], path
            continue
        if path.startswith("/embed"):
            for h in ("X-Awm-Messages", "X-Awm-Payloads"):
                assert got[1].get(h) == want[1].get(h), (path, h)
            assert abs(float(got[1]["X-Awm-Watermark-Rms"]) - float(want[1]["X-Awm-Watermark-Rms"])) <= 1e-6
            assert np.abs(_pcm(got[2]) - _pcm(want[2])).max() <= 1, path
            continue
        g, w = json.loads(got[2]), json.loads(want[2])
        assert sorted(g) == sorted(w), path
        for k, v in w.items():
            if isinstance(v, float):
                assert abs(g[k] - v) <= 1e-5, (path, k)
            elif k == "message_confidence":
                np.testing.assert_allclose(g[k], v, atol=1e-5, err_msg=path)
            else:
                assert g[k] == v, (path, k)
    for path in ("/embed", "/nope"):
        assert _post(addr, path, b"")[0] == _post(jax_server, path, b"")[0] == 400
    assert _get(addr, "/nope")[0] == _get(jax_server, "/nope")[0] == 404
    g, w = _get(addr, "/healthz")[1], _get(jax_server, "/healthz")[1]
    assert sorted(g) == sorted(w) and set(g["batching"]) == set(w["batching"]) | {"device_s"}


# -- the tools --------------------------------------------------------------------


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", os.path.join(ta.REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_demo_eval_quality_equals_jax(session):
    """demo_eval's quality section on 16 test-split clips of CHUNK samples
    (the 14-clip file round trip included: STOI, NSIM, SI-SNR), the port's
    fp32 session vs the JAX package's over the same weights: every number
    within 1e-4."""
    import jax.numpy as jnp

    from awm_tpu.api import InferenceSession as JSession
    from awm_tpu_torch.tools import demo_eval

    cfg = dataclasses.replace(ta.shapecap_config(), audio_len=CHUNK)
    state, gen, det, _ = ta.jax_state_from_npz(cfg)
    jsess = JSession.from_state(cfg, gen, det, state, compute_dtype=jnp.float32)
    clips = demo_eval.test_clips(CHUNK, 400, 16)
    want = _jax_tool("demo_eval").section_quality(jsess, clips, cfg, 8)
    got = demo_eval.section_quality(session, clips, 8)
    flat = lambda d: {k: v for k, v in d.items() if k != "file_roundtrip"} | d["file_roundtrip"]
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k, v in w.items():
        assert abs(g[k] - v) <= 1e-4, (k, g[k], v)


def test_tools_run_on_a_checkpoint(tmp_path, server, capsys):
    """demo_eval (quality, ecc, music) and bit_diagnostic (plain and under
    resample_8k) on a checkpoint of the port, and serve_load's load against
    the running server: each runs on the CPU at CHUNK samples and reports
    finite numbers of the expected shapes; an unknown section is refused
    before any model work."""
    from awm_tpu_torch import checkpoint as ck
    from awm_tpu_torch import train as tr
    from awm_tpu_torch.checkpoint import SHAPECAP_ARCH, configs_from_arch, read_arch
    from awm_tpu_torch.config import get_config
    from awm_tpu_torch.tools import bit_diagnostic, demo_eval, serve_load

    model, shaping = configs_from_arch(read_arch(SHAPECAP_ARCH))
    cfg = dataclasses.replace(get_config("base"), model=model, shaping=shaping)
    state = tr.init_state(cfg, device="cpu")
    ck.load_into(state.gen, state.det, ck.SHAPECAP_NPZ)
    path = str(tmp_path / "ckpt_best")
    ck.save_checkpoint(path, state, epoch=2, best_val=0.75, model_cfg=cfg.model, shaping_cfg=cfg.shaping)
    common = ["--ckpt", path, "--device", "cpu", "--audio-len", str(CHUNK), "--synthetic-n", "200",
              "--compute-dtype", "float32"]
    report = demo_eval.main(common + ["--n-eval", "16", "--batch-size", "8",
                                      "--sections", "quality,ecc,music"])
    assert report["best_val"] == 0.75 and report["n_eval"] == 16
    assert set(report) >= {"quality", "ecc", "music"} and len(report["ecc"]) == 12
    assert report["quality"]["detect_rate"] > 0.5
    with pytest.raises(SystemExit, match="unknown --sections"):
        demo_eval.main(common + ["--sections", "robustness"])
    for attack in ([], ["--attack", "resample_8k"]):
        out = bit_diagnostic.main(common + ["--n-eval", "8", "--batch-size", "4", *attack])
        assert len(out["ml_acc"]) == 16 and out["n_eval"] == 8
        assert all(0.0 <= v <= 1.0 for v in out["ml_acc"] + out["vote_acc"])
    assert "agg vote" in capsys.readouterr().out
    load = serve_load.run_load(*server[0], clients=4, requests=8, seconds=1)
    assert load["requests_ok"] == 8 and load["errors"] == 0
    assert load["batched_chunks"] == 8 * 16000 // CHUNK
    assert np.isfinite([load["req_per_s"], load["latency_p99_ms"], load["chunks_per_device_batch"]]).all()
