"""Benchmark of the port on one CUDA card: 1-s clips/s of the fused
embed+detect, of detect-only, and of the full train step (counterpart of the
repo-level bench.py of the JAX package).

    python -m awm_tpu_torch bench [--device cuda]

Prints ONE JSON line with bench.py's seven keys.  "metric" / "value" /
"unit" / "vs_baseline" carry embed+detect at B=512 (bf16 session);
"train_clips_per_sec_per_chip" / "train_vs_baseline" the bf16 train step at
B=128 (generator forward and backward, the detector on 2B, five losses,
Adam); "detect_only_clips_per_sec_per_chip" the detector with its on-device
reductions at B=512.  The networks are the base preset at its seed-0 init
(train.init_state(get_config("base"), seed=0)): the 2^16 x 64 message table
and the shared head, not the shapecap checkpoint.

vs_baseline divides by REF_CLIPS_PER_SEC, train_vs_baseline by
REF_TRAIN_CLIPS_PER_SEC: the reference notebooks' executed outputs on an
unspecified CUDA GPU at B=16 (BASELINE.md "Throughput").  Neither is a TPU
number, and neither is a target.

Fences: CUDA calls return before the card has finished, so the warm-up and
the last call of each timed loop are fetched to the host (a float of one
output value) before the clock starts and before it stops.

The port's train_step reseeds its message generator from (seed, step) at
every step, where bench.py hands one key to every step: the draws differ,
the work does not.  The bench runs on the card only: without one, and
without device="cpu" (the tests' small runs), it raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

REF_CLIPS_PER_SEC = 278.0  # BASELINE.md main14 validation rate
REF_TRAIN_CLIPS_PER_SEC = 76.5  # BASELINE.md main14 train rate midpoint
PACKAGE = b"awm_tpu_torch"  # what a cmdline of the port holds


def make_clips(n: int, audio_len: int, sample_rate: int) -> np.ndarray:
    """n sines at 150-450 Hz plus 0.02 noise from default_rng(0), float32
    (bench.py:41-46 and tools/bench_sweep.py:make_clips, bit for bit)."""
    rng = np.random.default_rng(0)
    t = np.arange(audio_len) / sample_rate
    return np.stack(
        [
            0.3 * np.sin(2 * np.pi * f * t) + 0.02 * rng.standard_normal(audio_len)
            for f in np.linspace(150, 450, n)
        ]
    ).astype(np.float32)


def require_device(device) -> torch.device:
    """The device to time on; a cuda device that torch cannot see raises
    (a bench never falls back to timing the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"bench: device {str(dev)!r} asked for, but torch sees no cuda card; "
                           f"the bench times the card (device 'cpu' runs it on the CPU)")
    return dev


def clips_per_sec(call, batch: int, n_iter: int) -> float:
    """clips/s of n_iter calls after one warm-up; call() returns a tensor
    whose first value fences the work queued before it."""
    float(call()[0])
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = call()
    float(out[0])
    return batch * n_iter / (time.perf_counter() - t0)


def session_inputs(cfg, batch: int, device):
    """make_clips' batch on device, messages arange(batch), full lengths."""
    clips = torch.from_numpy(make_clips(batch, cfg.audio_len, cfg.sample_rate)).to(device)
    return clips, torch.arange(batch, device=device), torch.full((batch,), cfg.audio_len, device=device)


def embed_detect_rate(sess, clips, msgs, lengths, n_iter: int) -> float:
    """clips/s of the session's fused embed+detect on tensors on its device."""
    with torch.inference_mode():
        return clips_per_sec(lambda: sess._embed_detect(clips, msgs, lengths)["wm_prob"],
                             clips.shape[0], n_iter)


def train_step_rate(cfg, state, s, n_iter: int) -> float:
    """clips/s of train_step on the batch s (updates state in place)."""
    from awm_tpu_torch import train as tr

    return clips_per_sec(lambda: tr.train_step(cfg, state, s)["total"].reshape(1), s.shape[0], n_iter)


def _bench_inference(cfg, state, batch: int = 512, n_iter: int = 12) -> "tuple[float, float]":
    """(embed+detect clips/s, detect-only clips/s) of a bf16 session over the
    state's networks at B=512, the data on the card once, full lengths."""
    from awm_tpu_torch.api import InferenceSession

    sess = InferenceSession.from_state(cfg, state)
    clips, msgs, lengths = session_inputs(cfg, batch, sess.device)
    fused = embed_detect_rate(sess, clips, msgs, lengths, n_iter)
    # detect-only: the dominant serving op (verify arbitrary content)
    with torch.inference_mode():
        detect = clips_per_sec(lambda: sess._detect_reduced(clips, lengths)[3], batch, n_iter)
    return fused, detect


def _bench_train(cfg, state, batch: int = 128, n_iter: int = 20) -> float:
    """Train-step clips/s at B=128 in cfg's compute dtype (the base preset's
    bf16): 0.3 x normal clips from default_rng(1), one warm-up step, then
    n_iter steps.  Updates state in place."""
    dev = next(state.gen.parameters()).device
    rng = np.random.default_rng(1)
    b = torch.from_numpy((0.3 * rng.standard_normal((batch, cfg.audio_len))).astype(np.float32)).to(dev)
    return train_step_rate(cfg, state, b, n_iter)


def _ancestors(pid: int, proc_root: str) -> "set[int]":
    """pid and every process above it, by the PPid: line of each status."""
    seen = set()
    while pid > 0 and pid not in seen:
        seen.add(pid)
        try:
            with open(os.path.join(proc_root, str(pid), "status")) as f:
                pid = next((int(line.split()[1]) for line in f if line.startswith("PPid:")), 0)
        except (OSError, ValueError):
            break
    return seen


def _busy_pids(proc_root: str = "/proc", me: "int | None" = None) -> "list[int]":
    """Processes whose cmdline holds the port's package name, other than
    this one and its ancestors (a timeout, bash -c, torchrun or a script
    that starts the bench holds the name too)."""
    skip = _ancestors(os.getpid() if me is None else me, proc_root)
    busy = []
    for name in os.listdir(proc_root):
        if not name.isdigit() or int(name) in skip:
            continue
        try:
            with open(os.path.join(proc_root, name, "cmdline"), "rb") as f:
                cmd = f.read().replace(b"\0", b" ")
        except OSError:
            continue
        if PACKAGE in cmd:
            busy.append(int(name))
    return sorted(busy)


def _wait_for_exclusive_chip(max_wait_s: float = 2700.0, proc_root: str = "/proc") -> None:
    """Block (bounded) while any other process of the port is alive.

    The card is single-tenant: a bench next to a live trainer measures
    contention, not the port.  Detection only, by a scan of the cmdlines
    under proc_root; never kills anything."""
    deadline = time.monotonic() + max_wait_s
    while True:
        busy = _busy_pids(proc_root)
        if not busy:
            return
        left = deadline - time.monotonic()
        if left <= 0:
            break
        print(f"bench: waiting for awm_tpu_torch process(es) {busy} to release the "
              f"chip ({int(left)}s left)", file=sys.stderr)
        time.sleep(min(30.0, left))
    print("bench: proceeding despite a live awm_tpu_torch process — numbers may "
          "reflect chip contention", file=sys.stderr)


def main(device="cuda", *, audio_len: "int | None" = None, infer_batch: int = 512,
         infer_iters: int = 12, train_batch: int = 128, train_iters: int = 20) -> dict:
    """Time the base preset's seed-0 networks on device and print the one
    JSON line; returns it as a dict.  The sizes default to bench.py's."""
    from awm_tpu_torch import train as tr
    from awm_tpu_torch.config import get_config

    dev = require_device(device)
    _wait_for_exclusive_chip()

    cfg = get_config("base")  # bf16 mixed-precision training by default
    if audio_len:
        cfg = dataclasses.replace(cfg, audio_len=audio_len)
    state = tr.init_state(cfg, seed=0, device=dev)

    infer, detect = _bench_inference(cfg, state, infer_batch, infer_iters)
    train = _bench_train(cfg, state, train_batch, train_iters)

    out = {
        "metric": "embed_detect_clips_per_sec_per_chip",
        "value": round(infer, 1),
        "unit": "1s-16kHz clips/s",
        "vs_baseline": round(infer / REF_CLIPS_PER_SEC, 2),
        "train_clips_per_sec_per_chip": round(train, 1),
        "train_vs_baseline": round(train / REF_TRAIN_CLIPS_PER_SEC, 2),
        "detect_only_clips_per_sec_per_chip": round(detect, 1),
    }
    print(json.dumps(out), flush=True)
    return out
