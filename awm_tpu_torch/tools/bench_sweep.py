"""Batch-size sweep of the two headline throughput paths on one CUDA card
(counterpart of tools/bench_sweep.py).

Sweeps the fused embed+detect call and the full train step across batch
sizes, printing clips/s for each point: the tuning companion to the bench
(awm_tpu_torch/bench.py, which pins B=512 and B=128).  Optionally writes a
torch.profiler trace (utils/profiling.trace) of three steps at the train
sweep's best point.

Departures from the JAX tool:
- A point that runs out of card memory prints ``FAILED (OutOfMemoryError)``
  and ends that sweep, its tensors dropped and the allocator's cache
  emptied.  Any other error is raised: a kernel that fails to build or to
  launch must not end a sweep with exit 0.
- train_step updates the state's networks in place, so each batch size
  (and the trace) continues from the last one's weights, where the JAX
  tool restarts each from the initial state.  Throughput does not depend
  on the weights.

Usage: python -m awm_tpu_torch.tools.bench_sweep [--infer 128,256,512,1024]
       [--train 64,128,256,512] [--trace-dir DIR] [--preset base] [--device cuda]
"""

from __future__ import annotations

import argparse
import gc

import torch

from awm_tpu_torch.bench import (embed_detect_rate, make_clips, require_device, session_inputs,
                                  train_step_rate)


def _point(kind: str, b: int, timed) -> "float | None":
    """timed()'s clips/s, printed; None, printed as FAILED, when the card
    ran out of memory."""
    try:
        rate = timed()
    except torch.OutOfMemoryError:
        rate = None
    if rate is None:
        gc.collect()  # the failed point's tensors, held by the traceback's frames
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
        print(f"{kind} B={b:5d}: FAILED (OutOfMemoryError)", flush=True)
    else:
        print(f"{kind} B={b:5d}: {rate:9.1f} clips/s", flush=True)
    return rate


def sweep_infer(cfg, state, batches, n_iter=12):
    """embed+detect clips/s of a bf16 session over the state's networks at
    each batch size, until one runs out of memory."""
    from awm_tpu_torch.api import InferenceSession

    sess = InferenceSession.from_state(cfg, state)
    rows = []
    for b in batches:
        rate = _point("infer", b, lambda: embed_detect_rate(sess, *session_inputs(cfg, b, sess.device), n_iter))
        if rate is None:
            break
        rows.append((b, rate))
    return rows


def sweep_train(cfg, state, batches, n_iter=15, trace_dir=None):
    """Train-step clips/s at each batch size, until one runs out of memory;
    with trace_dir, a trace of three steps at the fastest point."""
    from awm_tpu_torch import train as tr
    from awm_tpu_torch.utils.profiling import trace

    dev = next(state.gen.parameters()).device
    batch = lambda b: torch.from_numpy(make_clips(b, cfg.audio_len, cfg.sample_rate)).to(dev)  # noqa: E731
    rows = []
    for b in batches:
        rate = _point("train", b, lambda: train_step_rate(cfg, state, batch(b), n_iter))
        if rate is None:
            break
        rows.append((b, rate))
    if trace_dir and rows:
        best_b = max(rows, key=lambda r: r[1])[0]
        s = batch(best_b)
        float(tr.train_step(cfg, state, s)["total"])
        with trace(trace_dir):
            for _ in range(3):
                terms = tr.train_step(cfg, state, s)
            float(terms["total"])
        print(f"trace written to {trace_dir} (B={best_b})", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_sweep", description=__doc__.splitlines()[0])
    ap.add_argument("--infer", default="128,256,512,1024")
    ap.add_argument("--train", default="64,128,256,512")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--preset", default="base")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from awm_tpu_torch import train as tr
    from awm_tpu_torch.config import get_config

    dev = require_device(args.device)
    cfg = get_config(args.preset)
    state = tr.init_state(cfg, seed=0, device=dev)
    if args.infer:
        sweep_infer(cfg, state, [int(x) for x in args.infer.split(",")])
    if args.train:
        sweep_train(cfg, state, [int(x) for x in args.train.split(",")], trace_dir=args.trace_dir)


if __name__ == "__main__":
    main()
