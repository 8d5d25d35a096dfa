#!/usr/bin/env python3
"""Time the CUDA LSTM kernels of one checkout on the card, at the main
paths' shapes: A at B=512, B and C at B=128, T=16000, fp32 and bf16.

    python3 awm_tpu_torch/ops/bench_lstm.py [--tree DIR] [--variants] [--check] [--only NAME]

--tree DIR imports awm_tpu_torch from another checkout of this repository
(DIR/awm_tpu_torch), so that two commits can be timed in turns in one call
on one card: run this script once per tree, parent, change, change, parent.
Only the wrappers every checkout has are called (forward_kernel,
forward_train_kernel, backward_kernel).  --variants also times each rows-
per-block variant the checkout's launch plan can choose (a checkout without
a plan has none).  --check first holds every kernel against its plain
version at T=2000 and prints ptxas's report.  The backward's four launches
are also timed apart, from a torch.profiler trace of one call.  Prints one JSON object per
line: {"tree", "card", "kernel", "batch", "rows", "ms"}; times are CUDA events
over --reps launches after a warm-up.  Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

T = 16000


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_split(torch, fn) -> dict[str, float]:
    """Device ms by kernel name of one call of fn (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
    return {e.key: dev_us(e) / 1e3 for e in prof.key_averages()
            if dev_us(e) > 0 and e.self_cpu_time_total == 0}


def inputs(torch, b: int, t: int, dtype, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(b, t, 64, device="cuda", generator=g) * 0.5).to(dtype)
    w = [(torch.rand(*s, device="cuda", generator=g) * 2 - 1) / 8.0
         for s in ((256, 64), (256, 64), (256,))]
    dy = torch.randn(b, t, 64, device="cuda", generator=g) * 0.1
    return x, w[0], w[1], 2 * w[2], dy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tree", default=here)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default="", help="time only kernels whose name contains this")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path[0] = tree  # in place of this script's own directory

    import torch

    if not torch.cuda.is_available():
        print("bench_lstm: no CUDA card visible to torch", file=sys.stderr)
        return 1
    from awm_tpu_torch.ops import lstm_kernel as K
    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    K.libraries()
    fwd_rows = getattr(K, "FWD_ROWS", (None,)) if args.variants else (None,)
    bwd_rows = getattr(K, "BWD_ROWS", (None,)) if args.variants else (None,)
    if None not in fwd_rows:
        fwd_rows, bwd_rows = (None, *fwd_rows), (None, *bwd_rows)
    kw = lambda rows: {} if rows is None else {"rows": rows}
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}

    if args.check:
        print(K.build_log, flush=True)
        for sfx, dtype in dtypes.items():
            for b in (5, 128):
                x, w_ih, w_hh, bias, dy = inputs(torch, b, 2000, dtype, seed=b)
                ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
                for rows in fwd_rows:
                    y0 = K.forward_kernel(x, w_ih, w_hh, bias, **kw(rows))
                    y, c = K.forward_train_kernel(x, w_ih, w_hh, bias, **kw(rows))
                    torch.cuda.synchronize()
                    print(f"check {sfx} B={b} rows={rows}: A vs plain "
                          f"{float((y0.float() - ref_y.float()).abs().max()):.3e}, B y "
                          f"{float((y.float() - ref_y.float()).abs().max()):.3e} cprev "
                          f"{float((c - ref_c).abs().max()):.3e}", flush=True)
                ref_g = lstm_backward(x, ref_y, ref_c, dy, w_ih, w_hh, bias)
                for rows in bwd_rows:
                    got = K.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, **kw(rows))
                    torch.cuda.synchronize()
                    rels = [float((g.float() - r.float()).abs().max() / (r.float().abs().max() + 1e-12))
                            for g, r in zip(got, ref_g)]
                    print(f"check {sfx} B={b} rows={rows}: C dx, dW_ih, dW_hh, db rel "
                          f"{', '.join(f'{r:.2e}' for r in rels)}", flush=True)

    def report(kernel, batch, rows, ms):
        print(json.dumps({"tree": tree, "card": card, "kernel": kernel, "batch": batch,
                          "rows": rows, "ms": ms}), flush=True)

    want = lambda name: args.only in name
    for sfx, dtype in dtypes.items():
        x, w_ih, w_hh, bias, _ = inputs(torch, 512, T, dtype, seed=7)
        for rows in fwd_rows if want(f"lstm_fwd_{sfx}") else ():
            report(f"lstm_fwd_{sfx}", 512, rows,
                   cuda_ms(torch, lambda: K.forward_kernel(x, w_ih, w_hh, bias, **kw(rows)), args.reps))
        del x
        x, w_ih, w_hh, bias, dy = inputs(torch, 128, T, dtype, seed=8)
        y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
        for rows in fwd_rows if want(f"lstm_fwd_train_{sfx}") else ():
            report(f"lstm_fwd_train_{sfx}", 128, rows, cuda_ms(
                torch, lambda: K.forward_train_kernel(x, w_ih, w_hh, bias, **kw(rows)), args.reps))
        if not want(f"lstm_bwd_{sfx}"):
            continue
        for rows in bwd_rows:
            report(f"lstm_bwd_{sfx}", 128, rows, cuda_ms(
                torch, lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias, **kw(rows)), args.reps))
        split = kernel_split(torch, lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias))
        for key, ms in split.items():
            if "lstm_bwd" in key:
                short = key[key.index("lstm_bwd"):].split("I")[0].split("E")[0]
                report(f"lstm_bwd_{sfx}:{short}", 128, None, ms)
        del x, y, cprev, dy
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
