#!/usr/bin/env python3
"""Time the CUDA LSTM kernels of one checkout on the card, at the main
paths' shapes: A at B=512, B and C at B=128, fp32 and bf16, at one width
(--width 64, the base family, T=16000; --width 32, the strided family's two
stacked LSTMs, T=50; --width 16, the gradient check of
entry.dryrun_multichip, T=32; any other width, T=16000: 48 takes
capacity 48, 56 capacity 64 at runtime widths, 128 the cluster path, 512
the wide path past 256; --width is D, and --hidden H names the hidden width
apart (default D): 24 with --steps 50 the strided family at hidden_dim 24,
capacity 32 masked; --steps overrides T; --batch times all three at one
other batch, e.g. the curriculum's B=8 or the dry run's B=4).

    python3 awm_tpu_torch/ops/bench_lstm.py [--tree DIR] [--width D] [--hidden H] [--steps T[,T...]] [--batch B]
                                            [--variants] [--paths] [--check] [--only NAME] [--library]
                                            [--split] [--hash [--against FILE]] [--gates]

--tree DIR imports awm_tpu_torch from another checkout of this repository
(DIR/awm_tpu_torch), so that two commits can be timed in turns in one call
on one card: run this script once per tree, parent, change, change, parent.
Only the wrappers every checkout has are called (forward_kernel,
forward_train_kernel, backward_kernel); a checkout without width-32 kernels
takes --width 64 only.  --variants also times each rows-per-block variant
the checkout's launch plan can choose (a checkout without a plan has none;
on the cluster path every rows a cluster the checkout builds, for C too; on
the wide path WIDE_ROWS, rows a row group).
--paths (capacities 32 and 16 at T <= 64, any D, H within them, in a
checkout whose wrappers take short= and fused=) also times each kernel on
the path the plan does not take: A and B on the ring beside the short
path (or on the short path beside the ring, where the plan keeps a masked
fp32 forward there), C in four launches beside the fused one; every line
of such a checkout carries "path" (short, ring, fused, four, cluster or
wide).  An older checkout, whose short path and fused backward take D = H
only, takes --paths at square widths only.
--check first holds every kernel against its plain version at B in (1, 7,
128) and T in (1, 2, 3, 15, 16, 17, 37, 50, 64, 65, 800) with every rows
variant (A and B on both paths where the checkout has the forward's short
path at this width and T is within its bound, with the same bits on both;
C on both of its paths likewise), prints each
error beside its tolerance and ptxas's report, and exits 1 if
any error is above it.  The backward's launches are also timed apart, from a
torch.profiler trace of one call (one on the fused path at widths 32 and
16, four otherwise, five on the cluster path: the gate pass first; there at every
rows variant with --variants), and on the cluster path each line also
holds "waves": the waves of clusters the call takes at the card's reading
of the clusters it holds (on the wide path "launches": the cooperative
launches of row groups a window takes; there C's split is its every launch
by kernel: the packing, the gate pass, the recurrence, dx, dW, the sum).  Prints one JSON object per line: {"tree",
"card", "kernel", "width", "steps", "batch", "rows", "ms"}; times are CUDA
events over --reps launches after a warm-up, and with --variants also
"device_ms": the kernels' own device time per call from torch.profiler
(over min(--reps, 50) calls).  --steps with more than one T (e.g.
--width 32 --steps 1,2,8,16,32,50,64) adds "device_ms" to every line and
then prints, for each kernel and rows variant, one line {"tree", "card",
"kernel", "width", "batch", "rows", "steps", "device_ms", "fixed_ms",
"step_ms"}: the least-squares fit of device ms = fixed + T x step over the
T whose device ms was measured, what a short call costs before its steps
and what each step adds.  --library also times one torch.nn.LSTM (cuDNN)
call of each kernel's function on the same inputs, TF32 off (the yardstick
only; the port never calls it): kernel "<kernel>:nn.LSTM", rows null, ms
null where the card's memory refuses it.  --split (the wide path, a width
past 256) times the recurrence's step with its parts switched off: it builds
lstm_wide.cu once more for each mask of SPLIT_MASKS with -DAWM_WIDE_SPLIT=mask
(1 the row group's barrier, 2 the staging of h / da, 4 the recurrent product,
8 the rest of the step; all builds in parallel, the library the port loads
has none), puts each in the port's place in turn and prints, for A's and C's
recurrence at one row a group (B=1) and at 32 (B=32), fp32 and bf16, one
line {"tree", "card", "kernel", "width", "steps", "batch", "rows", "split",
"off", "device_ms", "us_a_step"}: the recurrence launches' device ms (the
other launches of the call left out) and over T.  --hash prints, for every
(D, H) of HASH_SHAPES (each path: the capacities, masked, cluster, wide) at
each (B, T) of HASH_BT, fp32 and bf16, one line per kernel {"tree", "card",
"kernel", "d", "h", "batch", "steps", "sha256"}: the hash of the bytes of
its outputs (A: y; B: y, c_{t-1}; C: dx, dW_ih, dW_hh, db) from seeded
inputs, the same in every checkout; --against FILE (another tree's --hash
lines) adds "same" to each line and a last line {"tree", "against",
"same", "of", "differ"}, and exits 1 where any output's bits differ.
--gates builds lstm_wide.cu with -DAWM_WIDE_GATES=1 and holds C's wide fp32
gate pass to the gates kernel B formed, bit for bit, at GATES_CASES (one
line each, gates_check); it exits 1 where any differ.
Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

STEPS = {64: 16000, 32: 50, 16: 32}  # the main paths' T at each width (16000 at any other)
# --split: the parts of a wide recurrence's step switched off (lstm_wide.cu's AWM_WIDE_SPLIT bits)
SPLIT_PARTS = {1: "barrier", 2: "staging", 4: "product", 8: "rest"}
SPLIT_MASKS = (0, 1, 2, 4, 8, 15)
# --check's shapes: T around the ring's 16-step chunks and the short path's
# bound (64 at width 32).
CHECK_B, CHECK_T = (1, 7, 128), (1, 2, 3, 15, 16, 17, 37, 50, 64, 65, 800)
# --hash's (D, H): the capacities' squares, masked (48, 40 x 24, 33 x 33:
# capacity 48; 56 x 56: capacity 64; 24 x 24, 20 x 32, 32 x 20: capacity 32;
# 12 x 12, 9 x 3: capacity 16), the cluster
# path (96, 128, 256, 200 x 8), the wide path (257, 512, 40 x 600, 300 x 40);
# (B, T): a ragged batch over several ring chunks (T past the short and
# fused paths' 64), a batch of full row groups (T = 17, within them).
HASH_SHAPES = ((16, 16), (32, 32), (64, 64), (48, 48), (40, 24), (33, 33), (56, 56), (24, 24), (20, 32), (32, 20),
               (12, 12), (9, 3), (96, 96), (128, 128), (256, 256), (200, 8), (257, 257), (512, 512), (40, 600),
               (300, 40))
HASH_BT = ((7, 65), (32, 17))


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


def kernel_split(torch, fn, reps: int = 5) -> dict[str, float]:
    """Device ms by kernel name of one call of fn (torch.profiler over reps
    calls): each kernel's mean over the launches the trace holds, times its
    launches a call.  The profiler drops a kernel of a window now and then,
    most often its first, so a window's sum over reps would read low."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
    return {e.key: dev_us(e) / 1e3 / e.count * max(1, round(e.count / reps)) for e in prof.key_averages()
            if dev_us(e) > 0 and e.self_cpu_time_total == 0}


def device_ms(torch, fn, reps: int) -> float | None:
    """Device ms of one call of fn in the LSTM kernels alone: at T=50 a
    call's CUDA-event time is the host's (allocations, casts, the launch),
    and only this tells the rows variants apart.  A trace without them is
    taken again, three times at most, then None (not measured), never 0."""
    for _ in range(3):
        ms = sum(ms for key, ms in kernel_split(torch, fn, reps).items() if "lstm_" in key)
        if ms > 0:
            return ms
    return None


def inputs(torch, b: int, t: int, dtype, seed: int, width: int = 64, hidden: int | None = None):
    """Seeded x (B, T, D = width), weights at torch's LSTM init scale
    U(+-1/sqrt(H)) (H = hidden, default width) and an fp32 dy (kernel_dy
    gives it the checkout's kernel C's type)."""
    h = hidden or width
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(b, t, width, device="cuda", generator=g) * 0.5).to(dtype)
    w = [(torch.rand(*s, device="cuda", generator=g) * 2 - 1) / h**0.5
         for s in ((4 * h, width), (4 * h, h), (4 * h,))]
    dy = torch.randn(b, t, h, device="cuda", generator=g) * 0.1
    return x, w[0], w[1], 2 * w[2], dy


def library_ms(torch, kernel: str, x, w_ih, w_hh, bias, dy, reps: int) -> float | None:
    """One torch.nn.LSTM call of kernel's function (b_ih = bias, b_hh = 0)
    by CUDA events, TF32 off: A inference, B the forward under grad, C the
    gradient of y (dy) with respect to x and the weights; None where the
    card's memory refuses it."""
    width = w_hh.shape[1]
    m = torch.nn.LSTM(x.shape[2], width, batch_first=True).cuda()
    with torch.no_grad():
        m.weight_ih_l0.copy_(w_ih)
        m.weight_hh_l0.copy_(w_hh)
        m.bias_ih_l0.copy_(bias)
        m.bias_hh_l0.zero_()
    m = m.to(x.dtype)
    m.flatten_parameters()
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if kernel == "lstm_fwd":
            with torch.inference_mode():
                return cuda_ms(torch, lambda: m(x), reps)
        xg = x.detach().clone().requires_grad_()
        if kernel == "lstm_fwd_train":
            return cuda_ms(torch, lambda: m(xg), reps)
        y = m(xg)[0]
        return cuda_ms(torch, lambda: torch.autograd.grad(y, [xg, *m.parameters()], dy.to(x.dtype),
                                                          retain_graph=True), reps)
    except torch.OutOfMemoryError:
        return None
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul
        del m
        torch.cuda.empty_cache()


def fit_line(ts, ms) -> tuple[float, float] | tuple[None, None]:
    """(fixed, step) of the least-squares line ms = fixed + t x step over
    the pairs whose ms was measured (not None); (None, None) where fewer
    than two distinct t remain."""
    pts = [(t, m) for t, m in zip(ts, ms) if m is not None]
    n = len(pts)
    if len({t for t, _ in pts}) < 2:
        return None, None
    mt, mm = sum(t for t, _ in pts) / n, sum(m for _, m in pts) / n
    step = sum((t - mt) * (m - mm) for t, m in pts) / sum((t - mt) ** 2 for t, _ in pts)
    return mm - step * mt, step


def kernel_dy(K, x, y, cprev, dy, w_ih, w_hh, bias):
    """dy as the checkout's kernel C takes it: in x's dtype, as autograd
    hands it over, or fp32 in a checkout from before that (its kernel C
    refuses any other)."""
    try:
        K.backward_kernel(x, y, cprev, dy.to(x.dtype), w_ih, w_hh, bias)
        return dy.to(x.dtype)
    except ValueError:
        return dy


def output_hashes(torch, K, tree: str, card: str, against: str | None) -> int:
    """--hash: the sha256 of each kernel's outputs at HASH_SHAPES x HASH_BT
    (printed), held to another tree's lines where `against` names them;
    returns the count of outputs whose bits differ."""
    import hashlib

    def digest(*tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    # by kernel and operand type, not by instantiation: a checkout that routes a
    # width to another capacity names it otherwise (48 x 48: lstm_fwd_f32_masked
    # before capacity 48, lstm_fwd_f32_w48 after)
    kind = lambda name: (max((k for k in ("lstm_fwd", "lstm_fwd_train", "lstm_bwd") if name.startswith(k + "_")),
                             key=len), "_bf16" in name)
    key = lambda line: (*kind(line["kernel"]), line["d"], line["h"], line["batch"], line["steps"])
    theirs = {}
    if against:
        with open(against) as f:
            theirs = {key(line): line["sha256"] for line in map(json.loads, f) if "sha256" in line}
    same = differ = 0
    for d, h in HASH_SHAPES:
        for b, t in HASH_BT:
            for dtype in (torch.float32, torch.bfloat16):
                x, w_ih, w_hh, bias, dy = inputs(torch, b, t, dtype, seed=d * 1000 + h + b, width=d, hidden=h)
                y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
                dy = kernel_dy(K, x, y, cprev, dy, w_ih, w_hh, bias)
                outs = {"lstm_fwd": (K.forward_kernel(x, w_ih, w_hh, bias),), "lstm_fwd_train": (y, cprev),
                        "lstm_bwd": K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)}
                for kernel, got in outs.items():
                    line = {"tree": tree, "card": card, "kernel": K.instantiation(kernel, dtype, d, h), "d": d, "h": h,
                            "batch": b, "steps": t, "sha256": digest(*got)}
                    if against:
                        line["same"] = theirs.get(key(line)) == line["sha256"]
                        same, differ = same + line["same"], differ + (not line["same"])
                    print(json.dumps(line), flush=True)
                del x, y, cprev, dy, outs
                torch.cuda.empty_cache()
    if against:
        print(json.dumps({"tree": tree, "against": against, "same": same, "of": same + differ, "differ": differ}),
              flush=True)
    return differ


# --gates: (D, H, B, T, rows a row group, CTAs a group (0: the card's), chunk
# of h (0: the card's)): every rows variant at 512 (whole h), ragged groups,
# chunked h, a tiled group, an H past a multiple of 16 (its last k-tile
# zero-padded), H not a multiple of 4 (one value a load), a narrow H.
GATES_CASES = tuple((512, 512, r, 33, r, 0, 0) for r in (1, 2, 4, 8, 16, 32, 64)) + (
    (512, 512, 7, 33, 4, 0, 0), (512, 512, 40, 21, 32, 0, 64), (512, 512, 5, 19, 8, 7, 0),
    (300, 300, 9, 17, 2, 0, 0), (257, 257, 6, 17, 8, 0, 48), (40, 600, 3, 9, 1, 0, 0), (300, 40, 5, 17, 4, 0, 0))


def gates_check(torch, K, tree: str, card: str) -> int:
    """--gates: lstm_wide.cu built with -DAWM_WIDE_GATES=1; at each of
    GATES_CASES fp32 kernel B keeps the gates it forms, C's fp32 gate pass
    forms them again from B's y, and one line {"tree", "card", "check",
    "d", "h", "batch", "steps", "rows", "ctas", "chunk", "equal",
    "max_abs"} says whether they are the same bits.  Returns the count of
    cases that differ."""
    import ctypes

    from awm_tpu_torch.ops import cuda_build

    lib = ctypes.CDLL(cuda_build.build_all(["lstm_wide"], ("-DAWM_WIDE_GATES=1",))["lstm_wide"][0])
    fn = lib.awm_lstm_wide_gates_check
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p], ctypes.c_int
    differ = 0
    for d, h, b, t, rows, ctas, chunk in GATES_CASES:
        x, w_ih, w_hh, bias, _ = inputs(torch, b, t, torch.float32, seed=d + h + b, width=d, hidden=h)
        f32 = dict(dtype=torch.float32, device=x.device)
        y, cprev = torch.empty(b, t, h, **f32), torch.empty(b, t, h, **f32)
        xp_fwd, xp_c, pre_c = (torch.empty(b, t, 4 * h, **f32) for _ in range(3))
        wpack, c_state = torch.empty(K.wide_pack_elems(False, False, h), **f32), torch.empty(b, h, **f32)
        count = torch.empty(-(-b // rows), dtype=torch.int32, device=x.device)
        err = fn(*(v.data_ptr() for v in (x, w_ih, w_hh, bias, y, cprev, xp_fwd, wpack, c_state, count, xp_c, pre_c)),
                 b, t, d, h, rows, ctas, chunk, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"awm_lstm_wide_gates_check: {lib.awm_cuda_error_string(err).decode()}")
        torch.cuda.synchronize()
        equal = torch.equal(xp_fwd, pre_c)
        differ += not equal
        print(json.dumps({"tree": tree, "card": card, "check": "gates", "d": d, "h": h, "batch": b, "steps": t,
                          "rows": rows, "ctas": ctas, "chunk": chunk, "equal": equal,
                          "max_abs": float((xp_fwd - pre_c).abs().max())}), flush=True)
    return differ


def split_libraries(K, masks) -> dict:
    """lstm_wide.cu built once for each mask with -DAWM_WIDE_SPLIT=mask (all
    nvcc processes at once), loaded with the port's entry points' types."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from awm_tpu_torch.ops import cuda_build

    base = K.libraries()["lstm_wide"]
    with ThreadPoolExecutor(len(masks)) as pool:
        paths = dict(zip(masks, pool.map(lambda m: cuda_build.build_all(["lstm_wide"], (f"-DAWM_WIDE_SPLIT={m}",)),
                                         masks)))
    libs = {}
    for mask, built in paths.items():
        lib = ctypes.CDLL(built["lstm_wide"][0])
        for name in [n for n in K.launches if n.endswith("_wide")] + ["awm_lstm_wide_shape", "awm_lstm_wide_pack_elems",
                                                                      "awm_cuda_error_string"]:
            fn = K.entry_point(name) if name.endswith("_wide") else name
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = getattr(base, fn).argtypes, getattr(base, fn).restype
        libs[mask] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tree", default=here)
    ap.add_argument("--width", type=int, default=64, help="D >= 1 (and H unless --hidden)")
    ap.add_argument("--hidden", type=int, default=None, help="H >= 1 (default: D)")
    ap.add_argument("--steps", type=lambda v: [int(t) for t in v.split(",")], default=None,
                    help="T, or a comma-separated list of T to fit (default: the width's main path)")
    ap.add_argument("--batch", type=int, default=None, help="B of every kernel (default: A 512, B and C 128)")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--paths", action="store_true",
                    help="also time A and B on the ring and C in four launches where the plan takes the others")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default="", help="time only kernels whose name contains this")
    ap.add_argument("--library", action="store_true", help="also time torch.nn.LSTM (cuDNN) on the same inputs")
    ap.add_argument("--split", action="store_true", help="time the wide recurrence's step with parts switched off")
    ap.add_argument("--hash", action="store_true", help="print the sha256 of every kernel's outputs at HASH_SHAPES")
    ap.add_argument("--against", default=None, help="with --hash: another tree's --hash lines to hold them to")
    ap.add_argument("--gates", action="store_true",
                    help="check that the wide fp32 gate pass reproduces kernel B's gates bit for bit")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    width, hidden = args.width, args.hidden or args.width
    sweep = args.steps or [STEPS.get(args.width, 16000) if hidden == width else 16000]
    b_serve, b_train = (args.batch, args.batch) if args.batch else (512, 128)
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
    wide = hasattr(K, "is_wide") and K.is_wide(width, hidden)
    cluster = hasattr(K, "capacity") and K.capacity(width, hidden) is None and not wide
    cap = K.capacity(width, hidden) if hasattr(K, "capacity") else width
    variants = K.WIDE_ROWS if wide else K.CLUSTER_ROWS if cluster else None
    fwd_rows = (variants or getattr(K, "FWD_ROWS", (None,))) if args.variants else (None,)
    bwd_rows = (variants or getattr(K, "BWD_ROWS", (None,))) if args.variants else (None,)
    if None not in fwd_rows:
        fwd_rows, bwd_rows = (None, *fwd_rows), (None, *bwd_rows)
    has_short = hasattr(K, "FWD_SHORT_MAX_STEPS") and cap in getattr(K, "SHORT_WIDTHS", (32,))
    has_fused = "fused" in inspect.signature(K.backward_kernel).parameters and cap in K.FUSED_WIDTHS
    if (width, hidden) != (cap, cap) and not hasattr(K, "MASKED_SHORT_DTYPES"):
        has_short = has_fused = False  # a checkout from before the masked short and fused paths
    kw = lambda rows: {} if rows is None else {"rows": rows}
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}

    # A checkout from before the width-32 kernels names its width-64 ones so.
    sfx_of = {dtype: sfx for sfx, dtype in dtypes.items()}
    named = getattr(K, "instantiation", lambda kernel, dtype, w, h=None: f"{kernel}_{sfx_of[dtype]}")
    name = lambda kernel, dtype, w: named(kernel, dtype, w) if hidden == w else named(kernel, dtype, w, hidden)
    failed = 0
    if args.check:
        print(K.build_log, flush=True)
        err = lambda a, r: float((a.float() - r.float()).abs().max())
        for sfx, dtype in dtypes.items():
            tol_a, tol_b, tol_c = (K.KERNEL_TOL[k, sfx] for k in K.KERNELS)
            for b in CHECK_B:
                for t in CHECK_T:
                    x, w_ih, w_hh, bias, dy = inputs(torch, b, t, dtype, seed=b * 1000 + t, width=width, hidden=hidden)
                    ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
                    dy = kernel_dy(K, x, ref_y, ref_c, dy, w_ih, w_hh, bias)
                    err_a = err_b = 0.0
                    same = True  # the short path gives the ring path's bits
                    paths = (False, True) if has_short and t <= K.FWD_SHORT_MAX_STEPS else (None,)
                    for rows in fwd_rows:
                        got = {}
                        for short in paths:
                            pk = {} if short is None else {"short": short}
                            y0 = K.forward_kernel(x, w_ih, w_hh, bias, **kw(rows), **pk)
                            y, c = K.forward_train_kernel(x, w_ih, w_hh, bias, **kw(rows), **pk)
                            err_a, err_b = max(err_a, err(y0, ref_y)), max(err_b, err(y, ref_y), err(c, ref_c))
                            got[short] = (y0, y, c)
                        if len(got) == 2:
                            same &= all(torch.equal(a, b) for a, b in zip(got[False], got[True]))
                    ref_g = lstm_backward(x, ref_y, ref_c, dy, w_ih, w_hh, bias)
                    rel = 0.0
                    bwd_paths = ({}, {"fused": False}) if has_fused and t <= K.FUSED_MAX_STEPS else ({},)
                    for rows in bwd_rows:
                        for pk in bwd_paths:
                            got = K.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, **kw(rows), **pk)
                            rel = max(rel, *(err(g, r) / (float(r.float().abs().max()) + 1e-12)
                                             for g, r in zip(got, ref_g)))
                    torch.cuda.synchronize()
                    bad = err_a > tol_a or err_b > tol_b or rel > tol_c or not same
                    failed += bad
                    print(f"check{' FAIL' if bad else ''} {sfx} D={width} H={hidden} B={b} T={t} rows {fwd_rows} / "
                          f"{bwd_rows}: A max abs {err_a:.3e} (tol {tol_a:.0e}), B {err_b:.3e} (tol "
                          f"{tol_b:.0e}); C max rel {rel:.3e} (tol {tol_c:.0e})"
                          + (f"; the short path gives the ring's bits: {same}"
                             if len(paths) == 2 else ""),
                          flush=True)

    swept = {}  # (kernel, batch, rows) -> {T: device ms}, for the fit

    def cluster_waves(kernel, batch, rows, dtype):
        """Waves of clusters of a call on the cluster path at the card's
        reading of the clusters it holds (rows None: the plan's), else None."""
        if not cluster or not hasattr(K, "_cluster_slots"):
            return None
        slots = K._cluster_slots(torch.cuda.current_device(), dtype, width, hidden)
        sm_count = torch.cuda.get_device_properties(0).multi_processor_count
        plan = K.launch_plan(batch, steps, dtype, sm_count, width, None, hidden, slots)
        bwd = kernel.startswith("lstm_bwd")
        r = rows or (plan.bwd_rows if bwd else plan.fwd_rows)
        return -(-(-(-batch // r)) // dict(zip(K.CLUSTER_ROWS, slots[bwd]))[r])

    def wide_launches(kernel, batch, rows, dtype):
        """Cooperative launches of row groups a window takes on the wide path
        at the card's reading of the CTAs it holds (rows None: the plan's)."""
        slots = K._wide_slots(torch.cuda.current_device(), dtype, hidden)
        sm_count = torch.cuda.get_device_properties(0).multi_processor_count
        plan = K.launch_plan(batch, steps, dtype, sm_count, width, hidden=hidden, wide_slots=slots)
        bwd = kernel.startswith("lstm_bwd")
        r = rows or (plan.bwd_rows if bwd else plan.fwd_rows)
        at_once = dict(zip(K.WIDE_ROWS, slots[bwd])).get(r, 0)
        ctas = K.wide_ctas(-(-hidden // K.WIDE_UNITS), at_once)
        return -(-(-(-batch // r)) // (at_once // ctas)) if ctas else None

    def held(rows, dtype, bwd: bool) -> bool:
        """Whether the card holds a row group of this many rows on the wide
        path with W_hh's slice where the plan would take it (always True
        elsewhere, and for the plan's own rows)."""
        if not wide or rows is None:
            return True
        slots = dict(zip(K.WIDE_ROWS, K._wide_slots(torch.cuda.current_device(), dtype, hidden)[bwd]))
        return slots[rows] >= 1

    def path_of(kernel, batch, rows, dtype, path):
        """The path a call takes in a checkout with device_plan: the forced
        one, else the plan's (None in an older checkout)."""
        if path is not None or dtype is None or not hasattr(K, "device_plan"):
            return path
        bwd = kernel.startswith("lstm_bwd")
        plan = K.device_plan(batch, steps, dtype, torch.cuda.current_device(), width, hidden, rows if bwd else None)
        if plan.wide or plan.cluster:
            return "wide" if plan.wide else "cluster"
        if bwd:
            return "fused" if plan.bwd_fused else "four"
        return "short" if plan.fwd_short else "ring"

    def report(kernel, batch, rows, ms, fn=None, dtype=None, path=None):
        line = {"tree": tree, "card": card, "kernel": kernel, "width": width, "steps": steps,
                "batch": batch, "rows": rows, "ms": ms}
        if hidden != width:
            line["hidden"] = hidden
        if hasattr(K, "device_plan") and dtype is not None:
            line["path"] = path_of(kernel, batch, rows, dtype, path)
        if dtype is not None and cluster:
            line["waves"] = cluster_waves(kernel, batch, rows, dtype)
        if dtype is not None and wide:
            line["launches"] = wide_launches(kernel, batch, rows, dtype)
        if fn is not None and (args.variants or len(sweep) > 1):
            line["device_ms"] = device_ms(torch, fn, min(args.reps, 50))
            swept.setdefault((kernel, batch, rows), {})[steps] = line["device_ms"]
        print(json.dumps(line), flush=True)

    want = lambda name: args.only in name
    if args.hash:
        return 1 if output_hashes(torch, K, tree, card, args.against) else 0
    if args.gates:
        return 1 if gates_check(torch, K, tree, card) else 0
    if args.split:
        if not wide:
            print("bench_lstm: --split times the wide path (a width past 256)", file=sys.stderr)
            return 1
        libs, base = split_libraries(K, SPLIT_MASKS), K.libraries()["lstm_wide"]
        steps = sweep[0]
        try:
            for sfx, dtype in dtypes.items():
                for batch in (1, 32):
                    x, w_ih, w_hh, bias, dy = inputs(torch, batch, steps, dtype, seed=9, width=width, hidden=hidden)
                    y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
                    dy = dy.to(dtype)
                    calls = {name("lstm_fwd", dtype, width): ("lstm_wide_fwd", lambda: K.forward_kernel(
                                 x, w_ih, w_hh, bias, rows=batch)),
                             name("lstm_bwd", dtype, width): ("lstm_wide_bwd", lambda: K.backward_kernel(
                                 x, y, cprev, dy, w_ih, w_hh, bias, rows=batch))}
                    for mask, lib in libs.items():
                        K._libs["lstm_wide"] = lib
                        for kernel, (frag, fn) in calls.items():
                            if not want(kernel):
                                continue
                            ms = None
                            for _ in range(3):
                                ms = sum(v for k, v in kernel_split(torch, fn, args.reps).items() if frag in k) or None
                                if ms:
                                    break
                            print(json.dumps({"tree": tree, "card": card, "kernel": kernel, "width": width,
                                              "steps": steps, "batch": batch, "rows": batch, "split": mask,
                                              "off": [p for bit, p in SPLIT_PARTS.items() if mask & bit],
                                              "device_ms": ms, "us_a_step": None if ms is None else 1e3 * ms / steps}),
                                  flush=True)
                    K._libs["lstm_wide"] = base
                    del x, y, cprev, dy
                    torch.cuda.empty_cache()
        finally:
            K._libs["lstm_wide"] = base
        return 0
    for steps in sweep:
        for sfx, dtype in dtypes.items():
            fwd, fwd_train, bwd = (name(k, dtype, width) for k in ("lstm_fwd", "lstm_fwd_train", "lstm_bwd"))
            x, w_ih, w_hh, bias, _ = inputs(torch, b_serve, steps, dtype, seed=7, width=width, hidden=hidden)
            other_fwd = args.paths and has_short and steps <= K.FWD_SHORT_MAX_STEPS
            other_bwd = args.paths and has_fused and steps <= K.FUSED_MAX_STEPS
            for rows in fwd_rows if want(fwd) else ():
                if not held(rows, dtype, False):
                    continue
                fn = lambda: K.forward_kernel(x, w_ih, w_hh, bias, **kw(rows))
                report(fwd, b_serve, rows, cuda_ms(torch, fn, args.reps), fn, dtype)
                if other_fwd:
                    short = path_of(fwd, b_serve, rows, dtype, None) == "ring"
                    fn = lambda: K.forward_kernel(x, w_ih, w_hh, bias, **kw(rows), short=short)
                    report(fwd, b_serve, rows, cuda_ms(torch, fn, args.reps), fn, dtype, "short" if short else "ring")
            if args.library and want(fwd):
                report(f"{fwd}:nn.LSTM", b_serve, None, library_ms(torch, "lstm_fwd", x, w_ih, w_hh, bias, None,
                                                                   args.reps))
            del x
            x, w_ih, w_hh, bias, dy = inputs(torch, b_train, steps, dtype, seed=8, width=width, hidden=hidden)
            y, cprev = K.forward_train_kernel(x, w_ih, w_hh, bias)
            dy = kernel_dy(K, x, y, cprev, dy, w_ih, w_hh, bias)
            for rows in fwd_rows if want(fwd_train) else ():
                if not held(rows, dtype, False):
                    continue
                fn = lambda: K.forward_train_kernel(x, w_ih, w_hh, bias, **kw(rows))
                report(fwd_train, b_train, rows, cuda_ms(torch, fn, args.reps), fn, dtype)
                if other_fwd:
                    short = path_of(fwd_train, b_train, rows, dtype, None) == "ring"
                    fn = lambda: K.forward_train_kernel(x, w_ih, w_hh, bias, **kw(rows), short=short)
                    report(fwd_train, b_train, rows, cuda_ms(torch, fn, args.reps), fn, dtype,
                           "short" if short else "ring")
            for kernel, what in (("lstm_fwd_train", fwd_train), ("lstm_bwd", bwd)) if args.library else ():
                if want(what):
                    report(f"{what}:nn.LSTM", b_train, None,
                           library_ms(torch, kernel, x, w_ih, w_hh, bias, dy, args.reps))
            if want(bwd):
                for rows in bwd_rows:
                    if not held(rows, dtype, True):
                        continue
                    fn = lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias, **kw(rows))
                    report(bwd, b_train, rows, cuda_ms(torch, fn, args.reps), fn, dtype)
                    if other_bwd:
                        fn = lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias, **kw(rows), fused=False)
                        report(bwd, b_train, rows, cuda_ms(torch, fn, args.reps), fn, dtype, "four")
                # C's launches apart: at the plan's rows, and on the cluster and wide paths at every variant
                for rows in [r for r in bwd_rows if held(r, dtype, True)] if cluster or wide else (None,):
                    split = kernel_split(torch, lambda: K.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias,
                                                                          **kw(rows)))
                    for key, ms in split.items():
                        if "lstm_bwd" in key or "lstm_wide" in key:
                            short = key[key.index("lstm_"):].split("(")[0]
                            report(f"{bwd}:{short}", b_train, rows, ms, None, dtype)
            del x, y, cprev, dy
            torch.cuda.empty_cache()
    if len(sweep) > 1:
        for (kernel, batch, rows), by_t in swept.items():
            fixed, step = fit_line(list(by_t), list(by_t.values()))
            print(json.dumps({"tree": tree, "card": card, "kernel": kernel, "width": width, "hidden": hidden,
                              "batch": batch, "rows": rows, "steps": list(by_t), "device_ms": list(by_t.values()),
                              "fixed_ms": fixed, "step_ms": step}), flush=True)
    if failed:
        print(f"bench_lstm: {failed} check(s) above tolerance", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
