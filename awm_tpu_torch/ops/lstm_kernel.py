"""Wrappers of the CUDA LSTM kernels, their routing, and the autograd Function.

Three TPU kernels of awm_tpu/ops/pallas/lstm_kernel.py have a counterpart:
- A, lstm_pallas_forward (pallas_call at line 157): forward_kernel,
  ops/csrc/lstm_fwd.cu, instantiations lstm_fwd_{f32,bf16};
- B, _forward_train (line 342): forward_train_kernel, the same source with
  its TRAIN flag, instantiations lstm_fwd_train_{f32,bf16};
- C, _backward (line 391): backward_kernel, ops/csrc/lstm_bwd.cu,
  instantiations lstm_bwd_{f32,bf16}.
On that card each is bound by the latency of one step of the 16000-step
recurrence, not by bytes or FLOPs.  What the designs do about it (the
sources' headers have the detail): a block owns a few batch rows and runs
all T steps; every weight of the recurrence sits in a register for the whole
launch; the work of a step that does not depend on the carried state (the
input projection in A and B, the whole gate recompute in C) is done by
producer warps that run ahead and hand it over through a ring in shared
memory; one barrier separates two steps.  The bf16 instantiations put every
product on the tensor cores (mma.sync: bf16 in, exact products, fp32 sums),
the recurrent one with the block's rows as the tile's N; the fp32 ones stay
on the CUDA cores in full fp32, no TF32.

The launch plan (launch_plan) is computed here, in Python, from the batch and
the card's SM count, and handed to the C entry points: rows per block (1, 2
or 4 forward, 1 or 2 backward: the rows that finish the batch soonest, by
the waves of blocks the card needs and the measured cost of a step of that
many rows, so B=128 takes 128 blocks of one row and B=512 128 blocks of
four), the backward's scratch shapes and its dx and dW grids.

Routing (lstm_fused_forward), by grad first and then by device:
- grad needed (grad mode on and any of x, w_ih, w_hh, b requires grad):
  LSTMFunction, the counterpart of the JAX package's lstm_fused custom_vjp.
  Its forward runs B and its backward C: the kernels on a CUDA tensor, their
  plain versions (ops/lstm.py) on a CPU one, so the CPU tests exercise the
  hand-written backward arithmetic rather than autograd of the loop;
- no grad: kernel A on a CUDA tensor, the plain recurrence on a CPU one.
No path returns a detached result while a gradient is needed, and there is
no fallback from a kernel to its plain version: a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from awm_tpu_torch.ops import cuda_build
from awm_tpu_torch.ops.lstm import (
    lstm_backward,
    lstm_forward,
    lstm_forward_train,
    matmul_dtype,
)

INPUT = 64  # D the kernels are compiled for
HIDDEN = 64  # H the kernels are compiled for
GATES = 4 * HIDDEN
SOURCES = ("lstm_fwd", "lstm_bwd")  # ops/csrc/<name>.cu, one library each

# Launches of each instantiation since import (or since a caller zeroed
# them); chip_smoke.py reads them to show that the main paths went through
# the kernels.  A call counts once: a forward call is one launch, a backward
# call four (the recurrence, dx, dW, the ordered sum).
launches = {
    "lstm_fwd_f32": 0, "lstm_fwd_bf16": 0,
    "lstm_fwd_train_f32": 0, "lstm_fwd_train_bf16": 0,
    "lstm_bwd_f32": 0, "lstm_bwd_bf16": 0,
}

_libs: dict[str, ctypes.CDLL] = {}
build_log = ""

# Rows per block each recurrent kernel is instantiated for, with the time of
# one step of a block of that many rows relative to a block of one row
# (measured with ops/bench_lstm.py --variants on an H100, T=16000; PERF.md
# has the times).  A step is bound by latency, so a second row costs less
# than the first, but not nothing.
FWD_STEP_COST = {
    torch.float32: {1: 1.0, 2: 1.32, 4: 2.4},
    torch.bfloat16: {1: 1.0, 2: 1.08, 4: 1.3},
}
BWD_STEP_COST = {
    torch.float32: {1: 1.0, 2: 2.1},
    torch.bfloat16: {1: 1.0, 2: 1.58},
}
FWD_ROWS = tuple(FWD_STEP_COST[torch.float32])
BWD_ROWS = tuple(BWD_STEP_COST[torch.float32])
DW_CHUNK_ROWS = 2048  # least rows of the (B*T) axis per dW chunk
DW_MAX_CHUNKS = 256
DX_TILE_ROWS = 32  # lstm_bwd.cu's DX_ROWS


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one (batch, steps, dtype) call is cut over a card of sm_count SMs."""

    fwd_rows: int  # batch rows per block, kernels A and B
    fwd_blocks: int
    bwd_rows: int  # batch rows per block, kernel C's recurrent kernel
    bwd_blocks: int
    n_chunks: int  # chunks of the (B*T) axis, kernel C's dW partials
    dx_blocks: int  # grid of kernel C's dx kernel (it strides over row tiles)
    da_shape: tuple[int, int, int]  # scratch: da in the operand type
    da_dtype: torch.dtype
    part_shape: tuple[int, int, int]  # scratch: dW chunk partials, fp32
    db_part_shape: tuple[int, int]  # scratch: db per recurrent block, fp32


def _rows_per_block(batch: int, sm_count: int, step_cost: dict[int, float]) -> int:
    """Rows per block that finish the batch soonest.  A recurrent kernel
    keeps one block on an SM for all T steps, so the blocks run in
    ceil(blocks / sm_count) waves and a call costs waves x the step cost of
    that many rows.  Ties go to fewer rows.  B=128 on 132 SMs takes 128
    blocks of one row; B=512 one wave of 128 blocks of four rows."""
    def cost(rows: int) -> float:
        return -(-(-(-batch // rows)) // sm_count) * step_cost[rows]

    return min(step_cost, key=lambda rows: (cost(rows), rows))


def launch_plan(batch: int, steps: int, dtype: torch.dtype, sm_count: int) -> LaunchPlan:
    """The plan of one call: pure, so the CPU tests reach it."""
    if batch < 1 or steps < 1 or sm_count < 1:
        raise ValueError(f"launch_plan takes batch, steps, sm_count >= 1, got {batch}, {steps}, {sm_count}")
    mm = matmul_dtype(dtype)
    fwd_rows = _rows_per_block(batch, sm_count, FWD_STEP_COST[mm])
    bwd_rows = _rows_per_block(batch, sm_count, BWD_STEP_COST[mm])
    bwd_blocks = -(-batch // bwd_rows)
    n_rows = batch * steps
    n_chunks = max(1, min(DW_MAX_CHUNKS, -(-n_rows // DW_CHUNK_ROWS)))
    return LaunchPlan(
        fwd_rows=fwd_rows, fwd_blocks=-(-batch // fwd_rows),
        bwd_rows=bwd_rows, bwd_blocks=bwd_blocks,
        n_chunks=n_chunks, dx_blocks=max(1, min(-(-n_rows // DX_TILE_ROWS), 2 * sm_count)),
        da_shape=(batch, steps, GATES), da_dtype=mm,
        part_shape=(n_chunks, GATES, INPUT + HIDDEN), db_part_shape=(bwd_blocks, GATES),
    )


def _plan_for(x: torch.Tensor) -> LaunchPlan:
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    return launch_plan(x.shape[0], x.shape[1], x.dtype, sm_count)


def libraries() -> dict[str, ctypes.CDLL]:
    """Build (every source at once, one nvcc each) and load the kernel
    libraries, once per process."""
    global build_log
    if not _libs:
        built = cuda_build.load_all(SOURCES)
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fwd, bwd = built["lstm_fwd"][0], built["lstm_bwd"][0]
        for fn in (fwd.awm_lstm_fwd_f32, fwd.awm_lstm_fwd_bf16):
            fn.argtypes = [ptr] * 5 + [i, i, i, ptr]
        for fn in (fwd.awm_lstm_fwd_train_f32, fwd.awm_lstm_fwd_train_bf16):
            fn.argtypes = [ptr] * 6 + [i, i, i, ptr]
        for fn in (bwd.awm_lstm_bwd_f32, bwd.awm_lstm_bwd_bf16):
            fn.argtypes = [ptr] * 14 + [i, i, i, i, i, ptr]
        for fn in (fwd.awm_lstm_fwd_f32, fwd.awm_lstm_fwd_bf16, fwd.awm_lstm_fwd_train_f32,
                   fwd.awm_lstm_fwd_train_bf16, bwd.awm_lstm_bwd_f32, bwd.awm_lstm_bwd_bf16):
            fn.restype = ctypes.c_int
        for lib in (fwd, bwd):
            lib.awm_cuda_error_string.argtypes = [ctypes.c_int]
            lib.awm_cuda_error_string.restype = ctypes.c_char_p
        build_log = "\n".join(f"== {name}.cu\n{built[name][1]}" for name in SOURCES)
        _libs.update({name: built[name][0] for name in SOURCES})
    return _libs


def _check_x_weights(x, w_ih, w_hh, b):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"lstm kernel takes float32 or bfloat16 x, got {x.dtype}")
    if x.dim() != 3 or x.shape[2] != INPUT:
        raise ValueError(f"lstm kernel takes x of shape (B, T, {INPUT}), got {tuple(x.shape)}")
    for name, t, shape in (
        ("w_ih", w_ih, (GATES, INPUT)), ("w_hh", w_hh, (GATES, HIDDEN)), ("b", b, (GATES,)),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"lstm kernel takes {name} of shape {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("lstm kernel takes a contiguous x")
    if max(x.shape[0], x.shape[1]) >= 2**31:
        raise ValueError("lstm kernel takes B and T below 2**31 (C int arguments)")


def _check_stream(name, t, shape, dtype, device):
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
        raise ValueError(
            f"lstm kernel takes {name} {shape} {dtype} on {device}, "
            f"got {tuple(t.shape)} {t.dtype} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"lstm kernel takes a contiguous {name}")


def _operands(x, w_ih, w_hh, b):
    mm = matmul_dtype(x.dtype)
    return mm, w_ih.to(mm).contiguous(), w_hh.to(mm).contiguous(), b.to(torch.float32).contiguous()


def _launch(lib_name: str, name: str, x: torch.Tensor, *args) -> None:
    lib = libraries()[lib_name]
    with torch.cuda.device(x.device):
        err = getattr(lib, f"awm_{name}")(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.awm_cuda_error_string(err).decode()}")
    launches[name] += 1


def _suffix(mm: torch.dtype) -> str:
    return "bf16" if mm == torch.bfloat16 else "f32"


def forward_kernel(x, w_ih, w_hh, b, rows: int | None = None) -> torch.Tensor:
    """Kernel A: (B, T, 64) -> y (B, T, 64) in x's dtype, on the card.
    rows overrides the plan's rows per block (for tests and timing)."""
    _check_x_weights(x, w_ih, w_hh, b)
    bsz, t, _ = x.shape
    y = torch.empty(bsz, t, HIDDEN, dtype=x.dtype, device=x.device)
    if bsz == 0 or t == 0:
        return y
    mm, w_ih, w_hh, b = _operands(x, w_ih, w_hh, b)
    _launch("lstm_fwd", f"lstm_fwd_{_suffix(mm)}", x, x.data_ptr(), w_ih.data_ptr(),
            w_hh.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, t, rows or _plan_for(x).fwd_rows)
    return y


def forward_train_kernel(
    x, w_ih, w_hh, b, rows: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B: (B, T, 64) -> (y in x's dtype, cprev fp32), both
    (B, T, 64), on the card.  rows as in forward_kernel."""
    _check_x_weights(x, w_ih, w_hh, b)
    bsz, t, _ = x.shape
    y = torch.empty(bsz, t, HIDDEN, dtype=x.dtype, device=x.device)
    cprev = torch.empty(bsz, t, HIDDEN, dtype=torch.float32, device=x.device)
    if bsz == 0 or t == 0:
        return y, cprev
    mm, w_ih, w_hh, b = _operands(x, w_ih, w_hh, b)
    _launch("lstm_fwd", f"lstm_fwd_train_{_suffix(mm)}", x, x.data_ptr(), w_ih.data_ptr(),
            w_hh.data_ptr(), b.data_ptr(), y.data_ptr(), cprev.data_ptr(), bsz, t,
            rows or _plan_for(x).fwd_rows)
    return y, cprev


def backward_kernel(x, y, cprev, dy, w_ih, w_hh, b, rows: int | None = None):
    """Kernel C: (dx in x's dtype, dW_ih, dW_hh, db fp32) on the card.
    y and cprev are forward_train_kernel's outputs, dy is fp32 (B, T, 64).
    Scratch, shaped by the plan: da (B, T, 256) in the operand type, chunk
    partials of dW, db per recurrent block.  rows overrides the plan's rows
    per block of the recurrent kernel (for tests and timing)."""
    _check_x_weights(x, w_ih, w_hh, b)
    bsz, t, _ = x.shape
    shape = (bsz, t, HIDDEN)
    _check_stream("y", y, shape, x.dtype, x.device)
    _check_stream("cprev", cprev, shape, torch.float32, x.device)
    _check_stream("dy", dy, shape, torch.float32, x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.zeros_like(x)
    dw_ih, dw_hh = torch.zeros(GATES, INPUT, **f32), torch.zeros(GATES, HIDDEN, **f32)
    db = torch.zeros(GATES, **f32)
    if bsz == 0 or t == 0:
        return dx, dw_ih, dw_hh, db
    mm, w_ih, w_hh, b = _operands(x, w_ih, w_hh, b)
    plan = _plan_for(x)
    if rows is not None:
        plan = dataclasses.replace(plan, bwd_rows=rows, bwd_blocks=-(-bsz // rows),
                                   db_part_shape=(-(-bsz // rows), GATES))
    da = torch.empty(plan.da_shape, dtype=plan.da_dtype, device=x.device)
    part = torch.empty(plan.part_shape, **f32)
    db_part = torch.empty(plan.db_part_shape, **f32)
    _launch("lstm_bwd", f"lstm_bwd_{_suffix(mm)}", x,
            x.data_ptr(), y.data_ptr(), cprev.data_ptr(), dy.data_ptr(), w_ih.data_ptr(),
            w_hh.data_ptr(), b.data_ptr(), dx.data_ptr(), dw_ih.data_ptr(), dw_hh.data_ptr(),
            db.data_ptr(), da.data_ptr(), part.data_ptr(), db_part.data_ptr(), bsz, t,
            plan.bwd_rows, plan.n_chunks, plan.dx_blocks)
    return dx, dw_ih, dw_hh, db


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU one (the plain
    versions); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"lstm kernels run on cuda (or cpu via the plain versions), got {x.device}")


def forward_train(x, w_ih, w_hh, b):
    """(y, cprev): kernel B on the card, lstm_forward_train on the CPU."""
    if _on_card(x):
        return forward_train_kernel(x, w_ih, w_hh, b)
    return lstm_forward_train(x, w_ih, w_hh, b)


def backward(x, y, cprev, dy, w_ih, w_hh, b):
    """(dx, dW_ih, dW_hh, db): kernel C on the card, lstm_backward on the CPU."""
    if _on_card(x):
        return backward_kernel(x, y, cprev, dy, w_ih, w_hh, b)
    return lstm_backward(x, y, cprev, dy, w_ih, w_hh, b)


class LSTMFunction(torch.autograd.Function):
    """The LSTM with its hand-written backward (counterpart of lstm_fused's
    _fused_fwd / _fused_bwd, awm_tpu/ops/pallas/lstm_kernel.py:438-461).

    Saved for the backward: x in its own dtype, y (which doubles as the
    h_{t-1} history) and the fp32 c_{t-1} history.  The backward casts dy to
    fp32 and returns each gradient in its primal's dtype: dx in x's (bf16
    under mixed precision), the weight gradients in the weights' (fp32)."""

    @staticmethod
    def forward(ctx, x, w_ih, w_hh, b):
        y, cprev = forward_train(x, w_ih, w_hh, b)
        ctx.save_for_backward(x, y, cprev, w_ih, w_hh, b)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, cprev, w_ih, w_hh, b = ctx.saved_tensors
        dx, dw_ih, dw_hh, db = backward(
            x, y, cprev, dy.to(torch.float32).contiguous(), w_ih, w_hh, b
        )
        return dx.to(x.dtype), dw_ih.to(w_ih.dtype), dw_hh.to(w_hh.dtype), db.to(b.dtype)


def lstm_fused_forward(
    x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """(B, T, D) -> (B, T, H), zero initial state, torch param layout
    (w_ih: (4H, D), w_hh: (4H, H), b: (4H,) = b_ih + b_hh).  Output dtype is
    x's; fp32 and bf16 follow the precision contract of ops/lstm.py.  Routed
    as the module doc says."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w_ih, w_hh, b)):
        return LSTMFunction.apply(x, w_ih, w_hh, b)
    if _on_card(x):
        return forward_kernel(x, w_ih, w_hh, b)
    return lstm_forward(x, w_ih, w_hh, b)
