"""Wrappers of the CUDA LSTM kernels, their routing, and the autograd Function.

Three TPU kernels of awm_tpu/ops/pallas/lstm_kernel.py have a counterpart:
- A, lstm_pallas_forward (pallas_call at line 157): forward_kernel,
  ops/csrc/lstm_fwd.cu, instantiations lstm_fwd_{f32,bf16}[_w48|_w32|_w16] (above
  width 64 ops/csrc/lstm_fwd_cluster.cu, lstm_fwd_{f32,bf16}_cluster; above
  256 ops/csrc/lstm_wide.cu, lstm_fwd_{f32,bf16}_wide);
- B, _forward_train (line 342): forward_train_kernel, the same sources with
  their TRAIN flag, instantiations lstm_fwd_train_{f32,bf16}[_w48|_w32|_w16|_cluster|_wide];
- C, _backward (line 391): backward_kernel, ops/csrc/lstm_bwd.cu (above 256
  lstm_wide.cu), instantiations lstm_bwd_{f32,bf16}[_w48|_w32|_w16|_cluster|_wide].
Each takes any input width D and hidden width H >= 1 (x's last axis and
w_hh's second), as the TPU kernels do; a width of 0 raises.  Up to
CLUSTER_MAX_WIDTH = 256 every weight of the recurrence sits on chip, so the
kernels are compiled for the capacities W of WIDTHS: 64 (the base family,
no suffix), 48 (suffix _w48: the base family at channels 33-48 on a block
of 384 threads, not the width-64 block's 512), 32 (the strided family,
suffix _w32) and 16 (the gradient check of entry.dryrun_multichip, suffix
_w16: at T <= 64 the short forward and the one-launch backward, as at 32,
the backward's residency read from the card).  A call takes the
smallest capacity with max(D, H) <= W, the same for A, B and C: at D = H =
W it is the square instantiation, else the same one with D and H passed at
run time (its weights load zeros past the real widths, a padded unit stays
exactly zero; counted as *_masked, e.g. lstm_bwd_f32_w48_masked at 40 x
24), and the four-launch backward's dx, dW and sum run at the runtime
widths (bf16 on the tensor cores; at capacity 48 at 48 x 48 too).  At
capacities 32 and 16 a masked call at T <= 64 takes its square call's
fused backward, and in bf16 its short forward (fp32's masked short forward
is built and held, but measured slower than the masked ring, so the plan
keeps the ring there: MASKED_SHORT_DTYPES), in the capacity's layout.  Capacity 48 sums in
capacity 64's order less terms that are exactly zero (a quad of the gate
products, four lanes of C's dh product), so a call gives the same bits at
either.  Above 64 a call runs on a
thread-block cluster of ceil(H / 32) CTAs of 32 hidden units each, which
carries 1, 2, 4 or 8 batch rows, h (and in the backward da) exchanged
between them through distributed shared memory every step in row bursts
(instantiations *_cluster, lstm_fwd_cluster.cu and lstm_bwd.cu, "widths above
64"); the backward's gates, activations and local derivatives come from a
whole-card gate pass before its recurrence, in windows of time whose
scratch stays within CLUSTER_SCRATCH_BYTES whatever B T is.  Above 256 (max(D, H) >
CLUSTER_MAX_WIDTH) a call takes the wide path (instantiations *_wide,
lstm_wide.cu's header has the design): windows of WIDE_* steps chosen so
that the call's scratch stays within WIDE_SCRATCH_BYTES whatever T is, each
window's projection (A, B) or gate pass (C) over the whole card, then a
recurrence of row groups of ceil(H / WIDE_UNITS) CTAs that exchange h (da)
through global memory with one barrier a step (cooperative launches of the
row groups the card holds at once, _wide_slots; where the card does not
hold a group's CTAs at once, fewer CTAs of more unit tiles each, wide_ctas),
then C's dx and dW by window and the ordered sum.  On that card each (up to
256) is bound by the latency of one step of the recurrence, not by bytes or
FLOPs: 16000 steps at W = 64; at W = 32 the strided family's 50 steps
take about as long as the host's work for one call, so a call launches one
kernel and nothing
beside it: every kernel reads fp32 weights and the bf16 ones round them
themselves (no cast kernel), dy comes in x's type as autograd hands it,
no output is zero-filled (the kernels write every element), the plan is
cached, and at W = 32 and 16 the backward is one cooperative launch where
its grid is resident at once.  What the
designs do about the latency (the sources' headers have the detail): a
block owns a few batch rows and runs
all T steps; every weight of the recurrence sits in a register for the whole
launch; the work of a step that does not depend on the carried state (the
input projection in A and B, the whole gate recompute in C) is done by
producer warps that run ahead and hand it over through a ring in shared
memory (on the cluster path C's is a gate pass over the whole card before
the recurrence); one barrier separates two steps.  At W = 32 and 16 and T
up to FWD_SHORT_MAX_STEPS, A and B take the short path instead
(lstm_fwd_short_kernel): the block's x in one TMA copy, every step's
projection up front by all warps, then the steps with nothing beside them,
in the ring path's arithmetic and so with its bits.  The bf16
instantiations put every product on the tensor cores (mma.sync: bf16 in,
exact products, fp32 sums), the recurrent one with the block's rows as the
tile's N; the fp32 ones stay on the CUDA cores in full fp32, no TF32.

The launch plan (launch_plan) is computed here, in Python, from the batch,
the steps, the widths and the card's SM count, cached per shape, and handed
to the C entry points: the capacity, the cluster's size
or the wide path (its windows, its rows a row group and its scratch); rows per block
(1, 2 or 4 forward, 1 or 2 backward; 1, 2, 4 or 8 a cluster: the rows that
finish the batch soonest, by the waves of blocks the card needs, at the
blocks an SM runs at once (the clusters the card holds), and the measured
cost of a step of that many rows at that width and path, so B=128 takes
128 blocks of one row and B=512 128 blocks of four), the forward's path
(fwd_short: the short path at capacities 32 and 16 and T <= 64, square
or, in bf16, masked; else the ring or the cluster), the backward's path
(bwd_fused: one launch at capacities 32 and 16, T <= 64, where its blocks
are resident at once: at 32 one block an SM, at 16 the blocks an SM the
card's occupancy reading of the call's instantiation, square or masked,
gives, fused_slots; else four),
its scratch shapes at the real G = 4H (on the cluster path a window's, with
the gate pass's records) and its dx and dW grids.

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
import functools

import torch

from awm_tpu_torch.ops import cuda_build
from awm_tpu_torch.ops.lstm import (
    lstm_backward,
    lstm_forward,
    lstm_forward_train,
    matmul_dtype,
)

WIDTHS = (64, 48, 32, 16)  # the capacities W of the register-held instantiations, kernels A, B and C
CLUSTER_MAX_WIDTH = 256  # the cluster path's widest D and H (8 CTAs of CLUSTER_UNITS); wider: the wide path
CLUSTER_UNITS = 32  # hidden units a CTA of the cluster path owns
SOURCES = ("lstm_fwd", "lstm_fwd_cluster", "lstm_bwd", "lstm_wide")  # ops/csrc/<name>.cu, one library each
KERNELS = ("lstm_fwd", "lstm_fwd_train", "lstm_bwd")


def capacity(width: int, hidden: int | None = None) -> int | None:
    """The smallest W of WIDTHS with max(D, H) <= W, or None where the call
    takes the cluster path (max(D, H) > 64) or the wide path (> 256)."""
    need = max(width, hidden or width)
    fits = [w for w in WIDTHS if need <= w]
    return min(fits) if fits else None


def is_wide(width: int, hidden: int | None = None) -> bool:
    """True where a call takes the wide path: max(D, H) > CLUSTER_MAX_WIDTH."""
    return max(width, hidden or width) > CLUSTER_MAX_WIDTH


def instantiation(kernel: str, dtype: torch.dtype, width: int, hidden: int | None = None) -> str:
    """The name of the instantiation a call of input width D = width and
    hidden width H = hidden (default: width) runs, and of its launch
    counter: lstm_fwd_f32 (D = H = 64), lstm_fwd_bf16_w32 (D = H = 32),
    lstm_bwd_f32_w48 (D = H = 48), lstm_fwd_f32_masked (max(D, H) in 49-63:
    capacity 64 at runtime widths), lstm_bwd_f32_w48_masked (max(D, H) in
    33-48, not 48 x 48), lstm_fwd_f32_w16_masked, lstm_bwd_bf16_cluster
    (max(D, H) > 64),
    lstm_bwd_f32_wide (max(D, H) > 256).  Its C entry point is
    entry_point(name)."""
    sfx = "bf16" if matmul_dtype(dtype) == torch.bfloat16 else "f32"
    hidden = hidden or width
    if is_wide(width, hidden):
        return f"{kernel}_{sfx}_wide"
    cap = capacity(width, hidden)
    if cap is None:
        return f"{kernel}_{sfx}_cluster"
    name = f"{kernel}_{sfx}" + ("" if cap == 64 else f"_w{cap}")
    return name if width == hidden == cap else f"{name}_masked"


def source_of(name: str) -> str:
    """The source (library) of an instantiation: lstm_wide on the wide path,
    else lstm_bwd, lstm_fwd, or lstm_fwd_cluster for A and B on the cluster
    path."""
    if name.endswith("_wide"):
        return "lstm_wide"
    if name.startswith("lstm_bwd"):
        return "lstm_bwd"
    return "lstm_fwd_cluster" if name.endswith("_cluster") else "lstm_fwd"


def entry_point(name: str) -> str:
    """The C function of an instantiation: a masked call runs its capacity's
    entry point with the real widths."""
    return "awm_" + name.removesuffix("_masked")


# Each kernel against its plain version on the card, by (kernel, operand
# type) at every width (chip_smoke.py and ops/bench_lstm.py --check).  fp32:
# the same arithmetic in another summation order.  bf16: both round x, the
# weights and the recurrent h at the same points, so an h that lands on the
# other side of a bf16 rounding boundary is the largest difference (the TPU
# kernel's bf16 bound, tests/test_pallas.py:106).  A and B: max abs error of
# y (and cprev).  C: max abs error of each of dx, dW_ih, dW_hh, db over that
# tensor's max abs value; bf16 rounds da, and dx is stored bf16 (one ulp is
# 2^-8).
KERNEL_TOL = {("lstm_fwd", "f32"): 1e-4, ("lstm_fwd", "bf16"): 5e-2,
              ("lstm_fwd_train", "f32"): 1e-4, ("lstm_fwd_train", "bf16"): 5e-2,
              ("lstm_bwd", "f32"): 1e-4, ("lstm_bwd", "bf16"): 1e-2}


# Launches of each instantiation since import (or since a caller zeroed
# them); chip_smoke.py reads them to show that the main paths went through
# the kernels.  A call counts once: a forward call is one launch; a
# backward call is one launch on the fused path (capacities 32 and 16 where the
# plan takes it) and four otherwise (the recurrence, dx, dW, the ordered sum).
# One counter per path: square, masked (a capacity at runtime widths),
# cluster and wide (a call counts once there too, whatever its windows): a
# capacity's square and masked counters at each of WIDTHS, the same
# capacity for A, B and C.
PATH_WIDTHS = (tuple((w, w) for w in WIDTHS) + tuple((w - 1, w) for w in WIDTHS)
               + ((CLUSTER_MAX_WIDTH, CLUSTER_MAX_WIDTH), (CLUSTER_MAX_WIDTH + 1, CLUSTER_MAX_WIDTH + 1)))
launches = {instantiation(k, dt, d, h): 0
            for d, h in PATH_WIDTHS for k in KERNELS for dt in (torch.float32, torch.bfloat16)}

_libs: dict[str, ctypes.CDLL] = {}
build_log = ""

# Rows per block each recurrent kernel is instantiated for, with the time of
# one call of blocks of that many rows relative to blocks of one row, by
# (width, operand dtype), measured with ops/bench_lstm.py --variants on an
# H100 (PERF.md has the times): width 64 at T=16000; width 48 at T=16000
# from kernel B at B=128, where every variant is one wave (fp32 5.43, 8.27,
# 13.38 ms at 1, 2, 4 rows; bf16 4.50, 5.10, 5.50; A at B=512 took its
# least at 4 rows, fp32 13.2 and bf16 5.5 ms); C at width 48 from its
# recurrence at B=128, T=16000 (the call's device ms less dx, dW and the
# sum, which do not change with the rows: fp32 7.11 and 13.55 ms at 1 and 2
# rows, bf16 5.31 and 8.59; at B=512 two rows took fp32 54.2 ms against
# 55.5 at one, bf16 21.7 against 25.7, as these costs choose); width 32 at T=50 from
# the kernels' device time at B=128, where every variant is one wave (a
# call's CUDA-event time there is the host's).  A step is bound by latency,
# so a second row costs less than the first, but not nothing.  Width 16 at
# T=50, B=128, the same way (in bf16 the rows are columns of the mma tile,
# as at width 32, so a row more costs nothing measurable); its forward on the
# ring, its backward on the fused path that T <= 64 takes (bench_lstm.py
# --width 16 --variants --steps 50 --batch 128: fp32 0.02182 and 0.0389 ms
# at one and two rows, bf16 0.01605 and 0.02069; the four launches' 1.38 at
# two rows is its recurrence's).  A 128-thread block leaves room on its
# SM: the waves count BLOCKS_PER_SM blocks an SM at width 16.
FWD_STEP_COST = {
    (64, torch.float32): {1: 1.0, 2: 1.32, 4: 2.4},
    (64, torch.bfloat16): {1: 1.0, 2: 1.08, 4: 1.3},
    (48, torch.float32): {1: 1.0, 2: 1.52, 4: 2.46},
    (48, torch.bfloat16): {1: 1.0, 2: 1.13, 4: 1.22},
    (32, torch.float32): {1: 1.0, 2: 1.08, 4: 2.31},
    (32, torch.bfloat16): {1: 1.0, 2: 1.04, 4: 1.19},
    (16, torch.float32): {1: 1.0, 2: 1.19, 4: 1.60},
    (16, torch.bfloat16): {1: 1.0, 2: 1.01, 4: 0.98},
}
BWD_STEP_COST = {
    (64, torch.float32): {1: 1.0, 2: 2.1},
    (64, torch.bfloat16): {1: 1.0, 2: 1.58},
    (48, torch.float32): {1: 1.0, 2: 1.91},
    (48, torch.bfloat16): {1: 1.0, 2: 1.62},
    (32, torch.float32): {1: 1.0, 2: 1.32},
    (32, torch.bfloat16): {1: 1.0, 2: 1.14},
    (16, torch.float32): {1: 1.0, 2: 1.78},
    (16, torch.bfloat16): {1: 1.0, 2: 1.29},
}
# The short path's (W = 32 and 16, T <= FWD_SHORT_MAX_STEPS), kernel A's
# device time at T=50, B=128, where every variant is one wave.  In bf16 the
# rows are columns of the mma tile: at width 32 A and B took 0.93-1.03x one
# row's time at two and four over two calls, so they are counted the same
# and ties go to fewer rows; at width 16 four rows took 0.97x one row's time
# over three calls (0.01107 against 0.01140 ms, H100; at B=4, T=32 0.00756
# against 0.00779), so four rows a block at every batch.
SHORT_STEP_COST = {
    (32, torch.float32): {1: 1.0, 2: 1.26, 4: 1.77},
    (32, torch.bfloat16): {1: 1.0, 2: 1.0, 4: 1.0},
    (16, torch.float32): {1: 1.0, 2: 1.20, 4: 1.57},
    (16, torch.bfloat16): {1: 1.0, 2: 1.01, 4: 0.97},
}
FWD_ROWS = (1, 2, 4)
BWD_ROWS = (1, 2)
DW_CHUNK_ROWS = 2048  # rows of the (B*T) axis per dW chunk where rows are many
DW_MIN_CHUNK_ROWS = 64  # least rows per chunk where they are few (T = 50)
DW_MAX_CHUNKS = 256
DX_TILE_ROWS = 32  # lstm_bwd.cu's DX_ROWS
# The fused backward (lstm_bwd.cu, lstm_bwd_fused_kernel): the capacities it
# is instantiated for (square and masked: any D, H within them, the capacity's
# shared memory and partials), the most T the plan sends to it (its rows' da and
# x_t | h_{t-1} stay in shared memory: 172.5 KB of the H100's 227 KB a block
# at W = 32, T = 64, fp32, two rows; 78.5 KB at W = 16; the kernel asks the
# card's limit, and a longer T fails at its launch), and the blocks an SM the
# plan counts on at W = 32 for its one wave: the plan's step costs are
# measured at one block an SM (two would share its instruction slots between
# two latency-bound recurrences), and a cooperative launch refuses a grid
# that is not resident at once.  At W = 16 (FUSED_READ_WIDTHS) a 128-thread
# block leaves room on its SM, as the ring's BLOCKS_PER_SM counts, so the
# plan takes the blocks the card holds at once: fused_slots, the reading of
# cudaOccupancyMaxActiveBlocksPerMultiprocessor at the call's shared memory
# for the call's instantiation, square or masked (_fused_slots, before any
# launch; the masked one's registers differ); where the grid is more, the four
# launches.  W = 32 keeps one block an SM: a reading of two there would move
# B = 300 at T = 50 (150 blocks of two rows) onto the fused path, which
# test_plan_fuses_the_strided_backward_in_one_wave and the width-32 step
# costs, measured at one block an SM, keep on the four launches.
FUSED_WIDTHS = (32, 16)
FUSED_READ_WIDTHS = (16,)
FUSED_MAX_STEPS = 64
FUSED_BLOCKS_PER_SM = 1
# The forward's short path, kernels A and B (lstm_fwd.cu,
# lstm_fwd_short_kernel: x in one TMA copy, every step's projection up
# front, no ring): the capacities it is instantiated for (square and masked)
# and the most T the plan sends to it (the source's SHORT_MAX_STEPS; a
# longer T is refused at the launch).  Its buffers grow with T: 166 KB at
# W = 32, T = 64 and four fp32 rows (85 KB at W = 16), of the 227 KB one block may ask for on an
# H100.  Two of its blocks may share an SM where their shared memory fits,
# but the plan counts one an SM at W = 32 (SHORT_STEP_COST's): two blocks of
# two rows were slower than one of four (bf16, B=512) or as fast (fp32); at
# W = 16 BLOCKS_PER_SM's four, as on the ring.
SHORT_WIDTHS = (32, 16)
FWD_SHORT_MAX_STEPS = 64
# The operand types whose masked calls (any other D, H within those
# capacities) the plan sends to the short path: bf16 only.  On an H100
# (ops/bench_lstm.py --paths, device ms; PERF.md section 6) the masked
# bf16 short path took A at 24 x 24, B=512, T=50 0.0145 ms against the
# masked ring's 0.0163, B at B=128 0.01355 against 0.0138, and at 12 x 12
# as long or less; the fp32 one took longer
# than the ring at every shape timed (A at 24 x 24, B=512 0.0291 against
# 0.0270; B at B=128 0.0152 against 0.0147; at 12 x 12, B=4 and 128, 3-8%
# longer): its 50 steps on the CUDA cores are the call either way, and the
# relayout of x into the capacity's rows comes on top.
MASKED_SHORT_DTYPES = (torch.bfloat16,)


def short_x_tma(steps: int, width: int, bf16: bool) -> bool:
    """lstm_fwd.cu's short_x_tma: whether a masked short call brings x in
    by the TMA copy (a row's T D values are whole 16-byte pieces, so every
    block's span is 16-byte aligned at both ends) or by plain loads; either
    way x lands in the capacity's padded rows, the same values in the same
    places.  A square call always takes the TMA."""
    return steps * width * (2 if bf16 else 4) % 16 == 0


# Blocks of one instantiation an SM runs at once without slowing each other,
# by (capacity, operand dtype); the plan's waves count sm_count x this.  One
# where it is not measured: a W = 64 block holds the register file alone, and
# two W = 32 blocks were slower than one of twice the rows (the short path's
# note above).  One at W = 48: two 384-thread blocks of two rows an SM took
# 14.1 ms where one of four took 13.2 (fp32 A, B=512; bf16 7.0 against 5.5;
# lstm_fwd.cu's FWD_MIN_BLOCKS).  W = 16: a 128-thread block holds a
# fraction of an SM's registers, and 512 one-row fp32 blocks (3.9 an SM)
# took 0.0158 ms where 128 blocks of four took 0.0195 (H100, T=50, PERF.md
# section 6): the plan had counted one block an SM and picked four rows.
BLOCKS_PER_SM = {(16, torch.float32): 4, (16, torch.bfloat16): 4}
# The cluster path (max(D, H) > 64): a cluster carries R = 1, 2, 4 or 8
# batch rows (CLUSTER_ROWS, every one built at HW = 128 and 256).  A wave
# holds the clusters the card runs at once, which
# cudaOccupancyMaxActiveClusters gives (read once per instantiation, rows
# and widths, _cluster_slots; shared memory grows with R): a GPC holds whole
# clusters only, so on an H100 30 clusters of 4 and not 132 // 4 = 33 (39 of
# 3, 15 of 8), one CTA an SM, but 62 of 4 for kernel C's bf16 recurrence up
# to four rows (two CTAs an SM); the pure plan takes sm_count // K where it
# is not given them.  The time of one wave of clusters of R rows relative to
# one row, by (K, operand dtype), measured with ops/bench_lstm.py --width
# 96|128|256 --variants --steps 2000 on an H100 (PERF.md section 6; a wave's
# time grows with T alone, so T=2000 keeps the ratios of T=16000): the
# forward's from kernel A at B=512, the backward's from its recurrence
# (lstm_bwd_cluster_kernel's device time) at B=128, each call's time over
# its waves at the card's reading.  Where none is measured (K = 1, 2, 5, 6,
# 7) the plan takes the fewest rows that fit the batch in one wave (the
# most rows where none does): a wave of R rows costs less than R waves of
# one at every measured K.
CLUSTER_FWD_STEP_COST = {
    (3, torch.float32): {1: 1.0, 2: 1.50, 4: 2.48, 8: 4.44}, (3, torch.bfloat16): {1: 1.0, 2: 1.09, 4: 1.16, 8: 1.31},
    (4, torch.float32): {1: 1.0, 2: 1.53, 4: 2.56, 8: 4.57}, (4, torch.bfloat16): {1: 1.0, 2: 0.99, 4: 1.07, 8: 1.23},
    (8, torch.float32): {1: 1.0, 2: 1.61, 4: 3.14, 8: 6.87}, (8, torch.bfloat16): {1: 1.0, 2: 1.27, 4: 1.33, 8: 1.42},
}
CLUSTER_BWD_STEP_COST = {
    (3, torch.float32): {1: 1.0, 2: 1.50, 4: 2.66, 8: 5.22}, (3, torch.bfloat16): {1: 1.0, 2: 1.31, 4: 1.27, 8: 1.97},
    (4, torch.float32): {1: 1.0, 2: 1.47, 4: 2.71, 8: 5.50}, (4, torch.bfloat16): {1: 1.0, 2: 1.19, 4: 2.12, 8: 2.35},
    (8, torch.float32): {1: 1.0, 2: 1.74, 4: 3.13, 8: 8.83}, (8, torch.bfloat16): {1: 1.0, 2: 1.28, 4: 1.66, 8: 2.67},
}
CLUSTER_ROWS = (1, 2, 4, 8)
CLUSTER_REC = 8  # floats of a (row, step, unit) record of kernel C's gate pass (lstm_any.cuh's CREC)
# Kernel C on the cluster path runs in windows of time (lstm_bwd.cu's
# launch_cluster, the wide path's windows): a window's records (B, tc, H, 8)
# fp32 and da (B, tc, 4H) in the operand type, beside the dW partials (at
# most a quarter of the budget), the carried (dh, dc) and each row's db, stay
# within CLUSTER_SCRATCH_BYTES whatever B T is (for all T the records alone
# took 67 GB at H = 256, B = 512, T = 16000, bf16: more than the card has
# beside the call's 25 GB of operands).  2 GiB, the wide path's budget: a
# few percent of an 80 GB card, and windows of hundreds of steps or more at
# the batches the card runs, so a window's own costs (the recurrence's
# relaunch, one read and write of the dW partials) stay near 1% of its
# steps' (PERF.md section 6).  A call whose whole T fits runs one window, the
# same launches in the same order as one pass over T: the same bits.
CLUSTER_SCRATCH_BYTES = 2**31
# The wide path (max(D, H) > CLUSTER_MAX_WIDTH, ops/csrc/lstm_wide.cu): a CTA
# owns WIDE_UNITS hidden units, a row group of ceil(H / WIDE_UNITS) CTAs
# carries up to 64 batch rows (WIDE_ROWS, the plan's choice), and a call runs
# in windows of time whose scratch (A, B: the window's projection (B, tc, 4H)
# fp32; C: its records (B, tc, H, 8) fp32 and da (B, tc, 4H) in the operand
# type, beside the dW partials, at most a quarter of the budget) stays within
# WIDE_SCRATCH_BYTES whatever T is: the GB-scale analogue of the TPU kernel's
# 4 MB time tile (awm_tpu/ops/pallas/lstm_kernel.py::_pick_tc).  Each step a
# CTA stages the recurrent operand (A, B: h_{t-1}, H terms; C: da_t, 4H
# terms) of its rows: A and B the whole row where it fits shared memory
# beside W_hh's slice in global memory, else (and C always) in chunks of
# WIDE_CHUNK terms (512 bytes a row) through a ring of WIDE_RING buffers, so
# that nothing of a CTA's shared memory grows with H but W_hh's slice, which
# moves to global memory where it does not fit (wide_smem mirrors the
# source's count; the card's memory bounds the width).  Rows a group: the
# fewest launches of the row groups the card holds at once (_wide_slots:
# cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs over ceil(H / 16)),
# then the fewest rows (_wide_rows); where no rows variant holds a group's
# ceil(H / 16) CTAs at once (H > 2112 at one CTA an SM of 132), fewer CTAs a
# group, each of more tiles of WIDE_UNITS (wide_ctas).
WIDE_UNITS = 16
WIDE_ROWS = (1, 2, 4, 8, 16, 32, 64)
WIDE_SCRATCH_BYTES = 2**31
WIDE_CHUNK = {False: 128, True: 256}  # terms a staged chunk, by bf16 (lstm_wide.cu's chunk_terms)
WIDE_RING = {False: 4, True: 6}  # buffers of a chunked ring, by bf16 (lstm_wide.cu's ring_depth)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one (batch, steps, dtype, width) call is cut over a card of
    sm_count SMs."""

    capacity: int  # W of the register-held instantiations (A, B and C), 0 on the cluster and wide paths
    cluster: int  # CTAs of a cluster (ceil(H / 32)) on the cluster path, else 0
    fwd_rows: int  # batch rows per block (per cluster), kernels A and B
    fwd_blocks: int
    fwd_short: bool  # kernels A and B on the short path (lstm_fwd_short_kernel)
    bwd_rows: int  # batch rows per block, kernel C's recurrent kernel
    bwd_blocks: int
    bwd_fused: bool  # kernel C in one cooperative launch (its scratch: bwd_blocks partials of 4W*2W + 4W)
    n_chunks: int  # chunks of the (B*T) axis, kernel C's dW partials
    dx_blocks: int  # grid of kernel C's dx kernel (it strides over row tiles)
    da_shape: tuple[int, int, int]  # scratch: da in the operand type
    da_dtype: torch.dtype
    part_shape: tuple[int, int, int]  # scratch: dW chunk partials (n_chunks, 4H, D + H), fp32
    db_part_shape: tuple[int, int]  # scratch: db per recurrent block, fp32
    rec_shape: tuple[int, ...] | None  # scratch on the cluster path: the gate pass's records (B, bwd_window, H, 8), fp32
    # The cluster and wide paths: da_shape and rec_shape are a window's, (B, bwd_window, ...).  The wide
    # path (max(D, H) > 256): fwd_rows / bwd_rows are rows a row group and fwd_blocks / bwd_blocks the
    # row groups.
    wide: bool = False
    fwd_window: int = 0  # steps a window of A and B (the wide path)
    bwd_window: int = 0  # steps a window of C (the cluster and wide paths)
    xp_shape: tuple[int, int, int] | None = None  # scratch: A and B's window projection (B, fwd_window, 4H), fp32
    fwd_pack: int = 0  # scratch: elements of the packed W_hh in the operand type, A and B
    bwd_pack: int = 0  # and C's
    state_shape: tuple[int, int] | None = None  # scratch: the state carried between windows, (B, H) fp32 each
    fwd_ctas: int = 0  # CTAs a row group, A and B (ceil(H / WIDE_UNITS) unless tiled; 0: the card's choice)
    bwd_ctas: int = 0  # and C's
    wih: int = 0  # scratch: elements of W_ih in bf16 (4H x D), the bf16 gate passes and C's dx

    def scratch_bytes(self, kernel: str) -> int:
        """Bytes of scratch a wide call of kernel ("lstm_fwd", "lstm_fwd_train"
        or "lstm_bwd"), or a cluster call of "lstm_bwd", allocates beside its
        inputs and outputs."""
        elt = 2 if self.da_dtype == torch.bfloat16 else 4
        prod = lambda shape: functools.reduce(lambda a, b: a * b, shape, 1)
        if kernel == "lstm_bwd":  # da_shape[::2]: db_rows (B, 4H), each row's db (carried, or a tiled CTA's)
            return (4 * (prod(self.rec_shape) + prod(self.part_shape) + prod(self.db_part_shape)
                         + 2 * prod(self.state_shape) + prod(self.da_shape[::2]) + self.bwd_blocks)
                    + elt * (prod(self.da_shape) + self.bwd_pack) + 2 * self.wih)
        return (4 * (prod(self.xp_shape) + prod(self.state_shape) + self.fwd_blocks) + elt * self.fwd_pack
                + 2 * self.wih)


def _one_wave_rows(batch: int, slots: dict[int, int]) -> int:
    """The fewest rows a cluster that fit the batch in one wave, or the
    most rows the card holds where none does (the plan where no cost is
    measured)."""
    fits = [r for r in CLUSTER_ROWS if slots[r] > 0 and -(-batch // r) <= slots[r]]
    return min(fits) if fits else max(r for r in CLUSTER_ROWS if slots[r] > 0)


def _rows_per_block(batch: int, slots, step_cost: dict[int, float]) -> int:
    """Rows per block that finish the batch soonest.  A recurrent kernel
    keeps a block on its SM for all T steps, and slots blocks (or clusters;
    a number, or one by rows per block) run at once, so the blocks run in
    ceil(blocks / slots) waves and a call costs waves x the step cost of
    that many rows.  Ties go to fewer rows, and a rows variant of which the
    card holds no block (0 slots) is never taken.  B=128 on 132 SMs takes
    128 blocks of one row; B=512 one wave of 128 blocks of four."""
    def at_once(rows: int) -> int:
        return slots[rows] if isinstance(slots, dict) else slots

    def cost(rows: int) -> float:
        return -(-(-(-batch // rows)) // at_once(rows)) * step_cost[rows]

    return min((r for r in step_cost if at_once(r) > 0), key=lambda rows: (cost(rows), rows))


def _check_width(width: int, hidden: int | None = None) -> None:
    for name, w in (("D", width), ("H", width if hidden is None else hidden)):
        if w < 1:
            raise ValueError(f"lstm kernels take widths D, H >= 1, got {name} = {w}")


def wide_pitch(n: int, bf16: bool) -> int:
    """lstm_wide.cu's wide_pitch: the row pitch of a staged operand of n terms."""
    return -(-n // 16) * 16 + (8 if bf16 else 4)


def wide_smem(bwd: bool, bf16: bool, hidden: int, rows: int, w_smem: bool, chunk: int) -> int:
    """lstm_wide.cu's wide_smem: the dynamic shared memory of a recurrence
    CTA (A / B: bwd False; C: True) of `rows` rows whose staged operand comes
    in chunks of `chunk` terms (wide_chunk's; a ring of WIDE_RING buffers, or
    one for the whole row), with W_hh's slice (w_smem) or without it; fp32
    A / B's also the step's gate sums (rows x 64 fp32), C's its db, dh and
    the dh product's partials."""
    elt, whole = (2 if bf16 else 4), -(-(4 * hidden if bwd else hidden) // 16) * 16
    tile = (16 if bwd else 8) if bf16 else 1  # bf16: the ring's rows in whole mma tiles
    ring = elt * (1 if chunk >= whole else WIDE_RING[bf16]) * -(-rows // tile) * tile * wide_pitch(chunk, bf16)
    if not bwd:
        return (ring + (elt * 4 * WIDE_UNITS * wide_pitch(hidden, bf16) if w_smem else 0)
                + (0 if bf16 else 4 * rows * 4 * WIDE_UNITS))
    return (max(ring, 4 * rows * 4 * WIDE_UNITS) + (elt * WIDE_UNITS * wide_pitch(4 * hidden, bf16) if w_smem else 0)
            + 4 * rows * WIDE_UNITS + 4 * WIDE_UNITS * (64 if bf16 else max(64, 8 * rows)))


def wide_chunk(bwd: bool, bf16: bool, hidden: int, rows: int, optin: int, chunk: int = 0) -> int:
    """lstm_wide.cu's rec_chunk: the terms a staged chunk of a recurrence at
    `rows` rows where a CTA may opt in to `optin` bytes of shared memory: a
    given chunk in whole k-tiles (at most the row); else C's WIDE_CHUNK, and
    A / B's whole row where it fits beside W_hh's slice in global memory
    (their plan and step times stay those of whole-row staging wherever it
    fits), WIDE_CHUNK past it."""
    whole = -(-(4 * hidden if bwd else hidden) // 16) * 16
    if chunk > 0:
        return min(-(-chunk // 16) * 16, whole)
    part = min(WIDE_CHUNK[bf16], whole)
    return part if bwd or wide_smem(False, bf16, hidden, rows, False, whole) > optin else whole


def wide_pack_elems(bwd: bool, bf16: bool, hidden: int) -> int:
    """Elements of the packed W_hh of the wide path (lstm_wide.cu's
    pack_elems): each CTA's 64 gate rows (A, B) or 16 columns (C)."""
    k = -(-hidden // WIDE_UNITS)
    return k * (WIDE_UNITS * wide_pitch(4 * hidden, bf16) if bwd else 4 * WIDE_UNITS * wide_pitch(hidden, bf16))


def wide_ctas(k: int, slots: int) -> int:
    """lstm_wide.cu's group_ctas: the CTAs of a row group of k unit tiles
    where the card holds `slots` CTAs at once: all k where they fit, else as
    few as fit with the tiles spread evenly (k = 140 on 132: 70 CTAs of
    two); 0 where not one fits."""
    if slots >= k:
        return k
    return -(-k // -(-k // slots)) if slots >= 1 else 0


def _wide_rows(batch: int, k: int, slots: dict[int, int]) -> tuple[int, int]:
    """(Rows, CTAs) of a row group of k unit tiles, where slots[r] CTAs of r
    rows are resident at once: where some rows variant holds a group's k
    CTAs, the fewest launches of the row groups the card holds, then the
    fewest rows (a launch runs every step of a window, so each launch more
    costs a window's steps again; a step's cost grows with the rows more
    slowly than the rows: PERF.md section 6); else (tiled: fewer CTAs of
    more tiles, wide_ctas) the fewest launches times tiles, then the fewest
    rows.  A CTA's shared memory does not grow with H (the staged operand
    comes in chunks, W_hh's slice moves to global memory), so every width
    has a launch shape; a reading of no CTA at any rows (the card's SMs held
    by others) raises."""
    groups = lambda r: -(-batch // r)
    fit = [r for r in WIDE_ROWS if slots[r] >= k]
    if fit:
        return min(fit, key=lambda r: (-(-groups(r) // (slots[r] // k)), r)), k
    some = [r for r in WIDE_ROWS if slots[r] >= 1]
    if not some:
        raise RuntimeError(f"the card holds no CTA of the wide recurrence at any rows a group (H = {k * WIDE_UNITS}): "
                           f"{slots}")

    def cost(r: int) -> tuple[int, int]:
        c = wide_ctas(k, slots[r])
        return -(-groups(r) // (slots[r] // c)) * -(-k // c), r
    rows = min(some, key=cost)
    return rows, wide_ctas(k, slots[rows])


def _wide_plan(batch: int, steps: int, dtype: torch.dtype, sm_count: int, width: int, hidden: int,
               bwd_rows: int | None, wide_slots: tuple | None) -> LaunchPlan:
    """The wide path's plan (launch_plan's, max(D, H) > CLUSTER_MAX_WIDTH)."""
    mm = matmul_dtype(dtype)
    bf16, elt = mm == torch.bfloat16, 2 if mm == torch.bfloat16 else 4
    k = -(-hidden // WIDE_UNITS)
    fwd_slots, bwd_slots = (dict(zip(WIDE_ROWS, s)) for s in wide_slots or ((sm_count,) * len(WIDE_ROWS),) * 2)
    fwd_rows, fwd_ctas = _wide_rows(batch, k, fwd_slots)
    if bwd_rows is None:
        bwd_rows, bwd_ctas = _wide_rows(batch, k, bwd_slots)
    elif bwd_rows not in range(1, max(WIDE_ROWS) + 1):
        raise ValueError(f"the wide path takes 1 to {max(WIDE_ROWS)} rows a row group, got {bwd_rows}")
    else:
        bwd_ctas = wide_ctas(k, bwd_slots.get(bwd_rows, 0))  # 0 (the card's choice) where the reading left it out
    fwd_groups, bwd_groups = -(-batch // fwd_rows), -(-batch // bwd_rows)
    g, budget = 4 * hidden, WIDE_SCRATCH_BYTES
    fwd_pack, bwd_pack = wide_pack_elems(False, bf16, hidden), wide_pack_elems(True, bf16, hidden)
    # windows: what the budget leaves after the fixed scratch (for C a quarter of the budget kept for
    # the dW partials), a local row index below 2^31; the same windows at any T longer than them
    part_budget = budget // 4
    wih = g * width if bf16 else 0
    fwd_fixed = 4 * (batch * hidden + fwd_groups) + elt * fwd_pack + 2 * wih
    bwd_fixed = (part_budget + 4 * (bwd_groups * g + 2 * batch * hidden + batch * g + bwd_groups) + elt * bwd_pack
                 + 2 * wih)
    window = lambda fixed, per_step: max(1, min(steps, (budget - fixed) // per_step, (2**31 - 1) // batch))
    fwd_window = window(fwd_fixed, batch * g * 4)
    bwd_window = window(bwd_fixed, batch * (hidden * CLUSTER_REC * 4 + g * elt))
    # dW partials: the four-launch formula over a window's rows, within their quarter of the budget
    n_rows = batch * bwd_window
    n_chunks = max(1, min(DW_MAX_CHUNKS, part_budget // (4 * g * (width + hidden)),
                          max(-(-n_rows // DW_CHUNK_ROWS), min(sm_count, -(-n_rows // DW_MIN_CHUNK_ROWS)))))
    return LaunchPlan(
        capacity=0, cluster=0, fwd_rows=fwd_rows, fwd_blocks=fwd_groups, fwd_short=False,
        bwd_rows=bwd_rows, bwd_blocks=bwd_groups, bwd_fused=False, n_chunks=n_chunks, dx_blocks=0,
        da_shape=(batch, bwd_window, g), da_dtype=mm,
        part_shape=(n_chunks, g, width + hidden), db_part_shape=(bwd_groups, g),
        rec_shape=(batch, bwd_window, hidden, CLUSTER_REC),
        wide=True, fwd_window=fwd_window, bwd_window=bwd_window, xp_shape=(batch, fwd_window, g),
        fwd_pack=fwd_pack, bwd_pack=bwd_pack, state_shape=(batch, hidden), fwd_ctas=fwd_ctas, bwd_ctas=bwd_ctas,
        wih=wih,
    )


@functools.lru_cache(maxsize=4096)
def launch_plan(batch: int, steps: int, dtype: torch.dtype, sm_count: int,
                width: int, bwd_rows: int | None = None, hidden: int | None = None,
                cluster_slots: tuple | None = None, wide_slots: tuple | None = None,
                fused_slots: tuple | None = None) -> LaunchPlan:
    """The plan of one call of input width D = width and hidden width H =
    hidden (default: width): pure, so the CPU tests reach it, and cached, so
    a call looks its shape up.  bwd_rows overrides the backward's rows per
    block (for tests and timing; the path follows from the blocks).
    cluster_slots: ((forward, backward) clusters of each of CLUSTER_ROWS
    rows the card runs at once) on the cluster path, _cluster_slots'
    reading; None counts sm_count // K for each.  wide_slots: ((A's, C's)
    CTAs of each of WIDE_ROWS rows the card holds at once) on the wide path,
    _wide_slots' reading; None counts sm_count for each.  fused_slots:
    (blocks of the fused backward at each of BWD_ROWS rows a block that the
    card holds at once at this T), _fused_slots' reading (at the widths of
    FUSED_READ_WIDTHS); None counts sm_count x FUSED_BLOCKS_PER_SM for each.
    The call takes the fused path where its blocks are at most that, and the
    four launches where they are more: decided here, before any launch.  The
    forward's path follows from the widths and T alone.  The fused path
    counts on the whole card: sm_count SMs, each free to hold its blocks.
    Where the process has less (an MPS client with a share of the SMs,
    another kernel resident), the cooperative launch refuses the grid and
    the call raises; it is never retried on another path."""
    if batch < 1 or steps < 1 or sm_count < 1:
        raise ValueError(f"launch_plan takes batch, steps, sm_count >= 1, got {batch}, {steps}, {sm_count}")
    hidden = hidden or width
    _check_width(width, hidden)
    if is_wide(width, hidden):
        return _wide_plan(batch, steps, dtype, sm_count, width, hidden, bwd_rows, wide_slots)
    mm = matmul_dtype(dtype)
    cap = capacity(width, hidden)
    if cap is None:
        k = -(-hidden // CLUSTER_UNITS)
        fwd_slots, bwd_slots = (dict(zip(CLUSTER_ROWS, s)) for s in
                                cluster_slots or ((max(1, sm_count // k),) * len(CLUSTER_ROWS),) * 2)
        fwd_short = False
        rows_of = lambda slots, costs: (_rows_per_block(batch, slots, costs[k, mm]) if (k, mm) in costs
                                        else _one_wave_rows(batch, slots))
        fwd_rows = rows_of(fwd_slots, CLUSTER_FWD_STEP_COST)
        if bwd_rows is None:
            bwd_rows = rows_of(bwd_slots, CLUSTER_BWD_STEP_COST)
    else:
        k, slots = 0, sm_count * BLOCKS_PER_SM.get((cap, mm), 1)
        fwd_short = (cap in SHORT_WIDTHS and steps <= FWD_SHORT_MAX_STEPS
                     and (width == hidden == cap or mm in MASKED_SHORT_DTYPES))
        fwd_rows = _rows_per_block(batch, slots, (SHORT_STEP_COST if fwd_short else FWD_STEP_COST)[cap, mm])
        if bwd_rows is None:
            bwd_rows = _rows_per_block(batch, slots, BWD_STEP_COST[cap, mm])
    allowed = CLUSTER_ROWS if cap is None else BWD_ROWS
    if bwd_rows not in allowed:
        raise ValueError(f"backward rows per block are {allowed}, got {bwd_rows}")
    bwd_blocks = -(-batch // bwd_rows)
    bwd_fused = False
    if cap in FUSED_WIDTHS and steps <= FUSED_MAX_STEPS:
        at_once = (sm_count * FUSED_BLOCKS_PER_SM if fused_slots is None
                   else dict(zip(BWD_ROWS, fused_slots))[bwd_rows])
        bwd_fused = bwd_blocks <= at_once
    g = 4 * hidden
    window, cluster = steps, {}
    if cap is None:  # C's windows: what CLUSTER_SCRATCH_BYTES leaves after the fixed scratch, as the wide path's
        bf16, elt = mm == torch.bfloat16, 2 if mm == torch.bfloat16 else 4
        wih, pack = (g * width, wide_pack_elems(True, True, hidden)) if bf16 else (0, 0)
        fixed = (CLUSTER_SCRATCH_BYTES // 4 + 4 * (bwd_blocks * g + 2 * batch * hidden + batch * g) + elt * pack
                 + 2 * wih)
        window = max(1, min(steps, (CLUSTER_SCRATCH_BYTES - fixed) // (batch * (hidden * CLUSTER_REC * 4 + g * elt)),
                            (2**31 - 1) // batch))
        cluster = dict(bwd_window=window, state_shape=(batch, hidden), wih=wih, bwd_pack=pack)
    n_rows = batch * window
    # Chunks of DW_CHUNK_ROWS (of a window's rows on the cluster path), but
    # enough for one dW block an SM while each keeps DW_MIN_CHUNK_ROWS (B=128
    # at T=50 has 6400 rows: 4 chunks would leave 128 SMs idle), and no more
    # than DW_MAX_CHUNKS partials to sum (at most a quarter of the cluster
    # path's budget: no bound below DW_MAX_CHUNKS up to width 256).
    n_chunks = max(1, min(DW_MAX_CHUNKS, CLUSTER_SCRATCH_BYTES // 4 // (4 * g * (width + hidden)),
                          max(-(-n_rows // DW_CHUNK_ROWS), min(sm_count, -(-n_rows // DW_MIN_CHUNK_ROWS)))))
    return LaunchPlan(
        capacity=cap or 0, cluster=k,
        fwd_rows=fwd_rows, fwd_blocks=-(-batch // fwd_rows), fwd_short=fwd_short,
        bwd_rows=bwd_rows, bwd_blocks=bwd_blocks, bwd_fused=bwd_fused, n_chunks=n_chunks, dx_blocks=max(1, min(-(-n_rows // DX_TILE_ROWS), 2 * sm_count)),
        da_shape=(batch, window, g), da_dtype=mm,
        part_shape=(n_chunks, g, width + hidden), db_part_shape=(bwd_blocks, g),
        rec_shape=(batch, window, hidden, CLUSTER_REC) if cap is None else None, **cluster,
    )


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _cluster_slots(device_index: int, dtype: torch.dtype, width: int, hidden: int) -> tuple:
    """((kernel A, kernel C's recurrence) clusters of each of CLUSTER_ROWS
    rows) the card holds at once for a call of these widths on the cluster
    path: cudaOccupancyMaxActiveClusters, read once per instantiation and
    widths."""
    libs, bf16 = libraries(), int(matmul_dtype(dtype) == torch.bfloat16)
    out = []
    for lib, fn in ((libs["lstm_fwd_cluster"], "awm_lstm_fwd_cluster_slots"),
                    (libs["lstm_bwd"], "awm_lstm_bwd_cluster_slots")):
        with torch.cuda.device(device_index):
            got = tuple(getattr(lib, fn)(bf16, rows, width, hidden) for rows in CLUSTER_ROWS)
        if min(got) < 0 or max(got) < 1:  # an error, or no rows variant fits the card
            err = -min(got)
            raise RuntimeError(f"{fn}: {lib.awm_cuda_error_string(err).decode() if err > 0 else 'no cluster fits'}")
        out.append(got)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _fused_slots(device_index: int, dtype: torch.dtype, width: int, steps: int, masked: bool = False) -> tuple:
    """(Blocks of the fused backward at each of BWD_ROWS rows a block) the
    card holds at once at capacity `width` and T = steps, of the square
    instantiation (D = H = width) or the masked one (masked: its registers
    may differ): the SMs times awm_lstm_bwd_fused_slots
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the call's dynamic
    shared memory, which grows with T), read once per instantiation, rows
    and T; 0 where the card's opt-in limit refuses the block's shared
    memory."""
    lib, bf16 = libraries()["lstm_bwd"], int(matmul_dtype(dtype) == torch.bfloat16)
    with torch.cuda.device(device_index):
        got = tuple(lib.awm_lstm_bwd_fused_slots(bf16, width, rows, steps, int(masked)) for rows in BWD_ROWS)
    if min(got) < 0:
        raise RuntimeError(f"awm_lstm_bwd_fused_slots: {lib.awm_cuda_error_string(-min(got)).decode()}")
    return tuple(n * _sm_count(device_index) for n in got)


@functools.lru_cache(maxsize=None)
def _wide_slots(device_index: int, dtype: torch.dtype, hidden: int) -> tuple:
    """((kernel A's, kernel C's) CTAs of the wide recurrence at each of
    WIDE_ROWS rows) the card holds at once at hidden width H:
    awm_lstm_wide_shape, read once per instantiation and width; 0 for the
    rows at which W_hh's slice leaves shared memory where another rows
    variant keeps it there (read from global memory each step it cost fp32
    B at B=128 twice the time of half the rows, C twice that of half the
    rows in twice the launches: PERF.md section 6).  Checks that the
    library's packed W_hh has the size wide_pack_elems gives, that it would
    launch the CTAs a group wide_ctas gives, and that its chunk and shared
    memory are wide_chunk's and wide_smem's."""
    lib, bf16 = libraries()["lstm_wide"], int(matmul_dtype(dtype) == torch.bfloat16)
    k = -(-hidden // WIDE_UNITS)
    out = []
    with torch.cuda.device(device_index):
        for bwd in (0, 1):
            shapes = []
            for rows in WIDE_ROWS:
                got = (ctypes.c_int * 6)()
                err = lib.awm_lstm_wide_shape(bwd, bf16, hidden, rows, 0, got)
                if err:
                    raise RuntimeError(f"awm_lstm_wide_shape: {lib.awm_cuda_error_string(err).decode()}")
                if got[1] != wide_ctas(k, got[0]):
                    raise RuntimeError(f"lstm_wide.cu's group_ctas ({got[1]}) and lstm_kernel.wide_ctas "
                                       f"({wide_ctas(k, got[0])}) disagree at H = {hidden}, {got[0]} slots")
                chunk = wide_chunk(bool(bwd), bool(bf16), hidden, rows, got[5])
                smem = wide_smem(bool(bwd), bool(bf16), hidden, rows, bool(got[2]), got[4])
                if (got[4], got[3]) != (chunk, smem):
                    raise RuntimeError(f"lstm_wide.cu's chunk and shared memory ({got[4]}, {got[3]}) and "
                                       f"lstm_kernel.wide_chunk / wide_smem ({chunk}, {smem}) disagree at H = "
                                       f"{hidden}, {rows} rows, bwd {bwd}")
                shapes.append(tuple(got[:3]))
            slots = [n for n, _, _ in shapes]
            if any(m for _, _, m in shapes):
                slots = [n if m else 0 for n, _, m in shapes]
            out.append(tuple(slots))
        for bwd in (0, 1):
            if lib.awm_lstm_wide_pack_elems(bwd, bf16, hidden) != wide_pack_elems(bool(bwd), bool(bf16), hidden):
                raise RuntimeError("lstm_wide.cu's packed W_hh and lstm_kernel.wide_pack_elems disagree")
    return tuple(out)


def device_plan(batch: int, steps: int, dtype: torch.dtype, device_index: int, width: int,
                hidden: int | None = None, bwd_rows: int | None = None) -> LaunchPlan:
    """The plan of a call on card device_index, with the card's readings
    the path needs: the clusters it holds (the cluster path), the CTAs of a
    row group (the wide path), the fused backward's blocks (capacities of
    FUSED_READ_WIDTHS at T <= FUSED_MAX_STEPS, of the call's instantiation:
    square or masked)."""
    hidden = hidden or width
    sm_count = _sm_count(device_index)
    if is_wide(width, hidden):
        return launch_plan(batch, steps, dtype, sm_count, width, bwd_rows, hidden,
                           wide_slots=_wide_slots(device_index, dtype, hidden))
    cap = capacity(width, hidden)
    slots = _cluster_slots(device_index, dtype, width, hidden) if cap is None else None
    fused = (_fused_slots(device_index, dtype, cap, steps, not width == hidden == cap)
             if cap in FUSED_READ_WIDTHS and steps <= FUSED_MAX_STEPS else None)
    return launch_plan(batch, steps, dtype, sm_count, width, bwd_rows, hidden, slots, fused_slots=fused)


def _plan_for(x: torch.Tensor, hidden: int, bwd_rows: int | None = None) -> LaunchPlan:
    bsz, t, width = x.shape
    return device_plan(bsz, t, x.dtype, x.device.index, width, hidden, bwd_rows)


def libraries() -> dict[str, ctypes.CDLL]:
    """Build (every source at once, one nvcc each) and load the kernel
    libraries, once per process."""
    global build_log
    if not _libs:
        built = cuda_build.load_all(SOURCES)
        ptr, i = ctypes.c_void_p, ctypes.c_int
        argtypes = {"lstm_fwd": [ptr] * 5 + [i] * 6 + [ptr],
                    "lstm_fwd_train": [ptr] * 6 + [i] * 6 + [ptr],
                    "lstm_bwd": [ptr] * 15 + [i] * 8 + [ptr]}
        wide_argtypes = {"lstm_fwd": [ptr] * 11 + [i] * 8 + [ptr], "lstm_fwd_train": [ptr] * 11 + [i] * 8 + [ptr],
                         "lstm_bwd": [ptr] * 21 + [i] * 9 + [ptr]}
        for name in launches:
            kernel = max((k for k in KERNELS if name.startswith(k + "_")), key=len)
            fn = getattr(built[source_of(name)][0], entry_point(name))
            if name.endswith("_cluster") and kernel == "lstm_bwd":
                fn.argtypes = [ptr] * 20 + [i] * 7 + [ptr]
            else:
                fn.argtypes = (wide_argtypes if name.endswith("_wide") else argtypes)[kernel]
            fn.restype = ctypes.c_int
        wide = built["lstm_wide"][0]
        wide.awm_lstm_wide_shape.argtypes, wide.awm_lstm_wide_shape.restype = [i] * 5 + [ptr], ctypes.c_int
        wide.awm_lstm_wide_pack_elems.argtypes, wide.awm_lstm_wide_pack_elems.restype = [i] * 3, ctypes.c_longlong
        for src, fn, n in (("lstm_fwd_cluster", "awm_lstm_fwd_cluster_slots", 4),
                           ("lstm_bwd", "awm_lstm_bwd_cluster_slots", 4), ("lstm_bwd", "awm_lstm_bwd_fused_slots", 5)):
            lib = built[src][0]
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = [i] * n, ctypes.c_int
        for lib, _ in built.values():
            lib.awm_cuda_error_string.argtypes = [ctypes.c_int]
            lib.awm_cuda_error_string.restype = ctypes.c_char_p
        build_log = "\n".join(f"== {name}.cu\n{built[name][1]}" for name in SOURCES)
        _libs.update({name: built[name][0] for name in SOURCES})
    return _libs


def _check_x_weights(x, w_ih, w_hh, b) -> tuple[int, int]:
    """Checks the operands of one call; returns its widths (D, H): x's last
    axis and w_hh's second."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"lstm kernel takes float32 or bfloat16 x, got {x.dtype}")
    if w_hh.dim() != 2 or x.dim() != 3:
        raise ValueError(f"lstm kernel takes a 3-D x and a 2-D w_hh, got {tuple(x.shape)}, {tuple(w_hh.shape)}")
    width, hidden = x.shape[2], w_hh.shape[1]
    _check_width(width, hidden)
    for name, t, shape in (
        ("w_ih", w_ih, (4 * hidden, width)), ("w_hh", w_hh, (4 * hidden, hidden)),
        ("b", b, (4 * hidden,)),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"lstm kernel takes {name} of shape {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("lstm kernel takes a contiguous x")
    if max(x.shape[0], x.shape[1]) >= 2**31:
        raise ValueError("lstm kernel takes B and T below 2**31 (C int arguments)")
    return width, hidden


def _check_stream(name, t, shape, dtypes, device):
    if tuple(t.shape) != shape or t.dtype not in dtypes or t.device != device:
        raise ValueError(
            f"lstm kernel takes {name} {shape} {' or '.join(map(str, dtypes))} on {device}, "
            f"got {tuple(t.shape)} {t.dtype} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"lstm kernel takes a contiguous {name}")


def _weight(w: torch.Tensor) -> torch.Tensor:
    """w as every kernel reads it: fp32, contiguous and 8-byte aligned (the
    bf16 kernels load two weights at once and round them to bf16
    themselves).  The models' fp32 parameters pass as they are; a bf16
    weight is widened (exactly), and a view at a 4-byte offset copied."""
    w = w.to(torch.float32).contiguous()
    return w if w.data_ptr() % 8 == 0 else w.clone()


def _operands(w_ih, w_hh, b):
    """(w_ih, w_hh, b) as the kernels read them: all fp32, the weights by
    _weight."""
    return _weight(w_ih), _weight(w_hh), b.to(torch.float32).contiguous()


def _launch(lib_name: str, name: str, x: torch.Tensor, *args) -> None:
    """One call of the C entry point awm_<name> on x's device and its
    current stream (the raw handle, as Triton's launcher takes it: no
    Stream object is built for a call)."""
    lib = libraries()[lib_name]
    with torch.cuda.device(x.device):
        err = getattr(lib, entry_point(name))(*args, torch._C._cuda_getCurrentRawStream(x.device.index))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.awm_cuda_error_string(err).decode()}")
    launches[name] += 1


def _forward_path(x: torch.Tensor, width: int, hidden: int, rows: int | None, short: bool | None) -> tuple:
    """(x, rows, short) of one forward launch: the plan's rows and path
    unless overridden (for tests and timing).  The short path's TMA copy
    reads x from a 16-byte aligned address (short_x_tma's calls): a view at
    another offset is copied (the outputs are fresh allocations, aligned)."""
    plan = _plan_for(x, hidden)
    short = plan.fwd_short if short is None else short
    if short and capacity(width, hidden) not in SHORT_WIDTHS:
        raise ValueError(f"the forward's short path is compiled for capacities {SHORT_WIDTHS} (max(D, H) <= 32), "
                         f"got D = {width}, H = {hidden}")
    rows = rows or plan.fwd_rows
    if plan.cluster and rows not in CLUSTER_ROWS:
        raise ValueError(f"the cluster path takes rows per cluster in {CLUSTER_ROWS}, got {rows}")
    if short and x.data_ptr() % 16:
        x = x.clone()
    return x, rows, short


def _wide_forward(x, w_ih, w_hh, b, y, cprev, rows: int | None, ctas: int | None, chunk: int | None) -> None:
    """Kernel A (cprev None) or B on the wide path: the plan's windows, rows
    a row group and CTAs a group (rows and ctas override them; rows alone
    leaves the CTAs to the card) and the card's chunk of the staged h
    (chunk overrides it), its scratch allocated here."""
    bsz, t, width = x.shape
    hidden = w_hh.shape[1]
    plan = _plan_for(x, hidden)
    ctas = ctas or (0 if rows else plan.fwd_ctas)
    rows = rows or plan.fwd_rows
    if not 1 <= rows <= max(WIDE_ROWS):
        raise ValueError(f"the wide path takes 1 to {max(WIDE_ROWS)} rows a row group, got {rows}")
    if not 0 <= ctas <= -(-hidden // WIDE_UNITS):
        raise ValueError(f"the wide path takes 1 to ceil(H / {WIDE_UNITS}) CTAs a row group, got {ctas}")
    f32 = dict(dtype=torch.float32, device=x.device)
    xp, c_state = torch.empty(plan.xp_shape, **f32), torch.empty(plan.state_shape, **f32)
    pack = torch.empty(plan.fwd_pack, dtype=plan.da_dtype, device=x.device)
    wih = torch.empty(plan.wih, dtype=torch.bfloat16, device=x.device) if plan.wih else None
    count = torch.empty(-(-bsz // rows), dtype=torch.int32, device=x.device)
    name = instantiation("lstm_fwd" if cprev is None else "lstm_fwd_train", x.dtype, width, hidden)
    _launch("lstm_wide", name, x, x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b.data_ptr(), y.data_ptr(),
            None if cprev is None else cprev.data_ptr(), xp.data_ptr(), pack.data_ptr(),
            None if wih is None else wih.data_ptr(), c_state.data_ptr(), count.data_ptr(), bsz, t, width, hidden,
            rows, ctas, _chunk(chunk), plan.fwd_window)


def _chunk(chunk: int | None) -> int:
    """The wide path's chunk override as the entry points take it (0: the
    card's choice)."""
    if chunk is not None and chunk < 1:
        raise ValueError(f"the wide path takes a chunk of >= 1 terms, got {chunk}")
    return chunk or 0


def forward_kernel(x, w_ih, w_hh, b, rows: int | None = None, short: bool | None = None,
                   ctas: int | None = None, chunk: int | None = None) -> torch.Tensor:
    """Kernel A: (B, T, D) -> y (B, T, H) in x's dtype, on the card, D, H
    >= 1.  rows overrides the plan's rows per block (a row group on the
    wide path), short its path (the short path at capacities 32 and 16, or the ring),
    ctas the wide path's CTAs a row group (fewer than ceil(H / 16): tiled)
    and chunk the terms of its staged chunks of h (whole k-tiles, at most
    the row; the same bits at any chunk) (for tests and timing)."""
    width, hidden = _check_x_weights(x, w_ih, w_hh, b)
    bsz, t, _ = x.shape
    y = torch.empty(bsz, t, hidden, dtype=x.dtype, device=x.device)
    if bsz == 0 or t == 0:
        return y
    w_ih, w_hh, b = _operands(w_ih, w_hh, b)
    if is_wide(width, hidden) and not short:
        _wide_forward(x, w_ih, w_hh, b, y, None, rows, ctas, chunk)
        return y
    x, rows, short = _forward_path(x, width, hidden, rows, short)
    name = instantiation("lstm_fwd", x.dtype, width, hidden)
    _launch(source_of(name), name, x, x.data_ptr(), w_ih.data_ptr(),
            w_hh.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, t, width, hidden, rows, int(short))
    return y


def forward_train_kernel(
    x, w_ih, w_hh, b, rows: int | None = None, short: bool | None = None, ctas: int | None = None,
    chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B: (B, T, D) -> (y in x's dtype, cprev fp32), both
    (B, T, H), on the card.  rows, short, ctas and chunk as in
    forward_kernel."""
    width, hidden = _check_x_weights(x, w_ih, w_hh, b)
    bsz, t, _ = x.shape
    y = torch.empty(bsz, t, hidden, dtype=x.dtype, device=x.device)
    cprev = torch.empty(bsz, t, hidden, dtype=torch.float32, device=x.device)
    if bsz == 0 or t == 0:
        return y, cprev
    w_ih, w_hh, b = _operands(w_ih, w_hh, b)
    if is_wide(width, hidden) and not short:
        _wide_forward(x, w_ih, w_hh, b, y, cprev, rows, ctas, chunk)
        return y, cprev
    x, rows, short = _forward_path(x, width, hidden, rows, short)
    name = instantiation("lstm_fwd_train", x.dtype, width, hidden)
    _launch(source_of(name), name, x, x.data_ptr(),
            w_ih.data_ptr(), w_hh.data_ptr(), b.data_ptr(), y.data_ptr(), cprev.data_ptr(),
            bsz, t, width, hidden, rows, int(short))
    return y, cprev


def backward_kernel(x, y, cprev, dy, w_ih, w_hh, b, rows: int | None = None, ctas: int | None = None,
                    chunk: int | None = None, fused: bool | None = None):
    """Kernel C: (dx in x's dtype, dW_ih, dW_hh, db fp32) on the card.
    y and cprev are forward_train_kernel's outputs, dy is (B, T, H) in x's
    dtype (as autograd hands it to LSTMFunction.backward).  The outputs are
    not zero-filled: the kernels write every element.  The plan picks the
    path: fused (capacities 32 and 16), one cooperative launch with scratch for
    one dW and db partial per block at the capacity; else four launches with da (B, T, 4H) in the operand
    type, chunk partials of dW and db per recurrent block; on the cluster
    and wide paths window by window from the last (lstm_bwd.cu's
    launch_cluster, lstm_wide.cu), the gate pass first, its scratch the
    plan's (a window's records (B, tc, H, 8) fp32 and da, the dW and db
    partials, the packed W_hh and bf16 W_ih where the path reads them, the
    carried (dh, dc) and each row's db, db_rows).  rows
    overrides the plan's rows per block of the recurrence (a row group on
    the wide path), ctas the wide path's CTAs a row group and chunk the
    terms of its staged chunks of da (whole k-tiles, at most the row; the
    same bits at any chunk) and fused the path at capacities of FUSED_WIDTHS (True
    the cooperative launch, which raises where the card does not hold its
    grid at once; False the four launches) (for tests and timing)."""
    width, hidden = _check_x_weights(x, w_ih, w_hh, b)
    bsz, t, _ = x.shape
    shape = (bsz, t, hidden)
    _check_stream("y", y, shape, (x.dtype,), x.device)
    _check_stream("cprev", cprev, shape, (torch.float32,), x.device)
    _check_stream("dy", dy, shape, (x.dtype,), x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dw_ih, dw_hh = torch.empty(4 * hidden, width, **f32), torch.empty(4 * hidden, hidden, **f32)
    db = torch.empty(4 * hidden, **f32)
    if bsz == 0 or t == 0:
        return dx, dw_ih.zero_(), dw_hh.zero_(), db.zero_()
    if fused and capacity(width, hidden) not in FUSED_WIDTHS:
        raise ValueError(f"the fused backward is compiled for capacities {FUSED_WIDTHS} (max(D, H) <= 32), "
                         f"got D = {width}, H = {hidden}")
    w_ih, w_hh, b = _operands(w_ih, w_hh, b)
    plan = _plan_for(x, hidden, rows)
    fused = plan.bwd_fused if fused is None else fused
    name = instantiation("lstm_bwd", x.dtype, width, hidden)
    if plan.wide or plan.cluster:  # windows of time: a window's scratch, the state carried between windows
        keep = [torch.empty(plan.da_shape, dtype=plan.da_dtype, device=x.device), torch.empty(plan.rec_shape, **f32),
                torch.empty(plan.part_shape, **f32), torch.empty(plan.db_part_shape, **f32),
                torch.empty(plan.bwd_pack, dtype=plan.da_dtype, device=x.device),
                torch.empty(plan.wih, dtype=torch.bfloat16, device=x.device),
                torch.empty(plan.state_shape, **f32), torch.empty(plan.state_shape, **f32),
                torch.empty(bsz, 4 * hidden, **f32)]
        scratch = [s.data_ptr() if s.numel() else None for s in keep]  # da, rec, part, db_part, pack, wih, dh, dc, db_rows
        args = (x.data_ptr(), y.data_ptr(), cprev.data_ptr(), dy.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(),
                b.data_ptr(), dx.data_ptr(), dw_ih.data_ptr(), dw_hh.data_ptr(), db.data_ptr(), *scratch)
        if plan.cluster:
            _launch("lstm_bwd", name, x, *args, bsz, t, width, hidden, plan.bwd_rows, plan.n_chunks, plan.bwd_window)
            return dx, dw_ih, dw_hh, db
        count = torch.empty(plan.bwd_blocks, dtype=torch.int32, device=x.device)
        ctas = ctas or plan.bwd_ctas
        if not 0 <= ctas <= -(-hidden // WIDE_UNITS):
            raise ValueError(f"the wide path takes 1 to ceil(H / {WIDE_UNITS}) CTAs a row group, got {ctas}")
        _launch("lstm_wide", name, x, *args, count.data_ptr(), bsz, t, width, hidden, plan.bwd_rows, ctas,
                _chunk(chunk), plan.bwd_window, plan.n_chunks)
        return dx, dw_ih, dw_hh, db
    if fused:  # the partials at the capacity W, whatever D and H: (blocks, 4W 2W + 4W)
        da = db_part = None
        cap = plan.capacity
        part = torch.empty(plan.bwd_blocks, 4 * cap * 2 * cap + 4 * cap, **f32)
    else:
        da = torch.empty(plan.da_shape, dtype=plan.da_dtype, device=x.device)
        part = torch.empty(plan.part_shape, **f32)
        db_part = torch.empty(plan.db_part_shape, **f32)
    _launch("lstm_bwd", name, x,
            x.data_ptr(), y.data_ptr(), cprev.data_ptr(), dy.data_ptr(),
            w_ih.data_ptr(), w_hh.data_ptr(), b.data_ptr(),
            dx.data_ptr(), dw_ih.data_ptr(), dw_hh.data_ptr(), db.data_ptr(),
            da.data_ptr() if da is not None else None, None, part.data_ptr(),
            db_part.data_ptr() if db_part is not None else None, bsz, t, width, hidden,
            plan.bwd_rows, plan.n_chunks, plan.dx_blocks, int(fused))
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
    h_{t-1} history) and the fp32 c_{t-1} history.  The backward hands dy
    on in x's dtype, as autograd gives it (y's; the plain version widens
    it), and returns each gradient in its primal's dtype: dx in x's (bf16
    under mixed precision), the weight gradients in the weights' (fp32)."""

    @staticmethod
    def forward(ctx, x, w_ih, w_hh, b):
        y, cprev = forward_train(x, w_ih, w_hh, b)
        ctx.save_for_backward(x, y, cprev, w_ih, w_hh, b)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, cprev, w_ih, w_hh, b = ctx.saved_tensors
        dx, dw_ih, dw_hh, db = backward(x, y, cprev, dy.to(x.dtype).contiguous(), w_ih, w_hh, b)
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
