"""The launch plan of the port's CUDA LSTM kernels, and their plain versions
at sequences shorter than the kernels' rings.

The plan (rows per block, block counts, the backward's scratch shapes) is a
pure function of (batch, steps, dtype, SM count, D, H), so it is tested here
on the CPU, at width 64, 48, 32 and 16, at the masked widths below 64
(capacity 48 at 33-48 for kernels A, B and C), on the
cluster path above it and on the wide path past 256.  The short-T cases hold the plain training forward and backward against
the JAX package's Pallas kernels in interpret mode: on the card the kernels
are held against these plain versions at T = 1, 2, 3."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from awm_tpu.ops.pallas.lstm_kernel import _backward, _forward_train

from awm_tpu_torch.ops import lstm_kernel
from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train
from awm_tpu_torch.ops.lstm_kernel import launch_plan

BATCHES = [1, 2, 3, 4, 5, 127, 128, 129, 512, 513]


@pytest.mark.parametrize("sm_count", [1, 132])
@pytest.mark.parametrize("batch", BATCHES)
def test_plan_covers_every_row_once(batch, sm_count):
    """Block i owns rows [i * rows, (i + 1) * rows): together the blocks
    cover 0..B-1 exactly once, the last block may be ragged, and no block
    is empty.  Both dtypes, forward and backward."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = launch_plan(batch, 16000, dtype, sm_count, width=64)
        for rows, blocks, choices in (
            (plan.fwd_rows, plan.fwd_blocks, lstm_kernel.FWD_ROWS),
            (plan.bwd_rows, plan.bwd_blocks, lstm_kernel.BWD_ROWS),
        ):
            assert rows in choices
            assert blocks * rows >= batch > (blocks - 1) * rows
            owned = [r for i in range(blocks) for r in range(i * rows, min((i + 1) * rows, batch))]
            assert owned == list(range(batch))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", BATCHES)
def test_plan_scratch_shapes(batch, dtype):
    """The scratch the backward wrapper allocates: da for every (row, step)
    in the operand type, one db partial per recurrent block, one dW partial
    per chunk, and chunks that cover the (B*T) axis."""
    steps = 300
    plan = launch_plan(batch, steps, dtype, 132, width=64)
    assert plan.da_shape == (batch, steps, 256) and plan.da_dtype == dtype
    assert plan.db_part_shape == (plan.bwd_blocks, 256)
    assert plan.part_shape == (plan.n_chunks, 256, 128)
    assert 1 <= plan.n_chunks <= lstm_kernel.DW_MAX_CHUNKS
    chunk_rows = -(-batch * steps // plan.n_chunks)  # as lstm_bwd.cu cuts the axis
    assert plan.n_chunks * chunk_rows >= batch * steps
    assert 1 <= plan.dx_blocks <= 2 * 132


def test_plan_fills_the_card():
    """At the training batch every SM that has a row gets one block of one
    row; at the serving batch no choice of rows would finish sooner by the
    plan's own cost."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = launch_plan(128, 16000, dtype, 132, width=64)
        assert (plan.fwd_rows, plan.fwd_blocks, plan.bwd_rows, plan.bwd_blocks) == (1, 128, 1, 128)
        cost = lstm_kernel.FWD_STEP_COST[64, dtype]
        plan = launch_plan(512, 16000, dtype, 132, width=64)
        waves = lambda rows: -(-(-(-512 // rows)) // 132)
        assert all(waves(plan.fwd_rows) * cost[plan.fwd_rows] <= waves(r) * cost[r] for r in cost)
        assert (plan.fwd_rows, plan.fwd_blocks) == (4, 128)


def test_plan_refuses_empty_calls():
    for args in ((0, 10, 132), (4, 0, 132), (4, 10, 0)):
        with pytest.raises(ValueError):
            launch_plan(args[0], args[1], torch.float32, args[2], width=64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", BATCHES)
def test_plan_width32(batch, dtype):
    """Width 32 (the strided family, T=50): scratch sized by the width (da
    (B, T, 128), dW partials (n, 128, 64), db (blocks, 128)), rows from the
    width's own measured costs, blocks that cover the batch once, and chunks
    of the (B*T) axis that give every SM a dW block where the 6400 rows of
    B=128 would otherwise make 4."""
    plan = launch_plan(batch, 50, dtype, 132, width=32)
    assert plan.da_shape == (batch, 50, 128) and plan.da_dtype == dtype
    assert plan.part_shape == (plan.n_chunks, 128, 64)
    assert plan.db_part_shape == (plan.bwd_blocks, 128)
    assert plan.fwd_rows in lstm_kernel.FWD_ROWS and plan.bwd_rows in lstm_kernel.BWD_ROWS
    assert plan.fwd_blocks * plan.fwd_rows >= batch > (plan.fwd_blocks - 1) * plan.fwd_rows
    n_rows = batch * 50
    assert plan.n_chunks == min(132, -(-n_rows // lstm_kernel.DW_MIN_CHUNK_ROWS))
    # T=50 takes the forward's short path, with its own measured costs: the
    # training batch 128 blocks of one row, the serving batch 128 of four
    assert plan.fwd_short
    cost = lstm_kernel.SHORT_STEP_COST[32, dtype]
    waves = lambda rows: -(-(-(-batch // rows)) // 132)
    assert all(waves(plan.fwd_rows) * cost[plan.fwd_rows] <= waves(r) * cost[r] for r in cost)
    want = {128: (1, 128), 512: (4, 128)}.get(batch)
    assert want is None or (plan.fwd_rows, plan.fwd_blocks) == want


# Card readings of the fused backward at width 16 (blocks the card holds at
# once at one and two rows a block): none (the pure plan's one block an SM),
# an H100's at four and three blocks an SM, a reading below one block an SM,
# and one where the card holds no block (shared memory past its limit).
W16_READINGS = (None, (528, 528), (396, 264), (64, 32), (0, 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", BATCHES)
def test_plan_width16(batch, dtype):
    """Width 16 (entry.dryrun_multichip's gradient check, T=32): A and B on
    the short path at T <= FWD_SHORT_MAX_STEPS and on the ring past it; C in
    one cooperative launch at T <= FUSED_MAX_STEPS where the card's
    occupancy reading (fused_slots) holds the grid, else (and past that T)
    the four launches; scratch sized by the width (da (B, T, 64), dW
    partials (n, 64, 32), db (blocks, 64)), blocks that cover the batch
    once, and rows from the width's own measured step costs (the short
    path's where it takes it) at BLOCKS_PER_SM blocks an SM, whatever the
    reading: at B=512 fp32 one row a block on the ring (one wave of 512
    blocks), which the card measured faster than four rows (0.0158 against
    0.0195 ms).  A dry-run rank's two fp32 rows take two blocks and the
    fused backward."""
    slots = 132 * lstm_kernel.BLOCKS_PER_SM[16, dtype]
    for steps in (1, 32, 50, 64, 65, 800):
        for reading in W16_READINGS:
            plan = launch_plan(batch, steps, dtype, 132, 16, fused_slots=reading)
            assert plan.fwd_short == (steps <= lstm_kernel.FWD_SHORT_MAX_STEPS), (steps, reading)
            at_once = 132 if reading is None else dict(zip(lstm_kernel.BWD_ROWS, reading))[plan.bwd_rows]
            assert plan.bwd_fused == (steps <= lstm_kernel.FUSED_MAX_STEPS and plan.bwd_blocks <= at_once), (
                steps, reading)
            assert plan.da_shape == (batch, steps, 64) and plan.da_dtype == dtype
            assert plan.part_shape == (plan.n_chunks, 64, 32)
            assert plan.db_part_shape == (plan.bwd_blocks, 64)
            fwd_cost = (lstm_kernel.SHORT_STEP_COST if plan.fwd_short else lstm_kernel.FWD_STEP_COST)[16, dtype]
            for rows, blocks, cost in ((plan.fwd_rows, plan.fwd_blocks, fwd_cost),
                                       (plan.bwd_rows, plan.bwd_blocks, lstm_kernel.BWD_STEP_COST[16, dtype])):
                assert rows in cost and blocks * rows >= batch > (blocks - 1) * rows
                waves = lambda r: -(-(-(-batch // r)) // slots)
                assert all(waves(rows) * cost[rows] <= waves(r) * cost[r] for r in cost)
    if dtype == torch.float32:
        dry = launch_plan(2, 32, dtype, 132, width=16, fused_slots=(528, 528))
        assert dry.fwd_short and dry.fwd_blocks == 2 and dry.bwd_fused and dry.bwd_blocks == 2
        assert launch_plan(512, 800, dtype, 132, width=16).fwd_rows == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plan_width16_fused_follows_the_occupancy_reading(dtype):
    """The fused backward at width 16 is chosen from the card's occupancy
    reading before any launch: a smaller reading moves a call that fit to the
    four launches (never the other way), a grid of more blocks than the
    reading holds never stays fused, and the reading moves nothing else of
    the plan (rows, blocks, scratch, the forward's path).  A rows override
    is read at its own rows."""
    for steps in (1, 32, 50, 64):
        for batch in (1, 2, 4, 7, 32, 128, 129, 264, 265, 396, 397, 528, 529, 1000):
            base = launch_plan(batch, steps, dtype, 132, 16, fused_slots=(528, 528))
            was = True
            for reading in ((528, 528), (396, 264), (132, 132), (64, 32), (4, 2), (1, 1), (0, 0)):
                plan = launch_plan(batch, steps, dtype, 132, 16, fused_slots=reading)
                assert dataclasses.replace(plan, bwd_fused=base.bwd_fused) == base, (batch, steps, reading)
                at_once = dict(zip(lstm_kernel.BWD_ROWS, reading))[plan.bwd_rows]
                assert plan.bwd_fused == (plan.bwd_blocks <= at_once), (batch, steps, reading)
                assert was or not plan.bwd_fused, (batch, steps, reading)  # smaller readings: never fused again
                was = plan.bwd_fused
                for rows in lstm_kernel.BWD_ROWS:
                    forced = launch_plan(batch, steps, dtype, 132, 16, rows, fused_slots=reading)
                    assert forced.bwd_fused == (-(-batch // rows) <= reading[rows - 1]), (batch, steps, reading)
    # past the fused kernel's steps no reading fuses; width 32 keeps its one block an SM by default
    assert not launch_plan(2, lstm_kernel.FUSED_MAX_STEPS + 1, dtype, 132, 16, fused_slots=(528, 528)).bwd_fused
    assert lstm_kernel.FUSED_READ_WIDTHS == (16,) and set(lstm_kernel.FUSED_READ_WIDTHS) <= set(lstm_kernel.FUSED_WIDTHS)


def test_plan_keeps_width64_main_shapes_and_refuses_other_widths():
    """The chunking for short calls leaves the width-64 main paths' plans as
    they were (B=128 and 512 at T=16000: 256 chunks of 2048 rows or more);
    a width-64 call of fewer than 132 x 2048 rows (the curriculum's B=8,
    the trainer's B=16) now gets one dW chunk an SM, not one per 2048 rows;
    a width of 0 still raises a ValueError; one past the cluster path's
    widest (CLUSTER_MAX_WIDTH + 1 = 257), as D or as H, is planned on the
    wide path."""
    for dtype in (torch.float32, torch.bfloat16):
        assert launch_plan(128, 16000, dtype, 132, width=64).n_chunks == lstm_kernel.DW_MAX_CHUNKS
        assert launch_plan(512, 16000, dtype, 132, width=64).part_shape == (256, 256, 128)
        assert launch_plan(8, 16000, dtype, 132, width=64).n_chunks == 132  # 63 at 2048 rows a chunk
        assert launch_plan(16, 16000, dtype, 132, width=64).n_chunks == 132  # 125
    with pytest.raises(ValueError, match="widths D, H >= 1"):
        launch_plan(4, 10, torch.float32, 132, 0)
    ceiling = lstm_kernel.CLUSTER_MAX_WIDTH
    for width, hidden in ((ceiling + 1, None), (64, ceiling + 1), (ceiling + 1, 64)):
        plan = launch_plan(4, 10, torch.float32, 132, width, None, hidden)
        assert plan.wide and (plan.capacity, plan.cluster) == (0, 0)
        assert lstm_kernel.instantiation("lstm_bwd", torch.float32, width, hidden) == "lstm_bwd_f32_wide"
    assert not launch_plan(4, 10, torch.float32, 132, ceiling).wide


# The width-64 main shapes' plans as they stood before the fused backward
# (the base family at T=16000: B=3 the odd batch of chip_smoke.py, B=8 the
# curriculum's, B=16 the trainer's, B=128 training, B=512 serving):
# (fwd_rows, fwd_blocks, bwd_rows, bwd_blocks, n_chunks, dx_blocks, part_shape, db_part_shape).
W64_PLANS = {
    (torch.float32, 3): (1, 3, 1, 3, 132, 264, (132, 256, 128), (3, 256)),
    (torch.float32, 8): (1, 8, 1, 8, 132, 264, (132, 256, 128), (8, 256)),
    (torch.float32, 16): (1, 16, 1, 16, 132, 264, (132, 256, 128), (16, 256)),
    (torch.float32, 128): (1, 128, 1, 128, 256, 264, (256, 256, 128), (128, 256)),
    (torch.float32, 512): (4, 128, 1, 512, 256, 264, (256, 256, 128), (512, 256)),
    (torch.bfloat16, 3): (1, 3, 1, 3, 132, 264, (132, 256, 128), (3, 256)),
    (torch.bfloat16, 8): (1, 8, 1, 8, 132, 264, (132, 256, 128), (8, 256)),
    (torch.bfloat16, 16): (1, 16, 1, 16, 132, 264, (132, 256, 128), (16, 256)),
    (torch.bfloat16, 128): (1, 128, 1, 128, 256, 264, (256, 256, 128), (128, 256)),
    (torch.bfloat16, 512): (4, 128, 2, 256, 256, 264, (256, 256, 128), (256, 256)),
}


@pytest.mark.parametrize("dtype,batch", list(W64_PLANS), ids=lambda v: str(v).replace("torch.", ""))
def test_plan_width64_main_shapes_unchanged(dtype, batch):
    """At width 64 the plan is what it was: four launches, the same rows,
    chunks, grids and scratch."""
    plan = launch_plan(batch, 16000, dtype, 132, width=64)
    assert not plan.bwd_fused and not plan.fwd_short
    assert (plan.fwd_rows, plan.fwd_blocks, plan.bwd_rows, plan.bwd_blocks, plan.n_chunks,
            plan.dx_blocks, plan.part_shape, plan.db_part_shape) == W64_PLANS[dtype, batch]
    assert plan.da_shape == (batch, 16000, 256) and plan.da_dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plan_fuses_the_strided_backward_in_one_wave(dtype):
    """Width 32 at T=50 on 132 SMs: the training batch B=128 (128 blocks of
    one row) and B=256 (128 blocks of two) fit one wave and take the fused
    backward; B=300 (150 blocks of two) and B=1024 (512 of two) do not and
    take the four launches, as does T beyond the fused kernel's 64 steps."""
    fused = lambda b, t=50, sm=132: launch_plan(b, t, dtype, sm, width=32).bwd_fused
    assert fused(128) and fused(256) and fused(1) and fused(7)
    assert launch_plan(256, 50, dtype, 132, width=32).bwd_rows == 2
    assert not fused(300) and not fused(1024)
    assert fused(128, t=lstm_kernel.FUSED_MAX_STEPS) and not fused(128, t=lstm_kernel.FUSED_MAX_STEPS + 1)
    assert not fused(7, t=800)
    assert fused(1, sm=1) and not fused(3, sm=1)


@pytest.mark.parametrize("width", [32, 64, 16])
@pytest.mark.parametrize("sm_count", [1, 8, 132])
def test_plan_fuses_exactly_where_blocks_fit_one_wave(width, sm_count):
    """The fused backward where, and only where, the width has it, T is at
    most FUSED_MAX_STEPS and the blocks fit one wave at the occupancy the
    plan counts on; a rows override moves the blocks and so the path."""
    for dtype in (torch.float32, torch.bfloat16):
        for batch in BATCHES + [256, 264, 265, 300, 1024]:
            for steps in (1, 50, 64, 65, 800):
                for rows in (None, *lstm_kernel.BWD_ROWS):
                    plan = launch_plan(batch, steps, dtype, sm_count, width, rows)
                    assert plan.bwd_rows == (rows or plan.bwd_rows)
                    assert plan.bwd_blocks == -(-batch // plan.bwd_rows)
                    want = (width in lstm_kernel.FUSED_WIDTHS and steps <= lstm_kernel.FUSED_MAX_STEPS
                            and plan.bwd_blocks <= sm_count * lstm_kernel.FUSED_BLOCKS_PER_SM)
                    assert plan.bwd_fused == want, (dtype, batch, steps, rows)
    with pytest.raises(ValueError, match="rows"):
        launch_plan(4, 50, torch.float32, 132, width, 4)


def test_cached_plan_equals_a_fresh_one():
    """launch_plan is cached per shape: the cached plan equals one computed
    afresh, and a second call returns the same object without computing."""
    for args in ((128, 50, torch.bfloat16, 132, 32), (300, 50, torch.float32, 132, 32),
                 (512, 16000, torch.bfloat16, 132, 64), (7, 3, torch.float32, 132, 32, 2),
                 (512, 50, torch.float32, 132, 32), (512, 64, torch.bfloat16, 132, 32),
                 (512, 65, torch.bfloat16, 132, 32)):
        fresh = launch_plan.__wrapped__(*args)
        assert launch_plan(*args) == fresh
        hits = launch_plan.cache_info().hits
        assert launch_plan(*args) is launch_plan(*args)
        assert launch_plan.cache_info().hits == hits + 2


SHORT_BATCHES = [1, 7, 128, 300, 512]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", SHORT_BATCHES)
def test_plan_takes_the_short_forward_exactly_within_its_bound(batch, dtype):
    """Kernels A and B take the short path at width 32 exactly where T is
    at most FWD_SHORT_MAX_STEPS (the strided family's 50 steps, up to 64),
    the ring beyond it and at width 64 always, whatever the batch, and a
    rows override leaves the path as it is."""
    bound = lstm_kernel.FWD_SHORT_MAX_STEPS
    for steps in (1, 2, 15, 16, 17, 50, bound, bound + 1, 800, 16000):
        assert launch_plan(batch, steps, dtype, 132, width=32).fwd_short == (steps <= bound), steps
        assert not launch_plan(batch, steps, dtype, 132, width=64).fwd_short
        for rows in lstm_kernel.BWD_ROWS:
            assert (launch_plan(batch, steps, dtype, 132, 32, rows).fwd_short
                    == launch_plan(batch, steps, dtype, 132, 32).fwd_short)


def _source_constants() -> dict[str, int]:
    """The short path's constants as lstm_fwd.cu declares them."""
    import os
    import re

    src = os.path.join(os.path.dirname(lstm_kernel.__file__), "csrc", "lstm_fwd.cu")
    with open(src) as f:
        text = f.read()
    steps, xpad = re.search(r"constexpr int SHORT_MAX_STEPS = (\d+), XPAD = (\d+);", text).groups()
    header = re.search(r"constexpr int SHORT_HEADER = (\d+);", text).group(1)
    return {"SHORT_MAX_STEPS": int(steps), "XPAD": int(xpad), "SHORT_HEADER": int(header)}


BLOCK_SMEM_OPTIN = 232448  # the most shared memory one block may ask for on an H100: 227 KB


def _launch_smem(source: str, kernel: str) -> list[str]:
    """The dynamic shared memory argument of every <<<...>>> launch of
    `kernel` (by the name it is launched under) in ops/csrc/<source>.cu."""
    import os
    import re

    with open(os.path.join(os.path.dirname(lstm_kernel.__file__), "csrc", f"{source}.cu")) as f:
        text = f.read()
    return re.findall(rf"\b{kernel}\s*<<<[^,]+,[^,]+,\s*(.*?),\s*\(cudaStream_t\)stream>>>", text, re.S)


@pytest.mark.parametrize("masked", [False, True], ids=["square", "masked"])
@pytest.mark.parametrize("rows", lstm_kernel.FWD_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("width", lstm_kernel.SHORT_WIDTHS)
def test_short_path_shared_memory_fits_at_its_bound(width, dtype, rows, masked):
    """The short path's buffers, by the layout and constants of
    lstm_fwd.cu (its fwd_short_smem_bytes): x's mbarrier in SHORT_HEADER
    bytes, a multiple of 16 that holds its 8; xp, each row's T steps of 4W +
    XPAD floats padded to 8 past a multiple of 32, so that 4 rows' 16-byte
    reads at one step and 4 lanes' stores 2 steps apart take distinct banks;
    x, rows of W + 8 in bf16 and W in fp32, and the 8 rows the last
    projection tile reads past it; h.  At the plan's bound, which is the
    source's SHORT_MAX_STEPS, they stay under the 227 KB a block may opt in
    to on an H100, at every rows variant and width of SHORT_WIDTHS (32 and
    16); they grow with T and rows, so the bound at four rows is the worst
    case the plan sends."""
    src = _source_constants()
    bound = lstm_kernel.FWD_SHORT_MAX_STEPS
    assert bound == src["SHORT_MAX_STEPS"]
    header, step_floats = src["SHORT_HEADER"], 4 * width + src["XPAD"]
    assert header % 16 == 0 and header >= 8
    assert (2 * step_floats * 4) % 128 in (32, 96) and step_floats % 4 == 0  # 2 steps apart: 32 bytes
    elt = 2 if dtype == torch.bfloat16 else 4
    xpw = width + 8 if elt == 2 else width

    def smem(r: int, steps: int) -> int:
        row = steps * step_floats + (8 - steps * step_floats) % 32
        assert row % 32 == 8
        h = 2 * (8 if elt == 2 else r) * xpw * elt
        return header + r * row * 4 + (r * steps + 8) * xpw * elt + h

    got = smem(rows, bound)
    assert got <= BLOCK_SMEM_OPTIN
    assert all(smem(rows, steps) < got for steps in (1, 17, 50))
    assert rows == 4 or got < smem(4, bound)
    # the square and the masked instantiation launch under one selector with
    # the capacity's buffers (no D or H in the size), and a masked x landing
    # contiguous in xp's space fits it: R T D values of the operand type
    assert _launch_smem("lstm_fwd", "kernel") == ["fwd_short_smem_bytes<T, R, W>(steps)", "smem"]
    if masked:
        for steps in (1, 17, 50, bound):
            xp_bytes = rows * (steps * step_floats + (8 - steps * step_floats) % 32) * 4
            assert rows * steps * (width - 1) * elt <= xp_bytes


def _fused_pads() -> dict[str, int]:
    """The pads of the fused kernel's da and x_t | h_{t-1} rows as lstm_bwd.cu
    declares them (FDA_P, FV_P: bf16, fp32)."""
    import os
    import re

    with open(os.path.join(os.path.dirname(lstm_kernel.__file__), "csrc", "lstm_bwd.cu")) as f:
        text = f.read()
    out = {}
    for name, n in (("FDA_P", 4), ("FV_P", 2)):
        bf, f32 = re.search(rf"constexpr int {name} = is_bf16<T> \? {n} \* W \+ (\d+) : {n} \* W \+ (\d+);",
                            text).groups()
        out[f"{name}_bf16"], out[f"{name}_f32"] = int(bf), int(f32)
    return out


def fused_smem(width: int, rows: int, steps: int, bf16: bool) -> int:
    """A Python copy of lstm_bwd.cu's fused_smem_bytes: the recurrence's
    region (rec_smem_bytes: fp32 [W_ih | W_hh] for the producers, the ring
    of NBUF chunks of SB steps of 7W floats a row, c_{t-1}, da
    double-buffered, the staged x_t | h_{t-1}), 16-byte aligned, then the
    block's da and x_t | h_{t-1} rows for its (row, step) pairs in whole
    16-row tiles, and at W = 32 in bf16 W_ih^T for dx (W = 16 holds its
    fragments in registers)."""
    src, pads, elt = _bwd_source_constants(), _fused_pads(), 2 if bf16 else 4
    sb, nbuf, w = src["SB"], src["NBUF"], width
    rec = ((0 if bf16 else 4 * (4 * w) * (2 * w))
           + 4 * (nbuf * sb * rows * 7 * w + rows * sb * w + 2 * rows * 4 * (w + 8))
           + elt * rows * sb * (2 * w + 8 if bf16 else 2 * w))
    dap = 4 * w + pads["FDA_P_bf16" if bf16 else "FDA_P_f32"]
    vp = 2 * w + pads["FV_P_bf16" if bf16 else "FV_P_f32"]
    nrp = -(-rows * steps // 16) * 16
    return -(-rec // 16) * 16 + elt * (nrp * (dap + vp) + (w * dap if bf16 and w == 32 else 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [17, 24, 31])
def test_short_x_copy_routes_give_the_same_rows(d, dtype):
    """A masked short call's x copy at capacity 32, on a numpy model of the
    kernel's two routes: lstm_kernel.short_x_tma is lstm_fwd.cu's rule (a
    row's T D values whole 16-byte pieces); where it takes the TMA, every
    block's span (R rows from row0) starts and ends 16-byte aligned, and
    the span lands contiguous, then each value moves to its padded row;
    where it refuses, some block's span would break that, and plain loads
    fill the padded rows from device memory.  Both give the same bytes: x
    at columns < D of rows of XP (W + 8 in bf16, W in fp32), zeros at D ..
    W - 1, rows past the block's zero."""
    import os
    import re

    with open(os.path.join(os.path.dirname(lstm_kernel.__file__), "csrc", "lstm_fwd.cu")) as f:
        rule = r"constexpr bool short_x_tma\(int steps, int d, int elt\) \{ return steps \* d \* elt % 16 == 0; \}"
        assert re.search(rule, f.read())
    bf16, cap = dtype == torch.bfloat16, 32
    elt, xpw = (2, cap + 8) if bf16 else (4, cap)
    gen = torch.Generator().manual_seed(d)
    routes = set()
    for steps in (1, 17, 32, 50, 64):
        tma = lstm_kernel.short_x_tma(steps, d, bf16)
        assert tma == (steps * d * elt % 16 == 0) and lstm_kernel.short_x_tma(steps, cap, bf16)
        routes.add(tma)
        for rows, batch in ((1, 3), (2, 5), (4, 7)):
            x = torch.randn(batch, steps, d, generator=gen).to(dtype)
            flat = x.reshape(-1).view(torch.int16 if bf16 else torch.int32).numpy()  # x's bytes, a value an element
            spans = []
            for row0 in range(0, batch, rows):
                nrows = min(rows, batch - row0)
                start, n = row0 * steps * d, nrows * steps * d
                spans.append(start * elt % 16 == 0 and n * elt % 16 == 0)
                via_tma = np.zeros((rows * steps + 8, xpw), flat.dtype)
                via_loads = np.zeros_like(via_tma)
                landed = flat[start:start + n].copy()  # the TMA's contiguous copy in xp's space
                via_tma[:nrows * steps, :d] = landed.reshape(-1, d)
                via_loads[:nrows * steps, :d] = flat.reshape(-1, d)[start // d:start // d + nrows * steps]
                assert via_tma.tobytes() == via_loads.tobytes()
                want = x[row0:row0 + nrows].reshape(-1, d)
                got = torch.from_numpy(via_tma[:nrows * steps, :d].copy()).view(dtype)
                assert torch.equal(got, want) and not via_tma[:, d:cap].any() and not via_tma[nrows * steps:].any()
            assert all(spans) if tma else not all(spans), (steps, rows, batch)
    assert routes == ({True, False} if d != 24 else {True})


@pytest.mark.parametrize("masked", [False, True], ids=["square", "masked"])
@pytest.mark.parametrize("rows", lstm_kernel.BWD_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("width", lstm_kernel.FUSED_WIDTHS)
def test_fused_backward_shared_memory_fits_at_its_bound(width, dtype, rows, masked):
    """The fused backward's shared memory (lstm_bwd.cu's fused_smem_bytes,
    copied above) at the plan's FUSED_MAX_STEPS stays under the 227 KB a
    block may opt in to on an H100 at both rows variants and both widths; it
    grows with T (in whole 16-row tiles) and rows; its row pitches keep 16-byte rows (ldmatrix,
    float4) and, in bf16, 8 consecutive rows in distinct 16-byte bank groups.
    At W = 16 it is the size the plan's notes give (80384 bytes, fp32, two
    rows) and W = 32's (172544)."""
    bf16 = dtype == torch.bfloat16
    bound = lstm_kernel.FUSED_MAX_STEPS
    got = fused_smem(width, rows, bound, bf16)
    assert got <= BLOCK_SMEM_OPTIN
    assert all(fused_smem(width, rows, t, bf16) <= got for t in (17, 32, 50))
    assert fused_smem(width, rows, 1, bf16) < got
    assert rows == 2 or got < fused_smem(width, 2, bound, bf16)
    pads, elt = _fused_pads(), 2 if bf16 else 4
    for pitch in (4 * width + pads["FDA_P_bf16" if bf16 else "FDA_P_f32"],
                  2 * width + pads["FV_P_bf16" if bf16 else "FV_P_f32"]):
        assert pitch * elt % 16 == 0
        if bf16:
            words = pitch * elt // 4
            assert sorted(r * words % 32 for r in range(8)) == list(range(0, 32, 4))
    if not bf16 and rows == 2:
        assert got == {16: 80384, 32: 172544}[width]
    # the masked instantiation launches with the capacity's size (no D or H
    # in it): one cooperative launch site for both, fused_smem_bytes<T, R, W>
    import os
    import re

    with open(os.path.join(os.path.dirname(lstm_kernel.__file__), "csrc", "lstm_bwd.cu")) as f:
        text = f.read()
    assert re.findall(r"cudaLaunchCooperativeKernel\(\(const void\*\)lstm_bwd_fused_kernel<T, R, W, MASKED>,"
                      r"[^;]*fused_smem_bytes<T, R, W>\(a\.steps\)", text, re.S)
    assert f"launch_fused<T, {rows}, W, {'true' if masked else 'false'}>" in text


@pytest.mark.parametrize("missing", [(), (1, 4)], ids=["all", "some_missing"])
def test_fit_line_recovers_fixed_and_step(missing):
    """bench_lstm.py's fit of a short call, device ms = fixed + T x step:
    exact on points on a line, the T whose time the profiler missed (None)
    left out; fewer than two distinct T give (None, None)."""
    from awm_tpu_torch.ops.bench_lstm import fit_line

    ts = [1, 2, 8, 16, 32, 50, 64]
    ms = [None if i in missing else 0.0035 + t * 0.00021 for i, t in enumerate(ts)]
    fixed, step = fit_line(ts, ms)
    assert fixed == pytest.approx(0.0035, rel=1e-9) and step == pytest.approx(0.00021, rel=1e-9)
    assert fit_line([50, 50], [0.014, 0.015]) == (None, None)
    assert fit_line(ts, [None] * len(ts)) == (None, None)


@pytest.mark.parametrize("case", ["fp32", "offset_view", "bf16", "transposed"])
def test_weights_reach_the_kernels_fp32_and_aligned(case):
    """Every kernel reads fp32, contiguous, 8-byte aligned weights (the bf16
    ones load two at once and round them themselves): a model's fp32
    parameter passes as it is, a view at a 4-byte offset is copied, a bf16
    weight is widened exactly, a transposed one made contiguous."""
    base = torch.randn(128 * 32 + 1, generator=torch.Generator().manual_seed(0))
    w = {"fp32": base[:4096].view(128, 32), "offset_view": base[1:].view(128, 32),
         "bf16": base[:4096].view(128, 32).to(torch.bfloat16),
         "transposed": base[:4096].view(32, 128).t()}[case]
    got = lstm_kernel._weight(w)
    assert got.dtype == torch.float32 and got.is_contiguous() and got.data_ptr() % 8 == 0
    assert torch.equal(got, w.float())
    assert (got.data_ptr() == w.data_ptr()) == (case == "fp32")
    assert case != "offset_view" or w.data_ptr() % 8 == 4


def _case(rng, b, t, w=64):
    x = (rng.standard_normal((b, t, w)) * 0.3).astype(np.float32)
    w_ih = (rng.standard_normal((4 * w, w)) * 0.1).astype(np.float32)
    w_hh = (rng.standard_normal((4 * w, w)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal((4 * w,)) * 0.1).astype(np.float32)
    dy = (rng.standard_normal((b, t, w)) * 0.5).astype(np.float32)
    return x, (w_ih, w_hh, bias), dy


# T, width: the width-64 cases keep their ids; width 32 adds "-w32", 16 "-w16".
SHORT = pytest.mark.parametrize("t,w", [(1, 64), (2, 64), (3, 64), (1, 32), (2, 32), (3, 32),
                                        (1, 16), (2, 16), (3, 16)],
                                ids=["1", "2", "3", "1-w32", "2-w32", "3-w32", "1-w16", "2-w16", "3-w16"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@SHORT
def test_plain_forward_train_matches_pallas_short(rng, t, w, dtype):
    """Plain kernel B vs the TPU's _forward_train in interpret mode at B=3
    and T = 1, 2, 3.  The tolerances of test_plain_forward_train_matches_pallas:
    fp32 2e-5 (summation order); bf16 y 1e-2 (one bf16 ulp), cprev 1e-3."""
    x, weights, _ = _case(rng, 3, t, w)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        ref_y, ref_c = _forward_train(jnp.asarray(x).astype(jdtype), *map(jnp.asarray, weights))
    y, cprev = lstm_forward_train(torch.from_numpy(x).to(dtype), *map(torch.from_numpy, weights))
    assert y.shape == (3, t, w) and y.dtype == dtype and cprev.dtype == torch.float32
    assert float(cprev[:, 0].abs().max()) == 0.0  # c_{-1} = 0
    tol_y, tol_c = (2e-5, 2e-5) if dtype == torch.float32 else (1e-2, 1e-3)
    np.testing.assert_allclose(
        y.float().numpy(), np.swapaxes(np.asarray(ref_y.astype(jnp.float32)), 0, 1), atol=tol_y)
    np.testing.assert_allclose(cprev.numpy(), np.swapaxes(np.asarray(ref_c), 0, 1), atol=tol_c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@SHORT
def test_plain_backward_matches_pallas_short(rng, t, w, dtype):
    """Plain kernel C vs the TPU's _backward in interpret mode on the same
    (x, y, cprev, dy) at B=3 and T = 1, 2, 3, relative to each tensor's max:
    fp32 1e-5, bf16 1e-3 (test_plain_backward_matches_pallas's).  At T = 1
    h_{-1} = 0, so dW_hh is exactly zero on both sides."""
    x, weights, dy = _case(rng, 3, t, w)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx, jw = jnp.asarray(x).astype(jdtype), list(map(jnp.asarray, weights))
    with pltpu.force_tpu_interpret_mode():
        y_t, c_t = _forward_train(jx, *jw)
        ref = _backward(jnp.swapaxes(jx, 0, 1), y_t, c_t, jnp.swapaxes(jnp.asarray(dy), 0, 1),
                        *jw, dx_dtype=jx.dtype)
    y = torch.from_numpy(np.swapaxes(np.asarray(y_t.astype(jnp.float32)), 0, 1).copy()).to(dtype)
    cprev = torch.from_numpy(np.swapaxes(np.asarray(c_t), 0, 1).copy())
    got = lstm_backward(torch.from_numpy(x).to(dtype), y, cprev, torch.from_numpy(dy),
                        *map(torch.from_numpy, weights))
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    refs = (np.swapaxes(np.asarray(ref[0].astype(jnp.float32)), 0, 1),
            *(np.asarray(v) for v in ref[1:]))
    for name, a, r in zip(("dx", "dw_ih", "dw_hh", "db"), got, refs):
        a = a.float().numpy()
        assert a.shape == r.shape, name
        assert float(np.abs(a - r).max()) <= tol * float(np.abs(r).max()) + 1e-12, name
    if t == 1:
        assert float(got[2].abs().max()) == 0.0


# (D, H) of the new widths: masked within capacity 64 (the base family at
# channels 48, a D != H pair), within 32 and 16, and the cluster path (the
# base family at channels 128, 96, the ceiling, a wide input with a narrow
# hidden width and the reverse).
MASKED = [(48, 48), (40, 24), (17, 17), (20, 32), (9, 3)]
CLUSTER = [(96, 96), (128, 128), (256, 256), (200, 8), (8, 200), (130, 70)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d,h", MASKED + CLUSTER)
def test_plan_at_every_new_width(d, h, dtype):
    """A width that is not a capacity's square takes the smallest capacity
    with max(D, H) <= W; within capacities 32 and 16 at T <= 64 the fused
    backward where the grid fits and, in bf16 (MASKED_SHORT_DTYPES), the
    short forward, as their square calls do (the short path's measured
    costs for the forward's rows), else the ring forward and the four-launch
    backward, its capacity's measured costs at the blocks an SM runs; above
    64 the cluster
    path, ceil(H / 32) CTAs a cluster, sm_count // K clusters a wave, rows
    by the cluster path's measured costs at that K (where none is measured,
    the fewest rows that fit one wave).  Scratch at the real widths: da (B,
    T, 4H), dW partials (n, 4H, D + H), db (blocks, 4H); on the cluster
    path a window's da (B, tc, 4H) and the gate pass's records (B, tc, H,
    8); the blocks cover the batch once; the launch counters name the
    path.  Kernels A, B and C take the smallest capacity of WIDTHS (48 x 48
    capacity 48's square, 40 x 24 its masked instantiation) with its own
    costs and blocks an SM."""
    for batch in (1, 7, 64, 128, 512):
        for steps in (1, 50, 16000):
            plan = launch_plan(batch, steps, dtype, 132, d, None, h)
            window = plan.bwd_window if max(d, h) > 64 else steps
            assert 1 <= window <= steps
            assert plan.da_shape == (batch, window, 4 * h) and plan.da_dtype == dtype
            assert plan.part_shape == (plan.n_chunks, 4 * h, d + h)
            assert plan.db_part_shape == (plan.bwd_blocks, 4 * h)
            small = max(d, h) <= 32 and steps <= 64
            assert plan.fwd_short == (small and dtype == torch.bfloat16)
            assert plan.bwd_fused == (small and plan.bwd_blocks <= 132)
            for rows, blocks in ((plan.fwd_rows, plan.fwd_blocks), (plan.bwd_rows, plan.bwd_blocks)):
                assert blocks * rows >= batch > (blocks - 1) * rows
            names = [lstm_kernel.instantiation(k, dtype, d, h) for k in lstm_kernel.KERNELS]
            if max(d, h) > 64:
                assert (plan.capacity, plan.cluster) == (0, -(-h // 32)) and plan.cluster <= 8
                assert all(n.endswith("_cluster") for n in names)
                assert plan.rec_shape == (batch, window, h, lstm_kernel.CLUSTER_REC)
                slots = (132 // plan.cluster,) * 2
                costs = tuple(c.get((plan.cluster, dtype))
                              for c in (lstm_kernel.CLUSTER_FWD_STEP_COST, lstm_kernel.CLUSTER_BWD_STEP_COST))
            else:
                cap = min(w for w in lstm_kernel.WIDTHS if max(d, h) <= w)
                assert (plan.capacity, plan.cluster) == (cap, 0)
                assert cap == 48 if 32 < max(d, h) <= 48 else cap != 48
                assert all(n.endswith("_masked") for n in names) == (not d == h == cap)
                assert plan.rec_shape is None
                slots = (132 * lstm_kernel.BLOCKS_PER_SM.get((cap, dtype), 1),) * 2
                costs = ((lstm_kernel.SHORT_STEP_COST if plan.fwd_short else lstm_kernel.FWD_STEP_COST)[cap, dtype],
                         lstm_kernel.BWD_STEP_COST[cap, dtype])
            for rows, cost, at_once in zip((plan.fwd_rows, plan.bwd_rows), costs, slots):
                waves = lambda r: -(-(-(-batch // r)) // at_once)
                if cost is None:  # no cost measured at this K: the fewest rows that fit one wave
                    fits = [r for r in lstm_kernel.CLUSTER_ROWS if waves(r) == 1]
                    assert rows == (min(fits) if fits else max(lstm_kernel.CLUSTER_ROWS))
                else:
                    assert all(waves(rows) * cost[rows] <= waves(r) * cost[r] for r in cost)
            for name in names:
                assert name in lstm_kernel.launches
                assert lstm_kernel.entry_point(name) == "awm_" + name.removesuffix("_masked")


# (D, H) at the edges of capacities 32 and 16, masked: the widest masked
# squares, one unit short of the capacity either way, a width of one.
MASKED_EDGES = [(31, 31), (32, 31), (1, 32), (15, 16), (16, 15)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d,h", MASKED_EDGES, ids=[f"{d}x{h}" for d, h in MASKED_EDGES])
def test_masked_short_and_fused_at_the_boundaries(d, h, dtype):
    """A masked call of capacity 32 or 16 takes the fused backward at T <=
    64 where the grid fits (a fused-slots reading given: the reading's
    blocks at the plan's rows; withheld: one block an SM), the four launches
    past it and at 65; in bf16 the short forward at T = 1 and 64, the ring at
    65, and in fp32 the ring at every T (MASKED_SHORT_DTYPES: the masked fp32
    short path measured slower than the ring).  Its names are the capacity's
    masked counters; its backward's rows and path and, in bf16, its
    forward's are the square call's at the same capacity (the plan reads no
    width but the capacity on these paths); scratch at the real widths."""
    cap = 32 if max(d, h) > 16 else 16
    names = [lstm_kernel.instantiation(k, dtype, d, h) for k in lstm_kernel.KERNELS]
    assert names == [f"{k}_{'bf16' if dtype == torch.bfloat16 else 'f32'}_w{cap}_masked" for k in lstm_kernel.KERNELS]
    for steps in (1, 64, 65):
        within = steps <= 64
        for reading in (None, (264, 132), (7, 3), (0, 0)):
            for batch in (1, 7, 132, 133, 265):
                plan = launch_plan(batch, steps, dtype, 132, d, None, h, fused_slots=reading)
                square = launch_plan(batch, steps, dtype, 132, cap, fused_slots=reading)
                bf16 = dtype == torch.bfloat16
                assert plan.capacity == cap and plan.fwd_short == (within and bf16)
                at_once = 132 if reading is None else dict(zip(lstm_kernel.BWD_ROWS, reading))[plan.bwd_rows]
                assert plan.bwd_fused == (within and plan.bwd_blocks <= at_once), (steps, reading, batch)
                assert (plan.bwd_fused, plan.bwd_rows) == (square.bwd_fused, square.bwd_rows)
                if bf16 or not within:
                    assert (plan.fwd_short, plan.fwd_rows) == (square.fwd_short, square.fwd_rows)
                assert plan.da_shape == (batch, steps, 4 * h) and plan.part_shape[1:] == (4 * h, d + h)


def test_square_widths_keep_their_instantiations():
    """D = H = 64, 32, 16 keep the names, entry points and plans they had;
    the masked names run the same entry point as their capacity's square.
    D = H = 48 is capacity 48's square for kernels A, B and C (47 x 48 its
    masked one)."""
    for w, sfx in ((64, ""), (32, "_w32"), (16, "_w16")):
        for kernel in lstm_kernel.KERNELS:
            assert lstm_kernel.instantiation(kernel, torch.float32, w) == f"{kernel}_f32{sfx}"
            masked = lstm_kernel.instantiation(kernel, torch.bfloat16, w - 1, w)
            assert masked == f"{kernel}_bf16{sfx}_masked"
            assert lstm_kernel.entry_point(masked) == f"awm_{kernel}_bf16{sfx}"
        assert launch_plan(128, 16000, torch.float32, 132, w) == launch_plan(128, 16000, torch.float32, 132, w, None, w)
    for kernel in ("lstm_fwd", "lstm_fwd_train"):
        assert lstm_kernel.instantiation(kernel, torch.float32, 48) == f"{kernel}_f32_w48"
        masked = lstm_kernel.instantiation(kernel, torch.bfloat16, 47, 48)
        assert masked == f"{kernel}_bf16_w48_masked"
        assert lstm_kernel.entry_point(masked) == f"awm_{kernel}_bf16_w48"
    assert lstm_kernel.instantiation("lstm_bwd", torch.float32, 48) == "lstm_bwd_f32_w48"
    assert lstm_kernel.entry_point("lstm_bwd_f32_w48") == "awm_lstm_bwd_f32_w48"
    assert launch_plan(128, 16000, torch.float32, 132, 48) == launch_plan(128, 16000, torch.float32, 132, 48, None, 48)


# (D, H) at the edges of the capacities: each side of 16, 32, 48 and 64, and
# D != H pairs whose wider side picks the capacity.
BOUNDARY = [(1, 1), (16, 16), (17, 17), (32, 32), (33, 33), (47, 47), (48, 48), (49, 49), (63, 63), (64, 64),
            (40, 24), (24, 40), (1, 48), (48, 1)]


def _entry_points(source: str) -> set[str]:
    """The C entry points an ops/csrc/<source>.cu defines by its entry macros."""
    import os
    import re

    with open(os.path.join(os.path.dirname(lstm_kernel.__file__), "csrc", f"{source}.cu")) as f:
        return set(re.findall(r"^AWM_\w+_ENTRY\((awm_\w+),", f.read(), re.M))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d,h", BOUNDARY, ids=[f"{d}x{h}" for d, h in BOUNDARY])
def test_capacities_at_the_boundaries(d, h, dtype):
    """Kernels A, B and C take the smallest of 16, 32, 48, 64 that holds
    max(D, H): their names (square where D = H is the capacity, else
    masked) and launch counters, entry points that the source defines, and
    the plan's capacity.  The rows follow FWD_STEP_COST / BWD_STEP_COST and
    BLOCKS_PER_SM at that capacity."""
    need, sfx = max(d, h), "bf16" if dtype == torch.bfloat16 else "f32"
    cap = min(w for w in (16, 32, 48, 64) if need <= w)
    suffix = "" if cap == 64 else f"_w{cap}"
    for kernel in lstm_kernel.KERNELS:
        name = lstm_kernel.instantiation(kernel, dtype, d, h)
        assert name == f"{kernel}_{sfx}{suffix}" + ("" if d == h == cap else "_masked")
        assert name in lstm_kernel.launches
        assert lstm_kernel.entry_point(name) == f"awm_{kernel}_{sfx}{suffix}"
        assert lstm_kernel.entry_point(name) in _entry_points(lstm_kernel.source_of(name))
    assert lstm_kernel.capacity(d, h) == cap
    for batch in (1, 7, 128, 512):
        plan = launch_plan(batch, 16000, dtype, 132, d, None, h)
        assert plan.capacity == cap
        at_once = 132 * lstm_kernel.BLOCKS_PER_SM.get((cap, dtype), 1)
        for rows, cost in ((plan.fwd_rows, lstm_kernel.FWD_STEP_COST[cap, dtype]),
                           (plan.bwd_rows, lstm_kernel.BWD_STEP_COST[cap, dtype])):
            waves = lambda r: -(-(-(-batch // r)) // at_once)
            assert rows == min(cost, key=lambda r: (waves(r) * cost[r], r))


def _fwd_source_constants() -> dict[str, int]:
    """The ring's constants as lstm_fwd.cu and lstm_common.cuh declare them."""
    import os
    import re

    csrc = os.path.join(os.path.dirname(lstm_kernel.__file__), "csrc")
    text = "".join(open(os.path.join(csrc, f)).read() for f in ("lstm_fwd.cu", "lstm_common.cuh"))
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", text).group(1)) for k in ("S", "NBUF")}


SM_SMEM = 233472  # an H100 SM's shared memory (228 KB), of which each resident block takes 1 KB more


@pytest.mark.parametrize("rows", lstm_kernel.FWD_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ring_shared_memory_at_capacity_48(dtype, rows):
    """The ring path's buffers at capacity 48, by lstm_fwd.cu's
    fwd_smem_bytes: the ring of NBUF chunks of S steps, R rows and 4W fp32
    columns; h double-buffered (bf16: the mma's 8 B rows) and the chunk's x,
    rows padded by 8 bf16 (XP) so that the 8 rows an mma's B fragment reads
    fall in distinct banks (28 words apart at 48, as 36 at 64).  Within the
    227 KB a block may opt in to at every rows variant, and where the plan
    counts two blocks an SM (BLOCKS_PER_SM), two fit the SM's 228 KB."""
    src, w = _fwd_source_constants(), 48
    bf16 = dtype == torch.bfloat16
    elt, xp, h_rows = (2, w + 8, 8) if bf16 else (4, w, rows)
    smem = 4 * src["NBUF"] * src["S"] * rows * 4 * w + elt * (2 * h_rows * xp + rows * src["S"] * xp)
    assert smem <= BLOCK_SMEM_OPTIN
    assert smem % 16 == 0 and (4 * src["NBUF"] * src["S"] * rows * 4 * w) % 16 == 0  # h and x 16-byte aligned
    if bf16:
        words = xp * elt // 4
        assert sorted(g * words % 32 for g in range(8)) == list(range(0, 32, 4))
    for cap, blocks in lstm_kernel.BLOCKS_PER_SM.items():
        if cap == (w, dtype):
            assert blocks * (smem + 1024) <= SM_SMEM


# (D, H) of kernel C about capacity 48: its narrowest and widest squares,
# D != H both ways, a width of one beside 48; 49 stays on capacity 64.
C48_WIDTHS = [(33, 33), (40, 24), (24, 40), (1, 48), (48, 1), (48, 48), (49, 49)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d,h", C48_WIDTHS, ids=[f"{d}x{h}" for d, h in C48_WIDTHS])
def test_kernel_c_capacity_48(d, h, dtype):
    """Kernel C at max(D, H) in 33..48 runs capacity 48 (lstm_bwd_*_w48 at
    48 x 48, else lstm_bwd_*_w48_masked), through awm_lstm_bwd_*_w48, which
    lstm_bwd.cu defines; at 49 capacity 64 at runtime widths.  The plan's
    capacity, the four-launch path (no fused path at 48) and scratch at the
    real widths."""
    sfx = "bf16" if dtype == torch.bfloat16 else "f32"
    cap = 48 if max(d, h) <= 48 else 64
    suffix = "_w48" if cap == 48 else ""
    name = lstm_kernel.instantiation("lstm_bwd", dtype, d, h)
    assert name == f"lstm_bwd_{sfx}{suffix}" + ("" if d == h == cap else "_masked")
    assert lstm_kernel.entry_point(name) == f"awm_lstm_bwd_{sfx}{suffix}"
    assert lstm_kernel.entry_point(name) in _entry_points("lstm_bwd")
    assert name in lstm_kernel.launches and lstm_kernel.source_of(name) == "lstm_bwd"
    for batch, steps in ((5, 37), (128, 16000)):
        plan = launch_plan(batch, steps, dtype, 132, d, None, h)
        assert plan.capacity == cap and not plan.bwd_fused and plan.cluster == 0
        assert plan.da_shape == (batch, steps, 4 * h) and plan.db_part_shape == (plan.bwd_blocks, 4 * h)
        assert plan.part_shape == (plan.n_chunks, 4 * h, d + h) and plan.dx_blocks >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bwd_step_cost_at_capacity_48(dtype):
    """BWD_STEP_COST has capacity 48's measured costs for every rows variant
    of the recurrence (one row = 1), a second row costing more than nothing
    and less than a second wave of one row."""
    cost = lstm_kernel.BWD_STEP_COST[48, dtype]
    assert sorted(cost) == sorted(lstm_kernel.BWD_ROWS) and cost[1] == 1.0
    assert 1.0 < cost[2] < 2 * 2.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [32, 128])
def test_plan_rows_at_capacity_48(batch, dtype):
    """The channels-48 family's main shapes (the train step at B=32 and the
    timed B=128): one wave of one-row blocks for A, B and C (a second row
    costs more than nothing, and ties go to fewer rows); dW chunks that
    cover the (B*T) axis; the launch counters of capacity 48's squares."""
    plan = launch_plan(batch, 16000, dtype, 132, 48)
    assert (plan.capacity, plan.fwd_rows, plan.bwd_rows) == (48, 1, 1)
    assert (plan.fwd_blocks, plan.bwd_blocks) == (batch, batch) and not plan.fwd_short
    assert plan.n_chunks * -(-batch * 16000 // plan.n_chunks) >= batch * 16000
    assert all(lstm_kernel.instantiation(k, dtype, 48).endswith("_w48") for k in lstm_kernel.KERNELS)


def _bwd_source_constants() -> dict[str, int]:
    """The recurrence's constants as lstm_bwd.cu and lstm_common.cuh declare them."""
    import os
    import re

    csrc = os.path.join(os.path.dirname(lstm_kernel.__file__), "csrc")
    text = "".join(open(os.path.join(csrc, f)).read() for f in ("lstm_bwd.cu", "lstm_common.cuh"))
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", text).group(1)) for k in ("SB", "NBUF")}


@pytest.mark.parametrize("rows", lstm_kernel.BWD_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rec_shared_memory_at_capacity_48(dtype, rows):
    """Kernel C's recurrent block at capacity 48, by lstm_bwd.cu's
    rec_smem_bytes: fp32 [W_ih | W_hh] staged (4W x 2W), the ring of NBUF
    chunks of SB steps (4W factors and 3W unit values a (step, row)),
    c_{t-1}, da double-buffered at 4 (W + 8) a row, and x_t | h_{t-1} (bf16
    rows padded by 8).  Within what one block may opt in to, every section
    16-byte aligned (the bf16 producers' float4 ring stores, the consumers'
    float4 da loads), and the bf16 rows' 8-row mma reads in distinct banks."""
    src, w = _bwd_source_constants(), 48
    bf16 = dtype == torch.bfloat16
    elt, kp = (2, 2 * w + 8) if bf16 else (4, 2 * w)
    sections = [0 if bf16 else 4 * 4 * w * 2 * w, 4 * src["NBUF"] * src["SB"] * rows * 7 * w,
                4 * rows * src["SB"] * w, 4 * 2 * rows * 4 * (w + 8), elt * rows * src["SB"] * kp]
    assert sum(sections) <= BLOCK_SMEM_OPTIN
    assert all(sum(sections[:i]) % 16 == 0 for i in range(1, len(sections)))
    assert (7 * w * 4) % 16 == 0 and ((w + 8) * 4) % 16 == 0  # a ring entry, a gate's da
    if bf16:
        assert sorted(g * (kp * elt // 4) % 32 for g in range(8)) == list(range(0, 32, 4))


def _fma32(a, b, c):
    """fmaf on float32 arrays: the product is exact in float64."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _xor(v, m):
    """v of lane l ^ m, for every lane l (a shuffle by XOR)."""
    return v[np.arange(32) ^ m]


def _dh_model(da, w_hh, h, cap):
    """dh_{t-1} = da . W_hh of units 0..h-1 as lstm_bwd.cu's consumer warps
    form it at capacity cap (48 or 64), and the (unit, lane) -> [(gate,
    column)] terms each lane sums.  Lane (og = lane / 16, jp = lane % 16) of
    warp k takes units 8 k + 4 og .. + 3 and columns EP jp .. EP jp + EP - 1
    of each gate q (EP = 4 at both capacities), one running fmaf sum in the
    order (q, e); lanes with EP jp >= cap read nothing and give +0 (capacity
    48's lanes 12-15); then transpose_reduce4<8, 4> and the butterflies over
    lanes 2 and 1 apart.  da (4, cap): the gates' da, the columns past h
    the padded units'; weights past h are +0, as load_wm gives them."""
    ep = 4
    lanes = np.arange(32)
    og, jp = lanes >> 4, lanes & 15
    hi, lo = (jp & 8) != 0, (jp & 4) != 0
    dh = np.zeros(cap, np.float32)
    terms = {}
    for k in range(cap // 8):
        unit0 = 8 * k + 4 * og
        part = np.zeros((4, 32), np.float32)  # [o][lane]
        for q in range(4):
            for e in range(ep):
                col = ep * jp + e
                live = ep * jp < cap
                ve = np.where(live, da[q, np.minimum(col, cap - 1)], np.float32(0.0)).astype(np.float32)
                for o in range(4):
                    u = unit0 + o
                    w = np.where(live & (col < h) & (u < h), w_hh[q * h + np.minimum(col, h - 1), np.minimum(u, h - 1)],
                                 np.float32(0.0)).astype(np.float32)
                    part[o] = _fma32(ve, w, part[o])
                    for lane in lanes[live]:
                        terms.setdefault((int(u[lane]), int(lane)), []).append((q, int(col[lane])))
        b0 = np.where(hi, part[2], part[0]) + _xor(np.where(hi, part[0], part[2]), 8)
        b1 = np.where(hi, part[3], part[1]) + _xor(np.where(hi, part[1], part[3]), 8)
        out = np.where(lo, b1, b0) + _xor(np.where(lo, b0, b1), 4)
        out = out + _xor(out, 2)
        out = out + _xor(out, 1)
        dh[8 * k: 8 * k + 8] = out[::4]  # lane 4 u' holds unit u' of the warp, as do its three neighbours
        assert all(np.array_equal(out[i::4].view(np.uint32), out[::4].view(np.uint32)) for i in range(4))
    return dh[:h], terms


@pytest.mark.parametrize("h", [33, 40, 47, 48])
def test_dh_lane_split_keeps_capacity_64_bits(h):
    """Kernel C's dh product at capacity 48 keeps capacity 64's lane split
    (lstm_bwd.cu: EP = 4 at W = 48, lanes jp >= 12 idle): every lane of a
    unit sums the same (gate, column) terms in the same order at both
    capacities, less capacity 64's terms past column 47, whose weights are
    exactly zero; the two fp32 sums in the tree's order give the same bits
    for random da and W_hh (zeros past h), with signed zeros in the padded
    units' da."""
    import os
    import re

    with open(os.path.join(os.path.dirname(lstm_kernel.__file__), "csrc", "lstm_bwd.cu")) as f:
        src = f.read()
    assert re.search(r"constexpr int EP = W == 48 \? 4 : H / 16;", src)  # the split this model follows
    rng = np.random.default_rng(h)
    w_hh = rng.standard_normal((4 * h, h)).astype(np.float32)
    for trial in range(20):
        real = (rng.standard_normal((4, h)) * 10.0 ** rng.integers(-3, 3)).astype(np.float32)
        da = {}
        for cap in (48, 64):
            pad = np.where(rng.random((4, cap - h)) < 0.5, np.float32(-0.0), np.float32(0.0)).astype(np.float32)
            da[cap] = np.concatenate([real, pad], axis=1)
        dh48, terms48 = _dh_model(da[48], w_hh, h, 48)
        dh64, terms64 = _dh_model(da[64], w_hh, h, 64)
        assert np.array_equal(dh48.view(np.uint32), dh64.view(np.uint32)), trial
    for (unit, lane), t64 in terms64.items():
        if unit < h:
            assert terms48.get((unit, lane), []) == [(q, c) for q, c in t64 if c < 48]
            assert all(c >= h for q, c in t64 if c >= 48)


def _cluster_waves(batch: int, rows: int, slots: int) -> int:
    return -(-(-(-batch // rows)) // slots)


@pytest.mark.parametrize("sm_count", [8, 132])
def test_cluster_plan_counts_clusters_a_wave(sm_count):
    """On the cluster path a wave holds sm_count // K clusters (one CTA an
    SM) where the card's reading is not given: rows a cluster among
    CLUSTER_ROWS (1, 2, 4, 8) in both kernels, the clusters cover the batch,
    a rows override of the backward takes every built variant and refuses
    any other; at K = 3, 4, 8 the rows take the fewest waves at the measured
    cost of a wave of that many rows (ties to fewer rows), and at K = 7 (H =
    200, no cost measured) the fewest rows that fit one wave, or 8."""
    for h in (65, 96, 128, 200, 256):
        k = -(-h // 32)
        slots = max(1, sm_count // k)
        for dtype in (torch.float32, torch.bfloat16):
            for batch in (1, 32, 300, 512):
                plan = launch_plan(batch, 16000, dtype, sm_count, h)
                assert plan.cluster == k and plan.fwd_rows in lstm_kernel.CLUSTER_ROWS
                assert plan.fwd_blocks * plan.fwd_rows >= batch > (plan.fwd_blocks - 1) * plan.fwd_rows
                assert plan.bwd_rows in lstm_kernel.CLUSTER_ROWS
                for rows, costs in ((plan.fwd_rows, lstm_kernel.CLUSTER_FWD_STEP_COST),
                                    (plan.bwd_rows, lstm_kernel.CLUSTER_BWD_STEP_COST)):
                    cost = costs.get((k, dtype))
                    if cost is None:
                        fits = [r for r in lstm_kernel.CLUSTER_ROWS if _cluster_waves(batch, r, slots) == 1]
                        assert rows == (min(fits) if fits else 8), (h, batch)
                    else:
                        assert k in (3, 4, 8)
                        best = min((_cluster_waves(batch, r, slots) * cost[r], r) for r in lstm_kernel.CLUSTER_ROWS)
                        assert (_cluster_waves(batch, rows, slots) * cost[rows], rows) == best, (h, batch)
        for rows in lstm_kernel.CLUSTER_ROWS:
            assert launch_plan(300, 16000, torch.bfloat16, sm_count, h, rows).bwd_blocks == -(-300 // rows)
        with pytest.raises(ValueError, match="rows"):
            launch_plan(300, 16000, torch.bfloat16, sm_count, h, 3)
    if sm_count == 132:
        # K = 7 (H = 200): 18 clusters a wave; B=512 fits none, so 8 rows; B=32 two
        for dtype in (torch.float32, torch.bfloat16):
            assert (launch_plan(512, 16000, dtype, 132, 200).fwd_rows,
                    launch_plan(512, 16000, dtype, 132, 200).bwd_rows) == (8, 8)
            assert launch_plan(32, 16000, dtype, 132, 200).fwd_rows == 2


def test_cluster_plan_takes_the_clusters_the_card_holds():
    """Given the card's reading (cudaOccupancyMaxActiveClusters: 30 clusters
    of 4 CTAs on an H100, not 132 // 4 = 33, at every rows variant), the
    waves count 30: the base family at channels 128 takes one wave on its
    main path (the session's B=64: 4 rows or more; the train step's B=32: 2
    or more) in both dtypes, where PR 12's plan took two; kernel C at the
    timed B=128 fewer than the 5 waves of one row.  A reading of fewer
    clusters for a rows variant moves the choice by it."""
    on_card = ((30,) * 4, (30,) * 4)
    plan = lambda b, dt, slots=on_card: launch_plan(b, 16000, dt, 132, 128, None, 128, slots)
    for dtype in (torch.float32, torch.bfloat16):
        assert _cluster_waves(64, plan(64, dtype).fwd_rows, 30) == 1 and plan(64, dtype).fwd_rows >= 4
        assert _cluster_waves(32, plan(32, dtype).fwd_rows, 30) == 1
        assert _cluster_waves(32, plan(32, dtype).bwd_rows, 30) == 1
        assert _cluster_waves(128, plan(128, dtype).bwd_rows, 30) < 5
        # with no 4- or 8-row cluster resident, B=64 cannot take one wave
        few = ((30, 30, 0, 0), (30, 30, 0, 0))
        assert plan(64, dtype, few).fwd_rows in (1, 2)


# The cluster path's measured K (96, 128, 256 at the card's reading) and the
# batches of the main paths, the timed shapes and the edges.
CLUSTER_K = {3: (96, 39), 4: (128, 30), 8: (256, 15)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 7, 32, 64, 128, 512])
@pytest.mark.parametrize("k", sorted(CLUSTER_K))
def test_cluster_plan_rows_waves_and_scratch(k, batch, dtype):
    """The plan at K = 3, 4, 8 on an H100's reading of the clusters it
    holds: rows a cluster that take the fewest waves at the measured cost
    (ties to fewer rows), clusters that cover the batch once, and the
    backward's scratch at the real widths: a window's gate-pass records (B,
    tc, H, 8) fp32 and da (B, tc, 4H) in the operand type, within
    CLUSTER_SCRATCH_BYTES, db per cluster.  At K = 4
    the base family's main path (session B=64, train step B=32) takes one
    wave."""
    h, per_wave = CLUSTER_K[k]
    slots = ((per_wave,) * 4,) * 2
    plan = launch_plan(batch, 16000, dtype, 132, h, None, h, slots)
    assert plan.cluster == k
    for rows, blocks, costs in ((plan.fwd_rows, plan.fwd_blocks, lstm_kernel.CLUSTER_FWD_STEP_COST),
                                (plan.bwd_rows, plan.bwd_blocks, lstm_kernel.CLUSTER_BWD_STEP_COST)):
        assert blocks * rows >= batch > (blocks - 1) * rows
        cost = costs[k, dtype]
        assert set(cost) == set(lstm_kernel.CLUSTER_ROWS) and cost[1] == 1.0
        best = min((_cluster_waves(batch, r, per_wave) * cost[r], r) for r in lstm_kernel.CLUSTER_ROWS)
        assert (_cluster_waves(batch, rows, per_wave) * cost[rows], rows) == best
    tc = plan.bwd_window
    assert plan.rec_shape == (batch, tc, h, 8) and plan.da_shape == (batch, tc, 4 * h)
    assert 1 <= tc <= 16000 and plan.scratch_bytes("lstm_bwd") <= lstm_kernel.CLUSTER_SCRATCH_BYTES
    assert plan.da_dtype == dtype and plan.db_part_shape == (plan.bwd_blocks, 4 * h)
    if k == 4 and batch in (32, 64):
        rows = plan.fwd_rows if batch == 64 else max(plan.fwd_rows, plan.bwd_rows)
        assert _cluster_waves(batch, rows, per_wave) == 1
        assert _cluster_waves(batch, plan.bwd_rows, per_wave) == 1 or batch == 64


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [96, 128, 256])
@pytest.mark.parametrize("batch", [1, 7, 128, 512, 1024, 4096])
def test_cluster_backward_windows_stay_within_the_budget(batch, h, dtype):
    """Kernel C on the cluster path at T=16000 (D = H): its windows keep
    every scratch tensor the call allocates (a window's records (B, tc, H, 8)
    fp32 and da (B, tc, 4H), the dW and db partials, the carried (dh, dc)
    and each row's db, bf16's packed W_hh and W_ih) within
    CLUSTER_SCRATCH_BYTES for B up to 4096; a call whose whole T fits the
    budget runs one window (the parent's launches, so the parent's bits),
    and one that does not (the records alone 67 GB at H = 256, B = 512,
    bf16) runs the longest window that fits."""
    plan = launch_plan(batch, 16000, dtype, 132, h, None, h, ((15,) * 4,) * 2)
    tc, budget = plan.bwd_window, lstm_kernel.CLUSTER_SCRATCH_BYTES
    assert plan.cluster and plan.rec_shape == (batch, tc, h, 8) and plan.da_shape == (batch, tc, 4 * h)
    assert plan.state_shape == (batch, h) and 1 <= tc <= 16000
    assert plan.scratch_bytes("lstm_bwd") <= budget
    bf16 = dtype == torch.bfloat16
    assert plan.wih == (4 * h * h if bf16 else 0)
    assert plan.bwd_pack == (lstm_kernel.wide_pack_elems(True, True, h) if bf16 else 0)
    whole = dataclasses.replace(plan, rec_shape=(batch, 16000, h, 8), da_shape=(batch, 16000, 4 * h))
    # one step more would not fit beside the quarter of the budget kept for the dW partials
    longer = dataclasses.replace(plan, rec_shape=(batch, tc + 1, h, 8), da_shape=(batch, tc + 1, 4 * h),
                                 part_shape=(1, 1, budget // 16))
    if whole.scratch_bytes("lstm_bwd") <= budget:
        assert tc == 16000
    else:
        assert tc < 16000 and longer.scratch_bytes("lstm_bwd") > budget
    if (batch, h, dtype) == (512, 256, torch.bfloat16):
        assert whole.scratch_bytes("lstm_bwd") > 80 * 10**9 and tc < 16000


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch,steps", [(7, 65), (32, 17), (128, 50), (32, 2000)])
def test_cluster_backward_short_calls_take_one_window(batch, steps, dtype):
    """A cluster call whose whole T fits the budget (the hash shapes, the
    strided-length and main-path calls below) runs one window of every
    step, with the dW chunks of one pass over all its rows."""
    for h in (96, 128, 256):
        plan = launch_plan(batch, steps, dtype, 132, h, None, h)
        assert plan.bwd_window == steps and plan.rec_shape == (batch, steps, h, 8)
        n_rows = batch * steps
        assert plan.n_chunks == max(1, min(lstm_kernel.DW_MAX_CHUNKS, max(-(-n_rows // lstm_kernel.DW_CHUNK_ROWS),
                                                                         min(132, -(-n_rows // 64)))))


@pytest.mark.parametrize("d,h", [(48, 48), (40, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_zero_padded_weights_leave_padded_units_zero(rng, d, h, dtype):
    """The plain version on weights zero-padded to capacity 64 (what the
    masked kernels compute): the padded units' outputs are exactly 0 in y,
    c_{t-1} and the backward's dx columns, dW and db rows and columns past
    the real widths; the real units within 1e-6 of the unpadded call
    (relative to each tensor's max where it exceeds 1).  bf16 rounds at the
    same points on both sides, but the padded products sum their zeros in
    another order, so a bf16 output (y, dx) may land one bf16 ulp (2^-8
    relative) away."""
    t, w = 24, 64
    x, (w_ih, w_hh, bias), dy = _case(rng, 2, t, w)
    x, dy = x[..., :d], dy[..., :h]
    gate = lambda a: a.reshape(4, w, *a.shape[1:])
    wi, wh, bb = gate(w_ih)[:, :h, :d].reshape(4 * h, d), gate(w_hh)[:, :h, :h].reshape(4 * h, h), gate(bias)[:, :h].reshape(-1)
    pad_w = lambda m, cols: np.pad(m.reshape(4, h, cols), ((0, 0), (0, w - h), (0, w - cols))).reshape(4 * w, w)
    tx, tdy = torch.from_numpy(np.ascontiguousarray(x)).to(dtype), torch.from_numpy(np.ascontiguousarray(dy))
    txp = torch.from_numpy(np.pad(x, ((0, 0), (0, 0), (0, w - d)))).to(dtype)
    tdyp = torch.from_numpy(np.pad(dy, ((0, 0), (0, 0), (0, w - h))))
    wp = [torch.from_numpy(a) for a in (pad_w(wi, d), pad_w(wh, h), np.pad(bb.reshape(4, h), ((0, 0), (0, w - h))).reshape(-1))]
    wr = [torch.from_numpy(np.ascontiguousarray(a)) for a in (wi, wh, bb)]
    y, c = lstm_forward_train(tx, *wr)
    yp, cp = lstm_forward_train(txp, *wp)
    assert float(yp[..., h:].float().abs().max()) == 0.0 and float(cp[..., h:].abs().max()) == 0.0
    ulp = 0.0 if dtype == torch.float32 else 2.0**-8
    assert float((yp[..., :h].float() - y.float()).abs().max()) <= 1e-6 + ulp * float(y.float().abs().max())
    assert float((cp[..., :h] - c).abs().max()) <= 1e-6 + 4 * ulp
    g = lstm_backward(tx, y, c, tdy, *wr)
    # the backward of both on the same forward (the unpadded one's, zero-padded):
    # a bf16 y one ulp apart would move the gradients by far more than the order
    pad_h = lambda a: torch.nn.functional.pad(a, (0, w - h))
    gp = lstm_backward(txp, pad_h(y), pad_h(c), tdyp, *wp)
    dxp, dwip, dwhp, dbp = (gp[0].float(), gate(gp[1]), gate(gp[2]), gate(gp[3]))
    assert float(dxp[..., d:].abs().max()) == 0.0
    assert float(dwip[:, h:].abs().max()) == 0.0 and float(dwip[:, :, d:].abs().max()) == 0.0
    assert float(dwhp[:, h:].abs().max()) == 0.0 and float(dwhp[:, :, h:].abs().max()) == 0.0
    assert float(dbp[:, h:].abs().max()) == 0.0
    for a, r, rounds in ((dxp[..., :d], g[0].float(), ulp), (dwip[:, :h, :d].reshape(4 * h, d), g[1], 0.0),
                         (dwhp[:, :h, :h].reshape(4 * h, h), g[2], 0.0), (dbp[:, :h].reshape(-1), g[3], 0.0)):
        assert float((a - r).abs().max()) <= (1e-6 + rounds) * max(1.0, float(r.abs().max()))


# (D, H) on the wide path: one unit past the cluster path, a ragged last CTA,
# the base family at channels 320 and 512, the largest width the card holds
# (1024), and D != H both ways.
WIDE = [(257, 257), (300, 300), (320, 320), (512, 512), (1024, 1024), (300, 40), (40, 600)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d,h", WIDE, ids=[f"{d}x{h}" for d, h in WIDE])
def test_wide_plan(d, h, dtype):
    """Past 256 the plan takes the wide path: instantiations *_wide in
    lstm_wide.cu, row groups of ceil(H / 16) CTAs, rows a group from
    WIDE_ROWS that cover the batch once in the fewest launches of the row
    groups the card holds at once (a given slot count), then the fewest rows,
    windows of time within [1, T] whose scratch (the plan's shapes: a
    window's projection, records and da, the dW and db partials, the packed
    W_hh, the carried state) stays within WIDE_SCRATCH_BYTES, the same
    windows at any T past them."""
    k = -(-h // lstm_kernel.WIDE_UNITS)
    for kernel in lstm_kernel.KERNELS:
        name = lstm_kernel.instantiation(kernel, dtype, d, h)
        assert name.endswith("_wide") and lstm_kernel.source_of(name) == "lstm_wide"
        assert name in lstm_kernel.launches and lstm_kernel.entry_point(name) == "awm_" + name
    # a card that holds one CTA an SM up to 32 rows and one every other SM past them
    slots = (tuple(132 if r <= 32 else 66 for r in lstm_kernel.WIDE_ROWS),) * 2
    for batch in (1, 7, 8, 64, 128, 512):
        for steps in (1, 17, 512, 16000):
            for given in (None, slots):
                plan = launch_plan(batch, steps, dtype, 132, d, None, h, wide_slots=given)
                assert plan.wide and not plan.fwd_short and not plan.bwd_fused
                per = dict(zip(lstm_kernel.WIDE_ROWS, given[0] if given else (132,) * len(lstm_kernel.WIDE_ROWS)))
                launches = lambda r: -(-(-(-batch // r)) // (per[r] // k))
                for rows, groups in ((plan.fwd_rows, plan.fwd_blocks), (plan.bwd_rows, plan.bwd_blocks)):
                    assert rows in lstm_kernel.WIDE_ROWS and groups * rows >= batch > (groups - 1) * rows
                    assert all((launches(rows), rows) <= (launches(r), r) for r in lstm_kernel.WIDE_ROWS)
                for window in (plan.fwd_window, plan.bwd_window):
                    assert 1 <= window <= steps
                assert plan.xp_shape == (batch, plan.fwd_window, 4 * h)
                assert plan.da_shape == (batch, plan.bwd_window, 4 * h) and plan.da_dtype == dtype
                assert plan.rec_shape == (batch, plan.bwd_window, h, lstm_kernel.CLUSTER_REC)
                assert plan.part_shape == (plan.n_chunks, 4 * h, d + h)
                assert plan.db_part_shape == (plan.bwd_blocks, 4 * h) and plan.state_shape == (batch, h)
                bf16 = dtype == torch.bfloat16
                assert plan.fwd_pack == k * 64 * lstm_kernel.wide_pitch(h, bf16)
                assert plan.bwd_pack == k * 16 * lstm_kernel.wide_pitch(4 * h, bf16)
                for kernel in lstm_kernel.KERNELS:
                    assert plan.scratch_bytes(kernel) <= lstm_kernel.WIDE_SCRATCH_BYTES
                if steps == 16000:  # windows shorter than T: the same at any longer T
                    longer = launch_plan(batch, 10**6, dtype, 132, d, None, h, wide_slots=given)
                    if plan.bwd_window < steps:
                        assert longer.bwd_window == plan.bwd_window
                    if plan.fwd_window < steps:
                        assert longer.fwd_window == plan.fwd_window


# H past what the card holds of a row group at once (132 slots: H > 2112),
# and the widest that it does: (H, the CTAs a group, unit tiles of the CTA
# that owns the most); past the widths one staged row of h / da used to cap
# (fp32 C and bf16 A / B 14592, bf16 C 28672) and fp32 A / B's (60000)
TILED = [(2112, 132, 1), (2113, 67, 2), (2304, 72, 2), (4096, 128, 2), (8192, 128, 4),
         (14592, 131, 7), (28672, 128, 14), (60000, 130, 29)]
OPTIN = 232448  # the shared memory a CTA may opt in to on an H100 (227 KB)


def _mirror_slots(bwd: bool, bf16: bool, h: int, w_smem: bool, sm_count: int = 132) -> tuple:
    """The CTAs a card of sm_count SMs (one CTA an SM) holds of the wide
    recurrence at each of WIDE_ROWS, by lstm_wide.cu's shared memory as
    wide_smem and wide_chunk mirror it: 0 where a CTA of that many rows does
    not fit OPTIN with W_hh's slice where w_smem says."""
    return tuple(sm_count if lstm_kernel.wide_smem(bwd, bf16, h, r, w_smem,
                                                   lstm_kernel.wide_chunk(bwd, bf16, h, r, OPTIN)) <= OPTIN else 0
                 for r in lstm_kernel.WIDE_ROWS)


@pytest.mark.parametrize("h,ctas,tiles", TILED, ids=[f"H{h}" for h, _, _ in TILED])
def test_wide_plan_tiles_past_what_the_card_holds(h, ctas, tiles):
    """Where no rows variant holds a row group's ceil(H / 16) CTAs at once,
    the plan takes fewer CTAs a group, each of more unit tiles, spread
    evenly (wide_ctas, lstm_wide.cu's group_ctas), and the rows with the
    fewest launches times tiles; C's scratch counts db_rows (B, 4H) fp32
    and stays within the budget (up to H = 4096).  A CTA's shared memory no
    longer grows with H (the staged h / da come in chunks, W_hh's slice is
    read from global memory), so at every rows variant a CTA fits the card
    (the slots wide_smem gives) and every kernel and type has a launch
    shape, past the widths whole-row staging capped too; only a reading of
    no CTA at all raises."""
    k = -(-h // lstm_kernel.WIDE_UNITS)
    assert lstm_kernel.wide_ctas(k, 132) == ctas and -(-k // ctas) == tiles
    assert lstm_kernel.wide_ctas(k, k) == k and lstm_kernel.wide_ctas(k, 0) == 0
    slots = (tuple(132 if r <= 8 else 0 for r in lstm_kernel.WIDE_ROWS),) * 2
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        mirrored = tuple(_mirror_slots(bwd, bf16, h, False) for bwd in (False, True))
        assert all(n == 132 for pair in mirrored for n in pair), mirrored
        for batch in (1, 7, 128):
            plan = launch_plan(batch, 16000, dtype, 132, h, None, None, wide_slots=slots)
            assert (plan.fwd_ctas, plan.bwd_ctas) == (ctas, ctas)
            # one group a launch: the fewest groups of up to 8 rows, then the fewest rows
            assert plan.fwd_rows == plan.bwd_rows == min(r for r in lstm_kernel.WIDE_ROWS if r >= min(batch, 8))
            with_rows, without = (dataclasses.replace(plan, da_shape=(n, 0, 4 * h)).scratch_bytes("lstm_bwd")
                                  for n in (batch, 0))
            assert with_rows - without == 4 * batch * 4 * h  # db_rows (B, 4H) fp32
            # past 4096 the packed W_hh and one dW partial alone pass the budget (they grow with H^2, not T)
            for kernel in lstm_kernel.KERNELS:
                assert h > 4096 or plan.scratch_bytes(kernel) <= lstm_kernel.WIDE_SCRATCH_BYTES
            shaped = launch_plan(batch, 16000, dtype, 132, h, None, None, wide_slots=mirrored)
            assert 1 <= shaped.fwd_ctas <= k and 1 <= shaped.bwd_ctas <= k
            assert shaped.fwd_rows in lstm_kernel.WIDE_ROWS and shaped.bwd_rows in lstm_kernel.WIDE_ROWS
            assert 1 <= shaped.fwd_window <= 16000 and 1 <= shaped.bwd_window <= 16000
    with pytest.raises(RuntimeError, match="no CTA"):
        launch_plan(3, 10, torch.float32, 132, h, None, None, wide_slots=((0,) * 7, (0,) * 7))


@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wide_smem_stays_within_a_chunk_past_the_row(bwd, dtype):
    """wide_smem (lstm_wide.cu's count) without W_hh's slice: staged in
    chunks, a CTA of up to 64 rows fits the card at any H, and the same CTA
    at twice the width takes the same bytes; A / B's whole row (wide_chunk's
    choice where it fits) fits OPTIN wherever it is chosen."""
    bf16 = dtype == torch.bfloat16
    for h in (257, 512, 4352, 14592, 28672, 60000):
        for rows in lstm_kernel.WIDE_ROWS:
            chunk = lstm_kernel.wide_chunk(bwd, bf16, h, rows, OPTIN)
            whole = -(-(4 * h if bwd else h) // 16) * 16
            assert chunk == (whole if not bwd and lstm_kernel.wide_smem(False, bf16, h, rows, False, whole) <= OPTIN
                             else min(lstm_kernel.WIDE_CHUNK[bf16], whole))
            assert lstm_kernel.wide_smem(bwd, bf16, h, rows, False, chunk) <= OPTIN
            if chunk < whole:
                part = lstm_kernel.WIDE_CHUNK[bf16]
                assert (lstm_kernel.wide_smem(bwd, bf16, h, rows, False, part)
                        == lstm_kernel.wide_smem(bwd, bf16, 2 * h, rows, False, part))
    assert lstm_kernel.wide_chunk(bwd, bf16, 512, 8, OPTIN, chunk=40) == 48  # a given chunk: whole k-tiles
    assert lstm_kernel.wide_chunk(bwd, bf16, 512, 8, OPTIN, chunk=10**6) == (2048 if bwd else 512)  # at most the row


def test_wide_fp32_backward_plan_at_512_takes_one_launch():
    """fp32 C at B=128, D = H = 512 (the channels-512 train step's widths):
    with da staged in chunks, 32 rows a group keep W_hh's 131 KB slice in
    shared memory (the slots wide_smem gives, W_hh's slice in shared memory
    where it fits), so the plan takes 32 rows, 4 row groups of 32 CTAs, one
    cooperative launch a window.  The whole row of da (8.2 KB a row) would
    leave room for 8 rows only: 16 groups in 4 launches."""
    h, optin = 512, OPTIN
    slots = _mirror_slots(True, False, h, True)
    assert dict(zip(lstm_kernel.WIDE_ROWS, slots)) == {1: 132, 2: 132, 4: 132, 8: 132, 16: 132, 32: 132, 64: 0}
    chunk = lstm_kernel.wide_chunk(True, False, h, 32, optin)
    assert chunk == lstm_kernel.WIDE_CHUNK[False] == 128
    assert lstm_kernel.wide_smem(True, False, h, 32, True, chunk) <= optin
    whole = lstm_kernel.wide_smem(True, False, h, 32, True, 4 * h)
    assert whole > optin and lstm_kernel.wide_smem(True, False, h, 8, True, 4 * h) <= optin
    plan = launch_plan(128, 16000, torch.float32, 132, h, wide_slots=(slots, slots))
    k = -(-h // lstm_kernel.WIDE_UNITS)
    assert (plan.bwd_rows, plan.bwd_blocks, plan.bwd_ctas) == (32, 4, k)
    assert -(-plan.bwd_blocks // (slots[lstm_kernel.WIDE_ROWS.index(32)] // k)) == 1  # one launch a window
    assert plan.bwd_window == 510 and plan.scratch_bytes("lstm_bwd") <= lstm_kernel.WIDE_SCRATCH_BYTES


def test_wide_scratch_at_1024_is_within_4gb():
    """B=128, T=16000, D = H = 1024, fp32: kernel C's scratch (the widest
    of the three) is at most 4 GB, and stays so at any T: a window of a few
    hundred steps, 16 dW chunks of 33.5 MB."""
    for steps in (16000, 160000):
        plan = launch_plan(128, steps, torch.float32, 132, 1024)
        assert plan.wide and 100 <= plan.bwd_window < 1000 and plan.n_chunks == 16
        for kernel in lstm_kernel.KERNELS:
            assert plan.scratch_bytes(kernel) <= 4 * 10**9
        assert plan.scratch_bytes("lstm_bwd") >= 2 * 10**9  # the budget is used, not left idle
    assert launch_plan(128, 16000, torch.float32, 132, 1024) == launch_plan(128, 16000, torch.float32, 132, 1024,
                                                                           None, 1024)

