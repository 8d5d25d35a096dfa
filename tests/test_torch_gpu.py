"""Card-only tests of the port's CUDA kernels A, B and C (widths 64, 32 and 16, the masked widths
below 64, capacity 48 for A, B and C, the cluster path above it up to 256 and the wide path past it), of the attack ops,
of checkpoints written on the card and of the fp32 server on the card
(marker ``gpu``).

They skip where torch sees no CUDA card.  On a machine with one:
``python -m pytest tests/test_torch_gpu.py -m gpu``.  chip_smoke.py holds
the kernel against its plain version at the serving shapes."""

import numpy as np
import pytest
import torch

from awm_tpu_torch.ops import lstm_kernel
from awm_tpu_torch.ops.lstm import lstm_forward
from awm_tpu_torch.ops.lstm_kernel import lstm_fused_forward
from awm_tpu_torch.utils.precision import no_tf32

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(b, t, device, seed=0, w=64, h=None):
    """x (b, t, w) and the weights of LSTM(w, h) (h defaults to w)."""
    rng = np.random.default_rng(seed)
    h = h or w
    arrays = (
        rng.standard_normal((b, t, w)) * 0.3,
        rng.standard_normal((4 * h, w)) * 0.1,
        rng.standard_normal((4 * h, h)) * 0.1,
        rng.standard_normal(4 * h) * 0.1,
    )
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


@pytest.mark.parametrize("b,t", [(1, 17), (5, 300), (8, 64)])
def test_kernel_matches_plain_fp32(cuda, b, t):
    """fp32: only the summation order differs -> 1e-4."""
    x, w_ih, w_hh, bias = _inputs(b, t, cuda)
    before = lstm_kernel.launches["lstm_fwd_f32"]
    y = lstm_fused_forward(x, w_ih, w_hh, bias)
    torch.cuda.synchronize()
    assert lstm_kernel.launches["lstm_fwd_f32"] == before + 1
    with no_tf32():
        ref = lstm_forward(x, w_ih, w_hh, bias)
    assert y.dtype == torch.float32 and y.shape == (b, t, 64)
    assert float((y - ref).abs().max()) <= 1e-4


def test_kernel_matches_plain_bf16(cuda):
    """bf16: same rounding points as the plain version; 5e-2 as the TPU
    kernel's bf16 bound in tests/test_pallas.py."""
    x, w_ih, w_hh, bias = _inputs(3, 200, cuda, seed=1)
    x = x.to(torch.bfloat16)
    y = lstm_fused_forward(x, w_ih, w_hh, bias)
    ref = lstm_forward(x, w_ih, w_hh, bias)
    assert y.dtype == torch.bfloat16
    assert float((y.float() - ref.float()).abs().max()) <= 5e-2


def test_kernel_refuses_what_it_does_not_take(cuda):
    x, w_ih, w_hh, bias = _inputs(2, 8, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_fused_forward(x.transpose(0, 1), w_ih, w_hh, bias)
    with pytest.raises(ValueError, match="shape"):  # w_ih (4H, 16) for an x of D = 32
        lstm_fused_forward(x[..., :32].contiguous(), w_ih[:, :16], w_hh, bias)
    with pytest.raises(TypeError):
        lstm_fused_forward(x.half(), w_ih, w_hh, bias)
    with pytest.raises(ValueError, match="cpu"):
        lstm_fused_forward(x, w_ih.cpu(), w_hh, bias)


def test_session_on_card_matches_cpu(cuda):
    """The fp32 serving path on the card (kernel, TF32 off) vs on the CPU
    (plain recurrence), shapecap weights, 512-sample chunks: 1e-4."""
    from awm_tpu_torch.api import InferenceSession

    rng = np.random.default_rng(3)
    x = (0.2 * rng.standard_normal((3, 512))).astype(np.float32)
    msg = rng.integers(0, 2**16, size=3)
    kw = {"compute_dtype": torch.float32, "chunk_len": 512}
    on_card = InferenceSession.from_npz(device="cuda", **kw).embed_detect(x, msg)
    on_cpu = InferenceSession.from_npz(device="cpu", **kw).embed_detect(x, msg)
    for key in on_cpu:
        np.testing.assert_allclose(on_card[key], on_cpu[key], atol=1e-4, err_msg=key)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t", [(1, 17), (5, 300)])
def test_train_forward_kernel_matches_plain(cuda, dtype, tol, b, t):
    """Kernel B vs lstm_forward_train: y and cprev, the forward's
    tolerances (fp32 1e-4, bf16 5e-2); its y is kernel A's bit for bit."""
    from awm_tpu_torch.ops.lstm import lstm_forward_train

    x, w_ih, w_hh, bias = _inputs(b, t, cuda, seed=2)
    x = x.to(dtype)
    name = f"lstm_fwd_train_{'f32' if dtype == torch.float32 else 'bf16'}"
    before = lstm_kernel.launches[name]
    y, cprev = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias)
    torch.cuda.synchronize()
    assert lstm_kernel.launches[name] == before + 1
    with no_tf32():
        ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
    assert y.dtype == dtype and cprev.dtype == torch.float32
    assert float((y.float() - ref_y.float()).abs().max()) <= tol
    assert float((cprev - ref_c).abs().max()) <= tol
    assert torch.equal(y, lstm_kernel.forward_kernel(x, w_ih, w_hh, bias))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t", [(1, 17), (5, 300), (8, 2100)])
def test_backward_kernel_matches_plain(cuda, dtype, tol, b, t):
    """Kernel C vs lstm_backward on the same (x, y, cprev, dy), relative to
    each tensor's max: fp32 1e-4 (summation order), bf16 1e-2 (one bf16 ulp
    of a rounded da)."""
    from awm_tpu_torch.ops.lstm import lstm_backward

    x, w_ih, w_hh, bias = _inputs(b, t, cuda, seed=3)
    x = x.to(dtype)
    y, cprev = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias)
    dy = torch.randn(b, t, 64, device=cuda, generator=torch.Generator(cuda).manual_seed(4)).to(dtype)
    got = lstm_kernel.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
    again = lstm_kernel.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
    torch.cuda.synchronize()
    with no_tf32():
        ref = lstm_backward(x, y, cprev, dy, w_ih, w_hh, bias)
    assert got[0].dtype == dtype and all(g.dtype == torch.float32 for g in got[1:])
    for name, a, r, a2 in zip(("dx", "dw_ih", "dw_hh", "db"), got, ref, again):
        rel = float((a.float() - r.float()).abs().max() / (r.float().abs().max() + 1e-12))
        assert rel <= tol, (name, rel)
        assert torch.equal(a, a2), f"{name}: two runs differ (the sums are ordered)"


def test_function_on_card_matches_autograd_of_plain(cuda):
    """LSTMFunction on the card (kernels B then C) vs autograd of the plain
    fp32 recurrence, B=3 T=400: 1e-4 of each gradient's max."""
    from awm_tpu_torch.ops.lstm_kernel import LSTMFunction

    arrays = _inputs(3, 400, cuda, seed=5)
    a = [p.clone().requires_grad_() for p in arrays]
    b = [p.clone().requires_grad_() for p in arrays]
    with no_tf32():
        torch.sin(LSTMFunction.apply(*a)).sum().backward()
        torch.sin(lstm_forward(*b)).sum().backward()
    for pa, pb in zip(a, b):
        rel = float((pa.grad - pb.grad).abs().max() / pb.grad.abs().max())
        assert rel <= 1e-4, rel


# -- width 32: the strided family's two LSTM(32) over T = 50 ------------------


@pytest.mark.parametrize("dtype,tol_fwd,tol_bwd", [(torch.float32, 1e-4, 1e-4),
                                                   (torch.bfloat16, 5e-2, 1e-2)], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t", [(1, 50), (7, 37), (128, 50), (3, 800), (7, 15), (7, 16), (7, 17),
                                 (128, 64), (3, 65), (512, 50)])
def test_width32_kernels_match_plain(cuda, b, t, dtype, tol_fwd, tol_bwd):
    """The _w32 instantiations of A, B and C at every rows variant vs the
    plain versions, the width-64 tolerances and reasons: A and B max abs
    error of y and cprev, on both forward paths where T is within the short
    path's bound (the ring's 16-step chunk edges, the bound and one past
    it, A's serving batch) with the same bits on both, C relative to each gradient's max and the same
    bits in two runs.  Each call counts on its own instantiation."""
    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train

    x, w_ih, w_hh, bias = _inputs(b, t, cuda, seed=9, w=32)
    x = x.to(dtype)
    dy = torch.randn(b, t, 32, device=cuda, generator=torch.Generator(cuda).manual_seed(10)).to(dtype)
    with no_tf32():
        ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
        ref_g = lstm_backward(x, ref_y, ref_c, dy, w_ih, w_hh, bias)
    names = {k: lstm_kernel.instantiation(k, dtype, 32) for k in lstm_kernel.KERNELS}
    before = {n: lstm_kernel.launches[n] for n in names.values()}
    paths = (False, True) if t <= lstm_kernel.FWD_SHORT_MAX_STEPS else (False,)
    for rows in lstm_kernel.FWD_ROWS:
        got = []
        for short in paths:
            y0 = lstm_kernel.forward_kernel(x, w_ih, w_hh, bias, rows=rows, short=short)
            y, cprev = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias, rows=rows, short=short)
            torch.cuda.synchronize()
            assert y0.shape == (b, t, 32), short
            assert torch.equal(y0, y), short
            assert float((y0.float() - ref_y.float()).abs().max()) <= tol_fwd, short
            assert float((y.float() - ref_y.float()).abs().max()) <= tol_fwd, short
            assert float((cprev - ref_c).abs().max()) <= tol_fwd, short
            got.append((y0, cprev))
        # the short path gives the ring path's bits
        assert all(torch.equal(a, r) for a, r in zip(got[-1], got[0])), rows
    for rows in lstm_kernel.BWD_ROWS:
        got = lstm_kernel.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows)
        again = lstm_kernel.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows)
        torch.cuda.synchronize()
        assert tuple(got[1].shape) == (128, 32) and got[0].dtype == dtype
        for name, a, r, a2 in zip(("dx", "dw_ih", "dw_hh", "db"), got, ref_g, again):
            rel = float((a.float() - r.float()).abs().max() / (r.float().abs().max() + 1e-12))
            assert rel <= tol_bwd, (name, rel)
            assert torch.equal(a, a2), name
    n_fwd, n_bwd = len(lstm_kernel.FWD_ROWS) * len(paths), 2 * len(lstm_kernel.BWD_ROWS)
    assert [lstm_kernel.launches[n] - before[n] for n in names.values()] == [n_fwd, n_fwd, n_bwd]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("w,b,fused", [(32, 128, True), (32, 300, False), (16, 4, True), (16, 128, True),
                                      (24, 128, True), (12, 4, True)],
                         ids=["fused", "four", "w16-fused", "w16-fused-128", "masked32-fused", "masked16-fused"])
def test_width32_call_launches_its_kernels_alone(cuda, w, b, fused, dtype):
    """A width-32 (and width-16, and masked 24 x 24 and 12 x 12 on those
    capacities) call at T=50 from fp32 weights and a dy in
    x's type runs its kernels and nothing beside them (no cast, no fill): A
    and B one kernel each, on the short path the plan takes at T=50
    (lstm_fwd_short_kernel) and forced onto the ring (lstm_fwd_kernel), C
    one where the plan fuses it (width 32 at B=128, one wave; width 16 at
    the dry run's B=4 and at B=128, where the card's reading holds the grid)
    and four where it does not (width 32 at B=300), by torch.profiler's
    kernel list (the short path forced where the plan keeps the masked fp32
    forward on the ring).  The profiler drops a short window's kernels now and then:
    a trace that holds fewer than the call launches is taken again, three
    times at most, as chip_smoke.py's launched_alone does."""
    from torch.profiler import ProfilerActivity, profile

    x, w_ih, w_hh, bias = _inputs(b, 50, cuda, seed=11, w=w)
    x = x.to(dtype)
    y, cprev = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias)
    dy = torch.randn(b, 50, w, device=cuda).to(dtype)
    plan = lstm_kernel.device_plan(b, 50, dtype, cuda.index or 0, w)
    assert plan.bwd_fused == fused
    assert plan.fwd_short == (w in (32, 16) or dtype == torch.bfloat16)  # masked fp32: the ring
    for call, n_kernels, fragment in (
            (lambda: lstm_kernel.forward_kernel(x, w_ih, w_hh, bias, short=True), 1, "lstm_fwd_short_kernel"),
            (lambda: lstm_kernel.forward_kernel(x, w_ih, w_hh, bias, short=False), 1, "lstm_fwd_kernel"),
            (lambda: lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias, short=True), 1, "lstm_fwd_short_kernel"),
            (lambda: lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias, short=False), 1, "lstm_fwd_kernel"),
            (lambda: lstm_kernel.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias), 1 if fused else 4, "lstm_bwd")):
        call()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            if len(kernels) >= n_kernels:
                break
        assert len(kernels) == n_kernels and all(fragment in e.name for e in kernels), [e.name for e in kernels]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t", [(512, 50), (7, 64), (3, 1)])
def test_width32_short_path_same_bits_twice(cuda, b, t, dtype):
    """Kernel A on the short path, run twice on the same inputs (a ragged
    last block at B=7 and 3), gives the same bits: every sum has a fixed
    order, and the rows past the batch are zero in shared memory."""
    x, w_ih, w_hh, bias = _inputs(b, t, cuda, seed=13, w=32)
    x = x.to(dtype)
    assert lstm_kernel.launch_plan(b, t, dtype, 132, 32).fwd_short
    for rows in lstm_kernel.FWD_ROWS:
        first = lstm_kernel.forward_kernel(x, w_ih, w_hh, bias, rows=rows, short=True)
        again = lstm_kernel.forward_kernel(x, w_ih, w_hh, bias, rows=rows, short=True)
        torch.cuda.synchronize()
        assert torch.equal(first, again) and bool(torch.isfinite(first).all()), rows


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)], ids=["f32", "bf16"])
def test_width32_stack_function_matches_autograd(cuda, dtype, tol):
    """Two stacked LSTM(32) through LSTMFunction on the card (B then C for
    each; layer 1's dx is layer 0's dy, in x's dtype) vs autograd of the
    plain forward, B=3 T=50: every gradient relative to its max (fp32
    summation order; bf16: autograd of the plain forward also rounds the
    recurrent gradient at each step, which the kernels do not)."""
    from awm_tpu_torch.ops.lstm_kernel import LSTMFunction

    x, *w0 = _inputs(3, 50, cuda, seed=11, w=32)
    _, *w1 = _inputs(1, 1, cuda, seed=12, w=32)
    leaves = [x.to(dtype), *w0, *w1]
    a = [p.clone().requires_grad_() for p in leaves]
    c = [p.clone().requires_grad_() for p in leaves]
    with no_tf32():
        torch.sin(LSTMFunction.apply(LSTMFunction.apply(*a[:4]), *a[4:]).float()).sum().backward()
        torch.sin(lstm_forward(lstm_forward(*c[:4]), *c[4:]).float()).sum().backward()
    for i, (pa, pc) in enumerate(zip(a, c)):
        assert pa.grad.dtype == pa.dtype
        rel = float((pa.grad.float() - pc.grad.float()).abs().max() / pc.grad.float().abs().max())
        assert rel <= tol, (i, rel)


# -- width 16: the gradient check of entry.dryrun_multichip (B=4, T=32) ----------


@pytest.mark.parametrize("dtype,tol_fwd,tol_bwd", [(torch.float32, 1e-4, 1e-4),
                                                   (torch.bfloat16, 5e-2, 1e-2)], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t", [(1, 1), (7, 1), (4, 32), (2, 32), (7, 50), (128, 50), (3, 17), (7, 64), (7, 65)])
def test_width16_kernels_match_plain(cuda, b, t, dtype, tol_fwd, tol_bwd):
    """The _w16 instantiations of A, B and C at every rows variant vs the
    plain versions, the other widths' tolerances and reasons, on both paths
    of each where T is within their bound of 64: A and B max abs error of y
    and cprev on the short path and the ring, the short path with the ring
    path's bits; C relative to each gradient's max in one cooperative launch
    and in four, each the same bits in two runs.  Each call counts on its
    own instantiation, once."""
    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train

    x, w_ih, w_hh, bias = _inputs(b, t, cuda, seed=21, w=16)
    x = x.to(dtype)
    dy = torch.randn(b, t, 16, device=cuda, generator=torch.Generator(cuda).manual_seed(22)).to(dtype)
    with no_tf32():
        ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
        ref_g = lstm_backward(x, ref_y, ref_c, dy, w_ih, w_hh, bias)
    names = {k: lstm_kernel.instantiation(k, dtype, 16) for k in lstm_kernel.KERNELS}
    assert names["lstm_bwd"].endswith("_w16")
    before = {n: lstm_kernel.launches[n] for n in names.values()}
    plan = lstm_kernel.device_plan(b, t, dtype, cuda.index or 0, 16)
    within = t <= lstm_kernel.FWD_SHORT_MAX_STEPS
    assert plan.fwd_short == within and plan.bwd_fused == within  # these grids fit an H100 at once
    paths = (False, True) if within else (False,)
    for rows in lstm_kernel.FWD_ROWS:
        got = []
        for short in paths:
            y0 = lstm_kernel.forward_kernel(x, w_ih, w_hh, bias, rows=rows, short=short)
            y, cprev = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias, rows=rows, short=short)
            torch.cuda.synchronize()
            assert y0.shape == (b, t, 16) and y0.dtype == dtype and torch.equal(y0, y), (rows, short)
            assert float((y0.float() - ref_y.float()).abs().max()) <= tol_fwd, (rows, short)
            assert float((cprev - ref_c).abs().max()) <= tol_fwd, (rows, short)
            got.append((y0, cprev))
        assert all(torch.equal(a, r) for a, r in zip(got[-1], got[0])), rows  # short == ring, bit for bit
    for rows in lstm_kernel.BWD_ROWS:
        for fused in paths:
            got = lstm_kernel.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows, fused=fused)
            again = lstm_kernel.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows, fused=fused)
            torch.cuda.synchronize()
            assert tuple(got[1].shape) == (64, 16) and got[0].dtype == dtype
            for name, a, r, a2 in zip(("dx", "dw_ih", "dw_hh", "db"), got, ref_g, again):
                rel = float((a.float() - r.float()).abs().max() / (r.float().abs().max() + 1e-12))
                assert rel <= tol_bwd, (name, rows, fused, rel)
                assert torch.equal(a, a2), (name, rows, fused)
    n_fwd, n_bwd = len(lstm_kernel.FWD_ROWS) * len(paths), 2 * len(lstm_kernel.BWD_ROWS) * len(paths)
    assert [lstm_kernel.launches[n] - before[n] for n in names.values()] == [n_fwd, n_fwd, n_bwd]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_width16_fused_backward_is_chosen_before_the_launch(cuda, dtype):
    """The fused backward at width 16 runs where the card's occupancy
    reading holds its grid, and the plan takes the four launches one block
    past it; a cooperative launch forced on that grid raises (no retry on
    another path) and counts nothing; the four launches there match the
    plain version."""
    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train

    reading = lstm_kernel._fused_slots(cuda.index or 0, dtype, 16, 50)
    assert all(n >= torch.cuda.get_device_properties(cuda).multi_processor_count for n in reading), reading
    b = reading[0] + 1  # one row past what the card holds at one row a block
    x, w_ih, w_hh, bias = _inputs(b, 50, cuda, seed=24, w=16)
    x = x.to(dtype)
    dy = torch.randn(b, 50, 16, device=cuda, generator=torch.Generator(cuda).manual_seed(25)).to(dtype)
    assert lstm_kernel.device_plan(b - 1, 50, dtype, cuda.index or 0, 16, bwd_rows=1).bwd_fused
    assert not lstm_kernel.device_plan(b, 50, dtype, cuda.index or 0, 16, bwd_rows=1).bwd_fused
    with no_tf32():
        y, cprev = lstm_forward_train(x, w_ih, w_hh, bias)
        ref = lstm_backward(x, y, cprev, dy, w_ih, w_hh, bias)
    name = lstm_kernel.instantiation("lstm_bwd", dtype, 16)
    before = lstm_kernel.launches[name]
    with pytest.raises(RuntimeError, match="launch failed"):
        lstm_kernel.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias, rows=1, fused=True)
    assert lstm_kernel.launches[name] == before
    got = lstm_kernel.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias, rows=1)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for a, r in zip(got, ref):
        assert float((a.float() - r.float()).abs().max() / (r.float().abs().max() + 1e-12)) <= tol
    assert lstm_kernel.launches[name] == before + 1


# -- masked within capacities 32 and 16: the short forward and the fused backward --

# (D, H): the strided family at hidden_dim 24, the narrowest of capacity 32,
# D != H both ways, capacity 16 square-ish and D != H.
MASKED_SMALL = [(24, 24), (17, 17), (20, 32), (32, 20), (12, 12), (9, 3)]


def _padded(x, w_ih, w_hh, bias, cap):
    """The operands zero-padded to capacity cap: x's columns, each gate's
    rows and the weights' columns (a square call at the capacity)."""
    d, h = x.shape[2], w_hh.shape[1]
    pad_w = lambda a, cols: torch.nn.functional.pad(a.view(4, h, cols), (0, cap - cols, 0, cap - h)).reshape(
        4 * cap, cap)
    return (torch.nn.functional.pad(x, (0, cap - d)), pad_w(w_ih, d), pad_w(w_hh, h),
            torch.nn.functional.pad(bias.view(4, h), (0, cap - h)).reshape(4 * cap))


@pytest.mark.parametrize("t", [1, 17, 50, 64])
@pytest.mark.parametrize("dtype,tol_fwd,tol_bwd", [(torch.float32, 1e-4, 1e-4),
                                                   (torch.bfloat16, 5e-2, 1e-2)], ids=["f32", "bf16"])
@pytest.mark.parametrize("d,h", MASKED_SMALL, ids=[f"{d}x{h}" for d, h in MASKED_SMALL])
def test_masked_short_and_fused_paths(cuda, d, h, dtype, tol_fwd, tol_bwd, t):
    """A masked call of capacity 32 or 16 at T <= 64 on the short forward
    (rows 1, 2, 4) and the fused backward (rows 1, 2), B = 7 (a ragged last
    block): against the plain versions at KERNEL_TOL; A and B with the
    masked ring's bits; A, B and C with the bits of the square call on
    operands zero-padded to the capacity, whose padded outputs are exactly
    0 (C's dx, dW and db are that call's sums: the capacity's layout, each
    padded term +0); C twice the same bits.  At capacity 16 C's db is held
    to the masked four launches' instead: the square fused kernel's own
    recurrence rounds a few gates in the last bit unlike its four-launch
    recurrence, which the masked ones share.  Each call counts once on the
    masked counter (the four launches' too)."""
    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train

    b, cap = 7, lstm_kernel.capacity(d, h)
    x, w_ih, w_hh, bias = _inputs(b, t, cuda, seed=d * 100 + h + t, w=d, h=h)
    x = x.to(dtype)
    dy = torch.randn(b, t, h, device=cuda, generator=torch.Generator(cuda).manual_seed(t)).to(dtype)
    xp, wi, wh, bp = _padded(x, w_ih, w_hh, bias, cap)
    dyp = torch.nn.functional.pad(dy, (0, cap - h))
    with no_tf32():
        ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
        ref_g = lstm_backward(x, ref_y, ref_c, dy, w_ih, w_hh, bias)
    names = {k: lstm_kernel.instantiation(k, dtype, d, h) for k in lstm_kernel.KERNELS}
    assert all(n.endswith(f"_w{cap}_masked") for n in names.values())
    plan = lstm_kernel.device_plan(b, t, dtype, cuda.index or 0, d, h)
    assert plan.bwd_fused and plan.fwd_short == (dtype == torch.bfloat16)  # masked fp32 A and B: the ring
    before = {n: lstm_kernel.launches[n] for n in names.values()}
    for rows in lstm_kernel.FWD_ROWS:
        y0 = lstm_kernel.forward_kernel(x, w_ih, w_hh, bias, rows=rows, short=True)
        y, cprev = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias, rows=rows, short=True)
        ring_y, ring_c = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias, rows=rows, short=False)
        pad_y, pad_c = lstm_kernel.forward_train_kernel(xp, wi, wh, bp, rows=rows, short=True)
        torch.cuda.synchronize()
        assert y0.shape == (b, t, h) and y0.dtype == dtype and torch.equal(y0, y), rows
        assert float((y0.float() - ref_y.float()).abs().max()) <= tol_fwd, rows
        assert float((cprev - ref_c).abs().max()) <= tol_fwd, rows
        assert torch.equal(y, ring_y) and torch.equal(cprev, ring_c), rows
        assert torch.equal(y, pad_y[..., :h]) and torch.equal(cprev, pad_c[..., :h]), rows
        assert float(pad_y[..., h:].float().abs().max() if h < cap else 0) == 0.0
    ypad, cpad = (torch.nn.functional.pad(v, (0, cap - h)) for v in (ref_y, ref_c))
    for rows in lstm_kernel.BWD_ROWS:
        got = lstm_kernel.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows, fused=True)
        again = lstm_kernel.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows, fused=True)
        pad = lstm_kernel.backward_kernel(xp, ypad, cpad, dyp, wi, wh, bp, rows=rows, fused=True)
        torch.cuda.synchronize()
        assert tuple(got[0].shape) == (b, t, d) and tuple(got[1].shape) == (4 * h, d)
        for name, a, r, a2 in zip(("dx", "dw_ih", "dw_hh", "db"), got, ref_g, again):
            rel = float((a.float() - r.float()).abs().max() / (r.float().abs().max() + 1e-12))
            assert rel <= tol_bwd, (name, rows, rel)
            assert torch.equal(a, a2), (name, rows)
        dwi, dwh, dbp = pad[1].view(4, cap, cap), pad[2].view(4, cap, cap), pad[3].view(4, cap)
        if cap == 32:
            assert torch.equal(got[0], pad[0][..., :d]), rows
            assert torch.equal(got[1], dwi[:, :h, :d].reshape(4 * h, d)), rows
            assert torch.equal(got[2], dwh[:, :h, :h].reshape(4 * h, h)), rows
            assert torch.equal(got[3], dbp[:, :h].reshape(4 * h)), rows
        else:  # the fused recurrence's da is the masked four launches' (db: the blocks summed in order)
            four = lstm_kernel.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows, fused=False)
            assert torch.equal(got[3], four[3]), rows
        for zero in (pad[0][..., d:], dwi[:, h:], dwi[:, :, d:], dwh[:, h:], dwh[:, :, h:], dbp[:, h:]):
            assert zero.numel() == 0 or float(zero.float().abs().max()) == 0.0, rows
    n_fwd = len(lstm_kernel.FWD_ROWS)  # A once, B short and ring a rows; C twice (three times at 16)
    n_bwd = (2 if cap == 32 else 3) * len(lstm_kernel.BWD_ROWS)
    assert [lstm_kernel.launches[n] - before[n] for n in names.values()] == [n_fwd, 2 * n_fwd, n_bwd]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d,h", [(24, 24), (12, 12)], ids=["24x24", "12x12"])
def test_masked_fused_backward_is_chosen_before_the_launch(cuda, d, h, dtype):
    """The batch just past the fused grid the plan counts on (capacity 32:
    one block an SM; 16: the masked instantiation's occupancy reading)
    takes the four launches, the batch before it the fused launch; a
    cooperative launch forced one block past what the card holds of the
    masked instantiation raises and counts nothing; the four launches there
    match the plain version."""
    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train

    idx, cap = cuda.index or 0, lstm_kernel.capacity(d, h)
    plan = lambda b: lstm_kernel.device_plan(b, 50, dtype, idx, d, h)
    edge = next(b for b in range(2, 1 << 14) if not plan(b).bwd_fused)
    assert plan(edge - 1).bwd_fused and not plan(edge).bwd_fused
    reading = lstm_kernel._fused_slots(idx, dtype, cap, 50, True)
    b = reading[0] + 1  # one row past what the card holds at one row a block
    x, w_ih, w_hh, bias = _inputs(b, 50, cuda, seed=31, w=d, h=h)
    x = x.to(dtype)
    dy = torch.randn(b, 50, h, device=cuda, generator=torch.Generator(cuda).manual_seed(32)).to(dtype)
    with no_tf32():
        y, cprev = lstm_forward_train(x, w_ih, w_hh, bias)
        ref = lstm_backward(x, y, cprev, dy, w_ih, w_hh, bias)
    name = lstm_kernel.instantiation("lstm_bwd", dtype, d, h)
    before = lstm_kernel.launches[name]
    with pytest.raises(RuntimeError, match="launch failed"):
        lstm_kernel.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias, rows=1, fused=True)
    assert lstm_kernel.launches[name] == before
    got = lstm_kernel.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias, rows=1, fused=False)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for a, r in zip(got, ref):
        assert float((a.float() - r.float()).abs().max() / (r.float().abs().max() + 1e-12)) <= tol
    assert lstm_kernel.launches[name] == before + 1


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)], ids=["f32", "bf16"])
def test_width16_function_matches_autograd(cuda, dtype, tol):
    """LSTMFunction at width 16 on the card (B then C), the dry run's loss
    sum(sin(lstm(x))) at B=4, T=32, vs autograd of the plain forward: every
    gradient relative to its max, as at width 32; fp32 dx also within the
    dry run's 1e-4 absolute."""
    from awm_tpu_torch.ops.lstm_kernel import LSTMFunction

    leaves = [a.to(dtype) if i == 0 else a for i, a in enumerate(_inputs(4, 32, cuda, seed=23, w=16))]
    a = [p.clone().requires_grad_() for p in leaves]
    c = [p.clone().requires_grad_() for p in leaves]
    with no_tf32():
        torch.sin(LSTMFunction.apply(*a).float()).sum().backward()
        torch.sin(lstm_forward(*c).float()).sum().backward()
    for i, (pa, pc) in enumerate(zip(a, c)):
        assert pa.grad.dtype == pa.dtype
        rel = float((pa.grad.float() - pc.grad.float()).abs().max() / pc.grad.float().abs().max())
        assert rel <= tol, (i, rel)
    if dtype == torch.float32:
        assert float((a[0].grad - c[0].grad).abs().max()) < 1e-4


@pytest.mark.parametrize("dtype,tol_fwd,tol_bwd", [(torch.float32, 1e-4, 1e-4),
                                                   (torch.bfloat16, 5e-2, 1e-2)], ids=["f32", "bf16"])
def test_kernel_refuses_unbuilt_width(cuda, dtype, tol_fwd, tol_bwd):
    """No width >= 1 is refused any more: past the cluster path's widest
    (CLUSTER_MAX_WIDTH + 1 = 257, and D = 40, H = 600) A, B and C run the
    wide path's instantiations (counted on *_wide) and hold against their
    plain versions at KERNEL_TOL, two calls of each giving the same bits;
    a width of 0 is refused with a ValueError before any launch."""
    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train

    b, t = 5, 37
    for d, h in ((lstm_kernel.CLUSTER_MAX_WIDTH + 1,) * 2, (40, 600)):
        x, w_ih, w_hh, bias = _inputs(b, t, cuda, seed=d + h, w=d, h=h)
        x = x.to(dtype)
        dy = torch.randn(b, t, h, device=cuda, generator=torch.Generator(cuda).manual_seed(h)).to(dtype)
        names = [lstm_kernel.instantiation(k, dtype, d, h) for k in lstm_kernel.KERNELS]
        assert all(n.endswith("_wide") for n in names)
        before = [lstm_kernel.launches[n] for n in names]
        with no_tf32():
            ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
            ref_g = lstm_backward(x, ref_y, ref_c, dy, w_ih, w_hh, bias)
            y0 = lstm_fused_forward(x, w_ih, w_hh, bias)
            again = lstm_kernel.forward_kernel(x, w_ih, w_hh, bias)
            y, cprev = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias)
            got = lstm_kernel.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias)
            got2 = lstm_kernel.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias)
        torch.cuda.synchronize()
        assert [lstm_kernel.launches[n] - n0 for n, n0 in zip(names, before)] == [2, 1, 2]
        assert y0.shape == (b, t, h) and torch.equal(y0, again) and torch.equal(y0, y)
        assert float((y0.float() - ref_y.float()).abs().max()) <= tol_fwd
        assert float((cprev - ref_c).abs().max()) <= tol_fwd
        for name, a, r, a2 in zip(("dx", "dw_ih", "dw_hh", "db"), got, ref_g, got2):
            rel = float((a.float() - r.float()).abs().max() / (r.float().abs().max() + 1e-12))
            assert rel <= tol_bwd, (d, h, name, rel)
            assert torch.equal(a, a2), (d, h, name)
    x, w_ih, w_hh, bias = _inputs(2, 8, cuda, w=8)
    before = dict(lstm_kernel.launches)
    with pytest.raises(ValueError, match="widths D, H >= 1"):
        lstm_fused_forward(x[..., :0].contiguous(), w_ih[:, :0].contiguous(), w_hh, bias)
    assert lstm_kernel.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wide_path_tiles_past_what_the_card_holds(cuda, dtype):
    """The wide path's unit tiles: at 512 x 512 fewer CTAs a row group
    (each of more tiles of 16 units) give the bits of the plan's untiled
    call in A, B and C; at H = 4352 (272 tiles a group, more CTAs than the
    card holds at once) the plan takes fewer CTAs and A, B and C hold
    against their plain versions at KERNEL_TOL."""
    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train

    sfx = "bf16" if dtype == torch.bfloat16 else "f32"

    def calls(x, w_ih, w_hh, bias, dy, ctas=None):
        y, cprev = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias, ctas=ctas)
        return (lstm_kernel.forward_kernel(x, w_ih, w_hh, bias, ctas=ctas), y, cprev,
                *lstm_kernel.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias, ctas=ctas))

    for h, b, t in ((512, 5, 61), (4352, 2, 9)):
        x, w_ih, w_hh, bias = _inputs(b, t, cuda, seed=h, w=h)
        w_ih, w_hh, bias = (v * (0.3 / h**0.5) / 0.1 for v in (w_ih, w_hh, bias))  # a contractive recurrence
        x = x.to(dtype)
        dy = torch.randn(b, t, h, device=cuda, generator=torch.Generator(cuda).manual_seed(h)).to(dtype)
        plan = lstm_kernel._plan_for(x, h)
        k = -(-h // lstm_kernel.WIDE_UNITS)
        with no_tf32():
            got = calls(x, w_ih, w_hh, bias, dy)
            if h == 512:
                assert plan.fwd_ctas == plan.bwd_ctas == k
                for ctas in (3, 31):
                    assert all(torch.equal(a, r) for a, r in zip(calls(x, w_ih, w_hh, bias, dy, ctas), got)), ctas
                continue
            assert plan.fwd_ctas < k and plan.bwd_ctas < k
            ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
            ref_g = lstm_backward(x, got[1], got[2], dy, w_ih, w_hh, bias)
        for a, r in ((got[0], ref_y), (got[1], ref_y), (got[2], ref_c)):
            assert float((a.float() - r.float()).abs().max()) <= lstm_kernel.KERNEL_TOL["lstm_fwd", sfx]
        for a, r in zip(got[3:], ref_g):
            rel = float((a.float() - r.float()).abs().max() / (r.float().abs().max() + 1e-12))
            assert rel <= lstm_kernel.KERNEL_TOL["lstm_bwd", sfx], rel


def _max_rel(a, r, rows=4096):
    """max |a - r| / max |r| over a tensor's first axis in slices of rows (a
    dW_hh at H = 28672 is 13 GB; its differences would not fit beside it)."""
    err = max(float((a[i:i + rows].float() - r[i:i + rows].float()).abs().max()) for i in range(0, a.shape[0], rows))
    return err / (max(float(r[i:i + rows].float().abs().max()) for i in range(0, r.shape[0], rows)) + 1e-12)


# Past the widths whose whole staged row of h / da filled a CTA's shared
# memory before the chunks (an H100's 227 KB: fp32 C 14264, bf16 A / B
# 14512, bf16 C 28532): (dtype, H)
CEILINGS = [(torch.float32, 14592), (torch.bfloat16, 14592), (torch.bfloat16, 28672)]


@pytest.mark.parametrize("dtype,h", CEILINGS, ids=[f"{'bf16' if d == torch.bfloat16 else 'f32'}-{h}"
                                                   for d, h in CEILINGS])
def test_wide_path_past_the_old_ceiling(cuda, dtype, h):
    """A, B and C at D = 16, B = 2, T = 24 and an H past the width whose
    whole staged row used to fill shared memory: the plan gives a launch
    shape (no RuntimeError), the *_wide instantiations launch, and they hold
    against their plain versions at KERNEL_TOL; two calls of C give the same
    bits."""
    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train

    sfx = "bf16" if dtype == torch.bfloat16 else "f32"
    b, t, d = 2, 24, 16
    x, w_ih, w_hh, bias = _inputs(b, t, cuda, seed=h, w=d, h=h)
    w_ih, w_hh, bias = (v * (0.3 / h**0.5) / 0.1 for v in (w_ih, w_hh, bias))  # a contractive recurrence
    x = x.to(dtype)
    dy = torch.randn(b, t, h, device=cuda, generator=torch.Generator(cuda).manual_seed(h)).to(dtype)
    names = [lstm_kernel.instantiation(k, dtype, d, h) for k in lstm_kernel.KERNELS]
    before = [lstm_kernel.launches[n] for n in names]
    with no_tf32():
        y0 = lstm_kernel.forward_kernel(x, w_ih, w_hh, bias)
        y, cprev = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias)
        got = lstm_kernel.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
        again = lstm_kernel.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
        torch.cuda.synchronize()
        assert all(torch.equal(a, a2) for a, a2 in zip(got, again))
        del again
        ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
        for a, r in ((y0, ref_y), (y, ref_y), (cprev, ref_c)):
            assert float((a.float() - r.float()).abs().max()) <= lstm_kernel.KERNEL_TOL["lstm_fwd", sfx]
        del ref_y, ref_c
        torch.cuda.empty_cache()
        ref_g = lstm_backward(x, y, cprev, dy, w_ih, w_hh, bias)
    assert [lstm_kernel.launches[n] - n0 for n, n0 in zip(names, before)] == [1, 1, 2]
    for name, a, r in zip(("dx", "dw_ih", "dw_hh", "db"), got, ref_g):
        assert _max_rel(a, r) <= lstm_kernel.KERNEL_TOL["lstm_bwd", sfx], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wide_path_chunks_keep_the_bits(cuda, dtype):
    """At 512 x 512 (B = 7, T = 61, rows a group where the whole row fits
    too) h and da staged in chunks of any size give the bits of the plan's
    staging: A and B in chunks of 16 and 64 terms against their whole row,
    C's whole row (2048) and chunks of 64 against its chunks of 128 / 256;
    two calls of C the same bits.  At B = 40, C in chunks of 16 and 64 terms
    also at 8 rows a group (the fp32 dh product's 4 x 4 tiles a thread) and
    32 (its 8 x 8 tiles a warp, then a group of 8)."""
    b, t, h = 7, 61, 512
    x, w_ih, w_hh, bias = _inputs(b, t, cuda, seed=7, w=h)
    w_ih, w_hh, bias = (v * (0.3 / h**0.5) / 0.1 for v in (w_ih, w_hh, bias))
    x = x.to(dtype)
    dy = torch.randn(b, t, h, device=cuda, generator=torch.Generator(cuda).manual_seed(3)).to(dtype)

    def calls(chunk=None):
        y, cprev = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias, chunk=chunk)
        return (lstm_kernel.forward_kernel(x, w_ih, w_hh, bias, chunk=chunk), y, cprev,
                *lstm_kernel.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias, chunk=chunk))

    with no_tf32():
        base = calls()
        assert all(torch.equal(a, r) for a, r in zip(calls(), base))
        for chunk in (16, 64, 4 * h):
            assert all(torch.equal(a, r) for a, r in zip(calls(chunk), base)), chunk
        x40 = _inputs(40, 33, cuda, seed=8, w=h)[0].to(dtype)
        y40, c40 = lstm_kernel.forward_train_kernel(x40, w_ih, w_hh, bias)
        dy40 = torch.randn(40, 33, h, device=cuda, generator=torch.Generator(cuda).manual_seed(4)).to(dtype)
        for rows in (8, 32):
            ref = lstm_kernel.backward_kernel(x40, y40, c40, dy40, w_ih, w_hh, bias, rows=rows)
            for chunk in (16, 64):  # a whole row of da (2048 terms) at 32 rows fits no CTA in fp32
                got = lstm_kernel.backward_kernel(x40, y40, c40, dy40, w_ih, w_hh, bias, rows=rows, chunk=chunk)
                assert all(torch.equal(a, r) for a, r in zip(got, ref)), (rows, chunk)


# (D, H) of the new widths: capacity 48 (48 x 48, the base family at
# channels 48; 40 x 24 masked), masked within 32 and 16, the cluster path (96 x 96,
# 128 x 128, the base family at channels 128; the ceiling; a wide input with
# a narrow hidden width and the reverse).
NEW_WIDTHS = [(48, 48), (40, 24), (17, 17), (9, 3), (96, 96), (128, 128), (256, 256), (200, 8), (8, 200)]


@pytest.mark.parametrize("dtype,tol_fwd,tol_bwd", [(torch.float32, 1e-4, 1e-4),
                                                   (torch.bfloat16, 5e-2, 1e-2)], ids=["f32", "bf16"])
@pytest.mark.parametrize("d,h", NEW_WIDTHS, ids=[f"{d}x{h}" for d, h in NEW_WIDTHS])
def test_new_widths_match_plain(cuda, d, h, dtype, tol_fwd, tol_bwd):
    """A, B and C at the masked and cluster widths vs the plain versions at
    KERNEL_TOL (the other widths' tolerances and reasons), at every rows
    variant the path takes, T = 37 (past a ring chunk) and B = 5 (a ragged
    last block at two rows): shapes (B, T, H) and (4H, D), the launches
    counted on the path's own counter, two backward calls bit-equal."""
    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train

    b, t = 5, 37
    x, w_ih, w_hh, bias = _inputs(b, t, cuda, seed=d * 300 + h, w=d, h=h)
    x = x.to(dtype)
    dy = torch.randn(b, t, h, device=cuda, generator=torch.Generator(cuda).manual_seed(h)).to(dtype)
    with no_tf32():
        ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
        ref_g = lstm_backward(x, ref_y, ref_c, dy, w_ih, w_hh, bias)
    names = {k: lstm_kernel.instantiation(k, dtype, d, h) for k in lstm_kernel.KERNELS}
    for k, n in names.items():  # 48 x 48: capacity 48's square, A, B and C
        assert n.endswith("_cluster" if max(d, h) > 64 else "_w48" if d == h == 48 else "_masked"), n
    before = {n: lstm_kernel.launches[n] for n in names.values()}
    fwd_rows = lstm_kernel.CLUSTER_ROWS if max(d, h) > 64 else lstm_kernel.FWD_ROWS
    bwd_rows = lstm_kernel.CLUSTER_ROWS if max(d, h) > 64 else lstm_kernel.BWD_ROWS
    for rows in fwd_rows:
        y0 = lstm_kernel.forward_kernel(x, w_ih, w_hh, bias, rows=rows)
        y, cprev = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias, rows=rows)
        torch.cuda.synchronize()
        assert y0.shape == (b, t, h) and y0.dtype == dtype and torch.equal(y0, y), rows
        assert float((y0.float() - ref_y.float()).abs().max()) <= tol_fwd, rows
        assert float((cprev - ref_c).abs().max()) <= tol_fwd, rows
    for rows in bwd_rows:
        got = lstm_kernel.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows)
        again = lstm_kernel.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows)
        torch.cuda.synchronize()
        assert tuple(got[0].shape) == (b, t, d) and got[0].dtype == dtype
        assert tuple(got[1].shape) == (4 * h, d) and tuple(got[2].shape) == (4 * h, h)
        for name, a, r, a2 in zip(("dx", "dw_ih", "dw_hh", "db"), got, ref_g, again):
            rel = float((a.float() - r.float()).abs().max() / (r.float().abs().max() + 1e-12))
            assert rel <= tol_bwd, (name, rows, rel)
            assert torch.equal(a, a2), name
    n_fwd, n_bwd = len(fwd_rows), 2 * len(bwd_rows)  # a call counts once
    assert [lstm_kernel.launches[n] - before[n] for n in names.values()] == [n_fwd, n_fwd, n_bwd]


@pytest.mark.parametrize("d,h", [(48, 48), (40, 24)], ids=["48x48", "40x24"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_masked_width_equals_padded_capacity(cuda, dtype, d, h):
    """Kernels A, B and C at 48 x 48 (capacity 48's square instantiation)
    and 40 x 24 (capacity 48 at runtime widths) give the same bits as the
    square width-64 instantiation on the operands zero-padded to 64 (the
    first H columns): capacity 48 sums in capacity 64's order less terms
    that are exactly zero (a quad of the gate products, C's four idle lanes
    of the dh product), and C's dW and db sum over the rows as the square
    call does, fp32 dx over the gate columns in order.  bf16 dx is held
    where 16 divides H: its mma k-tiles of 16 gate columns straddle two
    gates at H = 24, so its fp32 sums group other terms than the padded
    call's (test_capacity_48_matches_plain holds it against plain).  The
    padded units and gradient entries stay exactly 0."""
    x, w_ih, w_hh, bias = _inputs(4, 300, cuda, seed=d + h, w=d, h=h)
    x = x.to(dtype)
    xp = torch.nn.functional.pad(x, (0, 64 - d))
    # each gate's h rows (and the columns) padded to 64
    pad_w = lambda a, cols: torch.nn.functional.pad(a.view(4, h, cols), (0, 64 - cols, 0, 64 - h)).reshape(256, 64)
    wi, wh = pad_w(w_ih, d), pad_w(w_hh, h)
    bp = torch.nn.functional.pad(bias.view(4, h), (0, 64 - h)).reshape(256)
    assert tuple(wi.shape) == (256, 64) and tuple(bp.shape) == (256,)
    names = [lstm_kernel.instantiation(k, dtype, d, h) for k in lstm_kernel.KERNELS]
    assert all("_w48" in n for n in names)
    before = [lstm_kernel.launches[n] for n in names]
    y48 = lstm_kernel.forward_kernel(x, w_ih, w_hh, bias)
    y64 = lstm_kernel.forward_kernel(xp, wi, wh, bp)
    yt48, c48 = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias)
    yt64, c64 = lstm_kernel.forward_train_kernel(xp, wi, wh, bp)
    dy = torch.randn(4, 300, h, device=cuda, generator=torch.Generator(cuda).manual_seed(d * h)).to(dtype)
    g48 = lstm_kernel.backward_kernel(x, yt48, c48, dy, w_ih, w_hh, bias)
    g64 = lstm_kernel.backward_kernel(xp, yt64, c64, torch.nn.functional.pad(dy, (0, 64 - h)), wi, wh, bp)
    torch.cuda.synchronize()
    assert [lstm_kernel.launches[n] - b for n, b in zip(names, before)] == [1, 1, 1]
    assert torch.equal(y48, y64[..., :h]) and torch.equal(yt48, yt64[..., :h])
    assert torch.equal(c48, c64[..., :h])
    assert float(y64[..., h:].float().abs().max()) == 0.0 and float(c64[..., h:].abs().max()) == 0.0
    dx64, dwi64, dwh64, db64 = g64[0], g64[1].view(4, 64, 64), g64[2].view(4, 64, 64), g64[3].view(4, 64)
    assert torch.equal(g48[1], dwi64[:, :h, :d].reshape(4 * h, d))
    assert torch.equal(g48[2], dwh64[:, :h, :h].reshape(4 * h, h))
    assert torch.equal(g48[3], db64[:, :h].reshape(4 * h))
    if dtype == torch.float32 or h % 16 == 0:
        assert torch.equal(g48[0], dx64[..., :d])
    assert float(dx64[..., d:].float().abs().max()) == 0.0
    for pad in (dwi64[:, h:], dwi64[:, :, d:], dwh64[:, h:], dwh64[:, :, h:], db64[:, h:]):
        assert float(pad.abs().max()) == 0.0


# (D, H) about capacity 48 (kernels A, B and C): its widest and narrowest
# squares, D != H both ways, a width of one beside 48; then 49..63, which
# stay on capacity 64.
CAP48_WIDTHS = [(33, 33), (47, 47), (48, 48), (40, 24), (24, 40), (1, 48), (48, 1), (49, 49), (63, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d,h", CAP48_WIDTHS, ids=[f"{d}x{h}" for d, h in CAP48_WIDTHS])
def test_capacity_48_matches_plain(cuda, d, h, dtype):
    """Kernels A, B and C at max(D, H) in 33..48 run capacity 48 (its square
    at 48 x 48, else masked), at 49..63 capacity 64 masked: each call counts
    on that counter and holds against the plain versions at KERNEL_TOL at
    every rows variant, B = 5 (a ragged last block), T = 37 (past a ring
    chunk); A and B the same y, C twice the same bits."""
    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train

    sfx = "bf16" if dtype == torch.bfloat16 else "f32"
    b, t = 5, 37
    x, w_ih, w_hh, bias = _inputs(b, t, cuda, seed=d * 100 + h, w=d, h=h)
    x = x.to(dtype)
    dy = torch.randn(b, t, h, device=cuda, generator=torch.Generator(cuda).manual_seed(d + h)).to(dtype)
    with no_tf32():
        ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
        ref_g = lstm_backward(x, ref_y, ref_c, dy, w_ih, w_hh, bias)
    cap = "_w48" if max(d, h) <= 48 else ""
    names = {k: lstm_kernel.instantiation(k, dtype, d, h) for k in lstm_kernel.KERNELS}
    assert names == {k: f"{k}_{sfx}{cap}" + ("" if d == h == 48 else "_masked") for k in lstm_kernel.KERNELS}
    before = {n: lstm_kernel.launches[n] for n in names.values()}
    tol = {k: lstm_kernel.KERNEL_TOL[k, sfx] for k in lstm_kernel.KERNELS}
    for rows in lstm_kernel.FWD_ROWS:
        y0 = lstm_kernel.forward_kernel(x, w_ih, w_hh, bias, rows=rows)
        y, cprev = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias, rows=rows)
        torch.cuda.synchronize()
        assert y0.shape == (b, t, h) and y0.dtype == dtype and torch.equal(y0, y), rows
        assert float((y0.float() - ref_y.float()).abs().max()) <= tol["lstm_fwd"], rows
        assert float((cprev - ref_c).abs().max()) <= tol["lstm_fwd_train"], rows
    for rows in lstm_kernel.BWD_ROWS:
        got = lstm_kernel.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows)
        again = lstm_kernel.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows)
        torch.cuda.synchronize()
        for name, a, r, a2 in zip(("dx", "dw_ih", "dw_hh", "db"), got, ref_g, again):
            rel = float((a.float() - r.float()).abs().max() / (r.float().abs().max() + 1e-12))
            assert rel <= tol["lstm_bwd"], (name, rows, rel)
            assert torch.equal(a, a2), (name, rows)
    n = len(lstm_kernel.FWD_ROWS)
    assert [lstm_kernel.launches[v] - before[v] for v in names.values()] == [n, n, 2 * len(lstm_kernel.BWD_ROWS)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cluster_path_same_bits_twice(cuda, dtype):
    """Two calls of each kernel on the cluster path (128 x 128, four CTAs a
    cluster) give the same bits: the h and da exchanges and every sum run in
    a fixed order."""
    x, w_ih, w_hh, bias = _inputs(3, 200, cuda, seed=128, w=128)
    x = x.to(dtype)
    dy = torch.randn(3, 200, 128, device=cuda, generator=torch.Generator(cuda).manual_seed(1)).to(dtype)
    y, c = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias)
    y2, c2 = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias)
    g = lstm_kernel.backward_kernel(x, y, c, dy, w_ih, w_hh, bias)
    g2 = lstm_kernel.backward_kernel(x, y, c, dy, w_ih, w_hh, bias)
    assert torch.equal(lstm_kernel.forward_kernel(x, w_ih, w_hh, bias), lstm_kernel.forward_kernel(x, w_ih, w_hh, bias))
    assert torch.equal(y, y2) and torch.equal(c, c2)
    assert all(torch.equal(a, b) for a, b in zip(g, g2))


@pytest.mark.parametrize("dtype,tol_fwd,tol_bwd", [(torch.float32, 1e-4, 1e-4),
                                                   (torch.bfloat16, 5e-2, 1e-2)], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", lstm_kernel.CLUSTER_ROWS)
@pytest.mark.parametrize("w", [96, 128, 256])
def test_cluster_rows_variants_match_plain(cuda, w, rows, dtype, tol_fwd, tol_bwd):
    """Every rows-a-cluster variant the cluster path builds, at K = 3, 4, 8
    and batches that leave a cluster one row, a ragged last cluster and
    several clusters (B = 1, 7, 32), T = 1 and 17: A and B against
    lstm_forward_train and C against lstm_backward at KERNEL_TOL; A twice
    and C twice the same bits, A and B the same y."""
    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train

    for b in (1, 7, 32):
        for t in (1, 17):
            x, w_ih, w_hh, bias = _inputs(b, t, cuda, seed=w + b + t, w=w)
            x = x.to(dtype)
            dy = torch.randn(b, t, w, device=cuda, generator=torch.Generator(cuda).manual_seed(b)).to(dtype)
            with no_tf32():
                ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
                ref_g = lstm_backward(x, ref_y, ref_c, dy, w_ih, w_hh, bias)
            y0 = lstm_kernel.forward_kernel(x, w_ih, w_hh, bias, rows=rows)
            y, cprev = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias, rows=rows)
            got = lstm_kernel.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows)
            again = lstm_kernel.backward_kernel(x, ref_y, ref_c, dy, w_ih, w_hh, bias, rows=rows)
            torch.cuda.synchronize()
            assert torch.equal(y0, y) and torch.equal(y0, lstm_kernel.forward_kernel(x, w_ih, w_hh, bias, rows=rows))
            assert float((y0.float() - ref_y.float()).abs().max()) <= tol_fwd, (b, t)
            assert float((cprev - ref_c).abs().max()) <= tol_fwd, (b, t)
            for name, a, r, a2 in zip(("dx", "dw_ih", "dw_hh", "db"), got, ref_g, again):
                rel = float((a.float() - r.float()).abs().max() / (r.float().abs().max() + 1e-12))
                assert rel <= tol_bwd, (name, b, t, rel)
                assert torch.equal(a, a2), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cluster_backward_at_scale(cuda, dtype):
    """Kernel C on the cluster path at D = H = 256, B = 512 (A's serving
    batch), T = 16000: the call's operands fit the card (bf16 ~25 GB), and
    its windows keep the scratch within CLUSTER_SCRATCH_BYTES (for all T
    the gate pass's records alone were 67 GB bf16, and the call raised
    torch.OutOfMemoryError).  Held against lstm_backward in slices of 64
    rows (dx by rows; dW and db the slices' sums) at KERNEL_TOL."""
    from awm_tpu_torch.ops.lstm import lstm_backward

    b, t, w = 512, 16000, 256
    sfx = "bf16" if dtype == torch.bfloat16 else "f32"
    gen = torch.Generator(cuda).manual_seed(5)
    x = (0.3 * torch.randn(b, t, w, device=cuda, generator=gen)).to(dtype)
    w_ih, w_hh, bias = (0.1 * torch.randn(*s, device=cuda, generator=gen) for s in ((4 * w, w), (4 * w, w), (4 * w,)))
    y, cprev = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias)
    dy = torch.randn(b, t, w, device=cuda, generator=gen).to(dtype)
    name = lstm_kernel.instantiation("lstm_bwd", dtype, w)
    before = lstm_kernel.launches[name]
    with no_tf32():
        got = lstm_kernel.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
        torch.cuda.synchronize()
        assert lstm_kernel.launches[name] == before + 1 and name.endswith("_cluster")
        dx_err, sums = 0.0, None
        for r0 in range(0, b, 64):
            rows = slice(r0, r0 + 64)
            ref = lstm_backward(x[rows], y[rows], cprev[rows], dy[rows], w_ih, w_hh, bias)
            dx_err = max(dx_err, float((got[0][rows].float() - ref[0].float()).abs().max()) /
                         (float(ref[0].float().abs().max()) + 1e-12))
            sums = list(ref[1:]) if sums is None else [a + r for a, r in zip(sums, ref[1:])]
            del ref
    assert dx_err <= lstm_kernel.KERNEL_TOL["lstm_bwd", sfx], dx_err
    for what, a, r in zip(("dw_ih", "dw_hh", "db"), got[1:], sums):
        rel = float((a - r).abs().max() / (r.abs().max() + 1e-12))
        assert rel <= lstm_kernel.KERNEL_TOL["lstm_bwd", sfx], (what, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("w", [96, 256])
def test_cluster_backward_windows(cuda, w, dtype, monkeypatch):
    """C on the cluster path with the budget cut so that a call of B = 7,
    T = 65 runs in windows (of 3 and of 16 steps) against the same call in
    one window: dx and db the same bits ((dh, dc) and each row's db carried
    exactly), dW_ih and dW_hh within KERNEL_TOL (the partials summed by
    window, in another order), all against lstm_backward at KERNEL_TOL."""
    from awm_tpu_torch.ops.lstm import lstm_backward

    b, t = 7, 65
    sfx = "bf16" if dtype == torch.bfloat16 else "f32"
    x, w_ih, w_hh, bias = _inputs(b, t, cuda, seed=w + 1, w=w)
    x = x.to(dtype)
    dy = torch.randn(b, t, w, device=cuda, generator=torch.Generator(cuda).manual_seed(2)).to(dtype)
    y, cprev = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias)
    one = lstm_kernel.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
    with no_tf32():
        ref = lstm_backward(x, y, cprev, dy, w_ih, w_hh, bias)
    plan = lstm_kernel._plan_for(x, w)
    assert plan.bwd_window == t
    elt = 2 if dtype == torch.bfloat16 else 4
    per_step = b * (w * lstm_kernel.CLUSTER_REC * 4 + 4 * w * elt)
    # the plan's fixed scratch beside a quarter of the budget kept for the dW partials
    fixed = 4 * (plan.bwd_blocks * 4 * w + 2 * b * w + b * 4 * w) + elt * plan.bwd_pack + 2 * plan.wih
    for tc in (3, 16):
        budget = lstm_kernel.CLUSTER_SCRATCH_BYTES
        cut = 4 * -(-(fixed + tc * per_step) // 3)  # three quarters of it hold the fixed scratch and tc steps
        monkeypatch.setattr(lstm_kernel, "CLUSTER_SCRATCH_BYTES", cut)
        lstm_kernel.launch_plan.cache_clear()
        try:
            assert lstm_kernel._plan_for(x, w).bwd_window == tc
            got = lstm_kernel.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
            torch.cuda.synchronize()
        finally:
            monkeypatch.setattr(lstm_kernel, "CLUSTER_SCRATCH_BYTES", budget)
            lstm_kernel.launch_plan.cache_clear()
        assert torch.equal(got[0], one[0]) and torch.equal(got[3], one[3]), tc
        for what, a, r in zip(("dx", "dw_ih", "dw_hh", "db"), got, ref):
            rel = float((a.float() - r.float()).abs().max() / (r.float().abs().max() + 1e-12))
            assert rel <= lstm_kernel.KERNEL_TOL["lstm_bwd", sfx], (what, tc, rel)


# The wide path's fp32 A and B (every warp works at any rows): the rows a
# row group the plan can take and two in between, at T around a chunk.
WIDE_ROWS_CASES = [(1, 1), (2, 2), (4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (7, 5), (40, 32), (33, 17)]


@pytest.mark.parametrize("b,rows", WIDE_ROWS_CASES, ids=[f"B{b}-r{r}" for b, r in WIDE_ROWS_CASES])
def test_wide_fp32_forward_every_rows(cuda, b, rows):
    """fp32 kernels A and B on the wide path at H = 512 with every rows a
    row group (the tile a warp takes follows them): A and B against
    lstm_forward_train at 1e-4, B's y A's bit for bit; C (its gate pass sums
    h in A's order) against lstm_backward at 1e-4."""
    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train

    h, t = 512, 37
    x, w_ih, w_hh, bias = _inputs(b, t, cuda, seed=b + rows, w=h)
    w_ih, w_hh, bias = (v * (0.3 / h**0.5) / 0.1 for v in (w_ih, w_hh, bias))
    dy = torch.randn(b, t, h, device=cuda, generator=torch.Generator(cuda).manual_seed(rows))
    with no_tf32():
        y0 = lstm_kernel.forward_kernel(x, w_ih, w_hh, bias, rows=rows)
        y, cprev = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias, rows=rows)
        got = lstm_kernel.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias)
        torch.cuda.synchronize()
        ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
        ref_g = lstm_backward(x, y, cprev, dy, w_ih, w_hh, bias)
    assert torch.equal(y0, y)
    assert float((y - ref_y).abs().max()) <= 1e-4 and float((cprev - ref_c).abs().max()) <= 1e-4
    for what, a, r in zip(("dx", "dw_ih", "dw_hh", "db"), got, ref_g):
        assert float((a - r).abs().max() / (r.abs().max() + 1e-12)) <= 1e-4, what


def test_wide_fp32_gate_pass_reproduces_the_forward_gates(cuda):
    """C's wide fp32 gate pass sums h in the forward's order: a build with
    -DAWM_WIDE_GATES=1 runs B over one window keeping every step's gates,
    then the gate pass on B's own y, and the two sets of gates are equal
    bit for bit (ops/bench_lstm.py --gates: rows 1 .. 64, whole and chunked
    h, H = 512, 300, 257, 40 x 600, tiled)."""
    import json
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "awm_tpu_torch/ops/bench_lstm.py", "--gates"], capture_output=True,
                         text=True, timeout=900)
    lines = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert out.returncode == 0 and lines and all(line["equal"] for line in lines), out.stdout + out.stderr


SHORT_AND_RAGGED = [(1, 1), (1, 2), (7, 3), (7, 37)]  # T below and beyond the rings, a ragged last block
# the forward's: also the ring's chunk edges, the short path's bound (width
# 32) and one past it, and A's serving batch
FWD_SHAPES = SHORT_AND_RAGGED + [(7, 15), (7, 16), (7, 17), (3, 64), (3, 65), (512, 50)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", lstm_kernel.FWD_ROWS)
@pytest.mark.parametrize("b,t", FWD_SHAPES)
def test_forward_kernels_every_rows_variant(cuda, b, t, rows, dtype, tol):
    """Kernels A and B at each rows-per-block instantiation the launch plan
    can pick, vs lstm_forward_train: the forward's tolerances, at width 64
    and at width 32 on both of its paths where T is within the short path's
    bound (the plan's path, and the other one forced)."""
    from awm_tpu_torch.ops.lstm import lstm_forward_train

    for w in (64, 32):
        x, w_ih, w_hh, bias = _inputs(b, t, cuda, seed=6, w=w)
        x = x.to(dtype)
        with no_tf32():
            ref_y, ref_c = lstm_forward_train(x, w_ih, w_hh, bias)
        paths = (None, False, True) if w == 32 and t <= lstm_kernel.FWD_SHORT_MAX_STEPS else (None,)
        for short in paths:
            y0 = lstm_kernel.forward_kernel(x, w_ih, w_hh, bias, rows=rows, short=short)
            y, cprev = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias, rows=rows, short=short)
            torch.cuda.synchronize()
            assert torch.equal(y0, y), (w, short)
            assert float((y0.float() - ref_y.float()).abs().max()) <= tol, (w, short)
            assert float((y.float() - ref_y.float()).abs().max()) <= tol, (w, short)
            assert float((cprev - ref_c).abs().max()) <= tol, (w, short)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", lstm_kernel.BWD_ROWS)
@pytest.mark.parametrize("b,t", SHORT_AND_RAGGED)
def test_backward_kernel_every_rows_variant(cuda, b, t, rows, dtype, tol):
    """Kernel C at each rows-per-block instantiation of its recurrent kernel
    vs lstm_backward on the plain forward's (y, cprev): the backward's
    tolerances, and the same bits in two runs."""
    from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train

    x, w_ih, w_hh, bias = _inputs(b, t, cuda, seed=7)
    x = x.to(dtype)
    dy = torch.randn(b, t, 64, device=cuda, generator=torch.Generator(cuda).manual_seed(8)).to(dtype)
    with no_tf32():
        y, cprev = lstm_forward_train(x, w_ih, w_hh, bias)
        ref = lstm_backward(x, y, cprev, dy, w_ih, w_hh, bias)
    got = lstm_kernel.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias, rows=rows)
    again = lstm_kernel.backward_kernel(x, y, cprev, dy, w_ih, w_hh, bias, rows=rows)
    torch.cuda.synchronize()
    for name, a, r, a2 in zip(("dx", "dw_ih", "dw_hh", "db"), got, ref, again):
        rel = float((a.float() - r.float()).abs().max() / (r.float().abs().max() + 1e-12))
        assert rel <= tol, (name, rel)
        assert torch.equal(a, a2), name


def test_kernel_refuses_rows_it_is_not_built_for(cuda):
    x, w_ih, w_hh, bias = _inputs(2, 8, cuda)
    with pytest.raises(RuntimeError, match="invalid"):
        lstm_kernel.forward_kernel(x, w_ih, w_hh, bias, rows=3)


def test_kernel_refuses_the_short_path_at_width64(cuda):
    """The forward's short path is built for widths 32 and 16 only: forcing
    it at width 64 raises before any launch, as does the fused backward."""
    x, w_ih, w_hh, bias = _inputs(2, 8, cuda)
    with pytest.raises(ValueError, match="short path"):
        lstm_kernel.forward_kernel(x, w_ih, w_hh, bias, short=True)
    y, cprev = lstm_kernel.forward_train_kernel(x, w_ih, w_hh, bias)
    with pytest.raises(ValueError, match="fused backward"):
        lstm_kernel.backward_kernel(x, y, cprev, torch.zeros_like(y), w_ih, w_hh, bias, fused=True)


# -- the attack ops on the card vs the CPU ---------------------------------------


def _audio(shape, seed=0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32))


@pytest.mark.parametrize("cutoff,q", [(7000.0, 0.707), (4000.0, 0.707), (1000.0, 200.0)],
                         ids=["7k", "4k", "high_q_scan"])
def test_lowpass_biquad_on_card_matches_cpu(cuda, cutoff, q):
    """FIR form (and the scan fallback for the high-Q set) with TF32 allowed
    around the call: the op turns it off itself.  1e-5 (the scan 2e-4 of the
    output's max)."""
    from awm_tpu_torch.dsp import lowpass_biquad

    x = _audio((4, 16000), seed=1)
    torch.backends.cudnn.allow_tf32 = True
    got = lowpass_biquad(x.to(cuda), 16000, cutoff, q).cpu()
    want = lowpass_biquad(x, 16000, cutoff, q)
    tol = 1e-5 if q < 1 else 2e-4 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("rate", [8000, 11025, 22050])
def test_resample_roundtrip_on_card_matches_cpu(cuda, rate):
    """One strided conv each way in true fp32 on the card: 1e-5 vs the CPU."""
    from awm_tpu_torch.augment import resample_roundtrip

    x = _audio((4, 16000), seed=2)
    torch.backends.cudnn.allow_tf32 = True
    got = resample_roundtrip(x.to(cuda), rate).cpu()
    assert got.shape == x.shape
    assert float((got - resample_roundtrip(x, rate)).abs().max()) <= 1e-5


def test_attack_conv_gradients_on_card_are_true_fp32(cuda):
    """The backward of the resampling and biquad convolutions runs when
    autograd gets to it, outside any no_tf32 context of the caller's:
    conv1d_fp32 turns TF32 off there too.  1e-5 of the gradient's max vs the
    CPU (TF32 shows as ~1e-3)."""
    from awm_tpu_torch.augment import resample_roundtrip
    from awm_tpu_torch.dsp import fir_lowpass, lowpass_biquad

    torch.backends.cudnn.allow_tf32 = True
    chain = lambda v: fir_lowpass(lowpass_biquad(resample_roundtrip(v, 22050), 16000, 4000.0), 3000.0)
    grads = []
    for dev in (cuda, "cpu"):
        v = _audio((4, 16000), seed=5).to(dev).requires_grad_()
        torch.sin(3.0 * chain(v)).sum().backward()
        grads.append(v.grad.cpu())
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-5 * float(grads[1].abs().max())


def test_codecs_and_quantize_on_card_are_exact(cuda):
    from awm_tpu_torch.dsp import alaw_roundtrip, mulaw_roundtrip, quantize_int16

    x = _audio((4, 16000), seed=3)
    for fn in (mulaw_roundtrip, alaw_roundtrip, quantize_int16):
        assert torch.equal(fn(x.to(cuda)).cpu(), fn(x)), fn.__name__


def test_robust_step_launches_the_kernels(cuda):
    """One bf16 train step under the attack curriculum on the card: finite
    terms, kernels B and C launched once each, attacks drawn on the card."""
    import dataclasses

    from awm_tpu_torch import train as tr
    from awm_tpu_torch.augment import AugmentConfig
    from awm_tpu_torch.config import get_config

    cfg = dataclasses.replace(
        get_config("base"), audio_len=2000,
        augment=AugmentConfig(noise_snr_db=(10.0, 40.0), volume_range=(0.3, 1.2), lowpass_hz=(3500.0, 7000.0),
                              quantize=True, resample_hz=(8000, 22050), attack_prob=0.45))
    state = tr.init_state(cfg, device=cuda)
    assert state.attack_generator.device.type == "cuda"
    before = dict(lstm_kernel.launches)
    terms = tr.train_step(cfg, state, _audio((4, 2000), seed=4).to(cuda))
    assert all(bool(torch.isfinite(v)) for v in terms.values())
    for name in ("lstm_fwd_train_bf16", "lstm_bwd_bf16"):
        assert lstm_kernel.launches[name] == before[name] + 1


# -- checkpoints and serving on the card -------------------------------------------


def test_checkpoint_from_card_restores_on_cpu(cuda, tmp_path):
    """A TrainState trained two steps on the card, saved, and restored into
    a CPU state: parameters, BN statistics and Adam moments equal tensor for
    tensor; step, epoch and best_val back."""
    import dataclasses

    from awm_tpu_torch import checkpoint as ck
    from awm_tpu_torch import train as tr
    from awm_tpu_torch.config import get_config

    cfg = dataclasses.replace(get_config("base"), audio_len=400)
    state = tr.init_state(cfg, seed=1, device=cuda)
    for _ in range(2):
        tr.train_step(cfg, state, _audio((2, 400), seed=9).to(cuda))
    ck.save_checkpoint(str(tmp_path / "c"), state, epoch=2, best_val=0.5, model_cfg=cfg.model)
    cpu = tr.init_state(cfg, seed=2, device="cpu")
    _, epoch, best_val = ck.restore_checkpoint(str(tmp_path / "c"), cpu)
    assert (epoch, best_val, cpu.step) == (2, 0.5, 2)
    for net in ("gen", "det"):
        a, b = getattr(state, net).state_dict(), getattr(cpu, net).state_dict()
        assert all(b[k].device.type == "cpu" and torch.equal(a[k].cpu(), b[k]) for k in a), net
    oa, ob = state.optimizer.state_dict()["state"], cpu.optimizer.state_dict()["state"]
    assert all(torch.equal(v.cpu(), ob[i][k].cpu()) for i in oa for k, v in oa[i].items())


def test_server_batched_fp32_equals_alone_on_card(cuda):
    """The fp32 server on the card, six concurrent clients (embed and
    detect, ragged lengths of 512-sample chunks): each response equals the
    same call on the unbatched session (embed within one int16 LSB, detect
    within 1e-5), with fewer device batches than requests.  The batcher's
    first device call (a seventh, detect request) is held until the six are
    queued, each sent once the one before is in the queue, so the batches
    they meet in do not depend on timing: in the queue's order e d e d e d
    the batcher's windows (same-op co-riders, another op spilled to the
    back) give four device batches, e, e, e, then d d d.  (The wait window
    alone let a batch close before a co-rider arrived: one run in 50 on the
    card had six batches of one.)"""
    import http.client
    import io
    import json
    import threading
    import time
    import wave

    from awm_tpu_torch.api import InferenceSession, detect_array, watermark_array
    from awm_tpu_torch.serve import make_server
    from awm_tpu_torch.utils.audio_io import encode_wav_bytes

    class Held:
        """The batcher's session: a device call waits until release is set."""

        def __init__(self, inner):
            self.inner, self.entered, self.release = inner, threading.Event(), threading.Event()

        def __getattr__(self, name):
            fn = getattr(self.inner, name)

            def call(*args, **kw):
                self.entered.set()
                assert self.release.wait(120)
                return fn(*args, **kw)
            return call

    def until(cond, what):
        deadline = time.monotonic() + 60
        while not cond():
            assert time.monotonic() < deadline, what
            time.sleep(0.002)

    sess = InferenceSession.from_npz(compute_dtype=torch.float32, device="cuda", chunk_len=512)
    httpd, batched = make_server(sess, "127.0.0.1", 0, max_wait_ms=50.0)
    held = Held(sess)
    batched.batcher.session = held
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    rng = np.random.default_rng(0)
    waves = [(0.2 * rng.standard_normal(int(n))).astype(np.float32) for n in rng.integers(700, 2000, 6)]
    bodies = [encode_wav_bytes(w, 16000) for w in waves]
    pcm = lambda b: np.frombuffer(wave.open(io.BytesIO(b)).readframes(10**7), "<i2").astype(np.int32)
    results = {}

    def hit(i):
        c = http.client.HTTPConnection(*httpd.server_address, timeout=120)
        path = f"/embed?message={i}&seed={i}" if i % 2 == 0 else "/detect"
        body = bodies[i % 6]
        c.request("POST", path, body=body, headers={"Content-Length": str(len(body))})
        r = c.getresponse()
        results[i] = (r.status, r.read())

    try:
        threads = [threading.Thread(target=hit, args=(7,))]  # the held call: detect of bodies[1]
        threads[0].start()
        until(held.entered.is_set, "the first device call")
        for i in range(6):
            threads.append(threading.Thread(target=hit, args=(i,)))
            threads[-1].start()
            until(lambda: batched.batcher._q.qsize() == i + 1, f"request {i} queued")
        held.release.set()
        for t in threads:
            t.join(timeout=120)
        stats = dict(batched.batcher.stats)
    finally:
        held.release.set()
        httpd.shutdown()
        httpd.server_close()
        batched.close()
    assert results[7][0] == 200, results[7][1]
    for i in range(6):
        status, body = results[i]
        assert status == 200, body
        x = pcm(bodies[i]).astype(np.float32) / 32768.0
        if i % 2 == 0:
            want = watermark_array(x, sess, message=i, seed=i)["watermarked_waveform"]
            assert np.abs(pcm(body) - pcm(encode_wav_bytes(want, 16000))).max() <= 1
        else:
            got, want = json.loads(body), detect_array(x, sess)
            assert abs(got["mean_probability"] - want["mean_probability"]) <= 1e-5
            assert got["predicted_message"] == want["predicted_message"]
            np.testing.assert_allclose(got["message_confidence"], want["message_confidence"], atol=1e-5)
    six = {k: stats[k] - 1 for k in ("requests", "device_batches")}  # the held call's aside
    assert six["device_batches"] < six["requests"] == 6
    assert six["device_batches"] == 4


def _shapecap_step_inputs(b, t):
    rng = np.random.default_rng(4)
    return ((rng.standard_normal((b, t)) * 0.2).astype(np.float32),
            rng.integers(0, 2**16, b).astype(np.int64))


def test_mesh_of_one_step_equals_plain_on_card(cuda, tmp_path):
    """A mesh of one process over NCCL: the fp32 step issues no collective
    and gives the plain step's terms (1e-6 relative; cuDNN may pick its
    algorithms anew), through kernels B and C."""
    import torch.distributed as dist

    import torch_parallel_worker as pw
    from awm_tpu_torch import train as tr
    from awm_tpu_torch.parallel import collectives, initialize_distributed, make_mesh, shard_state

    cfg = pw.job_config({"audio_len": 800})
    s, m = (torch.from_numpy(a).to(cuda) for a in _shapecap_step_inputs(4, 800))
    plain = tr.train_step(cfg, pw.job_state(cfg, cuda), s, message=m)
    initialize_distributed(f"file://{tmp_path}/rdzv", 1, 0, device=cuda)
    try:
        state = shard_state(pw.job_state(cfg, cuda), make_mesh())
        before = dict(lstm_kernel.launches)
        count = collectives.stats["count"]
        terms = tr.train_step(cfg, state, s, message=m)
        assert collectives.stats["count"] == count
        for k in ("lstm_fwd_train_f32", "lstm_bwd_f32"):
            assert lstm_kernel.launches[k] > before[k], k
    finally:
        dist.destroy_process_group()
    for k, v in plain.items():
        assert abs(float(terms[k]) - float(v)) <= 1e-6 * abs(float(v)), k


def test_two_ranks_over_gloo_on_card(cuda, tmp_path):
    """Two ranks on the one card over gloo (data=2, one row each, T=800):
    the fp32 step against one process on the card, at the CPU test's
    tolerances: terms 1e-5 relative, BatchNorm statistics 1e-5, and the
    gradients and updated parameters by torch_parallel_worker.check_step
    (5e-3 of each parameter's largest gradient; 1e-2 lr where the gradient
    is clearly nonzero, 2 lr elsewhere)."""
    import json
    import os
    import subprocess
    import sys

    import torch_parallel_worker as pw
    from awm_tpu_torch import train as tr
    from awm_tpu_torch.parallel import full_grads

    s, m = _shapecap_step_inputs(2, 800)
    np.savez(tmp_path / "in.npz", s=s, messages=m[None])
    job = {"name": "clean", "inputs": str(tmp_path / "in.npz"), "audio_len": 800}
    (tmp_path / "spec.json").write_text(json.dumps(
        {"url": f"file://{tmp_path}/rdzv", "device": "cuda:0", "out": str(tmp_path), "jobs": [job]}))
    env = dict(os.environ, PYTHONPATH=pw.REPO)
    procs = [subprocess.Popen([sys.executable, os.path.join(pw.REPO, "tests", "torch_parallel_worker.py"),
                               str(tmp_path / "spec.json"), str(r), "2"], env=env)
             for r in range(2)]
    try:
        assert [p.wait(timeout=300) for p in procs] == [0, 0]
    finally:
        for p in procs:
            p.kill()
    cfg = pw.job_config(job)
    one = pw.job_state(cfg, cuda)
    terms = tr.train_step(cfg, one, torch.from_numpy(s).to(cuda), message=torch.from_numpy(m).to(cuda))
    lr = cfg.train.schedule.lr
    params = [f"{n}.{k}" for n in ("gen", "det") for k, _ in getattr(one, n).named_parameters()]
    want = {f"{n}.{k}": v.cpu().numpy() for n in ("gen", "det") for k, v in getattr(one, n).state_dict().items()}
    want.update({f"grad.{k}": v.cpu().numpy() for k, v in full_grads(one).items()})
    for r in range(2):
        got = dict(np.load(tmp_path / f"clean.{r}.npz"))
        for k, v in terms.items():
            assert abs(float(got[f"term0/{k}"]) - float(v)) <= 1e-5 * abs(float(v)), (r, k)
        pw.check_step(got, want, lr, params)
        for k, v in want.items():
            if k not in params and not k.startswith("grad."):
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5, err_msg=f"{r} {k}")


def test_cluster_plan_reads_the_clusters_the_card_holds(cuda):
    """The cluster path's waves come from cudaOccupancyMaxActiveClusters:
    at least one and at most sm_count // K clusters of each rows variant of
    kernel A and C's recurrence (one CTA an SM), 2 sm_count // K for C's
    bf16 recurrence up to four rows (two CTAs an SM, which its registers
    allow), and a call's plan is the pure plan given that reading."""
    sm_count = torch.cuda.get_device_properties(cuda).multi_processor_count
    for w in (96, 128, 256):
        k = -(-w // lstm_kernel.CLUSTER_UNITS)
        for dtype in (torch.float32, torch.bfloat16):
            slots = lstm_kernel._cluster_slots(cuda.index or 0, dtype, w, w)
            assert all(len(s) == len(lstm_kernel.CLUSTER_ROWS) for s in slots), slots
            most = [[(2 if j == 1 and dtype == torch.bfloat16 and r <= 4 else 1) * sm_count // k
                     for r in lstm_kernel.CLUSTER_ROWS] for j in (0, 1)]
            assert all(1 <= n <= m for pair, bound in zip(slots, most) for n, m in zip(pair, bound)), (w, dtype, slots)
            x = torch.zeros(64, 8, w, device=cuda, dtype=dtype)
            assert lstm_kernel._plan_for(x, w) == lstm_kernel.launch_plan(64, 8, dtype, sm_count, w, None, w, slots)
