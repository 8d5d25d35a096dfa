"""Port ops vs the JAX package: the plain LSTM recurrence, training forward
and backward against the Pallas LSTM kernels in interpret mode, the
autograd Function, the kernel wrappers' routing, and the convs.

Inputs are seeded numpy arrays handed to both packages; tolerances are
stated per test."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from awm_tpu.ops.conv import conv1d as jconv1d, conv_transpose1d as jconv_t
from awm_tpu.ops import lstm_cell as jlstm_cell, lstm_stack as jlstm_stack
from awm_tpu.ops.lstm import lstm_forward as jlstm
from awm_tpu.ops.pallas.lstm_kernel import lstm_pallas_forward

from awm_tpu_torch.ops import (conv1d, conv_transpose1d, lstm_cell, lstm_forward, lstm_fused_forward,
                               lstm_stack)
from awm_tpu_torch.ops.lstm import lstm_backward, lstm_forward_train
from awm_tpu_torch.ops import lstm_kernel


def _lstm_inputs(rng, b, t, d=64, h=64):
    return (
        (rng.standard_normal((b, t, d)) * 0.3).astype(np.float32),
        (rng.standard_normal((4 * h, d)) * 0.1).astype(np.float32),
        (rng.standard_normal((4 * h, h)) * 0.1).astype(np.float32),
        (rng.standard_normal((4 * h,)) * 0.1).astype(np.float32),
    )


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,t,d,h", [(2, 256, 64, 64), (3, 128, 16, 32), (1, 64, 64, 64), (4, 32, 16, 16)])
def test_plain_lstm_matches_jax_scan(rng, b, t, d, h):
    """fp32: same recurrence, only the summation order differs -> 2e-5
    (the fp32 tolerance of tests/test_pallas.py)."""
    x, w_ih, w_hh, bias = _lstm_inputs(rng, b, t, d, h)
    ref = np.asarray(jlstm(*map(jnp.asarray, (x, w_ih, w_hh, bias))))
    out = lstm_forward(*_t(x, w_ih, w_hh, bias))
    assert out.dtype == torch.float32 and out.shape == (b, t, h)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("w", [64, 32])
def test_lstm_cell_matches_jax(rng, w):
    """One step over pre-projected gates, B=3, at both widths: fp32 at 1e-5
    (the h product's summation order)."""
    xp = (rng.standard_normal((3, 4 * w)) * 0.5).astype(np.float32)
    h = (rng.standard_normal((3, w)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((3, w)) * 0.5).astype(np.float32)
    w_hh = (rng.standard_normal((4 * w, w)) * 0.1).astype(np.float32)
    ref_h, ref_c = jlstm_cell(*map(jnp.asarray, (xp, h, c, w_hh)))
    got_h, got_c = lstm_cell(*_t(xp, h, c, w_hh))
    assert got_h.dtype == torch.float32 and got_h.shape == got_c.shape == (3, w)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), atol=1e-5)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), atol=1e-5)


@pytest.mark.parametrize("w,t", [(64, 64), (32, 50)], ids=["64", "32"])
def test_lstm_stack_matches_jax(rng, w, t):
    """Two stacked layers (main14b_2's depth) as a tuple of {w_ih, w_hh, b},
    B=2: fp32 at 1e-5 (summation order over T <= 64 steps)."""
    x = _lstm_inputs(rng, 2, t, w, w)[0]
    layers = [dict(zip(("w_ih", "w_hh", "b"), _lstm_inputs(rng, 1, 1, w, w)[1:])) for _ in range(2)]
    ref = jlstm_stack(jnp.asarray(x), tuple({k: jnp.asarray(v) for k, v in p.items()} for p in layers))
    got = lstm_stack(torch.from_numpy(x), tuple({k: torch.from_numpy(v) for k, v in p.items()}
                                                for p in layers))
    assert got.dtype == torch.float32 and got.shape == (2, t, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# (width, T): the base family's LSTM(64) and the strided family's LSTM(32)
# over its 50 strided steps.  Cases of width 64 keep their original ids.
W32 = (32, 50)


@pytest.mark.parametrize("b,w,t", [(2, 64, 128), (3, 64, 128), (2, *W32), (3, *W32)]
                         + [(2, dh, 32) for dh in [(48, 48), (40, 24), (96, 96), (128, 128)]],
                         ids=["2", "3", "2-w32", "3-w32", "2-48x48", "2-40x24", "2-96x96", "2-128x128"])
def test_plain_lstm_matches_pallas_kernel_fp32(rng, b, w, t):
    """The TPU kernel (interpret mode) and the port's plain version of the
    CUDA kernel agree in fp32 at 2e-5, at widths 64 and 32 and at the widths
    the kernels take masked or on the cluster path ((D, H) pairs)."""
    d, h = w if isinstance(w, tuple) else (w, w)
    x, w_ih, w_hh, bias = _lstm_inputs(rng, b, t, d, h)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(lstm_pallas_forward(*map(jnp.asarray, (x, w_ih, w_hh, bias))))
    out = lstm_forward(*_t(x, w_ih, w_hh, bias))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


def test_plain_lstm_matches_pallas_kernel_bf16(rng):
    """bf16 contract (x, weights and the recurrent h rounded to bf16, fp32
    accumulation and state, y stored bf16) matches the TPU kernel's, at
    width 64 (T=128) and 32 (T=50).  Both round at the same points, so they
    differ by the fp32 summation order plus at most one bf16 ulp of y
    (2^-8 relative at |y| < 1): 1e-2."""
    for w, t in ((64, 128), W32):
        x, w_ih, w_hh, bias = _lstm_inputs(rng, 2, t, w, w)
        with pltpu.force_tpu_interpret_mode():
            ref = lstm_pallas_forward(
                jnp.asarray(x).astype(jnp.bfloat16), *map(jnp.asarray, (w_ih, w_hh, bias))
            )
        out = lstm_forward(torch.from_numpy(x).to(torch.bfloat16), *_t(w_ih, w_hh, bias))
        assert out.dtype == torch.bfloat16 and out.shape == (2, t, w)
        err = np.abs(out.float().numpy() - np.asarray(ref.astype(jnp.float32))).max()
        assert err < 1e-2, (w, err)
        # and stays within the bf16 bound of tests/test_pallas.py of the fp32 result
        ref32 = np.asarray(jlstm(*map(jnp.asarray, (x, w_ih, w_hh, bias))))
        assert np.abs(out.float().numpy() - ref32).max() < 5e-2, w


def test_wrapper_routes_cpu_tensors_to_plain_version(rng):
    """On a CPU tensor the wrapper returns the plain version's result
    exactly and launches nothing."""
    x, w_ih, w_hh, bias = _t(*_lstm_inputs(rng, 3, 32))
    before = dict(lstm_kernel.launches)
    out = lstm_fused_forward(x, w_ih, w_hh, bias)
    assert lstm_kernel.launches == before
    assert torch.equal(out, lstm_forward(x, w_ih, w_hh, bias))


def test_wrapper_refuses_other_devices(rng):
    x, w_ih, w_hh, bias = _t(*_lstm_inputs(rng, 1, 4))
    with pytest.raises(ValueError, match="cuda"):
        lstm_fused_forward(x.to("meta"), w_ih.to("meta"), w_hh.to("meta"), bias.to("meta"))


@pytest.mark.parametrize(
    "k,stride,padding,dilation", [(7, 1, 3, 1), (3, 1, 16, 16), (3, 2, 1, 1), (1, 1, 0, 1)]
)
def test_conv1d_matches_jax(rng, k, stride, padding, dilation):
    """fp32 conv, (B, T, C) / (k, in, out) in JAX vs (B, C, T) / (out, in, k)
    here: summation order only -> 1e-5."""
    x = rng.standard_normal((2, 96, 5)).astype(np.float32)
    w = rng.standard_normal((k, 5, 6)).astype(np.float32) * 0.3
    b = rng.standard_normal(6).astype(np.float32)
    ref = np.asarray(jconv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             stride=stride, padding=padding, dilation=dilation))
    out = conv1d(torch.from_numpy(x).transpose(1, 2), torch.from_numpy(w).permute(2, 1, 0),
                 torch.from_numpy(b), stride=stride, padding=padding, dilation=dilation)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("k,stride,padding,output_padding", [(7, 1, 3, 0), (4, 2, 1, 0), (5, 3, 1, 2)])
def test_conv_transpose1d_matches_jax(rng, k, stride, padding, output_padding):
    """Transposed conv: JAX (k, in, out) maps to torch (in, out, k) without
    a flip (awm_tpu/checkpoint.py::_conv_t) -> 1e-5."""
    x = rng.standard_normal((2, 40, 5)).astype(np.float32)
    w = rng.standard_normal((k, 5, 6)).astype(np.float32) * 0.3
    b = rng.standard_normal(6).astype(np.float32)
    ref = np.asarray(jconv_t(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                             padding=padding, output_padding=output_padding))
    out = conv_transpose1d(torch.from_numpy(x).transpose(1, 2),
                           torch.from_numpy(w).permute(1, 2, 0), torch.from_numpy(b),
                           stride=stride, padding=padding, output_padding=output_padding)
    assert out.shape[2] == ref.shape[1]
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), ref, atol=1e-5)


def test_fir_and_shaping_match_jax(rng):
    """fp32 FIR (JAX pins Precision.HIGHEST) and the main16 chain: 1e-7."""
    from awm_tpu.config import ShapingConfig as JShaping
    from awm_tpu.shaping import clamp_peak as jclamp, limit_rms as jlimit, shape_delta as jshape
    from awm_tpu.dsp import fir_lowpass as jfir
    from awm_tpu_torch.config import ShapingConfig
    from awm_tpu_torch.dsp import fir_lowpass
    from awm_tpu_torch.shaping import clamp_peak, limit_rms, shape_delta

    d = (rng.standard_normal((3, 700)) * 0.02).astype(np.float32)
    jd, td = jnp.asarray(d), torch.from_numpy(d)
    pairs = [
        (jfir(jd, 3000.0, 101), fir_lowpass(td, 3000.0, 101)),
        (jclamp(jd, 0.02), clamp_peak(td, 0.02)),
        (jlimit(jd, 0.01), limit_rms(td, 0.01)),
        (jshape(jd, JShaping(enabled=True, max_rms=0.01)),
         shape_delta(td, ShapingConfig(enabled=True, max_rms=0.01))),
    ]
    for ref, out in pairs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-7)
    shaped = shape_delta(td, ShapingConfig(enabled=True, max_rms=0.01))
    assert float(shaped.square().mean(dim=1).sqrt().max()) <= 0.01
    # the FIR keeps its input dtype but computes in fp32
    assert fir_lowpass(td.to(torch.bfloat16), 3000.0).dtype == torch.bfloat16


# -- kernels B and C: plain versions, the autograd Function, the routing ------


def _train_case(rng, b, t, dtype, w=64):
    """w: the width D = H, or a pair (D, H)."""
    d, h = w if isinstance(w, tuple) else (w, w)
    x, w_ih, w_hh, bias = _lstm_inputs(rng, b, t, d, h)
    dy = (rng.standard_normal((b, t, h)) * 0.5).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    tx = torch.from_numpy(x).to(dtype)
    return x, (w_ih, w_hh, bias), dy, jx, tx


def _rel(a, ref):
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max() / (np.abs(ref).max() + 1e-12))


# bf16 dx at the new widths ((D, H) pairs), relative to its max: dx is
# stored bf16, so a sum that differs by order alone may round to the other
# neighbour (2^-8 = 3.9e-3 of an element), and each da that lands on the
# other side of a rounding boundary moves dx by one bf16 ulp of that da times
# a weight; at 4H = 512 terms (H = 128) more of them do (measured 3.6e-3 at
# 128 x 128, against 1e-3 held at W <= 64).
BF16_DX_NEW_WIDTHS_TOL = 5e-3
# bf16 past 256 (the wide path's widths): the inputs' fixed weight scale of
# 0.1 gives the recurrence a gain of about 0.1 sqrt(H) (1.6 at 257, 2.4 at
# 600, against 1.1 at 128), so a value that lands on the other side of a
# bf16 rounding boundary in one of the two correct computations grows along
# T instead of dying out: measured over seeds 0-2 at T=32, c_{t-1} 5.3e-3
# absolute (held at 1e-3 below 256) and C's tensors 6.1e-3 of their max (dx
# 5e-3, the rest 1e-3 below 256), while fp32 stays at 1.4e-6.  Held at 1e-2,
# the card's bf16 bound for kernel C against its plain version (KERNEL_TOL).
BF16_WIDE_TOL = 1e-2


def _bf16_tol(dtype, w, name, tol):
    """The bound of one bf16 tensor at width w (an int, or a (D, H) pair)."""
    if dtype != torch.bfloat16 or not isinstance(w, tuple):
        return tol
    if max(w) > 256:
        return BF16_WIDE_TOL
    return BF16_DX_NEW_WIDTHS_TOL if name == "dx" else tol


# dtype, width, T: width 64 at T=128 (ids as before), width 32 at T=50,
# width 16 at T=32 (the shape of entry.dryrun_multichip's gradient check);
# the widths the kernels take masked (48 x 48, the base family at channels
# 48; 40 x 24, D != H), on the cluster path (96 x 96, 128 x 128, the base
# family at channels 128) and on the wide path past 256 (257 x 257, one unit
# past a 16-unit CTA; 300 x 300, a ragged last CTA; 40 x 600, D != H), and
# masked within capacities 32 and 16, which the short forward and the fused
# backward take at T <= 64 (24 x 24, the strided family at hidden_dim 24;
# 20 x 32; 12 x 12), as (D, H) at T=32.
NEW_WIDTHS = [(48, 48), (40, 24), (96, 96), (128, 128), (257, 257), (300, 300), (40, 600), (24, 24), (20, 32),
              (12, 12)]
TRAIN_CASES = [pytest.param(torch.float32, 64, 128, id="f32"),
               pytest.param(torch.bfloat16, 64, 128, id="bf16"),
               pytest.param(torch.float32, *W32, id="f32-w32"),
               pytest.param(torch.bfloat16, *W32, id="bf16-w32"),
               pytest.param(torch.float32, 16, 32, id="f32-w16"),
               pytest.param(torch.bfloat16, 16, 32, id="bf16-w16")] + [
    pytest.param(dt, dh, 32, id=f"{sfx}-{dh[0]}x{dh[1]}")
    for dh in NEW_WIDTHS for dt, sfx in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))]


@pytest.mark.parametrize("dtype,w,t", TRAIN_CASES)
def test_plain_forward_train_matches_pallas(rng, dtype, w, t):
    """Plain kernel B vs the TPU's _forward_train in interpret mode, B=3,
    width 64 at T=128 and 32 at T=50 (the Pallas grid tiles time, the plain
    version does not).  fp32:
    y and cprev 2e-5 (summation order only; measured 1.2e-7).  bf16: y 1e-2
    (one bf16 ulp of |y| < 1 plus order; measured 4.9e-4); cprev 1e-3, since
    an h that rounds to the other bf16 neighbour moves the next steps' fp32 c
    (measured 9.2e-5)."""
    from awm_tpu.ops.pallas.lstm_kernel import _forward_train

    _, (w_ih, w_hh, bias), _, jx, tx = _train_case(rng, 3, t, dtype, w)
    with pltpu.force_tpu_interpret_mode():
        ref_y, ref_c = _forward_train(jx, *map(jnp.asarray, (w_ih, w_hh, bias)))
    y, cprev = lstm_forward_train(tx, *_t(w_ih, w_hh, bias))
    assert y.dtype == dtype and cprev.dtype == torch.float32
    tol_y, tol_c = (2e-5, 2e-5) if dtype == torch.float32 else (1e-2, _bf16_tol(dtype, w, "cprev", 1e-3))
    ref_y = np.swapaxes(np.asarray(ref_y.astype(jnp.float32)), 0, 1)
    ref_c = np.swapaxes(np.asarray(ref_c), 0, 1)
    np.testing.assert_allclose(y.float().numpy(), ref_y, atol=tol_y)
    np.testing.assert_allclose(cprev.numpy(), ref_c, atol=tol_c)
    # the training forward's y is the inference forward's
    assert torch.equal(y, lstm_forward(tx, *_t(w_ih, w_hh, bias)))


@pytest.mark.parametrize("dtype,w,t", TRAIN_CASES)
def test_plain_backward_matches_pallas(rng, dtype, w, t):
    """Plain kernel C vs the TPU's _backward in interpret mode on the same
    (x, y, cprev, dy), B=3, width 64 at T=128 and 32 at T=50, relative to
    each tensor's max.  fp32: 1e-5
    (summation order; measured 6.6e-7).  bf16: 1e-3 (da is rounded to bf16
    before every product, and a da that lands on the other side of a
    rounding boundary moves its products by one bf16 ulp; measured 3.4e-6)."""
    from awm_tpu.ops.pallas.lstm_kernel import _backward, _forward_train

    _, (w_ih, w_hh, bias), dy, jx, tx = _train_case(rng, 3, t, dtype, w)
    jw = list(map(jnp.asarray, (w_ih, w_hh, bias)))
    with pltpu.force_tpu_interpret_mode():
        y_t, c_t = _forward_train(jx, *jw)
        ref = _backward(jnp.swapaxes(jx, 0, 1), y_t, c_t, jnp.swapaxes(jnp.asarray(dy), 0, 1),
                        *jw, dx_dtype=jx.dtype)
    y = torch.from_numpy(np.swapaxes(np.asarray(y_t.astype(jnp.float32)), 0, 1).copy()).to(dtype)
    cprev = torch.from_numpy(np.swapaxes(np.asarray(c_t), 0, 1).copy())
    got = lstm_backward(tx, y, cprev, torch.from_numpy(dy), *_t(w_ih, w_hh, bias))
    assert got[0].dtype == dtype and all(g.dtype == torch.float32 for g in got[1:])
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    ref_dx = np.swapaxes(np.asarray(ref[0].astype(jnp.float32)), 0, 1)
    for name, a, r in zip(("dx", "dw_ih", "dw_hh", "db"), got,
                          (ref_dx, *(np.asarray(v) for v in ref[1:]))):
        t_ = _bf16_tol(dtype, w, name, tol)
        assert _rel(a.float().numpy(), r) < t_, (name, _rel(a.float().numpy(), r))


@pytest.mark.parametrize("dtype,w,t", TRAIN_CASES)
def test_lstm_function_grads_match_jax_grad(rng, dtype, w, t):
    """LSTMFunction (plain B and C on the CPU) vs jax.grad of the TPU's
    lstm_fused custom_vjp in interpret mode, loss sum(sin(y)), B=2, width 64
    at T=128 and 32 at T=50.
    Cotangents come back in the primals' dtypes.  Relative to each
    gradient's max: fp32 1e-5 (the 5e-3 of tests/test_pallas.py, tightened
    to what is measured, 4.7e-7); bf16 1e-3 (the two sides round y and da to
    bf16 at the same points; a value on a rounding boundary moves by one
    ulp; measured 4.7e-7)."""
    from awm_tpu.ops.pallas.lstm_kernel import lstm_fused

    from awm_tpu_torch.ops.lstm_kernel import LSTMFunction

    _, (w_ih, w_hh, bias), _, jx, tx = _train_case(rng, 2, t, dtype, w)

    def loss(*a):
        return jnp.sum(jnp.sin(lstm_fused(*a).astype(jnp.float32)))

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2, 3))(jx, *map(jnp.asarray, (w_ih, w_hh, bias)))
    leaves = [tx.requires_grad_(), *(p.requires_grad_() for p in _t(w_ih, w_hh, bias))]
    y = LSTMFunction.apply(*leaves)
    torch.sin(y.float()).sum().backward()
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    for name, leaf, r in zip(("dx", "dw_ih", "dw_hh", "db"), leaves, ref):
        assert leaf.grad.dtype == leaf.dtype, name
        t_ = _bf16_tol(dtype, w, name, tol)
        err = _rel(leaf.grad.float().numpy(), np.asarray(r.astype(jnp.float32)))
        assert err < t_, (name, err)


def test_lstm_function_matches_autograd_of_plain_forward(rng):
    """The hand-written backward equals autograd of the plain fp32
    recurrence (independent of the JAX package): 1e-5 of each max."""
    from awm_tpu_torch.ops.lstm_kernel import LSTMFunction

    arrays = _lstm_inputs(rng, 3, 96)
    a = [p.requires_grad_() for p in _t(*arrays)]
    b = [p.requires_grad_() for p in _t(*arrays)]
    torch.sin(LSTMFunction.apply(*a)).sum().backward()
    torch.sin(lstm_forward(*b)).sum().backward()
    for pa, pb in zip(a, b):
        assert _rel(pa.grad.numpy(), pb.grad.numpy()) < 1e-5


def test_routing_never_detaches_under_grad(rng, monkeypatch):
    """The repaired fault: on the card, a CUDA tensor under grad used to go
    to the inference kernel, whose output has no grad_fn, so no gradient
    reached the LSTM's weights or anything upstream of it.  Here the device
    decision is faked as "cuda" and each kernel replaced by its plain version
    with a record of the call: under grad the routing must take kernel B then
    C and the gradients must reach every input; without grad, kernel A."""
    from awm_tpu_torch.ops import lstm as plain

    calls = []

    def fake(name, fn):
        def run(*args):
            calls.append(name)
            return fn(*args)
        return run

    monkeypatch.setattr(lstm_kernel, "_on_card", lambda x: True)
    monkeypatch.setattr(lstm_kernel, "forward_kernel", fake("A", plain.lstm_forward))
    monkeypatch.setattr(lstm_kernel, "forward_train_kernel", fake("B", plain.lstm_forward_train))
    monkeypatch.setattr(lstm_kernel, "backward_kernel", fake("C", plain.lstm_backward))

    arrays = _t(*_lstm_inputs(rng, 2, 16))
    x, w_ih, w_hh, bias = arrays[0], *(p.requires_grad_() for p in arrays[1:])
    y = lstm_fused_forward(x, w_ih, w_hh, bias)
    assert y.grad_fn is not None and calls == ["B"]
    y.sum().backward()
    assert calls == ["B", "C"]
    assert all(p.grad is not None and float(p.grad.abs().sum()) > 0 for p in (w_ih, w_hh, bias))
    with torch.no_grad():
        y = lstm_fused_forward(x, w_ih, w_hh, bias)
    assert y.grad_fn is None and calls == ["B", "C", "A"]
    # grad mode on but nothing requires grad: the inference kernel
    lstm_fused_forward(x, *(p.detach() for p in (w_ih, w_hh, bias)))
    assert calls == ["B", "C", "A", "A"]
    # only x requires grad (upstream layers train, the LSTM's weights do not)
    y = lstm_fused_forward(x.clone().requires_grad_(), *(p.detach() for p in (w_ih, w_hh, bias)))
    assert y.grad_fn is not None and calls[-1] == "B"
