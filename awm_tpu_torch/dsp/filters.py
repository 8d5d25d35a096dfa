"""Time-domain filters: windowed-sinc FIR lowpass and biquad IIR lowpass
(counterpart of awm_tpu/dsp/filters.py).

- ``fir_lowpass``: the 101-tap Hamming-windowed sinc applied to the
  watermark delta (ref: py/main16.py:53-64).
- ``lowpass_biquad``: torchaudio.functional.lowpass_biquad's filter.  A
  well-damped biquad's impulse response dies out within a few dozen taps, so
  it runs as a short causal FIR conv1d; poorly damped poles fall back to the
  state-space recurrence evaluated by a log-depth doubling scan.  Both are
  differentiable, so they can sit inside the robust train step.

Every convolution here runs in true fp32 (TF32 off), forward and backward
(utils.precision.conv1d_fp32), as the JAX versions pin Precision.HIGHEST.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from awm_tpu_torch.utils.precision import conv1d_fp32


def sinc_lowpass_kernel(cutoff_hz: float, taps: int, sample_rate: int) -> np.ndarray:
    """Hamming-windowed sinc FIR kernel, unit DC gain, shape (taps,).

    fc = cutoff / sr in cycles/sample (the filter main16 intended; the JAX
    docstring records why this departs from py/main16.py:58).
    """
    fc = cutoff_hz / sample_rate
    n = np.arange(taps, dtype=np.float64) - (taps - 1) / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        sinc = np.where(n == 0, 2.0 * fc, np.sin(2.0 * math.pi * fc * n) / (math.pi * n))
    window = 0.54 - 0.46 * np.cos(2.0 * math.pi * (n + (taps - 1) / 2.0) / (taps - 1))
    kernel = sinc * window
    return (kernel / kernel.sum()).astype(np.float32)


def fir_lowpass(
    x: torch.Tensor,
    cutoff_hz: float = 4000.0,
    taps: int = 101,
    sample_rate: int = 16000,
) -> torch.Tensor:
    """Zero-phase-delay FIR lowpass of (..., T), same output length, in true
    fp32 whatever x's dtype (the JAX version pins Precision.HIGHEST); the
    result is cast back to x's dtype."""
    kernel = torch.from_numpy(sinc_lowpass_kernel(cutoff_hz, taps, sample_rate))
    lead, t = x.shape[:-1], x.shape[-1]
    half = (taps - 1) // 2
    xf = F.pad(x.reshape(-1, 1, t).to(torch.float32), (half, half))
    out = conv1d_fp32(xf, kernel.to(x.device).view(1, 1, taps))
    return out.reshape(*lead, t).to(x.dtype)


def lowpass_biquad_coeffs(cutoff_hz: float, sample_rate: int, q: float = 0.707) -> tuple:
    """Normalised (b0, b1, b2, a1, a2) of a 2nd-order lowpass, the audio EQ
    cookbook's formula as torchaudio.functional.lowpass_biquad has it:
    w0 = 2 pi fc / sr, alpha = sin(w0) / (2 Q)."""
    w0 = 2.0 * math.pi * cutoff_hz / sample_rate
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    b0 = (1.0 - cw) / 2.0
    b1 = 1.0 - cw
    b2 = (1.0 - cw) / 2.0
    a0 = 1.0 + alpha
    a1 = -2.0 * cw
    a2 = 1.0 - alpha
    return (b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0)


def _biquad_associative(x: torch.Tensor, coeffs) -> torch.Tensor:
    """One biquad along the last axis as a log-depth scan.

    Direct form II transposed,
        y[n]  = b0 x[n] + s1[n-1]
        s1[n] = b1 x[n] - a1 y[n] + s2[n-1]
        s2[n] = b2 x[n] - a2 y[n],
    is the linear recurrence s[n] = A s[n-1] + B x[n] with
        A = [[-a1, 1], [-a2, 0]],  B = [[b1 - a1 b0], [b2 - a2 b0]],
    whose steps compose associatively: (A2, v2) o (A1, v1) = (A2 A1, A2 v1 +
    v2).  Each element (A, B x[n]) is carried as six sequences (the matrix's
    four, shared by the batch, and the vector's two) and combined with the
    element 1, 2, 4, ... steps before it: ceil(log2 T) rounds of elementwise
    fp32 math, 14 at T = 16000.  (jax.lax.associative_scan, which the JAX
    package uses, wants a power-of-two length; this scan does not.)"""
    b0, b1, b2, a1, a2 = coeffs
    lead, t = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, t).to(torch.float32)
    ones = torch.ones(1, t, dtype=torch.float32, device=x.device)
    seqs = [ones * -a1, ones.clone(), ones * -a2, ones * 0.0,
            xf * (b1 - a1 * b0), xf * (b2 - a2 * b0)]
    d = 1
    while d < t:
        l00, l01, l10, l11, lv0, lv1 = (s[:, :-d] for s in seqs)
        r00, r01, r10, r11, rv0, rv1 = (s[:, d:] for s in seqs)
        # A = A_r A_l ; v = A_r v_l + v_r
        new = (r00 * l00 + r01 * l10, r00 * l01 + r01 * l11,
               r10 * l00 + r11 * l10, r10 * l01 + r11 * l11,
               r00 * lv0 + r01 * lv1 + rv0, r10 * lv0 + r11 * lv1 + rv1)
        seqs = [torch.cat([s[:, :d], n], dim=1) for s, n in zip(seqs, new)]
        d *= 2
    s1 = seqs[4]  # state component 1 after step n; y[n] = b0 x[n] + s1[n-1]
    y = b0 * xf + F.pad(s1[:, :-1], (1, 0))
    return y.reshape(*lead, t).to(x.dtype)


def _biquad_impulse_response(coeffs, tol: float = 1e-7, max_len: int = 8192) -> np.ndarray:
    """Truncated impulse response of the biquad, on the host in float64.  A
    stable 2nd-order IIR decays geometrically with its pole magnitude; once
    |h| < tol the remaining taps are below fp32 resolution (~40 taps for the
    7 kHz lowpass at 16 kHz, whose poles sit at |p| ~ 0.45)."""
    b0, b1, b2, a1, a2 = coeffs
    h = np.zeros(max_len, dtype=np.float64)
    x1 = x2 = y1 = y2 = 0.0
    for n in range(max_len):
        xn = 1.0 if n == 0 else 0.0
        yn = b0 * xn + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
        h[n] = yn
        x2, x1 = x1, xn
        y2, y1 = y1, yn
        if n > 2 and abs(yn) < tol and abs(y1) < tol and abs(y2) < tol:
            h = h[: n + 1]
            break
    return h.astype(np.float32)


@lru_cache(maxsize=64)
def _biquad_fir_kernel(coeffs: tuple, device: torch.device) -> Optional[torch.Tensor]:
    """The reversed impulse response as a (1, 1, taps) conv weight on
    `device`, or None where it does not die out within 8192 taps.  Made once
    per coefficient set and device: the host loop above is not paid per call."""
    h = _biquad_impulse_response(coeffs)
    if len(h) >= 8192:
        return None
    return torch.from_numpy(h[::-1].copy()).to(device).view(1, 1, -1)


def biquad(x: torch.Tensor, coeffs) -> torch.Tensor:
    """One biquad along the last axis: a causal FIR conv1d over the truncated
    impulse response where that is short (every filter the reference uses),
    else the doubling scan."""
    coeffs = tuple(float(c) for c in coeffs)
    kernel = _biquad_fir_kernel(coeffs, x.device)
    if kernel is None:
        return _biquad_associative(x, coeffs)
    taps = kernel.shape[-1]
    lead, t = x.shape[:-1], x.shape[-1]
    xf = F.pad(x.reshape(-1, 1, t).to(torch.float32), (taps - 1, 0))  # causal
    out = conv1d_fp32(xf, kernel)
    return out.reshape(*lead, t).to(x.dtype)


def lowpass_biquad(x: torch.Tensor, sample_rate: int = 16000, cutoff_freq: float = 7000.0,
                   q: float = 0.707) -> torch.Tensor:
    """torchaudio.functional.lowpass_biquad over the last axis."""
    return biquad(x, lowpass_biquad_coeffs(cutoff_freq, sample_rate, q))
