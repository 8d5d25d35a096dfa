"""Rational polyphase resampling (counterpart of awm_tpu/dsp/resample.py:37-123).

The polyphase decomposition is packed into one multi-channel strided
convolution, as in the JAX package:

    y[n*up + r] = sum_q  W[r, q] * x[n*down + q_min + q]

W[r, :] is phase r of the prototype lowpass at its own offset: one conv1d
with ``up`` output channels and stride ``down``, static shapes, differentiable,
so it can sit inside the robust train step (awm_tpu_torch.augment).  The
prototype is scipy.signal.resample_poly's default
(firwin(2*10*max(up, down)+1, 1/max(up, down), window=('kaiser', 5.0)) * up).
The conv runs in true fp32 (TF32 off), forward and backward, whatever the
caller's precision: the JAX version pins Precision.HIGHEST.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from awm_tpu_torch.utils.precision import conv1d_fp32


def _firwin_kaiser(numtaps: int, cutoff: float, beta: float = 5.0) -> np.ndarray:
    """scipy.signal.firwin(numtaps, cutoff, window=('kaiser', beta)): a
    windowed-sinc lowpass with unit DC gain; cutoff in Nyquist units."""
    m = np.arange(numtaps, dtype=np.float64) - (numtaps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * m)  # np.sinc is sin(pi x)/(pi x)
    h *= np.kaiser(numtaps, beta)
    return h / h.sum()


@lru_cache(maxsize=64)
def _polyphase_weights(up: int, down: int, taps_per_phase: int = 10, beta: float = 5.0):
    """(W, q_min, up, down) on the host, up/down reduced by their gcd, W of
    shape (up, width) float32 with y[n*up + r] = sum_q W[r, q] * x[n*down +
    q_min + q] (x zero outside).  With the prototype h of half-length H =
    taps_per_phase * max(up, down), y[j] = sum_m h[m*up - j*down + H] x[m];
    j = n*up + r and m = n*down + q give the tap index up*q - r*down + H."""
    if up < 1 or down < 1:
        raise ValueError("up/down must be positive integers")
    g = math.gcd(up, down)
    up, down = up // g, down // g
    max_rate = max(up, down)
    half = taps_per_phase * max_rate
    h = _firwin_kaiser(2 * half + 1, 1.0 / max_rate, beta) * up
    n_taps = len(h)
    q_min = -(half // up)  # r = 0, lower edge
    q_max = ((up - 1) * down + half) // up  # r = up - 1, upper edge
    W = np.zeros((up, q_max - q_min + 1), dtype=np.float32)
    q = np.arange(q_min, q_max + 1)
    for r in range(up):
        idx = up * q - r * down + half
        ok = (idx >= 0) & (idx < n_taps)
        W[r, ok] = h[idx[ok]]
    return W, q_min, up, down


@lru_cache(maxsize=64)
def _weight_tensor(up: int, down: int, taps_per_phase: int, beta: float, device: torch.device):
    """The (up, 1, width) conv weight on `device`, made once per ratio and
    device so a train step copies nothing from the host."""
    W = _polyphase_weights(up, down, taps_per_phase, beta)[0]
    return torch.from_numpy(W).to(device).unsqueeze(1)


def resample_poly(x: torch.Tensor, up: int, down: int, *, taps_per_phase: int = 10,
                  beta: float = 5.0) -> torch.Tensor:
    """Rational resample of (..., T) by up/down, scipy.resample_poly parity:
    output length ceil(T*up/down), zero-padded edges, centred prototype."""
    W, q_min, up, down = _polyphase_weights(up, down, taps_per_phase, beta)
    if up == 1 and down == 1:
        return x
    lead, t = x.shape[:-1], x.shape[-1]
    out_len = -(-t * up // down)
    n_blocks = -(-out_len // up)  # conv output positions needed
    width = W.shape[1]
    # x index touched: n*down + q_min + dq, n in [0, n_blocks), dq in [0, width)
    pad_l = max(0, -q_min)
    pad_r = max(0, (n_blocks - 1) * down + q_min + width - 1 - (t - 1))
    xf = F.pad(x.reshape(-1, 1, t).to(torch.float32), (pad_l, pad_r))
    out = conv1d_fp32(xf, _weight_tensor(up, down, taps_per_phase, beta, x.device), stride=down)
    y = out[:, :, :n_blocks].transpose(1, 2).reshape(xf.shape[0], n_blocks * up)
    return y[:, :out_len].reshape(*lead, out_len).to(x.dtype)


def resample_rational(x: torch.Tensor, orig_hz: int, target_hz: int, **kw) -> torch.Tensor:
    """Resample (..., T) audio from orig_hz to target_hz (any integer rates)."""
    g = math.gcd(int(orig_hz), int(target_hz))
    return resample_poly(x, int(target_hz) // g, int(orig_hz) // g, **kw)
