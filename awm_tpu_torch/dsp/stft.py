"""Spectral ops: framing, STFT, mel filterbank, log-mel (counterpart of
awm_tpu/dsp/stft.py:27-137).

Conventions, as the JAX package matches them to torch/torchaudio:
- periodic Hann window (torch.hann_window's default);
- center=True with reflect padding of n_fft // 2 (torch.stft's default);
- onesided rfft, no normalisation, (..., frames, freqs) layout;
- mel: HTK scale, no filterbank norm, f_min 0, f_max sr/2, power 2
  (torchaudio MelSpectrogram's defaults), the filterbank built in float64 on
  the host.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window, identical to torch.hann_window(n)."""
    k = torch.arange(n, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis by `pad` on each side, as numpy's (and
    jnp.pad's) mode="reflect" does, also where pad >= T: the reflection
    repeats with period 2 (T - 1).  torch's own reflect pad refuses that
    case, which a short clip under a 2048-point STFT hits."""
    t = x.shape[-1]
    if pad < t:
        lead = x.shape[:-1]
        return F.pad(x.reshape(-1, 1, t), (pad, pad), mode="reflect").reshape(*lead, t + 2 * pad)
    period = 2 * (t - 1)
    q = torch.remainder(torch.arange(-pad, t + pad, device=x.device), period)
    return x[..., torch.where(q >= t, period - q, q)]


def frame(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Slice (..., T) into overlapping frames -> (..., n_frames, frame_length),
    n_frames = 1 + (T - frame_length) // hop: a strided view of x (no copy)."""
    return x.unfold(-1, frame_length, hop)


def stft(x: torch.Tensor, n_fft: int, hop: int, *, center: bool = True) -> torch.Tensor:
    """Complex STFT of (..., T) -> (..., n_frames, n_fft // 2 + 1)."""
    if center:
        x = reflect_pad(x, n_fft // 2)
    frames = frame(x, n_fft, hop) * hann_window(n_fft, x.dtype, x.device)
    return torch.fft.rfft(frames, dim=-1)


def spectrogram(x: torch.Tensor, n_fft: int, hop: int, power: float = 2.0) -> torch.Tensor:
    """|STFT|^power of (..., T) -> (..., n_frames, n_freqs), fp32."""
    s = stft(x.to(torch.float32), n_fft, hop)
    mag2 = s.real * s.real + s.imag * s.imag
    if power == 2.0:
        return mag2
    if power == 1.0:
        return torch.sqrt(mag2)
    return torch.pow(mag2, power / 2.0)


def hz_to_mel(f):
    """HTK mel scale (torchaudio melscale_fbanks mel_scale='htk')."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0, f_max: float | None = None
) -> np.ndarray:
    """Triangular HTK mel filterbank, shape (n_freqs, n_mels), norm=None,
    computed in float64 and returned as float32."""
    if f_max is None:
        f_max = sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / (f_pts[1:-1] - f_pts[:-2])
    up = slopes[:, 2:] / (f_pts[2:] - f_pts[1:-1])
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def mel_spectrogram(
    x: torch.Tensor,
    *,
    sample_rate: int = 16000,
    n_fft: int = 1024,
    hop: int = 256,
    n_mels: int = 64,
    power: float = 2.0,
) -> torch.Tensor:
    """(..., T) -> (..., n_frames, n_mels) power mel spectrogram."""
    spec = spectrogram(x, n_fft, hop, power=power)
    fb = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate)).to(spec.device)
    return torch.matmul(spec, fb)


def log_mel(x: torch.Tensor, eps: float = 1e-5, **kw) -> torch.Tensor:
    """log(mel + eps), as MultiScaleMelLoss uses it."""
    return torch.log(mel_spectrogram(x, **kw) + eps)
