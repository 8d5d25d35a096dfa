"""NSIM perceptual quality metric (ViSQOL-style), host-side numpy (the port's
own copy of awm_tpu/dsp/quality.py).

The reference reports wide-band PESQ where the ``pesq`` package is available
(ref: py/main14.py:1186-1195).  That C extension is optional
(dsp/stoi.py:pesq_score); this module provides the framework's own
PESQ-class *full-reference perceptual similarity* metric so quality reports
never silently lose their perceptual column.

The metric is the Neurogram Similarity Index Measure (NSIM, Hines & Harte,
Speech Communication 2012) — the similarity core of Google's ViSQOL — applied
to gammatone-weighted log-power spectrograms:

1. Both signals -> power STFT (32 ms Hann, 50% overlap at 16 kHz).
2. Integrate FFT bins through a 4th-order gammatone magnitude response
   filterbank, ERB-spaced over 21 bands from 50 Hz (ViSQOL speech mode
   banding), -> "neurogram" (frames, bands) in dB.
3. Jointly normalize by the reference's dynamic range, then compute
   NSIM = luminance * structure over 3x3 Gaussian-windowed patches
   (SSIM-heritage constants K1=0.01, K2=0.03) and average.

Scores are ~1.0 for transparent signals, decreasing toward 0 with
degradation.  Watermark/embed evaluation compares time-aligned signals, so
ViSQOL's patch re-alignment stage is unnecessary and deliberately omitted.
This is NOT ITU-T P.862 PESQ and is reported under its own "nsim" key.
"""

from __future__ import annotations

import numpy as np

N_FRAME = 512  # 32 ms at 16 kHz
HOP = 256
NUM_BANDS = 21  # ViSQOL speech-mode band count
MIN_FREQ = 50.0
FLOOR_DB = -80.0  # spectrogram floor relative to reference peak
K1, K2 = 0.01, 0.03  # SSIM-heritage stability constants


def erb(f: np.ndarray) -> np.ndarray:
    """Equivalent rectangular bandwidth (Glasberg & Moore 1990), Hz."""
    return 24.7 * (4.37e-3 * f + 1.0)


def erb_space(fmin: float, fmax: float, n: int) -> np.ndarray:
    """n center frequencies equally spaced on the ERB-rate scale."""

    def hz_to_erbrate(f):
        return 21.4 * np.log10(4.37e-3 * f + 1.0)

    def erbrate_to_hz(r):
        return (10.0 ** (r / 21.4) - 1.0) / 4.37e-3

    return erbrate_to_hz(np.linspace(hz_to_erbrate(fmin), hz_to_erbrate(fmax), n))


def gammatone_weights(fs: int, nfft: int, num_bands: int = NUM_BANDS,
                      fmin: float = MIN_FREQ, fmax: float | None = None) -> np.ndarray:
    """(bands, nfft//2+1) power-response matrix of a 4th-order gammatone
    filterbank: |H(f)|^2 = [1 + ((f-fc)/(b*ERB(fc)))^2]^-4 with b=1.019,
    each row normalized to unit sum so band energies are comparable."""
    if fmax is None:
        fmax = fs / 2.0
    f = np.linspace(0.0, fs / 2.0, nfft // 2 + 1)
    fc = erb_space(fmin, fmax * 0.9, num_bands)
    b = 1.019 * erb(fc)
    h2 = (1.0 + ((f[None, :] - fc[:, None]) / b[:, None]) ** 2) ** -4
    return h2 / h2.sum(axis=1, keepdims=True)


def _neurogram(x: np.ndarray, weights: np.ndarray) -> np.ndarray:
    hop, n = HOP, N_FRAME
    num = max((len(x) - n) // hop + 1, 0)
    if num == 0:
        return np.zeros((0, weights.shape[0]))
    idx = np.arange(num)[:, None] * hop + np.arange(n)[None, :]
    w = np.hanning(n + 2)[1:-1]
    spec = np.abs(np.fft.rfft(x[idx] * w, axis=1)) ** 2
    band = spec @ weights.T  # (frames, bands)
    return 10.0 * np.log10(band + 1e-20)


def _gauss3x3() -> np.ndarray:
    g = np.array([0.25, 0.5, 0.25])
    k = np.outer(g, g)
    return k / k.sum()


def _filt3x3(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """'valid' 3x3 correlation via stride tricks (img: frames x bands)."""
    from numpy.lib.stride_tricks import sliding_window_view

    win = sliding_window_view(img, (3, 3))
    return np.einsum("ijkl,kl->ij", win, k)


def nsim(ref: np.ndarray, deg: np.ndarray) -> float:
    """NSIM between two neurograms (frames, bands); ~1 means identical."""
    if ref.shape[0] < 3 or ref.shape[1] < 3:
        return float("nan")
    peak = ref.max()
    ref = np.maximum(ref, peak + FLOOR_DB)
    deg = np.maximum(deg, peak + FLOOR_DB)
    # map to [0, 1] by the reference dynamic range
    lo = peak + FLOOR_DB
    scale = max(ref.max() - lo, 1e-6)
    r = (ref - lo) / scale
    d = (deg - lo) / scale
    c1, c2 = K1**2, K2**2
    k = _gauss3x3()
    mu_r, mu_d = _filt3x3(r, k), _filt3x3(d, k)
    s_rr = _filt3x3(r * r, k) - mu_r**2
    s_dd = _filt3x3(d * d, k) - mu_d**2
    s_rd = _filt3x3(r * d, k) - mu_r * mu_d
    s_rr, s_dd = np.maximum(s_rr, 0.0), np.maximum(s_dd, 0.0)
    lum = (2 * mu_r * mu_d + c1) / (mu_r**2 + mu_d**2 + c1)
    struct = (s_rd + c2) / (np.sqrt(s_rr) * np.sqrt(s_dd) + c2)
    return float(np.mean(lum * struct))


def nsim_quality(clean: np.ndarray, degraded: np.ndarray, fs: int = 16000) -> float:
    """Full-reference perceptual similarity of time-aligned signals.

    Drop-in perceptual column for quality reports (the reference's PESQ slot,
    ref: py/main14.py:1186-1195): ~1.0 = transparent, lower = degraded.
    """
    n = min(len(clean), len(degraded))
    if n < N_FRAME + 2 * HOP:
        return float("nan")
    x = np.asarray(clean[:n], dtype=np.float64)
    y = np.asarray(degraded[:n], dtype=np.float64)
    if fs != 16000:
        from awm_tpu_torch.utils.audio_io import resample

        x = resample(x, fs, 16000).astype(np.float64)
        y = resample(y, fs, 16000).astype(np.float64)
    w = gammatone_weights(16000, N_FRAME)
    return nsim(_neurogram(x, w), _neurogram(y, w))
