"""Short-Time Objective Intelligibility (STOI), host-side numpy (the port's
own copy of awm_tpu/dsp/stoi.py).

The reference calls the ``pystoi`` package (ref: py/main14.py:1186-1195);
so that the metric needs no extra package it is implemented here from the
published algorithm (Taal et al., ICASSP 2010): 10 kHz resample, silent-frame
removal, 1/3-octave band analysis over 15 bands from 150 Hz, 384 ms (N=30
frame) segments, clipped normalized correlation, averaged.

PESQ (ITU-T P.862) is a multi-thousand-line licensed standard; it is
deliberately NOT reimplemented — ``pesq_score`` raises with guidance (the
reference's PESQ path produced no recorded values anywhere, BASELINE.md).
"""

from __future__ import annotations

import numpy as np

from awm_tpu_torch.utils.audio_io import resample

FS = 10000  # STOI internal rate
N_FRAME = 256
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
N_SEG = 30  # frames per segment (384 ms)
BETA = -15.0  # SDR clip (dB)
DYN_RANGE = 40.0  # silent-frame energy threshold (dB)


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    cf = 2.0 ** (k / 3.0) * min_freq
    flo = cf * 2 ** (-1.0 / 6.0)
    fhi = cf * 2 ** (1.0 / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo = np.argmin((f - flo[i]) ** 2)
        hi = np.argmin((f - fhi[i]) ** 2)
        obm[i, lo:hi] = 1.0
    return obm


def _frames(x: np.ndarray):
    hop = N_FRAME // 2
    n = (len(x) - N_FRAME) // hop + 1
    if n < 1:
        return np.zeros((0, N_FRAME))
    idx = np.arange(n)[:, None] * hop + np.arange(N_FRAME)[None, :]
    return x[idx]


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    w = np.hanning(N_FRAME + 2)[1:-1]
    xf = _frames(x) * w
    yf = _frames(y) * w
    energies = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    mask = energies > energies.max() - DYN_RANGE
    xf, yf = xf[mask], yf[mask]
    # overlap-add back
    hop = N_FRAME // 2
    n = len(xf)
    out_len = (n - 1) * hop + N_FRAME if n else 0
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    for i in range(n):
        xs[i * hop : i * hop + N_FRAME] += xf[i]
        ys[i * hop : i * hop + N_FRAME] += yf[i]
    return xs, ys


def stoi(clean: np.ndarray, degraded: np.ndarray, fs: int = 16000) -> float:
    """STOI in [~0, 1]; higher is more intelligible."""
    n = min(len(clean), len(degraded))
    x = np.asarray(clean[:n], dtype=np.float64)
    y = np.asarray(degraded[:n], dtype=np.float64)
    if fs != FS:
        x = resample(x, fs, FS).astype(np.float64)
        y = resample(y, fs, FS).astype(np.float64)
    x, y = _remove_silent_frames(x, y)
    if len(x) < N_FRAME * 2:
        return float("nan")

    w = np.hanning(N_FRAME + 2)[1:-1]
    xf = np.fft.rfft(_frames(x) * w, NFFT, axis=1)
    yf = np.fft.rfft(_frames(y) * w, NFFT, axis=1)
    obm = _thirdoct(FS, NFFT, NUM_BANDS, MIN_FREQ)
    # band envelopes: sqrt of band-summed power, (frames, bands)
    xb = np.sqrt((np.abs(xf) ** 2) @ obm.T)
    yb = np.sqrt((np.abs(yf) ** 2) @ obm.T)

    n_frames = xb.shape[0]
    if n_frames < N_SEG:
        return float("nan")
    c = 10.0 ** (-BETA / 20.0)
    scores = []
    for m in range(N_SEG, n_frames + 1):
        xs = xb[m - N_SEG : m]  # (N, bands)
        ys = yb[m - N_SEG : m]
        alpha = np.sqrt((xs**2).sum(axis=0) / ((ys**2).sum(axis=0) + 1e-12))
        ys_n = ys * alpha
        ys_c = np.minimum(ys_n, xs * (1 + c))
        xm = xs - xs.mean(axis=0)
        ym = ys_c - ys_c.mean(axis=0)
        num = (xm * ym).sum(axis=0)
        den = np.linalg.norm(xm, axis=0) * np.linalg.norm(ym, axis=0) + 1e-12
        scores.append(num / den)
    return float(np.mean(scores))


def pesq_score(clean: np.ndarray, degraded: np.ndarray, fs: int = 16000,
               mode: str = "wb"):
    """Wide-band PESQ (ITU-T P.862.2) via the optional ``pesq`` package,
    exactly as the reference calls it (ref: py/main14.py:1186-1195).

    Returns the MOS-LQO float when the package is importable, else None —
    ITU-T P.862 is a multi-thousand-line licensed standard, deliberately not
    reimplemented.  When PESQ is unavailable, ``stoi`` (above) and SI-SNR
    are the documented perceptual/fidelity fallbacks; eval reports omit the
    "pesq" key rather than fabricating a stand-in."""
    try:
        import pesq as _pesq
    except ImportError:
        return None
    n = min(len(clean), len(degraded))
    return float(_pesq.pesq(fs, np.asarray(clean[:n], dtype=np.float32),
                            np.asarray(degraded[:n], dtype=np.float32), mode))
