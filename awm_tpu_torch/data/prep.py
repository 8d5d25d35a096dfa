"""Dataset acquisition & curation tools (the reference's dataset_creation/;
the port's own copy of awm_tpu/data/prep.py, numpy/scipy on the host).

Functional, librosa-free re-implementations of the 12 prep scripts
(SURVEY.md section 2.3), each citing its source:

- build_metadata           <- dataset_creation/subset.py:5-38
- select_audios            <- dataset_creation/select_audios.py:8-87
- segment_to_clips         <- dataset_creation/1_sec_files.py:10-83 (flat),
                              100_sub.py (per-source subdirs), pre_100.py (serial)
- analyze_audio / classify_speech_noise / classify_folder
                           <- dataset_creation/noise_mul.py:21-307 (and noise.py)
- copy_speech_only         <- dataset_creation/speech_only.py:1-22
- find_silent              <- dataset_creation/silent.py:7-61
- compare_metadata         <- dataset_creation/same.py:1-18

A CLI over these lives in awm_tpu_torch/__main__.py (`python -m awm_tpu_torch
prep ...`).  Nothing here touches a device: the features are the JAX
package's, computed the same way, so both packages label a corpus alike.
The VoxPopuli download itself (dataset_creation/dataset.py uses HuggingFace
datasets) is out of scope for a zero-egress environment; any directory of
audio files works as input.
"""

from __future__ import annotations

import concurrent.futures as cf
import csv
import glob
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.signal import butter, lfilter
from scipy.stats import kurtosis as _kurtosis

from awm_tpu_torch.utils.audio_io import load_audio, resample, save_wav, to_mono

AUDIO_EXTS = (".wav", ".ogg", ".flac", ".mp3")


# ---------------------------------------------------------------------------
# metadata


def build_metadata(
    audio_dir: str, output_csv: str, exts: Sequence[str] = AUDIO_EXTS
) -> int:
    """Walk audio_dir, write (filepath, duration) CSV
    (ref: dataset_creation/subset.py:5-38)."""
    rows = []
    for ext in exts:
        for p in sorted(glob.glob(os.path.join(audio_dir, "**", f"*{ext}"), recursive=True)):
            try:
                wav, sr = load_audio(p)
                rows.append((p, wav.shape[-1] / sr))
            except Exception:
                continue
    os.makedirs(os.path.dirname(output_csv) or ".", exist_ok=True)
    with open(output_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filepath", "duration"])
        w.writerows(rows)
    return len(rows)


def read_metadata(csv_path: str) -> List[Tuple[str, float]]:
    with open(csv_path) as f:
        r = csv.DictReader(f)
        return [(row["filepath"], float(row["duration"])) for row in r]


def select_audios(
    metadata_csv: str,
    output_csv: str,
    *,
    hours: Optional[float] = None,
    seconds: Optional[float] = None,
    seed: Optional[int] = None,
) -> Tuple[int, float]:
    """Shuffle metadata, greedily take files until the duration target
    (ref: dataset_creation/select_audios.py:8-87 — which uses a random seed
    1-1000 when none is given; pass seed for reproducibility)."""
    if (hours is None) == (seconds is None):
        raise ValueError("pass exactly one of hours / seconds")
    target = float(seconds) if seconds is not None else float(hours) * 3600.0
    rows = read_metadata(metadata_csv)
    rng = np.random.default_rng(seed if seed is not None else np.random.randint(1, 1001))
    order = rng.permutation(len(rows))
    picked, total = [], 0.0
    for i in order:
        if total >= target:
            break
        picked.append(rows[i])
        total += rows[i][1]
    os.makedirs(os.path.dirname(output_csv) or ".", exist_ok=True)
    with open(output_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filepath", "duration"])
        w.writerows(picked)
    return len(picked), total


def compare_metadata(csv_a: str, csv_b: str) -> Dict[str, int]:
    """Set-intersection check between two metadata CSVs
    (ref: dataset_creation/same.py:1-18)."""
    a = {p for p, _ in read_metadata(csv_a)}
    b = {p for p, _ in read_metadata(csv_b)}
    return {
        "a_total": len(a),
        "b_total": len(b),
        "overlap": len(a & b),
        "a_only": len(a - b),
        "b_only": len(b - a),
    }


# ---------------------------------------------------------------------------
# segmentation


def _segment_one(
    path: str,
    out_dir: str,
    *,
    sample_rate: int,
    seg_seconds: float,
    per_file_subdirs: bool,
    peak_norm: float = 0.99,
) -> int:
    try:
        wav, sr = load_audio(path)
    except Exception:
        return 0
    x = to_mono(wav)
    x = resample(x, sr, sample_rate)
    peak = np.abs(x).max()
    if peak > 0:
        x = x * (peak_norm / peak)  # peak-normalize (ref: 1_sec_files.py)
    seg_len = int(seg_seconds * sample_rate)
    n = len(x) // seg_len
    stem = os.path.splitext(os.path.basename(path))[0]
    dest = os.path.join(out_dir, stem) if per_file_subdirs else out_dir
    os.makedirs(dest, exist_ok=True)
    for i in range(n):
        save_wav(
            os.path.join(dest, f"{stem}_seg{i}.wav"),
            x[i * seg_len : (i + 1) * seg_len],
            sample_rate,
        )
    return n


def segment_to_clips(
    files: Sequence[str],
    out_dir: str,
    *,
    sample_rate: int = 16000,
    seg_seconds: float = 1.0,
    per_file_subdirs: bool = False,
    workers: int = 8,
) -> int:
    """Parallel split into non-overlapping fixed-length clips
    (ref: dataset_creation/1_sec_files.py:10-83; per_file_subdirs=True is
    100_sub.py; workers=1 is the serial pre_100.py)."""
    os.makedirs(out_dir, exist_ok=True)
    total = 0
    if workers <= 1:
        for p in files:
            total += _segment_one(
                p, out_dir, sample_rate=sample_rate, seg_seconds=seg_seconds,
                per_file_subdirs=per_file_subdirs,
            )
        return total
    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        futs = [
            pool.submit(
                _segment_one, p, out_dir, sample_rate=sample_rate,
                seg_seconds=seg_seconds, per_file_subdirs=per_file_subdirs,
            )
            for p in files
        ]
        for f in futs:
            total += f.result()
    return total


# ---------------------------------------------------------------------------
# speech/noise heuristic classifier


def _stft_mag(y: np.ndarray, n_fft: int = 2048, hop: int = 512) -> np.ndarray:
    """Centered Hann-window STFT magnitude, librosa-compatible framing
    (reflect-padded, frames = 1 + len//hop).  Returns (n_fft//2+1, frames)."""
    pad = n_fft // 2
    if len(y) < 2:
        y = np.pad(y, (0, 2 - len(y)))
    yp = np.pad(y, pad, mode="reflect" if len(y) > pad else "constant")
    n_frames = 1 + (len(yp) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    # periodic Hann (librosa/scipy sym=False)
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    return np.abs(np.fft.rfft(yp[idx] * win, axis=1)).T


def _hz_to_mel(f):
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3)
    log_region = f >= 1000.0
    mel = np.where(
        log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0), mel
    )
    return mel


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * (200.0 / 3)
    log_region = m >= 15.0
    return np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)


def _mel_filterbank(sr: int, n_fft: int, n_mels: int = 128) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, (n_mels, n_fft//2+1)."""
    fft_freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fb = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lo, ce, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (fft_freqs - lo) / max(ce - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ce, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        fb[i] *= 2.0 / (hi - lo)  # slaney area norm
    return fb


def _dct_ortho(x: np.ndarray, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II over axis 0 (scipy.fft.dct type=2 norm='ortho'),
    first n_out coefficients.  x: (n_in, frames)."""
    n_in = x.shape[0]
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_in))
    scale = np.full((n_out, 1), np.sqrt(2.0 / n_in))
    scale[0, 0] = np.sqrt(1.0 / n_in)
    return (basis * scale) @ x


def full_spectral_features(y: np.ndarray, sr: int, n_mfcc: int = 13) -> Dict:
    """librosa-equivalent framewise features of the FULL noise.py analyzer
    (ref: dataset_creation/noise.py:49-68): spectral centroid/bandwidth/
    rolloff means and 13-coefficient MFCC mean/var — all librosa-free
    (STFT/mel/DCT implemented above, validated against scipy in
    tests/test_prep_cli.py)."""
    s = _stft_mag(y)  # (freqs, frames)
    freqs = np.fft.rfftfreq(2048, 1.0 / sr)[:, None]
    total = s.sum(axis=0) + 1e-10
    centroid = (freqs * s).sum(axis=0) / total
    bandwidth = np.sqrt(((np.abs(freqs - centroid) ** 2) * s).sum(axis=0) / total)
    cum = np.cumsum(s, axis=0)
    rolloff_idx = np.argmax(cum >= 0.85 * cum[-1:], axis=0)
    rolloff = freqs[rolloff_idx, 0]

    mel = _mel_filterbank(sr, 2048) @ (s**2)  # power melspectrogram
    db = 10.0 * np.log10(np.maximum(mel, 1e-10))
    db = np.maximum(db, db.max() - 80.0)  # top_db=80
    mfcc = _dct_ortho(db, n_mfcc)  # (n_mfcc, frames)
    return {
        "spectral_centroid": float(centroid.mean()),
        "spectral_bandwidth": float(bandwidth.mean()),
        "rolloff": float(rolloff.mean()),
        "mfcc_mean": float(mfcc.mean(axis=1).mean()),
        "mfcc_var": float(mfcc.var(axis=1).mean()),
    }


def analyze_audio(path_or_array, sr: int = 16000, *, full: bool = False) -> Dict:
    """Feature extraction for the speech/noise heuristic
    (ref: dataset_creation/noise_mul.py:21-99): total energy, 300-3000 Hz
    Butterworth band energy, zero-crossing rate, FFT spectral centroid,
    kurtosis, 10ms-frame energy std, speech-to-noise ratio.

    full=True reproduces the FULL noise.py analyzer
    (ref: dataset_creation/noise.py:10-90): order-5 Butterworth band filter,
    framewise (librosa-equivalent) spectral centroid, plus spectral
    bandwidth, rolloff, and 13-coefficient MFCC mean/var."""
    try:
        if isinstance(path_or_array, str):
            wav, fsr = load_audio(path_or_array)
            y = resample(to_mono(wav), fsr, sr)
            results: Dict = {"file_path": path_or_array}
        else:
            y = np.asarray(path_or_array, dtype=np.float32)
            results = {"file_path": None}
        results["duration"] = len(y) / sr

        energy = float(np.mean(y**2))
        results["energy"] = energy

        nyq = 0.5 * sr
        # noise.py uses order 5 (ref: dataset_creation/noise.py:28); the
        # reduced noise_mul heuristic used a shallower band filter
        b, a = butter(5 if full else 3, [300 / nyq, 3000 / nyq], btype="band")
        y_speech = lfilter(b, a, y)
        speech_energy = float(np.mean(y_speech**2))
        results["speech_band_energy"] = speech_energy

        results["zero_crossing_rate"] = float(
            np.mean(np.abs(np.diff(np.signbit(y).astype(int))))
        )

        if full:
            results.update(full_spectral_features(y, sr))
        else:
            fft = np.abs(np.fft.rfft(y))
            freqs = np.fft.rfftfreq(len(y), 1 / sr)
            results["spectral_centroid"] = float(
                np.sum(freqs * fft) / (np.sum(fft) + 1e-8)
            )

        results["kurtosis"] = float(_kurtosis(y))

        hop, frame = sr // 100, sr // 40  # 10 ms hop, 25 ms frames
        if len(y) >= frame:
            n_frames = (len(y) - frame) // hop + 1
            idx = np.arange(n_frames)[:, None] * hop + np.arange(frame)[None, :]
            frame_energies = np.mean(y[idx] ** 2, axis=1)
            results["energy_std"] = float(np.std(frame_energies))
        else:
            results["energy_std"] = 0.0

        results["speech_to_noise_ratio"] = speech_energy / (energy + 1e-10)
        return results
    except Exception as e:  # error class (ref: noise_mul.py:94-104)
        return {"file_path": path_or_array if isinstance(path_or_array, str) else None,
                "error": str(e)}


def classify_speech_noise(features: Dict) -> str:
    """Additive scoring, threshold >= 4, SNR feature double-weighted
    (ref: dataset_creation/noise_mul.py:101-137)."""
    if "error" in features:
        return "error"
    score = 0
    if features["speech_band_energy"] > 0.001:
        score += 1
    if features["zero_crossing_rate"] < 0.1:
        score += 1
    if features["spectral_centroid"] < 3000:
        score += 1
    if features["kurtosis"] > 5:
        score += 1
    if features["energy_std"] > 0.01:
        score += 1
    if features["speech_to_noise_ratio"] > 0.6:
        score += 2
    return "speech" if score >= 4 else "noise"


def classify_folder(
    audio_dir: str,
    output_dir: str,
    *,
    workers: int = 8,
    max_files: Optional[int] = None,
    exts: Sequence[str] = (".wav",),
    full: bool = False,
) -> Dict[str, int]:
    """Classify every file; writes audio_classification_results.csv,
    speech_files.txt, noise_files.txt (ref: noise_mul.py:139-307).

    full=True records the FULL noise.py feature set per file (spectral
    bandwidth/rolloff, MFCC stats — ref: dataset_creation/noise.py:49-90);
    the classification score uses the same 6 features either way, exactly
    as the reference's two scripts share one scoring rule."""
    import functools

    files: List[str] = []
    for ext in exts:
        files.extend(sorted(glob.glob(os.path.join(audio_dir, "**", f"*{ext}"), recursive=True)))
    if max_files:
        files = files[:max_files]
    os.makedirs(output_dir, exist_ok=True)

    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        feats = list(pool.map(functools.partial(analyze_audio, full=full), files))
    labels = [classify_speech_noise(f) for f in feats]

    with open(os.path.join(output_dir, "audio_classification_results.csv"), "w", newline="") as f:
        keys = ["file_path", "duration", "energy", "speech_band_energy",
                "zero_crossing_rate", "spectral_centroid", "kurtosis",
                "energy_std", "speech_to_noise_ratio"]
        if full:
            keys += ["spectral_bandwidth", "rolloff", "mfcc_mean", "mfcc_var"]
        w = csv.writer(f)
        w.writerow(keys + ["classification"])
        for feat, lab in zip(feats, labels):
            w.writerow([feat.get(k, "") for k in keys] + [lab])
    for name, target in (("speech_files.txt", "speech"), ("noise_files.txt", "noise")):
        with open(os.path.join(output_dir, name), "w") as f:
            for feat, lab in zip(feats, labels):
                if lab == target:
                    f.write(feat["file_path"] + "\n")
    return {
        "speech": labels.count("speech"),
        "noise": labels.count("noise"),
        "error": labels.count("error"),
    }


def sample_feature_stats(
    audio_dir: str,
    n: int = 100,
    *,
    seed: int = 0,
    full: bool = False,
    exts: Sequence[str] = (".wav",),
) -> Dict[str, Dict[str, float]]:
    """Parameter-tuning mode: analyze n random files and return per-feature
    statistics (count/mean/std/min/max) plus the classification tally — the
    reference's ``--sample N`` describe() dump for manual threshold
    inspection (ref: dataset_creation/noise.py:245-270,
    noise_mul.py:262-286)."""
    import random

    files: List[str] = []
    for ext in exts:
        files.extend(sorted(glob.glob(os.path.join(audio_dir, "**", f"*{ext}"), recursive=True)))
    random.Random(seed).shuffle(files)
    files = files[:n]
    feats = [analyze_audio(p, full=full) for p in files]
    labels = [classify_speech_noise(f) for f in feats]

    stats: Dict[str, Dict[str, float]] = {}
    numeric = [f for f in feats if "error" not in f]
    if numeric:
        for k, v in numeric[0].items():
            if not isinstance(v, (int, float)):
                continue
            vals = np.asarray([f[k] for f in numeric if k in f], dtype=np.float64)
            stats[k] = {
                "count": int(vals.size),
                "mean": float(vals.mean()),
                "std": float(vals.std()),
                "min": float(vals.min()),
                "max": float(vals.max()),
            }
    stats["_classification"] = {
        "speech": labels.count("speech"),
        "noise": labels.count("noise"),
        "error": labels.count("error"),
    }
    return stats


def copy_speech_only(speech_list_file: str, out_dir: str) -> int:
    """Copy files listed in speech_files.txt to a clean directory
    (ref: dataset_creation/speech_only.py:1-22)."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    with open(speech_list_file) as f:
        for line in f:
            src = line.strip()
            if src and os.path.exists(src):
                shutil.copy2(src, os.path.join(out_dir, os.path.basename(src)))
                n += 1
    return n


def find_silent(
    audio_dir: str, rms_threshold: float = 1e-4, exts: Sequence[str] = (".wav",)
) -> List[str]:
    """RMS silence census (ref: dataset_creation/silent.py:7-61)."""
    silent = []
    for ext in exts:
        for p in sorted(glob.glob(os.path.join(audio_dir, "**", f"*{ext}"), recursive=True)):
            try:
                wav, _ = load_audio(p)
                if float(np.sqrt(np.mean(wav**2))) < rms_threshold:
                    silent.append(p)
            except Exception:
                continue
    return silent
