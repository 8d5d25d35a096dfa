"""Host-side audio file I/O: load, mono-mix, resample, save (the port's own
copy of awm_tpu/utils/audio_io.py, numpy/scipy only).

Replacement for the torchaudio load/save paths the reference uses
at every API edge (ref: py/main14.py:601-607 load_audio, py/main14.py:793-797
save, py/main15.py:850-867 quality save path).  Backed by numpy + the stdlib
``wave`` module for 16/24/32-bit PCM and float WAVs; optionally by
``soundfile`` when present for mp3/flac/ogg parity with the reference's
multi-format globs (ref: py/main14.py:1055-1058).  Resampling uses a
polyphase filter (scipy.signal.resample_poly), the standard equivalent of
torchaudio.transforms.Resample.
"""

from __future__ import annotations

import os
import struct
import wave
from typing import Tuple

import numpy as np

try:  # optional; not in the baked image but supported if available
    import soundfile as _sf
except ImportError:  # pragma: no cover
    _sf = None

from scipy.signal import resample_poly
from math import gcd

_WAV_EXTS = {".wav", ".wave"}


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    """Load an audio file -> (waveform (channels, T) float32 in [-1, 1], sr)."""
    ext = os.path.splitext(path)[1].lower()
    if _sf is not None and ext not in _WAV_EXTS:
        data, sr = _sf.read(path, dtype="float32", always_2d=True)
        return data.T.copy(), sr
    if ext not in _WAV_EXTS:
        raise ValueError(
            f"cannot decode {ext!r} without the optional 'soundfile' package; "
            "convert to WAV or install soundfile"
        )
    return _read_wav(path)


def _read_wav(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        return _parse_wav(f, path)


def decode_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Parse WAV bytes in memory -> ((channels, T) float32, sr): the serving
    path's decode (request bodies never touch the filesystem)."""
    import io

    return _parse_wav(io.BytesIO(data), "<bytes>")


def encode_wav_bytes(waveform: np.ndarray, sample_rate: int) -> bytes:
    """Encode (channels, T) or (T,) float waveform as 16-bit PCM WAV bytes
    in memory (same encoding as save_wav)."""
    import io

    x = np.asarray(waveform, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    pcm = np.round(np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.T.tobytes())
    return buf.getvalue()


def _parse_wav(f, path: str) -> Tuple[np.ndarray, int]:
    """Parse RIFF/WAVE from any binary file-like object (file or BytesIO)."""
    riff = f.read(12)
    if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    fmt = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            raise ValueError(f"{path}: no data chunk")
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"fmt ":
            fmt = f.read(size)
            if size % 2:
                f.read(1)
        elif cid == b"data":
            raw = f.read(size)
            break
        else:
            f.seek(size + (size % 2), os.SEEK_CUR)
    if fmt is None:
        raise ValueError(f"{path}: missing fmt chunk")
    (audio_format, channels, sr, _, _, bits) = struct.unpack("<HHIIHH", fmt[:16])
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        dtype = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")

    n = (len(x) // channels) * channels
    return x[:n].reshape(-1, channels).T.copy(), sr


def save_wav(path: str, waveform: np.ndarray, sample_rate: int) -> None:
    """Write (channels, T) or (T,) float waveform as 16-bit PCM WAV.

    Matches the reference's quality save path: clamp to [-1, 1], scale to
    int16, PCM_S encoding (ref: py/main15.py:857-867).
    """
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_wav_bytes(waveform, sample_rate))


def to_mono(waveform: np.ndarray) -> np.ndarray:
    """(channels, T) -> (T,) by channel mean (ref: py/main14.py:59-60)."""
    x = np.asarray(waveform)
    if x.ndim == 1:
        return x
    return x.mean(axis=0)


def resample(waveform: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample over the last axis (torchaudio Resample equivalent)."""
    if orig_sr == target_sr:
        return waveform
    g = gcd(orig_sr, target_sr)
    return resample_poly(waveform, target_sr // g, orig_sr // g, axis=-1).astype(
        np.float32
    )


def load_mono_16k(path: str, sample_rate: int = 16000) -> np.ndarray:
    """File -> mono float32 (T,) at the target rate — the standard API edge
    (ref: py/main14.py:723-727)."""
    wav, sr = load_audio(path)
    return resample(to_mono(wav), sr, sample_rate)
