"""The port's data modules vs the JAX package: the synthetic music clips, the
speech + music concatenation, and the native C++ WAV decoder (the port's own
copy, built by its own data/native.py) against the JAX package's native
decoder and the Python decode, file type by file type; BatchLoader's native
path.  Exact (bit for bit) unless a test says otherwise."""

import ctypes
import fcntl
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile

import numpy as np
import pytest

from awm_tpu.data import native as jax_native
from awm_tpu.data.dataset import ConcatClips as JConcat
from awm_tpu.data.dataset import SyntheticClips as JSynth
from awm_tpu.data.dataset import SyntheticMusicClips as JMusic
from awm_tpu_torch.data import (BatchLoader, ConcatClips, OneSecClips, SyntheticClips,
                                SyntheticMusicClips)
from awm_tpu_torch.data import native
from awm_tpu_torch.utils.audio_io import load_audio, resample, save_wav, to_mono

def _jax_loader_error() -> str:
    """Why the JAX package's loader returned no library: its dlopen error,
    or g++'s where the file is missing (the loader swallows both)."""
    if os.path.exists(jax_native._LIB):
        try:
            ctypes.CDLL(jax_native._LIB)
        except OSError as e:
            return f"dlopen {jax_native._LIB}: {e}"
        return f"{jax_native._LIB} loads here, yet the loader returned none"
    run = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", jax_native._SRC,
                          "-o", os.devnull], capture_output=True, text=True)
    return f"{jax_native._LIB} missing; g++ exit {run.returncode}: {run.stderr[-2000:]}"


@pytest.fixture
def needs_native():
    """Both native decoders loaded, decided when the test runs, never at
    import.  Under several test workers every worker imports this file and
    tests/test_native.py while collecting, and the JAX package's loader
    (awm_tpu/data/native.py) has g++ write straight to its one library path
    with no lock between processes, then caches a failed load for the life
    of the process: a worker that opened a half-written library would skip
    these tests.  So the check holds a file lock shared by the workers,
    and where the JAX loader has no library it forgets that and loads once
    more (every worker has finished collecting by now, so any build begun
    then is complete).  It skips only where there is no g++; with g++ and
    still no library it fails with the loader's error."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native WAV decoders cannot be built")
    tag = hashlib.sha256(jax_native._LIB.encode()).hexdigest()[:12]
    with open(os.path.join(tempfile.gettempdir(), f"awm_native_decoder_{tag}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not jax_native.available():
                with jax_native._lock:
                    jax_native._lib, jax_native._tried = None, False
                if not jax_native.available():
                    pytest.fail(f"the JAX package's native WAV decoder did not load: {_jax_loader_error()}")
            if not native.available():
                pytest.fail(f"the port's native WAV decoder did not load ({native.library_path()})")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@pytest.mark.parametrize("seed,audio_len", [(1, 800), (7, 16000)])
def test_music_and_concat_equal_jax(seed, audio_len):
    """SyntheticMusicClips (the training mix's seed 1, demo_eval's seed 7)
    and ConcatClips of speech + music: every clip equal to the JAX
    package's, lengths and offsets included."""
    n = 3 if audio_len == 16000 else 5
    for i in range(n):
        np.testing.assert_array_equal(SyntheticMusicClips(n, audio_len, seed)[i],
                                      JMusic(n, audio_len, seed)[i])
    ours = ConcatClips(SyntheticClips(4, audio_len), SyntheticMusicClips(n, audio_len, seed))
    ref = JConcat(JSynth(4, audio_len), JMusic(n, audio_len, seed))
    assert len(ours) == len(ref) == 4 + n and ours.audio_len == audio_len
    for i in range(len(ref)):
        np.testing.assert_array_equal(ours[i], ref[i])
    with pytest.raises(ValueError):
        ConcatClips()


def _pcm_wav(path, frames, sr, *, bits=16, fmt=1, truncate_to=None):
    """A RIFF/WAVE file of (frames, channels) samples in [-1, 1]: PCM 16 or
    24-bit, or IEEE float 32; truncate_to cuts the file after that many
    bytes (its headers still claim the full data chunk)."""
    frames = np.asarray(frames, np.float64)
    ch = frames.shape[1]
    if fmt == 3:
        data = frames.astype("<f4").tobytes()
    elif bits == 16:
        data = np.round(frames * 32767).astype("<i2").tobytes()
    else:
        v = np.round(frames * 8388607).astype(np.int32).reshape(-1)
        data = np.stack([v & 255, (v >> 8) & 255, (v >> 16) & 255], axis=1).astype(np.uint8).tobytes()
    block = ch * bits // 8
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, fmt, ch, sr, sr * block, block, bits)
           + b"data" + struct.pack("<I", len(data)))
    blob = hdr + data
    with open(path, "wb") as f:
        f.write(blob[:truncate_to] if truncate_to else blob)


WAV_KINDS = {  # name: (seconds, sample rate, channels, bits, format code)
    "pcm16_mono": (1.0, 16000, 1, 16, 1),
    "pcm24_mono_long": (1.3, 16000, 1, 24, 1),
    "float32_mono_short": (0.4, 16000, 1, 32, 3),
    "pcm16_stereo": (1.1, 16000, 2, 16, 1),
    "pcm16_22050": (0.5, 22050, 1, 16, 1),
}


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    for name, (sec, sr, ch, bits, fmt) in WAV_KINDS.items():
        t = np.arange(int(sec * sr)) / sr
        tone = 0.4 * np.sin(2 * np.pi * 300 * t)[:, None] + 0.05 * rng.standard_normal((len(t), ch))
        _pcm_wav(str(d / f"{name}.wav"), np.clip(tone, -1, 1), sr, bits=bits, fmt=fmt)
    # cut mid-data at a sample boundary (both decoders read what is there)
    # and inside the fmt chunk (both reject it)
    _pcm_wav(str(d / "truncated_data.wav"), 0.3 * np.ones((4000, 1)), 16000, truncate_to=44 + 2 * 1500)
    _pcm_wav(str(d / "truncated_header.wav"), 0.3 * np.ones((4000, 1)), 16000, truncate_to=30)
    return d


@pytest.mark.parametrize("name", [*WAV_KINDS, "truncated_data", "truncated_header"])
def test_native_decoder_equals_jax_native_and_python(needs_native, wav_dir, name):
    """One file per call, clip length 16000 at 16 kHz: the port's decoder
    equals the JAX package's native decoder bit for bit (ok flag included);
    at the target rate it also equals the Python decode (mono mix, cut or
    zero-pad) bit for bit, and at another rate, where it interpolates
    linearly and Python resamples polyphase, it correlates above 0.99 with
    it.  A file cut inside its header fails in all three."""
    path = str(wav_dir / f"{name}.wav")
    got, ok = native.load_clips([path], clip_len=16000, target_sr=16000, n_threads=1)
    want, jok = jax_native.load_clips([path], clip_len=16000, target_sr=16000, n_threads=1)
    assert ok.tolist() == jok.tolist()
    np.testing.assert_array_equal(got, want)
    if name == "truncated_header":
        assert not ok[0] and not got.any()
        with pytest.raises(Exception):
            load_audio(path)
        return
    wav, sr = load_audio(path)
    py = resample(to_mono(wav), sr, 16000)[:16000]
    py = np.pad(py, (0, 16000 - len(py)))
    assert ok[0]
    if sr == 16000:
        np.testing.assert_array_equal(got[0], py)
    else:
        n = int(len(wav[0]) * 16000 / sr) - 16
        assert np.corrcoef(got[0][:n], py[:n])[0, 1] > 0.99
        assert not got[0][n + 20:].any()


def test_batch_loader_native_path(needs_native, wav_dir):
    """BatchLoader over the folder decodes through the native decoder (one
    C call a batch) and gives the Python decode's batch bit for bit on the
    16 kHz files; the unreadable file falls back to Python, which counts it
    and gives silence."""
    ds = OneSecClips(str(wav_dir))
    fast = BatchLoader(ds, batch_size=len(ds), shuffle=False, drop_last=False, num_workers=2)
    slow = BatchLoader(ds, batch_size=len(ds), shuffle=False, drop_last=False, num_workers=2, native=False)
    (a,), (b,) = list(fast), list(slow)
    assert fast.native_batches == 1 and slow.native_batches == 0
    assert fast.n_errors == slow.n_errors == 1
    for i, path in enumerate(ds.filepaths):
        if "22050" not in path:
            np.testing.assert_array_equal(a[i], b[i], err_msg=os.path.basename(path))
    assert BatchLoader(SyntheticClips(4, 100), 2)._native is None
