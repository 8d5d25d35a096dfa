"""ctypes bindings for the native C++ batch WAV decoder (csrc/wavio.cpp, the
port's own copy of the JAX package's native/wavio.cpp).

Host code, no device kernel.  g++ builds the shared library at first use
into ``data/_native/libawmwav-<hash>.so`` (the hash covers the source and
the flags, so an edited source never loads a stale library; the build goes
to a temporary name and is renamed into place, so processes that build at
once never load half a file).  ``available()`` is False where no toolchain
exists, and BatchLoader then decodes in Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "csrc", "wavio.cpp")
LIB_DIR = os.path.join(_HERE, "_native")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(LIB_DIR, f"libawmwav-{h.hexdigest()[:16]}.so")


def _build(lib: str) -> bool:
    os.makedirs(LIB_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *FLAGS, SRC, "-o", tmp], check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, lib)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib_path = library_path()
        if not os.path.exists(lib_path) and not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError:
            return None
        lib.awm_load_clips.restype = ctypes.c_long
        lib.awm_load_clips.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.POINTER(ctypes.c_float),
            ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def load_clips(paths: Sequence[str], clip_len: int = 16000, target_sr: int = 16000,
               n_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a batch of WAV files -> ((n, clip_len) float32, (n,) ok mask).

    One C call (ctypes releases the GIL); a std::thread pool reads, decodes
    (PCM 8/16/24/32-bit, float 32/64), mono-mixes, resamples by linear
    interpolation and cuts or zero-pads each file.  A file that fails leaves
    zeros and ok False."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native WAV decoder is unavailable (no g++, or its build failed)")
    n = len(paths)
    out = np.zeros((n, clip_len), dtype=np.float32)
    ok = np.zeros(n, dtype=np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.awm_load_clips(arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), clip_len,
                       target_sr, n_threads, ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out, ok.astype(bool)
