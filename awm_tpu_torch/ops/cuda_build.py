"""Build a CUDA source of this package into a shared library and load it.

Each ``csrc/*.cu`` has a plain C interface.  nvcc compiles it for sm_90a into
``ops/_build/<name>-<hash>.so`` at first use (a fresh checkout builds in
seconds; several sources build in parallel), and ctypes loads it.  The hash
covers the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source never loads a stale library.  Nothing here runs at import:
the CPU tests import every module, and a machine without a card may have
no nvcc at all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels cannot be built")


def _library_path(name: str, extra: tuple = ()) -> str:
    """ops/_build/<name>-<hash>.so; the hash covers the source, every shared
    header of csrc/ and the flags (extra ones too)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(extra)).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all(names, extra: tuple = ()) -> dict[str, tuple[str, str]]:
    """Compile csrc/<name>.cu for every name that needs it, one nvcc process
    each, all started together, with NVCC_FLAGS and `extra` (e.g. a -D that
    only a timing script passes).  Returns {name: (library path, nvcc log)};
    the log holds ptxas's registers / shared memory / spills per kernel."""
    out, running = {}, {}
    for name in names:
        lib = _library_path(name, extra)
        log_path = lib[:-3] + ".log"
        if os.path.exists(lib) and os.path.exists(log_path):
            with open(log_path) as f:
                out[name] = (lib, f.read())
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        src = os.path.join(CSRC, f"{name}.cu")
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, *extra, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running[name] = (proc, src, lib, log_path, tmp)
    failed = []
    for name, (proc, src, lib, log_path, tmp) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
            continue
        with open(log_path, "w") as f:
            f.write(log)
        os.replace(tmp, lib)  # atomic: a concurrent process never loads a half-written file
        out[name] = (lib, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load_all(names, extra: tuple = ()) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Build (if needed, in parallel) and dlopen csrc/<name>.cu for every
    name, with the `extra` flags of build_all.  Returns {name: (library,
    log)}."""
    return {name: (ctypes.CDLL(path), log) for name, (path, log) in build_all(names, extra).items()}
