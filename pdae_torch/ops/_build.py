"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Each source in ``pdae_torch/csrc`` has a plain C interface and compiles on
its own into one shared library (``nvcc -gencode arch=compute_90a,
code=sm_90a -O3 -shared -Xcompiler -fPIC``), all sources at once, one nvcc
process each. The libraries go to ``pdae_torch/_build/`` under a name that
carries a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is reused. Nothing here runs at import time: the CPU
tests import every module on machines without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("attention.cu", "groupnorm.cu", "groupnorm_bwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
build_logs: dict = {}   # source -> nvcc/ptxas output of the last build


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                           "port's CUDA kernels are built on the card's machine")
    return path


def _library_path(source: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(CSRC, source), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def _build_locked(sources) -> float:
    missing = [s for s in sources if not os.path.exists(_library_path(s))]
    if not missing:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    procs = []
    for src in missing:
        out = _library_path(src)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[src] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - start


def build(sources=SOURCES) -> float:
    """Compile every library that is missing; returns the seconds spent."""
    with _lock:
        return _build_locked(sources)


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, building all missing ones first."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            _build_locked(SOURCES)
            lib = _libs[source] = ctypes.CDLL(_library_path(source))
        return lib
