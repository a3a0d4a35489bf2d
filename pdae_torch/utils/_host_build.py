"""Build the port's host libraries with g++ at first use; load them with ctypes.

The input pipeline's native code, ``csrc/lmdb_reader.cpp`` (the LMDB reader)
and ``csrc/image_decode.cpp`` (libjpeg decode and the triangle resize), each
compiles on its own into one shared library with ``native/Makefile``'s
flags, ``g++ -O2 -std=c++17 -fPIC -Wall -shared`` (and ``-ljpeg`` for the
decoder): the same flags keep the resize's arithmetic bit-equal to the JAX
package's library. The libraries go to ``pdae_torch/_build/`` under a name
that carries a hash of the source and the command, as ``ops/_build.py`` names
the CUDA ones, so an edited source is rebuilt and an unchanged one reused.

Loader threads, test workers and torchrun ranks may all ask at once: a thread
lock keeps one build per process, and each build writes a process-unique
temporary file that ``os.replace`` moves into place, so no process loads a
half-written library. A library that does not build or load gives ``None``,
once per process, and the compiler's output stays in ``build_logs``. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Callable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")
LIBS = {"lmdb_reader.cpp": (), "image_decode.cpp": ("-ljpeg",)}

_lock = threading.Lock()
_libs: dict = {}        # source -> loaded library, or None where it failed
build_logs: dict = {}   # source -> the compiler's (or the loader's) output


def _command(source: str, out: str) -> list:
    return [CXX, *CXX_FLAGS, "-o", out, os.path.join(CSRC, source), *LIBS[source]]


def library_path(source: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(CSRC, source), "rb") as f:
        h.update(f.read())
    h.update(" ".join(_command(source, "")).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def _build(source: str) -> str:
    """The library of ``source``, compiled where it is missing. Raises
    ``RuntimeError`` with the compiler's output where g++ fails."""
    out = library_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(_command(source, tmp), capture_output=True, text=True,
                              timeout=300)
        build_logs[source] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {source} (exit {proc.returncode}):\n"
                               f"{build_logs[source]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(source: str, declare: Callable[[ctypes.CDLL], None]) -> Optional[ctypes.CDLL]:
    """The library of ``source`` with its signatures set by ``declare(lib)``,
    built first where it is missing; ``None`` where it does not build or load
    (the reason in ``build_logs[source]``). Tried once per process."""
    with _lock:
        if source not in _libs:
            try:
                lib = ctypes.CDLL(_build(source))
                declare(lib)
            except RuntimeError:         # g++ failed; its output is in the log
                lib = None
            except (OSError, subprocess.SubprocessError, AttributeError) as e:
                build_logs[source] = build_logs.get(source, "") + f"{type(e).__name__}: {e}"
                lib = None
            _libs[source] = lib
        return _libs[source]


def last_line(source: str) -> str:
    """The last non-empty line of ``source``'s build output, or ``""``."""
    lines = [ln for ln in build_logs.get(source, "").splitlines() if ln.strip()]
    return lines[-1] if lines else ""
