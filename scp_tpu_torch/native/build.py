"""g++ build of the port's native host library (the twin of
scp_tpu/native/build.py: the octree builder, the range coder and the
KD-tree distortion metrics).

`src/ac.cpp`, `src/octree.cpp` and `src/metrics.cpp` are compiled with
scp_tpu's flags into
`scp_tpu_torch/_build/`, named by a hash of the source and the flags, and
loaded with ctypes (a plain C interface; no PyTorch headers).  Nothing runs
at import time: the first `load_library()` builds.

Each process compiles into a temp file of its own (pid and a random
suffix) and renames it into place, so processes that build at once (test
workers) never read each other's half-written output.  A failed build
raises with the compiler's last lines; nothing falls back quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import secrets
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "src")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("ac.cpp", "octree.cpp", "metrics.cpp")
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-march=native", "-fopenmp"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    pass


def lib_path(build_dir: str = BUILD_DIR) -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(SRC_DIR, name), "rb") as fh:
            h.update(name.encode() + fh.read())
    return os.path.join(build_dir, f"libscp_native-{h.hexdigest()[:16]}.so")


def _compile(out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{secrets.token_hex(4)}.tmp"
    cmd = ["g++", *CXXFLAGS, "-o", tmp, *(os.path.join(SRC_DIR, s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"g++ did not run: {e}") from e
    try:
        if proc.returncode != 0:
            tail = "\n".join((proc.stdout + proc.stderr).splitlines()[-30:])
            raise NativeBuildError(f"g++ failed (rc {proc.returncode}):\n{tail}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library(build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """The loaded native library, built first if it is missing."""
    path = lib_path(build_dir)
    with _lock:
        lib = _libs.get(path)
        if lib is None:
            if not os.path.exists(path):
                _compile(path)
            lib = _libs[path] = ctypes.CDLL(path)
        return lib
