"""Build and load the port's hand-written CUDA kernels.

Each `csrc/*.cu` source becomes one shared library with a plain C
interface, compiled by `nvcc` alone (no ninja, no PyTorch headers) into
`scp_tpu_torch/_build/`, named by a hash of the sources and flags so a
changed source rebuilds and an unchanged one is reused.  The libraries are
loaded with ctypes; launchers take raw device pointers, sizes and the
caller's CUDA stream, and return a cudaError_t code that the Python
wrapper turns into an exception.

Nothing here runs at import time: the first launch (or `build_all()`)
builds.  A build or launch failure raises — there is no path that quietly
runs the plain PyTorch version instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("mlp.cu", "swin_attn.cu", "knn_topk.cu", "window_attn.cu", "rans.cu",
           "cached_attn.cu")
# -Xptxas -v: each kernel's registers, shared memory and spills go to the
# build log beside the library (ptxas_report)
FLAGS = ["-shared", "-Xcompiler", "-fPIC", "-gencode=arch=compute_90a,code=sm_90a", "-O3",
         "-std=c++17", "-Xptxas", "-v"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# argtypes of every exported launcher, by library
_SIGNATURES = {
    "mlp.cu": {
        "scp_ln_mlp_residual": [_P] * 9 + [_I, _I, _I, _F, _I, _I, _I, _P],
    },
    "swin_attn.cu": {
        "scp_attn_self": [_P] * 7 + [_I] + [_P] * 5 + [_I] * 4 + [_F, _F, _I, _I, _P],
        "scp_attn_cross": [_P] * 10 + [_I] + [_P] * 6 + [_I] * 4 + [_F, _F, _I, _I, _P],
        "scp_proj_gemm": [_P, _I, _P, _P, _F, _P, _P, _P, _I, _P] + [_I] * 6 + [_P],
    },
    "knn_topk.cu": {
        "scp_knn_topk": [_P, _I] + [_P] * 5 + [_I] * 4 + [_P],
    },
    "window_attn.cu": {
        "scp_window_attn": [_P, _L, _L, _L] * 4 + [_P, _P] + [_I] * 5 + [_F, _I, _P],
    },
    "rans.cu": {
        "scp_rans_decode_group": [_P, _L, _L, _P, _L, _P, _P, _P, _P],
        "scp_rans_encode": [_P, _I, _P, _L, _P, _P],
    },
    "cached_attn.cu": {
        "scp_cached_attn": [_P] * 9 + [_L] + [_I] * 6 + [_F, _I, _P],
    },
}
# the element types the Swin kernels (A, B, C, E) take, and the flag that
# tells a launcher which one it got
KERNEL_DTYPES = {"bfloat16": 0, "float32": 1}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest(src: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name == src or name.endswith(".cuh"):
            with open(os.path.join(CSRC, name), "rb") as fh:
                h.update(name.encode() + fh.read())
    return h.hexdigest()[:16]


def lib_path(src: str) -> str:
    return os.path.join(BUILD_DIR, f"{os.path.splitext(src)[0]}-{_digest(src)}.so")


def log_path(src: str) -> str:
    """The compiler's output (ptxas -v) of the library's build."""
    return lib_path(src)[:-3] + ".log"


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")
_PTXAS_STACK = re.compile(r"(\d+) bytes stack frame")


def ptxas_report(src: str, name_part: str = "") -> list:
    """[{kernel (mangled), registers, spill_stores, spill_loads, static smem
    bytes, stack frame bytes}] of each entry of `src`'s build whose name
    contains `name_part`, read from its build log."""
    rows = []
    with open(log_path(src)) as fh:
        for line in fh:
            m = _PTXAS_ENTRY.search(line)
            if m:
                rows.append({"kernel": m.group(1), "registers": None, "spill_stores": None,
                             "spill_loads": None, "smem": 0, "stack": None})
                continue
            if not rows:
                continue
            if (m := _PTXAS_SPILL.search(line)) and rows[-1]["spill_stores"] is None:
                rows[-1]["spill_stores"], rows[-1]["spill_loads"] = int(m.group(1)), int(m.group(2))
                if st := _PTXAS_STACK.search(line):
                    rows[-1]["stack"] = int(st.group(1))
            if m := _PTXAS_USED.search(line):
                rows[-1]["registers"] = int(m.group(1))
                if sm := _PTXAS_SMEM.search(line):
                    rows[-1]["smem"] = int(sm.group(1))
    return [r for r in rows if name_part in r["kernel"]]


def build_all(sources=SOURCES) -> dict:
    """Compile every missing library, one nvcc per source, all started
    together.  Returns {"seconds": wall, "cold": [built], "cached": [reused]}."""
    t0 = time.time()
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [s for s in sources if not os.path.exists(lib_path(s))]
    procs = []
    if todo:
        nvcc = nvcc_path()
        for src in todo:
            out = lib_path(src)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *FLAGS, "-o", tmp, os.path.join(CSRC, src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for src, out, tmp, proc in procs:
        stdout, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} (rc {proc.returncode}):\n{err}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            with open(log_path(src), "w") as fh:
                fh.write(stdout + err)
            os.replace(tmp, out)
    if errors:
        raise KernelBuildError("\n".join(errors))
    return {
        "seconds": time.time() - t0,
        "cold": todo,
        "cached": [s for s in sources if s not in todo],
    }


def load(src: str) -> ctypes.CDLL:
    """The loaded library of `src`, built first if needed."""
    with _lock:
        lib = _libs.get(src)
        if lib is not None:
            return lib
        path = lib_path(src)
        if not os.path.exists(path):
            build_all((src,))
        lib = ctypes.CDLL(path)
        for fn, argtypes in _SIGNATURES[src].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.scp_error_string.argtypes = [ctypes.c_int]
        lib.scp_error_string.restype = ctypes.c_char_p
        _libs[src] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.scp_error_string(code).decode()
        raise KernelLaunchError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def on_device(*tensors):
    """Context manager making the operands' card the current CUDA device
    for a launch.  The launchers run on the runtime's current device
    (cudaGetDevice, cudaFuncSetAttribute, the launch itself), not on the
    device of the pointers they are given, so a launch for tensors on
    cuda:1 while cuda:0 is current would run on the wrong card.  Raises
    when the operands (None ones skipped) lie on more than one device."""
    import torch

    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"kernel operands on {sorted(map(str, devs))}: one CUDA device expected")
    return torch.cuda.device(devs.pop())


def dtype_flag(t) -> int:
    """The launcher's is_f32 flag for a bf16 or f32 tensor; raises on any
    other element type."""
    name = str(t.dtype).replace("torch.", "")
    if name not in KERNEL_DTYPES:
        raise ValueError(f"kernel takes bfloat16 or float32, got {t.dtype}")
    return KERNEL_DTYPES[name]


def check_cuda_tensor(name: str, t, dtype, shape=None) -> None:
    """Device, dtype, contiguity, shape and 16-byte alignment checks made
    before every launch (the kernels read rows as 16-byte vectors)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
