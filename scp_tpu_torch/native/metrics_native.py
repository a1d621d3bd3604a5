"""ctypes bindings for the native distortion metrics (the twin of
scp_tpu/native/metrics_native.py): a static KD-tree per call
(`src/metrics.cpp`, OpenMP over the queries).  The library is the port's
own build (native/build.py); a failed build raises NativeBuildError.
Counts its calls in `calls`."""

from __future__ import annotations

import ctypes

import numpy as np

from scp_tpu_torch.native.build import BUILD_DIR, NativeBuildError, load_library

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
calls = 0


def _lib(build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    lib = load_library(build_dir)
    for name, restype, argtypes in (
        ("pc_mse_directional", None, [_P, _I64, _P, _I64, _P, ctypes.c_int32, _P]),
        ("pc_mean_nn_dist", ctypes.c_double, [_P, _I64, _P, _I64]),
        ("pc_knn", None, [_P, _I64, _P, _I64, ctypes.c_int32, _P]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def available(build_dir: str = BUILD_DIR) -> bool:
    """Whether the library builds (or is built) and loads."""
    try:
        _lib(build_dir)
    except (NativeBuildError, OSError):
        return False
    return True


def _c3(a) -> np.ndarray:
    """(n, 3) contiguous float64, the layout the C functions index."""
    a = np.ascontiguousarray(a, dtype=np.float64)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"expected (n, 3) points, got {a.shape}")
    return a


def _count():
    global calls
    calls += 1


def mse_directional(a, b, normals=None, normal_of_nn: bool = False) -> tuple[float, float]:
    """(D1, D2) mean squared errors of a's points to their nearest in b;
    D2 projects on `normals` (a's own, or the normal at the nearest point
    of b when normal_of_nn), 0.0 without normals."""
    lib = _lib()
    a, b = _c3(a), _c3(b)
    if not (len(a) and len(b)):
        raise ValueError("empty point cloud")
    out = np.zeros(2, dtype=np.float64)
    nrm = None
    if normals is not None:
        normals = _c3(normals)
        need = len(b) if normal_of_nn else len(a)
        if normals.shape[0] < need:
            raise ValueError(f"{normals.shape[0]} normals for {need} points")
        nrm = normals.ctypes.data_as(_P)
    lib.pc_mse_directional(a.ctypes.data_as(_P), a.shape[0], b.ctypes.data_as(_P), b.shape[0],
                           nrm, 1 if normal_of_nn else 0, out.ctypes.data_as(_P))
    _count()
    return float(out[0]), float(out[1])


def mean_nn_dist(a, b) -> float:
    """Mean (not squared) distance of a's points to their nearest in b."""
    lib = _lib()
    a, b = _c3(a), _c3(b)
    if not (len(a) and len(b)):
        raise ValueError("empty point cloud")
    _count()
    return float(lib.pc_mean_nn_dist(a.ctypes.data_as(_P), a.shape[0], b.ctypes.data_as(_P),
                                     b.shape[0]))


def knn(points, queries, k: int) -> np.ndarray:
    """(len(queries), k) int64 indices into points of each query's k
    nearest, nearest first."""
    lib = _lib()
    points, queries = _c3(points), _c3(queries)
    if not 1 <= int(k) <= len(points):
        raise ValueError(f"k={k} for {len(points)} points")
    out = np.empty((queries.shape[0], int(k)), dtype=np.int64)
    lib.pc_knn(points.ctypes.data_as(_P), points.shape[0], queries.ctypes.data_as(_P),
               queries.shape[0], int(k), out.ctypes.data_as(_P))
    _count()
    return out
