"""ctypes bindings for the native single-pass octree builder (the twin of
scp_tpu/native/octree_native.py)."""

from __future__ import annotations

import ctypes

import numpy as np

from scp_tpu_torch.native.build import BUILD_DIR, NativeBuildError, load_library

_P = ctypes.c_void_p


def _lib(build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    lib = load_library(build_dir)
    lib.octree_build.restype = _P
    lib.octree_build.argtypes = [_P, ctypes.c_int64, ctypes.c_int32]
    lib.octree_num_nodes.restype = ctypes.c_int64
    lib.octree_num_nodes.argtypes = [_P]
    lib.octree_fill.restype = None
    lib.octree_fill.argtypes = [_P] * 7
    lib.octree_free.restype = None
    lib.octree_free.argtypes = [_P]
    return lib


def available(build_dir: str = BUILD_DIR) -> bool:
    """Whether the library builds (or is built) and loads."""
    try:
        _lib(build_dir)
    except (NativeBuildError, OSError):
        return False
    return True


def build_from_keys(keys: np.ndarray, bits: int, build_dir: str = BUILD_DIR):
    """Sorted unique uint64 Morton keys -> OctreeArrays (see core.octree).
    Counts its calls in `build_from_keys.calls`."""
    from scp_tpu_torch.core.octree import OctreeArrays

    lib = _lib(build_dir)
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    if keys.ndim != 1 or not 1 <= int(bits) <= 21:
        raise ValueError(f"keys must be 1-D and bits in 1..21, got {keys.shape}, {bits}")
    h = lib.octree_build(keys.ctypes.data_as(_P), keys.shape[0], int(bits))
    try:
        n = lib.octree_num_nodes(h)
        occ = np.empty(n, dtype=np.int32)
        level = np.empty(n, dtype=np.int32)
        octant = np.empty(n, dtype=np.int32)
        parent = np.empty(n, dtype=np.int64)
        pos = np.empty((n, 3), dtype=np.int64)
        level_starts = np.empty(int(bits) + 1, dtype=np.int64)
        lib.octree_fill(h, *(a.ctypes.data_as(_P)
                             for a in (occ, level, octant, parent, pos, level_starts)))
    finally:
        lib.octree_free(h)
    build_from_keys.calls += 1
    return OctreeArrays(occupancy=occ, level=level, octant=octant, parent=parent, pos=pos,
                        level_starts=level_starts, max_level=int(bits))


build_from_keys.calls = 0
