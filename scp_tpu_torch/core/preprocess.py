"""Copy of scp_tpu/core/preprocess.py (the port imports nothing of the
JAX package).

Point-cloud -> octree context shards (reference `proc_pc`/`mul_proc_pc`,
data_preproc/data_preprocess.py:13-167).

Outputs per cloud one (N, K=4, 6) int array: channel 0 occupancy (1..255,
256 = missing ancestor), 1 level, 2 octant, 3:6 grid position — the data
contract every dataset and codec consumes (SURVEY.md §1).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from scp_tpu_torch.core.morton import axis_bits
from scp_tpu_torch.core.octree import OctreeArrays, build_octree, gen_context, morton_prefix_filter
from scp_tpu_torch.core.pointcloud import read_points
from scp_tpu_torch.core.quantize import QuantGrid, make_grid
from scp_tpu_torch.utils import profiling


@dataclasses.dataclass
class PreprocResult:
    context: np.ndarray  # (N, 4, 6)
    tree: OctreeArrays
    grid: QuantGrid
    grid_points: np.ndarray  # unique int grid coords fed to the octree
    ref_points: np.ndarray  # Cartesian points after normalize/rotation
    recon_points: np.ndarray  # dequantized Cartesian reconstruction
    bin_num: int
    z_offset: float
    octree_s: float = 0.0  # seconds of the octree build (host wall)


def rotate_axes(points: np.ndarray) -> np.ndarray:
    """MVUB orientation fix: (x, y, z) -> (x, z, -y) (reference :37-39)."""
    p = points[:, [0, 2, 1]].copy()
    p[:, 2] = -p[:, 2]
    return p


def preprocess_points(
    points: np.ndarray,
    system: str = "cart",
    qs: float = 1.0,
    offset="min",
    qlevel: int | None = None,
    rotation: bool = False,
    normalize: bool = False,
    morton_path: list[int] | None = None,
    native: bool = True,
) -> PreprocResult:
    """`native` picks the octree builder (core.octree.build_octree)."""
    with profiling.span("preprocess"):
        return _preprocess(points, system, qs, offset, qlevel, rotation, normalize,
                           morton_path, native)


def _preprocess(points, system, qs, offset, qlevel, rotation, normalize, morton_path,
                native) -> PreprocResult:
    p = np.asarray(points, dtype=np.float64)
    if normalize:
        p = p - p.mean(axis=0)
        p = p / np.abs(p).max()
    if rotation:
        p = rotate_axes(p)

    with profiling.span("preprocess.quantize"):
        grid = make_grid(p, system=system, qs=qs, offset=offset, qlevel=qlevel)
        q = np.unique(grid.to_grid(p), axis=0)

    with profiling.span("preprocess.octree"):
        t0 = time.perf_counter()
        if morton_path is not None:
            # Multi-level split: keep only points whose radial-axis Morton bit
            # prefix matches; the octree keeps the FULL cloud's bit depth so the
            # three subtrees tile one global grid (reference Octree.py:184-221).
            bits = axis_bits(q)
            q_sub = q[morton_prefix_filter(q, morton_path)]
            tree = build_octree(q_sub, max_level=bits, native=native)
            q = q_sub
        else:
            tree = build_octree(q, native=native)
        octree_s = time.perf_counter() - t0
        ctx = gen_context(tree, k=4)

    return PreprocResult(
        context=ctx,
        tree=tree,
        grid=grid,
        grid_points=q,
        ref_points=p.astype(np.float32),
        recon_points=grid.from_grid(q).astype(np.float32),
        bin_num=grid.bin_num,
        z_offset=float(grid.offset[2]),
        octree_s=octree_s,
    )


def save_whole(out_file: str, arr: np.ndarray) -> None:
    """np.save(out_file, arr) through a temporary file and a rename, so an
    interrupted write leaves no `<out_file>.npy` for a resumed run to skip."""
    tmp = f"{out_file}.npy.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as fh:
            np.save(fh, arr)
        os.replace(tmp, out_file + ".npy")
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def preprocess_file(
    inp_path: str,
    out_dir: str,
    out_name: str,
    test: bool = False,
    **kwargs,
) -> tuple[str, PreprocResult]:
    """Read, preprocess, and save the shard. Training shards embed the node
    count in the filename `<name>_<N>.npy` (reference :80); test shards are
    `<name>.npy` plus `<name>_loc.npy` with the raw points (:76-78)."""
    os.makedirs(out_dir, exist_ok=True)
    pts = read_points(inp_path)
    res = preprocess_points(pts, **kwargs)
    if test:
        mp = kwargs.get("morton_path")
        suffix = "".join(f"_{m}" for m in mp) if mp else ""
        out_file = os.path.join(out_dir, out_name + suffix)
        save_whole(out_file + "_loc", res.ref_points)
    else:
        out_file = os.path.join(out_dir, f"{out_name}_{res.context.shape[0]}")
    save_whole(out_file, res.context)
    return out_file, res


def kitti_qs(lidar_level: int) -> float:
    """Rate-point step sizes (reference encode_dataset_ehem.py:141)."""
    return 400.0 / (2**lidar_level - 1)


def ford_qs(lidar_level: int) -> float:
    return float(2 ** (18 - lidar_level))
