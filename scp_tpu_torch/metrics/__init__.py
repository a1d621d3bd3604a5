"""Distortion metrics: D1/D2 PSNR (MPEG pc_error equivalent) and Chamfer
(the twin of scp_tpu/metrics).

The reference shells out to a prebuilt `utils/pc_error` binary and parses
its stdout (reference data_preproc/pt.py:13-85, utils/__init__.py:3-16);
here the same quantities are computed in-process, by default on the
port's native KD-tree (native/src/metrics.cpp, built with g++ at first
use).  `native=False` takes scipy's KDTree instead, as scp_tpu does when
its library does not build; nothing falls back on its own: a failed
native build raises.

Peaks: 59.70 (KITTI), 30000 (Ford) — reference encode_dataset.py:63-66.
"""

from __future__ import annotations

import numpy as np

from scp_tpu_torch.native import metrics_native

PEAKS = {"kitti": 59.70, "ford": 30000.0}


def mse_directional(a, b, normals=None, normal_of_nn=False, native: bool = True):
    """(D1, D2) mean squared errors of a's points to their nearest in b."""
    if native:
        return metrics_native.mse_directional(a, b, normals, normal_of_nn)
    from scipy.spatial import KDTree

    d, idx = KDTree(b).query(a, k=1, workers=-1)
    mse_d1 = float((d**2).mean())
    mse_d2 = 0.0
    if normals is not None:
        nrm = normals[idx] if normal_of_nn else normals[: len(a)]
        diff = a - b[idx]
        dot = (diff * nrm).sum(axis=1)
        mse_d2 = float((dot**2).mean())
    return mse_d1, mse_d2


def d1_d2_psnr(
    reference: np.ndarray,
    reconstruction: np.ndarray,
    peak: float,
    normals: np.ndarray | None = None,
    native: bool = True,
) -> tuple[float, float]:
    """Symmetric D1 (point-to-point) and D2 (point-to-plane) PSNR.

    PSNR = 10*log10(3*peak^2 / max(mse_ab, mse_ba)).  `normals` are the
    reference cloud's; the B->A pass uses the normal at the nearest
    reference point.
    """
    a = np.asarray(reference, np.float64)
    b = np.asarray(reconstruction, np.float64)
    m1_ab, m2_ab = mse_directional(a, b, normals, normal_of_nn=False, native=native)
    m1_ba, m2_ba = mse_directional(b, a, normals, normal_of_nn=True, native=native)
    mse1 = max(m1_ab, m1_ba)
    mse2 = max(m2_ab, m2_ba)

    def psnr(mse):
        if mse <= 0:
            return float("inf")
        return 10.0 * np.log10(3.0 * peak * peak / mse)

    return psnr(mse1), (psnr(mse2) if normals is not None else 0.0)


def chamfer(a: np.ndarray, b: np.ndarray, scale: float = 1.0, native: bool = True) -> float:
    """max of mean NN distances (reference pt.py:88-95)."""
    a = np.asarray(a, np.float64) / scale
    b = np.asarray(b, np.float64) / scale
    if native:
        return max(metrics_native.mean_nn_dist(b, a), metrics_native.mean_nn_dist(a, b))
    from scipy.spatial import KDTree

    d1, _ = KDTree(a, compact_nodes=False).query(b, k=1, workers=-1)
    d2, _ = KDTree(b, compact_nodes=False).query(a, k=1, workers=-1)
    return float(max(d1.mean(), d2.mean()))


def estimate_normals(points: np.ndarray, k: int = 30, native: bool = True) -> np.ndarray:
    """PCA normals over k-NN neighborhoods, oriented toward the sensor
    origin (replaces the reference's Open3D path, gene_normals.py:40-52)."""
    pts = np.asarray(points, np.float64)
    if native:
        idx = metrics_native.knn(pts, pts, k)
    else:
        from scipy.spatial import KDTree

        _, idx = KDTree(pts).query(pts, k=k, workers=-1)
    nb = pts[idx]  # (N, k, 3)
    centered = nb - nb.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered)
    _, vecs = np.linalg.eigh(cov)
    normals = vecs[:, :, 0]  # smallest eigenvalue
    # orient toward origin (sensor at 0)
    flip = np.sign((normals * -pts).sum(axis=1))
    flip[flip == 0] = 1.0
    return (normals * flip[:, None]).astype(np.float32)
