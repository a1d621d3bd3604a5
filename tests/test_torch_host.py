"""The port's copies of scp_tpu's host modules held against the originals
on the CPU: the stream container (codec/bitstream.py), the point-cloud
reader and writer (core/pointcloud.py), QuantGrid.from_grid, deoctree,
the cylindrical transforms, and the metrics and normals ply of the codec
CLI.  Integers and bytes are exact; floats are exact too, since every
copy runs the same numpy operations (the round trips keep scp_tpu's own
1e-6 of tests/test_transforms.py)."""

import os

import numpy as np
import pytest

from scp_tpu.codec import bitstream as jbits
from scp_tpu.core import octree as joctree
from scp_tpu.core import pointcloud as jpc
from scp_tpu.core import quantize as jquant
from scp_tpu.core import transforms as jtf
from scp_tpu.tools import gene_normals as jnormals
from scp_tpu_torch.codec import bitstream as tbits
from scp_tpu_torch.core import octree as toctree
from scp_tpu_torch.core import pointcloud as tpc
from scp_tpu_torch.core import quantize as tquant
from scp_tpu_torch.core import transforms as ttf
from scp_tpu_torch.tools import gene_normals as tnormals


@pytest.fixture(autouse=True)
def no_jax_native(monkeypatch):
    """scipy metrics and numpy octrees on scp_tpu's side: its native build
    shares one <so>.tmp across test workers, and a library another test of
    the worker loaded would take the metrics off scipy."""
    from scp_tpu.native import metrics_native

    monkeypatch.setenv("SCP_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(metrics_native, "available", lambda: False)


def _cloud(rng, n=500):
    r, az, el = rng.uniform(2, 60, n), rng.uniform(0, 2 * np.pi, n), rng.uniform(-0.4, 0.2, n)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                     r * np.sin(el)], 1)


def _header(mod, system, n_sub):
    rng = np.random.default_rng(5)
    levels = tuple(int(x) for x in rng.integers(8, 13, n_sub))
    angular = system != "cart"
    return mod.StreamHeader(
        n_sym=123457, max_level=sum(levels) if n_sub > 1 else levels[0], system=system,
        bin_num=4096 if angular else 0, z_offset=-3.25, lidar_clip=12, qs_rho=0.0977,
        pos_mm=(np.sort(rng.integers(0, 2**16, (sum(levels), 2)), 1) if angular
                else np.zeros((0, 2), np.int64)),
        subtree_sizes=tuple(int(x) for x in rng.integers(100, 9000, n_sub)),
        coding_mode="rans", backend="torch-cuda", coding_params="group=16;tiny=512",
        subtree_levels=levels, level_sizes=rng.integers(1, 5000, sum(levels)),
        grid_qs=rng.uniform(0.01, 1, (n_sub, 3)), grid_offset=rng.uniform(-9, 9, (n_sub, 3)),
        grid_bin_num=rng.integers(0, 5000, n_sub))


@pytest.mark.parametrize("system,n_sub", [("spher", 1), ("spher", 3), ("cylin", 1),
                                          ("cart", 1), ("cart", 3)])
def test_stream_bytes_identical_both_directions(system, n_sub):
    payload = bytes(np.random.default_rng(1).integers(0, 256, 777, dtype=np.uint8))
    blob_t = tbits.pack_stream(_header(tbits, system, n_sub), payload)
    blob_j = jbits.pack_stream(_header(jbits, system, n_sub), payload)
    assert blob_t == blob_j
    for blob in (blob_t, blob_j):
        th, tp = tbits.unpack_stream(blob)
        jh, jp = jbits.unpack_stream(blob)
        assert tp == jp == payload
        assert tbits.pack_stream(th, tp) == jbits.pack_stream(jh, jp) == blob
        for f in ("n_sym", "max_level", "system", "bin_num", "z_offset", "lidar_clip",
                  "qs_rho", "subtree_sizes", "coding_mode", "backend", "coding_params",
                  "subtree_levels"):
            assert getattr(th, f) == getattr(jh, f), f
        for f in ("pos_mm", "level_sizes", "grid_qs", "grid_offset", "grid_bin_num"):
            np.testing.assert_array_equal(getattr(th, f), getattr(jh, f), err_msg=f)
        for tg, jg in zip(th.grids(), jh.grids()):
            assert tg.system == jg.system and tg.bin_num == jg.bin_num
            np.testing.assert_array_equal(tg.qs, jg.qs)
            np.testing.assert_array_equal(tg.offset, jg.offset)


@pytest.mark.parametrize("args", [("scan", "spher", 16, 1800, -3.0), ("a_b", "cylin", 12, 7, 0),
                                  ("17", "cart", 9, 0, -2)])
def test_reference_style_name_matches(args):
    assert tbits.reference_style_name(*args) == jbits.reference_style_name(*args)


def _write_binary_ply(path, pts, extra=True):
    """binary_little_endian .ply with x, y, z floats (and an intensity
    column, which the readers skip)."""
    props = ["x", "y", "z"] + (["intensity"] if extra else [])
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(pts)}\n"
            + "".join(f"property float {p}\n" for p in props) + "end_header\n")
    cols = [pts.astype("<f4")] + ([np.ones((len(pts), 1), "<f4")] if extra else [])
    with open(path, "wb") as fh:
        fh.write(head.encode("ascii") + np.hstack(cols).tobytes())


def test_read_points_matches_every_format(tmp_path):
    pts = _cloud(np.random.default_rng(2)).astype(np.float32)
    files = {}
    files["ascii.ply"] = tmp_path / "ascii.ply"
    jpc.write_ply(str(files["ascii.ply"]), pts)
    files["binary.ply"] = tmp_path / "binary.ply"
    _write_binary_ply(files["binary.ply"], pts)
    files["kitti.bin"] = tmp_path / "kitti.bin"
    np.hstack([pts, np.zeros((len(pts), 1), np.float32)]).tofile(files["kitti.bin"])
    files["cloud.npy"] = tmp_path / "cloud.npy"
    np.save(files["cloud.npy"], np.hstack([pts, np.ones((len(pts), 1), np.float32)]))
    for name, path in files.items():
        got, want = tpc.read_points(str(path)), jpc.read_points(str(path))
        assert got.dtype == want.dtype and got.shape == (len(pts), 3), name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(tpc.read_points(str(files["binary.ply"])), pts)
    np.testing.assert_array_equal(tpc.read_points(str(files["kitti.bin"])), pts)


def test_write_ply_then_read_points(tmp_path):
    pts = _cloud(np.random.default_rng(3))
    tpc.write_ply(str(tmp_path / "t.ply"), pts)
    jpc.write_ply(str(tmp_path / "j.ply"), pts)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    np.testing.assert_array_equal(tpc.read_points(str(tmp_path / "t.ply")),
                                  jpc.read_points(str(tmp_path / "j.ply")))
    np.testing.assert_allclose(tpc.read_points(str(tmp_path / "t.ply")), pts, atol=1e-6)


@pytest.mark.parametrize("system", ["cart", "cylin", "spher"])
def test_deoctree_and_from_grid_match(system):
    rng = np.random.default_rng(4)
    pts = _cloud(rng, 3000)
    tgrid = tquant.make_grid(pts, system=system, qs=0.1, offset=0)
    jgrid = jquant.make_grid(pts, system=system, qs=0.1, offset=0)
    q = np.unique(tgrid.to_grid(pts), axis=0)
    np.testing.assert_array_equal(q, np.unique(jgrid.to_grid(pts), axis=0))
    q -= q.min(0)
    codes = toctree.build_octree(q, native=False).occupancy
    got, want = toctree.deoctree(codes), joctree.deoctree(codes)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(tgrid.from_grid(got), jgrid.from_grid(want))
    g2 = tquant.QuantGrid(system=system, qs=np.array([0.1, 0.002, 0.003]),
                          offset=np.array([1.0, 0.0, -0.5]), bin_num=3141)
    j2 = jquant.QuantGrid(system=system, qs=g2.qs, offset=g2.offset, bin_num=3141)
    np.testing.assert_array_equal(g2.from_grid(got), j2.from_grid(want))


def test_cylindrical_transforms_match():
    pts = _cloud(np.random.default_rng(6), 2000)
    pts[:5] = [[0, 0, 1], [1, 0, 0], [-1, 0, 0], [0, -1, 0], [0, 0, 0]]  # axis and origin
    cyl = ttf.cart2cylin(pts)
    np.testing.assert_array_equal(cyl, jtf.cart2cylin(pts))
    np.testing.assert_array_equal(ttf.cylin2cart(cyl), jtf.cylin2cart(cyl))
    np.testing.assert_allclose(ttf.cylin2cart(cyl), pts, atol=1e-6)


def test_metrics_and_normals_ply_match(tmp_path):
    from scp_tpu import metrics as jmetrics
    from scp_tpu_torch import metrics as tmetrics

    rng = np.random.default_rng(8)
    a = _cloud(rng, 800)
    b = a + rng.normal(0, 0.05, a.shape)
    assert tmetrics.PEAKS == jmetrics.PEAKS
    # scp_tpu runs on scipy here: the port's scipy path equals it, and its
    # native KD-tree (the default; its OpenMP sums run in another order)
    # agrees within 1e-9 (tests/test_torch_metrics_native.py)
    assert tmetrics.chamfer(a, b, native=False) == jmetrics.chamfer(a, b)
    assert abs(tmetrics.chamfer(a, b) - jmetrics.chamfer(a, b)) <= 1e-9 * jmetrics.chamfer(a, b)
    nt, nj = tmetrics.estimate_normals(a, k=8, native=False), jmetrics.estimate_normals(a, k=8)
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_allclose(tmetrics.estimate_normals(a, k=8), nj, rtol=0, atol=1e-6)
    tnormals.write_ply_with_normals(str(tmp_path / "t.ply"), a, nt)
    jnormals.write_ply_with_normals(str(tmp_path / "j.ply"), a, nj)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    pt, ntr = tnormals.read_normals_ply(str(tmp_path / "t.ply"))
    pj, njr = jnormals.read_normals_ply(str(tmp_path / "j.ply"))
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(ntr, njr)
    for normals in (None, ntr):
        got = tmetrics.d1_d2_psnr(a, b, 59.7, normals=normals, native=False)
        want = jmetrics.d1_d2_psnr(a, b, 59.7, normals=normals)
        assert got == want
        native = tmetrics.d1_d2_psnr(a, b, 59.7, normals=normals)
        np.testing.assert_allclose(native, want, rtol=1e-9, atol=0)
    assert os.path.getsize(tmp_path / "t.ply") > 0
