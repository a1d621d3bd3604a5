"""The port's test-data tools (scp_tpu_torch.tools.test_gene, psnr_test)
held against scp_tpu's on the CPU, on three small LiDAR-like sweeps (.ply,
KITTI layout) at lidar level 12: in the spherical, cylindrical and
cartesian systems, with --mullevel, and split by --parts.

The shards and `_quant.ply` files are byte-equal; the `_manifest.npz`
arrays equal (the zip members carry their write time, so the files are
compared by content); `_meta.npy`'s bin_num (and z_offset) equal and its
Chamfer within 1e-9 relative: the port computes it on its native KD-tree,
scp_tpu here on scipy's (its native build shares one <so>.tmp across test
workers, so its library is off: SCP_TPU_NO_NATIVE=1 and
`metrics_native.available` patched to False), and the two sum in other
orders.  psnr_test's printed D1 / D2 / Chamfer (three and five decimals)
agree within 1e-6, with and without --with_normals."""

import glob
import os
import re

import numpy as np
import pytest

from scp_tpu.core.pointcloud import write_ply as jwrite_ply
from scp_tpu.tools import psnr_test as jpsnr
from scp_tpu.tools import test_gene as jgene
from scp_tpu_torch.metrics import estimate_normals
from scp_tpu_torch.tools import psnr_test as tpsnr
from scp_tpu_torch.tools import test_gene as tgene
from scp_tpu_torch.tools.gene_normals import write_ply_with_normals

LEVEL = "12"
REL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def jax_switches():
    from scp_tpu.native import metrics_native

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCP_TPU_NO_NATIVE", "1")
        mp.setattr(metrics_native, "available", lambda: False)
        yield


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """Three sweeps under data/seq00 and their normals plys under
    normals/seq00 (the same names, so psnr_test finds the same
    `_quant.ply` for both)."""
    tmp = tmp_path_factory.mktemp("test_tools")
    rng = np.random.default_rng(17)
    for i, n in enumerate((1500, 1800, 1200)):
        r, az = rng.uniform(2, 60, n), rng.uniform(0, 2 * np.pi, n)
        el = rng.uniform(-0.4, 0.2, n)
        pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                        r * np.sin(el)], 1)
        jwrite_ply(str(tmp / "data" / "seq00" / f"scan{i}.ply"), pts)
        write_ply_with_normals(str(tmp / "normals" / "seq00" / f"scan{i}.ply"), pts,
                               estimate_normals(pts, k=8, native=False))
    return tmp


def _gen_both(tmp_path, sweeps, flags):
    dirs = {}
    for pkg, mod in (("jax", jgene), ("port", tgene)):
        out = str(tmp_path / pkg)
        mod.main(["--type", "kitti", "--ori_dir", str(sweeps / "data" / "seq00" / "*.ply"),
                  "--out_dir", out, "--lidar_level", LEVEL, *flags])
        dirs[pkg] = out
    return dirs


def _compare_outputs(jdir, tdir):
    jfiles = sorted(os.listdir(jdir))
    assert jfiles == sorted(os.listdir(tdir)) and jfiles
    for name in jfiles:
        jp, tp = os.path.join(jdir, name), os.path.join(tdir, name)
        if name.endswith("_meta.npy"):
            jm, tm = np.load(jp), np.load(tp)
            assert jm.shape == tm.shape
            assert jm[0] == tm[0] and (len(jm) < 3 or jm[2] == tm[2])
            assert abs(jm[1] - tm[1]) <= REL * abs(jm[1]), (jm, tm)
        elif name.endswith("_manifest.npz"):
            jz, tz = np.load(jp), np.load(tp)
            assert sorted(jz.files) == sorted(tz.files)
            for k in jz.files:
                np.testing.assert_array_equal(tz[k], jz[k], err_msg=f"{name}:{k}")
        else:  # shards and _quant.ply
            with open(jp, "rb") as a, open(tp, "rb") as b:
                assert a.read() == b.read(), name
    return jfiles


@pytest.mark.parametrize("flags", [["--spher"], ["--cylin"], [], ["--spher", "--mullevel"]],
                         ids=["spher", "cylin", "cart", "spher-mullevel"])
def test_test_gene_writes_jax_packages_files(tmp_path, sweeps, flags):
    dirs = _gen_both(tmp_path, sweeps, flags)
    files = _compare_outputs(dirs["jax"], dirs["port"])
    shards = [f for f in files if f.endswith(".npy") and not f.endswith("_meta.npy")]
    assert len(shards) == 3 * (3 if "--mullevel" in flags else 1)
    assert all(f.startswith("seq00scan") for f in files)


def test_parts_cover_every_cloud_once(tmp_path, sweeps):
    """--parts i/3 writes cloud i only; the three parts together are the
    whole run's files, and each part equals scp_tpu's same part."""
    whole = set()
    for i in range(3):
        dirs = _gen_both(tmp_path / f"part{i}", sweeps, ["--spher", "--parts", f"{i}/3"])
        files = _compare_outputs(dirs["jax"], dirs["port"])
        assert {f[: len("seq00scan0")] for f in files} == {f"seq00scan{i}"}
        whole |= set(files)
    full = _gen_both(tmp_path / "all", sweeps, ["--spher"])
    assert whole == set(os.listdir(full["port"]))


def _printed(out: str):
    """[(D1, D2, chamfer)] of psnr_test's per-cloud lines, then the mean line."""
    pat = r"D1 (\S+)\s+D2 (\S+)\s+chamfer (\S+)"
    return [tuple(float(x) for x in m.groups()) for m in re.finditer(pat, out)]


@pytest.mark.parametrize("with_normals", [False, True])
def test_psnr_test_prints_jax_packages_numbers(tmp_path, sweeps, capsys, with_normals):
    dirs = _gen_both(tmp_path, sweeps, ["--spher"])
    ori = sweeps / ("normals" if with_normals else "data") / "seq00" / "*.ply"
    flags = ["--type", "kitti", "--ori_dir", str(ori)] + (["--with_normals"] if with_normals
                                                          else [])
    capsys.readouterr()
    jpsnr.main([*flags, "--quant_dir", dirs["jax"]])
    want = _printed(capsys.readouterr().out)
    got_ret = tpsnr.main([*flags, "--quant_dir", dirs["port"]])
    got = _printed(capsys.readouterr().out)
    assert len(want) == len(got) == 4  # three clouds and the mean
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert len(got_ret["d1"]) == 3 and np.isfinite(got_ret["d1"]).all()
    assert (np.array(got_ret["d2"]) > 0).all() == with_normals
    assert glob.glob(os.path.join(dirs["port"], "*_quant.ply"))
