"""The port's shard-preprocessing CLIs held against scp_tpu's on the CPU:
tools.preprocess writes the same shard names and arrays on small KITTI
.bin sweeps in the spherical, cylindrical and cartesian systems, skips the
clouds whose shards exist, and `--parts i/N` covers every cloud once;
tools.multi_preproc runs N copies with `--parts i/N`; gene_normals.main
writes scp_tpu's normals files.

scp_tpu runs with SCP_TPU_NO_NATIVE=1 (its native build shares one
<so>.tmp across test workers) and its metrics on scipy.
"""

import glob
import os
import sys

import numpy as np
import pytest

from scp_tpu.tools import gene_normals as jgene
from scp_tpu.tools import preprocess as jpre
from scp_tpu_torch.tools import gene_normals as tgene
from scp_tpu_torch.tools import multi_preproc as tmulti
from scp_tpu_torch.tools import preprocess as tpre

N_POINTS = 1500


@pytest.fixture(scope="module", autouse=True)
def jax_switches():
    from scp_tpu.native import metrics_native

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCP_TPU_NO_NATIVE", "1")
        mp.setattr(metrics_native, "available", lambda: False)
        yield


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """Four small LiDAR-like sweeps as KITTI .bin files in two sequences;
    returns the --ori_dir glob."""
    root = tmp_path_factory.mktemp("kitti")
    rng = np.random.default_rng(0)
    for seq, frames in (("00", 3), ("01", 1)):
        d = root / "sequences" / seq / "velodyne"
        d.mkdir(parents=True)
        for f in range(frames):
            r = rng.uniform(2.0, 60.0, N_POINTS)
            az = rng.uniform(0, 2 * np.pi, N_POINTS)
            el = rng.uniform(-0.4, 0.2, N_POINTS)
            pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                            r * np.sin(el), np.zeros(N_POINTS)], 1).astype(np.float32)
            pts.tofile(d / f"{f:06d}.bin")
    return str(root / "sequences" / "*" / "velodyne" / "*.bin")


def _shards(out_dir):
    return {os.path.basename(p): np.load(p) for p in glob.glob(os.path.join(out_dir, "*.npy"))}


@pytest.mark.parametrize("system", ["spher", "cylin", "cart"])
def test_preprocess_writes_jax_packages_shards(sweeps, tmp_path, capsys, system):
    flags = [f"--{system}"] if system != "cart" else []
    jpre.main(["--type", "kitti", "--ori_dir", sweeps, "--out_dir", str(tmp_path / "j"), *flags])
    tpre.main(["--type", "kitti", "--ori_dir", sweeps, "--out_dir", str(tmp_path / "t"), *flags])
    want, got = _shards(tmp_path / "j"), _shards(tmp_path / "t")
    assert len(want) == 4 and sorted(got) == sorted(want)
    assert {n.rsplit("_", 1)[0] for n in got} == {"00000000", "00000001", "00000002",
                                                 "01000000"}
    for name, w in want.items():
        assert got[name].dtype == w.dtype and np.array_equal(got[name], w), name
        assert w.shape[1:] == (4, 6) and int(name.rsplit("_", 1)[1][:-4]) == w.shape[0]
    # a second run skips every cloud and rewrites nothing
    stamps = {p: os.stat(p).st_mtime_ns for p in glob.glob(str(tmp_path / "t" / "*.npy"))}
    capsys.readouterr()
    tpre.main(["--type", "kitti", "--ori_dir", sweeps, "--out_dir", str(tmp_path / "t"), *flags])
    assert capsys.readouterr().out.count("Already exists") == 4
    assert {p: os.stat(p).st_mtime_ns for p in stamps} == stamps


def test_parts_cover_every_cloud_once(sweeps, tmp_path):
    names = []
    for part in ("0/2", "1/2"):
        out = str(tmp_path / part.replace("/", "of"))
        tpre.main(["--type", "kitti", "--spher", "--ori_dir", sweeps, "--out_dir", out,
                   "--parts", part])
        names += sorted(_shards(out))
    assert len(names) == len(set(names)) == 4
    for n, parts in ((4, "1/2"), (3, "0/2"), (3, "1/2"), (5, "2/3")):
        assert tpre.part_slice(n, parts) == jpre.part_slice(n, parts)
    assert tpre.part_slice(7, "-1/-1") == (0, 7, 0, 1)


def test_multi_preproc_runs_n_parts(tmp_path):
    log = tmp_path / "parts.txt"
    cmd = [sys.executable, "-c",
           f"import sys; open({str(log)!r}, 'a').write(sys.argv[-1] + '\\n')"]
    assert tmulti.commands(3, cmd) == [cmd + ["--parts", f"{i}/3"] for i in range(3)]
    assert tmulti.main(["3", *cmd]) == 0
    assert sorted(log.read_text().split()) == ["0/3", "1/3", "2/3"]
    assert tmulti.main(["2", sys.executable, "-c", "import sys; sys.exit(3)"]) == 3
    # one copy killed by a signal (as the OOM killer does), the other fine
    killed = ("import os, signal, sys\n"
              "if sys.argv[-1] == '1/2': os.kill(os.getpid(), signal.SIGKILL)")
    assert tmulti.main(["2", sys.executable, "-c", killed]) == 128 + 9


def test_an_interrupted_shard_write_leaves_no_shard(sweeps, tmp_path, monkeypatch, capsys):
    """A write cut in the middle leaves no `<name>_<N>.npy` (nor its
    temporary file), so the next run writes the shard instead of skipping it."""
    out = str(tmp_path / "out")
    first = sorted(glob.glob(sweeps))[:1]
    argv = ["--type", "kitti", "--spher", "--ori_dir", first[0], "--out_dir", out]

    def cut_save(fh, arr):
        fh.write(b"\x93NUMPY")
        raise KeyboardInterrupt

    with monkeypatch.context() as mp:
        mp.setattr(np, "save", cut_save)
        with pytest.raises(KeyboardInterrupt):
            tpre.main(argv)
    assert os.listdir(out) == []
    tpre.main(argv)
    assert "Already exists" not in capsys.readouterr().out
    jout = str(tmp_path / "jax")
    jpre.main(argv[:-1] + [jout])
    got, want = _shards(out), _shards(jout)
    assert list(got) == list(want) and all(np.array_equal(got[k], want[k]) for k in want)


def test_gene_normals_writes_jax_packages_files(sweeps, tmp_path):
    jgene.main(["--ori_dir", sweeps, "--out_dir", str(tmp_path / "j"), "--knn", "12"])
    tgene.main(["--ori_dir", sweeps, "--out_dir", str(tmp_path / "t"), "--knn", "12",
                "--parts", "0/1"])
    want = sorted(glob.glob(str(tmp_path / "j" / "*" / "*.ply")))
    got = sorted(glob.glob(str(tmp_path / "t" / "*" / "*.ply")))
    assert len(want) == 4
    assert [os.path.relpath(p, tmp_path / "t") for p in got] == [
        os.path.relpath(p, tmp_path / "j") for p in want]
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a
