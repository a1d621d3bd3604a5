"""The port's native octree builder (scp_tpu_torch/native): its OctreeArrays
equal the port's numpy builder's and scp_tpu's (numpy path, SCP_TPU_NO_NATIVE
set around it) on clouds of 100, 3,000 and 50,000 points in the three
coordinate systems; four processes that build it at once into an empty
directory all load it; the build writes nothing under HOME (scp_tpu's
~/.cache/scp_tpu); a failed build raises."""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from scp_tpu.core import octree as joctree
from scp_tpu.core.preprocess import preprocess_points as jpreprocess
from scp_tpu_torch.core import octree as toctree
from scp_tpu_torch.core.morton import morton_encode
from scp_tpu_torch.core.preprocess import preprocess_points as tpreprocess
from scp_tpu_torch.native import build, octree_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cloud(rng, n):
    r, az, el = rng.uniform(2, 60, n), rng.uniform(0, 2 * np.pi, n), rng.uniform(-0.4, 0.2, n)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                     r * np.sin(el)], 1)


def _assert_same(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("n", [100, 3000, 50_000])
@pytest.mark.parametrize("system", ["cart", "cylin", "spher"])
def test_native_octree_equals_numpy_and_jax(monkeypatch, n, system):
    monkeypatch.setenv("SCP_TPU_NO_NATIVE", "1")  # scp_tpu's shared <so>.tmp build
    pts = _cloud(np.random.default_rng(n), n)
    qs = 0.05 if system == "cart" else 400.0 / (2**14 - 1)
    offset = "min" if system == "cart" else 0
    res = tpreprocess(pts, system=system, qs=qs, offset=offset, native=False)
    q = res.grid_points
    bits = res.tree.max_level
    keys = np.unique(morton_encode(q, bits))
    native = octree_native.build_from_keys(keys, bits)
    _assert_same(native, toctree._build_from_keys_numpy(keys, bits))
    _assert_same(native, joctree.build_octree(q))
    # build_octree takes the native builder above NATIVE_MIN_KEYS keys
    calls = octree_native.build_from_keys.calls
    _assert_same(toctree.build_octree(q), native)
    assert octree_native.build_from_keys.calls == calls + (len(keys) > toctree.NATIVE_MIN_KEYS)
    # and the contexts of a whole preprocessing run agree with scp_tpu's
    ctx = tpreprocess(pts, system=system, qs=qs, offset=offset).context
    np.testing.assert_array_equal(
        ctx, jpreprocess(pts, system=system, qs=qs, offset=offset).context)


_BUILD_ONE = r'''
import sys
from scp_tpu_torch.native import build, octree_native
import numpy as np
d = sys.argv[1]
lib = build.load_library(d)
t = octree_native.build_from_keys(np.arange(5000, dtype=np.uint64) * 7, 8, build_dir=d)
print("LOADED", build.lib_path(d), t.num_nodes)
'''


def test_parallel_builds_into_an_empty_dir_all_load(tmp_path):
    """Four processes start the build at once into an empty directory, each
    compiling into a temp file of its own; all four load the library, and
    the directory ends with the library alone (no temp files).  HOME points
    into the test dir: the build writes nothing there (scp_tpu's cache is
    ~/.cache/scp_tpu)."""
    out = tmp_path / "build"
    home = tmp_path / "home"
    home.mkdir()
    env = {**os.environ, "PYTHONPATH": ROOT, "HOME": str(home)}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, str(out)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    results = [p.communicate(timeout=300) for p in procs]
    for p, (stdout, stderr) in zip(procs, results):
        assert p.returncode == 0, stderr[-3000:]
        assert "LOADED" in stdout
    assert len({r[0].split()[1] for r in results}) == 1
    assert os.listdir(out) == [os.path.basename(build.lib_path(str(out)))]
    assert list(home.iterdir()) == []
    assert build.BUILD_DIR == os.path.join(ROOT, "scp_tpu_torch", "_build")


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "src"
    bad.mkdir()
    (bad / "octree.cpp").write_text("this is not C++;\n")
    # the library's other sources (the range coder, the metrics) as they are
    for name in build.SOURCES:
        if name != "octree.cpp":
            shutil.copyfile(os.path.join(build.SRC_DIR, name), bad / name)
    monkeypatch.setattr(build, "SRC_DIR", str(bad))
    with pytest.raises(build.NativeBuildError, match="g.. failed"):
        build.load_library(str(tmp_path / "out"))
    assert not octree_native.available(str(tmp_path / "out"))
    # the port's builder does not fall back to numpy when asked for native
    with pytest.raises(build.NativeBuildError):
        octree_native.build_from_keys(np.arange(3000, dtype=np.uint64), 6,
                                      build_dir=str(tmp_path / "out"))
    assert not any(p.name.endswith(".tmp") for p in (tmp_path / "out").iterdir())
