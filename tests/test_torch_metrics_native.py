"""The port's native KD-tree metrics (scp_tpu_torch/native/src/metrics.cpp,
bound by native/metrics_native.py) against the port's scipy path
(`native=False`) and scp_tpu's scipy path on the CPU.

D1 and Chamfer are sums of nearest distances, which do not depend on
which of two equidistant neighbours a tree returns: within 1e-9 relative
(the native sums run in OpenMP's order, which may differ from run to
run in the last bit).  D2 projects the offset to the
chosen neighbour (and, B -> A, that neighbour's normal), so where a query
has two nearest points at one distance two correct trees may pick
different ones.  On clouds without ties D2 is held to 1e-9 too; on
integer clouds, full of ties, the two D2 means may differ by at most the
tied queries' share: each tied term is a squared projection of an offset
of length d, so it lies in [0, d^2], and the bound is sum(d_i^2) / n over
the tied queries i.  The k-NN of estimate_normals returns the same
neighbour sets as scipy's where the k-th distance is not tied, and the
normals agree within 1e-6.  A failed build raises.

scp_tpu's metrics run with its native library switched off
(`metrics_native.available` patched to False, SCP_TPU_NO_NATIVE=1): its
build shares one <so>.tmp across test workers."""

import os
import shutil

import numpy as np
import pytest

from scp_tpu_torch import metrics as tmetrics
from scp_tpu_torch.native import build, metrics_native

REL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def jax_scipy():
    from scp_tpu.native import metrics_native as jnative

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCP_TPU_NO_NATIVE", "1")
        mp.setattr(jnative, "available", lambda: False)
        yield


def _lidar(rng, n):
    r, az, el = rng.uniform(2, 60, n), rng.uniform(0, 2 * np.pi, n), rng.uniform(-0.4, 0.2, n)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                     r * np.sin(el)], 1)


def _close(got, want, rel=REL):
    assert abs(got - want) <= rel * abs(want), (got, want)


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(12)
    a = _lidar(rng, 3000)
    b = np.round(a * 8) / 8  # a quantized reconstruction
    b = np.unique(b, axis=0)
    normals = tmetrics.estimate_normals(a, k=12, native=False).astype(np.float64)
    return a, b, normals


@pytest.mark.parametrize("with_normals", [False, True])
@pytest.mark.parametrize("direction", ["ab", "ba"])
def test_mse_directional_matches_scipy(clouds, with_normals, direction):
    from scp_tpu import metrics as jmetrics

    a, b, normals = clouds
    nrm = normals if with_normals else None
    q, ref = (a, b) if direction == "ab" else (b, a)
    of_nn = direction == "ba"
    got = metrics_native.mse_directional(q, ref, nrm, of_nn)
    scipy_port = tmetrics.mse_directional(q, ref, nrm, of_nn, native=False)
    scipy_jax = jmetrics.mse_directional(q, ref, nrm, of_nn)
    assert scipy_port == scipy_jax
    before = metrics_native.calls
    default = tmetrics.mse_directional(q, ref, nrm, of_nn)
    assert metrics_native.calls == before + 1  # the default is native
    _close(default[0], got[0])
    _close(got[0], scipy_port[0])
    if with_normals:
        _close(got[1], scipy_port[1])
    else:
        assert got[1] == scipy_port[1] == 0.0


def test_d2_ties_within_the_tied_share():
    """Integer clouds: many queries have two nearest points at one
    distance; D1 stays within 1e-9, D2 within the tied queries' bound."""
    from scipy.spatial import KDTree

    rng = np.random.default_rng(13)
    a = np.unique(rng.integers(0, 40, (4000, 3)), axis=0).astype(np.float64)
    b = np.unique(rng.integers(0, 40, (3000, 3)) + 0.5 * rng.integers(0, 2, (3000, 3)),
                  axis=0)
    normals = tmetrics.estimate_normals(a, k=12, native=False).astype(np.float64)
    for q, ref, of_nn in ((a, b, False), (b, a, True)):
        got = metrics_native.mse_directional(q, ref, normals, of_nn)
        want = tmetrics.mse_directional(q, ref, normals, of_nn, native=False)
        _close(got[0], want[0])
        d, _ = KDTree(ref).query(q, k=2)
        tied = d[:, 0] == d[:, 1]
        bound = float((d[tied, 0] ** 2).sum()) / len(q)
        print(f"{tied.mean():.3f} of the queries tied; D2 native {got[1]}, scipy {want[1]}, "
              f"bound {bound}")
        assert tied.any()
        assert abs(got[1] - want[1]) <= bound + REL * want[1]


def test_psnr_and_chamfer_match_scipy(clouds):
    from scp_tpu import metrics as jmetrics

    a, b, normals = clouds
    for nrm in (None, normals):
        got = tmetrics.d1_d2_psnr(a, b, 59.7, normals=nrm)
        want = tmetrics.d1_d2_psnr(a, b, 59.7, normals=nrm, native=False)
        assert want == jmetrics.d1_d2_psnr(a, b, 59.7, normals=nrm)
        _close(got[0], want[0])
        if nrm is not None:
            _close(got[1], want[1])
    got = tmetrics.chamfer(a, b, scale=2.0)
    want = tmetrics.chamfer(a, b, scale=2.0, native=False)
    assert want == jmetrics.chamfer(a, b, scale=2.0)
    _close(got, want)
    before = metrics_native.calls
    tmetrics.chamfer(a, b)  # two native passes, one per direction
    assert metrics_native.calls == before + 2


def test_knn_and_normals_match_scipy(clouds):
    from scipy.spatial import KDTree

    from scp_tpu import metrics as jmetrics

    a, _, _ = clouds
    k = 12
    got = metrics_native.knn(a, a, k)
    d, want = KDTree(a).query(a, k=k + 1)
    untied = d[:, k - 1] < d[:, k]
    assert untied.mean() > 0.99
    np.testing.assert_array_equal(np.sort(got[untied], 1), np.sort(want[untied, :k], 1))
    dist = np.linalg.norm(a[got] - a[:, None], axis=-1)
    np.testing.assert_allclose(dist, d[:, :k], rtol=0, atol=1e-12)
    nt = tmetrics.estimate_normals(a, k=k)
    np.testing.assert_allclose(nt, tmetrics.estimate_normals(a, k=k, native=False), atol=1e-6)
    np.testing.assert_array_equal(tmetrics.estimate_normals(a, k=k, native=False),
                                  jmetrics.estimate_normals(a, k=k))


def test_bad_inputs_and_failed_build_raise(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match=r"\(n, 3\)"):
        metrics_native.mean_nn_dist(np.zeros((4, 2)), np.zeros((4, 3)))
    with pytest.raises(ValueError, match="empty"):
        metrics_native.mse_directional(np.zeros((0, 3)), np.zeros((4, 3)))
    with pytest.raises(ValueError, match="k="):
        metrics_native.knn(np.zeros((4, 3)), np.zeros((2, 3)), 5)
    bad = tmp_path / "src"
    bad.mkdir()
    for name in build.SOURCES:
        shutil.copyfile(os.path.join(build.SRC_DIR, name), bad / name)
    (bad / "metrics.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(build, "SRC_DIR", str(bad))
    out = str(tmp_path / "out")
    with pytest.raises(build.NativeBuildError, match="g.. failed"):
        metrics_native._lib(out)
    assert not metrics_native.available(out)
    assert not any(p.name.endswith(".tmp") for p in (tmp_path / "out").iterdir())
    # the metrics raise instead of taking scipy's path on their own
    with pytest.raises(build.NativeBuildError):
        tmetrics.chamfer(np.zeros((4, 3)), np.ones((4, 3)))
