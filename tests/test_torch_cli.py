"""The port's codec CLI (scp_tpu_torch.cli.{encode,decode,selftest}) held
against scp_tpu's on the CPU, on one narrow EHEM run saved twice from the
same parameters: an orbax run dir for scp_tpu, and a port run dir (its
config through scp_tpu_torch.config, the parameters through the weight
converter into a torch.save checkpoint).

scp_tpu runs with SCP_STATIC_KNN=1 and SCP_CODEC_DTYPE=f32 (never "0": it
reads the switches with bool()) and SCP_TPU_NO_NATIVE=1, so both packages
take scipy's KD-tree for the metrics; the port with `--static-knn --dtype
f32 --device cpu`.  On a .ply, on cached shards written by scp_tpu's own
test_gene, and with --mullevel: header fields equal except the backend
stamps, decoded points equal (scp_tpu's computed from its header and
octree, as its lossless decoder returns them), and Chamfer and PSNR D1 / D2 (normals from
write_ply_with_normals) within 1e-9 relative in the results txt of each
CLI.  The payload's bits (and so bpp) agree within RATE_RTOL: the port's
CDF rows match JAX's only within rounding (the model's f32 logits agree
within tests/test_torch_models.py's LOGIT_TOL; on these clouds 13-26% of
the coded symbols get a start or frequency 1-3 units of 65536 apart, 0.3
ideal bits in 77,647), so the byte counts may differ by a byte or two.
What the CLI adds to the codec is held exactly instead: its payload is
byte for byte the port codec's in-process stream of the same slices.  The
port's decoder refuses scp_tpu's stream, and its selftest passes.  EHEM's
staged and full coding modes (`--ehem-mode`; scp_tpu's SCP_CODEC_MODE) are
held the same way, with --mullevel and on shards of the port's test_gene.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from scp_tpu.cli import encode as jencode_cli
from scp_tpu.codec.bitstream import unpack_stream as junpack
from scp_tpu.config import Config as JConfig
from scp_tpu.config import load_config as jload_config
from scp_tpu.config import save_config as jsave_config
from scp_tpu.core.pointcloud import write_ply as jwrite_ply
from scp_tpu.models import build_model
from scp_tpu.tools import test_gene
from scp_tpu_torch import config as tconfig
from scp_tpu_torch import weights
from scp_tpu_torch.cli import decode as tdecode_cli
from scp_tpu_torch.cli import encode as tencode_cli
from scp_tpu_torch.cli import selftest as tselftest
from scp_tpu_torch.cli.codec_common import CodecSession
from scp_tpu_torch.codec.bitstream import unpack_stream as tunpack
from scp_tpu_torch.codec.slices import split_levels
from scp_tpu_torch.core.pointcloud import read_points
from scp_tpu_torch.metrics import estimate_normals
from scp_tpu_torch.models.ehem import EHEM as TEHEM
from scp_tpu_torch.tools.gene_normals import write_ply_with_normals
from test_torch_pallas_config import random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
REL = 1e-9
RATE_RTOL = 1e-3  # payload bits vs JAX's (chip_smoke.py's BPP_RTOL); see the docstring
SWIN = dict(embed_dim=64, self_depths=[2, 2], cross_depths=[1], num_heads=2, window_size=16,
            mlp_ratio=2.0)
PORT_FLAGS = ["--static-knn", "--dtype", "f32", "--device", "cpu"]
CKPT_NAME = "epoch=0-step=1"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run thousands of small torch ops,
    which crawl when every test worker's thread pool spans all the cores
    (the suite runs several workers on one machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_switches():
    """scp_tpu's switches, and its metrics on scipy: its native build shares
    one <so>.tmp across test workers, and a library another test of the
    worker loaded would take the metrics off scipy."""
    from scp_tpu.native import metrics_native

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCP_STATIC_KNN", "1")
        mp.setenv("SCP_CODEC_DTYPE", "f32")
        mp.setenv("SCP_TPU_NO_NATIVE", "1")
        mp.setattr(metrics_native, "available", lambda: False)
        yield


def lidar_points(rng, n):
    r = rng.uniform(2.0, 60.0, n)
    az = rng.uniform(0, 2 * np.pi, n)
    el = rng.uniform(-0.4, 0.2, n)
    return np.stack(
        [r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], 1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX checkpoint path, port checkpoint path, data dir) of one narrow
    EHEM (context 64, embed 64, depths (2, 2) / (1,)) and two clouds."""
    from scp_tpu.train import checkpoints
    from scp_tpu.train.trainer import TrainState

    tmp = tmp_path_factory.mktemp("cli")
    cfg = jload_config("train_kitti_ehem.yaml", config_dir=CONFIGS)
    cfg.model.context_size = 64
    cfg.model.swin = JConfig.wrap(dict(SWIN))
    cfg.bf16 = False
    jrun = str(tmp / "jax_run")
    jsave_config(cfg, jrun)
    variables = random_variables(np.random.default_rng(3), build_model(cfg))
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state={}, step=np.zeros(()))
    jck = checkpoints.save(jrun, state, {}, epoch=0, step=1, final=True)

    tcfg = tconfig.load_config("train_kitti_ehem.yaml", CONFIGS)
    tcfg.model.context_size = 64
    tcfg.model.swin = tconfig.Config.wrap(dict(SWIN))
    trun = str(tmp / "port_run")
    tconfig.save_config(tcfg, trun)
    tm = weights.load_into(TEHEM.from_config(tcfg, torch.float32, device="cpu"), variables)
    tck = os.path.join(trun, "ckpt", CKPT_NAME + ".pt")
    os.makedirs(os.path.dirname(tck))
    torch.save({"model": tm.state_dict(), "meta": {"epoch": 0, "step": 1}}, tck)

    data = tmp / "seq00"  # a KITTI layout: the shards are named seq00<stem>
    data.mkdir()
    rng = np.random.default_rng(11)
    # at KITTI's L12 step the deep levels pass 512 nodes, so the model
    # codes them (smaller levels take the fixed uniform prior)
    for name, n in (("scan0", 1200), ("scan1", 1500)):
        pts = lidar_points(rng, n)
        jwrite_ply(str(data / f"{name}.ply"), pts)
        ndir = tmp / "normals"
        write_ply_with_normals(str(ndir / f"{name}.ply"), pts, estimate_normals(pts, k=8))
    return jck, tck, str(data), str(tmp / "normals")


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _results_txt(path):
    """{key: value} of a results txt (the lines after the first)."""
    out = {}
    with open(path) as fh:
        for line in fh.read().splitlines()[1:]:
            if ": " in line:
                k, v = line.split(": ", 1)
                out[k] = v
    return out


def _run_both(tmp_path, monkeypatch, runs, files, extra, name, port_extra=()):
    """Encode `files` (a glob) with both CLIs into their own dirs (the port
    also given `port_extra`); returns {package: ([bin paths], results txt
    dict)}."""
    jck, tck, _, _ = runs
    out = {}
    for pkg, cli, ck, flags in (("jax", jencode_cli, jck, []),
                                ("port", tencode_cli, tck, [*PORT_FLAGS, *port_extra])):
        work = tmp_path / f"{name}_{pkg}"
        work.mkdir()
        monkeypatch.chdir(work)
        cli.main(["--ckpt_path", ck, "--type", "kitti", "--spher", "--test_files", files,
                  "--out_dir", str(work / "bins"), *extra, *flags])
        bins = sorted(p for p in os.listdir(work / "bins") if p.endswith(".bin"))
        out[pkg] = ([str(work / "bins" / b) for b in bins],
                    _results_txt(work / f"test_results_same_kitti_{_level(extra)}.txt"))
    return out


def _level(extra):
    return extra[extra.index("--lidar_level") + 1]


def _check_streams(out):
    """Header fields equal except the backend stamps; payload bits equal."""
    (jbins, jtxt), (tbins, ttxt) = out["jax"], out["port"]
    assert [os.path.basename(b) for b in jbins] == [os.path.basename(b) for b in tbins]
    headers = []
    for jb, tb in zip(jbins, tbins):
        jh, jp = junpack(_read(jb))
        th, tp = tunpack(_read(tb))
        assert th.backend == "torch-cpu" and jh.backend == "cpu"
        assert th.coding_params != jh.coding_params
        for f in dataclasses.fields(th):
            if f.name in ("backend", "coding_params"):
                continue
            a, b = getattr(jh, f.name), getattr(th, f.name)
            if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)
            else:
                assert a == b, f.name
        assert abs(len(tp) - len(jp)) * 8 <= RATE_RTOL * len(jp) * 8, (len(tp), len(jp))
        headers.append((th, tp))
    return headers


def _check_metrics(out, keys):
    jtxt, ttxt = out["jax"][1], out["port"][1]
    assert jtxt["sample number"] == ttxt["sample number"]
    for k in keys:
        if jtxt[k] == "N/A":
            assert ttxt[k] == "N/A", k
            continue
        a, b = float(jtxt[k]), float(ttxt[k])
        assert abs(a - b) <= (RATE_RTOL if k == "bpp" else REL) * abs(a), (k, a, b)


def _check_in_process(session, header, payload, ori_file, lidar_level, mullevel):
    """The CLI's payload is the port codec's own stream of the same slices,
    byte for byte (one encode_into per subtree on one encoder)."""
    results, _ = session.preproc(ori_file, "kitti", lidar_level, "spher", mullevel=mullevel)
    enc = session.codec.new_stream_encoder()
    for ctx, _grid in results:
        slices = split_levels(ctx, angular=True, lidar_level_clip=lidar_level)
        session.codec.encode_into(enc, slices, lidar_clip=lidar_level)
    want, _, n_sym = session.codec.finish_stream(enc)
    assert payload == want and header.n_sym == n_sym


@pytest.fixture(scope="module")
def sessions(runs):
    """A session of each package: scp_tpu's for its preprocessing (numpy;
    its codec is never compiled here), the port's to decode."""
    from scp_tpu.cli.codec_common import CodecSession as JSession

    jck, tck, _, _ = runs
    return (JSession(jck, jencode_cli.resolve_run(jck)[0]),
            CodecSession(tck, tencode_cli.resolve_run(tck)[0], dtype="f32", static_knn=True,
                         device="cpu"))


def _decode_both(sessions, binfile_j, binfile_t, ori_file, lidar_level, mullevel, gt=None):
    """What scp_tpu's decode of its stream returns, and the port's decode
    of its own (by sessions[1]).  scp_tpu's decoder is lossless (its own
    tests), so its output is its grids' from_grid of its deoctree of the
    encoded occupancies: computed so, with scp_tpu's numpy functions, from
    its header and its preprocessing, without compiling its codec again."""
    from scp_tpu.core import deoctree as jdeoctree

    jheader, _ = junpack(_read(binfile_j))
    results, _ = sessions[0].preproc(ori_file, "kitti", lidar_level, "spher",
                                     mullevel=mullevel)
    jpts = np.vstack([g.from_grid(jdeoctree(ctx[:, -1, 0].astype(np.int64)))
                      for (ctx, _), g in zip(results, jheader.grids())]).astype(np.float32)
    tpts, _ = sessions[1].decode_file(binfile_t, ground_truth=gt)
    return jpts, tpts


def test_ply_encode_decode_matches_jax(tmp_path, monkeypatch, runs, sessions):
    jck, tck, data, normals = runs
    out = _run_both(tmp_path, monkeypatch, runs, os.path.join(data, "scan0.*"),
                    ["--lidar_level", "12", "--normals_dir", normals], "ply")
    ((header, payload),) = _check_streams(out)
    _check_in_process(sessions[1], header, payload, os.path.join(data, "scan0.ply"), 12, False)
    _check_metrics(out, ("bpp", "chamfer_dist", "PSNR", "PSNR_D2"))
    assert np.isfinite(float(out["port"][1]["PSNR_D2"]))
    jpts, tpts = _decode_both(sessions, out["jax"][0][0], out["port"][0][0],
                              os.path.join(data, "scan0.ply"), 12, False)
    np.testing.assert_array_equal(tpts, jpts)

    # the port's decode CLI refuses the stream scp_tpu wrote (backend stamp)
    with pytest.raises(RuntimeError, match="backend 'cpu'"):
        tdecode_cli.main(["--ckpt_path", tck, "--type", "kitti", "--test_files",
                          os.path.join(data, "scan0.ply"), "--bin_dir",
                          os.path.dirname(out["jax"][0][0]), *PORT_FLAGS])
    # and a port stream decoded with other settings (bf16 instead of f32)
    with pytest.raises(RuntimeError, match="dtype=float32"):
        tdecode_cli.main(["--ckpt_path", tck, "--type", "kitti", "--test_files",
                          os.path.join(data, "scan0.ply"), "--bin_dir",
                          os.path.dirname(out["port"][0][0]), "--static-knn",
                          "--device", "cpu"])


def test_cached_shards_encode_decode_matches_jax(tmp_path, monkeypatch, runs, sessions):
    """Shards, _meta.npy and _manifest.npz from scp_tpu's own test_gene; the
    decode CLI checks the codes against the shard."""
    jck, tck, data, _ = runs
    pre = str(tmp_path / "pre")
    test_gene.main(["--type", "kitti", "--ori_dir", os.path.join(data, "scan1.ply"),
                    "--out_dir", pre, "--spher", "--lidar_level", "12"])
    out = _run_both(tmp_path, monkeypatch, runs, os.path.join(data, "scan1.*"),
                    ["--lidar_level", "12", "--preproc_path", pre + "/"], "cached")
    _check_streams(out)
    _check_metrics(out, ("bpp", "chamfer_dist", "PSNR"))
    assert out["port"][1]["PSNR"] == "N/A"
    decoded = tdecode_cli.main(["--ckpt_path", tck, "--type", "kitti", "--test_files",
                                os.path.join(data, "scan1.ply"), "--preproc_path", pre,
                                "--bin_dir", os.path.dirname(out["port"][0][0]),
                                *PORT_FLAGS])
    assert len(decoded) == 1
    pts = read_points(decoded[0]["out_ply"])
    quant = read_points(os.path.join(pre, "seq00scan1_quant.ply"))
    np.testing.assert_allclose(np.sort(pts.astype(np.float64), axis=0),
                               np.sort(quant.astype(np.float64), axis=0), atol=1e-4)
    gt = np.load(os.path.join(pre, "seq00scan1.npy"))[:, -1, 0].astype(np.int16) - 1
    jpts, tpts = _decode_both(sessions, out["jax"][0][0], out["port"][0][0],
                              os.path.join(data, "scan1.ply"), 12, False, gt)
    np.testing.assert_array_equal(tpts, jpts)


def test_mullevel_encode_decode_matches_jax(tmp_path, monkeypatch, runs, sessions):
    """Three subtrees through one stream (encode_into three times), decoded
    subtree by subtree with one decoder."""
    jck, tck, data, _ = runs
    out = _run_both(tmp_path, monkeypatch, runs, os.path.join(data, "scan1.*"),
                    ["--lidar_level", "12", "--mullevel"], "mullevel")
    ((header, payload),) = _check_streams(out)
    assert len(header.subtree_sizes) == 3
    _check_in_process(sessions[1], header, payload, os.path.join(data, "scan1.ply"), 12, True)
    _check_metrics(out, ("bpp", "chamfer_dist", "PSNR"))
    jpts, tpts = _decode_both(sessions, out["jax"][0][0], out["port"][0][0],
                              os.path.join(data, "scan1.ply"), 12, True)
    np.testing.assert_array_equal(tpts, jpts)


def test_octattn_flags_and_runs_are_refused(runs, octattn_run, tmp_path):
    """What the CLIs refuse: OctAttention's schedule flags on an EHEM run
    (they would be ignored), and EHEM's --ehem-mode on an OctAttention run
    (it picks its schedule with --incremental / --octattn-coder)."""
    _, tck, data, _ = runs
    for flag in ("--incremental", "--sequential"):
        with pytest.raises(ValueError, match="OctAttention"):
            tencode_cli.main(["--ckpt_path", tck, "--type", "kitti", "--spher", "--test_files",
                              os.path.join(data, "scan0.ply"), "--out_dir", str(tmp_path),
                              flag, *PORT_FLAGS])
    ck, ply, _, _ = octattn_run
    for mode in ("rans", "staged", "full"):
        with pytest.raises(ValueError, match="--ehem-mode is EHEM's"):
            tencode_cli.main(["--ckpt_path", ck, "--type", "kitti", "--spher", "--test_files",
                              ply, "--out_dir", str(tmp_path), "--ehem-mode", mode,
                              "--device", "cpu"])
    with pytest.raises(ValueError, match="--ehem-mode is EHEM's"):
        tdecode_cli.main(["--ckpt_path", ck, "--type", "kitti", "--test_files", ply,
                          "--bin_dir", str(tmp_path), "--ehem-mode", "staged", "--device", "cpu"])


@pytest.mark.parametrize("mode, mullevel", [("staged", True), ("full", False)])
def test_host_coder_modes_encode_decode_match_jax(tmp_path, monkeypatch, runs, sessions, mode,
                                                  mullevel):
    """--ehem-mode staged / full through both CLIs (scp_tpu's reads
    SCP_CODEC_MODE): the header names the mode, the payload is the port
    codec's in-process stream of the same slices, byte for byte, and its
    bits are within RATE_RTOL of scp_tpu's.  A session started in rans
    mode decodes it in the header's mode (lossless, the points scp_tpu's
    decoder returns).  Without --mullevel the shards come from the port's
    own tools.test_gene, which both CLIs read, and the decode CLI checks
    the codes against them."""
    from scp_tpu_torch.tools import test_gene as ttest_gene

    jck, tck, data, _ = runs
    monkeypatch.setenv("SCP_CODEC_MODE", mode)
    extra = ["--lidar_level", "12"]
    pre = str(tmp_path / "pre")
    if mullevel:
        extra.append("--mullevel")
    else:
        ttest_gene.main(["--type", "kitti", "--ori_dir", os.path.join(data, "scan1.ply"),
                         "--out_dir", pre, "--spher", "--lidar_level", "12"])
        extra += ["--preproc_path", pre + "/"]
    out = _run_both(tmp_path, monkeypatch, runs, os.path.join(data, "scan1.*"), extra, mode,
                    port_extra=["--ehem-mode", mode])
    ((header, payload),) = _check_streams(out)
    assert header.coding_mode == mode
    assert len(header.subtree_sizes) == (3 if mullevel else 1)
    run_dir = tencode_cli.resolve_run(tck)[0]
    moded = CodecSession(tck, run_dir, dtype="f32", static_knn=True, ehem_mode=mode,
                         device="cpu")
    assert moded.codec.mode == mode
    _check_in_process(moded, header, payload, os.path.join(data, "scan1.ply"), 12, mullevel)
    assert header.n_sym == moded.codec.ac_symbols_per_node * sum(header.subtree_sizes)
    _check_metrics(out, ("bpp", "chamfer_dist", "PSNR"))
    rans_session = CodecSession(tck, run_dir, dtype="f32", static_knn=True, device="cpu")
    gt = None
    if not mullevel:
        gt = np.load(os.path.join(pre, "seq00scan1.npy"))[:, -1, 0].astype(np.int16) - 1
        (dec,) = tdecode_cli.main(["--ckpt_path", tck, "--type", "kitti", "--test_files",
                                   os.path.join(data, "scan1.ply"), "--preproc_path", pre,
                                   "--bin_dir", os.path.dirname(out["port"][0][0]),
                                   *PORT_FLAGS])
        quant = read_points(os.path.join(pre, "seq00scan1_quant.ply"))
        np.testing.assert_allclose(np.sort(dec["points"].astype(np.float64), axis=0),
                                   np.sort(quant.astype(np.float64), axis=0), atol=1e-4)
    jpts, tpts = _decode_both((sessions[0], rans_session), out["jax"][0][0], out["port"][0][0],
                              os.path.join(data, "scan1.ply"), 12, mullevel, gt)
    assert rans_session.codec.mode == mode
    np.testing.assert_array_equal(tpts, jpts)


@pytest.fixture(scope="module")
def octattn_run(tmp_path_factory):
    """A tiny OctAttention port run dir (configs/train_kitti.yaml at narrow
    widths, context 32, weights drawn from a seed) and a 200-point KITTI-
    like cloud with its shard for the decoder's ground-truth check."""
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points
    from scp_tpu_torch.models import build_model as tbuild_model
    from scp_tpu_torch.models.layers import flax_init_

    tmp = tmp_path_factory.mktemp("octattn_cli")
    cfg = tconfig.load_config("train_kitti.yaml", CONFIGS)
    for k, v in dict(context_size=32, occ_embed_dim=16, level_embed_dim=4, octant_embed_dim=4,
                     abs_pos_embed_dim=8, layer_num=2, head_num=2,
                     hidden_dimension=64).items():
        cfg.model[k] = v
    run = str(tmp / "run")
    tconfig.save_config(cfg, run)
    model = flax_init_(tbuild_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    ck = os.path.join(run, "ckpt", CKPT_NAME + ".pt")
    os.makedirs(os.path.dirname(ck))
    torch.save({"model": model.state_dict(), "meta": {"epoch": 0, "step": 1}}, ck)
    data = tmp / "seq00"
    data.mkdir()
    pts = lidar_points(np.random.default_rng(5), 200)
    jwrite_ply(str(data / "scan.ply"), pts)
    res = preprocess_points(read_points(str(data / "scan.ply")), system="spher", qs=kitti_qs(6))
    shards = tmp / "shards"
    shards.mkdir()
    np.save(shards / "seq00scan.npy", res.context)
    return ck, str(data / "scan.ply"), str(shards), res


@pytest.mark.parametrize("schedule, flags", [
    ("rans", ["--incremental"]),
    ("incr", ["--incremental", "--octattn-coder", "full"]),
    ("full", []),
])
def test_octattn_cli_roundtrip(octattn_run, tmp_path, monkeypatch, schedule, flags):
    """encode -> decode through cli.encode / cli.decode on a tiny
    OctAttention run, in each schedule: the header names the schedule and
    an f32 stamp (OctAttention's default dtype), the decode is lossless
    against the shard and needs no --incremental; a window-schedule stream
    decoded with another window is refused."""
    ck, ply, shards, res = octattn_run
    monkeypatch.chdir(tmp_path)
    bins = str(tmp_path / "bins")
    common = ["--ckpt_path", ck, "--type", "kitti", "--device", "cpu", "--test_files", ply]
    (stats,) = tencode_cli.main([*common, "--lidar_level", "6", "--spher", "--out_dir", bins,
                                 *flags])
    header, payload = tunpack(_read(stats["outputfile"]))
    assert header.coding_mode == schedule and header.backend == "torch-cpu"
    assert header.coding_params.startswith("dtype=float32")
    assert stats["oct_num"] == res.context.shape[0] and stats["bits"] == len(payload) * 8
    (dec,) = tdecode_cli.main([*common, "--preproc_path", shards, "--bin_dir", bins])
    np.testing.assert_allclose(np.sort(dec["points"].astype(np.float64), axis=0),
                               np.sort(res.recon_points.astype(np.float64), axis=0), atol=1e-4)
    if schedule == "full":
        with pytest.raises(RuntimeError, match="window=fast"):
            tdecode_cli.main([*common, "--bin_dir", bins, "--sequential"])


def test_sessions_refuse_orbax_dirs_and_need_the_card(runs, tmp_path):
    """scp_tpu's orbax run dir cannot be read by the port (no orbax where it
    runs); without --device cpu the CLIs take the card, and with no card
    they raise instead of falling back to the CPU."""
    jck, tck, data, _ = runs
    with pytest.raises(ValueError, match="orbax"):
        CodecSession(jck, tencode_cli.resolve_run(tck)[0], device="cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA device"):
        tencode_cli.main(["--ckpt_path", tck, "--type", "kitti", "--spher", "--static-knn",
                          "--test_files", os.path.join(data, "scan0.ply"),
                          "--out_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA device"):
        tdecode_cli.main(["--ckpt_path", tck, "--type", "kitti", "--test_files",
                          os.path.join(data, "scan0.ply"), "--bin_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA device"):
        tselftest.main([])


def test_selftest_prints_lossless_roundtrip(capsys):
    assert tselftest.main(["--device", "cpu"]) == 0
    assert "LOSSLESS ROUNDTRIP OK" in capsys.readouterr().out


def test_selftest_octattn_prints_lossless_roundtrip(capsys):
    assert tselftest.main(["--model", "octattn", "--device", "cpu"]) == 0
    assert "LOSSLESS ROUNDTRIP OK  model=octattn" in capsys.readouterr().out


def test_bench_measure_keeps_the_best_lossless_pass():
    """tools/bench.py's measurement on a CPU rehearsal (a narrow model, a
    small cloud whose levels all take the uniform prior, so the passes
    cost little): a warm pass, then the timed ones, the best kept; the
    record has the root bench.py's keys.  Its main() needs the card."""
    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.codec.slices import split_levels as tsplit
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points
    from scp_tpu_torch.tools import bench

    torch.manual_seed(0)
    model = TEHEM(self_depths=(2, 2), cross_depths=(1,), embed_dim=64, num_heads=2,
                  window_size=16, mlp_ratio=2.0, knn_k=4, static_knn=True, device="cpu")
    pts = lidar_points(np.random.default_rng(1), 300)
    sl = tsplit(preprocess_points(pts, system="spher", qs=kitti_qs(12)).context, angular=True)
    lines = []
    out = bench.measure(EHEMCodec(model, context_size=64), sl, len(pts), 2, log=lines.append)
    assert [ln.split(":")[0] for ln in lines] == ["# warm", "# pass 0", "# pass 1"]
    rec = out["record"]
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == "ehem_enc_dec_points_per_sec_L16" and rec["unit"] == "points/sec"
    assert rec["value"] == round(len(pts) / (out["encode_s"] + out["decode_s"]), 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench.main(["--passes", "1"])
