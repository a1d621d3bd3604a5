"""Port codec vs the JAX package: call plans and the device expansion bit
for bit, CDF quantization (strictly monotone rows; the share of rows that
differ from JAX's is printed), rANS bytes identical for the same rows and
symbols, and a CPU codec roundtrip that is lossless with the JAX codec's
bpp on the same cloud and weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from scp_tpu.codec import ehem_codec as jcodec
from scp_tpu.codec import rans as jrans
from scp_tpu.codec.slices import split_levels as jsplit
from scp_tpu.core.preprocess import preprocess_points as jpreprocess
from scp_tpu.models.ehem import EHEM as JEHEM
from scp_tpu_torch import weights
from scp_tpu_torch.codec import ehem_codec as tcodec
from scp_tpu_torch.codec import rans as trans
from scp_tpu_torch.codec.slices import split_levels as tsplit
from scp_tpu_torch.core.preprocess import preprocess_points as tpreprocess
from scp_tpu_torch.models.ehem import EHEM as TEHEM


@pytest.fixture(scope="module", autouse=True)
def numpy_octree():
    """scp_tpu's octree builder takes its native library above 2048 keys,
    built at first use through one <so>.tmp that test workers share (a
    race that can fail tests/test_ac.py; ROADMAP, traps).  Its numpy path
    is the native builder's reference, so the octrees are the same."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCP_TPU_NO_NATIVE", "1")
        yield


# ---- call plan and expansion (integer steps: bit-exact) ---------------------


@pytest.mark.parametrize("csz,group,small", [(8192, 16, 1024), (256, 4, 32), (64, 8, 32)])
def test_call_plan_layouts_equal(csz, group, small):
    for n in [1, 31, 513, 1000, csz - 1, csz, csz + 1, 3 * csz // 2 + 1, 14 * csz + 77,
              15 * csz + csz // 2 + 3, 40 * csz + 5, 123_456]:
        assert tcodec._call_plan(n, csz, group, small) == jcodec._call_plan(
            n, csz, group, small
        ), n
        assert tcodec._pow2(n) == jcodec._pow2(n)


def _parent_level(rng, b, n_par):
    data = np.zeros((b, 4, 3), np.int32)
    data[:, :, 2] = 255
    data[:n_par, :, 0] = rng.integers(1, 15, (n_par, 4))
    data[:n_par, :, 1] = rng.integers(1, 9, (n_par, 4))
    data[:n_par, :3, 2] = rng.integers(0, 255, (n_par, 3))
    pos = np.zeros((b, 3), np.int32)
    pos[:n_par] = rng.integers(0, 1 << 12, (n_par, 3))
    occ = np.full(b, 255, np.uint8)
    occ[:n_par] = rng.integers(0, 255, n_par)
    return data, pos, occ


@pytest.mark.parametrize("b,n_par,w", [(1024, 100, 1024), (2048, 300, 1024), (512, 1, 512)])
def test_expansion_bit_exact(rng, b, n_par, w):
    data, pos, occ = _parent_level(rng, b, n_par)
    n_child = int(sum(bin(int(o) + 1).count("1") for o in occ[:n_par]))
    if n_child > w:
        n_par = 1
        n_child = int(bin(int(occ[0]) + 1).count("1"))
    args = (np.int32(n_par), np.int32(n_child), np.int32(9), np.int32(1 << 4))
    want_d, want_p = jcodec._expand_windowed(
        jnp.asarray(data), jnp.asarray(pos), jnp.asarray(occ[:w]), *args, w
    )
    got_d, got_p = tcodec._expand_windowed(
        torch.from_numpy(data.copy()), torch.from_numpy(pos.copy()),
        torch.from_numpy(occ[:w].copy()), n_par, n_child, 9, 1 << 4, w,
    )
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


def test_expansion_variants_and_emits_bit_exact(rng):
    """The parity-, stream- and flat-fed expansions and both emits, against
    the JAX package's jitted programs on the same buffers."""
    b, n_par, w = 2048, 200, 1024
    data, pos, occ = _parent_level(rng, b, n_par)
    n_child = int(sum(bin(int(o) + 1).count("1") for o in occ[:n_par]))
    ev, od = occ[0:w:2].copy(), occ[1:w:2].copy()
    j = (np.int32(n_par), np.int32(n_child), np.int32(5), np.int32(1 << 7))
    t = (n_par, n_child, 5, 1 << 7)
    T = torch.from_numpy

    def jd():
        return jnp.asarray(data), jnp.asarray(pos)

    def td():
        return T(data.copy()), T(pos.copy())

    stream = np.concatenate([np.full(37, 9, np.uint8), occ])
    pairs = [
        (jcodec._expand_parity(*jd(), jnp.asarray(ev), jnp.asarray(od), *j, w),
         tcodec._expand_parity(*td(), T(ev), T(od), *t, w)),
        (jcodec._expand_stream(*jd(), jnp.asarray(stream), np.int32(37), *j, w),
         tcodec._expand_stream(*td(), T(stream), 37, *t, w)),
        (jcodec._expand_flat(*jd(), jnp.asarray(occ[:700]), *j, w),
         tcodec._expand_flat(*td(), T(occ[:700].copy()), *t, w)),
    ]
    for (wd, wp), (gd, gp) in pairs:
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))

    out = rng.integers(0, 255, 4096).astype(np.uint8)
    want = jcodec._emit_parity(jnp.asarray(out), jnp.asarray(ev), jnp.asarray(od),
                               np.int32(100), np.int32(777))
    got = tcodec._emit_parity(T(out.copy()), T(ev), T(od), 100, 777)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flat = rng.integers(0, 255, 512).astype(np.uint8)
    want = jcodec._emit_flat(jnp.asarray(out), jnp.asarray(flat), np.int32(9), np.int32(300))
    got = tcodec._emit_flat(T(out.copy()), T(flat), 9, 300)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_device_expansion_rebuilds_every_level_of_the_octree(rng):
    """Expanding level by level from the root buffer, fed the true
    occupancies, reproduces split_levels' context rows (the current node's
    own occupancy is the unknown token 255 in the buffers) and positions."""
    pts = rng.integers(0, 1 << 7, (3000, 3))
    sl = tsplit(tpreprocess(pts, system="cart", qs=1.0).context, angular=False)
    sizes = sl.level_sizes
    codec = tcodec.EHEMCodec.__new__(tcodec.EHEMCodec)
    codec.device = torch.device("cpu")
    b_cap = tcodec._pow2(max(sizes) * 2)
    data, pos = codec._root_bufs(b_cap)
    occ = torch.from_numpy(np.concatenate([sl.occ_stream.astype(np.uint8),
                                           np.zeros(b_cap, np.uint8)]))
    off = 0
    for li, n in enumerate(sizes):
        want = sl.data[li].copy()
        want[:, 3, 2] = 255
        np.testing.assert_array_equal(data[:n].numpy(), want)
        np.testing.assert_array_equal(pos[:n].numpy(), sl.pos_int[li])
        if li + 1 < len(sizes):
            data, pos = tcodec._expand_stream(data, pos, occ, off, n, sizes[li + 1], li + 2,
                                              1 << (sl.max_level - li - 1), b_cap)
        off += n


# ---- CDF quantization --------------------------------------------------------


def test_logits_to_cdf_strictly_monotone_and_close_to_jax(rng):
    scales = np.array([0.1, 1.0, 5.0, 30.0], np.float32)
    logits = (rng.normal(size=(4096, 255)) * np.repeat(scales, 1024)[:, None]).astype(
        np.float32
    )
    got = tcodec.logits_to_cdf(torch.from_numpy(logits)).numpy()
    want = np.asarray(jcodec.logits_to_cdf(jnp.asarray(logits))).astype(np.int64)
    full = got.astype(np.int64)
    full[:, -1] = 65536  # the wrapped top entry
    assert (full[:, 0] == 0).all()
    assert (np.diff(full, axis=1) >= 1).all()  # every symbol has freq >= 1
    differ = float((got != want).any(axis=1).mean())
    print(f"logits_to_cdf: share of rows that differ from JAX's: {differ:.4f}")
    # the two cumsums add in different orders; a row differs by a few
    # units in some entries at most
    assert int(np.abs(got - want).max()) <= 4


# ---- rANS ---------------------------------------------------------------------


def _rows_and_syms(rng, n):
    logits = rng.normal(0.0, 3.0, (n, 255)).astype(np.float32)
    rows = np.asarray(jcodec.logits_to_cdf(jnp.asarray(logits)))  # shared rows
    pdf = np.exp(logits - logits.max(1, keepdims=True))
    pdf /= pdf.sum(1, keepdims=True)
    syms = np.array([rng.choice(255, p=p) for p in pdf], np.int32)
    return rows, syms


def test_rans_bytes_identical_to_jax(rng):
    """Three groups (one over a chunk, one odd, one tiny): the port's
    payload is byte-for-byte JAX's, and the port decodes it."""
    sizes = [jrans.CHUNK + 4099, 2047, 5]
    groups = [_rows_and_syms(rng, n) for n in sizes]
    jenc, tenc = jrans.RansEncoder(), trans.RansEncoder("cpu")
    for rows, syms in groups:
        n = syms.shape[0]
        pad = jrans.pad_to_chunk(n) - n
        rp = np.concatenate([rows, np.zeros((pad, 256), rows.dtype)])
        sp = np.concatenate([syms, np.zeros(pad, syms.dtype)])
        jenc.append_group(jrans.gather_start_freq(jnp.asarray(rp), jnp.asarray(sp)), n)
        tenc.append_group(
            trans.gather_start_freq(torch.from_numpy(rp.astype(np.int32)),
                                    torch.from_numpy(sp)), n
        )
    want = jenc.finish()
    got = tenc.finish()
    assert got == want
    dec = trans.RansDecoder(got, "cpu")
    for rows, syms in groups:
        n = syms.shape[0]
        rp = np.zeros((trans.pad_to_chunk(n), 256), np.int32)
        rp[:n] = rows
        out = dec.decode_group(torch.from_numpy(rp), n)
        np.testing.assert_array_equal(out[:n].numpy(), syms)


# ---- the codec end to end ---------------------------------------------------

CFG = dict(self_depths=(2, 2), cross_depths=(2, 1), embed_dim=64, num_heads=4,
           window_size=64, mlp_ratio=2.0, knn_k=4)
# bpp of the port vs the JAX codec on the same cloud and weights: the CDF
# rows differ in a few entries (summation order), which moves the rate by
# far less than this relative tolerance.
BPP_RTOL = 2e-3


def _variables(rng, model):
    d = np.zeros((1, 8, 4, 3), np.int32)
    p = np.zeros((1, 8, 3), np.float32)
    v = unfreeze(jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0), d, p)))

    def walk(node):
        for k, val in node.items():
            if isinstance(val, dict):
                walk(val)
            elif k == "var":
                node[k] = (1.0 + np.abs(rng.normal(0, 0.2, val.shape))).astype(np.float32)
            else:
                s = 0.01 if k == "kernel" else 0.2
                node[k] = (val + rng.normal(0, s, val.shape)).astype(np.float32)

    walk(v)
    return v


def _cloud(rng, n):
    r = rng.uniform(2.0, 60.0, n)
    az = rng.uniform(0, 2 * np.pi, n)
    el = rng.uniform(-0.4, 0.2, n)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                     r * np.sin(el)], 1)


def test_codec_roundtrip_lossless_with_jax_bpp(monkeypatch):
    monkeypatch.setenv("SCP_STATIC_KNN", "1")  # never "0": JAX reads it with bool()
    rng = np.random.default_rng(11)
    jm = JEHEM(**CFG)
    variables = _variables(rng, jm)
    tm = weights.load_into(TEHEM(**CFG, static_knn=True, device="cpu"), variables)
    pts = _cloud(rng, 1500)

    res_t = tpreprocess(pts, system="spher", qs=60.0 / 255)
    sl = tsplit(res_t.context, angular=True)
    res_j = jpreprocess(pts, system="spher", qs=60.0 / 255)
    np.testing.assert_array_equal(res_t.context, res_j.context)
    assert sum(n > tcodec.EHEMCodec.TINY_UNIFORM_MAX for n in sl.level_sizes) >= 2

    codec = tcodec.EHEMCodec(tm, context_size=256)
    assert "staticknn=1" in codec.coding_params()
    stream, bits, _ = codec.encode_to_stream(sl)
    codes = codec.decode(codec.new_stream_decoder(stream, len(sl.occ_stream)), sl.max_level,
                         np.array(sl.pos_mm, np.int64), angular=True,
                         ground_truth=sl.occ_stream, level_sizes=sl.level_sizes)
    np.testing.assert_array_equal(codes, sl.occ_stream)

    jc = jcodec.EHEMCodec(jm, variables, context_size=256, mode="rans")
    _, jbits, _ = jc.encode_to_stream(jsplit(res_j.context, angular=True))
    bpp, jbpp = bits / len(pts), jbits / len(pts)
    print(f"codec roundtrip bpp: port {bpp:.5f}, JAX {jbpp:.5f}")
    assert abs(bpp - jbpp) <= BPP_RTOL * jbpp
