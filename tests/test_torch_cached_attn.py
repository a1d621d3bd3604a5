"""OctAttention's cached attention (ops/cached_attn.py, csrc/cached_attn.cu)
and the captured position step (models/octattention.py's StepGraphs,
codec/octattn_codec.py's LevelGraphs).

On the CPU: the plain version, with the position as a device-style tensor,
equals the step's batched products as the port computed them before the
kernel, bit for bit; decode_step returns the caller's own tensors; a CPU
model captures and replays nothing, and its streams are the bytes the
uncaptured loop wrote.  On the card (marker `cuda`; they skip without
one): the kernel against the plain version at the benchmark cell's shapes,
the graph-replayed level loop against the eager one, a lossless roundtrip
whose every position replays.  This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cached_attn.py
"""

import math

import numpy as np
import pytest
import torch

from scp_tpu_torch.codec import octattn_rans as orans
from scp_tpu_torch.codec import rans
from scp_tpu_torch.codec.ehem_codec import logits_to_cdf
from scp_tpu_torch.codec.octattn_codec import OctAttentionCodec
from scp_tpu_torch.core.octree import build_octree, gen_context
from scp_tpu_torch.models.octattention import DualStreamLayer, OctAttention
from scp_tpu_torch.ops import _cuda
from scp_tpu_torch.ops.cached_attn import cached_attention, cached_attention_plain, plan
from scp_tpu_torch.utils import profiling

HEADS, HD = 4, 150  # the benchmark cell's heads and head dim (600-wide tokens)
TINY = dict(occ_embed_dim=16, level_embed_dim=4, octant_embed_dim=4, abs_pos_embed_dim=8,
            num_layers=2, num_heads=2, hidden_dim=64, context_size=32)


def step_products(q, k_self, v_self, k_cache, v_cache, length: int):
    """DualStreamLayer._attend_cached as the port computed it before the
    kernel (the model's dtype is q's)."""
    lanes, h, _, hd = k_cache.shape
    scale = math.sqrt(hd)
    qh = q.view(lanes * h, 1, hd)
    kh = k_cache[:, :, :length].reshape(lanes * h, length, hd)
    vh = v_cache[:, :, :length].reshape(lanes * h, length, hd)
    scores = torch.bmm(qh, kh.transpose(1, 2)).float() / scale
    diag = torch.bmm(qh, k_self.view(lanes * h, hd, 1)).float() / scale
    weights = torch.softmax(torch.cat([scores, diag], dim=-1), dim=-1).to(q.dtype)
    out = torch.bmm(weights[..., :length], vh)
    out = out + weights[..., length:] * v_self.view(lanes * h, 1, hd)
    return out.view(lanes, h * hd)


def operands(gen, lanes, window, dtype, device="cpu"):
    def r(*s):
        return torch.randn(*s, generator=gen, device=device).to(dtype)

    return (r(lanes, HEADS * HD), r(lanes, HEADS * HD), r(lanes, HEADS * HD),
            r(lanes, HEADS, window, HD), r(lanes, HEADS, window, HD))


def seeded(model: OctAttention, seed: int) -> OctAttention:
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    return model


def small_context(seed=1, n=400, bits=7):
    rng = np.random.default_rng(seed)
    return gen_context(build_octree(np.unique(rng.integers(0, 2**bits, (n, 3)), axis=0)))


def roundtrip(codec, ctx):
    enc = codec.new_rans_encoder(codec.max_lane_bucket(ctx))
    codec.encode_incremental_into(enc, ctx)
    payload = enc.finish()
    _, occ, max_level = codec.split_levels(ctx)
    codes = codec.decode_incremental_rans(codec.new_rans_decoder(payload), max_level,
                                          ground_truth=occ)
    np.testing.assert_array_equal(codes, occ)
    return payload


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: many small ops, several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ---- the CPU --------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [1, 7, 63])
@pytest.mark.parametrize("lanes", [1, 4, 8])
def test_plain_with_a_tensor_position_equals_the_step_bit_for_bit(lanes, length, dtype):
    window = 64
    args = operands(torch.Generator().manual_seed(lanes * 100 + length), lanes, window, dtype)
    want = step_products(*args, length)
    got = cached_attention_plain(*args, torch.tensor(length))
    assert got.dtype == dtype and got.shape == (lanes, HEADS * HD)
    assert torch.equal(got, want)
    # the model's seam on the CPU is the plain version
    layer = DualStreamLayer(HEADS * HD, HEADS, 300, dtype)
    assert torch.equal(layer._attend_cached(*args, length), want)
    assert torch.equal(cached_attention(*args, torch.tensor(length)), want)


def test_plan_aligns_chunks_and_fills_the_card():
    # f32 rows of 600 bytes pair up to 16-byte multiples, bf16 rows of 300 in fours
    assert plan(512, 1024, 150, 4) == (32, 2, 32)
    assert plan(4, 1024, 150, 4) == (16, 2, 64)
    assert plan(512, 1024, 150, 2) == (32, 4, 32)
    chunk, group, nsplit = plan(8, 32, 7, 4)
    assert chunk % group == 0 and (chunk * 7 * 4) % 16 == 0 and nsplit == -(-32 // chunk)
    chunk, _, _ = plan(512, 1024, 600, 4)  # wide heads: shorter chunks under the smem limit
    assert 2 * chunk * 600 * 4 + (600 + chunk) * 4 <= 48 * 1024
    with pytest.raises(ValueError):
        plan(512, 1024, 8192, 4)


def test_signature_declares_the_launcher():
    assert "cached_attn.cu" in _cuda.SOURCES
    assert list(_cuda._SIGNATURES["cached_attn.cu"]) == ["scp_cached_attn"]


def test_two_decode_steps_return_distinct_logits():
    model = seeded(OctAttention(**TINY, device="cpu"), 2)
    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.integers(0, 9, (2, 3, 4, 3)).astype(np.int32))
    pos = torch.from_numpy(rng.random((2, 3, 4, 3), np.float32))
    cache = model.init_cache(3)
    first, qs = model.decode_step(data[0], pos[0], cache, 0)
    kept = first.clone()
    model.decode_insert(data[0], pos[0], cache, 0, qs)
    second, _ = model.decode_step(data[1], pos[1], cache, 1)
    assert first.data_ptr() != second.data_ptr()
    assert torch.equal(first, kept)
    assert model.step_replays == 0 and model._graphs == {}


def test_cpu_captures_nothing_and_writes_the_uncaptured_bytes(monkeypatch):
    """Counters 0 on the CPU, and the fused and steps streams equal those of
    the loop as it stood before the graphs: host-int positions, the step's
    batched products and a decoder whose states were replaced, not updated
    in place."""
    model = seeded(OctAttention(**TINY, device="cpu"), 4)
    ctx = small_context()
    with profiling.recording():
        with profiling.unit("u"):
            fused = roundtrip(OctAttentionCodec(model), ctx)
            steps = roundtrip(OctAttentionCodec(model, fused=False), ctx)
    counters = profiling.drain()["counters"]["u"]
    assert counters["octattn.positions"] > 0
    assert counters.get("octattn.graph_replays", 0) == 0
    assert counters.get("octattn.graph_captures", 0) == 0
    assert model._graphs == {}

    def old_level(self, inputs, n, lanes, true_syms=None, dec=None):
        # the level loop as it stood: host-int positions, the decoder's
        # states and pointer replaced by new tensors at every step
        model, csz = self.model, self.csz
        lane = torch.arange(lanes)
        cache = model.init_cache(lanes)
        nsteps = self._steps_bucket(min(csz, n))
        out = torch.zeros((nsteps, lanes) if dec is not None else (nsteps, lanes, 2),
                          dtype=torch.int64)
        for j in range(min(csz, n)):
            n_act = orans.active_count(n, csz, j)
            d_j, p_j = inputs(j)
            logits, qs = model.decode_step(d_j, p_j, cache, j)
            rows = logits_to_cdf(logits)
            if dec is not None:
                states, ptr = dec.states.clone(), dec.ptr.clone()
                sym = orans.decode_step_core(states, ptr, dec.stream, rows, n_act)[:lanes]
                dec.states, dec.ptr = states, ptr
                out[j] = sym
            else:
                sym = true_syms[j]
                out[j] = rans.gather_start_freq(rows, sym)
            d_j[:, -1, 0] = torch.where(lane < n_act, sym, 255).to(d_j.dtype)
            model.decode_insert(d_j, p_j, cache, j, qs)
        return out

    monkeypatch.setattr(DualStreamLayer, "_attend_cached",
                        lambda self, *args: step_products(*args))
    monkeypatch.setattr(OctAttentionCodec, "_rans_level", old_level)
    assert roundtrip(OctAttentionCodec(model), ctx) == fused
    assert roundtrip(OctAttentionCodec(model, fused=False), ctx) == steps == fused


# ---- the card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lanes", [1, 2, 8, 32, 128])
def test_kernel_matches_plain_on_card(cuda_device, lanes, dtype):
    window = 1024
    gen = torch.Generator(device=cuda_device).manual_seed(lanes)
    args = operands(gen, lanes, window, dtype, cuda_device)
    f32 = dtype == torch.float32
    for length in (0, 1, 511, 1023):
        n0 = cached_attention.launches
        got = cached_attention(*args, length)
        dev_len = torch.tensor(length, dtype=torch.int64, device=cuda_device)
        again = cached_attention(*args, dev_len)
        assert cached_attention.launches == n0 + 2
        if f32:
            want = cached_attention_plain(*args, length)
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        else:
            # f32 sums: a bf16 call differs from the f32 products of its own
            # operands only by the output's rounding (half a bf16 ulp, <= 2^-8
            # of the value); twice that, and an atol for the summation order
            want = cached_attention_plain(*(a.float() for a in args), length)
            torch.testing.assert_close(got.float(), want, atol=1e-5, rtol=2.0**-7)
        assert torch.equal(got, again)  # fixed-order sums: the same bits every call
    with pytest.raises(ValueError):
        cached_attention(*(a.half() for a in args), 5)


@pytest.mark.cuda
def test_decode_steps_on_card_return_their_own_tensors(cuda_device):
    model = seeded(OctAttention(**TINY, device="cpu"), 2).to(cuda_device)
    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.integers(0, 9, (3, 4, 4, 3)).astype(np.int32)).to(cuda_device)
    pos = torch.from_numpy(rng.random((3, 4, 4, 3), np.float32)).to(cuda_device)
    cache, ref = model.init_cache(4), model.init_cache(4)
    outs = []
    for j in range(3):
        logits, qs = model.decode_step(data[j], pos[j], cache, j)
        want, want_qs = model._step(data[j], pos[j], ref, j)
        torch.testing.assert_close(logits, want, atol=1e-5, rtol=1e-5)
        outs.append((logits, logits.clone()))
        model.decode_insert(data[j], pos[j], cache, j, qs)
        model._insert(data[j], pos[j], ref, j, want_qs)
        torch.testing.assert_close(cache["k"], ref["k"], atol=1e-5, rtol=1e-5)
    assert len({o.data_ptr() for o, _ in outs}) == 3
    assert all(torch.equal(o, kept) for o, kept in outs)
    assert model.step_replays == 3
    # a cache changed in place between calls is copied in again
    cache["k"][0, :, :, 0] += 0.5
    ref["k"][0, :, :, 0] += 0.5
    got, _ = model.decode_step(data[0], pos[0], cache, 3)
    want, _ = model._step(data[0], pos[0], ref, 3)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _level(codec, ctx, li):
    levels, occ, max_level = codec.split_levels(ctx)
    n = levels[li][0].shape[0]
    lanes = codec._lane_count(-(-n // codec.csz))
    pos_int = ctx[ctx[:, -1, 1] == li + 1][:, :, 3:6].astype(np.int32)
    inputs = codec._fused_inputs(*codec._level_bufs(levels[li][0], pos_int, lanes),
                                 float(np.float32(1.0 / float(2**max_level))), lanes)
    first = sum(d.shape[0] for d, _ in levels[:li])
    return inputs, n, lanes, codec._true_syms(occ[first:first + n].astype(np.int64), n, lanes)


@pytest.mark.cuda
def test_graph_replayed_level_matches_the_eager_one_on_card(cuda_device):
    model = seeded(OctAttention(**TINY, device="cpu"), 5).to(cuda_device)
    codec = OctAttentionCodec(model)
    ctx = small_context(n=3000, bits=9)
    levels, _, _ = codec.split_levels(ctx)
    li = int(np.argmax([d.shape[0] for d, _ in levels]))
    inputs, n, lanes, ts = _level(codec, ctx, li)
    assert lanes > 1
    graphed = codec._rans_level(inputs, n, lanes, true_syms=ts)
    replays = model.step_replays
    model._graphs_for = lambda *a: None  # the model's uncaptured step and insert
    try:
        eager = codec._rans_level(lambda j: inputs(j), n, lanes, true_syms=ts)
    finally:
        del model._graphs_for
    assert model.step_replays == replays
    assert torch.equal(graphed, eager)
    # decode: the symbols of a stream of this level alone
    enc = codec.new_rans_encoder(lanes)
    enc.append_level(graphed, n, codec.csz)
    payload = enc.finish()
    dec_g, dec_e = codec.new_rans_decoder(payload), codec.new_rans_decoder(payload)
    syms_g = codec._rans_level(inputs, n, lanes, dec=dec_g)
    model._graphs_for = lambda *a: None
    try:
        syms_e = codec._rans_level(lambda j: inputs(j), n, lanes, dec=dec_e)
    finally:
        del model._graphs_for
    assert torch.equal(syms_g, syms_e)
    assert torch.equal(dec_g.states, dec_e.states) and torch.equal(dec_g.ptr, dec_e.ptr)
    i = np.arange(n)
    np.testing.assert_array_equal(syms_g.cpu().numpy()[i % codec.csz, i // codec.csz],
                                  ts.cpu().numpy()[i % codec.csz, i // codec.csz])


@pytest.mark.cuda
def test_sweep_roundtrip_replays_every_position_on_card(cuda_device):
    model = seeded(OctAttention(**TINY, device="cpu"), 6).to(cuda_device)
    codec = OctAttentionCodec(model)
    ctx = small_context(n=3000, bits=9)
    with profiling.recording():
        with profiling.unit("u"):
            roundtrip(codec, ctx)
    counters = profiling.drain()["counters"]["u"]
    assert counters["octattn.positions"] > 0
    assert counters["octattn.graph_replays"] == counters["octattn.positions"]
    assert counters["octattn.graph_captures"] > 0
    assert codec.coding_params().endswith(";cattn=split;backend=torch-cuda")
    # captured: every position's step and insert launch the kernel once a layer
    # (the insert's last layer attends nothing), counted by the replays
    n0, replays = cached_attention.launches, model.step_replays
    roundtrip(codec, ctx)
    layers = model.num_layers
    assert model.step_replays > replays
    assert cached_attention.launches - n0 == (model.step_replays - replays) * (2 * layers - 1)


@pytest.mark.cuda
def test_codec_level_leaves_an_outside_cache_true_on_card(cuda_device):
    """The codec's level steps in the graphs' own caches; a caller with a
    cache of its own at the same lane count is copied in again after it."""
    model = seeded(OctAttention(**TINY, device="cpu"), 7).to(cuda_device)
    rng = np.random.default_rng(8)
    data = torch.from_numpy(rng.integers(0, 9, (2, 4, 4, 3)).astype(np.int32)).to(cuda_device)
    pos = torch.from_numpy(rng.random((2, 4, 4, 3), np.float32)).to(cuda_device)
    cache, ref = model.init_cache(4), model.init_cache(4)
    _, qs = model.decode_step(data[0], pos[0], cache, 0)
    model.decode_insert(data[0], pos[0], cache, 0, qs)
    _, want_qs = model._step(data[0], pos[0], ref, 0)
    model._insert(data[0], pos[0], ref, 0, want_qs)
    own = model.step_graphs(4).own_cache()  # as a codec level begins
    model.decode_step(data[1], pos[1], own, 0)
    got, _ = model.decode_step(data[1], pos[1], cache, 1)
    want, _ = model._step(data[1], pos[1], ref, 1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_graph_replayed_level_sees_a_cache_changed_in_place_on_card(cuda_device):
    """A change made in place to the cache the level steps in (the
    benchmark's planted fault) reaches the captured steps as the eager ones."""
    model = seeded(OctAttention(**TINY, device="cpu"), 9).to(cuda_device)
    codec = OctAttentionCodec(model)
    ctx = small_context(n=3000, bits=9)
    levels, _, _ = codec.split_levels(ctx)
    li = int(np.argmax([d.shape[0] for d, _ in levels]))
    inputs, n, lanes, ts = _level(codec, ctx, li)
    clean = codec._rans_level(inputs, n, lanes, true_syms=ts)
    insert = model.decode_insert

    def perturbed(data_t, pos_t, cache, length, qs):
        out = insert(data_t, pos_t, cache, length, qs)
        if length == 0:
            cache["k"][0, :, :, 0] += 0.5
        return out

    model.decode_insert = perturbed
    graphed = codec._rans_level(inputs, n, lanes, true_syms=ts)
    model._graphs_for = lambda *a: None
    try:
        eager = codec._rans_level(lambda j: inputs(j), n, lanes, true_syms=ts)
    finally:
        del model._graphs_for, model.decode_insert
    assert torch.equal(graphed, eager)
    assert not torch.equal(graphed, clean)
