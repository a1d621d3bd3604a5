"""The Python around the Hopper GEMM kernels, on the CPU: the shape rules
that pick a kernel arm (the Hopper wgmma GEMM for K <= 256, the WMMA GEMM
past it; the fused MLP kernel for C <= 256), the plain version of the
projection GEMM, the wrapper's argument checks, and the reading of the
ptxas report that chip_smoke.py gates on, and the accuracy of the erf the
Hopper kernels' GELU evaluates.  The kernels themselves are held against
these plain versions on the card (tests/test_torch_kernels.py)."""

import math
import os
import re

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from scp_tpu_torch.ops import _cuda, proj_gemm
from scp_tpu_torch.ops import mlp as tmlp
from scp_tpu_torch.ops import swin_attn as tswin


@pytest.mark.parametrize("n,k,want", [
    (256, 256, "sm90"), (768, 256, "sm90"), (512, 256, "sm90"), (1024, 256, "sm90"),
    (64, 64, "sm90"), (320, 192, "sm90"), (192, 128, "sm90"),
    (256, 320, "wmma"), (768, 384, "wmma"), (512, 1024, "wmma"), (256, 96, "wmma"),
])
def test_gemm_arm_is_chosen_by_shape_alone(n, k, want):
    assert proj_gemm.arm(n, k) == want


@pytest.mark.parametrize("c,dtype,want", [
    (256, torch.bfloat16, "sm90"), (128, torch.bfloat16, "sm90"), (64, torch.bfloat16, "sm90"),
    (320, torch.bfloat16, "wmma"), (384, torch.bfloat16, "wmma"),
    (256, torch.float32, "f32"), (384, torch.float32, "f32"),
])
def test_mlp_kernel_arm(c, dtype, want):
    assert tmlp.kernel_arm(c, dtype) == want


@pytest.mark.parametrize("c,dtype,want", [
    (128, torch.bfloat16, "sm90"), (256, torch.bfloat16, "sm90"),
    (384, torch.bfloat16, "wmma"), (512, torch.bfloat16, "wmma"),
    (256, torch.float32, "f32"),
])
def test_attention_sublayers_gemm_arm(c, dtype, want):
    assert tswin.gemm_arm(c, dtype) == want


def _inputs(rng, m, n, k):
    def t(*s, scale=1.0):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))

    return (t(m, k).bfloat16(), t(n, k, scale=0.05).bfloat16(), t(n, scale=0.05),
            (1 + t(k, scale=0.1), t(k, scale=0.1)))


def test_two_plain_gemms_are_the_plain_mlp_sublayer():
    """fc1 with the LN prologue and GELU, then fc2 with the residual: the
    plain GEMM rounds where the plain MLP sublayer does, bit for bit (the
    MLP plain version is held against the Pallas kernel in
    test_torch_ops.py)."""
    rng = np.random.default_rng(0)
    x, w1, b1, ln = _inputs(rng, 96, 512, 128)
    _, w2, b2, _ = _inputs(rng, 96, 128, 512)
    h = proj_gemm.linear_plain(x, w1, b1, act="gelu", ln=ln)
    got = proj_gemm.linear_plain(h, w2, b2, resid=x)
    want = tmlp.ln_mlp_residual_plain(x, *ln, w1, b1, w2, b2, 1e-5, "gelu")
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_plain_gemm_rounds_where_the_kernels_do():
    """LN in f32, its value rounded to bf16; f32 products, bias, LeakyReLU
    and residual; one rounding at the end (float64 reference)."""
    rng = np.random.default_rng(1)
    a, w, b, ln = _inputs(rng, 40, 128, 64)
    resid = a[:, :1].expand(40, 128).contiguous()
    x = a.double()
    mu = x.mean(-1, keepdim=True)
    h = (x - mu) / torch.sqrt((x - mu).square().mean(-1, keepdim=True) + 1e-5)
    h = (h * ln[0].double() + ln[1].double()).bfloat16().double()
    y = h @ w.double().T + b.double()
    y = torch.where(y >= 0, y, 0.01 * y) + resid.double()
    got = proj_gemm.linear_plain(a, w, b, act="leaky", ln=ln, resid=resid)
    torch.testing.assert_close(got.double(), y.bfloat16().double(), atol=1e-2, rtol=1e-2)


def test_cpu_gemm_takes_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(2)
    a, w, b, ln = _inputs(rng, 33, 128, 64)
    before = (proj_gemm.linear.launches, dict(proj_gemm.linear.arms))
    want = proj_gemm.linear_plain(a, w, b, act="gelu", ln=ln)
    torch.testing.assert_close(proj_gemm.linear(a, w, b, act="gelu", ln=ln), want,
                               atol=0, rtol=0)
    buf = torch.full((33, 384), 7.0, dtype=torch.bfloat16)
    out = proj_gemm.linear(a, w, b, act="gelu", ln=ln, out=buf[:, 128:256])
    assert out.data_ptr() == buf[:, 128:256].data_ptr()
    torch.testing.assert_close(buf[:, 128:256], want, atol=0, rtol=0)
    assert (buf[:, :128] == 7.0).all() and (buf[:, 256:] == 7.0).all()
    assert (proj_gemm.linear.launches, proj_gemm.linear.arms) == before


def test_gemm_refuses_bad_arguments_on_any_device():
    rng = np.random.default_rng(3)
    a, w, b, _ = _inputs(rng, 8, 128, 64)
    with pytest.raises(ValueError, match="unknown activation"):
        proj_gemm.linear(a, w, b, act="relu")
    with pytest.raises(ValueError, match="w: expected"):
        proj_gemm.linear(a, w[:, :32], b)
    with pytest.raises(ValueError, match="bf16 CUDA tensor"):  # the kernel's own checks
        proj_gemm._check_rows("a", a, 8, 64)


def test_kernels_target_sm_90a_and_report_their_registers():
    """wgmma and setmaxnreg exist only for sm_90a; -Xptxas -v writes the
    registers and spills that chip_smoke.py checks into the build log."""
    assert "-gencode=arch=compute_90a,code=sm_90a" in _cuda.FLAGS
    assert "-Xptxas" in _cuda.FLAGS and "-v" in _cuda.FLAGS
    assert _cuda.log_path("mlp.cu").endswith(".log")
    assert set(_cuda._SIGNATURES["swin_attn.cu"]) == {"scp_attn_self", "scp_attn_cross",
                                                       "scp_proj_gemm"}


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3scp8mlp_sm90ILi256EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN3scp8mlp_sm90ILi256EEEv14CUtensorMap_st
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 528 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN3scp9gemm_sm90ILi256ELb1EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN3scp9gemm_sm90ILi256ELb1EEEv14CUtensorMap_st
    280 bytes stack frame, 476 bytes spill stores, 552 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 512 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN3scp9gemm_bf16ILb1EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Used 96 registers, 26624 bytes smem, 456 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills(tmp_path, monkeypatch):
    log = tmp_path / "swin_attn.log"
    log.write_text(PTXAS_LOG)
    monkeypatch.setattr(_cuda, "log_path", lambda src: str(log))
    rows = _cuda.ptxas_report("swin_attn.cu")
    assert [r["registers"] for r in rows] == [168, 168, 96]
    assert [r["spill_stores"] for r in rows] == [0, 476, None]
    assert rows[2]["smem"] == 26624
    assert [r["kernel"][:17] for r in _cuda.ptxas_report("swin_attn.cu", "sm90")] == [
        "_ZN3scp8mlp_sm90I", "_ZN3scp9gemm_sm90"]


def test_chip_smoke_fails_on_a_spilling_hopper_kernel(tmp_path, monkeypatch):
    log = tmp_path / "k.log"
    log.write_text(PTXAS_LOG)
    monkeypatch.setattr(_cuda, "log_path", lambda src: str(log))
    with pytest.raises(AssertionError, match=r"gemm_sm90<256,1> spills"):
        chip_smoke.sm90_resources(_cuda)
    log.write_text(PTXAS_LOG.replace("476 bytes spill stores, 552", "0 bytes spill stores, 0"))
    rows = chip_smoke.sm90_resources(_cuda)
    assert set(rows) == {"mlp_sm90<256>", "gemm_sm90<256,1>"}


def _erf_rational_coefficients():
    """The float literals of common.cuh's erf_rational, in source order:
    the numerator's 7 (highest power first), then the denominator's 5."""
    src = open(os.path.join(_cuda.CSRC, "common.cuh")).read()
    body = src.split("float erf_rational(float a) {", 1)[1].split("\n}", 1)[0]
    coef = [float(c) for c in re.findall(r"(-?\d+\.\d+e-\d+)f", body)]
    assert len(coef) == 12
    return coef[:7], coef[7:]


def _erf_rational(a):
    """erf_rational in f32 arithmetic (an f32 division stands for the
    kernel's fast one, within 2 ulp of it)."""
    num, den = _erf_rational_coefficients()
    f = np.float32
    x = np.clip(a.astype(f), f(-4), f(4))
    x2 = x * x
    p, q = f(num[0]), f(den[0])
    for c in num[1:]:
        p = (x2 * p + f(c)).astype(f)
    for c in den[1:]:
        q = (x2 * q + f(c)).astype(f)
    return ((x * p) / q).astype(f)


def test_the_hopper_kernels_erf_is_f32_accurate():
    """The Hopper kernels' GELU evaluates erf as a clamped rational
    function (common.cuh, erf_rational): to 5e-7 absolute, as close as
    JAX's own f32 erf; their GELU is as close to the exact one as torch's
    f32 GELU."""
    a = np.linspace(-6.0, 6.0, 240_001).astype(np.float32)
    want = np.array([math.erf(float(v)) for v in a])
    err = np.abs(_erf_rational(a).astype(np.float64) - want).max()
    jax_err = np.abs(np.asarray(jax.lax.erf(a)).astype(np.float64) - want).max()
    assert err < 5e-7 and err < 2 * jax_err, (err, jax_err)
    s = np.float32(0.70710678118654752)
    gelu = np.float32(0.5) * a * (np.float32(1) + _erf_rational(a * s))
    exact = 0.5 * a.astype(np.float64) * (1 + np.array([math.erf(float(v) / math.sqrt(2))
                                                        for v in a]))
    torch_gelu = torch.nn.functional.gelu(torch.from_numpy(a)).numpy()
    assert np.abs(gelu - exact).max() < 2 * np.abs(torch_gelu - exact).max()
