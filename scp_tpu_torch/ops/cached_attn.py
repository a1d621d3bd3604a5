"""The cached attention of OctAttention's KV-cache step.

`cached_attention(q, k_self, v_self, k_cache, v_cache, length)` is what
models/octattention.py's `DualStreamLayer._attend_cached` computes: q,
k_self, v_self (lanes, heads * hd) against the first `length` cached rows of
k_cache / v_cache (lanes, heads, W, hd), plus the self slot (the row's own
key and value): scores q.k / sqrt(hd), an f32 softmax over the `length`
scores and the self score, then the weighted sum of the cached values and
v_self.  -> (lanes, heads * hd) in q's dtype.

`length` is a host int or an int64 device scalar.  Dispatch is by the
tensor's device: a CPU tensor runs the plain version, which is the step's
batched products as the port has always computed them (a device `length`
is read back to the host there); a CUDA tensor launches csrc/cached_attn.cu
(f32 or bf16 operands, f32 sums) or raises.  The kernel reads a device
`length` itself, so a CUDA graph that captured it replays the step at
every cache length.  scp_tpu computes this step with einsums, not with a
Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from scp_tpu_torch.ops import _cuda

SMEM_LIMIT = 48 * 1024  # the split kernel's shared memory, static limit


def cached_attention_plain(q, k_self, v_self, k_cache, v_cache, length):
    """Plain version: the batched products over the first `length` rows."""
    lanes, h, _, hd = k_cache.shape
    length = int(length)
    scale = math.sqrt(hd)
    qh = q.reshape(lanes * h, 1, hd)
    kh = k_cache[:, :, :length].reshape(lanes * h, length, hd)
    vh = v_cache[:, :, :length].reshape(lanes * h, length, hd)
    scores = torch.bmm(qh, kh.transpose(1, 2)).float() / scale  # (lanes*h, 1, length)
    diag = torch.bmm(qh, k_self.reshape(lanes * h, hd, 1)).float() / scale
    weights = torch.softmax(torch.cat([scores, diag], dim=-1), dim=-1).to(q.dtype)
    out = torch.bmm(weights[..., :length], vh)
    out = out + weights[..., length:] * v_self.reshape(lanes * h, 1, hd)
    return out.view(lanes, h * hd)


def plan(rows: int, window: int, hd: int, esize: int) -> tuple[int, int, int]:
    """(chunk, group, nsplit) of a launch: `group` rows make a 16-byte
    multiple, so a chunk of a multiple of them starts aligned; chunks of 32
    rows, 16 where rows (lane x head) are fewer than 32 so that the splits
    still fill the card, fewer where the two chunk spans would pass the
    shared-memory limit."""
    group = 16 // math.gcd(hd * esize, 16)
    chunk = 32 if rows >= 32 else 16
    while chunk > group and 2 * chunk * hd * esize + (hd + chunk) * 4 > SMEM_LIMIT:
        chunk //= 2
    if chunk % group or 2 * chunk * hd * esize + (hd + chunk) * 4 > SMEM_LIMIT:
        raise ValueError(f"cached attention: head dim {hd} is too wide for the kernel")
    return chunk, group, -(-window // chunk)


def cached_attention(q, k_self, v_self, k_cache, v_cache, length):
    if q.device.type == "cpu":
        return cached_attention_plain(q, k_self, v_self, k_cache, v_cache, length)
    lanes, h, window, hd = k_cache.shape
    dtype = k_cache.dtype
    flag = _cuda.dtype_flag(k_cache)
    rows = lanes * h
    for name, t in (("q", q), ("k_self", k_self), ("v_self", v_self)):
        _cuda.check_cuda_tensor(name, t, dtype, (lanes, h * hd))
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _cuda.check_cuda_tensor(name, t, dtype, (lanes, h, window, hd))
    esize = k_cache.element_size()
    if (window * hd * esize) % 16:
        raise ValueError(f"cached attention: a head's window ({window} x {hd}) is not a "
                         "16-byte multiple")
    if rows > 65535:
        raise ValueError(f"cached attention: {rows} rows (lanes x heads) > 65535")
    if isinstance(length, torch.Tensor):
        _cuda.check_cuda_tensor("length", length, torch.int64, ())
        len_ptr, len_host = length.data_ptr(), 0
    else:
        len_ptr, len_host = None, int(length)
    chunk, group, nsplit = plan(rows, window, hd, esize)
    out = torch.empty((lanes, h * hd), dtype=dtype, device=q.device)
    ws_acc = torch.empty((rows, nsplit, hd), dtype=torch.float32, device=q.device)
    ws_ml = torch.empty((rows, nsplit, 2), dtype=torch.float32, device=q.device)
    lib = _cuda.load("cached_attn.cu")
    with _cuda.on_device(q, k_self, v_self, k_cache, v_cache):
        code = lib.scp_cached_attn(
            q.data_ptr(), k_self.data_ptr(), v_self.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), out.data_ptr(), ws_acc.data_ptr(), ws_ml.data_ptr(), len_ptr,
            len_host, rows, window, hd, chunk, group, nsplit, math.sqrt(hd), flag,
            _cuda.stream_ptr(q))
    _cuda.check(lib, code, "cached attention")
    if torch.cuda.is_current_stream_capturing():
        cached_attention.captured += 1  # recorded into a graph, run by its replays
    else:
        cached_attention.launches += 1
    return out


# Calls that ran on the card (each one launch of the split kernel and one of
# the combine): eager calls, and those a graph replay runs, which the graph's
# owner adds (replayed); calls recorded during a capture count as captured.
cached_attention.launches = 0
cached_attention.captured = 0


def replayed(calls: int) -> None:
    """Count `calls` calls run by a graph replay."""
    cached_attention.launches += calls
