"""Bitstream container: header + range-coder payload.

The reference smuggles decode metadata through the output FILENAME
(`_<levels>_<bin_num>_<z_offset>.bin`, reference encode.py:140-144) plus a
torch-saved `.dat` sidecar of per-level position extrema (encode.py:150).
Here the stream is SELF-CONTAINED: a small binary header carries everything
the decoder needs — entropy-coding metadata, per-subtree quantization grids
(qs/offset/bin_num), per-subtree octree depths, and per-level node counts.
The level counts let the decoder know every wavefront shape up front, so
the whole decode graph can be dispatched device-resident with no per-level
host round-trip.  The reference-compatible filename is still produced by
the CLI for drop-in workflows.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

_MAGIC = b"SCPT"
# v6: coding_mode "incr" routing — OctAttention streams written with the
# host-incremental schedule before the header pin were stamped "full" and
# would silently desync under --no_check; the bump makes stale bins fail
# loudly at unpack instead.
_VERSION = 6


@dataclasses.dataclass
class StreamHeader:
    n_sym: int  # arithmetic-coder steps (2 per node in "staged" mode)
    max_level: int
    system: str  # "cart" | "cylin" | "spher"
    bin_num: int
    z_offset: float
    lidar_clip: int
    qs_rho: float
    pos_mm: np.ndarray  # (L, 2) int64 per-level (min, max); empty for cart
    subtree_sizes: tuple = ()  # node counts per subtree (multi-level mode)
    coding_mode: str = "rans"  # entropy coding ("rans" | "staged" | "full")
    backend: str = ""  # backend that produced the stream (determinism
    # contract: decoding must run the same programs — see the codec's
    # module docstring)
    coding_params: str = ""  # every knob that changes the compiled phase
    # programs' float math (knn recall, pallas-attn, group batching);
    # decode refuses a mismatch the same way it refuses a backend change
    subtree_levels: tuple = ()  # (S,) octree depth per subtree
    level_sizes: np.ndarray | None = None  # (sum(subtree_levels),) int64
    # node counts per level, subtree-major — the decoder's shape oracle
    grid_qs: np.ndarray | None = None  # (S, 3) f64 quantization steps
    grid_offset: np.ndarray | None = None  # (S, 3) f64 grid offsets
    grid_bin_num: np.ndarray | None = None  # (S,) int64 angular bin counts

    @property
    def angular(self) -> bool:
        return self.system in ("cylin", "spher")

    def grids(self):
        """Per-subtree QuantGrids reconstructed from the header alone
        (role of the reference's re-derivation from the original points,
        encode_dataset_ehem.py:136-171 — here the stream is standalone)."""
        from scp_tpu_torch.core.quantize import QuantGrid

        return [
            QuantGrid(
                system=self.system,
                qs=self.grid_qs[i],
                offset=self.grid_offset[i],
                bin_num=int(self.grid_bin_num[i]),
            )
            for i in range(len(self.subtree_levels))
        ]


_SYSTEMS = ["cart", "cylin", "spher"]
# "incr" = OctAttention host-AC incremental schedule (position-major per
# level); distinct from "full" (chunked windows) because the two stream
# orders are incompatible — the header, not a CLI flag, pins the schedule.
_MODES = ["full", "staged", "rans", "incr"]
_HEAD_FMT = "<4sHQHBIdhdHHB12sB"


def pack_stream(header: StreamHeader, payload: bytes) -> bytes:
    mm = np.asarray(header.pos_mm, dtype=np.int64).reshape(-1, 2)
    sub = np.asarray(header.subtree_sizes, dtype=np.int64)
    n_sub = sub.shape[0]
    levels = np.asarray(header.subtree_levels, dtype=np.uint16)
    sizes = np.asarray(
        [] if header.level_sizes is None else header.level_sizes, np.int64
    )
    if levels.shape[0] != n_sub or sizes.shape[0] != int(levels.sum()):
        raise ValueError("subtree_levels / level_sizes inconsistent")
    qs = np.asarray(header.grid_qs, np.float64).reshape(n_sub, 3)
    off = np.asarray(header.grid_offset, np.float64).reshape(n_sub, 3)
    bn = np.asarray(header.grid_bin_num, np.int64).reshape(n_sub)
    backend = header.backend.encode()[:12].ljust(12, b"\0")
    params = header.coding_params.encode()
    if len(params) > 255:
        # One length byte in _HEAD_FMT: silent truncation here would make
        # every decode fail the params-mismatch check later.  Overflow must
        # be an encode-time error.
        raise ValueError(
            f"coding_params stamp is {len(params)} bytes (max 255): {params!r}"
        )
    head = struct.pack(
        _HEAD_FMT,
        _MAGIC,
        _VERSION,
        header.n_sym,
        header.max_level,
        _SYSTEMS.index(header.system),
        header.bin_num,
        header.z_offset,
        header.lidar_clip,
        header.qs_rho,
        mm.shape[0],
        n_sub,
        _MODES.index(header.coding_mode),
        backend,
        len(params),
    )
    return b"".join(
        [
            head,
            params,
            mm.tobytes(),
            sub.tobytes(),
            levels.tobytes(),
            sizes.tobytes(),
            qs.tobytes(),
            off.tobytes(),
            bn.tobytes(),
            payload,
        ]
    )


def unpack_stream(blob: bytes) -> tuple[StreamHeader, bytes]:
    size = struct.calcsize(_HEAD_FMT)
    (
        magic, ver, n_sym, max_level, sys_i, bin_num, z_off, clip, qs_rho,
        n_mm, n_sub, mode_i, backend, n_params,
    ) = struct.unpack(_HEAD_FMT, blob[:size])
    if magic != _MAGIC:
        raise ValueError("not an scp_tpu bitstream")
    if ver != _VERSION:
        raise ValueError(f"unsupported stream version {ver}")
    off = size
    params = blob[off : off + n_params].decode()
    off += n_params

    def take(dtype, count):
        nonlocal off
        a = np.frombuffer(blob[off : off + dtype().itemsize * count], dtype=dtype)
        off += dtype().itemsize * count
        return a

    mm = take(np.int64, 2 * n_mm).reshape(n_mm, 2)
    sub = take(np.int64, n_sub)
    levels = take(np.uint16, n_sub)
    sizes = take(np.int64, int(levels.sum()))
    qs = take(np.float64, 3 * n_sub).reshape(n_sub, 3)
    g_off = take(np.float64, 3 * n_sub).reshape(n_sub, 3)
    bn = take(np.int64, n_sub)
    header = StreamHeader(
        n_sym=n_sym,
        max_level=max_level,
        system=_SYSTEMS[sys_i],
        bin_num=bin_num,
        z_offset=z_off,
        lidar_clip=clip,
        qs_rho=qs_rho,
        pos_mm=mm.copy(),
        subtree_sizes=tuple(int(s) for s in sub),
        coding_mode=_MODES[mode_i],
        backend=backend.rstrip(b"\0").decode(),
        coding_params=params,
        subtree_levels=tuple(int(v) for v in levels),
        level_sizes=sizes.copy(),
        grid_qs=qs.copy(),
        grid_offset=g_off.copy(),
        grid_bin_num=bn.copy(),
    )
    return header, blob[off:]


def reference_style_name(stem: str, system: str, max_level: int, bin_num: int, z_offset: int) -> str:
    """`<stem>[_spher|_cylin]_<levels>_<bin_num>_<z_offset>.bin`
    (reference encode.py:140-144)."""
    tag = {"spher": "_spher", "cylin": "_cylin", "cart": ""}[system]
    return f"{stem}{tag}_{max_level}_{bin_num}_{int(z_offset)}.bin"
