"""EHEM entropy model (port of scp_tpu/models/ehem.py).

  * GeoFeatGenerator -> 256-d per node;
  * 5-stage self Swin over the context, fused multiscale head
    (ancient_mlp) -> 256-d;
  * checkerboard split: even nodes = group 1, odd = group 2;
  * group 1 logits from prob_pred_mlp1;
  * group 2 cross-attends (4-stage cross Swin) to keys built from group
    1's true occupancy embedding (16-d) + 240-d projected features;
    multiscale output + query -> prob_pred_mlp2;
  * odd-length inputs padded with occupancy 255.

Decoding is functional as in scp_tpu: phase 1 returns (logits1, feat_a1,
feat_a2); the caller feeds decoded group-1 occupancies into phase 2.

`static_knn`, `pallas_knn` and `pallas_attn` are constructor arguments
standing for scp_tpu's SCP_STATIC_KNN, SCP_PALLAS_KNN and SCP_PALLAS_ATTN
(which scp_tpu reads with bool(), so "0" turns them on): the fused KNN op
(kernel D) for graphs of N >= 2048 rows, and the fused window attention
(kernel E) in the Swin blocks' unfused branch.  All default off.

Training: `forward(data, pos)` is scp_tpu's teacher-forced `__call__`
(ehem.py:116-131), interleaved logits (B, N, 255) in f32; BatchNorm
follows `self.training` (a new model starts in eval mode, the codec's).
`fused_edgeconv` picks the train EdgeConv arm (scp_tpu's
SCP_FUSED_EDGECONV, on by default), `remat` recomputes the Swin blocks and
EdgeConvs in the backward (nn.remat there), and `plain_seams` sends the
kernel seams to their plain versions on any device (for holding the
kernels against them).  The codec's entry points run in eval mode under
no_grad whatever the model's mode.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from scp_tpu_torch import resolve_device
from scp_tpu_torch.models.dgcnn import GeoFeatGenerator
from scp_tpu_torch.models.layers import MLP
from scp_tpu_torch.models.swin1d import SwinEncoder1D

GEO_DIM = 256  # GeoFeatGenerator output width (x 128 + edge 128)


class EHEM(nn.Module):
    def __init__(
        self,
        token_num: int = 255,
        max_level: int = 19,
        knn_k: int = 20,
        self_depths: tuple = (4, 4, 4, 4, 2),
        cross_depths: tuple = (2, 2, 1, 1),
        embed_dim: int = 256,
        num_heads: int = 4,
        window_size: int = 512,
        mlp_ratio: float = 4.0,
        static_knn: bool = False,
        pallas_knn: bool = False,
        pallas_attn: bool = False,
        dtype: torch.dtype = torch.float32,
        device=None,
        fused_edgeconv: bool = True,
        remat: bool = False,
        plain_seams: bool = False,
    ):
        super().__init__()
        self.static_knn = bool(static_knn)
        self.pallas_knn = bool(pallas_knn)
        self.pallas_attn = bool(pallas_attn)
        self.token_num = token_num
        self.dtype = dtype
        self.geo = GeoFeatGenerator(knn_k, max_level, static_knn=static_knn,
                                    pallas_knn=pallas_knn, dtype=dtype,
                                    fused_edgeconv=fused_edgeconv, remat=remat,
                                    plain_seams=plain_seams)
        swin = dict(num_heads=num_heads, window_size=window_size, mlp_ratio=mlp_ratio,
                    pallas_attn=pallas_attn, dtype=dtype, remat=remat, plain_seams=plain_seams)
        self.swin_self = SwinEncoder1D(GEO_DIM, embed_dim, tuple(self_depths), cross=False,
                                       **swin)
        self.swin_cross = SwinEncoder1D(GEO_DIM, embed_dim, tuple(cross_depths), cross=True,
                                        **swin)
        ms_self = sum(self.swin_self.stage_widths)
        ms_cross = sum(self.swin_cross.stage_widths)
        self.ancient_mlp = MLP(ms_self, [1024, 512, GEO_DIM], dtype=dtype)
        self.prob_pred_mlp1 = MLP(GEO_DIM, [256, 256, token_num], dtype=dtype)
        self.pre_occ_mlp = MLP(16, [16, 16, 16], dtype=dtype)
        self.pre_attn_mlp = MLP(GEO_DIM, [256, 240, 240], dtype=dtype)
        self.prob_pred_mlp2 = MLP(ms_cross + GEO_DIM, [768, 512, token_num], dtype=dtype)
        self.eval()
        self.to(resolve_device(device))

    @staticmethod
    def from_config(cfg, dtype=torch.float32, **switches) -> "EHEM":
        """The model of a config (scp_tpu's EHEM.from_config); `switches`
        are the constructor's keyword arguments that scp_tpu reads from
        the environment (static_knn, pallas_knn, pallas_attn,
        fused_edgeconv) or that only the port has (device, plain_seams).
        remat comes from the config, as there."""
        m = cfg["model"]
        swin = m.get("swin", {}) or {}
        train = cfg.get("train", {}) or {}
        return EHEM(
            token_num=m["token_num"],
            max_level=m["max_level"],
            self_depths=tuple(swin.get("self_depths", (4, 4, 4, 4, 2))),
            cross_depths=tuple(swin.get("cross_depths", (2, 2, 1, 1))),
            embed_dim=swin.get("embed_dim", 256),
            num_heads=swin.get("num_heads", 4),
            window_size=swin.get("window_size", 512),
            mlp_ratio=swin.get("mlp_ratio", 4.0),
            remat=bool(cfg.get("remat", train.get("remat", False))),
            dtype=dtype,
            **switches,
        )

    @property
    def device(self) -> torch.device:
        return self.prob_pred_mlp1.dense_0.bias.device

    # ---- shared trunk -----------------------------------------------------

    @staticmethod
    def _pad_even(data, pos):
        """Odd context -> append one pad node (occ 255) (ehem.py:92-99)."""
        if data.shape[1] % 2 == 1:
            pad = torch.zeros_like(data[:, :1])
            pad[:, :, :, 2] = 255
            data = torch.cat([data, pad], dim=1)
            pos = torch.cat([pos, torch.zeros_like(pos[:, :1])], dim=1)
            return data, pos, True
        return data, pos, False

    @contextlib.contextmanager
    def _inference(self):
        """Eval mode (running BatchNorm) and no gradient, restoring the mode."""
        was = self.training
        self.eval()
        try:
            with torch.no_grad():
                yield
        finally:
            self.train(was)

    def _trunk(self, data, pos):
        """data (B, N, 4, 3) [level, octant, occ]; pos (B, N, 3).
        Returns (feat_a1, feat_a2): per-group 256-d features."""
        b, n = data.shape[:2]
        flat = data.reshape(b, n, -1)[:, :, :-1]  # drop current node's occ
        feat = self.geo(flat, pos)
        states = self.swin_self(feat)
        feat_a = self.ancient_mlp.multiscale(states[1:])
        return feat_a[:, ::2], feat_a[:, 1::2]

    def _phase2(self, feat_a1, feat_a2, pre_occ):
        """Group-2 logits given group-1 occupancies (0..254, pad 255)."""
        key = torch.cat(
            [
                self.pre_occ_mlp(self.geo.embed_occ(pre_occ)),
                self.pre_attn_mlp(feat_a1),
            ],
            dim=-1,
        )  # (B, N/2, 256)
        states = self.swin_cross(key, query=feat_a2)
        return self.prob_pred_mlp2.multiscale(states[1:], extra=feat_a2).float()

    # ---- entry points -----------------------------------------------------

    def _two_groups(self, data, pos):
        """Both groups' logits, teacher-forced on the true group-1 symbols."""
        data, pos, padded = self._pad_even(data, pos)
        pre_occ = data[:, ::2, -1, -1]
        feat_a1, feat_a2 = self._trunk(data, pos)
        logits1 = self.prob_pred_mlp1(feat_a1).float()
        logits2 = self._phase2(feat_a1, feat_a2, pre_occ)
        if padded:
            logits2 = logits2[:, :-1]
        return logits1, logits2

    def forward(self, data, pos):
        """Training/teacher-forced forward -> interleaved logits (B, N, 255)
        in f32; BatchNorm in the model's mode."""
        logits1, logits2 = self._two_groups(data, pos)
        b, n = data.shape[:2]
        out = logits1.new_zeros((b, n, self.token_num))
        out[:, 0::2] = logits1
        out[:, 1::2] = logits2
        return out

    def encode_probs(self, data, pos):
        """Encode-side forward -> (logits1, logits2)."""
        with self._inference():
            return self._two_groups(data, pos)

    def decode_phase1(self, data, pos):
        """Wavefront decode phase 1: current occupancies unknown (255)."""
        with self._inference():
            data, pos, _ = self._pad_even(data, pos)
            feat_a1, feat_a2 = self._trunk(data, pos)
            logits1 = self.prob_pred_mlp1(feat_a1).float()
            return logits1, feat_a1, feat_a2

    def decode_phase2(self, feat_a1, feat_a2, group1_occ, trim_last: bool):
        """Phase 2 from cached trunk features + decoded group-1 symbols."""
        with self._inference():
            logits2 = self._phase2(feat_a1, feat_a2, group1_occ)
            if trim_last:
                logits2 = logits2[:, :-1]
            return logits2

    # ---- products (2 per multiply-add; tools/profile_codec.py's MFU) -------

    def phase1_flops(self, lanes: int, width: int) -> int:
        """decode_phase1 on (lanes, width) contexts (odd widths padded)."""
        n = width + width % 2
        f_swin, pyramid = self.swin_self.flops(lanes, n)
        return (self.geo.flops(lanes, n) + f_swin
                + self.ancient_mlp.multiscale_flops(lanes, pyramid)
                + self.prob_pred_mlp1.flops(lanes * (n // 2)))

    def phase2_flops(self, lanes: int, width: int) -> int:
        """decode_phase2 after a phase-1 call on (lanes, width)."""
        m = (width + width % 2) // 2
        f_swin, pyramid = self.swin_cross.flops(lanes, m)
        return (self.pre_occ_mlp.flops(lanes * m) + self.pre_attn_mlp.flops(lanes * m) + f_swin
                + self.prob_pred_mlp2.multiscale_flops(
                    lanes, pyramid, extra_width=self.prob_pred_mlp1.dense_0.weight.shape[1]))

    def forward_flops(self, batch: int, context: int) -> int:
        """The teacher-forced training forward on (batch, context)."""
        return self.phase1_flops(batch, context) + self.phase2_flops(batch, context)
