"""Detection head (IKeypoint / IDetect / Detect) and the grid decode.

Counterpart of the JAX package's models/head.py. The head convs emit raw
per-level maps; `decode_level`/`decode` apply the sigmoid + grid/anchor
transform the reference performs inside the head's forward (reference
models/yolo.py:278-306):

    xy  = (sigmoid(t_xy) * 2 - 0.5 + grid) * stride
    wh  = (sigmoid(t_wh) * 2) ** 2 * anchor_px
    obj/cls = sigmoid(t)
    kpt_xy  = (t_kpt_xy * 2 - 0.5 + grid) * stride     (no sigmoid)
    kpt_conf = sigmoid(t_kpt_conf)

Channel layout contract (reference models/yolo.py:70,273-274): per level
the det conv (na*no_det channels) and the kpt conv (na*no_kpt channels) are
concatenated and then viewed as (bs, na, no, ny, nx) — the view re-slices
the concatenated channels anchor-major, so channel c maps to
(a, o) = divmod(c, no).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
from torch import nn

from face_detection_multi_scale_tpu_torch.models.layers import (
    Conv2d, ConvBN, DWConvBN, ImplicitA, ImplicitM)
from face_detection_multi_scale_tpu_torch.models.spec import ModelSpec


class DetectionHead(nn.Module):
    """Raw per-level maps, NCHW (bs, na*no, ny, nx) per level.

    ``variant``: "detect" = plain convs, "idetect"/"ikeypoint" = wrapped by
    ImplicitA before and ImplicitM after the det conv. Module names follow
    the reference (`m`, `m_kpt`, `ia`, `im`)."""

    def __init__(self, spec: ModelSpec, variant: str, ch: Sequence[int]):
        super().__init__()
        s = spec
        na, no_det, no_kpt = s.na, s.no_det, s.no_kpt
        self.implicit = variant in ("idetect", "ikeypoint")
        self.nkpt = s.nkpt
        self.m = nn.ModuleList(Conv2d(c, no_det * na, 1) for c in ch)
        if self.implicit:
            self.ia = nn.ModuleList(ImplicitA(c) for c in ch)
            self.im = nn.ModuleList(ImplicitM(no_det * na) for _ in ch)
        if s.nkpt:
            if s.dw_conv_kpt:
                # 6x (DWConv3x3 + Conv1x1) tower + final raw conv
                # (reference models/yolo.py:240-247)
                def tower(c):
                    mods = []
                    for _ in range(5):
                        mods += [DWConvBN(c, c, 3), ConvBN(c, c, 1, 1)]
                    mods += [DWConvBN(c, c, 3),
                             Conv2d(c, no_kpt * na, 1)]
                    return nn.Sequential(*mods)
                self.m_kpt = nn.ModuleList(tower(c) for c in ch)
            else:
                self.m_kpt = nn.ModuleList(
                    Conv2d(c, no_kpt * na, 1) for c in ch)

    def forward(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        outs = []
        for i, x in enumerate(xs):
            xa = self.ia[i](x) if self.implicit else x
            # the conv casts its input to its compute dtype (flax's
            # Conv(dtype=)): in a bf16 model ImplicitA's output is float32
            det = self.m[i](xa)
            if self.implicit:
                det = self.im[i](det)
            if self.nkpt:
                det = torch.cat([det, self.m_kpt[i](x)], dim=1)
            outs.append(det)
        return outs


def det_bias_prior(spec: ModelSpec, lvl: int) -> torch.Tensor:
    """Focal-style prior for the det conv bias of level `lvl`, as the JAX
    init sets it (reference models/yolo.py:419-427): obj ~ 8 objects per
    640 px image at this stride, cls 0.6/(nc-0.99). Shape (na*no_det,)."""
    b = torch.zeros(spec.na, spec.no_det, dtype=torch.float64)
    b[:, 4] = math.log(8 / (640 / float(spec.strides[lvl])) ** 2)
    b[:, 5:] = math.log(0.6 / (spec.nc - 0.99))
    return b.reshape(-1).float()


def reshape_level(raw: torch.Tensor, na: int, no: int) -> torch.Tensor:
    """NCHW (bs, na*no, ny, nx) map -> (bs, na, ny, nx, no), the reference
    view(bs, na, no, ny, nx).permute(0, 1, 3, 4, 2)."""
    bs, _, ny, nx = raw.shape
    return raw.reshape(bs, na, no, ny, nx).permute(0, 1, 3, 4, 2)


def decode_level(raw: torch.Tensor, anchors_px: torch.Tensor, stride: int,
                 nkpt: int, nc: int) -> torch.Tensor:
    """Decode one level's raw map (bs, na, ny, nx, no) to prediction rows
    (bs, na*ny*nx, no) in input-pixel space."""
    bs, na, ny, nx, no = raw.shape
    gy = torch.arange(ny, dtype=raw.dtype, device=raw.device)
    gx = torch.arange(nx, dtype=raw.dtype, device=raw.device)
    grid = torch.stack([gx[None, :].expand(ny, nx),
                        gy[:, None].expand(ny, nx)], dim=-1)  # (x, y)

    det = torch.sigmoid(raw[..., :5 + nc])
    xy = (det[..., 0:2] * 2.0 - 0.5 + grid) * stride
    anchor = anchors_px.reshape(1, na, 1, 1, 2).to(raw.dtype)
    wh = (det[..., 2:4] * 2.0) ** 2 * anchor
    parts = [xy, wh, det[..., 4:]]
    if nkpt:
        kraw = raw[..., 5 + nc:].reshape(bs, na, ny, nx, nkpt, 3)
        kxy = (kraw[..., 0:2] * 2.0 - 0.5 + grid[:, :, None, :]) * stride
        kconf = torch.sigmoid(kraw[..., 2:3])
        parts.append(torch.cat([kxy, kconf], dim=-1).reshape(
            bs, na, ny, nx, nkpt * 3))
    return torch.cat(parts, dim=-1).reshape(bs, na * ny * nx, no)


def decode(raw_levels: Sequence[torch.Tensor], spec: ModelSpec
           ) -> torch.Tensor:
    """Decode all levels and concatenate: (bs, sum(na*ny*nx), no), levels
    in order, anchor-major within a level (models/yolo.py:306-308)."""
    zs = []
    for lvl, raw in enumerate(raw_levels):
        anchors = torch.tensor(spec.anchors[lvl], dtype=torch.float32,
                               device=raw.device).reshape(-1, 2)
        zs.append(decode_level(raw, anchors, spec.strides[lvl], spec.nkpt,
                               spec.nc))
    return torch.cat(zs, dim=1)
