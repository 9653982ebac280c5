"""The serving postprocess in plain PyTorch and NumPy, from the published
semantics (yolov7-face utils/general.py non_max_suppression):

- gate: obj > conf_thres and obj * cls > conf_thres; `n_gated` counts the
  rows that clear it;
- the `max_candidates` gated rows of highest conf (equal conf in row
  order) enter a greedy NMS at IoU > iou_thres, and the first `max_det`
  keepers in conf order come out, each row [x1, y1, x2, y2, conf, cls,
  landmarks].
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of xyxy boxes (n, 4) x (m, 4) -> (n, m)."""
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0])).clamp(min=0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1])).clamp(min=0)
    inter = iw * ih
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def greedy_nms(boxes: torch.Tensor, iou_thres: float,
               limit: int) -> np.ndarray:
    """Greedy NMS over xyxy boxes already in score order: the indices of
    the first `limit` keepers. The suppression matrix is computed on the
    boxes' device in blocks and scanned on the host as packed bits."""
    k = boxes.shape[0]
    if k == 0:
        return np.zeros(0, np.int64)
    pad = -k % 8
    place = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                         device=boxes.device)
    rows = []
    for lo in range(0, k, 2048):
        sup = box_iou(boxes[lo:lo + 2048], boxes) > iou_thres
        sup = torch.nn.functional.pad(sup, (0, pad)).view(len(sup), -1, 8)
        rows.append((sup.to(torch.uint8) * place).sum(-1, dtype=torch.uint8)
                    .cpu().numpy())
    bits = np.concatenate(rows)
    removed = np.zeros(bits.shape[1], np.uint8)
    keep = []
    for i in range(k):
        if removed[i >> 3] & (0x80 >> (i & 7)):
            continue
        keep.append(i)
        if len(keep) == limit:
            break
        removed |= bits[i]
    return np.asarray(keep, np.int64)


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[..., :2] - x[..., 2:4] / 2,
                      x[..., :2] + x[..., 2:4] / 2], -1)


def postprocess(rows: torch.Tensor, conf_thres: float, iou_thres: float,
                max_candidates: int, max_det: int) -> List[Dict]:
    """Decoded rows (B, N, 6 + E) of a one-class model -> per image
    {"rows": (n, 6 + E) float64 kept rows, "index": (n,) their row
    indices, "n_gated": int}."""
    out = []
    for r in rows:
        obj, conf = r[:, 4], r[:, 4] * r[:, 5]
        gate = (obj > conf_thres) & (conf > conf_thres)
        idx = torch.nonzero(gate).flatten()
        order = torch.sort(conf[idx], descending=True, stable=True)[1]
        idx = idx[order][:max_candidates]
        boxes = xywh2xyxy(r[idx, :4])
        keep = torch.as_tensor(greedy_nms(boxes, iou_thres, max_det),
                               device=r.device)
        kept = idx[keep]
        served = torch.cat([boxes[keep], conf[kept, None],
                            torch.zeros_like(conf[kept, None]),
                            r[kept, 6:]], 1)
        out.append({"rows": served.double().cpu().numpy(),
                    "index": kept.cpu().numpy(),
                    "n_gated": int(gate.sum())})
    return out
