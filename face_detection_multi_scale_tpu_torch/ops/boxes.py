"""Box geometry used by the NMS path (counterpart of the JAX package's
ops/boxes.py, only what the postprocess needs)."""

from __future__ import annotations

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) center-xywh -> corner-xyxy."""
    cx, cy, w2, h2 = x[..., 0], x[..., 1], x[..., 2] / 2, x[..., 3] / 2
    return torch.stack([cx - w2, cy - h2, cx + w2, cy + h2], dim=-1)


def box_iou(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) x (..., M, 4) xyxy boxes -> (..., N, M).

    The operations and their order are those of the JAX package's
    `nms_keep_matrix` and of the NMS kernels, so the results agree to the
    bit: area = max(x2-x1, 0) * max(y2-y1, 0), inter = iw * ih,
    iou = inter / ((area1 + area2) - inter). Zero-area pairs give NaN,
    which compares false against any threshold."""
    def area(b):
        return ((b[..., 2] - b[..., 0]).clamp(min=0)
                * (b[..., 3] - b[..., 1]).clamp(min=0))

    a = box1[..., :, None, :]
    b = box2[..., None, :, :]
    iw = (torch.minimum(a[..., 2], b[..., 2])
          - torch.maximum(a[..., 0], b[..., 0])).clamp(min=0)
    ih = (torch.minimum(a[..., 3], b[..., 3])
          - torch.maximum(a[..., 1], b[..., 1])).clamp(min=0)
    inter = iw * ih
    return inter / (area(box1)[..., :, None] + area(box2)[..., None, :]
                    - inter)
