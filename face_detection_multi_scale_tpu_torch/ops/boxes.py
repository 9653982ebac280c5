"""Box geometry: coordinate conversions and the IoU family (counterpart of
the JAX package's ops/boxes.py).

`xywh2xyxy` and `box_iou` serve the NMS path; the rest serve training:
`bbox_iou` with every penalty the reference offers (EIoU is the box
loss's, reference utils/loss.py:162), `wh_iou`, `box_area`, `xyxy2xywh`
and `xywhn2xyxy`. Every function takes any leading batch dims and keeps
the JAX package's operations and their order.
"""

from __future__ import annotations

import math

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) center-xywh -> corner-xyxy."""
    cx, cy, w2, h2 = x[..., 0], x[..., 1], x[..., 2] / 2, x[..., 3] / 2
    return torch.stack([cx - w2, cy - h2, cx + w2, cy + h2], dim=-1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) corner-xyxy -> center-xywh."""
    x1, y1, x2, y2 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                       dim=-1)


def xywhn2xyxy(x: torch.Tensor, w: float = 640, h: float = 640,
               padw: float = 0, padh: float = 0) -> torch.Tensor:
    """Normalized center-xywh -> pixel corner-xyxy with padding offset."""
    cx, cy, bw, bh = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return torch.stack([w * (cx - bw / 2) + padw, h * (cy - bh / 2) + padh,
                        w * (cx + bw / 2) + padw, h * (cy + bh / 2) + padh],
                       dim=-1)


def box_area(box: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) xyxy boxes."""
    return (box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1])


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


def wh_iou(wh1: torch.Tensor, wh2: torch.Tensor) -> torch.Tensor:
    """IoU of (N, 2) x (M, 2) width-height pairs, as if corner-anchored."""
    inter = torch.minimum(wh1[:, None, :], wh2[None, :, :]).prod(-1)
    return inter / (wh1.prod(-1)[:, None] + wh2.prod(-1)[None, :] - inter)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, *, xywh: bool = False,
             kind: str = "iou", eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU between broadcast-matched boxes with optional
    GIoU / DIoU / CIoU / EIoU / SIoU penalty terms (reference
    utils/general.py:407-471).

    ``kind`` in {"iou", "giou", "diou", "ciou", "eiou", "siou"}. Inputs
    broadcast elementwise over leading dims; the last dim is 4. CIoU's
    alpha carries no gradient (the reference computes it under no_grad).
    """
    if xywh:
        b1, b2 = xywh2xyxy(box1), xywh2xyxy(box2)
    else:
        b1, b2 = box1, box2
    b1_x1, b1_y1, b1_x2, b1_y2 = b1[..., 0], b1[..., 1], b1[..., 2], b1[..., 3]
    b2_x1, b2_y1, b2_x2, b2_y2 = b2[..., 0], b2[..., 1], b2[..., 2], b2[..., 3]

    inter = ((torch.minimum(b1_x2, b2_x2)
              - torch.maximum(b1_x1, b2_x1)).clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2)
                - torch.maximum(b1_y1, b2_y1)).clamp(min=0))

    # union; the reference adds eps to heights only (utils/general.py:434)
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if kind == "iou":
        return iou

    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    if kind == "giou":
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area

    c2 = cw ** 2 + ch ** 2 + eps  # convex diagonal squared
    rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2
            + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
    if kind == "diou":
        return iou - rho2 / c2
    if kind == "ciou":
        v = (4 / math.pi ** 2) * (torch.atan(w2 / h2)
                                  - torch.atan(w1 / h1)) ** 2
        alpha = (v / (v - iou + (1 + eps))).detach()
        return iou - (rho2 / c2 + v * alpha)
    if kind == "eiou":
        w_dis = (b1_x2 - b1_x1 - b2_x2 + b2_x1) ** 2
        h_dis = (b1_y2 - b1_y1 - b2_y2 + b2_y1) ** 2
        return iou - (rho2 / c2 + w_dis / (cw ** 2 + eps)
                      + h_dis / (ch ** 2 + eps))
    if kind == "siou":
        s_cw = (b2_x1 + b2_x2 - b1_x1 - b1_x2) * 0.5
        s_ch = (b2_y1 + b2_y2 - b1_y1 - b1_y2) * 0.5
        sigma = torch.sqrt(s_cw ** 2 + s_ch ** 2)
        sin_a1 = s_cw.abs() / sigma
        sin_a2 = s_ch.abs() / sigma
        threshold = math.sqrt(2) / 2
        sin_alpha = torch.where(sin_a1 > threshold, sin_a2, sin_a1)
        angle_cost = torch.cos(torch.arcsin(sin_alpha) * 2 - math.pi / 2)
        rho_x = (s_cw / cw) ** 2
        rho_y = (s_ch / ch) ** 2
        gamma = angle_cost - 2
        distance_cost = 2 - torch.exp(gamma * rho_x) - torch.exp(
            gamma * rho_y)
        omiga_w = (w1 - w2).abs() / torch.maximum(w1, w2)
        omiga_h = (h1 - h2).abs() / torch.maximum(h1, h2)
        shape_cost = ((1 - torch.exp(-omiga_w)) ** 4
                      + (1 - torch.exp(-omiga_h)) ** 4)
        return iou - 0.5 * (distance_cost + shape_cost)
    raise ValueError(f"unknown IoU kind: {kind!r}")
