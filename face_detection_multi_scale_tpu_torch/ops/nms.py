"""Fixed-capacity non-maximum suppression and the serving postprocess.

Counterpart of the JAX package's ops/nms.py, held index for index against
its `non_max_suppression(backend="xla")`: the two-stage confidence gate,
top-K by confidence, packed xywh gather -> xyxy, class offset, the greedy
keep mask, the first `max_det` keepers in score order, and landmarks
gathered for the keepers only. Every shape is fixed by (B, N, K, max_det);
validity travels in masks.

Ties: `jax.lax.top_k` puts equal scores in index order; `torch.topk`
promises no order, so every top-K here is a stable descending sort.

The keep mask is `ops/nms_kernel.nms_keep`: the CUDA kernel for any K on
a CUDA tensor, its plain version on a CPU tensor. The multi-scale merge
(`weighted_nms_merge`) takes its keep mask the same way, through
`nms_keep_matrix`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from face_detection_multi_scale_tpu_torch.ops.boxes import xywh2xyxy
from face_detection_multi_scale_tpu_torch.ops.nms_kernel import nms_keep

MAX_WH = 4096  # class-offset multiplier (reference utils/general.py:518)
NEG_INF = -1e30


class Detections(NamedTuple):
    """Fixed-capacity per-image detections.

    boxes:  (B, max_det, 4) xyxy in network-input pixels
    scores: (B, max_det)
    classes: (B, max_det)
    extras: (B, max_det, E) landmark triplets (x, y, conf) * nkpt, or E=0
    valid:  (B, max_det) bool
    n_gated: (B,) int32 — rows that cleared the confidence gate BEFORE the
        `max_candidates` truncation; n_gated > max_candidates means
        candidates were dropped (`truncation_stats` reports it).
    """
    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    extras: torch.Tensor
    valid: torch.Tensor
    n_gated: Optional[torch.Tensor] = None


def truncation_stats(n_gated, max_candidates: int) -> dict:
    """Summarize candidate-truncation telemetry from per-image n_gated."""
    n = np.asarray(n_gated).reshape(-1)
    return {
        "images": int(n.size),
        "truncated_images": int((n > max_candidates).sum()),
        "max_gated": int(n.max()) if n.size else 0,
        "max_candidates": int(max_candidates),
        "dropped_total": int(np.clip(n - max_candidates, 0, None).sum()),
    }


def _stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last dim, descending, equal values in index order
    (the order of `jax.lax.top_k`)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_keep_matrix(boxes: torch.Tensor, scores: torch.Tensor,
                    iou_thres: float, max_det: Optional[int] = None):
    """Exact greedy NMS of one image: (K, 4) xyxy boxes, (K,) scores with
    invalid rows at <= NEG_INF/2 -> (keep_idx (max_det,), valid
    (max_det,)): the first `max_det` (default K) kept indices in descending
    score order, then zeros. The counterpart of the JAX `nms_keep_matrix`;
    the keep mask is `nms_keep` (the kernel on a CUDA tensor)."""
    k = boxes.shape[0]
    max_det = k if max_det is None else max_det
    if not 0 <= max_det <= k:
        raise ValueError(f"max_det must be in [0, {k}], got {max_det}")
    s, order = torch.sort(scores, descending=True, stable=True)
    valid = s > NEG_INF / 2
    keep = nms_keep(boxes[order].float()[None], valid[None], iou_thres)[0]
    pos = torch.where(keep, torch.arange(k, device=boxes.device), k)
    pos_sorted, sel = torch.sort(pos, stable=True)
    sel_valid = pos_sorted[:max_det] < k
    keep_idx = torch.where(sel_valid, order[sel[:max_det]], 0).to(torch.int32)
    return keep_idx, sel_valid


def _gather_candidates_planar(pred: torch.Tensor, *, nc: int,
                              conf_thres: float, k: int):
    """Decoded rows (B, N, no) -> top-K candidates sorted by conf:
    (boxes, conf, cls, nms_boxes, valid, top_idx, n_gated)."""
    obj = pred[..., 4]
    if nc == 1:
        conf = pred[..., 5] * obj
        cls = None  # all zeros
    else:
        cls_conf = pred[..., 5:5 + nc] * obj[..., None]
        conf, cls = cls_conf.max(dim=-1)
        cls = cls.to(pred.dtype)
    # two-stage gate as in the reference: obj > thr then conf > thr
    gate = (obj > conf_thres) & (conf > conf_thres)
    n_gated = gate.sum(dim=-1).to(torch.int32)

    masked_conf = torch.where(gate, conf, torch.full_like(conf, NEG_INF))
    top_conf, top_idx = _stable_topk(masked_conf, k)
    xywh = torch.gather(pred[..., :4], 1,
                        top_idx[..., None].expand(-1, -1, 4))
    top_boxes = xywh2xyxy(xywh)
    top_cls = (torch.zeros_like(top_conf) if cls is None
               else torch.gather(cls, 1, top_idx))
    # per-class NMS by offsetting each class's boxes apart
    nms_boxes = top_boxes if nc == 1 else \
        top_boxes + (top_cls * MAX_WH)[..., None]
    valid = top_conf > NEG_INF / 2
    return top_boxes, top_conf, top_cls, nms_boxes, valid, top_idx, n_gated


def _select_kept_planar(keep, boxes, conf, cls, top_idx, pred, *,
                        nc: int, max_det: int) -> Detections:
    """First max_det kept candidates in score order; landmark channels
    gathered from `pred` for the keepers only. Unfilled slots point at
    candidate 0 with score 0 and valid False, as in the JAX version."""
    bs, k = keep.shape
    idx = torch.arange(k, device=keep.device)
    pos = torch.where(keep, idx[None, :], k)
    pos_sorted, sel = torch.sort(pos, dim=1, stable=True)
    sel_valid = pos_sorted[:, :max_det] < k
    sel = torch.where(sel_valid, sel[:, :max_det], 0)
    fin_boxes = torch.gather(boxes, 1, sel[..., None].expand(-1, -1, 4))
    fin_conf = torch.where(sel_valid, torch.gather(conf, 1, sel),
                           torch.zeros((), dtype=conf.dtype,
                                       device=conf.device))
    fin_cls = torch.gather(cls, 1, sel)
    fin_src = torch.gather(top_idx, 1, sel)  # (B, max_det) rows into pred

    n_extra = pred.shape[-1] - (5 + nc)
    if n_extra > 0:
        extras = torch.gather(pred[..., 5 + nc:], 1,
                              fin_src[..., None].expand(-1, -1, n_extra))
    else:
        extras = pred.new_zeros((bs, max_det, 0))
    return Detections(boxes=fin_boxes, scores=fin_conf, classes=fin_cls,
                      extras=extras, valid=sel_valid)


def non_max_suppression(pred: torch.Tensor, conf_thres: float = 0.25,
                        iou_thres: float = 0.45, *, nc: int = 1,
                        max_candidates: int = 4096,
                        max_det: int = 300) -> Detections:
    """Batched NMS: pred (B, N, 5+nc+3*nkpt) decoded rows -> Detections.

    Accuracy knob, the fixed capacities: at most `max_candidates` gated
    rows (top by conf) enter suppression and at most `max_det` come out;
    `n_gated` says when the first cap truncated an image."""
    k = min(max_candidates, pred.shape[1])
    boxes, conf, cls, nms_boxes, valid, top_idx, n_gated = \
        _gather_candidates_planar(pred, nc=nc, conf_thres=conf_thres, k=k)
    keep = nms_keep(nms_boxes.float().contiguous(), valid, iou_thres)
    dets = _select_kept_planar(keep, boxes, conf, cls, top_idx, pred,
                               nc=nc, max_det=min(max_det, k))
    return dets._replace(n_gated=n_gated)


def detections_to_numpy(dets: Detections):
    """Fixed-capacity Detections -> list of (n_i, 6+E) numpy arrays
    [x1, y1, x2, y2, conf, cls, extras...] (reference utils/general.py:509
    format). numpy has no bf16: bf16 fields come out as float32, the same
    values."""
    boxes, scores, classes, extras, valid = (
        (t.float() if t.dtype == torch.bfloat16 else t).detach().cpu()
        .numpy() for t in dets[:5])
    return [np.concatenate([boxes[i][valid[i]], scores[i][valid[i]][:, None],
                            classes[i][valid[i]][:, None],
                            extras[i][valid[i]]], axis=1)
            for i in range(boxes.shape[0])]


# ---------------------------------------------------------------------------
# Multi-scale weighted NMS (the TTA merge layer)
# ---------------------------------------------------------------------------

def scale_weights(boxes: torch.Tensor, scale_idx: torch.Tensor,
                  num_scales: int) -> torch.Tensor:
    """Size-vs-scale priors (reference multi_scale_face_detector.py:168-201),
    in float32 as the JAX version computes them: faces < 32^2 px found at
    the 2 largest scales x1.2; 32^2..128^2 at the middle scale x1.1;
    > 128^2 at the 2 smallest scales x1.2."""
    sizes = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    w = torch.ones_like(sizes)
    small = sizes < 1024.0
    medium = (sizes >= 1024.0) & (sizes <= 16384.0)
    large = sizes > 16384.0
    w = torch.where(small & (scale_idx >= num_scales - 2), w * 1.2, w)
    w = torch.where(medium & (scale_idx == num_scales // 2), w * 1.1, w)
    w = torch.where(large & (scale_idx <= 1), w * 1.2, w)
    return w


def weighted_nms(boxes: torch.Tensor, conf: torch.Tensor,
                 scale_idx: torch.Tensor, valid: torch.Tensor,
                 num_scales: int, iou_thres: float, max_det: int):
    """Cross-scale merge: weight confidences by the scale priors, run one
    NMS over all scales' boxes (in original-image space), and return
    (max_det,) indices into the input plus validity. The caller keeps the
    ORIGINAL (unweighted) rows of the keepers, as the reference does
    (multi_scale_face_detector.py:203-240)."""
    w = scale_weights(boxes, scale_idx, num_scales)
    weighted = torch.where(valid, conf * w, torch.full_like(conf, NEG_INF))
    return nms_keep_matrix(boxes, weighted, iou_thres, max_det)


def weighted_nms_merge(merged, num_scales: int, iou_thres: float,
                       device="cuda") -> np.ndarray:
    """Host entry point for the TTA merge: (n, >=7) numpy rows
    [x1, y1, x2, y2, conf, cls, scale_idx] -> keep indices in descending
    weighted-score order, the greedy keep on `device` (the kernel on the
    card).

    The JAX version pads n to a power-of-two bucket (min 128) only to
    bound its recompiles; the keep set does not depend on the padding,
    and the kernel takes any K, so this runs at K = n."""
    n = len(merged)
    if n == 0:
        return np.zeros((0,), np.int64)
    rows = torch.from_numpy(np.asarray(merged, np.float32)).to(device)
    idx, ok = weighted_nms(rows[:, :4], rows[:, 4], rows[:, 6],
                           torch.ones(n, dtype=torch.bool, device=rows.device),
                           num_scales, iou_thres, max_det=n)
    return idx[ok].cpu().numpy().astype(np.int64)
