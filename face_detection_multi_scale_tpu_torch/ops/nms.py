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
`nms_keep_matrix`, and so does `non_max_suppression_from_raws`, the
postprocess straight from the conv-layout head maps. Where the JAX entry
points take `backend=` (Pallas or XLA), the port decides by the tensor's
device. `nms_indices` (the select-max/suppress loop) and
`merge_nms_boxes` are plain tensor code, as their JAX versions are plain
XLA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from face_detection_multi_scale_tpu_torch.ops.boxes import box_iou, xywh2xyxy
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


def nms_indices(boxes: torch.Tensor, scores: torch.Tensor,
                iou_thres: float, max_det: int):
    """Greedy NMS of one image by the select-max/suppress loop: (N, 4)
    xyxy boxes, (N,) scores with invalid rows at <= NEG_INF/2 ->
    (keep_idx (max_det,) int32, valid (max_det,) bool). `max_det` steps
    of an argmax (the first of equal maxima, as `jnp.argmax`) and an IoU
    suppression, the same output as sequential greedy NMS cut at `max_det`
    keeps (the JAX `nms_indices`)."""
    boxes = torch.as_tensor(boxes)
    live = torch.as_tensor(scores, device=boxes.device).clone()
    n = boxes.shape[0]
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    keep_idx = torch.zeros(max_det, dtype=torch.int32, device=boxes.device)
    keep_valid = torch.zeros(max_det, dtype=torch.bool, device=boxes.device)
    ar = torch.arange(n, device=boxes.device)
    for i in range(max_det):
        best = int(torch.argmax(live))
        if not bool(live[best] > NEG_INF / 2):
            # nothing live is left: every later step keeps nothing too
            break
        keep_idx[i], keep_valid[i] = best, True
        iw = (torch.minimum(x2, x2[best])
              - torch.maximum(x1, x1[best])).clamp(min=0)
        ih = (torch.minimum(y2, y2[best])
              - torch.maximum(y1, y1[best])).clamp(min=0)
        inter = iw * ih
        iou = inter / (areas + areas[best] - inter)
        live = torch.where((iou > iou_thres) | (ar == best),
                           torch.full_like(live, NEG_INF), live)
    return keep_idx, keep_valid


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
                              conf_thres: float, k: int,
                              agnostic: bool = False):
    """Decoded rows (B, N, no) -> top-K candidates sorted by conf:
    (boxes, conf, cls, nms_boxes, valid, top_idx, n_gated). With
    `agnostic` (or one class) the NMS boxes are the boxes themselves;
    otherwise each class is offset by cls * MAX_WH, so NMS runs per
    class."""
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
    nms_boxes = top_boxes if (agnostic or nc == 1) else \
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
                        nkpt: int = 5, max_candidates: int = 4096,
                        max_det: int = 300,
                        agnostic: bool = False) -> Detections:
    """Batched NMS: pred (B, N, 5+nc+3*nkpt) decoded rows -> Detections.

    Accuracy knob, the fixed capacities: at most `max_candidates` gated
    rows (top by conf) enter suppression and at most `max_det` come out;
    `n_gated` says when the first cap truncated an image. With nc > 1 the
    suppression is per class unless `agnostic`. `nkpt` is taken for the
    JAX signature's sake: the landmark width comes from `pred`."""
    k = min(max_candidates, pred.shape[1])
    boxes, conf, cls, nms_boxes, valid, top_idx, n_gated = \
        _gather_candidates_planar(pred, nc=nc, conf_thres=conf_thres, k=k,
                                  agnostic=agnostic)
    keep = nms_keep(nms_boxes.float().contiguous(), valid, iou_thres)
    dets = _select_kept_planar(keep, boxes, conf, cls, top_idx, pred,
                               nc=nc, max_det=min(max_det, k))
    return dets._replace(n_gated=n_gated)


def non_max_suppression_from_raws(raws, spec, conf_thres: float,
                                  iou_thres: float, *,
                                  max_candidates: int = 2048,
                                  max_det: int = 300) -> Detections:
    """The postprocess straight from the conv-layout head maps (per level
    (B, ny, nx, na*no), `YoloFace(x, reshape_heads=False)`), with the
    output of `decode` + `non_max_suppression` up to the order of float
    operations (the JAX `non_max_suppression_from_raws`):

    1. a planar decode of boxes and conf for every anchor, in float32:
       (B, N) planes from strided channel slices, in decode's candidate
       order (level-major, anchor-major, raster cells);
    2. the two-stage gate, the stable top-K by conf and one packed box
       gather;
    3. the keep mask (`nms_keep`: the kernel on a CUDA tensor) and the
       first `max_det` keepers in score order;
    4. the landmark channels gathered and decoded for the keepers only.

    As in the JAX version, classes are all 0 (the conf is obj times the
    best class score, and NMS is not per class)."""
    na, no, nc, nkpt = spec.na, spec.no, spec.nc, spec.nkpt
    bs = raws[0].shape[0]
    dev = raws[0].device

    # ---- stage 1: planar decode of boxes + conf for ALL anchors ----
    x1p, y1p, x2p, y2p, confp, objp = [], [], [], [], [], []
    levels = []  # (offset, cells, nx, (B, cells, ch) raw)
    offset = 0
    for lvl, raw in enumerate(raws):
        _, ny, nx, ch = raw.shape
        cells = ny * nx
        stride = float(spec.strides[lvl])
        anchors = torch.tensor(spec.anchors[lvl],
                               dtype=torch.float64).reshape(-1, 2).tolist()
        gy = torch.arange(ny, dtype=torch.float32, device=dev)[:, None] \
            .expand(ny, nx).reshape(-1)
        gx = torch.arange(nx, dtype=torch.float32, device=dev)[None, :] \
            .expand(ny, nx).reshape(-1)
        r2 = raw.reshape(bs, cells, ch)
        for a in range(na):
            t = r2[:, :, a * no:a * no + 5 + nc].float()
            obj = torch.sigmoid(t[:, :, 4])
            cls = torch.sigmoid(t[:, :, 5:5 + nc]).amax(dim=-1)
            cx = (torch.sigmoid(t[:, :, 0]) * 2.0 - 0.5 + gx) * stride
            cy = (torch.sigmoid(t[:, :, 1]) * 2.0 - 0.5 + gy) * stride
            w = (torch.sigmoid(t[:, :, 2]) * 2.0) ** 2 * anchors[a][0]
            h = (torch.sigmoid(t[:, :, 3]) * 2.0) ** 2 * anchors[a][1]
            x1p.append(cx - w / 2)
            y1p.append(cy - h / 2)
            x2p.append(cx + w / 2)
            y2p.append(cy + h / 2)
            confp.append(obj * cls)
            objp.append(obj)
        levels.append((offset, cells, nx, r2))
        offset += na * cells
    conf = torch.cat(confp, 1)
    obj = torch.cat(objp, 1)

    # ---- stage 2: gate, stable top-K, one packed box gather ----
    gate = (obj > conf_thres) & (conf > conf_thres)
    masked = torch.where(gate, conf, torch.full_like(conf, NEG_INF))
    k = min(max_candidates, conf.shape[1])
    top_conf, top_idx = _stable_topk(masked, k)
    valid = top_conf > NEG_INF / 2
    xyxy = torch.stack([torch.cat(x1p, 1), torch.cat(y1p, 1),
                        torch.cat(x2p, 1), torch.cat(y2p, 1)], dim=-1)
    boxes = torch.gather(xyxy, 1, top_idx[..., None].expand(-1, -1, 4))

    # ---- stage 3: the keep mask, the first max_det keepers ----
    keep = nms_keep(boxes.contiguous(), valid, iou_thres)
    max_det = min(max_det, k)
    pos = torch.where(keep, torch.arange(k, device=dev)[None, :], k)
    pos_sorted, sel = torch.sort(pos, dim=1, stable=True)
    sel_valid = pos_sorted[:, :max_det] < k
    sel = torch.where(sel_valid, sel[:, :max_det], 0)
    fin_boxes = torch.gather(boxes, 1, sel[..., None].expand(-1, -1, 4))
    fin_conf = torch.where(sel_valid, torch.gather(top_conf, 1, sel),
                           torch.zeros((), device=dev))
    fin_idx = torch.gather(top_idx, 1, sel)  # (B, max_det) rows of the N

    # ---- stage 4: landmark channels for the keepers only ----
    extras = torch.zeros((bs, max_det, 3 * nkpt), device=dev)
    comp = torch.arange(3 * nkpt, device=dev)
    for lvl, (off, cells, nx, r2) in enumerate(levels):
        ch = r2.shape[-1]
        stride = float(spec.strides[lvl])
        local = fin_idx - off
        in_lvl = (local >= 0) & (local < na * cells)
        local = local.clamp(0, na * cells - 1)
        a_idx, cell = local // cells, local % cells
        gy = (cell // nx).float()
        gx = (cell % nx).float()
        base = cell * ch + a_idx * no + (5 + nc)
        gidx = (base[:, :, None] + comp).reshape(bs, max_det * 3 * nkpt)
        got = torch.gather(r2.reshape(bs, cells * ch), 1, gidx).reshape(
            bs, max_det, 3 * nkpt).float()
        kx = (got[:, :, 0::3] * 2.0 - 0.5 + gx[:, :, None]) * stride
        ky = (got[:, :, 1::3] * 2.0 - 0.5 + gy[:, :, None]) * stride
        kc = torch.sigmoid(got[:, :, 2::3])
        dec = torch.stack([kx, ky, kc], dim=-1).reshape(bs, max_det,
                                                        3 * nkpt)
        extras = torch.where(in_lvl[:, :, None], dec, extras)

    return Detections(boxes=fin_boxes, scores=fin_conf,
                      classes=torch.zeros((bs, max_det), device=dev),
                      extras=extras, valid=sel_valid,
                      n_gated=gate.sum(dim=1).to(torch.int32))


def merge_nms_boxes(dets: Detections, all_boxes: torch.Tensor,
                    all_conf: torch.Tensor, iou_thres: float) -> Detections:
    """Merge-NMS refinement (reference utils/general.py:587-593): each
    kept box becomes the confidence-weighted mean of every candidate box
    (B, K, 4) overlapping it above the IoU threshold, weights (B, K)
    `all_conf`. The (max_det, K) weight product is a plain matmul, as in
    the JAX version."""
    iou = box_iou(dets.boxes, all_boxes)  # (B, max_det, K)
    w = (iou > iou_thres).to(all_conf.dtype) * all_conf[:, None, :]
    merged = (w @ all_boxes) / w.sum(dim=2, keepdim=True).clamp(min=1e-9)
    return dets._replace(boxes=merged)


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
