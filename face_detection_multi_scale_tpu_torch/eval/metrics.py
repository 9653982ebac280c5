"""Detection metrics: mAP accumulation, fitness, confusion matrix.

A copy of the JAX package's eval/metrics.py (numpy only). A numpy
re-implementation with reference semantics
(reference utils/metrics.py:12-106 fitness/ap_per_class/compute_ap,
:109-181 ConfusionMatrix; greedy prediction<->GT matching at IoU ladder
0.5:0.95 from test.py:242-276).
"""

from __future__ import annotations

from typing import List

import numpy as np

IOUV = np.linspace(0.5, 0.95, 10)


def fitness(p, r, map50, map_):
    """0.1 * mAP@.5 + 0.9 * mAP@.5:.95 (utils/metrics.py:12-15)."""
    return 0.1 * map50 + 0.9 * map_


def box_iou_np(box1: np.ndarray, box2: np.ndarray) -> np.ndarray:
    """(N,4)x(M,4) xyxy IoU (utils/general.py:473-495)."""
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    lt = np.maximum(box1[:, None, :2], box2[None, :, :2])
    rb = np.minimum(box1[:, None, 2:], box2[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(2)
    return inter / (area1[:, None] + area2[None, :] - inter)


def match_predictions(pred: np.ndarray, gt_boxes: np.ndarray,
                      gt_cls: np.ndarray,
                      iouv: np.ndarray = IOUV) -> np.ndarray:
    """Per-image TP matrix (n_pred, len(iouv)): greedy class-aware matching
    exactly as test.py:242-276 — per GT class, best-IoU pairing with each
    GT consumed once per threshold column."""
    n = len(pred)
    correct = np.zeros((n, len(iouv)), bool)
    if n == 0 or len(gt_boxes) == 0:
        return correct
    detected: List[int] = []
    for c in np.unique(gt_cls):
        ti = np.where(gt_cls == c)[0]
        pi = np.where(pred[:, 5] == c)[0]
        if len(pi) == 0:
            continue
        ious_all = box_iou_np(pred[pi, :4], gt_boxes[ti])
        best_i = ious_all.argmax(1)
        best_iou = ious_all.max(1)
        detected_set = set()
        for j in np.where(best_iou > iouv[0])[0]:
            d = ti[best_i[j]]
            if d.item() not in detected_set:
                detected_set.add(d.item())
                detected.append(d)
                correct[pi[j]] = best_iou[j] > iouv
                if len(detected) == len(gt_boxes):
                    break
    return correct


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray,
                 target_cls: np.ndarray):
    """P, R, AP per class from accumulated stats
    (utils/metrics.py:18-79). tp is (n, n_iou_thresholds)."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes = np.unique(target_cls)
    nc = len(unique_classes)

    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p = np.zeros((nc, 1000))
    r = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        n_l = (target_cls == c).sum()
        n_p = i.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + 1e-16)
        r[ci] = np.interp(-px, -conf[i], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p[ci] = np.interp(-px, -conf[i], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j] = compute_ap(recall[:, j], precision[:, j])[0]

    f1 = 2 * p * r / (p + r + 1e-16)
    i = f1.mean(0).argmax()
    return p[:, i], r[:, i], ap, f1[:, i], unique_classes.astype(np.int32)


def compute_ap(recall, precision):
    """101-point interpolated AP (utils/metrics.py:82-106)."""
    mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x) if hasattr(
        np, "trapezoid") else np.trapz(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


class ConfusionMatrix:
    """Detection confusion matrix (utils/metrics.py:109-181)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray):
        """detections (n, 6) [x1,y1,x2,y2,conf,cls]; labels (m, 5)
        [cls,x1,y1,x2,y2]."""
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int)
        det_classes = detections[:, 5].astype(int)
        iou = box_iou_np(labels[:, 1:], detections[:, :4])
        x = np.where(iou > self.iou_thres)
        if len(x[0]):
            matches = np.concatenate(
                [np.stack(x, 1), iou[x][:, None]], 1)
            if len(x[0]) > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1],
                                            return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0],
                                            return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))
        n = len(matches) > 0
        m0, m1, _ = matches.astype(int).T if n else (np.array([], int),) * 3
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[det_classes[m1[j][0]], gc] += 1
            else:
                self.matrix[self.nc, gc] += 1  # background FN
        if n:
            for i, dc in enumerate(det_classes):
                if not (m1 == i).any():
                    self.matrix[dc, self.nc] += 1  # background FP

    def values(self):
        return self.matrix
