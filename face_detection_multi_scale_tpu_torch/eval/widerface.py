"""WIDER FACE official evaluation protocol.

A copy of the JAX package's eval/widerface.py (numpy and scipy), whose
IoU runs through the port's native library (native/). A re-implementation
of the reference harness (reference widerface_evaluate/evaluation.py:
18-281 and the Cython IoU kernel widerface_evaluate/box_overlaps.pyx:
15-55) with vectorized numpy:

  * ground truth from the 4 .mat files (boxes + easy/medium/hard keep lists)
  * predictions from per-event txt dirs ("name, count, x y w h score" rows)
  * global min-max score normalization across the entire prediction set
  * per-image greedy matching with ignore regions at IoU 0.5, +1 pixel
    area convention
  * 1000-threshold PR accumulation and VOC AP

The inner 1000-threshold loop is replaced by an exact cumulative-sum
formulation (same output, ~100x faster); the greedy match keeps the
reference's sequential semantics because recall marking is order-dependent.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

THRESH_NUM = 1000


def _overlaps(boxes, query):
    """Use the port's native C++ IoU (native/, built with g++) when it
    builds, numpy otherwise."""
    from face_detection_multi_scale_tpu_torch import native
    if native.available():
        return native.bbox_overlaps_plus1(boxes, query)
    return bbox_overlaps_plus1(boxes, query)


def bbox_overlaps_plus1(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Pairwise IoU with the +1 pixel convention of the reference Cython
    kernel (widerface_evaluate/box_overlaps.pyx:15-55): (N,4)x(K,4)->(N,K).
    """
    boxes = boxes.astype(np.float64)
    query = query.astype(np.float64)
    area_q = ((query[:, 2] - query[:, 0] + 1)
              * (query[:, 3] - query[:, 1] + 1))  # (K,)
    iw = (np.minimum(boxes[:, None, 2], query[None, :, 2])
          - np.maximum(boxes[:, None, 0], query[None, :, 0]) + 1)
    ih = (np.minimum(boxes[:, None, 3], query[None, :, 3])
          - np.maximum(boxes[:, None, 1], query[None, :, 1]) + 1)
    iw = np.clip(iw, 0, None)
    ih = np.clip(ih, 0, None)
    area_b = ((boxes[:, 2] - boxes[:, 0] + 1)
              * (boxes[:, 3] - boxes[:, 1] + 1))
    inter = iw * ih
    ua = area_b[:, None] + area_q[None, :] - inter
    # the reference computes ua only where iw,ih > 0; elsewhere IoU is 0
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(inter > 0, inter / ua, 0.0)
    return out


def load_gt(gt_dir: str):
    """Load the 4 MATLAB ground-truth files
    (widerface_evaluate/evaluation.py:18-34)."""
    from scipy.io import loadmat

    gt_mat = loadmat(os.path.join(gt_dir, "wider_face_val.mat"))
    keep = {
        "easy": loadmat(os.path.join(gt_dir, "wider_easy_val.mat"))["gt_list"],
        "medium": loadmat(os.path.join(gt_dir, "wider_medium_val.mat"))["gt_list"],
        "hard": loadmat(os.path.join(gt_dir, "wider_hard_val.mat"))["gt_list"],
    }
    return (gt_mat["face_bbx_list"], gt_mat["event_list"],
            gt_mat["file_list"], keep)


def read_pred_file(path: str) -> Tuple[str, np.ndarray]:
    """One prediction txt: first line image name, second line count, then
    `x y w h score` rows (widerface_evaluate/evaluation.py:82-101)."""
    with open(path) as f:
        lines = f.read().splitlines()
    name = lines[0].strip()
    rows = []
    for line in lines[2:]:
        parts = line.split(" ")
        if parts[0] == "":
            continue
        rows.append([float(v) for v in parts[:5]])
    return name.split("/")[-1], np.array(rows, np.float64).reshape(-1, 5)


def load_preds(pred_dir: str) -> Dict[str, Dict[str, np.ndarray]]:
    preds: Dict[str, Dict[str, np.ndarray]] = {}
    for event in sorted(os.listdir(pred_dir)):
        event_dir = os.path.join(pred_dir, event)
        if not os.path.isdir(event_dir):
            continue
        cur = {}
        for txt in os.listdir(event_dir):
            name, boxes = read_pred_file(os.path.join(event_dir, txt))
            cur[name.removesuffix(".jpg")] = boxes
        preds[event] = cur
    return preds


def norm_scores(preds: Dict[str, Dict[str, np.ndarray]]):
    """Global min-max normalize all scores in place
    (widerface_evaluate/evaluation.py:121-143). Note the reference seeds
    max=0 / min=1, so the range is clamped to at least [min(s,1), max(s,0)].
    """
    max_score, min_score = 0.0, 1.0
    for event in preds.values():
        for v in event.values():
            if len(v):
                max_score = max(max_score, v[:, -1].max())
                min_score = min(min_score, v[:, -1].min())
    diff = max_score - min_score
    for event in preds.values():
        for v in event.values():
            if len(v):
                v[:, -1] = (v[:, -1] - min_score) / diff


def image_eval(pred: np.ndarray, gt: np.ndarray, ignore: np.ndarray,
               iou_thresh: float) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy per-image matching (widerface_evaluate/evaluation.py:146-179).
    pred rows are (x, y, w, h, score) sorted by descending score; gt rows
    are (x, y, w, h). Returns (pred_recall, proposal_list)."""
    p = pred.copy()
    g = gt.copy()
    p[:, 2] += p[:, 0]
    p[:, 3] += p[:, 1]
    g[:, 2] += g[:, 0]
    g[:, 3] += g[:, 1]
    overlaps = _overlaps(p[:, :4], g)

    pred_recall = np.zeros(len(p), np.int64)
    recall_list = np.zeros(len(g), np.int64)
    proposal_list = np.ones(len(p), np.int64)
    max_overlap = overlaps.max(axis=1)
    max_idx = overlaps.argmax(axis=1)
    recalled = 0
    for h in range(len(p)):
        if max_overlap[h] >= iou_thresh:
            mi = max_idx[h]
            if ignore[mi] == 0:
                if recall_list[mi] == 1:
                    recalled -= 1
                recall_list[mi] = -1
                proposal_list[h] = -1
            elif recall_list[mi] == 0:
                recall_list[mi] = 1
                recalled += 1
        pred_recall[h] = recalled
    return pred_recall, proposal_list


def img_pr_info(pred_scores: np.ndarray, proposal_list: np.ndarray,
                pred_recall: np.ndarray,
                thresh_num: int = THRESH_NUM) -> np.ndarray:
    """Per-image PR accumulation, vectorized cumulative-sum equivalent of
    widerface_evaluate/evaluation.py:182-196: for each threshold t the
    reference takes the LAST prediction index with score >= thresh, counts
    kept proposals up to it, and reads pred_recall there."""
    n = len(pred_scores)
    pr = np.zeros((thresh_num, 2), np.float64)
    if n == 0:
        return pr
    threshes = 1.0 - (np.arange(1, thresh_num + 1) / thresh_num)
    kept_cum = np.cumsum(proposal_list == 1)
    if np.all(pred_scores[:-1] >= pred_scores[1:]):
        # descending scores (NMS output order): last index with
        # score >= thresh via searchsorted
        counts = np.searchsorted(-pred_scores, -threshes, side="right")
    else:
        # arbitrary file order: the reference takes the LAST row index
        # with score >= thresh; suffix-max gives it vectorized
        suffix_max = np.maximum.accumulate(pred_scores[::-1])[::-1]
        # last index where suffix_max >= t == count of rows whose suffix
        # max clears the threshold
        counts = np.searchsorted(-suffix_max, -threshes, side="right")
    valid = counts > 0
    idx = counts[valid] - 1
    pr[valid, 0] = kept_cum[idx]
    pr[valid, 1] = pred_recall[idx]
    return pr


def voc_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """VOC-style AP (widerface_evaluate/evaluation.py:207-224)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluation(pred_dir: str, gt_dir: str, iou_thresh: float = 0.5,
               verbose: bool = True) -> Dict[str, float]:
    """Full protocol: returns {'easy': AP, 'medium': AP, 'hard': AP}
    (widerface_evaluate/evaluation.py:227-281)."""
    preds = load_preds(pred_dir)
    norm_scores(preds)
    facebox_list, event_list, file_list, keep = load_gt(gt_dir)
    event_num = len(event_list)
    aps: Dict[str, float] = {}
    for setting in ("easy", "medium", "hard"):
        gt_list = keep[setting]
        count_face = 0
        pr_curve = np.zeros((THRESH_NUM, 2), np.float64)
        for i in range(event_num):
            event_name = str(event_list[i][0][0])
            img_list = file_list[i][0]
            pred_list = preds[event_name]
            sub_gt_list = gt_list[i][0]
            gt_bbx_list = facebox_list[i][0]
            for j in range(len(img_list)):
                pred_info = pred_list[str(img_list[j][0][0])]
                gt_boxes = gt_bbx_list[j][0].astype(np.float64)
                keep_index = sub_gt_list[j][0]
                count_face += len(keep_index)
                if len(gt_boxes) == 0 or len(pred_info) == 0:
                    continue
                ignore = np.zeros(len(gt_boxes), np.int64)
                if len(keep_index) != 0:
                    ignore[keep_index.reshape(-1) - 1] = 1
                pred_recall, proposal_list = image_eval(
                    pred_info, gt_boxes, ignore, iou_thresh)
                pr_curve += img_pr_info(pred_info[:, 4], proposal_list,
                                        pred_recall)
        with np.errstate(divide="ignore", invalid="ignore"):
            precision = pr_curve[:, 1] / pr_curve[:, 0]
            recall = pr_curve[:, 1] / count_face
        precision = np.nan_to_num(precision)
        aps[setting] = voc_ap(recall, precision)
    if verbose:
        print("==================== Results ====================")
        print(f"Easy   Val AP: {aps['easy']}")
        print(f"Medium Val AP: {aps['medium']}")
        print(f"Hard   Val AP: {aps['hard']}")
        print("=================================================")
    return aps


def write_pred_file(path: str, name: str, rows) -> None:
    """Write one prediction txt in the exact reference format
    (test_widerface.py:88-114): name line, count line, then
    `x1 y1 w h conf` with int(v + 0.5) rounding and conf clamped to <= 1,
    conf printed as %.03f."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(name + "\n")
        f.write(str(len(rows)) + "\n")
        for x1, y1, x2, y2, conf in rows:
            ix1, iy1 = int(x1 + 0.5), int(y1 + 0.5)
            ix2, iy2 = int(x2 + 0.5), int(y2 + 0.5)
            c = conf if conf <= 1 else 1
            f.write("%d %d %d %d %.03f\n" % (ix1, iy1, ix2 - ix1,
                                             iy2 - iy1, c))
