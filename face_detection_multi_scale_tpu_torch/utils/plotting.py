"""Drawing helpers: detection boxes + 5-point landmarks on images (a copy
of the JAX package's utils/plotting.py).

Equivalent role to the reference plot_one_box / plot_skeleton_kpts
(reference utils/plots.py:68-107) using cv2 primitives; cv2 is imported
inside the function that draws, so the module imports without OpenCV.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

_PALETTE = [
    (56, 56, 255), (151, 157, 255), (31, 112, 255), (29, 178, 255),
    (49, 210, 207), (10, 249, 72), (23, 204, 146), (134, 219, 61),
    (52, 147, 26), (187, 212, 0), (168, 153, 44), (255, 194, 0),
    (147, 69, 52), (255, 115, 100), (236, 24, 0), (255, 56, 132),
    (133, 0, 82), (255, 56, 203), (200, 149, 255), (199, 55, 255),
]

_KPT_COLORS = [(0, 255, 0), (255, 0, 0), (0, 0, 255), (255, 255, 0),
               (0, 255, 255)]


def color(i: int):
    return _PALETTE[int(i) % len(_PALETTE)]


def draw_detection(img: np.ndarray, box, conf: Optional[float] = None,
                   cls: int = 0, label: Optional[str] = None,
                   kpts: Optional[Sequence[float]] = None,
                   kpt_conf_thres: float = 0.5,
                   line_thickness: Optional[int] = None) -> None:
    """Draw one detection (and optional landmark triplets) in place."""
    import cv2

    tl = line_thickness or max(
        1, round(0.002 * (img.shape[0] + img.shape[1]) / 2))
    c = color(cls)
    p1 = (int(box[0]), int(box[1]))
    p2 = (int(box[2]), int(box[3]))
    cv2.rectangle(img, p1, p2, c, tl, lineType=cv2.LINE_AA)
    if label:
        tf = max(tl - 1, 1)
        w, h = cv2.getTextSize(label, 0, tl / 3, tf)[0]
        outside = p1[1] - h - 3 >= 0
        p2t = (p1[0] + w, p1[1] - h - 3 if outside else p1[1] + h + 3)
        cv2.rectangle(img, p1, p2t, c, -1, cv2.LINE_AA)
        cv2.putText(img, label,
                    (p1[0], p1[1] - 2 if outside else p1[1] + h + 2),
                    0, tl / 3, (255, 255, 255), tf, cv2.LINE_AA)
    if kpts is not None:
        kpts = np.asarray(kpts).reshape(-1, 3)
        for i, (x, y, kc) in enumerate(kpts):
            if kc > kpt_conf_thres:
                cv2.circle(img, (int(x), int(y)), max(tl, 2),
                           _KPT_COLORS[i % len(_KPT_COLORS)], -1,
                           cv2.LINE_AA)


def draw_detections(img: np.ndarray, rows: np.ndarray, names=("face",),
                    hide_labels: bool = False, hide_conf: bool = False,
                    nkpt: int = 5, **kw) -> np.ndarray:
    """Draw all rows [x1,y1,x2,y2,conf,cls,(kpt triplets...)] in place."""
    for row in rows:
        cls = int(row[5])
        label = None
        if not hide_labels:
            name = names[cls] if cls < len(names) else str(cls)
            label = name if hide_conf else f"{name} {row[4]:.2f}"
        kpts = row[6:6 + 3 * nkpt] if len(row) >= 6 + 3 * nkpt else None
        draw_detection(img, row[:4], row[4], cls, label, kpts, **kw)
    return img
