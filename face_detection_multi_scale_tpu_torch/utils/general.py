"""Small shape/size, file and training utilities (copies of the JAX
package's `make_divisible`, `check_img_size`, `increment_path`,
`_xyxy2xywh_np`, `_xywh2xyxy_np`, `save_one_box`, `init_seeds`,
`labels_to_class_weights` and `labels_to_image_weights`)."""

from __future__ import annotations

import math
import random
from pathlib import Path

import numpy as np
import torch


def make_divisible(x: float, divisor: int) -> int:
    """Round ``x`` up to the nearest multiple of ``divisor``."""
    return int(math.ceil(x / divisor) * divisor)


def check_img_size(img_size: int, s: int = 32) -> int:
    """Round ``img_size`` up to a multiple of the stride ``s``."""
    return make_divisible(img_size, int(s))


def increment_path(path, exist_ok: bool = False, mkdir: bool = False):
    """runs/exp -> runs/exp2, runs/exp3, ... (reference
    utils/general.py:730-744). Returns the first free path; with
    ``mkdir`` also creates the directory (the parent, for a file)."""
    path = Path(path)
    if path.exists() and not exist_ok:
        suffix = path.suffix
        stem = path.with_suffix("")
        n = 2
        while Path(f"{stem}{n}{suffix}").exists():
            n += 1
        path = Path(f"{stem}{n}{suffix}")
    if mkdir:
        (path if not path.suffix else path.parent).mkdir(
            parents=True, exist_ok=True)
    return path


def _xyxy2xywh_np(x):
    y = np.copy(x).astype(np.float64)
    y[:, 0] = (x[:, 0] + x[:, 2]) / 2
    y[:, 1] = (x[:, 1] + x[:, 3]) / 2
    y[:, 2] = x[:, 2] - x[:, 0]
    y[:, 3] = x[:, 3] - x[:, 1]
    return y


def _xywh2xyxy_np(x):
    y = np.copy(x)
    y[:, 0] = x[:, 0] - x[:, 2] / 2
    y[:, 1] = x[:, 1] - x[:, 3] / 2
    y[:, 2] = x[:, 0] + x[:, 2] / 2
    y[:, 3] = x[:, 1] + x[:, 3] / 2
    return y


def save_one_box(xyxy, im, file="image.jpg", gain: float = 1.02,
                 pad: int = 10, square: bool = False, BGR: bool = False):
    """Save one padded detection crop (reference utils/general.py:717-727):
    box wh * gain + pad, optionally made square, clipped to the image,
    written as a .jpg under an increment_path'd name. ``im`` is HWC; with
    BGR=False it is RGB and the channels are swapped for cv2."""
    import cv2

    b = _xyxy2xywh_np(np.asarray(xyxy, np.float64).reshape(-1, 4))
    if square:
        b[:, 2:] = b[:, 2:].max(1, keepdims=True)
    b[:, 2:] = b[:, 2:] * gain + pad
    box = _xywh2xyxy_np(b).astype(int)
    h, w = im.shape[:2]
    box[:, [0, 2]] = box[:, [0, 2]].clip(0, w)
    box[:, [1, 3]] = box[:, [1, 3]].clip(0, h)
    crop = im[box[0, 1]:box[0, 3], box[0, 0]:box[0, 2]]
    out = increment_path(file, mkdir=True).with_suffix(".jpg")
    cv2.imwrite(str(out), np.ascontiguousarray(
        crop if BGR else crop[..., ::-1]))
    return out


def init_seeds(seed: int = 0) -> torch.Generator:
    """Seed the host RNGs (`random`, `np.random`, torch's) and hand back a
    torch.Generator seeded the same (reference utils/general.py:41-45;
    the JAX package returns a PRNGKey), for draws that should not ride
    the global state."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def labels_to_class_weights(labels, nc: int = 1):
    """Inverse-frequency class weights from training labels
    (reference utils/general.py:250-266): per-class occurrence counts
    with empty bins as 1, inverted and normalized to sum 1."""
    rows = [l for l in labels if l is not None and len(l)]
    if not rows:
        return np.ones(nc) / nc
    classes = np.concatenate(rows, 0)[:, 0].astype(int)
    weights = np.bincount(classes, minlength=nc).astype(np.float64)
    weights[weights == 0] = 1
    weights = 1 / weights
    return weights / weights.sum()


def labels_to_image_weights(labels, nc: int = 1, class_weights=None):
    """Per-image sampling weights from class weights and image contents
    (reference utils/general.py:269-274)."""
    if class_weights is None:
        class_weights = np.ones(nc)
    counts = np.array([
        np.bincount(l[:, 0].astype(int), minlength=nc)
        if l is not None and len(l) else np.zeros(nc, int)
        for l in labels])
    return (np.asarray(class_weights).reshape(1, nc) * counts).sum(1)
