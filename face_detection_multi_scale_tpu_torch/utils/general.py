"""Small shape/size and file utilities (copies of the JAX package's
`make_divisible`, `check_img_size`, `increment_path`, `_xyxy2xywh_np`,
`_xywh2xyxy_np` and `save_one_box`)."""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np


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
