"""Small shape/size, file, label and training utilities: copies of every
function of the JAX package's utils/general.py (`init_seeds` returns a
torch.Generator where JAX returns a PRNGKey; `check_dataset` never
fetches; `get_latest_run` finds this package's `<tag>.pt` checkpoints).
"""

from __future__ import annotations

import glob
import math
import os
import platform
import random
import re
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


def check_file(file: str) -> str:
    """Return the path as-is if it exists, else glob for it under the
    cwd and require a unique match (reference utils/general.py:152-160).
    A miss raises FileNotFoundError and several matches ValueError, where
    the JAX package asserts."""
    if Path(file).is_file() or file == "":
        return file
    files = glob.glob("./**/" + file, recursive=True)
    if not files:
        raise FileNotFoundError(f"File Not Found: {file}")
    if len(files) > 1:
        raise ValueError(
            f"Multiple files match '{file}', specify exact path: {files}")
    return files[0]


def check_dataset(data: dict, autodownload: bool = True) -> None:
    """Verify a dataset config's val paths exist (reference
    utils/general.py:163-183). Nothing is fetched: where the JAX package
    (and the reference) would run the config's `download` recipe, this
    raises FileNotFoundError naming the missing paths and the recipe."""
    val, s = data.get("val"), data.get("download")
    if not val or not len(val):
        return
    paths = [Path(x).resolve()
             for x in (val if isinstance(val, list) else [val])]
    missing = [str(x) for x in paths if not x.exists()]
    if not missing:
        return
    print(f"WARNING: Dataset not found, nonexistent paths: {missing}")
    if not (s and len(s) and autodownload):
        raise FileNotFoundError("Dataset not found.")
    raise FileNotFoundError(
        f"Dataset not found: {missing}. This package fetches nothing; run "
        f"the dataset's download recipe yourself: {s}")


def get_latest_run(search_dir: str = ".") -> str:
    """The most recent `last*.pt` checkpoint under search_dir, for
    --resume (reference utils/general.py:48-51): train/checkpoint.py
    saves `<tag>.pt` beside its `<tag>.meta.json`, and the `.pt` is what
    a resume loads. "" when there is none."""
    found = glob.glob(f"{search_dir}/**/last*.pt", recursive=True)
    return max(found, key=os.path.getctime) if found else ""


def clean_str(s: str) -> str:
    """Replace special characters with underscores (reference
    utils/general.py:215-217; used for stream-source names)."""
    return re.sub(pattern="[|@#!¡·$€%&()=?¿^*;:,¨´><+]", repl="_",
                  string=s)


def file_size(file) -> float:
    """File size in MB (reference utils/general.py:95-97)."""
    return os.path.getsize(file) / 1e6


def emojis(s: str = "") -> str:
    """Platform-safe emoji string (reference utils/general.py:90-92)."""
    return (s.encode().decode("ascii", "ignore")
            if platform.system() == "Windows" else s)


def clip_coords(boxes, img_shape, step: int = 2):
    """Clip xyxy boxes (numpy, in place) to (height, width)
    (reference utils/general.py:401-404)."""
    boxes[:, 0::step] = boxes[:, 0::step].clip(0, img_shape[1])
    boxes[:, 1::step] = boxes[:, 1::step].clip(0, img_shape[0])
    return boxes


def coco80_to_coco91_class():
    """COCO 80-index -> paper 91-index map (reference
    utils/general.py:277-286)."""
    return [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18,
            19, 20, 21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36,
            37, 38, 39, 40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52,
            53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 67, 70,
            72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87,
            88, 89, 90]


# segment (polygon) label utilities: unused by the face recipe, part of
# the reference data-layer surface (utils/general.py:340-371)

def xyn2xy(x, w: int = 640, h: int = 640, padw: float = 0,
           padh: float = 0):
    """Normalized (n, 2) segment points -> pixel points."""
    y = np.copy(x)
    y[:, 0] = w * x[:, 0] + padw
    y[:, 1] = h * x[:, 1] + padh
    return y


def segment2box(segment, width: int = 640, height: int = 640):
    """One polygon -> its xyxy box over the inside-image points
    (reference utils/general.py:348-353, incl. its `any(x)` quirk:
    all-outside or x==0-only polygons yield a (1, 4) zero box)."""
    x, y = segment.T
    inside = (x >= 0) & (y >= 0) & (x <= width) & (y <= height)
    x, y = x[inside], y[inside]
    return (np.array([x.min(), y.min(), x.max(), y.max()])
            if any(x) else np.zeros((1, 4)))


def segments2boxes(segments):
    """Polygons -> (n, 4) xywh boxes (reference
    utils/general.py:356-362)."""
    boxes = []
    for s in segments:
        x, y = s.T
        boxes.append([x.min(), y.min(), x.max(), y.max()])
    return _xyxy2xywh_np(np.array(boxes, np.float64))


def resample_segments(segments, n: int = 1000):
    """Up-sample each (m, 2) polygon to n points by linear interpolation
    (reference utils/general.py:365-371; in place on the list)."""
    for i, s in enumerate(segments):
        x = np.linspace(0, len(s) - 1, n)
        xp = np.arange(len(s))
        segments[i] = np.concatenate(
            [np.interp(x, xp, s[:, j]) for j in range(2)]
        ).reshape(2, -1).T
    return segments


def colorstr(*inputs) -> str:
    """ANSI-colored string, colorstr('blue', 'bold', 'hello')
    (reference utils/general.py:225-247)."""
    *args, string = (inputs if len(inputs) > 1
                     else ("blue", "bold", inputs[0]))
    colors = {
        "black": "\033[30m", "red": "\033[31m", "green": "\033[32m",
        "yellow": "\033[33m", "blue": "\033[34m", "magenta": "\033[35m",
        "cyan": "\033[36m", "white": "\033[37m",
        "bright_black": "\033[90m", "bright_red": "\033[91m",
        "bright_green": "\033[92m", "bright_yellow": "\033[93m",
        "bright_blue": "\033[94m", "bright_magenta": "\033[95m",
        "bright_cyan": "\033[96m", "bright_white": "\033[97m",
        "end": "\033[0m", "bold": "\033[1m", "underline": "\033[4m"}
    return ("".join(colors[x] for x in args) + f"{string}"
            + colors["end"])


def apply_classifier(dets_per_image, classify_fn, img_shape, im0s):
    """Second-stage classifier hook (reference utils/general.py:682-714):
    for each image's detections, cut out the (square-padded, rescaled)
    boxes, resize each crop to 224x224 RGB [0, 1], run the classifier,
    and keep only detections whose first-stage class agrees.

    ``classify_fn`` receives ONE (N, 224, 224, 3) float32 NHWC batch of
    every crop of every image and returns (N,) predicted class indices.
    ``dets_per_image`` is a list of (n_i, 6+) numpy [x1,y1,x2,y2,conf,cls]
    rows in ``img_shape`` (h, w) network-input space; ``im0s`` the
    original BGR images. Host code: OpenCV resizes the crops."""
    import cv2

    from face_detection_multi_scale_tpu_torch.data.letterbox import (
        scale_coords)

    im0s = [im0s] if isinstance(im0s, np.ndarray) else im0s
    crops, mapped = [], []
    for i, d in enumerate(dets_per_image):
        d = np.array(d, np.float64, copy=True)
        if len(d):
            b = _xyxy2xywh_np(d[:, :4])
            b[:, 2:] = b[:, 2:].max(1, keepdims=True)  # square
            b[:, 2:] = b[:, 2:] * 1.3 + 30  # pad
            d[:, :4] = _xywh2xyxy_np(b).astype(int)
            scale_coords(img_shape, d[:, :4], im0s[i].shape)
            for a in d:
                cut = im0s[i][int(a[1]):int(a[3]), int(a[0]):int(a[2])]
                im = cv2.resize(cut, (224, 224))[:, :, ::-1]  # BGR->RGB
                crops.append(np.ascontiguousarray(im, np.float32) / 255.0)
        mapped.append(d)
    if not crops:
        return list(dets_per_image)
    pred2 = np.asarray(classify_fn(np.stack(crops)))
    out = []
    k = 0
    for i, d in enumerate(mapped):
        n = len(d)
        if n:
            agree = d[:, 5].astype(int) == pred2[k:k + n].astype(int)
            out.append(np.asarray(dets_per_image[i])[agree])
            k += n
        else:
            out.append(dets_per_image[i])
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
