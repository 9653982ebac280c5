"""Training/validation dataset: WIDER FACE images + 5-landmark labels with
mosaic / perspective / HSV / flip augmentation, its collate and loader.

A copy of the JAX package's data/dataset.py (its dataset tools,
`autosplit`, `extract_boxes` and friends, are not ported): the label
files and their cache, `FaceDataset` (square or `rect` batch shapes, the
longest-side resize, the letterbox, and with `augment=True` mosaic /
mosaic9, mixup, `random_perspective`, `augment_hsv` and the flips),
`cutout`, `replicate`, `collate` and `DataLoader`. Host-side numpy/cv2
re-implementation of the reference data layer (reference
utils/datasets.py:349-676 LoadImagesAndLabels, :680-710
load_image/augment_hsv, :724-782 load_mosaic, :906-1016
random_perspective). The random draw ORDER inside `get()` matches the
reference __getitem__ exactly (global `random` + np.random in the same
sequence), so a seeded run gives the JAX package's batches bit for bit.

OpenCV and PIL are imported inside the functions that use them; an
augmenting function raises ImportError naming OpenCV where it is
missing (it never skips the augmentation).

Batches collate to uint8 NHWC (normalization happens on the device),
labels ride along as fixed-width rows with an image index column, and
per-host sharding replaces DistributedSampler.
"""

from __future__ import annotations

import functools
import glob
import hashlib
import math
import os
import random
import threading
import queue as queue_mod
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from face_detection_multi_scale_tpu_torch.data.letterbox import letterbox

IMG_FORMATS = {"bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp",
               "mpo"}
FLIP_INDEX = [1, 0, 2, 4, 3]  # landmark reindex on lr-flip
                              # (utils/datasets.py:364)


def _cv2():
    """OpenCV for the augmenting path; without it that path cannot run,
    and says so."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the augmenting loader needs OpenCV (cv2), "
                          "which is not installed") from e
    return cv2


def img2label_paths(img_paths: Sequence[str]) -> List[str]:
    """images/ dir -> labels/ dir, image ext -> .txt
    (utils/datasets.py:343-346)."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return [sb.join(p.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt"
            for p in img_paths]


def load_label_file(path: str, kpt_label: int) -> np.ndarray:
    """Read + validate one label txt (utils/datasets.py:481-510): rows of
    `cls x y w h` plus kpt_label x (x, y, occlusion) triplets; occlusion is
    stripped, coords must be normalized and non-negative."""
    ncols = kpt_label * 2 + 5
    if not os.path.isfile(path):
        return np.zeros((0, ncols), np.float32)
    with open(path) as f:
        rows = [x.split() for x in f.read().strip().splitlines()]
    if not rows:
        return np.zeros((0, ncols), np.float32)
    l = np.array(rows, np.float32)
    assert (l >= 0).all(), f"negative labels: {path}"
    if kpt_label:
        assert l.shape[1] == kpt_label * 3 + 5, \
            f"labels require {kpt_label * 3 + 5} columns: {path}"
        assert (l[:, 5::3] <= 1).all() and (l[:, 6::3] <= 1).all(), \
            f"non-normalized coordinates: {path}"
        keep = np.ones(l.shape[1], bool)
        keep[7::3] = False  # drop occlusion columns
        l = l[:, keep]
    else:
        assert l.shape[1] == 5, f"labels require 5 columns: {path}"
        assert (l[:, 1:5] <= 1).all(), f"non-normalized coords: {path}"
    assert np.unique(l, axis=0).shape[0] == l.shape[0], \
        f"duplicate labels: {path}"
    return l.astype(np.float32)


def exif_size(img) -> Tuple[int, int]:
    """PIL image size (w, h) corrected for EXIF rotation
    (utils/datasets.py exif_size semantics)."""
    s = img.size
    try:
        rotation = dict(img._getexif().items())[274]
        if rotation in (6, 8):
            s = (s[1], s[0])
    except Exception:
        pass
    return s


def _files_hash(paths: Sequence[str]) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(p.encode())
        try:
            h.update(str(os.path.getsize(p)).encode())
        except OSError:
            pass
    return h.hexdigest()


class FaceDataset:
    """Image + label store with reference-equivalent augmentation. The
    images and labels come from `_enumerate` and `load_image`, which a
    subclass may override to serve them from memory."""

    def __init__(self, path, img_size: int = 640, augment: bool = False,
                 hyp: Optional[Dict] = None, kpt_label: int = 5,
                 stride: int = 32, cache_images: bool = False,
                 prefix: str = "", rect: bool = False,
                 batch_size: int = 16, pad: float = 0.0,
                 single_cls: bool = False):
        self.img_size = img_size
        self.augment = augment
        self.hyp = hyp or {}
        self.kpt_label = kpt_label
        self.stride = stride
        self.rect = rect
        self.mosaic = augment and not rect
        self.mosaic_border = [-img_size // 2, -img_size // 2]

        (self.img_files, self.label_files, self.labels,
         self.shapes) = self._enumerate(path, prefix)
        if single_cls:  # force one class (utils/datasets.py:419-421)
            self.labels = [l.copy() for l in self.labels]
            for l in self.labels:
                if len(l):
                    l[:, 0] = 0
        self.n = len(self.img_files)
        self.indices = list(range(self.n))

        # Rectangular batching: sort by aspect ratio and give each batch
        # the minimal stride-aligned (h, w) that fits its images
        # (utils/datasets.py:431-454). NOTE the reference fork hard-forces
        # `self.rect = False` (utils/datasets.py:357), so its own val
        # protocol always runs the square letterbox — rect here is the
        # opt-in restoration of the upstream protocol, off by default.
        self.batch = np.floor(
            np.arange(self.n) / batch_size).astype(int)
        self.batch_shapes = None
        if rect:
            s = np.asarray(self.shapes, np.float64)  # (n, 2) wh
            ar = s[:, 1] / s[:, 0]  # h / w
            irect = ar.argsort()
            self.img_files = [self.img_files[i] for i in irect]
            self.label_files = [self.label_files[i] for i in irect]
            self.labels = [self.labels[i] for i in irect]
            self.shapes = s[irect]
            ar = ar[irect]
            nb = int(self.batch[-1]) + 1
            shapes_b = [[1.0, 1.0]] * nb
            for i in range(nb):
                ari = ar[self.batch == i]
                mini, maxi = ari.min(), ari.max()
                if maxi < 1:
                    shapes_b[i] = [maxi, 1.0]
                elif mini > 1:
                    shapes_b[i] = [1.0, 1.0 / mini]
            self.batch_shapes = (np.ceil(
                np.array(shapes_b) * img_size / stride + pad)
                .astype(int) * stride)
        self._img_cache: Dict[int, Tuple] = {}
        if cache_images:
            for i in range(self.n):
                self._img_cache[i] = self._load_image_uncached(i)

    def _enumerate(self, path, prefix: str):
        """(image files, label files, labels, shapes (n, 2) as (w, h)) of
        `path`: a directory, a list file or a list of either
        (utils/datasets.py:367-390), the labels and shapes through the
        label cache."""
        files: List[str] = []
        for p in path if isinstance(path, list) else [path]:
            p = Path(p)
            if p.is_dir():
                files += glob.glob(str(p / "**" / "*.*"), recursive=True)
            elif p.is_file():
                with open(p) as t:
                    parent = str(p.parent) + os.sep
                    for x in t.read().strip().splitlines():
                        files.append(x.replace("./", parent)
                                     if x.startswith("./") else x)
            else:
                raise FileNotFoundError(f"{prefix}{p} does not exist")
        img_files = sorted(
            x.split(" ")[0] for x in files
            if x.split(" ")[0].rsplit(".", 1)[-1].lower() in IMG_FORMATS)
        assert img_files, f"{prefix}no images found in {path}"
        label_files = img2label_paths(img_files)

        # label cache (the reference's *.cache equivalent,
        # utils/datasets.py:394-418), stored as an npz keyed by a
        # path+size hash
        cache_path = Path(label_files[0]).parent.with_suffix(
            ".labels.npz") if label_files else None
        key = _files_hash(img_files + label_files)
        cache = None
        if cache_path and cache_path.is_file():
            try:
                loaded = np.load(cache_path, allow_pickle=True)
                if str(loaded["key"]) == key:
                    cache = (list(loaded["labels"]), loaded["shapes"])
            except Exception:
                cache = None
        if cache is None:
            from PIL import Image

            labels = [load_label_file(lb, self.kpt_label)
                      for lb in label_files]
            shapes = np.array([exif_size(Image.open(p))
                               for p in img_files], np.float64)
            cache = (labels, shapes)
            if cache_path:
                try:
                    np.savez_compressed(
                        cache_path, key=key,
                        labels=np.array(labels, dtype=object),
                        shapes=shapes)
                except OSError:
                    pass
        return img_files, label_files, cache[0], cache[1]

    def __len__(self):
        return self.n

    # ------------------------------------------------------------------

    def _load_image_uncached(self, index: int):
        import cv2

        img = cv2.imread(self.img_files[index])
        assert img is not None, f"Image Not Found {self.img_files[index]}"
        h0, w0 = img.shape[:2]
        r = self.img_size / max(h0, w0)
        if r != 1:
            interp = cv2.INTER_AREA if (r < 1 and not self.augment) \
                else cv2.INTER_LINEAR
            img = cv2.resize(img, (int(w0 * r), int(h0 * r)),
                             interpolation=interp)
        return img, (h0, w0), img.shape[:2]

    def load_image(self, index: int):
        """Longest-side resize to img_size (utils/datasets.py:680-696):
        (img HWC BGR uint8, (h0, w0), (h, w))."""
        if index in self._img_cache:
            img, hw0, hw = self._img_cache[index]
            return img.copy(), hw0, hw
        return self._load_image_uncached(index)

    # ------------------------------------------------------------------

    def load_mosaic(self, index: int):
        """4-image mosaic + random_perspective (behavioral parity with
        utils/datasets.py:724-782; RNG draw sequence identical: center
        draws, then 3 companion indices, then the warp's draws).

        Geometry, expressed once instead of per-quadrant: each tile is
        anchored so that its corner touching the mosaic center survives,
        overflow is cropped at the canvas edge and at the far side of the
        source image."""
        s = self.img_size
        labels4 = []
        yc, xc = (int(random.uniform(-x, 2 * s + x))
                  for x in self.mosaic_border)
        indices = [index] + random.choices(self.indices, k=3)
        img4 = None
        for i, idx in enumerate(indices):
            img, _, (h, w) = self.load_image(idx)
            if img4 is None:
                img4 = np.full((s * 2, s * 2, img.shape[2]), 114, np.uint8)
            # quadrant i: bit 0 = right of center, bit 1 = below center
            (x1a, x2a), (x1b, x2b) = _mosaic_span(xc, w, 2 * s, i & 1)
            (y1a, y2a), (y1b, y2b) = _mosaic_span(yc, h, 2 * s, i >> 1)
            img4[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            padw, padh = x1a - x1b, y1a - y1b

            labels = self.labels[idx].copy()
            if labels.size:
                labels[:, 1:] = _xywhn2xyxy_kpt(
                    labels[:, 1:], w, h, padw, padh, self.kpt_label)
            labels4.append(labels)

        labels4 = np.concatenate(labels4, 0)
        np.clip(labels4[:, 1:], 0, 2 * s, out=labels4[:, 1:])
        return random_perspective(img4, labels4, **self._warp_args(),
                                  border=self.mosaic_border,
                                  kpt_label=self.kpt_label)

    def load_mosaic9(self, index: int):
        """9-image mosaic + random_perspective
        (utils/datasets.py:780-852). Unused by the default face recipe
        (reference __getitem__ only calls load_mosaic); provided for
        surface completeness with the same seeded draw order. Mirrors the
        reference's kpt quirk: the placement step maps only the box
        columns to mosaic pixels (xywhn2xyxy is called without kpt_label
        at utils/datasets.py:819), keypoint columns pass through."""
        s = self.img_size
        labels9 = []
        indices = [index] + random.choices(self.indices, k=8)
        img9 = None
        h0 = w0 = hp = wp = 0
        # top-left anchor of each ring position, as a function of the
        # canvas cell size s, this tile's (w, h), the center tile's
        # (w0, h0), and the previous tile's (wp, hp) — the reference's
        # clockwise ring layout expressed as a table
        anchors = (
            lambda: (s, s),                          # 0 center
            lambda: (s, s - h),                      # 1 top
            lambda: (s + wp, s - h),                 # 2 top right
            lambda: (s + w0, s),                     # 3 right
            lambda: (s + w0, s + hp),                # 4 bottom right
            lambda: (s + w0 - w, s + h0),            # 5 bottom
            lambda: (s + w0 - wp - w, s + h0),       # 6 bottom left
            lambda: (s - w, s + h0 - h),             # 7 left
            lambda: (s - w, s + h0 - hp - h),        # 8 top left
        )
        for i, idx in enumerate(indices):
            img, _, (h, w) = self.load_image(idx)
            if i == 0:
                img9 = np.full((s * 3, s * 3, img.shape[2]), 114, np.uint8)
                h0, w0 = h, w
            padx, pady = anchors[i]()
            x1, y1, x2, y2 = (max(v, 0) for v in
                              (padx, pady, padx + w, pady + h))

            labels = self.labels[idx].copy()
            if labels.size:
                # box columns only (reference utils/datasets.py:819)
                labels[:, 1:5] = _xywhn2xyxy_kpt(
                    labels[:, 1:5], w, h, padx, pady, kpt_label=0)
            labels9.append(labels)

            img9[y1:y2, x1:x2] = img[y1 - pady:, x1 - padx:]
            hp, wp = h, w

        yc, xc = (int(random.uniform(0, s)) for _ in self.mosaic_border)
        img9 = img9[yc:yc + 2 * s, xc:xc + 2 * s]

        labels9 = np.concatenate(labels9, 0)
        labels9[:, [1, 3]] -= xc
        labels9[:, [2, 4]] -= yc
        np.clip(labels9[:, 1:], 0, 2 * s, out=labels9[:, 1:])
        return random_perspective(img9, labels9, **self._warp_args(),
                                  border=self.mosaic_border,
                                  kpt_label=self.kpt_label)

    def _warp_args(self):
        return {k: self.hyp.get(k, 0.0) for k in (
            "degrees", "translate", "scale", "shear", "perspective")}

    # ------------------------------------------------------------------

    def get(self, index: int):
        """One example: (img HWC RGB uint8, labels (n, 5+2k) normalized,
        path, shapes). The augmentation RNG draw order matches reference
        __getitem__ (utils/datasets.py:551-645) exactly, including the
        indices indirection (utils/datasets.py:551) that image-weights
        resampling rewrites each epoch (train.py:374-385)."""
        index = self.indices[index]
        hyp = self.hyp
        mosaic = (self.mosaic
                  and random.random() < hyp.get("mosaic", 0.0))
        if mosaic:
            img, labels = self.load_mosaic(index)
            shapes = None
            if random.random() < hyp.get("mixup", 0.0):
                img2, labels2 = self.load_mosaic(
                    random.randint(0, self.n - 1))
                r = np.random.beta(8.0, 8.0)
                img = (img * r + img2 * (1 - r)).astype(np.uint8)
                labels = np.concatenate((labels, labels2), 0)
        else:
            img, (h0, w0), (h, w) = self.load_image(index)
            # per-batch rect shape when rect, else the square img_size
            # (utils/datasets.py:573)
            shape = (tuple(self.batch_shapes[self.batch[index]])
                     if self.rect else self.img_size)
            img, ratio, pad = letterbox(img, shape, auto=False,
                                        scaleup=self.augment)
            shapes = (h0, w0), ((h / h0, w / w0), pad)
            labels = self.labels[index].copy()
            if labels.size:
                labels[:, 1:] = _xywhn2xyxy_kpt(
                    labels[:, 1:], ratio[0] * w, ratio[1] * h,
                    pad[0], pad[1], self.kpt_label)

        if self.augment:
            if not mosaic:
                img, labels = random_perspective(
                    img, labels, **self._warp_args(),
                    kpt_label=self.kpt_label)
            augment_hsv(img, hyp.get("hsv_h", 0.0), hyp.get("hsv_s", 0.0),
                        hyp.get("hsv_v", 0.0))

        nl = len(labels)
        if nl:
            labels[:, 1:5] = _xyxy2xywh_rows(labels[:, 1:5])
            labels[:, [2, 4]] /= img.shape[0]
            labels[:, [1, 3]] /= img.shape[1]
            if self.kpt_label:
                labels[:, 6::2] /= img.shape[0]
                labels[:, 5::2] /= img.shape[1]

        if self.augment:
            if random.random() < hyp.get("flipud", 0.0):
                img = np.flipud(img)
                if nl:
                    labels[:, 2] = 1 - labels[:, 2]
                    if self.kpt_label:
                        labels[:, 6::2] = ((1 - labels[:, 6::2])
                                           * (labels[:, 6::2] != 0))
            if random.random() < hyp.get("fliplr", 0.0):
                img = np.fliplr(img)
                if nl:
                    labels[:, 1] = 1 - labels[:, 1]
                    if self.kpt_label:
                        labels[:, 5::2] = ((1 - labels[:, 5::2])
                                           * (labels[:, 5::2] != 0))
                        labels[:, 5::2] = labels[:, 5::2][:, FLIP_INDEX]
                        labels[:, 6::2] = labels[:, 6::2][:, FLIP_INDEX]

        img = np.ascontiguousarray(img[:, :, ::-1])  # BGR -> RGB, HWC
        return img, labels.astype(np.float32), self.img_files[index], shapes


# ---------------------------------------------------------------------------
# label geometry
# ---------------------------------------------------------------------------

def _xywhn2xyxy_kpt(x, w, h, padw, padh, kpt_label):
    """Normalized xywh (+ normalized kpts) -> pixel xyxy (+ pixel kpts),
    zeros staying zero (utils/general.py:322-338)."""
    y = x.copy()
    y[:, 0] = w * (x[:, 0] - x[:, 2] / 2) + padw
    y[:, 1] = h * (x[:, 1] - x[:, 3] / 2) + padh
    y[:, 2] = w * (x[:, 0] + x[:, 2] / 2) + padw
    y[:, 3] = h * (x[:, 1] + x[:, 3] / 2) + padh
    if kpt_label:
        kx = x[:, 4::2]
        ky = x[:, 5::2]
        y[:, 4::2] = np.where(kx != 0, w * kx + padw, 0)
        y[:, 5::2] = np.where(ky != 0, h * ky + padh, 0)
    return y


def _xyxy2xywh_rows(x):
    y = x.copy()
    y[:, 0] = (x[:, 0] + x[:, 2]) / 2
    y[:, 1] = (x[:, 1] + x[:, 3]) / 2
    y[:, 2] = x[:, 2] - x[:, 0]
    y[:, 3] = x[:, 3] - x[:, 1]
    return y


# ---------------------------------------------------------------------------
# augmentation primitives
# ---------------------------------------------------------------------------

def _mosaic_span(center: int, extent: int, canvas: int, after: int):
    """One axis of mosaic tile placement: ((canvas_lo, canvas_hi),
    (src_lo, src_hi)). `after`=0 places the tile before `center` (its
    trailing edge at the center, leading overflow cropped at 0, source
    keeping its far end); `after`=1 places it past the center (cropped at
    `canvas`, source keeping its near end)."""
    if after:
        lo, hi = center, min(center + extent, canvas)
        return (lo, hi), (0, min(extent, hi - lo))
    lo, hi = max(center - extent, 0), center
    return (lo, hi), (extent - (hi - lo), extent)


def augment_hsv(img, hgain=0.5, sgain=0.5, vgain=0.5):
    """In-place HSV jitter, behavioral parity with
    utils/datasets.py:699-710: one vector gain draw, per-channel uint8
    lookup tables (hue wraps mod 180 per the cv2 HSV range, sat/val
    saturate at 255)."""
    cv2 = _cv2()
    gains = np.random.uniform(-1, 1, 3) * (hgain, sgain, vgain) + 1.0
    ramp = np.arange(256, dtype=np.int16)
    hue_lut = ((ramp * gains[0]) % 180).astype(img.dtype)
    sat_lut = np.clip(ramp * gains[1], 0, 255).astype(img.dtype)
    val_lut = np.clip(ramp * gains[2], 0, 255).astype(img.dtype)
    channels = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    jittered = cv2.merge(tuple(
        cv2.LUT(ch, lut) for ch, lut in
        zip(channels, (hue_lut, sat_lut, val_lut)))).astype(img.dtype)
    cv2.cvtColor(jittered, cv2.COLOR_HSV2BGR, dst=img)


def _draw_warp(img_shape, degrees, translate, scale, shear, perspective,
               out_wh):
    """Draw the warp's random parameters and compose the 3x3 transform.

    The RNG ledger — 7 `random.uniform` draws, in this order — is a
    parity contract with the reference warp (utils/datasets.py:906-940):
    perspective x/y, rotation angle, scale, shear x/y, translation x/y.
    The transform chain maps image center -> perspective -> rotate+scale
    -> shear -> translate; composition is left-folded so the float
    product is reproducible.

    Returns (M, scale)."""
    cv2 = _cv2()
    w_out, h_out = out_wh

    center = np.eye(3)
    center[:2, 2] = (-img_shape[1] / 2, -img_shape[0] / 2)

    persp = np.eye(3)
    persp[2, :2] = (random.uniform(-perspective, perspective),
                    random.uniform(-perspective, perspective))

    rot = np.eye(3)
    angle = random.uniform(-degrees, degrees)
    s = random.uniform(1 - scale, 1 + scale)
    rot[:2] = cv2.getRotationMatrix2D(angle=angle, center=(0, 0), scale=s)

    sh = np.eye(3)
    to_tan = lambda deg: math.tan(deg * math.pi / 180)
    sh[0, 1] = to_tan(random.uniform(-shear, shear))
    sh[1, 0] = to_tan(random.uniform(-shear, shear))

    trans = np.eye(3)
    trans[:2, 2] = (
        random.uniform(0.5 - translate, 0.5 + translate) * w_out,
        random.uniform(0.5 - translate, 0.5 + translate) * h_out)

    M = functools.reduce(np.matmul, (trans, sh, rot, persp, center))
    return M, s


def _project(points_xy: np.ndarray, M: np.ndarray,
             perspective: float) -> np.ndarray:
    """Apply the homography to (n, 2) points; affine fast path skips the
    homogeneous divide (the reference's `if perspective` split,
    utils/datasets.py:955-960)."""
    n = len(points_xy)
    homo = np.ones((n, 3))
    homo[:, :2] = points_xy
    out = homo @ M.T
    return out[:, :2] / out[:, 2:3] if perspective else out[:, :2]


def random_perspective(img, targets=(), degrees=10, translate=.1, scale=.1,
                       shear=10, perspective=0.0, border=(0, 0),
                       kpt_label=0):
    """Random affine/perspective warp of image + boxes + keypoints
    (utils/datasets.py:906-1006; the seeded-RNG stream and every cv2
    call's arguments match, so warped pixels are identical).

    Box semantics: warp all 4 corners, take the axis-aligned hull, clip
    to the output frame, keep boxes via `box_candidates`. Keypoints:
    coordinates equal to 0 are the "missing" sentinel and stay 0; warped
    points leaving the frame are zeroed x-first (a zeroed x then counts
    as in-frame when the y pass re-evaluates — the reference's quirk at
    utils/datasets.py:992-995, kept for parity)."""
    cv2 = _cv2()
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2
    M, s = _draw_warp(img.shape, degrees, translate, scale, shear,
                      perspective, (width, height))

    if tuple(border) != (0, 0) or (M != np.eye(3)).any():
        warp_args = dict(dsize=(width, height),
                         borderValue=(114, 114, 114))
        img = (cv2.warpPerspective(img, M, **warp_args) if perspective
               else cv2.warpAffine(img, M[:2], **warp_args))

    n = len(targets)
    if n:
        x1, y1, x2, y2 = targets[:, 1:5].T
        # corner order (x1,y1),(x2,y2),(x1,y2),(x2,y1) — any order gives
        # the same hull; this one is the JAX package's
        corners = np.stack(
            [x1, y1, x2, y2, x1, y2, x2, y1], axis=1).reshape(n * 4, 2)
        warped = _project(corners, M, perspective).reshape(n, 4, 2)
        hull = np.concatenate(
            (warped[:, :, 0].min(1), warped[:, :, 1].min(1),
             warped[:, :, 0].max(1), warped[:, :, 1].max(1))
        ).reshape(4, n).T
        hull[:, 0::2] = hull[:, 0::2].clip(0, width)
        hull[:, 1::2] = hull[:, 1::2].clip(0, height)

        if kpt_label:
            kpts_in = targets[:, 5:]
            kpts = _project(kpts_in.reshape(n * kpt_label, 2), M,
                            perspective).reshape(n, kpt_label * 2)
            kpts[kpts_in == 0] = 0
            kx, ky = kpts[:, 0::2], kpts[:, 1::2]

            def out_of_frame():
                return ((kx < 0) | (kx > width)
                        | (ky < 0) | (ky > height))

            kx[out_of_frame()] = 0
            ky[out_of_frame()] = 0  # re-evaluated with kx zeroed (quirk)
            kpts[:, 0::2], kpts[:, 1::2] = kx, ky

        keep = box_candidates(box1=targets[:, 1:5].T * s, box2=hull.T,
                              area_thr=0.10)
        targets = targets[keep]
        targets[:, 1:5] = hull[keep]
        if kpt_label:
            targets[:, 5:] = kpts[keep]
    return img, targets


def box_candidates(box1, box2, wh_thr=2, ar_thr=20, area_thr=0.1,
                   eps=1e-16):
    """Post-warp box validity filter (utils/datasets.py:1009-1015)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr))


def _bbox_ioa(box1: np.ndarray, box2: np.ndarray) -> np.ndarray:
    """Intersection over box2 area, box1 (4,) vs box2 (n, 4) xyxy
    (utils/datasets.py:1021-1038)."""
    b2 = box2.T
    inter = (np.minimum(box1[2], b2[2]) - np.maximum(box1[0], b2[0])
             ).clip(0) * (np.minimum(box1[3], b2[3])
                          - np.maximum(box1[1], b2[1])).clip(0)
    area2 = (b2[2] - b2[0]) * (b2[3] - b2[1]) + 1e-16
    return inter / area2


def cutout(image: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Cutout augmentation: random gray-level masks over the image, boxes
    that end >60% obscured dropped (utils/datasets.py:1017-1061,
    https://arxiv.org/abs/1708.04552). In-place on the image; returns the
    surviving labels (rows of [cls, x1, y1, x2, y2, ...] pixels). Unused
    by the default face recipe; same seeded draw order as the
    reference."""
    h, w = image.shape[:2]
    scales = ([0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8
              + [0.03125] * 16)
    for s in scales:
        mask_h = random.randint(1, int(h * s))
        mask_w = random.randint(1, int(w * s))
        xmin = max(0, random.randint(0, w) - mask_w // 2)
        ymin = max(0, random.randint(0, h) - mask_h // 2)
        xmax = min(w, xmin + mask_w)
        ymax = min(h, ymin + mask_h)
        image[ymin:ymax, xmin:xmax] = [random.randint(64, 191)
                                       for _ in range(3)]
        if len(labels) and s > 0.03:
            box = np.array([xmin, ymin, xmax, ymax], np.float32)
            labels = labels[_bbox_ioa(box, labels[:, 1:5]) < 0.60]
    return labels


def replicate(img: np.ndarray, labels: np.ndarray):
    """Duplicate the smaller half of the boxes at random free positions
    (utils/datasets.py:856-870). labels rows are [cls, x1, y1, x2, y2]
    pixels; appended rows carry the copied class. Unused by the default
    face recipe; same seeded draw order as the reference."""
    h, w = img.shape[:2]
    boxes = labels[:, 1:].astype(int)
    x1, y1, x2, y2 = boxes.T
    s = ((x2 - x1) + (y2 - y1)) / 2
    for i in s.argsort()[:round(s.size * 0.5)]:
        x1b, y1b, x2b, y2b = boxes[i]
        bh, bw = y2b - y1b, x2b - x1b
        yc = int(random.uniform(0, h - bh))
        xc = int(random.uniform(0, w - bw))
        x1a, y1a, x2a, y2a = xc, yc, xc + bw, yc + bh
        img[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        labels = np.append(
            labels, [[labels[i, 0], x1a, y1a, x2a, y2a]], axis=0)
    return img, labels


# ---------------------------------------------------------------------------
# batching
# ---------------------------------------------------------------------------

def collate(samples) -> Tuple[np.ndarray, np.ndarray, list, list]:
    """Stack samples: images (B, H, W, 3) uint8 RGB; labels (N, 6+2k)
    rows [img_idx, cls, x, y, w, h, kpts...] (the reference collate_fn,
    utils/datasets.py:647-652, in NHWC)."""
    imgs, labels, paths, shapes = zip(*samples)
    out_labels = []
    for i, l in enumerate(labels):
        if len(l):
            out_labels.append(np.concatenate(
                [np.full((len(l), 1), i, np.float32), l], axis=1))
    n_cols = labels[0].shape[1] + 1 if len(labels[0].shape) == 2 else 16
    merged = (np.concatenate(out_labels, 0) if out_labels
              else np.zeros((0, n_cols), np.float32))
    return np.stack(imgs), merged, list(paths), list(shapes)


# -- process-pool worker plumbing (module-level so spawn can import it) --

_WORKER_DS: Optional[FaceDataset] = None


def _proc_worker_init(dataset: FaceDataset):
    """Runs once in each worker process; with the fork start method the
    dataset arrives by copy-on-write inheritance (no pickle), with spawn
    it is pickled once per worker."""
    global _WORKER_DS
    _WORKER_DS = dataset


def _proc_get_batch(task):
    """Assemble one full batch inside a worker process.

    Seeded per (loader seed, epoch, batch index), NOT per worker — the
    augmentation draw for a given batch is deterministic no matter which
    worker picks the task (the reference instead seeds each torch worker
    process, utils/datasets.py:59-87 + torch worker_init, which makes the
    stream depend on the worker->batch schedule).

    `ds_indices` is the parent's CURRENT dataset.indices when it has
    diverged from the fork-time snapshot (per-epoch --image-weights
    resampling, cli/train.py) — the worker's forked dataset would keep
    the epoch-0 list forever. None = unchanged since fork (the common
    unweighted case: zero extra IPC); once diverged, the compact int
    array rides with every task so any worker is always current."""
    idxs, batch_seed, ds_indices = task
    if ds_indices is not None:
        _WORKER_DS.indices = ds_indices
    if batch_seed is not None:
        random.seed(batch_seed)
        np.random.seed(batch_seed % (2 ** 32))
    return [_WORKER_DS.get(int(i)) for i in idxs]


class DataLoader:
    """Shuffling, optionally host-sharded, prefetched loader.

    Per-host sharding replaces DistributedSampler (utils/datasets.py:78):
    host k of K takes every K-th index after the epoch-seeded shuffle.

    Worker modes (the InfiniteDataLoader-with-workers equivalent,
    utils/datasets.py:59-121):
    - mode="thread" (default): samples of each batch fetched through a
      thread pool — cv2 releases the GIL, but label/target assembly is
      pure Python, so this tops out near 1 core of Python work.
    - mode="process": each batch is assembled end-to-end (decode +
      augment + label build) inside one of `workers` persistent worker
      processes, mirroring the reference's dataloader worker processes;
      finished batches return over pipes. Augmentation RNG is seeded per
      (seed, epoch, batch) so results are schedule-independent — but the
      stream differs from the serial/thread modes' shared global stream.
    - workers <= 1 keeps the exact serial global-RNG draw order the
      seeded parity tests rely on.

    The prefetch queue overlaps batch assembly with the train step in
    every mode.
    """

    def __init__(self, dataset: FaceDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 num_hosts: int = 1, host_id: int = 0,
                 drop_last: bool = True, prefetch: int = 2,
                 workers: int = 4, mode: str = "thread"):
        if getattr(dataset, "rect", False):
            # rect batch shapes are computed for sequential whole-dataset
            # iteration (batch i = indices [i*bs, (i+1)*bs)); shuffling
            # or host-sharding would mix shapes inside one stacked batch
            assert not shuffle and num_hosts == 1, (
                "rect datasets require shuffle=False, num_hosts=1")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.workers = workers
        assert mode in ("thread", "process"), mode
        self.mode = mode
        self.epoch = 0
        self._pool = None  # persistent process pool
        if self.mode == "process" and self.workers > 1:
            # fork the pool EAGERLY: forking after the torch runtime has
            # spawned its worker threads risks the classic
            # fork-while-a-thread-holds-a-lock deadlock in the children;
            # at loader construction the runtime is usually not (fully)
            # up yet, which is the safest point we control
            self._get_pool()

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _get_pool(self):
        if self._pool is None:
            import multiprocessing as mp

            # fork: dataset inherited copy-on-write, no per-worker
            # pickle of the image cache; spawn fallback elsewhere
            methods = mp.get_all_start_methods()
            ctx = mp.get_context(
                "fork" if "fork" in methods else "spawn")
            # snapshot identity: tasks ship dataset.indices only after
            # the parent reassigns it (image-weights resampling) —
            # unweighted epochs pay no per-task indices IPC
            self._fork_indices = self.dataset.indices
            self._pool = ctx.Pool(self.workers,
                                  initializer=_proc_worker_init,
                                  initargs=(self.dataset,))
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        n = len(self.dataset) // self.num_hosts
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx[self.host_id::self.num_hosts]

    def __iter__(self):
        if self.mode == "process" and self.workers > 1:
            yield from self._iter_process()
            return
        idx = self._epoch_indices()
        nb = len(self)
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)

        def produce():
            try:
                if self.workers > 1:
                    from concurrent.futures import ThreadPoolExecutor
                    with ThreadPoolExecutor(self.workers) as ex:
                        for b in range(nb):
                            chunk = idx[b * self.batch_size:
                                        (b + 1) * self.batch_size]
                            samples = list(ex.map(
                                self.dataset.get,
                                [int(i) for i in chunk]))
                            q.put(collate(samples))
                else:
                    for b in range(nb):
                        chunk = idx[b * self.batch_size:
                                    (b + 1) * self.batch_size]
                        samples = [self.dataset.get(int(i))
                                   for i in chunk]
                        q.put(collate(samples))
                q.put(None)
            except BaseException as e:  # surface worker errors
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    def _iter_process(self):
        """Process-pool epoch: one task per batch, at most
        workers + prefetch outstanding so a slow consumer never buffers
        the whole epoch in result pipes."""
        from collections import deque

        idx = self._epoch_indices()
        nb = len(self)
        pool = self._get_pool()
        max_inflight = self.workers + max(self.prefetch, 1)
        inflight: deque = deque()
        b = 0
        while b < nb or inflight:
            while b < nb and len(inflight) < max_inflight:
                chunk = [int(i) for i in
                         idx[b * self.batch_size:
                             (b + 1) * self.batch_size]]
                batch_seed = hash((self.seed, self.epoch, b)) & 0x7FFFFFFF
                cur = self.dataset.indices
                ship = (None if cur is self._fork_indices
                        else np.asarray(cur, np.int64))
                inflight.append(pool.apply_async(
                    _proc_get_batch, ((chunk, batch_seed, ship),)))
                b += 1
            yield collate(inflight.popleft().get())
