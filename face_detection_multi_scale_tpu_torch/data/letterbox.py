"""Host-side image geometry: letterbox, square padding, and coordinate
inverses (a copy of the JAX package's data/letterbox.py).

These run on the host in numpy/cv2 because exact parity with the reference
pipeline requires cv2's INTER_LINEAR resize and its rounding conventions
(reference utils/datasets.py:873-903 `letterbox`,
utils/preprocess_yolo_predict.py:273-290 `pad_to_square_top_left`,
:345-378 `preprocess_api_approach`, :122-157 `scale_coords_api_approach`;
coordinate inverse utils/general.py:374-398 `scale_coords`).

cv2 is imported inside the functions that resize or pad, so the module
imports where OpenCV is not installed; the coordinate inverses need only
numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

PAD_COLOR = (114, 114, 114)


def letterbox(img: np.ndarray, new_shape=(640, 640), color=PAD_COLOR,
              auto: bool = True, scale_fill: bool = False, scaleup: bool = True,
              stride: int = 32) -> Tuple[np.ndarray, Tuple[float, float], Tuple[float, float]]:
    """Aspect-preserving resize + gray padding.

    Matches reference utils/datasets.py:873-903 exactly, including the
    round(pad +/- 0.1) split of odd padding and the ``auto`` stride-minimal
    rectangle mode.
    Returns (image, (rw, rh) ratio, (dw, dh) per-side padding).

    cv2 is imported only to resize or to pad: an image already at the
    target shape comes back as a copy without it (cv2.copyMakeBorder
    with four zero pads is a copy), so that case runs without OpenCV.
    """
    shape = img.shape[:2]  # current (h, w)
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)

    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)

    ratio = (r, r)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))  # (w, h)
    dw = new_shape[1] - new_unpad[0]
    dh = new_shape[0] - new_unpad[1]
    if auto:  # minimal stride-aligned rectangle
        dw, dh = dw % stride, dh % stride
    elif scale_fill:
        dw, dh = 0.0, 0.0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])

    dw /= 2
    dh /= 2

    if shape[::-1] != new_unpad:
        import cv2
        img = cv2.resize(img, new_unpad, interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    if top or bottom or left or right:
        import cv2
        img = cv2.copyMakeBorder(img, top, bottom, left, right,
                                 cv2.BORDER_CONSTANT, value=color)
    else:
        img = img.copy()
    return img, ratio, (dw, dh)


def pad_to_square_top_left(img: np.ndarray) -> np.ndarray:
    """Zero-pad right/bottom to a square (the production-API preprocess step,
    reference utils/preprocess_yolo_predict.py:273-290)."""
    h, w, c = img.shape
    size = max(h, w)
    out = np.zeros((size, size, c), dtype=img.dtype)
    out[:h, :w, :] = img
    return out


def preprocess_api(img_rgb: np.ndarray, img_size: int, stride: int = 32) -> np.ndarray:
    """Production-API preprocess: pad-to-square (top-left) then letterbox
    with auto=False. Input is an RGB HWC uint8 array; output stays HWC
    (the model consumes NHWC).

    Mirrors utils/preprocess_yolo_predict.py:345-378 (which does NOT swap
    BGR/RGB because the input is already RGB from PIL).
    """
    squared = pad_to_square_top_left(img_rgb)
    out, _, _ = letterbox(squared, img_size, stride=stride, auto=False)
    return np.ascontiguousarray(out)


def preprocess_standard(img_bgr: np.ndarray, img_size: int, stride: int = 32,
                        auto: bool = False) -> np.ndarray:
    """Standard preprocess: letterbox then BGR->RGB, HWC output.

    Mirrors multi_scale_face_detector.py:94-97 (auto=False path) and
    test_widerface.py:66-69 (auto=True path when ``auto`` is set).
    """
    out, _, _ = letterbox(img_bgr, img_size, stride=stride, auto=auto)
    return np.ascontiguousarray(out[:, :, ::-1])


def scale_coords(img1_shape, coords: np.ndarray, img0_shape, ratio_pad=None,
                 kpt: bool = False, step: int = 2) -> np.ndarray:
    """Invert letterbox: map coords from the padded/resized frame
    (``img1_shape`` = (h, w)) back to the original frame (``img0_shape``).

    With ``kpt`` False, ``coords`` is (..., 4) xyxy; otherwise columns
    ``0::step`` are x and ``1::step`` are y (landmark triplets use step=3).
    Matches reference utils/general.py:374-398 including clipping.
    Operates in place on a float array and also returns it.
    """
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2,
               (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain, pad = ratio_pad
        if isinstance(gain, (list, tuple)):
            gain = gain[0]
    if not kpt:
        coords[..., [0, 2]] -= pad[0]
        coords[..., [1, 3]] -= pad[1]
        coords[..., :4] /= gain
        # Reference-compat quirk: utils/general.py:391 clips `coords[0:4]`
        # (the first four ROWS, not the four columns), so only the first 4
        # boxes get clipped. Reproduced here because the WIDER txt fixtures
        # were generated through this exact path.
        head = coords[:4]
        head[..., [0, 2]] = head[..., [0, 2]].clip(0, img0_shape[1])
        head[..., [1, 3]] = head[..., [1, 3]].clip(0, img0_shape[0])
        coords[:4] = head
    else:
        coords[..., 0::step] -= pad[0]
        coords[..., 1::step] -= pad[1]
        coords[..., 0::step] /= gain
        coords[..., 1::step] /= gain
        coords[..., 0::step] = coords[..., 0::step].clip(0, img0_shape[1])
        coords[..., 1::step] = coords[..., 1::step].clip(0, img0_shape[0])
    return coords


def scale_coords_api(img1_shape, coords: np.ndarray, img0_shape) -> np.ndarray:
    """Invert the pad-to-square + letterbox (API) preprocess.

    Because the square pad is top-left anchored, the inverse is a pure
    scale by max(orig_h, orig_w) / input_h followed by a clip to the
    original bounds (reference utils/preprocess_yolo_predict.py:122-157).
    """
    img_h = img1_shape[0]
    orig_h, orig_w = img0_shape[:2]
    scale = max(orig_h, orig_w) / img_h
    coords[..., [0, 2]] *= scale
    coords[..., [1, 3]] *= scale
    coords[..., [0, 2]] = coords[..., [0, 2]].clip(0, orig_w)
    coords[..., [1, 3]] = coords[..., [1, 3]].clip(0, orig_h)
    return coords
