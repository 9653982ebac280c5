"""Preprocessing on the card: letterbox / pad-to-square, resize, BGR->RGB
and /255 as tensor operations on the detector's device.

Counterpart of the JAX package's infer/device_preprocess.py. The host cv2
pipeline (data/letterbox.py) stays the parity oracle and the default;
this module serves `FaceDetector(use_device_preprocess=True)`: the raw
uint8 frame is uploaded once and every pyramid scale is cut from it on the
card, so the host does no resize work (the card machine has no OpenCV).

Numerics: the resize is `F.interpolate(mode="bilinear",
align_corners=False, antialias=False)` in float32 on NCHW, the JAX
version's `jax.image.resize(method="linear", antialias=False)`: both map
output pixel i to source (i + 0.5) * in / out - 0.5 and blend the two
nearest pixels; at the borders JAX renormalizes the weights of the pixels
that exist and torch clamps the source index, which gives the same value.
cv2's INTER_LINEAR uses the same mapping in fixed point, so outputs differ
from the host path by at most about 2/255 per pixel. No Pallas kernel
computes this in the JAX package (XLA fuses it), so neither does the port:
these are plain PyTorch operations.

Geometry is host arithmetic, a copy of the reference letterbox rounding,
so `scale_coords` / `scale_coords_api` invert device-preprocessed
detections unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from face_detection_multi_scale_tpu_torch.utils.general import make_divisible

PAD_VALUE = 114.0


@dataclasses.dataclass(frozen=True)
class LetterboxGeometry:
    """Static letterbox geometry for one (src, dst) shape pair.

    Mirrors the reference letterbox arithmetic (utils/datasets.py:873-903):
    ratio = min(dst/src) (capped at 1 unless scaleup), new_unpad =
    round(src * ratio), padding split in half with the round(+/-0.1)
    convention. `out_hw` is the final network input shape.
    """
    src_hw: Tuple[int, int]
    out_hw: Tuple[int, int]
    new_unpad: Tuple[int, int]          # (w, h) like the reference
    pad_tblr: Tuple[int, int, int, int]  # top, bottom, left, right
    ratio: float


def letterbox_geometry(src_hw: Tuple[int, int], new_shape,
                       auto: bool = False, scaleup: bool = True,
                       stride: int = 32) -> LetterboxGeometry:
    """Compute the exact reference letterbox geometry on the host."""
    shape = tuple(int(v) for v in src_hw)
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))
    dw = new_shape[1] - new_unpad[0]
    dh = new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = dw % stride, dh % stride
    dw /= 2
    dh /= 2
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    out_hw = (new_unpad[1] + top + bottom, new_unpad[0] + left + right)
    return LetterboxGeometry(src_hw=shape, out_hw=out_hw,
                             new_unpad=new_unpad,
                             pad_tblr=(top, bottom, left, right), ratio=r)


def _resize(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of float NCHW to (h, w), half-pixel sources, no
    antialiasing (cv2.INTER_LINEAR never antialiases)."""
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False,
                         antialias=False)


def device_letterbox(images_u8: torch.Tensor,
                     geom: LetterboxGeometry) -> torch.Tensor:
    """uint8 NHWC raw BGR frames -> float32 NHWC letterboxed RGB network
    input in [0, 1], on the frames' device: channel swap, bilinear resize,
    114-gray pad, /255. The result is an NHWC view of NCHW memory, the
    layout the network's first convolution reads."""
    x = images_u8.flip(-1).to(torch.float32).permute(0, 3, 1, 2)
    uw, uh = geom.new_unpad
    if (uh, uw) != geom.src_hw:
        x = _resize(x, (uh, uw))
    top, bottom, left, right = geom.pad_tblr
    if any((top, bottom, left, right)):
        x = F.pad(x, (left, right, top, bottom), value=PAD_VALUE)
    return (x / 255.0).permute(0, 2, 3, 1)


def device_preprocess_api(images_u8: torch.Tensor,
                          img_size: int) -> torch.Tensor:
    """The production API chain on the card (utils/preprocess_yolo_predict.py:
    273-378): zero-pad right/bottom to a square, then resize to (img_size,
    img_size), /255. Input is RGB already (the API chain never swaps
    channels): RGB uint8 NHWC in, float32 NHWC in [0, 1] out."""
    _, h, w, _ = images_u8.shape
    side = max(h, w)
    x = images_u8.to(torch.float32).permute(0, 3, 1, 2)
    if (h, w) != (side, side):
        x = F.pad(x, (0, side - w, 0, side - h))
    if side != img_size:
        x = _resize(x, (img_size, img_size))
    return (x / 255.0).permute(0, 2, 3, 1)


def geometry_for_api(src_hw: Tuple[int, int],
                     img_size: int) -> LetterboxGeometry:
    """Geometry record for the API chain (pure top-left scale, no pad in
    the output frame) so `scale_coords_api` inverts it directly."""
    side = max(src_hw)
    return LetterboxGeometry(
        src_hw=tuple(int(v) for v in src_hw),
        out_hw=(img_size, img_size),
        new_unpad=(img_size, img_size),
        pad_tblr=(0, 0, 0, 0),
        ratio=img_size / side)


def check_img_size_geometry(src_hw, img_size: int, stride: int,
                            auto: bool) -> LetterboxGeometry:
    """Letterbox geometry with the CLI's stride rounding applied to
    img_size first (check_img_size, utils/general.py:130-135)."""
    size = make_divisible(img_size, stride)
    return letterbox_geometry(src_hw, size, auto=auto, stride=stride)
