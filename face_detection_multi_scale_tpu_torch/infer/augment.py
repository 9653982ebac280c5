"""Augmented inference: multi-scale + flip test-time augmentation.

Counterpart of the JAX package's infer/augment.py. Reference semantics:
  * forward_augment (models/yolo.py:363-417): scales [1, 0.83, 0.67] with
    flips [none, lr, none]; each input is bilinear-resized (scale_img,
    utils/torch_utils.py:247-257: pad to stride multiple with 0.447),
    decoded, then de-scaled (boxes /= scale; lr flip: x = W - x) and all
    candidate sets concatenated. Landmark columns are NOT de-scaled —
    matching the reference, which only adjusts columns :4 and x.
  * flip_test (test.py:145-151): a second forward on the lr-flipped
    image, fused as (out + out_flip) / 2 and concatenated.

The functions take the `YoloFace` module itself (its weights live in it;
the JAX functions take a flax module and its `variables`) and NHWC float
images in [0, 1] on the module's device and in its dtype. Each forward
runs in full float32 on the card (`full_fp32`), as the detector's does.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from face_detection_multi_scale_tpu_torch.infer.detector import full_fp32
from face_detection_multi_scale_tpu_torch.models.head import decode
from face_detection_multi_scale_tpu_torch.models.model import YoloFace

TTA_SCALES = (1.0, 0.83, 0.67)
TTA_FLIPS = (None, "lr", None)
PAD_VALUE = 0.447  # imagenet mean gray (utils/torch_utils.py:257)


def resize_weights(n_in: int, n_out: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """(n_in, n_out) weights of one axis of `jax.image.resize(method=
    "bilinear")` (its `compute_weight_mat`, antialias on), in float32 as
    JAX computes them: a triangle kernel widened by 1/scale when
    downscaling, at half-pixel sample centres, scale = n_out / n_in;
    each output column normalized, and zero where the sample falls
    outside the input."""
    inv_scale = 1.0 / (n_out / n_in)
    f32 = dict(dtype=torch.float32, device=device)
    sample = (torch.arange(n_out, **f32) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(n_in, **f32)[:, None]).abs() \
        / max(inv_scale, 1.0)
    w = (1 - dist.abs()).clamp(min=0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(dtype)


def scale_img(x: torch.Tensor, ratio: float, gs: int = 32) -> torch.Tensor:
    """Bilinear scale of an NHWC batch constrained to a gs-multiple canvas
    (utils/torch_utils.py:247-257). The resize is the JAX package's
    `jax.image.resize(method="bilinear")`, which antialiases a downscale
    (its default): the per-axis weight matrices of `resize_weights`
    applied by two contractions, as JAX applies them. (F.interpolate's
    antialiased bilinear builds the same filter but its weights differ
    by up to about 1.2e-5 on [0, 1] images.)"""
    if ratio == 1.0:
        return x
    _, h, w, _ = x.shape
    sh, sw = int(h * ratio), int(w * ratio)
    resized = torch.einsum(
        "bhwc,hH,wW->bHWc", x,
        resize_weights(h, sh, x.dtype, x.device),
        resize_weights(w, sw, x.dtype, x.device))
    ph = math.ceil(h * ratio / gs) * gs
    pw = math.ceil(w * ratio / gs) * gs
    return F.pad(resized.permute(0, 3, 1, 2), (0, pw - sw, 0, ph - sh),
                 value=PAD_VALUE).permute(0, 2, 3, 1)


def descale_pred(p: torch.Tensor, flip, scale: float,
                 img_hw: Tuple[int, int]) -> torch.Tensor:
    """Invert the TTA transform on decoded predictions
    (models/yolo.py:402-417)."""
    boxes = p[..., :4] / scale
    if flip == "ud":
        boxes[..., 1] = img_hw[0] - boxes[..., 1]
    elif flip == "lr":
        boxes[..., 0] = img_hw[1] - boxes[..., 0]
    return torch.cat([boxes, p[..., 4:]], dim=-1)


def _rows(model: YoloFace, x: torch.Tensor) -> torch.Tensor:
    with full_fp32():
        return decode(model(x), model.spec)


@torch.inference_mode()
def forward_augment(model: YoloFace, x: torch.Tensor,
                    scales: Sequence[float] = TTA_SCALES,
                    flips: Sequence = TTA_FLIPS) -> torch.Tensor:
    """Scale/flip TTA forward: decoded predictions concatenated over the
    augmentations (models/yolo.py:363-374)."""
    img_hw = (x.shape[1], x.shape[2])
    outs = []
    for si, fi in zip(scales, flips):
        xi = x
        if fi == "lr":
            xi = xi.flip(2)
        elif fi == "ud":
            xi = xi.flip(1)
        xi = scale_img(xi, si, gs=model.spec.max_stride)
        outs.append(descale_pred(_rows(model, xi), fi, si, img_hw))
    return torch.cat(outs, dim=1)


@torch.inference_mode()
def forward_flip_test(model: YoloFace, x: torch.Tensor) -> torch.Tensor:
    """The test.py flip-test fusion: average of the plain and the
    lr-flipped forward (in the flipped frame, as the reference does),
    concatenated to the plain candidates (test.py:145-151)."""
    out = _rows(model, x)
    out_f = _rows(model, x.flip(2))
    return torch.cat([out, (out + out_f) / 2.0], dim=1)
