"""Programmatic entry points (the torch.hub surface).

Counterpart of the JAX package's hub.py (reference hubconf.py:21-87
`create` / `custom`): a member of the model family by name, or a
reference-format cfg yaml, with optional local weights, as a ready
FaceDetector. Weights are local files only: a missing path raises
FileNotFoundError, and nothing is downloaded. `device` defaults to the
card, as FaceDetector's does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from face_detection_multi_scale_tpu_torch.models import zoo


def available_models() -> List[str]:
    return zoo.available()


def create(name: str = "yolov7-w6-face", weights: Optional[str] = None,
           img_sizes: Sequence[int] = (640,), conf_thres: float = 0.25,
           iou_thres: float = 0.45, **kw):
    """A FaceDetector for a zoo model. `weights`: a reference torch .pt
    checkpoint or the JAX package's inference .npz; without it the
    weights are the seeded init. Other keywords go to FaceDetector."""
    from face_detection_multi_scale_tpu_torch.infer.detector import (
        FaceDetector)

    return FaceDetector(name, torch_weights=weights, img_sizes=img_sizes,
                        conf_thres=conf_thres, iou_thres=iou_thres, **kw)


def custom(cfg_path: str, weights: Optional[str] = None, **kw):
    """A FaceDetector from a reference-format cfg yaml (its strides from a
    shape-only forward)."""
    from face_detection_multi_scale_tpu_torch.infer.detector import (
        FaceDetector)
    from face_detection_multi_scale_tpu_torch.models.spec import load_spec

    return FaceDetector(load_spec(cfg_path), torch_weights=weights, **kw)
