"""Multi-checkpoint ensemble inference.

Counterpart of the JAX package's infer/ensemble.py. Reference semantics
(models/experimental.py:98-141 Ensemble + attempt_load): several models
run on the same input and their candidate sets are concatenated before
one NMS ("nms ensemble"), whose keep mask is the `nms_keep` kernel on the
card.
"""

from __future__ import annotations

from typing import Sequence

import torch

from face_detection_multi_scale_tpu_torch.infer.detector import (
    FaceDetector, full_fp32)
from face_detection_multi_scale_tpu_torch.models.head import decode
from face_detection_multi_scale_tpu_torch.ops import nms as NMS


class EnsembleDetector:
    """Wraps several FaceDetectors (possibly different architectures, on
    one device); detection candidates concatenate before one shared NMS
    with the first detector's thresholds and capacities."""

    def __init__(self, detectors: Sequence[FaceDetector]):
        if not detectors:
            raise ValueError("need at least one detector")
        self.detectors = list(detectors)
        first = detectors[0]
        self.spec = first.spec
        self.device = first.device
        self.stride = max(d.stride for d in detectors)
        self.conf_thres = first.conf_thres
        self.iou_thres = first.iou_thres
        self.max_det = first.max_det
        self.max_candidates = first.max_candidates

    @classmethod
    def from_weights(cls, model_names: Sequence[str],
                     weights: Sequence[str], **kw) -> "EnsembleDetector":
        return cls([FaceDetector(m, torch_weights=w, **kw)
                    for m, w in zip(model_names, weights)])

    @torch.inference_mode()
    def run_network(self, images_u8) -> NMS.Detections:
        """uint8 NHWC (bs, h, w, 3) -> Detections on the first detector's
        device. Each member's rows come from its own model (not the
        fused-ELAN executor, as in the JAX ensemble), on the batch cast to
        its dtype and divided by 255."""
        preds = []
        for det in self.detectors:
            x = torch.as_tensor(images_u8).to(det.device)
            with full_fp32():
                raws = det.model(x.to(det.dtype) / 255.0)
            preds.append(decode(raws, det.spec).to(self.device))
        return NMS.non_max_suppression(
            torch.cat(preds, dim=1), self.conf_thres, self.iou_thres,
            nc=self.spec.nc, nkpt=self.spec.nkpt,
            max_candidates=self.max_candidates, max_det=self.max_det)
