"""The inference engine: single-scale, batched, and multi-scale TTA
detection.

Counterpart of the JAX package's infer/detector.py `FaceDetector` (its
engine at detector.py:338-344 and `run_network` without a mesh):
uint8 NHWC batch -> /255 -> YoloFace forward with BN folded (or, with
`fuse_elan`, the fused-ELAN executor of models/fused.py, as the JAX
`_forward` at detector.py:270-285) -> grid decode -> fixed-capacity NMS
(the keep mask through the CUDA kernel on the card) -> Detections, then
the host-side inverse letterbox. The TTA pyramid (`detect_multi_scale`)
runs every scale and merges them with the scale-weighted NMS, whose keep
mask goes through the same kernel.

PyTorch runs eagerly, so there is no per-shape executable to cache.
Preprocessing (letterbox / pad-to-square) stays on the host in cv2 for
parity with the reference pipeline, and the division by 255 happens on the
device, so the upload is uint8; with `use_device_preprocess` the whole
preprocess runs on the device instead (infer/device_preprocess.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from face_detection_multi_scale_tpu_torch.data import letterbox as LB
from face_detection_multi_scale_tpu_torch.infer import device_preprocess as DP
from face_detection_multi_scale_tpu_torch.models import zoo
from face_detection_multi_scale_tpu_torch.models.convert import (
    jax_to_state_dict)
from face_detection_multi_scale_tpu_torch.models.fuse import fold_bn
from face_detection_multi_scale_tpu_torch.models.fused import (
    apply_variant, find_elan_blocks, fused_apply)
from face_detection_multi_scale_tpu_torch.models.head import decode
from face_detection_multi_scale_tpu_torch.models.model import (
    YoloFace, init_weights)
from face_detection_multi_scale_tpu_torch.models.spec import ModelSpec
from face_detection_multi_scale_tpu_torch.ops import nms as NMS
from face_detection_multi_scale_tpu_torch.utils.general import check_img_size


@contextlib.contextmanager
def full_fp32():
    """cuDNN convolutions in full float32 (its default is TF32, about
    three decimal digits); restores the previous setting on exit."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


class FaceDetector:
    """Face detector over a zoo model (or a resolved spec) in float32.

    The forward runs in full float32: cuDNN's TF32 is switched off around
    it (`full_fp32`), so the card computes what the CPU computes, up to the
    order of sums.

    Args mirror the JAX FaceDetector: `variables` is either a JAX-layout
    variables tree of numpy arrays (carried over by the weight bridge,
    models/convert.py) or a torch state dict with reference key names;
    with neither, weights are the seeded init (`seed`). `fuse` folds BN
    into the convs for serving. `device` defaults to the card and raises
    when there is none.

    `fuse_elan` runs each E-ELAN group as one fused kernel launch
    (models/fused.py, ops/elan_kernel.py): True with the default kernel,
    or a variant expression of the JAX package's grammar, optionally
    prefixed "pre:" to absorb each group's feeding downsample conv
    (`apply_variant` per block; the layout parts change no numbers).

    `use_device_preprocess` letterboxes, resizes and normalizes on the
    device (infer/device_preprocess.py): the raw uint8 frame is the only
    upload, one upload serves every pyramid scale, and the host needs no
    OpenCV for arrays; pixels differ from the cv2 path by at most about
    2/255.
    """

    def __init__(self, model: Union[str, ModelSpec] = "yolov7-w6-face",
                 variables=None, img_sizes: Sequence[int] = (640, 3840),
                 conf_thres: float = 0.5, iou_thres: float = 0.5,
                 use_api_preprocess: bool = False, max_det: int = 300,
                 max_candidates: int = 4096, seed: int = 0,
                 fuse: bool = True, fuse_elan: Union[bool, str] = False,
                 use_device_preprocess: bool = False, device="cuda"):
        self.device = _device(device)
        spec = zoo.get_spec(model) if isinstance(model, str) else model
        self.spec = spec.resolve()
        net = YoloFace(self.spec)
        if variables is None:
            init_weights(net, torch.Generator().manual_seed(seed))
        else:  # a JAX-layout tree, or a torch state dict
            net.load_state_dict(jax_to_state_dict(variables)
                                if "params" in variables else variables)
        if fuse:
            fold_bn(net)
        self.model = net.eval().to(self.device)
        self._elan_blocks = []
        if fuse_elan:
            expr = fuse_elan if isinstance(fuse_elan, str) else ""
            absorb = expr.startswith("pre:")
            expr = expr[4:] if absorb else expr
            blocks = find_elan_blocks(self.spec, absorb_pre=absorb)
            if expr:
                blocks = [dataclasses.replace(
                    b, shape=apply_variant(b.shape, expr)) for b in blocks]
            self._elan_blocks = blocks
        # packed group weights, filled once per block on first use
        self._elan_weights = {}

        self.stride = self.spec.max_stride
        self.img_sizes = [check_img_size(s, self.stride) for s in img_sizes]
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.use_api_preprocess = use_api_preprocess
        self.use_device_preprocess = use_device_preprocess
        self.max_det = max_det
        self.max_candidates = max_candidates
        self._trunc_images = 0
        self._trunc_total = 0
        self._trunc_max_gated = 0
        self._trunc_dropped = 0

    def _record_truncation(self, dets: NMS.Detections) -> None:
        n = dets.n_gated.cpu().numpy().reshape(-1)
        self._trunc_images += int((n > self.max_candidates).sum())
        self._trunc_total += int(n.size)
        self._trunc_max_gated = max(self._trunc_max_gated, int(n.max()))
        self._trunc_dropped += int(
            np.clip(n - self.max_candidates, 0, None).sum())

    def truncation_report(self) -> Dict[str, int]:
        """Accumulated candidate-truncation stats over every network call
        served; truncated_images > 0 means crowded inputs exceeded
        `max_candidates` and recall was capped."""
        return {"images": self._trunc_total,
                "truncated_images": self._trunc_images,
                "max_gated": self._trunc_max_gated,
                "max_candidates": int(self.max_candidates),
                "dropped_total": self._trunc_dropped}

    # ------------------------------------------------------------------
    # the engine
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def forward_rows(self, images_u8) -> torch.Tensor:
        """uint8 NHWC (bs, h, w, 3) -> decoded rows (bs, N, no) on the
        detector's device."""
        x = torch.as_tensor(images_u8).to(self.device)
        return self.forward_input(x.to(torch.float32) / 255.0)

    @torch.inference_mode()
    def forward_input(self, x: torch.Tensor) -> torch.Tensor:
        """float32 NHWC network input in [0, 1] on the detector's device ->
        decoded rows (bs, N, no)."""
        with full_fp32():
            if self._elan_blocks:
                raws = fused_apply(self.model, x, self._elan_blocks,
                                   self._elan_weights)
            else:
                raws = self.model(x)
        return decode(raws, self.spec)

    @torch.inference_mode()
    def postprocess(self, preds: torch.Tensor) -> NMS.Detections:
        """Decoded rows -> Detections with this detector's thresholds and
        capacities (on the rows' device)."""
        return NMS.non_max_suppression(
            preds, self.conf_thres, self.iou_thres, nc=self.spec.nc,
            max_candidates=self.max_candidates, max_det=self.max_det)

    def run_network(self, images_u8) -> NMS.Detections:
        """Raw engine call: uint8 NHWC (bs, h, w, 3) -> Detections on the
        detector's device."""
        dets = self.postprocess(self.forward_rows(images_u8))
        self._record_truncation(dets)
        return dets

    @torch.inference_mode()
    def device_input(self, raw_u8: torch.Tensor, img_size: int,
                     auto: bool):
        """Device preprocess of raw uint8 NHWC BGR frames on the detector's
        device -> (float32 NHWC network input, LetterboxGeometry), whose
        `out_hw` is the input shape the coordinate inverse needs."""
        src_hw = tuple(raw_u8.shape[1:3])
        if self.use_api_preprocess:
            # raw frames are BGR (cv2); the API chain expects RGB
            return (DP.device_preprocess_api(raw_u8.flip(-1), img_size),
                    DP.geometry_for_api(src_hw, img_size))
        geom = DP.letterbox_geometry(src_hw, img_size, auto=auto,
                                     stride=self.stride)
        return DP.device_letterbox(raw_u8, geom), geom

    def run_network_raw(self, raw_u8: torch.Tensor, img_size: int,
                        auto: bool):
        """Engine call with device preprocessing: raw uint8 NHWC frames on
        the device -> (Detections, LetterboxGeometry), the counterpart of
        the JAX `_executable_dev` run."""
        x, geom = self.device_input(raw_u8, img_size, auto)
        dets = self.postprocess(self.forward_input(x))
        self._record_truncation(dets)
        return dets, geom

    # ------------------------------------------------------------------
    # preprocessing
    # ------------------------------------------------------------------

    def _load(self, img) -> np.ndarray:
        if isinstance(img, (str, bytes)):
            import cv2
            im = cv2.imread(img)
            if im is None:
                raise ValueError(f"could not read image: {img!r}")
            return im
        return img

    def upload(self, images: np.ndarray) -> torch.Tensor:
        """Host uint8 NHWC frames -> the same on the detector's device."""
        return torch.from_numpy(np.ascontiguousarray(images)).to(self.device)

    def preprocess(self, img_bgr: np.ndarray, img_size: int) -> np.ndarray:
        """BGR HWC uint8 -> RGB HWC uint8 network input (reference
        multi_scale_face_detector.py:69-107 semantics for both modes)."""
        if self.use_api_preprocess:
            return LB.preprocess_api(img_bgr[:, :, ::-1], img_size,
                                     self.stride)
        return LB.preprocess_standard(img_bgr, img_size, self.stride,
                                      auto=True)

    # ------------------------------------------------------------------
    # detection APIs
    # ------------------------------------------------------------------

    def detect_single_scale(self, img, img_size: int, _raw_dev=None):
        """One image, one pyramid scale. Returns (detections, img0_shape,
        seconds): detections is (n, 7) [x1, y1, x2, y2, conf, cls,
        scale_idx] in original-image pixels (multi_scale_face_detector.py:
        109-166 contract, including the 6-column truncation, the
        API-inverse rescale and the .round()).

        `_raw_dev` (internal): the (1, h, w, 3) uint8 raw frame already on
        the device; the multi-scale loop uploads the frame once and reuses
        it at every scale when device preprocessing is on."""
        if _raw_dev is not None:
            img0_shape = tuple(int(v) for v in _raw_dev.shape[1:])
        else:
            img0 = self._load(img)
            img0_shape = img0.shape
        t1 = time.perf_counter()
        if self.use_device_preprocess:
            raw = _raw_dev if _raw_dev is not None else self.upload(img0[None])
            dets, geom = self.run_network_raw(raw, img_size, auto=True)
            inp_hw = geom.out_hw
        else:
            inp = self.preprocess(img0, img_size)
            dets = self.run_network(inp[None])
            inp_hw = inp.shape[:2]
        rows = NMS.detections_to_numpy(dets)[0]
        t2 = time.perf_counter()

        rows = rows[:, :6]
        if len(rows):
            rows[:, :4] = LB.scale_coords_api(
                inp_hw, rows[:, :4].astype(np.float64), img0_shape).round()
        scale_idx = self.img_sizes.index(img_size) if img_size in \
            self.img_sizes else -1
        out = np.hstack([rows, np.full((len(rows), 1), scale_idx,
                                       rows.dtype)])
        return out, img0_shape, t2 - t1

    def detect_multi_scale(self, img):
        """Full TTA pyramid: detect at every scale, merge with the
        scale-aware weighted NMS (multi_scale_face_detector.py:242-288),
        whose keep mask runs on the detector's device. Returns (final
        (n, 7) array, img0_shape)."""
        all_dets: List[np.ndarray] = []
        img0_shape = None
        img0 = self._load(img)
        # device preprocessing: ONE raw-frame upload serves all scales
        raw_dev = (self.upload(img0[None]) if self.use_device_preprocess
                   else None)
        for img_size in self.img_sizes:
            det, img0_shape, _ = self.detect_single_scale(
                img0, img_size, _raw_dev=raw_dev)
            if len(det):
                all_dets.append(det)
        if not all_dets:
            return np.zeros((0, 7)), img0_shape
        merged = np.vstack(all_dets)
        keep = NMS.weighted_nms_merge(merged, len(self.img_sizes),
                                      self.iou_thres, device=self.device)
        return merged[keep], img0_shape

    def detect_multi_scale_batch(self, imgs: Sequence) -> List[np.ndarray]:
        """Batched TTA pyramid: all images go through each scale as ONE
        engine call (host preprocessing), then merge per image with the
        weighted NMS.

        In API mode this is functionally identical to detect_multi_scale
        per image (same pad-to-square preprocess + top-left-scale
        inverse). In standard mode the images are letterboxed to a
        centered square (auto=False, the only batchable variant) and
        inverted with the exact gain+pad `scale_coords`, so boxes land in
        true original-image coordinates; for non-square images that
        differs from the per-image standard path, which applies the API
        inverse to an auto=True letterbox (multi_scale_face_detector.py:
        144, a reference quirk mirrored there)."""
        loaded = [self._load(im) for im in imgs]
        per_image: List[List[np.ndarray]] = [[] for _ in loaded]
        for scale_idx, img_size in enumerate(self.img_sizes):
            if self.use_api_preprocess:
                inputs = [self.preprocess(im, img_size) for im in loaded]
            else:
                inputs = [LB.preprocess_standard(im, img_size, self.stride,
                                                 auto=False)
                          for im in loaded]
            rows_list = NMS.detections_to_numpy(
                self.run_network(np.stack(inputs)))
            frame_hw = inputs[0].shape[:2]
            for i, rows in enumerate(rows_list):
                rows = rows[:, :6].astype(np.float64)
                if len(rows):
                    if self.use_api_preprocess:
                        rows[:, :4] = LB.scale_coords_api(
                            frame_hw, rows[:, :4], loaded[i].shape).round()
                    else:
                        rows[:, :4] = LB.scale_coords(
                            frame_hw, rows[:, :4],
                            loaded[i].shape[:2]).round()
                per_image[i].append(np.hstack([
                    rows, np.full((len(rows), 1), scale_idx)]))
        out = []
        for dets_per_scale in per_image:
            merged = np.vstack(dets_per_scale)
            if not len(merged):
                out.append(np.zeros((0, 7)))
                continue
            keep = NMS.weighted_nms_merge(merged, len(self.img_sizes),
                                          self.iou_thres, device=self.device)
            out.append(merged[keep])
        return out

    def detect_batch(self, imgs: Sequence, img_size: int,
                     kpt: bool = True) -> List[np.ndarray]:
        """Throughput path: a batch of images at one scale in one engine
        call, letterboxed to the same square (auto=False). With device
        preprocessing and frames of one shape (video), the raw frames are
        uploaded and letterboxed on the device. Returns per-image
        (n, 6 [+3*nkpt]) arrays in original coordinates."""
        img_size = check_img_size(img_size, self.stride)
        loaded = [self._load(img) for img in imgs]
        shapes = [im.shape for im in loaded]
        if self.use_device_preprocess and len(set(shapes)) == 1:
            dets, _ = self.run_network_raw(self.upload(np.stack(loaded)),
                                           img_size, auto=False)
        else:
            inputs = []
            for img0 in loaded:
                if self.use_api_preprocess:
                    inputs.append(LB.preprocess_api(
                        img0[:, :, ::-1], img_size, self.stride))
                else:
                    inputs.append(LB.preprocess_standard(
                        img0, img_size, self.stride, auto=False))
            dets = self.run_network(np.stack(inputs))
        rows_list = NMS.detections_to_numpy(dets)
        out = []
        for rows, shape in zip(rows_list, shapes):
            rows = rows.astype(np.float64)
            if not kpt:
                rows = rows[:, :6]
            if len(rows):
                if self.use_api_preprocess:
                    rows[:, :4] = LB.scale_coords_api(
                        (img_size, img_size), rows[:, :4], shape)
                    if kpt and rows.shape[1] > 6:
                        # same pad-to-square inverse for landmarks: pure
                        # scale by max(orig)/input, then clip
                        scale = max(shape[0], shape[1]) / img_size
                        rows[:, 6::3] = (rows[:, 6::3] * scale).clip(
                            0, shape[1])
                        rows[:, 7::3] = (rows[:, 7::3] * scale).clip(
                            0, shape[0])
                else:
                    rows[:, :4] = LB.scale_coords(
                        (img_size, img_size), rows[:, :4], shape[:2])
                    if kpt and rows.shape[1] > 6:
                        rows[:, 6:] = LB.scale_coords(
                            (img_size, img_size), rows[:, 6:], shape[:2],
                            kpt=True, step=3)
            out.append(rows)
        return out

    def warmup(self, img_size: Optional[int] = None, batch: int = 1):
        """Run the engine once on zeros (first-call allocations, the
        kernel's build and load) before serving."""
        size = check_img_size(img_size or self.img_sizes[0], self.stride)
        self.run_network(np.zeros((batch, size, size, 3), np.uint8))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
