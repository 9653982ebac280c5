"""Model export for deployment.

The counterpart of the JAX package's export_model.py. The reference
exports TorchScript / ONNX / CoreML (reference models/export.py:85-149)
and raw-head ONNX for the ncnn C++ app (reference cpp/export.py:62-70).
The port's artifacts:

  * a `torch.export` program (`.pt2`) in place of the JAX StableHLO and
    SavedModel artifacts: the inference function with the weights inside,
    optionally with the full postprocess (decode + fixed-capacity NMS)
    fused in, the analog of --export-nms (models/export.py:78,105). The
    NMS's keep mask is the custom op `fdms_torch::nms_keep`, so the
    loaded program launches the hand-written kernel on the card, once a
    call (`load_program` registers the op before loading);
  * ONNX-13 through the port's own emitter (onnx/export.py): float,
    fused NMS, and the W8A8 int8 graph;
  * raw-head mode: per-stride undecoded maps, the cpp/export.py contract
    for external runtimes (consumed by native/'s fdms_detect app).

Every artifact takes uint8 NHWC RGB network-input frames, casts them to
the dtype and divides by 255 inside, as the JAX `_build_fn` does.
"""

from __future__ import annotations

import copy
import json
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from face_detection_multi_scale_tpu_torch.infer.detector import _device
from face_detection_multi_scale_tpu_torch.models import quant
from face_detection_multi_scale_tpu_torch.models.fuse import fold_bn
from face_detection_multi_scale_tpu_torch.models.head import decode
from face_detection_multi_scale_tpu_torch.models.model import (
    cast_model, full_fp32)
from face_detection_multi_scale_tpu_torch.ops import nms as NMS
# the custom ops a saved program may hold are registered on import
from face_detection_multi_scale_tpu_torch.ops import nms_kernel  # noqa: F401
from face_detection_multi_scale_tpu_torch.ops import qconv_kernel  # noqa: F401

MAX_CANDIDATES = 2048  # the JAX export's non_max_suppression capacity


def serving_model(model: nn.Module, dtype: torch.dtype = torch.float32,
                  device="cpu", fold: bool = True) -> nn.Module:
    """A copy of the float32 `YoloFace` `model` as the detector serves it:
    BN folded in float32 (models/fuse.fold_bn), cast to `dtype`
    (models/model.cast_model: the implicit priors stay float32), in eval
    mode, without gradients, on `device`."""
    net = copy.deepcopy(model).eval()
    if fold:
        fold_bn(net)
    net = cast_model(net, dtype).to(device)
    net.requires_grad_(False)
    return net


def qparams_to(qparams: Dict, device) -> Dict:
    """The qparams of models/quant.quantize with every tensor on `device`
    (each conv's `inv_out` stays on the host, where `qconv` reads it)."""
    return {
        "convs": {tag: {k: (v if k == "inv_out" else v.to(device))
                        for k, v in q.items()}
                  for tag, q in qparams["convs"].items()},
        "adds": {tag: v.to(device) for tag, v in qparams["adds"].items()},
        "head_scales": qparams["head_scales"].to(device),
    }


class InferenceModule(nn.Module):
    """The exported function (the JAX `_build_fn`) as a module whose
    parameters are the weights: uint8 NHWC frames -> `dtype` / 255 ->
    the `YoloFace` `net` (BN folded, in `dtype`) -> the per-level raw maps
    (`raw_heads`), the decoded rows, or with `include_postprocess` the
    five Detections fields of `ops/nms.non_max_suppression` at
    max_candidates 2048: boxes, scores, classes, extras, valid."""

    def __init__(self, net: nn.Module, spec, *, raw_heads: bool = False,
                 include_postprocess: bool = False,
                 conf_thres: float = 0.25, iou_thres: float = 0.45,
                 max_det: int = 300, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net = net
        self.spec = spec
        self.raw_heads = raw_heads
        self.include_postprocess = include_postprocess
        self.conf_thres, self.iou_thres = conf_thres, iou_thres
        self.max_det = max_det
        self.dtype = dtype

    def forward(self, images_u8: torch.Tensor):
        x = images_u8.to(self.dtype) / 255.0
        raws = self.net(x)
        if self.raw_heads:
            return tuple(raws)  # per-stride (bs, na, ny, nx, no) maps
        preds = decode(raws, self.spec)
        if not self.include_postprocess:
            return preds
        d = NMS.non_max_suppression(
            preds, self.conf_thres, self.iou_thres, nc=self.spec.nc,
            nkpt=self.spec.nkpt, max_candidates=MAX_CANDIDATES,
            max_det=self.max_det)
        return d.boxes, d.scores, d.classes, d.extras, d.valid


class QuantInferenceModule(nn.Module):
    """The W8A8 walk as a module: uint8 NHWC frames -> models/quant.
    quant_apply on `qparams` with the float32 head of `net` (a BN-folded
    `YoloFace`) -> the per-level raw maps (`raw_heads`) or the decoded
    rows. Each conv is one `qconv` call, the custom op `fdms_torch::qconv`
    under export."""

    def __init__(self, net: nn.Module, spec, qparams: Dict, *,
                 raw_heads: bool = False):
        super().__init__()
        self.net = net
        self.spec = spec
        self.qparams = qparams
        self.raw_heads = raw_heads

    def forward(self, images_u8: torch.Tensor):
        raws = quant.quant_apply(self.spec, self.qparams, images_u8,
                                 self.net.model[-1], dtype=torch.float32)
        return tuple(raws) if self.raw_heads else decode(raws, self.spec)


def _build_fn(model, spec, *, include_postprocess: bool, raw_heads: bool,
              conf_thres: float, iou_thres: float, max_det: int, dtype,
              device="cpu") -> InferenceModule:
    """The exported function of the float32 `YoloFace` `model`, its copy
    served in `dtype` on `device`."""
    return InferenceModule(
        serving_model(model, dtype, device), spec, raw_heads=raw_heads,
        include_postprocess=include_postprocess, conf_thres=conf_thres,
        iou_thres=iou_thres, max_det=max_det, dtype=dtype)


def _meta(spec, *, img_size, batch, include_postprocess, raw_heads,
          conf_thres, iou_thres, max_det) -> dict:
    """The JSON sidecar of a program, with the JAX StableHLO sidecar's
    keys."""
    return {
        "model": spec.name, "img_size": img_size, "batch": batch,
        "include_postprocess": include_postprocess, "raw_heads": raw_heads,
        "conf_thres": conf_thres, "iou_thres": iou_thres,
        "max_det": max_det, "nkpt": spec.nkpt, "nc": spec.nc,
        "strides": list(spec.strides),
        "input": "uint8 NHWC RGB, network-input frame",
        "output": ("per-stride raw maps" if raw_heads else
                   ("boxes,scores,classes,extras,valid" if
                    include_postprocess else "decoded (bs, N, no)")),
    }


def trace_program(model, spec, *, img_size: int = 640, batch: int = 1,
                  include_postprocess: bool = True,
                  raw_heads: bool = False, conf_thres: float = 0.25,
                  iou_thres: float = 0.45, max_det: int = 300,
                  dtype: torch.dtype = torch.float32, device="cuda"):
    """The non-strict `torch.export` of the inference function of the
    float32 `YoloFace` `model` (served in `dtype` on `device`) at
    (batch, img_size, img_size, 3) uint8: an ExportedProgram with the
    weights inside, not decomposed, so that it launches what the live
    path launches (`aten.silu`, cuDNN convs, the `fdms_torch::nms_keep`
    kernel)."""
    device = _device(device)
    fn = _build_fn(model, spec, include_postprocess=include_postprocess,
                   raw_heads=raw_heads, conf_thres=conf_thres,
                   iou_thres=iou_thres, max_det=max_det, dtype=dtype,
                   device=device)
    x = torch.zeros((batch, img_size, img_size, 3), dtype=torch.uint8,
                    device=device)
    return torch.export.export(fn, (x,), strict=False)


def save_program(exported, path: str, meta: dict) -> str:
    """`torch.export.save` to `path` (a `.pt2`) and the JSON sidecar to
    `path + ".json"`."""
    torch.export.save(exported, path)
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return path


def export_program(model, spec, path: str, *, img_size: int = 640,
                   batch: int = 1, include_postprocess: bool = True,
                   raw_heads: bool = False, conf_thres: float = 0.25,
                   iou_thres: float = 0.45, max_det: int = 300,
                   dtype: torch.dtype = torch.float32,
                   device="cuda") -> str:
    """Serialize the inference function (weights baked in) to a `.pt2`
    program + a JSON sidecar describing the contract (the port's
    `export_stablehlo`). `model` is a float32 `YoloFace`; the program
    serves its BN-folded copy in `dtype` on `device` (the card unless
    the caller asks for the CPU)."""
    exported = trace_program(
        model, spec, img_size=img_size, batch=batch,
        include_postprocess=include_postprocess, raw_heads=raw_heads,
        conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det,
        dtype=dtype, device=device)
    return save_program(exported, path, _meta(
        spec, img_size=img_size, batch=batch,
        include_postprocess=include_postprocess, raw_heads=raw_heads,
        conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det))


def op_count(exported, name: str) -> int:
    """Nodes of `exported`'s graph that call the op `name` (e.g.
    "fdms_torch.nms_keep")."""
    return sum(n.op == "call_function" and str(n.target).startswith(
        name + ".") for n in exported.graph.nodes)


class Program:
    """A loaded `.pt2`: call it on uint8 NHWC frames (numpy or a tensor,
    moved to the program's device) for the exported outputs, a tuple of
    tensors (a raw-heads or decoded program: its maps or its rows). Runs
    in inference mode with cuDNN in full float32 (no TF32), as the
    detector's forward. `exported` is the ExportedProgram, `meta` the
    sidecar (None without one)."""

    def __init__(self, exported, meta: Optional[dict] = None):
        self.exported = exported
        self.module = exported.module()
        self.meta = meta
        self.device = next(iter(exported.state_dict.values())).device

    def __call__(self, images_u8):
        x = images_u8 if isinstance(images_u8, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(images_u8))
        x = x.to(self.device)
        with torch.inference_mode(), full_fp32():
            out = self.module(x)
        return tuple(out) if isinstance(out, (tuple, list)) else out


def load_program(path: str) -> Program:
    """Load a `.pt2` written by `export_program` (its custom ops are
    registered by this module's imports) and its sidecar."""
    exported = torch.export.load(path)
    meta = None
    try:
        with open(path + ".json") as f:
            meta = json.load(f)
    except FileNotFoundError:
        pass
    return Program(exported, meta)


def export_onnx(model, spec, path: str, *, img_size: int = 640,
                batch: int = 1, include_postprocess: bool = False,
                raw_heads: bool = False, conf_thres: float = 0.25,
                iou_thres: float = 0.45, max_det: int = 300,
                dtype=torch.float32, opset: int = 13, engine: str = "auto",
                qparams=None) -> str:
    """ONNX, the reference's interchange format (models/export.py:85-132,
    opset 11 there; 13 here), through the port's native emitter
    (onnx/export.py: the ATen graph of a `torch.export` mapped to
    ONNX-13, no optional package). `engine="auto"` is "native", the only
    engine. Output is decoded (bs, N, no) predictions, per-stride raw maps
    with raw_heads=True (the reference cpp/export.py contract), or with
    include_postprocess=True the --export-nms equivalent: decode + ONNX
    `NonMaxSuppression`, outputs boxes/scores/classes/extras/batch_index
    with a dynamic detection count. `qparams` (models/quant.
    quantize_model, or FaceDetector.calibrate_int8) selects the W8A8 int8
    graph, with `model`'s float head. The graph is float32 (`dtype` is
    taken for the JAX signature's sake)."""
    if engine == "auto":
        engine = "native"
    if engine == "tf2onnx":
        raise ValueError(
            "engine='tf2onnx' is the JAX package's jax2tf -> tf2onnx "
            "bridge; the port has no TensorFlow path and emits ONNX "
            "natively (engine='native')")
    if engine != "native":
        raise ValueError(f"unknown ONNX engine {engine!r}")
    if opset != 13:
        raise ValueError(
            f"native ONNX export emits opset 13 only (got {opset})")
    if raw_heads and include_postprocess:
        raise ValueError(
            "raw_heads and include_postprocess are mutually exclusive "
            "(raw maps have no boxes to suppress)")
    from face_detection_multi_scale_tpu_torch.onnx.export import (
        export_onnx_native, export_onnx_native_fused,
        export_onnx_native_quant)

    if qparams is not None:
        export_onnx_native_quant(
            spec, qparams, path, model=model, img_size=img_size,
            batch=batch, raw_heads=raw_heads,
            include_postprocess=include_postprocess, conf_thres=conf_thres,
            iou_thres=iou_thres, max_det=max_det)
    elif include_postprocess:
        export_onnx_native_fused(
            model, spec, path, img_size=img_size, batch=batch,
            conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det)
    else:
        export_onnx_native(model, spec, path, img_size=img_size,
                           batch=batch, raw_heads=raw_heads)
    meta = {
        "model": spec.name, "img_size": img_size, "batch": batch,
        "include_postprocess": include_postprocess,
        "raw_heads": raw_heads,
        "nkpt": spec.nkpt, "nc": spec.nc,
        "strides": list(spec.strides), "opset": 13,
        "engine": "native",
        "quantize": "int8" if qparams is not None else None,
        "input": "uint8 NHWC RGB, network-input frame",
        "output": ("boxes,scores,classes,extras,batch_index "
                   "(dynamic K)" if include_postprocess
                   else "per-stride raw maps" if raw_heads
                   else "decoded (bs, N, no)"),
    }
    if include_postprocess:
        meta.update(conf_thres=conf_thres, iou_thres=iou_thres,
                    max_det=max_det)
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return path
