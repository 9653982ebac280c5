#!/usr/bin/env python
"""Model export CLI.

    python -m face_detection_multi_scale_tpu_torch.cli.export \\
        --model yolov7-w6-face --weights w.npz [--format onnx] [--device cpu]

The port's counterpart of the JAX package's cli/export.py (the
models/export.py + cpp/export.py surface of the reference), with its
arguments and defaults, plus `--device` (default `cuda`; `cpu` runs
without a card). `--format pt2` (the default) writes a `torch.export`
program (export_model.export_program; load it with
export_model.load_program), in place of the JAX package's `stablehlo`
and `savedmodel`, which this CLI refuses; `--format onnx` writes ONNX-13
through the port's own emitter, float, with the fused NMS
(`--export-nms`) or W8A8 int8 (`--quantize int8 --calib-images`).
`--export-nms` defaults on for pt2 and off for onnx, as in JAX.
"""

from __future__ import annotations

import argparse
import glob as _glob
import sys
from pathlib import Path

import numpy as np
import torch

SUFFIX = {"pt2": ".pt2", "onnx": ".onnx"}


def _build_qparams(spec, model, calib_src: str, img_size: int, device):
    """Load calibration frames (npz/npy array, or an image dir/glob
    letterboxed to the export size) and run post-training W8A8
    calibration (models/quant.quantize_model on the BN-folded float32
    model on `device`; 8 frames max, as FaceDetector.calibrate_int8)."""
    from face_detection_multi_scale_tpu_torch import export_model as EM
    from face_detection_multi_scale_tpu_torch.models import quant

    p = Path(calib_src)
    if calib_src.endswith((".npy", ".npz")):
        loaded = np.load(calib_src)
        arr = loaded[loaded.files[0]] if hasattr(loaded, "files") \
            else loaded
    else:
        import cv2

        from face_detection_multi_scale_tpu_torch.data.letterbox import (
            letterbox)
        paths = (sorted(str(f) for f in p.iterdir())
                 if p.is_dir() else sorted(_glob.glob(calib_src)))
        frames = []
        for fp in paths[:8]:
            img = cv2.imread(fp)
            if img is None:
                continue
            rgb = np.ascontiguousarray(img[:, :, ::-1])
            frames.append(letterbox(rgb, (img_size, img_size),
                                    auto=False)[0])
        if not frames:
            raise SystemExit(f"no readable images in {calib_src}")
        arr = np.stack(frames)
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise SystemExit(
            f"calibration array must be (N, H, W, 3), got {arr.shape}")
    x = torch.as_tensor(np.ascontiguousarray(arr[:8])).to(device)
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    return quant.quantize_model(
        spec, EM.serving_model(model, torch.float32, device), x)


def build_model(model_name: str, weights):
    """(spec, float32 YoloFace on the CPU) of a zoo name or a cfg yaml,
    with the JAX package's inference .npz or a reference .pt, seeded
    random weights without."""
    from face_detection_multi_scale_tpu_torch.models import zoo
    from face_detection_multi_scale_tpu_torch.models.convert import (
        jax_to_state_dict, load_inference_weights,
        load_reference_state_dict, load_torch_checkpoint)
    from face_detection_multi_scale_tpu_torch.models.model import (
        YoloFace, compute_strides, init_weights)
    from face_detection_multi_scale_tpu_torch.models.spec import load_spec

    if model_name.endswith(".yaml"):
        spec = load_spec(model_name)
        compute_strides(spec)
    else:
        spec = zoo.get_spec(model_name)
    spec = spec.resolve()
    net = YoloFace(spec)
    if weights:
        state = (jax_to_state_dict(load_inference_weights(weights))
                 if weights.endswith(".npz")
                 else load_torch_checkpoint(weights))
        load_reference_state_dict(net, state)
    else:
        init_weights(net, torch.Generator().manual_seed(0))
    return spec, net.eval()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="yolov7-tiny-face")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--format", default="pt2",
                    choices=["pt2", "onnx", "stablehlo", "savedmodel"],
                    help="pt2: a torch.export program with the weights "
                         "inside (the port's stablehlo and savedmodel); "
                         "onnx serializes natively (no extra packages), "
                         "including --export-nms (standard "
                         "NonMaxSuppression ops, dynamic K)")
    ap.add_argument("--output", default=None)
    ap.add_argument("--export-nms", action="store_true", default=None,
                    help="fuse decode + NMS into the artifact (default "
                         "for pt2; off for onnx, matching the "
                         "reference's ONNX contract)")
    ap.add_argument("--no-export-nms", dest="export_nms",
                    action="store_false")
    ap.add_argument("--raw-heads", action="store_true",
                    help="per-stride undecoded maps (cpp/export.py mode)")
    ap.add_argument("--conf-thres", type=float, default=0.25)
    ap.add_argument("--iou-thres", type=float, default=0.45)
    ap.add_argument("--max-det", type=int, default=300)
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="W8A8 int8 ONNX graph (ConvInteger bodies, "
                         "int8 initializers): the serving mode of "
                         "FaceDetector(quantize='int8'); needs "
                         "--calib-images")
    ap.add_argument("--calib-images", default=None,
                    help="calibration frames for --quantize: a .npy/"
                         ".npz of uint8 NHWC network-input frames, or "
                         "an image directory/glob (letterboxed to "
                         "--img-size); at most 8 frames are used")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the export (default the card; "
                         "cpu runs without one): the program's device "
                         "for pt2, the calibration's for --quantize")
    args = ap.parse_args(argv)
    if args.format in ("stablehlo", "savedmodel"):
        ap.error(f"--format {args.format} is the JAX package's; the port "
                 "writes --format pt2 (a torch.export program) or onnx")

    from face_detection_multi_scale_tpu_torch import export_model as EM
    from face_detection_multi_scale_tpu_torch.infer.detector import _device

    device = _device(args.device)
    spec, net = build_model(args.model, args.weights)

    qparams = None
    if args.quantize:
        if args.format != "onnx":
            ap.error("--quantize is ONNX-only (pt2 serves the float "
                     "graph; the int8 mode serves live via FaceDetector)")
        if not args.calib_images:
            ap.error("--quantize int8 needs --calib-images")
        qparams = _build_qparams(spec, net, args.calib_images,
                                 args.img_size, device)

    out = args.output or f"{spec.name}_{args.img_size}{SUFFIX[args.format]}"
    export_nms = (args.export_nms if args.export_nms is not None
                  else args.format != "onnx")
    if args.format == "pt2":
        EM.export_program(
            net, spec, out, img_size=args.img_size, batch=args.batch_size,
            include_postprocess=export_nms, raw_heads=args.raw_heads,
            conf_thres=args.conf_thres, iou_thres=args.iou_thres,
            max_det=args.max_det, device=device)
    else:
        EM.export_onnx(
            net, spec, out, img_size=args.img_size, batch=args.batch_size,
            include_postprocess=export_nms, raw_heads=args.raw_heads,
            conf_thres=args.conf_thres, iou_thres=args.iou_thres,
            max_det=args.max_det, qparams=qparams)
    print(f"exported -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
