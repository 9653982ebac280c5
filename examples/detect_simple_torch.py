#!/usr/bin/env python
"""Minimal single-image face detection on the PyTorch port — the
reference detect_simple.py (detect_simple.py:1-173) distilled to its
essence: load one image, letterbox, one forward + NMS, draw boxes and
5-point landmarks, save.

    python examples/detect_simple_torch.py --image face.jpg \
        [--weights yolov7-w6-face.pt] [--model yolov7-tiny-face] \
        [--device cuda|cpu]

`run` does the computing on a uint8 BGR frame (no file I/O, no OpenCV);
`main` reads the image, draws what `run` found and writes it.
Everything heavier (directories, videos, webcams/RTSP, batching, label
txts) lives in the port's cli/detect.py.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def run(img, weights=None, model="yolov7-tiny-face", img_size=640,
        conf_thres=0.25, iou_thres=0.45, device="cuda"):
    """FaceDetector(model, torch_weights=weights, ...) and one
    detect_batch([img], img_size, kpt=True). Returns (rows, seconds):
    the (n, 6 + 15) rows in `img`'s pixels and the call's host time."""
    from face_detection_multi_scale_tpu_torch.infer.detector import (
        FaceDetector)

    det = FaceDetector(model, torch_weights=weights, img_sizes=(img_size,),
                       conf_thres=conf_thres, iou_thres=iou_thres,
                       device=device)
    t0 = time.time()
    rows = det.detect_batch([img], img_size, kpt=True)[0]
    return rows, time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", required=True)
    ap.add_argument("--weights", default=None,
                    help="reference .pt / stripped .npz (random init "
                         "weights if omitted — demo only)")
    ap.add_argument("--model", default="yolov7-tiny-face")
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--conf-thres", type=float, default=0.25)
    ap.add_argument("--iou-thres", type=float, default=0.45)
    ap.add_argument("--output", default=None,
                    help="default: <image>_det<ext>")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import cv2

    from face_detection_multi_scale_tpu_torch.utils.plotting import (
        draw_detections)

    img = cv2.imread(args.image)
    if img is None:
        raise SystemExit(f"could not read {args.image}")

    rows, seconds = run(img, args.weights, args.model, args.img_size,
                        args.conf_thres, args.iou_thres, args.device)
    print(f"{len(rows)} faces in {seconds:.3f}s")
    draw_detections(img, rows, nkpt=5)
    out = args.output or str(
        Path(args.image).with_stem(Path(args.image).stem + "_det"))
    cv2.imwrite(out, img)
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
