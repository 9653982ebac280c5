"""REST object-detection demo server.

    python -m face_detection_multi_scale_tpu_torch.cli.serve \
        [--port 5000] [--device cpu]

The port's counterpart of the JAX package's cli/serve.py, with the same
arguments and defaults, plus `--device` (default `cuda`; `cpu` runs
without a card). Equivalent surface to the reference Flask demo
(reference utils/flask_rest_api/restapi.py:1-37: POST
/v1/object-detection with an `image` file, or the raw image as the body,
-> JSON records; any other path answers 404), on the standard library's
http.server: no extra dependencies, the same endpoint and response
shape. Each request is one `FaceDetector.detect_batch` call; OpenCV
decodes the image on the host.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

DETECTOR = None
ARGS = None


def parse_multipart(body: bytes, boundary: bytes):
    """Minimal multipart/form-data parser: returns {name: bytes}."""
    parts = body.split(b"--" + boundary)
    out = {}
    for part in parts:
        if b"\r\n\r\n" not in part:
            continue
        head, _, data = part.partition(b"\r\n\r\n")
        m = re.search(rb'name="([^"]+)"', head)
        if m:
            out[m.group(1).decode()] = data.rstrip(b"\r\n-")
    return out


class Handler(BaseHTTPRequestHandler):
    def do_POST(self):
        if not self.path.startswith("/v1/object-detection"):
            self.send_error(404)
            return
        import cv2

        ctype = self.headers.get("Content-Type", "")
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if "multipart/form-data" in ctype:
            boundary = ctype.split("boundary=")[-1].encode()
            fields = parse_multipart(body, boundary)
            image_bytes = fields.get("image", b"")
        else:
            image_bytes = body
        img = cv2.imdecode(np.frombuffer(image_bytes, np.uint8),
                           cv2.IMREAD_COLOR)
        if img is None:
            self.send_error(400, "could not decode image")
            return
        rows = DETECTOR.detect_batch([img], ARGS.img_size, kpt=False)[0]
        records = [
            {"xmin": float(r[0]), "ymin": float(r[1]),
             "xmax": float(r[2]), "ymax": float(r[3]),
             "confidence": float(r[4]), "class": int(r[5]),
             "name": "face"}
            for r in rows]
        payload = json.dumps(records).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, fmt, *args):
        print("[serve]", fmt % args)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="yolov7-tiny-face",
                    help="zoo model name or reference cfg yaml path")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--conf-thres", type=float, default=0.25)
    ap.add_argument("--iou-thres", type=float, default=0.45)
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--host", default="0.0.0.0")
    # (no --micro-batch here: the HTTP handler serves one image per
    # request, and the engine runs whole batches at batch <= micro_batch,
    # so the flag would be inert; it lives on the CLIs that batch,
    # cli/detect.py and cli/batch_predict.py)
    ap.add_argument("--quantize", action="store_true",
                    help="W8A8 int8 serving (models/quant.py); "
                         "calibrates on the first request")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; cpu runs "
                         "without one)")
    args = ap.parse_args(argv)

    from face_detection_multi_scale_tpu_torch.infer.detector import (
        FaceDetector)
    from face_detection_multi_scale_tpu_torch.models.spec import load_spec

    global DETECTOR, ARGS
    ARGS = args
    model = (load_spec(args.model) if args.model.endswith(".yaml")
             else args.model)
    DETECTOR = FaceDetector(model, torch_weights=args.weights,
                            img_sizes=(args.img_size,),
                            conf_thres=args.conf_thres,
                            iou_thres=args.iou_thres,
                            quantize="int8" if args.quantize else None,
                            device=args.device)
    if args.quantize:
        # warmup's zero dummy must not become the calibration batch: the
        # first real request calibrates instead
        print("[serve] int8: first request calibrates")
    else:
        DETECTOR.warmup(args.img_size)
    server = ThreadingHTTPServer((args.host, args.port), Handler)
    print(f"serving on http://{args.host}:{args.port}"
          f"/v1/object-detection/{args.model}")
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
