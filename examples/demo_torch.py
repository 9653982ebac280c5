#!/usr/bin/env python
"""End-to-end demo on the PyTorch port (the reference notebook's role,
demo/inference_for_yolov5.ipynb): load a model, run single- and
multi-scale detection on an image, draw, and export JSON.

    python examples/demo_torch.py [image.jpg] [weights.pt|.npz] \
        [--device cuda|cpu]

`run` does the computing on uint8 BGR frames (no file I/O, no OpenCV);
`main` reads the image, calls `run`, and writes demo_result.jpg /
demo_result.json.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def run(image=None, weights=None, model="yolov7-tiny-face",
        img_sizes=(640, 1280), conf_thres=0.25, iou_thres=0.45,
        use_device_preprocess=False, device="cuda"):
    """hub.create(model, ...) with API preprocessing (on the device with
    `use_device_preprocess`, which needs no OpenCV), then
    detect_single_scale at the first size and detect_multi_scale over
    `img_sizes`. `image` is a uint8 BGR HWC array (random noise when
    None). Returns a dict: the detector, the image, the single-scale rows
    with their shape and seconds, and the multi-scale rows."""
    import numpy as np

    from face_detection_multi_scale_tpu_torch import hub

    det = hub.create(model, weights=weights, img_sizes=tuple(img_sizes),
                     conf_thres=conf_thres, iou_thres=iou_thres,
                     use_api_preprocess=True,
                     use_device_preprocess=use_device_preprocess,
                     device=device)
    if image is None:
        image = np.random.default_rng(0).integers(
            0, 255, (480, 640, 3), np.uint8)
    rows, shape, seconds = det.detect_single_scale(image, det.img_sizes[0])
    final, shape = det.detect_multi_scale(image)
    return {"det": det, "image": image, "rows": rows, "seconds": seconds,
            "final": final, "shape": shape}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("image", nargs="?", default=None)
    ap.add_argument("weights", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    image = None
    if args.image is not None:
        import cv2

        image = cv2.imread(args.image)
        if image is None:
            raise SystemExit(f"could not read {args.image}")
    else:
        print("no image given; using random noise")
    out = run(image, args.weights, device=args.device)
    det, final = out["det"], out["final"]
    size = det.img_sizes[0]
    print(f"single-scale {size}: {len(out['rows'])} faces in "
          f"{out['seconds'] * 1000:.1f} ms")
    print(f"multi-scale {det.img_sizes}: {len(final)} faces")

    det.save_detection_result(out["image"], final, "demo_result.jpg")
    det.export_to_json(final, out["shape"], "demo_result.json")
    print("wrote demo_result.jpg / demo_result.json")


if __name__ == "__main__":
    main()
