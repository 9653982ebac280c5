"""A/B comparison of preprocessing methods (API pad-to-square+letterbox vs
standard letterbox).

    python -m face_detection_multi_scale_tpu_torch.cli.compare_resize_methods \
        --image img.jpg [--device cpu]

The port's counterpart of the JAX package's cli/compare_resize_methods.py
(the reference compare_resize_methods.py +
MultiScaleFaceDetector.compare_preprocessing_methods surface, reference
multi_scale_face_detector.py:618-688), with the same arguments plus
`--device` (default `cuda`; `cpu` runs without a card). Renders a
side-by-side panel and prints `FaceDetector.compare_preprocessing_methods`'
quantitative diff as JSON."""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", required=True)
    ap.add_argument("--model", default="yolov7-tiny-face",
                    help="zoo model name or reference cfg yaml path")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--conf-thres", type=float, default=0.5)
    ap.add_argument("--out", default="resize_comparison.png")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; cpu runs "
                         "without one)")
    args = ap.parse_args(argv)

    import cv2
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from face_detection_multi_scale_tpu_torch.data.letterbox import (
        letterbox, preprocess_api)
    from face_detection_multi_scale_tpu_torch.infer.detector import (
        FaceDetector)
    from face_detection_multi_scale_tpu_torch.models.spec import load_spec

    img0 = cv2.imread(args.image)
    assert img0 is not None, f"cannot read {args.image}"

    # visual panel: original | standard letterbox | api pad-square
    std = letterbox(img0, args.img_size, auto=False)[0]
    api = preprocess_api(img0[:, :, ::-1], args.img_size)
    fig, axes = plt.subplots(1, 3, figsize=(16, 6))
    axes[0].imshow(img0[:, :, ::-1])
    axes[0].set_title(f"original {img0.shape[1]}x{img0.shape[0]}")
    axes[1].imshow(std[:, :, ::-1])
    axes[1].set_title("standard letterbox")
    axes[2].imshow(api)
    axes[2].set_title("API pad-to-square + letterbox")
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(args.out, dpi=100)
    print(f"panel -> {args.out}")

    model = (load_spec(args.model) if args.model.endswith(".yaml")
             else args.model)
    det = FaceDetector(model, torch_weights=args.weights,
                       img_sizes=(args.img_size,),
                       conf_thres=args.conf_thres, device=args.device)
    result = det.compare_preprocessing_methods(img0, args.img_size)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
