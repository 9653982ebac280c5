#!/usr/bin/env python
"""Deployment-consumer demo on the PyTorch port (the onnx_inference/ role
in the reference, onnx_inference/yolo_pose_onnx_inference.py): run
detection from an EXPORTED artifact only — no model code, no weights
conversion — as a serving container would with a `.pt2` program.

    python examples/exported_inference_torch.py [image.jpg] [model-name] \
        [--device cuda|cpu]

Part 1 exports the model (random weights unless `run` is given a
checkpoint; cli/export.py exports real ones), reloads the `.pt2`,
letterboxes the image on the host, runs the program (network + decode +
NMS inside, its keep mask the custom op `fdms_torch::nms_keep`, the
hand-written kernel on the card), and maps the rows back to the image.
Part 2 is the ONNX consumer: the native ONNX-13 artifact run by the
port's numpy runner (standing in for onnxruntime) and a consumer-side
numpy greedy NMS. `run` computes (the artifacts go to a temporary
directory); `main` reads the image, draws and writes exported_result.jpg.
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def synthetic_image():
    """A gray 480x640 BGR frame with one bright noisy square."""
    import numpy as np

    rng = np.random.default_rng(0)
    img0 = np.full((480, 640, 3), 64, np.uint8)
    img0[160:320, 240:400] = rng.integers(128, 255, (160, 160, 3), np.uint8)
    return img0


def build_model(name, weights=None):
    """The float32 YoloFace of zoo model `name` on the CPU: `weights` (a
    reference .pt or the JAX package's .npz) or the init of seed 0."""
    import torch

    from face_detection_multi_scale_tpu_torch.models import zoo
    from face_detection_multi_scale_tpu_torch.models.convert import (
        jax_to_state_dict, load_inference_weights, load_reference_state_dict,
        load_torch_checkpoint)
    from face_detection_multi_scale_tpu_torch.models.model import (
        YoloFace, init_weights)

    spec = zoo.get_spec(name).resolve()
    net = YoloFace(spec)
    if weights is None:
        init_weights(net, torch.Generator().manual_seed(0))
    elif str(weights).endswith(".npz"):
        load_reference_state_dict(net, jax_to_state_dict(
            load_inference_weights(str(weights))))
    else:
        load_reference_state_dict(net, load_torch_checkpoint(str(weights)))
    return spec, net.eval()


def onnx_greedy_nms(pred, conf_thres=0.25, iou_thres=0.45):
    """Consumer-side postprocess of one image's decoded (N, no) ONNX rows,
    numpy only: the two-stage gate, then greedy NMS in score order.
    Returns the kept rows' indices into `pred`."""
    import numpy as np

    obj = pred[:, 4]
    conf = obj * pred[:, 5]
    cand = np.where((obj > conf_thres) & (conf > conf_thres))[0]
    cand = cand[np.argsort(-conf[cand])]
    cxy, wh = pred[cand, :2], pred[cand, 2:4]
    bxyxy = np.concatenate([cxy - wh / 2, cxy + wh / 2], axis=1)
    keep_idx = []
    for i in range(len(cand)):
        bi = bxyxy[i]
        ok = True
        for j in keep_idx:
            bj = bxyxy[j]
            iw = max(0.0, min(bi[2], bj[2]) - max(bi[0], bj[0]))
            ih = max(0.0, min(bi[3], bj[3]) - max(bi[1], bj[1]))
            inter = iw * ih
            union = ((bi[2] - bi[0]) * (bi[3] - bi[1]) +
                     (bj[2] - bj[0]) * (bj[3] - bj[1]) - inter)
            if union > 0 and inter / union > iou_thres:
                ok = False
                break
        if ok:
            keep_idx.append(i)
    return cand[keep_idx]


def run(image=None, model="yolov7-lite-t", img_size=256, weights=None,
        conf_thres=0.25, iou_thres=0.45, device="cuda"):
    """Export `model` as a `.pt2` with its postprocess on `device`, load
    it back and run it on the host letterbox of `image` (uint8 BGR HWC;
    the synthetic frame when None); then the ONNX consumer on the same
    input. Returns a dict: the image, the network input `x` (1, s, s, 3)
    RGB, the program's rows in the image's pixels [x1, y1, x2, y2, conf,
    cls, 15 landmark values], the model and its spec, the artifact's
    bytes, the ONNX consumer's kept indices, and each part's host
    seconds."""
    import numpy as np

    from face_detection_multi_scale_tpu_torch.data import letterbox as LB
    from face_detection_multi_scale_tpu_torch.export_model import (
        export_onnx, export_program, load_program)
    from face_detection_multi_scale_tpu_torch.onnx import runner

    seconds = {}
    clock = time.perf_counter()

    def lap(part):
        nonlocal clock
        now = time.perf_counter()
        seconds[part], clock = now - clock, now

    img0 = synthetic_image() if image is None else image
    # producer side (normally cli/export.py with real weights)
    spec, net = build_model(model, weights)
    with tempfile.TemporaryDirectory() as tmp:
        artifact = Path(tmp) / f"{model}.pt2"
        export_program(net, spec, str(artifact), img_size=img_size, batch=1,
                       conf_thres=conf_thres, iou_thres=iou_thres,
                       device=device)
        size = artifact.stat().st_size
        lap("export")

        # consumer side: the artifact only
        prog = load_program(str(artifact))
        lap("load")
        lb, ratio, pad = LB.letterbox(img0, img_size, auto=False,
                                      scaleup=False)
        x = np.ascontiguousarray(lb[None, :, :, ::-1])  # BGR -> RGB NHWC
        boxes, scores, classes, extras, valid = (v.cpu().numpy()
                                                 for v in prog(x))
        keep = valid[0]
        rows = np.concatenate(
            [boxes[0][keep], scores[0][keep, None], classes[0][keep, None],
             extras[0][keep]], axis=1).astype(np.float64)
        if len(rows):
            LB.scale_coords((img_size, img_size), rows[:, :4],
                            img0.shape[:2], ratio_pad=(ratio, pad))
            rows[:, 6:] = LB.scale_coords(
                (img_size, img_size), rows[:, 6:], img0.shape[:2],
                ratio_pad=(ratio, pad), kpt=True, step=3)
        lap("call")

        # Part 2 — the ONNX consumer (the reference's onnx_inference demo
        # shape): the native dependency-free ONNX artifact, executed with
        # the port's numpy runner standing in for onnxruntime, and a
        # consumer-side numpy postprocess. External ONNX runtimes attach
        # their own NMS, so the artifact carries decoded rows only.
        onnx_path = str(artifact.with_suffix(".onnx"))
        export_onnx(net, spec, onnx_path, img_size=img_size, batch=1)
        (pred,) = runner.run_onnx(onnx_path, {"images": x})
    onnx_keep = onnx_greedy_nms(pred[0], conf_thres, iou_thres)
    lap("onnx")
    return {"image": img0, "x": x, "rows": rows, "model": net, "spec": spec,
            "pt2_bytes": size, "onnx_keep": onnx_keep,
            "ratio_pad": (ratio, pad), "seconds": seconds}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("image", nargs="?", default=None)
    ap.add_argument("model", nargs="?", default="yolov7-lite-t")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import cv2

    from face_detection_multi_scale_tpu_torch.utils.plotting import (
        draw_detections)

    img0 = None
    if args.image:
        img0 = cv2.imread(args.image)
        if img0 is None:
            raise SystemExit(f"could not read {args.image}")
    out = run(img0, args.model, device=args.device)
    print(f"exported {args.model}.pt2 ({out['pt2_bytes'] / 1e6:.1f} MB)")
    rows, img0 = out["rows"], out["image"]
    print(f"{len(rows)} detections")
    draw_detections(img0, rows, nkpt=out["spec"].nkpt)
    path = "exported_result.jpg"
    cv2.imwrite(path, img0)
    print(f"saved {path}")
    print(f"ONNX consumer path: {len(out['onnx_keep'])} detections "
          f"(fused-artifact path found {len(rows)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
