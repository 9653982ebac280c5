"""Standalone validation / speed / study CLI.

    python -m face_detection_multi_scale_tpu_torch.cli.test --data d.yaml

The port's counterpart of the JAX package's cli/test.py, with the same
arguments and defaults, plus `--device` (default `cuda`; `cpu` runs
without a card). Equivalent surface to the reference test.py (reference
test.py:41-455): `--task val` computes P/R/mAP50/mAP over a dataset yaml
(infer/validate.py); `--task speed` times inference+NMS; `--task study`
sweeps image sizes 256..1536 step 128 and writes study_*.txt
(test.py:438-455). Defaults: conf 0.001 / IoU 0.6 (test.py:388-389).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from face_detection_multi_scale_tpu_torch.infer.detector import DTYPES
from face_detection_multi_scale_tpu_torch.models import zoo
from face_detection_multi_scale_tpu_torch.models.convert import (
    jax_to_state_dict, load_inference_weights, load_reference_state_dict,
    load_torch_checkpoint)
from face_detection_multi_scale_tpu_torch.models.fuse import fold_bn
from face_detection_multi_scale_tpu_torch.models.head import decode
from face_detection_multi_scale_tpu_torch.models.model import (
    YoloFace, cast_model, compute_strides, full_fp32, init_weights)
from face_detection_multi_scale_tpu_torch.models.spec import load_spec
from face_detection_multi_scale_tpu_torch.ops import nms as NMS


def build(args):
    """(spec, YoloFace) of `--model` (a zoo name or a cfg yaml) with
    `--weights` (the JAX package's inference .npz or a reference .pt;
    seeded random weights without), BN folded, in `--dtype`, on
    `--device`."""
    if args.model.endswith(".yaml"):
        spec = load_spec(args.model)
        compute_strides(spec)
    else:
        spec = zoo.get_spec(args.model)
    spec = spec.resolve()
    net = YoloFace(spec)
    if args.weights:
        state = (jax_to_state_dict(load_inference_weights(args.weights))
                 if args.weights.endswith(".npz")
                 else load_torch_checkpoint(args.weights))
        load_reference_state_dict(net, state)
    else:
        init_weights(net, torch.Generator().manual_seed(0))
    fold_bn(net)
    device = torch.device(args.device)
    return spec, cast_model(net.eval().to(device), DTYPES[args.dtype])


def run_val(args, img_size):
    import yaml

    from face_detection_multi_scale_tpu_torch.data.dataset import (
        FaceDataset)
    from face_detection_multi_scale_tpu_torch.infer.validate import validate

    spec, model = build(args)
    with open(args.data) as f:
        data = yaml.safe_load(f)
    ds = FaceDataset(data["val"], img_size=img_size, augment=False,
                     hyp={}, kpt_label=args.kpt_label,
                     stride=spec.max_stride, rect=args.rect,
                     batch_size=args.batch_size,
                     pad=0.5 if args.rect else 0.0)
    save_dir = None
    if args.save_txt or args.save_json:
        from face_detection_multi_scale_tpu_torch.utils.general import (
            increment_path)
        save_dir = increment_path(Path(args.project) / args.name,
                                  args.exist_ok)
    return validate(model, ds, batch_size=args.batch_size,
                    conf_thres=args.conf_thres, iou_thres=args.iou_thres,
                    augment=args.augment, flip_test=args.flip_test,
                    save_dir=save_dir, save_txt=args.save_txt,
                    save_conf=args.save_conf, save_json=args.save_json,
                    weights_name=args.weights or args.model,
                    anno_json=args.anno_json)


def run_speed(args, img_size):
    spec, model = build(args)
    device = next(model.parameters()).device
    dtype = next(model.parameters()).dtype

    @torch.inference_mode()
    def engine(x):
        with full_fp32():
            raws = model((x.float() / 255.0).to(dtype))
        d = NMS.non_max_suppression(decode(raws, spec), args.conf_thres,
                                    args.iou_thres, nc=spec.nc,
                                    nkpt=spec.nkpt, max_candidates=2048,
                                    max_det=300)
        # sum EVERY field so each one (landmarks too) is computed, as the
        # JAX engine's sum keeps them in its executable
        return (d.boxes.float().sum() + d.scores.float().sum()
                + d.classes.float().sum() + d.extras.float().sum()
                + d.valid.sum())

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    b = args.batch_size
    batches = [np.random.default_rng(i).integers(
        0, 255, (b, img_size, img_size, 3), np.uint8) for i in range(2)]
    resident = [torch.from_numpy(x).to(device) for x in batches]
    float(engine(resident[0]))
    iters = 20
    sync()
    t0 = time.perf_counter()
    accs = [engine(resident[i % 2]) for i in range(iters)]
    sync()
    float(accs[-1])
    dt = time.perf_counter() - t0
    ms = 1000 * dt / (iters * b)
    print(f"Speed: {ms:.2f} ms/image inference+NMS per {img_size}x"
          f"{img_size} image at batch-size {b}")
    return {"ms_per_image": ms, "img_size": img_size}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", default=None)
    ap.add_argument("--model", default="yolov7-w6-face")
    ap.add_argument("--data", default=None, help="dataset yaml (val task)")
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--conf-thres", type=float, default=0.001)
    ap.add_argument("--iou-thres", type=float, default=0.6)
    ap.add_argument("--task", default="val",
                    choices=["val", "test", "speed", "study"])
    ap.add_argument("--kpt-label", type=int, default=5)
    ap.add_argument("--rect", action="store_true",
                    help="aspect-ratio batched val (rect=True, pad=0.5 — "
                         "the upstream test.py:114-119 protocol; off by "
                         "default because the reference fork hard-forces "
                         "rect=False in utils/datasets.py:357, so its "
                         "actual val protocol is the square letterbox)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--augment", action="store_true",
                    help="scale/flip TTA (models/yolo.py:363-374)")
    ap.add_argument("--flip-test", action="store_true",
                    help="lr-flip fusion (test.py:145-151)")
    ap.add_argument("--save-txt", action="store_true",
                    help="per-image normalized-xywh label txts under "
                         "<save_dir>/labels/ (test.py:197-204)")
    ap.add_argument("--save-conf", action="store_true",
                    help="append confidence to --save-txt lines")
    ap.add_argument("--save-json", action="store_true",
                    help="COCO-format predictions json incl. keypoints "
                         "(test.py:225-239, 324-330; unlike the "
                         "reference, bbox is actually written)")
    ap.add_argument("--anno-json", default=None,
                    help="COCO annotations json — when it exists and "
                         "pycocotools is importable, runs the COCO eval "
                         "on the saved predictions (test.py:331-345)")
    ap.add_argument("--project", default="runs/test")
    ap.add_argument("--name", default="exp")
    ap.add_argument("--exist-ok", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; cpu runs "
                         "without one)")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")

    if args.task in ("val", "test"):
        assert args.data, "--data required for val/test"
        run_val(args, args.img_size)
    elif args.task == "speed":
        args.conf_thres, args.iou_thres = 0.25, 0.45
        run_speed(args, args.img_size)
    elif args.task == "study":
        # size sweep 256 -> 1536 step 128 (test.py:442-455)
        name = Path(args.weights or args.model).stem
        rows = []
        for s in range(256, 1536 + 128, 128):
            r = run_speed(args, s)
            if args.data:
                v = run_val(args, s)
                rows.append([s, v["mp"], v["mr"], v["map50"], v["map"],
                             r["ms_per_image"]])
            else:
                rows.append([s, r["ms_per_image"]])
        out = f"study_{name}.txt"
        np.savetxt(out, np.array(rows), fmt="%10.4g")
        print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
