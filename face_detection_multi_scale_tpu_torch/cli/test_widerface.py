"""WIDER FACE val-set prediction writer.

    python -m face_detection_multi_scale_tpu_torch.cli.test_widerface \
        --weights w.npz --dataset_folder data/widerface/val/images/

The port's counterpart of the JAX package's cli/test_widerface.py, with
the same arguments and defaults, plus `--device` (default `cuda`; `cpu`
runs without a card). Equivalent surface to the reference
test_widerface.py (test_widerface.py:31-145): reads `wider_val.txt` next
to the dataset folder, runs the model over every image, and writes
per-image prediction txts in the exact format the official evaluation
consumes (name line, count line, `x1 y1 w h conf` rows with int(+0.5)
rounding — test_widerface.py:88-114). Default operating point conf 0.01 /
IoU 0.5 (test_widerface.py:124-125), `max_candidates` 16384, `max_det`
4096, batches of 16.

Images are bucketed by their letterboxed shape (or, with
`--device-preprocess`, by their original shape) and run in batches, one
engine call a batch, instead of the reference's per-image loop. `main`
reads and buckets the images (OpenCV); `write_buckets` runs the buckets
from decoded frames.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from face_detection_multi_scale_tpu_torch.data.letterbox import (
    letterbox, scale_coords)
from face_detection_multi_scale_tpu_torch.eval.widerface import (
    write_pred_file)
from face_detection_multi_scale_tpu_torch.infer.detector import (
    DTYPES, FaceDetector)
from face_detection_multi_scale_tpu_torch.ops.nms import (
    detections_to_numpy, truncation_stats)


def write_buckets(det, buckets: Dict[Tuple[int, int], List[Tuple]],
                  save_folder: str, *, img_size: int, batch_size: int,
                  device_preprocess: bool = False) -> Dict:
    """Run every bucket through `det` and write one prediction txt an
    image under `save_folder`.

    `buckets` maps a shape to its items (name, original HWC shape, frame):
    on the host route the frame is the image letterboxed (auto=True) to
    that shape, BGR, and the batch goes through `run_network`; with
    `device_preprocess` it is the raw BGR image of that original shape,
    and the batch goes through `run_network_raw(raw, img_size,
    auto=True)`, which letterboxes on the device. Buckets run largest
    first. A quantized detector that is not calibrated yet calibrates on
    the first batch (on the device route, on its device-letterboxed
    input). Returns {"written": txts, "gated": n_gated an image, "batches":
    engine calls, "batch_ms": each call's ms to its rows on the host}."""
    n_written, gated_counts, batch_ms = 0, [], []
    for shape, items in sorted(buckets.items(), key=lambda kv: -len(kv[1])):
        for i in range(0, len(items), batch_size):
            chunk = items[i:i + batch_size]
            t0 = time.perf_counter()
            if device_preprocess:
                raw = torch.from_numpy(np.stack(
                    [frame for _, _, frame in chunk])).to(det.device)
                if det._quantize and det._qparams is None:
                    det.calibrate_int8(det.device_input(raw, img_size,
                                                        auto=True)[0])
                # BGR: device_letterbox swaps channels on the device
                dets, geom = det.run_network_raw(raw, img_size, auto=True)
                inp_hw = geom.out_hw
            else:
                batch = np.stack([np.ascontiguousarray(frame[:, :, ::-1])
                                  for _, _, frame in chunk])
                dets = det.run_network(batch)
                inp_hw = shape
            rows_list = detections_to_numpy(dets)
            batch_ms.append((time.perf_counter() - t0) * 1e3)
            gated_counts.extend(dets.n_gated.cpu().numpy().tolist())
            for (name, img0_shape, _), rows in zip(chunk, rows_list):
                rows = rows.astype(np.float64)
                if len(rows):
                    scale_coords(inp_hw, rows[:, :4], img0_shape)
                save_name = os.path.join(save_folder, name[:-4] + ".txt")
                write_pred_file(save_name, Path(save_name).stem,
                                rows[:, :5])
                n_written += 1
    return {"written": n_written, "gated": gated_counts,
            "batches": len(batch_ms), "batch_ms": batch_ms}


def report_truncation(gated: Sequence[int], max_candidates: int) -> Dict:
    """Print the candidate-truncation telemetry of a run and return it:
    the reference keeps every gated box (max_nms 30000,
    utils/general.py:518-524); a fixed capacity drops candidates when a
    crowded image exceeds it."""
    stats = truncation_stats(gated, max_candidates)
    if stats["truncated_images"]:
        print(f"WARNING: {stats['truncated_images']}/{stats['images']} "
              f"images exceeded --max-candidates {max_candidates} "
              f"(max gated {stats['max_gated']}, "
              f"{stats['dropped_total']} candidates dropped) — raise "
              f"--max-candidates to recover recall")
    else:
        print(f"candidate truncation: none "
              f"(max gated {stats['max_gated']}/{max_candidates})")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", default=None)
    ap.add_argument("--model", default="yolov7-w6-face")
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--conf-thres", type=float, default=0.01)
    ap.add_argument("--iou-thres", type=float, default=0.5)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--dataset_folder", default="data/widerface/val/images/")
    ap.add_argument("--save_folder", default="widerface_evaluate/widerface_txt/")
    ap.add_argument("--kpt-label", type=int, default=5)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    # the reference NMS admits 30000 pre-NMS boxes and keeps all survivors
    # (utils/general.py:518-524); at conf 0.01 crowded hard-set images
    # need generous fixed capacities to avoid recall loss
    ap.add_argument("--max-det", type=int, default=4096)
    ap.add_argument("--max-candidates", type=int, default=16384)
    ap.add_argument("--device-preprocess", action="store_true",
                    help="letterbox + BGR->RGB + /255 on the device (raw "
                         "frames bucketed by ORIGINAL shape); differs "
                         "from the cv2 letterbox by <=2/255 per pixel")
    ap.add_argument("--quantize", action="store_true",
                    help="W8A8 int8 serving (models/quant.py), "
                         "calibrated on the first batch — use with the "
                         "eval protocol to measure the int8 AP delta")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; cpu runs "
                         "without one)")
    args = ap.parse_args(argv)

    import cv2

    det = FaceDetector(args.model, torch_weights=args.weights,
                       img_sizes=(args.img_size,),
                       conf_thres=args.conf_thres, iou_thres=args.iou_thres,
                       max_det=args.max_det,
                       max_candidates=args.max_candidates,
                       quantize="int8" if args.quantize else None,
                       dtype=DTYPES[args.dtype], device=args.device)

    testset_list = args.dataset_folder[:-7] + "wider_val.txt"
    with open(testset_list) as f:
        names = f.read().split()
    print(f"{len(names)} val images")

    # bucket by letterboxed (auto=True) shape for the host-cv2 path, by
    # ORIGINAL raw shape for the device-preprocess path (the letterbox
    # then runs on the device, its geometry fixed per raw shape)
    t0 = time.time()
    buckets = defaultdict(list)
    for name in names:
        path = args.dataset_folder + name
        img0 = cv2.imread(path)
        if img0 is None:
            print(f"WARNING: unreadable {path}")
            continue
        if args.device_preprocess:
            buckets[img0.shape[:2]].append((name, img0.shape, img0))
        else:
            lb = letterbox(img0, args.img_size, stride=det.stride,
                           auto=True)[0]
            buckets[lb.shape[:2]].append((name, img0.shape, lb))

    out = write_buckets(det, buckets, args.save_folder,
                        img_size=args.img_size, batch_size=args.batch_size,
                        device_preprocess=args.device_preprocess)
    print(f"Done. {out['written']} txts in {time.time() - t0:.3f}s "
          f"({len(buckets)} shape buckets) -> {args.save_folder}")
    report_truncation(out["gated"], args.max_candidates)
    return 0


if __name__ == "__main__":
    sys.exit(main())
