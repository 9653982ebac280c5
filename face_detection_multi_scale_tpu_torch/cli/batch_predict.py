"""Production multi-scale batch prediction over a CSV corpus.

    python -m face_detection_multi_scale_tpu_torch.cli.batch_predict \
        --csv items.csv --base-path footage/

The port's counterpart of the JAX package's cli/batch_predict.py, with
the same arguments and defaults, plus `--device` (default `cuda`; `cpu`
runs without a card). Equivalent surface to the reference production
pipeline (reference yolov7_face_multi_scale_dataframe_predict.py:
1008-1098 argparse and resume flow): CSV of (item_id, image-path-prefix)
rows -> per-item JSON tensor files + max-faces images, with
skip/continue/restart modes. Defaults mirror the reference: conf 0.6 /
IoU 0.3, scales 640+3840, API preprocessing.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv", required=True,
                    help="CSV with item_id and path columns")
    ap.add_argument("--item-col", default=None,
                    help="item id column (default: first)")
    ap.add_argument("--path-col", default=None,
                    help="path column (default: second)")
    ap.add_argument("--model", default="yolov7-w6-face")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--output-dir",
                    default="./api_predict_json_results_multi_scale")
    ap.add_argument("--max-faces-dir",
                    default="./api_predict_max_faces_images")
    ap.add_argument("--base-path", default="",
                    help="base directory prefix for image paths")
    ap.add_argument("--img-sizes", type=int, nargs="+",
                    default=[640, 3840])
    ap.add_argument("--conf-thres", type=float, default=0.6)
    ap.add_argument("--iou-thres", type=float, default=0.3)
    ap.add_argument("--max-items", type=int, default=None)
    ap.add_argument("--num-workers", type=int, default=8)
    ap.add_argument("--force-continue", action="store_true",
                    help="skip already-processed items")
    ap.add_argument("--force-restart", action="store_true",
                    help="reprocess everything")
    ap.add_argument("--check-progress", action="store_true",
                    help="only report done/partial/missing counts")
    ap.add_argument("--fuse-elan", nargs="?", const=True,
                    default=False,
                    help="fused E-ELAN serving kernels (optional variant "
                         "expression)")
    ap.add_argument("--micro-batch", type=int, default=None,
                    help="run the engine over chunks of this size, one "
                         "call a chunk (peak activation memory is the "
                         "chunk's)")
    ap.add_argument("--quantize", action="store_true",
                    help="W8A8 int8 serving (models/quant.py), "
                         "calibrated on the first served batch")
    ap.add_argument("--tile-top-scale", type=int, default=0,
                    help="run pyramid scales >= 2048 px as a g x g "
                         "batch of halo'd tiles (g=this value; 0=off); "
                         "approximation near seams — infer/tiling.py")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; cpu runs "
                         "without one)")
    args = ap.parse_args(argv)

    import pandas as pd

    from face_detection_multi_scale_tpu_torch.infer.detector import (
        DTYPES, FaceDetector)
    from face_detection_multi_scale_tpu_torch.infer.production import (
        ProductionPipeline)

    df = pd.read_csv(args.csv)
    item_col = args.item_col or df.columns[0]
    path_col = args.path_col or df.columns[1]
    items = list(zip(df[item_col].tolist(), df[path_col].tolist()))
    if args.max_items:
        items = items[:args.max_items]
    print(f"{len(items)} items from {args.csv}")

    detector = FaceDetector(
        args.model, torch_weights=args.weights,
        img_sizes=tuple(args.img_sizes), conf_thres=args.conf_thres,
        iou_thres=args.iou_thres, use_api_preprocess=True,
        fuse_elan=args.fuse_elan, tile_top_scale=args.tile_top_scale,
        micro_batch=args.micro_batch,
        quantize="int8" if args.quantize else None,
        dtype=DTYPES[args.dtype], device=args.device)
    pipeline = ProductionPipeline(
        detector, args.output_dir, args.max_faces_dir,
        base_image_path=args.base_path, io_workers=args.num_workers)

    progress = pipeline.check_progress(items)
    print(f"progress: {len(progress['done'])} done, "
          f"{len(progress['partial'])} partial, "
          f"{len(progress['missing'])} missing")
    if args.check_progress:
        return 0

    skip = args.force_continue or not args.force_restart
    results = pipeline.run(items, skip_processed=skip)
    total_faces = sum(r[2] for r in results)
    total_frames = sum(r[1] for r in results)
    print(f"Done: {len(results)} items, {total_frames} frames, "
          f"{total_faces} faces -> {args.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
