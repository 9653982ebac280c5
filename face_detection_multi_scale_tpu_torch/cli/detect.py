"""Single/batch image + video face detection CLI.

    python -m face_detection_multi_scale_tpu_torch.cli.detect \
        --source data/images [--device cpu]

The port's counterpart of the JAX package's cli/detect.py, with the same
arguments and defaults, plus `--device` (default `cuda`; `cpu` runs
without a card). Equivalent surface to the reference detect.py
(reference detect.py:20-202, argparse :160-185): runs a model over
images, directories, globs, videos or streams (webcam index, RTSP /
RTMP / HTTP URL, a .txt list of them); draws boxes + 5-point landmarks;
optionally saves label txts. Default operating point conf 0.25 / IoU
0.45 (detect.py:171-172). Frames go through `FaceDetector.detect_batch`;
OpenCV reads, draws and writes them on the host.
"""

from __future__ import annotations

import argparse
import glob
import sys
import time
from pathlib import Path

IMG_EXT = {".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp"}
VID_EXT = {".mov", ".avi", ".mp4", ".mpg", ".mpeg", ".m4v", ".wmv", ".mkv"}


def is_stream_source(source: str) -> bool:
    """Webcam index / RTSP / RTMP / HTTP stream / .txt list of streams —
    the reference detect.py:56-61 routing to LoadStreams."""
    return (source.isnumeric() or source.endswith(".txt")
            or source.lower().startswith(("rtsp://", "rtmp://",
                                          "http://", "https://")))


def list_sources(source: str):
    p = Path(source)
    if p.is_dir():
        files = sorted(str(f) for f in p.iterdir()
                       if f.suffix.lower() in IMG_EXT | VID_EXT)
    elif "*" in source:
        files = sorted(glob.glob(source, recursive=True))
    else:
        files = [source]
    imgs = [f for f in files if Path(f).suffix.lower() in IMG_EXT]
    vids = [f for f in files if Path(f).suffix.lower() in VID_EXT]
    return imgs, vids


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", default=None,
                    help="torch .pt checkpoint, or the JAX layout's "
                         "inference .npz")
    ap.add_argument("--model", default="yolov7-tiny-face",
                    help="zoo model name or reference cfg yaml path")
    ap.add_argument("--source", default="data/images")
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--conf-thres", type=float, default=0.25)
    ap.add_argument("--iou-thres", type=float, default=0.45)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--save-txt", action="store_true")
    ap.add_argument("--save-conf", action="store_true")
    ap.add_argument("--nosave", action="store_true")
    ap.add_argument("--hide-labels", action="store_true")
    ap.add_argument("--hide-conf", action="store_true")
    ap.add_argument("--kpt-label", type=int, default=5)
    ap.add_argument("--project", default="runs/detect")
    ap.add_argument("--name", default="exp")
    ap.add_argument("--exist-ok", action="store_true")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--max-frames", type=int, default=0,
                    help="stop stream sources after N frames per stream "
                         "(0 = run until the stream ends)")
    ap.add_argument("--fuse-elan", nargs="?", const=True,
                    default=False,
                    help="execute E-ELAN groups as single fused_elan "
                         "kernels; optionally a variant expression, e.g. "
                         "'pre:flat+im2col9+ab+ct' (models/fused."
                         "apply_variant grammar)")
    ap.add_argument("--micro-batch", type=int, default=None,
                    help="run the engine over chunks of this size, one "
                         "call a chunk (peak activation memory is the "
                         "chunk's)")
    ap.add_argument("--quantize", action="store_true",
                    help="W8A8 int8 serving (models/quant.py): int8 "
                         "weights + activations, calibrated on the "
                         "first served batch")
    ap.add_argument("--tile-top-scale", type=int, default=0,
                    help="run giant scales (>= 2048 px) as a g x g batch "
                         "of halo'd tiles (g=this value; 0=off); "
                         "approximation near seams (infer/tiling.py)")
    ap.add_argument("--device-preprocess", action="store_true",
                    help="resize+pad+normalize on the device (uint8 "
                         "raw frames are the only host-to-device copy; "
                         "best for video/webcam where frames share one "
                         "shape; numerics differ from cv2 by <=2/255 per "
                         "pixel)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; cpu runs "
                         "without one)")
    args = ap.parse_args(argv)

    import cv2

    from face_detection_multi_scale_tpu_torch.infer.detector import (
        DTYPES, FaceDetector)
    from face_detection_multi_scale_tpu_torch.models.spec import load_spec
    from face_detection_multi_scale_tpu_torch.utils.general import (
        increment_path)
    from face_detection_multi_scale_tpu_torch.utils.plotting import (
        draw_detections)

    save_dir = increment_path(Path(args.project) / args.name, args.exist_ok)
    (save_dir / "labels" if args.save_txt else save_dir).mkdir(
        parents=True, exist_ok=True)

    model = (load_spec(args.model) if args.model.endswith(".yaml")
             else args.model)
    det = FaceDetector(model, torch_weights=args.weights,
                       img_sizes=(args.img_size,),
                       conf_thres=args.conf_thres,
                       iou_thres=args.iou_thres,
                       use_device_preprocess=args.device_preprocess,
                       fuse_elan=args.fuse_elan,
                       micro_batch=args.micro_batch,
                       tile_top_scale=args.tile_top_scale,
                       quantize="int8" if args.quantize else None,
                       dtype=DTYPES[args.dtype], device=args.device)

    t0 = time.time()
    n_done = 0

    def process_frames(frames, paths, writer=None):
        nonlocal n_done
        rows_list = det.detect_batch(frames, args.img_size, kpt=True)
        for frame, path, rows in zip(frames, paths, rows_list):
            n_done += 1
            if len(rows):
                draw_detections(frame, rows, hide_labels=args.hide_labels,
                                hide_conf=args.hide_conf,
                                nkpt=args.kpt_label)
            if args.save_txt:
                h, w = frame.shape[:2]
                txt = save_dir / "labels" / (Path(path).stem + ".txt")
                with open(txt, "a") as f:
                    for r in rows:
                        xywh = [((r[0] + r[2]) / 2) / w,
                                ((r[1] + r[3]) / 2) / h,
                                (r[2] - r[0]) / w, (r[3] - r[1]) / h]
                        line = [int(r[5])] + xywh + (
                            [r[4]] if args.save_conf else [])
                        f.write(" ".join(f"{v:g}" for v in line) + "\n")
            if writer is not None:
                writer.write(frame)
            elif not args.nosave:
                cv2.imwrite(str(save_dir / Path(path).name), frame)
            print(f"{path}: {len(rows)} faces")

    if is_stream_source(args.source):
        # webcam index / rtsp / rtmp / http / .txt stream list -> the
        # threaded multi-stream grabber (reference detect.py:56-61 via
        # utils/datasets.py:262-340); each iteration is the freshest
        # frame of every stream, batched through one engine call
        from face_detection_multi_scale_tpu_torch.data.streams import (
            LoadStreams)

        streams = LoadStreams(args.source)
        writers = {}
        if not args.nosave:
            for si, s in enumerate(streams.sources):
                h0, w0 = streams.frames[si].shape[:2]
                writers[si] = cv2.VideoWriter(
                    str(save_dir / f"stream{si}.mp4"),
                    cv2.VideoWriter_fourcc(*"mp4v"), 30, (w0, h0))
        try:
            for fi, (sources, frames, _) in enumerate(streams):
                for si, frame in enumerate(frames):
                    process_frames([frame], [f"stream{si}"],
                                   writers.get(si))
                if args.max_frames and fi + 1 >= args.max_frames:
                    break
        finally:
            streams.close()
            for w in writers.values():
                w.release()
        imgs, vids = [], []
    else:
        imgs, vids = list_sources(args.source)

    # images, batched
    for i in range(0, len(imgs), args.batch_size):
        chunk = imgs[i:i + args.batch_size]
        frames = [cv2.imread(p) for p in chunk]
        process_frames(frames, chunk)

    # videos, frame by frame
    for vid in vids:
        cap = cv2.VideoCapture(vid)
        fps = cap.get(cv2.CAP_PROP_FPS) or 30
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        out_path = str(save_dir / (Path(vid).stem + ".mp4"))
        writer = None
        if not args.nosave:
            writer = cv2.VideoWriter(out_path,
                                     cv2.VideoWriter_fourcc(*"mp4v"),
                                     fps, (w, h))
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            process_frames([frame], [vid], writer)
        cap.release()
        if writer is not None:
            writer.release()

    dt = time.time() - t0
    print(f"Done. {n_done} frames in {dt:.3f}s "
          f"({1000 * dt / max(n_done, 1):.1f} ms/frame). "
          f"Results saved to {save_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
