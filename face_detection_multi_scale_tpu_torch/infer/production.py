"""Production batch-prediction pipeline: corpus -> per-item Triton-style
JSON tensors + max-faces images + DataFrame/CSV reports, resumable.

The port's counterpart of the JAX package's infer/production.py, a
re-design of the reference pipeline
(reference yolov7_face_multi_scale_dataframe_predict.py: frame expansion
:679 via utils/preprocess_yolo_predict.py:203-238, JSON tensor contract
:779-837, skip/resume :617-660 and :902-999, DataFrame columns :176-235,
report :315-424; operating point conf 0.6 / IoU 0.3, scales [640, 3840],
ckpt version tag "yolo_w6_face_multiscale_v1").

Execution model: the reference shards work across GPUs with a spawn Pool
pinning CUDA_VISIBLE_DEVICES per process
(yolov7_face_multi_scale_dataframe_predict.py:569-597). Here one
multi-scale FaceDetector serves its card while IO worker threads decode
frames, and a run of several processes (one a card, `torch.distributed`
initialized) shards items by rank; one process takes every item. pandas
is imported only by the DataFrame functions, cv2 only by `process_item`.
"""

from __future__ import annotations

import glob
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CKPT_VERSION = "yolo_w6_face_multiscale_v1"
PAD_BBOX = [-1.0, -1.0, -1.0, -1.0]


def get_image_paths_from_base(base_path: str,
                              base_image_path: str = "") -> List[str]:
    """Expand an item's `..._original.jpg` prefix to all of its
    `..._original_*.jpg` frames (utils/preprocess_yolo_predict.py:203-238).
    """
    full = os.path.join(base_image_path, base_path) if base_image_path \
        else base_path
    if not os.path.exists(full) and "_original.jpg" not in full:
        return []
    dir_path = os.path.dirname(full)
    base_name = os.path.basename(full)
    if "_original.jpg" in base_name:
        prefix = base_name.replace("_original.jpg", "")
        frames = sorted(glob.glob(
            os.path.join(dir_path, f"{prefix}_original_*.jpg")))
        if frames:
            return frames
        return [full] if os.path.exists(full) else []
    return [full] if os.path.exists(full) else []


def frames_to_json(all_frames_data: List[Dict], total_elapsed: float,
                   ckpt_version: str = CKPT_VERSION) -> Optional[Dict]:
    """Per-item Triton-style tensor dict, padded to the max face count
    (yolov7_face_multi_scale_dataframe_predict.py:779-837). Tensor names,
    datatypes, shapes, and padding sentinels match the reference exactly.
    """
    if not all_frames_data:
        return None
    num_frames = len(all_frames_data)
    max_faces = max(f["num_faces"] for f in all_frames_data)

    def pad(frame, key, fill):
        return frame[key] + [fill] * (max_faces - frame["num_faces"])

    tensors = [
        {"name": "yolo-face-bboxes", "datatype": "FP32",
         "shape": [num_frames, max_faces, 4],
         "data": [pad(f, "bboxes", PAD_BBOX) for f in all_frames_data]},
        {"name": "yolo-face-confidence", "datatype": "FP32",
         "shape": [num_frames, max_faces],
         "data": [pad(f, "confidence", -1.0) for f in all_frames_data]},
        {"name": "yolo-face-class_names", "datatype": "BYTES",
         "shape": [num_frames, max_faces],
         "data": [pad(f, "class_names", "unknown")
                  for f in all_frames_data]},
        {"name": "yolo-face-class_indexes", "datatype": "INT32",
         "shape": [num_frames, max_faces],
         "data": [pad(f, "class_indexes", -1) for f in all_frames_data]},
        {"name": "yolo-face-class_groups", "datatype": "BYTES",
         "shape": [num_frames, max_faces],
         "data": [pad(f, "class_groups", "unknown")
                  for f in all_frames_data]},
        {"name": "yolo-face-scale_used", "datatype": "BYTES",
         "shape": [num_frames, max_faces],
         "data": [pad(f, "scale_used", "unknown")
                  for f in all_frames_data]},
        {"name": "yolo-face-ckpt_version", "datatype": "BYTES",
         "shape": [num_frames], "data": [ckpt_version] * num_frames},
        {"name": "yolo-face-infer_time", "datatype": "FP32",
         "shape": [num_frames],
         "data": [f["infer_time"] for f in all_frames_data]},
        {"name": "yolo-face-total_time", "datatype": "FP32",
         "shape": [1], "data": [total_elapsed]},
    ]
    return {"yolo_face_prediction": tensors}


def read_existing_json(json_path: str) -> Optional[Tuple[int, int, float]]:
    """Inspect an existing item JSON; returns (num_frames, total_faces,
    total_elapsed) if valid, else None (skip-path semantics,
    yolov7_face_multi_scale_dataframe_predict.py:617-660)."""
    try:
        with open(json_path, encoding="utf-8") as f:
            data = json.load(f)
        total_elapsed = 0.0
        for tensor in data.get("yolo_face_prediction", []):
            if tensor.get("name") == "yolo-face-total_time":
                if tensor.get("data"):
                    total_elapsed = tensor["data"][0]
        for tensor in data.get("yolo_face_prediction", []):
            if tensor.get("name") == "yolo-face-bboxes":
                shape = tensor.get("shape", [0, 0, 0])
                total = sum(
                    1 for frame in tensor.get("data", [])
                    for bbox in frame if bbox[0] > -0.99)
                return shape[0], total, total_elapsed
    except Exception:
        return None
    return None


def detections_to_dataframe(detections: np.ndarray, img_path: str,
                            full_img_path: str, img_sizes: Sequence[int]):
    """(n, 7) detections -> per-face geometry DataFrame
    (yolov7_face_multi_scale_dataframe_predict.py:176-235 columns)."""
    import pandas as pd

    cols = ["image_path", "full_image_path", "file_name", "face_id",
            "x1", "y1", "x2", "y2", "width", "height", "area",
            "center_x", "center_y", "aspect_ratio", "confidence",
            "scale_used"]
    rows = []
    for i, det in enumerate(np.asarray(detections)):
        if len(det) < 5:
            continue
        x1, y1, x2, y2, conf = det[:5]
        scale_idx = int(det[6]) if len(det) >= 7 else -1
        w, h = x2 - x1, y2 - y1
        rows.append({
            "image_path": img_path,
            "full_image_path": full_img_path,
            "file_name": os.path.basename(img_path),
            "face_id": i,
            "x1": int(x1), "y1": int(y1), "x2": int(x2), "y2": int(y2),
            "width": int(w), "height": int(h), "area": int(w * h),
            "center_x": int((x1 + x2) / 2), "center_y": int((y1 + y2) / 2),
            "aspect_ratio": (w / h) if h > 0 else 0,
            "confidence": float(conf),
            "scale_used": (img_sizes[scale_idx]
                           if 0 <= scale_idx < len(img_sizes)
                           else "unknown"),
        })
    return pd.DataFrame(rows, columns=cols)


def shard_of_process() -> Tuple[int, int]:
    """(rank, world size) of this process: `torch.distributed`'s when it
    is initialized, else (0, 1), where the JAX pipeline takes the JAX
    process index and count."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ProductionPipeline:
    """Resumable corpus processor over a multi-scale FaceDetector."""

    def __init__(self, detector, json_dir: str, max_faces_dir: str,
                 base_image_path: str = "", io_workers: int = 8,
                 ckpt_version: str = CKPT_VERSION):
        self.detector = detector
        self.json_dir = json_dir
        self.max_faces_dir = max_faces_dir
        self.base_image_path = base_image_path
        self.io_workers = io_workers
        self.ckpt_version = ckpt_version
        os.makedirs(json_dir, exist_ok=True)
        os.makedirs(max_faces_dir, exist_ok=True)

    # ------------------------------------------------------------------

    def _faces(self, dets: np.ndarray, infer_time: float) -> Dict:
        """(n, 7) multi-scale rows of one frame -> its frame tensor dict."""
        sizes = self.detector.img_sizes
        return {
            "bboxes": [[float(v) for v in d[:4]] for d in dets],
            "confidence": [float(d[4]) for d in dets],
            "class_names": ["face"] * len(dets),
            "class_indexes": [int(d[5]) for d in dets],
            "class_groups": ["face"] * len(dets),
            "scale_used": [str(sizes[int(d[6])])
                           if 0 <= int(d[6]) < len(sizes) else "unknown"
                           for d in dets],
            "num_faces": len(dets),
            "infer_time": infer_time,
        }

    def detect_frame(self, img_bgr: np.ndarray) -> Tuple[Dict, float]:
        """One frame through the multi-scale engine -> frame tensor dict."""
        t0 = time.perf_counter()
        dets, _ = self.detector.detect_multi_scale(img_bgr)
        elapsed = time.perf_counter() - t0
        return self._faces(dets, elapsed), elapsed

    def detect_frames(self, images: Sequence[np.ndarray]):
        """Decoded BGR frames of one item -> (frame tensor dicts, (frame,
        its dict) with the most faces or None). With a batched pyramid
        (`detect_multi_scale_batch`) all frames go through each scale as
        one engine call, and each frame's `infer_time` is the call's time
        over the frames; otherwise `detect_frame` a frame."""
        if not len(images):
            return [], None
        if hasattr(self.detector, "detect_multi_scale_batch"):
            t0 = time.perf_counter()
            dets_list = self.detector.detect_multi_scale_batch(images)
            per_frame_t = (time.perf_counter() - t0) / len(images)
            found = [self._faces(d, per_frame_t) for d in dets_list]
        else:
            found = [self.detect_frame(img)[0] for img in images]
        best = max(range(len(found)), key=lambda i: found[i]["num_faces"])
        return found, (images[best], found[best])

    def process_item(self, item_id, base_path: str,
                     skip_processed: bool = False):
        """One item: expand frames, detect, write JSON + max-faces image.
        Returns (item_id, num_frames, total_faces, total_elapsed) or None.
        """
        import cv2

        json_path = os.path.join(self.json_dir, f"{item_id}.json")
        existing_imgs = glob.glob(os.path.join(
            self.max_faces_dir, f"{item_id}_max_*.jpg"))
        if skip_processed and os.path.exists(json_path) and existing_imgs:
            info = read_existing_json(json_path)
            if info is not None:
                return (item_id, *info)

        frame_paths = get_image_paths_from_base(base_path,
                                                self.base_image_path)
        if not frame_paths:
            return None

        t_item = time.perf_counter()
        with ThreadPoolExecutor(self.io_workers) as pool:
            images = list(pool.map(cv2.imread, frame_paths))
        images = [im for im in images if im is not None]
        all_frames, max_faces_frame = self.detect_frames(images)
        total_elapsed = time.perf_counter() - t_item

        data = frames_to_json(all_frames, total_elapsed, self.ckpt_version)
        if data is None:
            return None
        with open(json_path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2, ensure_ascii=False)

        if max_faces_frame is not None and max_faces_frame[1]["num_faces"]:
            from face_detection_multi_scale_tpu_torch.utils.plotting import (
                draw_detection)

            img, faces = max_faces_frame
            max_faces_count = faces["num_faces"]
            vis = img.copy()
            for bbox, conf in zip(faces["bboxes"], faces["confidence"]):
                draw_detection(vis, bbox, conf, 0, f"{conf:.2f}")
            out = os.path.join(
                self.max_faces_dir,
                f"{item_id}_max_{max_faces_count}_faces.jpg")
            cv2.imwrite(out, vis, [cv2.IMWRITE_JPEG_QUALITY, 95])

        total_faces = sum(f["num_faces"] for f in all_frames)
        return (item_id, len(all_frames), total_faces, total_elapsed)

    # ------------------------------------------------------------------

    def check_progress(self, items: Sequence[Tuple]) -> Dict[str, List]:
        """Classify items into done / partial / missing
        (yolov7_face_multi_scale_dataframe_predict.py:902-999)."""
        done, partial, missing = [], [], []
        for item_id, base_path in items:
            json_path = os.path.join(self.json_dir, f"{item_id}.json")
            imgs = glob.glob(os.path.join(self.max_faces_dir,
                                          f"{item_id}_max_*.jpg"))
            has_json = (os.path.exists(json_path)
                        and read_existing_json(json_path) is not None)
            if has_json and imgs:
                done.append(item_id)
            elif has_json or imgs:
                partial.append(item_id)
            else:
                missing.append(item_id)
        return {"done": done, "partial": partial, "missing": missing}

    def run(self, items: Sequence[Tuple], skip_processed: bool = True,
            shard: bool = True, progress_interval: int = 10):
        """Process a list of (item_id, base_path); a run of several
        processes (`torch.distributed` initialized) shards items by rank."""
        rank, world = shard_of_process()
        if shard and world > 1:
            items = items[rank::world]
        results = []
        t0 = time.time()
        for i, (item_id, base_path) in enumerate(items):
            r = self.process_item(item_id, base_path, skip_processed)
            if r is not None:
                results.append(r)
            if (i + 1) % progress_interval == 0:
                rate = (i + 1) / (time.time() - t0)
                print(f"[{i + 1}/{len(items)}] {rate:.2f} items/s")
        trunc = getattr(self.detector, "truncation_report", lambda: None)()
        if trunc and trunc["truncated_images"]:
            print(f"WARNING: candidate truncation on "
                  f"{trunc['truncated_images']}/{trunc['images']} frames "
                  f"(max gated {trunc['max_gated']} > cap "
                  f"{trunc['max_candidates']}, {trunc['dropped_total']} "
                  f"dropped) — raise max_candidates to recover recall")
        return results


def analyze_results(df) -> Dict:
    """Aggregate detection stats for reporting
    (yolov7_face_multi_scale_dataframe_predict.py:315-424)."""
    if len(df) == 0:
        return {"total_faces": 0, "total_images": 0}
    sizes = df["area"].to_numpy(float)
    return {
        "total_faces": int(len(df)),
        "total_images": int(df["image_path"].nunique()),
        "faces_per_image": float(len(df) / max(df["image_path"].nunique(), 1)),
        "avg_confidence": float(df["confidence"].mean()),
        "min_confidence": float(df["confidence"].min()),
        "max_confidence": float(df["confidence"].max()),
        "small_faces": int((sizes < 1024).sum()),
        "medium_faces": int(((sizes >= 1024) & (sizes <= 16384)).sum()),
        "large_faces": int((sizes > 16384).sum()),
        "scale_distribution": df["scale_used"].astype(str)
        .value_counts().to_dict(),
    }


def generate_report(analysis: Dict, path: str):
    """Markdown detection report."""
    lines = ["# Face Detection Report", ""]
    for key, val in analysis.items():
        if isinstance(val, dict):
            lines.append(f"## {key}")
            for k, v in val.items():
                lines.append(f"- {k}: {v}")
        else:
            lines.append(f"- **{key}**: {val}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def compare_json_shapes(dir_a: str, dir_b: str) -> Dict:
    """Regression diff of two JSON output dirs by the yolo-face-bboxes
    frame count (the compare_json_shapes.py tool, reference
    compare_json_shapes.py + comparison_report.txt)."""
    def shapes(d):
        out = {}
        for p in glob.glob(os.path.join(d, "*.json")):
            info = read_existing_json(p)
            if info is not None:
                out[os.path.basename(p)] = info[0]
        return out

    a, b = shapes(dir_a), shapes(dir_b)
    common = sorted(set(a) & set(b))
    mismatches = [(k, a[k], b[k]) for k in common if a[k] != b[k]]
    return {
        "total_a": len(a), "total_b": len(b), "common": len(common),
        "only_a": sorted(set(a) - set(b)),
        "only_b": sorted(set(b) - set(a)),
        "mismatches": mismatches,
        "match": len(common) - len(mismatches),
    }
