"""WIDER FACE annotation parsing + dataset statistics (a copy of the JAX
package's data/widerface_annotations.py; PIL is imported inside
`annotations_to_labels`, the one function that needs it).

Re-implementation of the reference browser/statistics tooling
(reference visualize_widerface.py:25-66 `load_annotations` for the
10-field `wider_face_*_bbx_gt.txt` format, :69-203 statistics by
size/blur/occlusion buckets) and the label-conversion one-off
(reference data/test.py:10-20: widerface val txts -> 5-kpt training label
rows with occlusion=2 sentinel).
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, List


# 10-field annotation row: x y w h blur expression illumination invalid
# occlusion pose
FIELDS = ("blur", "expression", "illumination", "invalid", "occlusion",
          "pose")


def load_annotations(annot_file: str) -> Dict[str, List[dict]]:
    """Parse wider_face_{train,val}_bbx_gt.txt: image path line, count
    line, then per-face rows (visualize_widerface.py:25-66)."""
    annotations: Dict[str, List[dict]] = {}
    with open(annot_file, encoding="utf-8") as f:
        while True:
            line = f.readline()
            if not line:
                break
            line = line.strip()
            if not line.endswith(".jpg"):
                continue
            image_path = line
            annotations[image_path] = []
            num_faces = int(f.readline().strip())
            if num_faces == 0:
                f.readline()  # the all-zeros row
                continue
            for _ in range(num_faces):
                parts = f.readline().split()
                if len(parts) < 4:
                    continue
                vals = list(map(int, parts))
                face = {"bbox": vals[:4]}
                for i, name in enumerate(FIELDS):
                    face[name] = vals[4 + i] if len(vals) > 4 + i else 0
                annotations[image_path].append(face)
    return annotations


def size_bucket(w: int, h: int) -> str:
    area = w * h
    if area < 32 * 32:
        return "small"
    if area <= 128 * 128:
        return "medium"
    return "large"


def dataset_statistics(annotations: Dict[str, List[dict]]) -> Dict:
    """Aggregate counts by event, size, blur, occlusion, validity
    (visualize_widerface.py:69-203)."""
    stats = {
        "images": len(annotations),
        "faces": 0,
        "events": Counter(),
        "size": Counter(),
        "blur": Counter(),
        "occlusion": Counter(),
        "invalid": 0,
    }
    for path, faces in annotations.items():
        event = path.split("/")[0]
        stats["events"][event] += len(faces)
        for face in faces:
            stats["faces"] += 1
            x, y, w, h = face["bbox"]
            stats["size"][size_bucket(w, h)] += 1
            stats["blur"][face["blur"]] += 1
            stats["occlusion"][face["occlusion"]] += 1
            stats["invalid"] += face["invalid"]
    stats["events"] = dict(stats["events"])
    stats["size"] = dict(stats["size"])
    stats["blur"] = dict(stats["blur"])
    stats["occlusion"] = dict(stats["occlusion"])
    return stats


def annotations_to_labels(annotations: Dict[str, List[dict]],
                          images_root: str, labels_root: str,
                          nkpt: int = 5, skip_invalid: bool = False):
    """Write training label txts from parsed annotations: normalized
    `cls x y w h` plus nkpt zero landmarks with occlusion=2 sentinel
    columns (the data/test.py:10-20 conversion generalized)."""
    from PIL import Image

    written = 0
    for path, faces in annotations.items():
        img_path = os.path.join(images_root, path)
        if not os.path.exists(img_path):
            continue
        with Image.open(img_path) as im:
            w_img, h_img = im.size
        rows = []
        for face in faces:
            if skip_invalid and face["invalid"]:
                continue
            x, y, w, h = face["bbox"]
            if w <= 0 or h <= 0:
                continue
            cx = min(max((x + w / 2) / w_img, 0.0), 1.0)
            cy = min(max((y + h / 2) / h_img, 0.0), 1.0)
            nw = min(w / w_img, 1.0)
            nh = min(h / h_img, 1.0)
            row = [0, cx, cy, nw, nh] + [0.0, 0.0, 2.0] * nkpt
            rows.append(row)
        out = os.path.join(labels_root, os.path.splitext(path)[0] + ".txt")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            for row in rows:
                f.write(" ".join(
                    str(int(v)) if i == 0 else f"{v:.6f}"
                    for i, v in enumerate(row)) + "\n")
        written += 1
    return written
