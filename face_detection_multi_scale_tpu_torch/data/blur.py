"""Blur-robustness dataset generation (a copy of the JAX package's
data/blur.py; host code: OpenCV is imported inside the functions that
need it, so importing the module needs neither OpenCV nor a card).

Re-implementation of the reference blur tooling
(reference blur_dataset_generator.py: blur kernels :236-282, difficulty
category buckets :79-105, 30/50/20 easy/medium/hard sampling :296-320,
quality filter (faces >= 32x32) :129-147, blurred val set :17-52).
"""

from __future__ import annotations

import json
import random
import shutil
from pathlib import Path
from typing import Dict, List

import numpy as np

BLUR_LEVELS = {
    "light": [
        {"type": "gaussian", "strength": 3, "label": "Gaussian_Light"},
        {"type": "motion", "strength": 5, "label": "Motion_Light"},
        {"type": "radial", "strength": 2, "label": "Radial_Light"},
    ],
    "medium": [
        {"type": "gaussian", "strength": 7, "label": "Gaussian_Medium"},
        {"type": "motion", "strength": 12, "label": "Motion_Medium"},
        {"type": "radial", "strength": 4, "label": "Radial_Medium"},
    ],
    "heavy": [
        {"type": "gaussian", "strength": 12, "label": "Gaussian_Heavy"},
        {"type": "motion", "strength": 19, "label": "Motion_Heavy"},
        {"type": "radial", "strength": 6, "label": "Radial_Heavy"},
    ],
}

EASY_CATEGORIES = [
    "22--Picnic", "20--Family_Group", "50--Celebration_Or_Party",
    "21--Festival", "11--Meeting", "49--Greeting", "19--Couple",
]
MEDIUM_CATEGORIES = [
    "12--Group", "13--Interview", "29--Students_Schoolkids", "7--Cheering",
    "18--Concerts", "28--Sports_Fan", "23--Shoppers", "52--Photographers",
    "8--Election_Campain",
]
HARD_CATEGORIES = [
    "3--Riot", "5--Car_Accident", "14--Traffic", "61--Street_Battle",
    "53--Raid", "54--Rescue", "2--Demonstration", "4--Dancing",
    "24--Soldier_Firing", "34--Baseball",
]


def apply_blur(image: np.ndarray, blur_type: str = "gaussian",
               strength: float = 5) -> np.ndarray:
    """Gaussian / horizontal-motion / radial (zoom) blur
    (blur_dataset_generator.py:236-282)."""
    import cv2

    if blur_type == "gaussian":
        k = int(strength) * 2 + 1
        return cv2.GaussianBlur(image, (k, k), strength / 3)
    if blur_type == "motion":
        k = int(strength)
        if k % 2 == 0:
            k += 1
        kernel = np.zeros((k, k))
        kernel[(k - 1) // 2, :] = 1.0
        kernel /= k
        return cv2.filter2D(image, -1, kernel)
    if blur_type == "radial":
        h, w = image.shape[:2]
        cx, cy = w // 2, h // 2
        result = np.zeros_like(image, np.float64)
        layers = max(int(strength), 2)
        for i in range(layers):
            scale = 1.0 + i * 0.015
            m = cv2.getRotationMatrix2D((cx, cy), 0, scale)
            layer = cv2.warpAffine(image, m, (w, h))
            result = cv2.addWeighted(result, i / (i + 1),
                                     layer.astype(np.float64), 1 / (i + 1),
                                     0)
        return np.clip(result, 0, 255).astype(np.uint8)
    return cv2.GaussianBlur(image, (15, 15), strength / 5)


def has_quality_faces(label_rows: np.ndarray, img_w: int, img_h: int,
                      min_size: int = 32) -> int:
    """Count faces at least min_size x min_size px (the keep filter,
    blur_dataset_generator.py:129-147). label_rows: normalized YOLO."""
    if len(label_rows) == 0:
        return 0
    w = label_rows[:, 3] * img_w
    h = label_rows[:, 4] * img_h
    return int(((w >= min_size) & (h >= min_size)).sum())


class BlurDatasetGenerator:
    """Sample WIDER train by difficulty, blur, and emit images + labels +
    metadata (blur_dataset_generator.py:284-395)."""

    def __init__(self, wider_path: str, seed: int = 0):
        self.wider_path = Path(wider_path)
        self.images_dir = self.wider_path / "images"
        self.labels_dir = self.wider_path / "labels"
        self.rng = random.Random(seed)

    def _category_images(self, categories: List[str]):
        out = []
        for cat in categories:
            cat_dir = self.images_dir / cat
            if cat_dir.is_dir():
                out += sorted(cat_dir.glob("*.jpg"))
        return out

    def create_blur_dataset(self, total_images: int, output_dir: str,
                            min_face: int = 32) -> Dict:
        """30/50/20 easy/medium/hard sampling, one blur config per image,
        copied labels, metadata JSON."""
        import cv2

        targets = {
            "easy": int(total_images * 0.3),
            "medium": int(total_images * 0.5),
            "hard": int(total_images * 0.2),
        }
        buckets = {
            "easy": self._category_images(EASY_CATEGORIES),
            "medium": self._category_images(MEDIUM_CATEGORIES),
            "hard": self._category_images(HARD_CATEGORIES),
        }
        out_img = Path(output_dir) / "train" / "images"
        out_lbl = Path(output_dir) / "train" / "labels"
        out_img.mkdir(parents=True, exist_ok=True)
        out_lbl.mkdir(parents=True, exist_ok=True)

        metadata = []
        all_configs = [c for lvl in BLUR_LEVELS.values() for c in lvl]
        for difficulty, want in targets.items():
            candidates = list(buckets[difficulty])
            self.rng.shuffle(candidates)
            made = 0
            for img_file in candidates:
                if made >= want:
                    break
                image = cv2.imread(str(img_file))
                if image is None:
                    continue
                lbl = (self.labels_dir / img_file.parent.name /
                       f"{img_file.stem}.txt")
                if not lbl.exists():
                    continue
                rows = np.array(
                    [list(map(float, ln.split()))
                     for ln in lbl.read_text().strip().splitlines() or []])
                if rows.size == 0 or has_quality_faces(
                        rows, image.shape[1], image.shape[0],
                        min_face) == 0:
                    continue
                cfg = self.rng.choice(all_configs)
                blurred = apply_blur(image, cfg["type"], cfg["strength"])
                name = (f"{img_file.parent.name}_{img_file.stem}"
                        f"_{cfg['label']}")
                cv2.imwrite(str(out_img / f"{name}.jpg"), blurred)
                shutil.copy2(lbl, out_lbl / f"{name}.txt")
                metadata.append({
                    "source": str(img_file), "difficulty": difficulty,
                    "blur": cfg})
                made += 1
        meta_path = Path(output_dir) / "metadata.json"
        with open(meta_path, "w") as f:
            json.dump(metadata, f, indent=2)
        return {"total": len(metadata),
                "by_difficulty": {k: sum(1 for m in metadata
                                         if m["difficulty"] == k)
                                  for k in targets}}

    def create_blur_val(self, wider_val_path: str, output_dir: str,
                        blur_level: str = "medium") -> int:
        """Blur the whole val split with one randomly-chosen config
        (blur_dataset_generator.py:17-52)."""
        import cv2

        images_dir = Path(wider_val_path) / "images"
        labels_dir = Path(wider_val_path) / "labels"
        out_img = Path(output_dir) / "val" / "images"
        out_lbl = Path(output_dir) / "val" / "labels"
        out_img.mkdir(parents=True, exist_ok=True)
        out_lbl.mkdir(parents=True, exist_ok=True)
        cfg = self.rng.choice(BLUR_LEVELS.get(blur_level,
                                              BLUR_LEVELS["medium"]))
        count = 0
        for cat_dir in sorted(images_dir.iterdir()):
            if not cat_dir.is_dir():
                continue
            for img_file in sorted(cat_dir.glob("*.jpg")):
                image = cv2.imread(str(img_file))
                if image is None:
                    continue
                blurred = apply_blur(image, cfg["type"], cfg["strength"])
                name = f"{cat_dir.name}_{img_file.stem}_{cfg['label']}"
                if cv2.imwrite(str(out_img / f"{name}.jpg"), blurred):
                    lbl = labels_dir / cat_dir.name / f"{img_file.stem}.txt"
                    if lbl.exists():
                        shutil.copy2(lbl, out_lbl / f"{name}.txt")
                        count += 1
        return count
