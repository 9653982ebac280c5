"""Synthetic learnable face dataset generator (a copy of the JAX
package's data/synthetic.py).

Draws cartoon faces (skin-tone ellipse, two eyes, nose, mouth) with exact
box + 5-landmark labels on noisy backgrounds. The reference repo has no
equivalent — it relies on WIDER FACE — but in an egress-free environment
this provides an end-to-end learnability check: a fresh model trained on
these images must reach nontrivial held-out mAP, exercising dataset,
augmentation, target assignment, loss, optimizer, EMA, and the mAP
protocol together (see tests/test_training_learns.py and the round-1
training runs).
"""

from __future__ import annotations

import shutil
from pathlib import Path
import numpy as np


def make_synthetic_face_dataset(root: str, n_images: int = 64,
                                img_size: int = 128,
                                val_fraction: float = 0.125,
                                seed: int = 7,
                                clean: bool = True) -> str:
    """Create train/val splits under `root` in the WIDER directory layout
    (images/<event>/x.jpg + labels/<event>/x.txt, 5-landmark rows with
    occlusion sentinel columns). Returns the path to a data yaml."""
    import cv2
    import yaml

    rng = np.random.default_rng(seed)
    rootp = Path(root)
    if clean and rootp.exists():
        shutil.rmtree(rootp)
    n_val = max(int(n_images * val_fraction), 1)
    for i in range(n_images):
        h = w = img_size
        img = rng.integers(0, 90, (h, w, 3), np.uint8)
        rows = []
        for _ in range(int(rng.integers(1, 4))):
            fw = int(rng.integers(img_size // 5, img_size // 3))
            fh = int(fw * rng.uniform(1.1, 1.4))
            cx = int(rng.integers(fw // 2 + 2, w - fw // 2 - 2))
            cy = int(rng.integers(fh // 2 + 2, h - fh // 2 - 2))
            color = tuple(int(v) for v in (rng.integers(150, 220),
                                           rng.integers(140, 200),
                                           rng.integers(170, 240)))
            cv2.ellipse(img, (cx, cy), (fw // 2, fh // 2), 0, 0, 360,
                        color, -1)
            ex, ey = fw // 5, fh // 6
            le, re = (cx - ex, cy - ey), (cx + ex, cy - ey)
            nose = (cx, cy + fh // 12)
            lm = (cx - ex // 2, cy + fh // 4)
            rm = (cx + ex // 2, cy + fh // 4)
            for p in (le, re):
                cv2.circle(img, p, max(fw // 12, 1), (30, 30, 30), -1)
            cv2.circle(img, nose, max(fw // 16, 1), (90, 60, 60), -1)
            cv2.line(img, lm, rm, (40, 20, 20), max(fw // 16, 1))
            kpts = []
            for (px, py) in (le, re, nose, lm, rm):
                kpts += [px / w, py / h, 2.0]
            rows.append([0, cx / w, cy / h, fw / w, fh / h] + kpts)
        split = "val" if i >= n_images - n_val else "train"
        img_dir = rootp / split / "images" / "0--Syn"
        lbl_dir = rootp / split / "labels" / "0--Syn"
        img_dir.mkdir(parents=True, exist_ok=True)
        lbl_dir.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(img_dir / f"s{i}.jpg"), img)
        with open(lbl_dir / f"s{i}.txt", "w") as f:
            for r in rows:
                f.write(" ".join(f"{v:.6f}" for v in r) + "\n")

    yaml_path = rootp / "data.yaml"
    with open(yaml_path, "w") as f:
        yaml.safe_dump({"train": str(rootp / "train" / "images"),
                        "val": str(rootp / "val" / "images"),
                        "nc": 1, "names": ["face"]}, f)
    return str(yaml_path)
