"""Training-time plotting (a copy of the JAX package's
utils/train_plots.py): batch mosaics, label statistics, results
curves, evolution scatter.

Reference parity (utils/plots.py): plot_images batch mosaic with boxes +
landmark dots (:155-250), plot_labels (:253-300), plot_results curves
(:388-430), plot_evolution scatter (:340-360).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_images(images: np.ndarray, labels: np.ndarray, paths=None,
                fname: str = "train_batch.jpg", max_subplots: int = 16,
                nkpt: int = 5) -> str:
    """Batch mosaic with normalized-label boxes and landmarks drawn
    (utils/plots.py:155-250). images: (B, H, W, 3) uint8 RGB; labels:
    (N, 6+2*nkpt) rows [img_idx, cls, x, y, w, h, kpts...]."""
    import cv2

    from face_detection_multi_scale_tpu_torch.utils.plotting import color

    bs, h, w = images.shape[:3]
    bs = min(bs, max_subplots)
    ns = int(np.ceil(bs ** 0.5))
    mosaic = np.full((ns * h, ns * w, 3), 255, np.uint8)
    for i in range(bs):
        gy, gx = divmod(i, ns)
        tile = images[i][:, :, ::-1].copy()  # RGB -> BGR for cv2
        rows = labels[labels[:, 0] == i]
        for r in rows:
            cx, cy, bw, bh = r[2] * w, r[3] * h, r[4] * w, r[5] * h
            p1 = (int(cx - bw / 2), int(cy - bh / 2))
            p2 = (int(cx + bw / 2), int(cy + bh / 2))
            cv2.rectangle(tile, p1, p2, color(int(r[1])), 2)
            for kp in range(nkpt):
                kx, ky = r[6 + 2 * kp] * w, r[7 + 2 * kp] * h
                if kx > 0 or ky > 0:
                    cv2.circle(tile, (int(kx), int(ky)), 2, (0, 255, 0), -1)
        if paths is not None and i < len(paths):
            cv2.putText(tile, os.path.basename(paths[i])[:30], (5, 15),
                        0, 0.4, (20, 20, 20), 1)
        mosaic[gy * h:(gy + 1) * h, gx * w:(gx + 1) * w] = tile
    cv2.imwrite(fname, mosaic)
    return fname


def plot_labels(labels: Sequence[np.ndarray], save_dir: str = ".") -> str:
    """Label statistics panel: class histogram, box center/size densities
    (utils/plots.py:253-300). labels: per-image (n, 5+2k) arrays."""
    plt = _plt()

    all_rows = np.concatenate([l for l in labels if len(l)], 0)
    cls = all_rows[:, 0]
    boxes = all_rows[:, 1:5]
    fig, axes = plt.subplots(2, 2, figsize=(10, 10))
    axes[0, 0].hist(cls, bins=max(int(cls.max()) + 1, 1))
    axes[0, 0].set_title(f"classes ({len(all_rows)} labels)")
    axes[0, 1].hist2d(boxes[:, 0], boxes[:, 1], bins=50)
    axes[0, 1].set_title("xy centers")
    axes[1, 0].hist2d(boxes[:, 2], boxes[:, 3], bins=50)
    axes[1, 0].set_title("wh")
    axes[1, 1].hist(np.sqrt(boxes[:, 2] * boxes[:, 3]), bins=50)
    axes[1, 1].set_title("sqrt(area)")
    out = os.path.join(save_dir, "labels.png")
    fig.tight_layout()
    fig.savefig(out, dpi=100)
    plt.close(fig)
    return out


def plot_results(metrics_jsonl: str, save_path: Optional[str] = None) -> str:
    """Training curves from the MetricsLogger JSONL (the results.png
    analog, utils/plots.py:388-430)."""
    plt = _plt()

    rows: List[Dict] = []
    with open(metrics_jsonl) as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))
    keys = sorted({k for r in rows for k in r if k != "step"})
    n = len(keys)
    if n == 0:
        raise ValueError("no metrics found")
    ncols = min(4, n)
    nrows = math.ceil(n / ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 3 * nrows),
                             squeeze=False)
    for i, key in enumerate(keys):
        ax = axes[i // ncols][i % ncols]
        pts = [(r["step"], r[key]) for r in rows if key in r]
        ax.plot([p[0] for p in pts], [p[1] for p in pts], marker=".")
        ax.set_title(key, fontsize=9)
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    out = save_path or os.path.join(os.path.dirname(metrics_jsonl),
                                    "results.png")
    fig.tight_layout()
    fig.savefig(out, dpi=100)
    plt.close(fig)
    return out


def plot_evolution(ledger_path: str, save_path: Optional[str] = None) -> str:
    """Fitness-vs-hyp scatter per evolvable key from the evolve.txt
    ledger (utils/plots.py:340-360 analog)."""
    plt = _plt()

    from face_detection_multi_scale_tpu_torch.train.evolve import read_ledger

    entries = read_ledger(ledger_path)
    if not entries:
        raise ValueError(f"empty ledger {ledger_path}")
    keys = sorted(entries[0]["hyp"])
    fits = [e["fitness"] for e in entries]
    ncols = 5
    nrows = math.ceil(len(keys) / ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 2.5 * nrows),
                             squeeze=False)
    for i, key in enumerate(keys):
        ax = axes[i // ncols][i % ncols]
        xs = [e["hyp"].get(key, np.nan) for e in entries]
        ax.scatter(xs, fits, s=8)
        best = entries[int(np.argmax(fits))]["hyp"].get(key)
        ax.set_title(f"{key} = {best:.3g}" if best is not None else key,
                     fontsize=8)
    for j in range(len(keys), nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    out = save_path or os.path.splitext(ledger_path)[0] + "_evolution.png"
    fig.tight_layout()
    fig.savefig(out, dpi=100)
    plt.close(fig)
    return out
