"""Anchor fitness check and k-means + genetic anchor evolution (a copy of
the JAX package's train/autoanchor.py, numpy and scipy).

The reference autoanchor (reference utils/autoanchor.py:11-58
check_anchor_order/check_anchors, :61-161 kmean_anchors): BPR computed
from the wh-ratio metric at threshold `anchor_t`, anchors recomputed
when BPR < 0.98 via whitened k-means then 1000-generation mutation
hill-climb. The anchors it returns go into the spec before the model is
built (cli/train.py).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from face_detection_multi_scale_tpu_torch.models.spec import ModelSpec


def check_anchor_order(anchors: np.ndarray,
                       strides: Sequence[int]) -> np.ndarray:
    """Flip the per-level anchor sets if their area order disagrees with
    the stride order (utils/autoanchor.py:11-19). anchors: (nl, na, 2)."""
    a = anchors.prod(-1).reshape(-1)
    da = a[-1] - a[0]
    ds = strides[-1] - strides[0]
    if np.sign(da) != np.sign(ds):
        return anchors[::-1].copy()
    return anchors


def _wh_metric(k: np.ndarray, wh: np.ndarray):
    r = wh[:, None, :] / k[None, :, :]
    x = np.minimum(r, 1.0 / r).min(2)
    return x, x.max(1)


def dataset_wh(labels, shapes: np.ndarray, img_size: int,
               scale_jitter: bool = False) -> np.ndarray:
    """Label wh in pixels after longest-side resize to img_size
    (utils/autoanchor.py:27-30)."""
    shapes = img_size * shapes / shapes.max(1, keepdims=True)
    if scale_jitter:
        shapes = shapes * np.random.uniform(0.9, 1.1,
                                            size=(shapes.shape[0], 1))
    whs = [l[:, 3:5] * s for s, l in zip(shapes, labels) if len(l)]
    return np.concatenate(whs) if whs else np.zeros((0, 2))


def check_anchors(labels, shapes: np.ndarray, spec: ModelSpec,
                  thr: float = 4.0, imgsz: int = 640,
                  verbose: bool = True) -> Tuple[np.ndarray, float]:
    """Analyze anchor fit; recompute when BPR < 0.98
    (utils/autoanchor.py:22-58). Returns (anchors (nl, na, 2) px, bpr)."""
    wh = dataset_wh(labels, shapes, imgsz, scale_jitter=True)
    anchors = np.asarray(spec.anchors, np.float64).reshape(spec.nl, -1, 2)
    flat = anchors.reshape(-1, 2)
    x, best = _wh_metric(flat, wh)
    aat = (x > 1.0 / thr).sum(1).mean()
    bpr = (best > 1.0 / thr).mean()
    if verbose:
        print(f"autoanchor: anchors/target = {aat:.2f}, "
              f"Best Possible Recall (BPR) = {bpr:.4f}")
    if bpr < 0.98:
        if verbose:
            print("autoanchor: recomputing anchors...")
        try:
            new = kmean_anchors(labels, shapes, n=flat.shape[0],
                                img_size=imgsz, thr=thr, gen=1000,
                                verbose=False)
            new_bpr = _wh_metric(new, wh)[1]
            new_bpr = (new_bpr > 1.0 / thr).mean()
            if new_bpr > bpr:
                anchors = check_anchor_order(
                    new.reshape(spec.nl, -1, 2), spec.strides)
                bpr = new_bpr
                if verbose:
                    print("autoanchor: new anchors adopted")
        except Exception as e:  # pragma: no cover
            print(f"autoanchor: ERROR {e}")
    return anchors, float(bpr)


def kmean_anchors(labels, shapes: np.ndarray, n: int = 9,
                  img_size: int = 640, thr: float = 4.0, gen: int = 1000,
                  verbose: bool = True) -> np.ndarray:
    """k-means anchors + genetic evolution (utils/autoanchor.py:61-161)."""
    from scipy.cluster.vq import kmeans

    inv_thr = 1.0 / thr
    wh0 = dataset_wh(labels, shapes, img_size)
    small = (wh0 < 3.0).any(1).sum()
    if small and verbose:
        print(f"autoanchor: WARNING {small}/{len(wh0)} labels < 3 px")
    wh = wh0[(wh0 >= 2.0).any(1)]

    s = wh.std(0)
    k, _ = kmeans(wh / s, n, iter=30)
    assert len(k) == n, f"kmeans returned {len(k)} != {n} anchors"
    k = k * s

    def fitness(kk):
        _, best = _wh_metric(kk, wh)
        return (best * (best > inv_thr)).mean()

    f = fitness(k)
    sh = k.shape
    mp, sigma = 0.9, 0.1
    npr = np.random
    for _ in range(gen):
        v = np.ones(sh)
        while (v == 1).all():
            v = ((npr.random(sh) < mp) * npr.random()
                 * npr.randn(*sh) * sigma + 1).clip(0.3, 3.0)
        kg = (k.copy() * v).clip(min=2.0)
        fg = fitness(kg)
        if fg > f:
            f, k = fg, kg.copy()
    k = k[np.argsort(k.prod(1))]
    if verbose:
        print("autoanchor:", ", ".join(
            f"{round(x[0])},{round(x[1])}" for x in k))
    return k
