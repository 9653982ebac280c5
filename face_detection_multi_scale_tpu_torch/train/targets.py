"""Host-side target assignment for the detection loss (a numpy copy of
the JAX package's train/targets.py, on the port's ModelSpec).

The reference `build_targets` (reference utils/loss.py:205-268) split in
two: anchor matching is independent of the network's predictions
(wh-ratio filter + 3-cell neighbor offsets), so it runs on the host in
numpy per batch and emits FIXED-CAPACITY padded arrays per level. The
device-side loss (train/loss.py) is then pure gathers and elementwise
math on tensors of fixed shapes.

Semantics mirrored exactly:
  * per-anchor wh ratio max(r, 1/r).max() < anchor_t   (utils/loss.py:233-236)
  * center-cell + 2 nearest neighbor cells, g=0.5 bias (utils/loss.py:216-245)
  * grid-relative boxes (gxy - gij, gwh)               (utils/loss.py:259)
  * keypoint targets shifted by gij where nonzero      (utils/loss.py:261-264)
  * gj/gi clamped to the grid                          (utils/loss.py:258)
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Sequence, Tuple

import numpy as np

from face_detection_multi_scale_tpu_torch.models.spec import ModelSpec

_OFF = np.array([[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1]], np.float32) * 0.5


@dataclasses.dataclass
class LevelTargets:
    """Fixed-capacity targets for one pyramid level.

    All arrays have leading dim `cap`; `mask` marks real rows.
    """
    b: np.ndarray        # (cap,) image index
    a: np.ndarray        # (cap,) anchor index
    gj: np.ndarray       # (cap,) grid row
    gi: np.ndarray       # (cap,) grid col
    tbox: np.ndarray     # (cap, 4) grid-relative (dx, dy, w, h)
    tkpt: np.ndarray     # (cap, 2*nkpt) grid-relative keypoints
    tcls: np.ndarray     # (cap,) class index
    anchors: np.ndarray  # (cap, 2) matched anchor wh in grid units
    mask: np.ndarray     # (cap,) bool


def build_targets(labels: np.ndarray, spec: ModelSpec,
                  grid_shapes: Sequence[Tuple[int, int]],
                  anchor_t: float = 4.0,
                  cap: int = 0) -> List[LevelTargets]:
    """labels: (n, 6 + 2*nkpt) rows [img_idx, cls, x, y, w, h, kpt_xy...]
    normalized to [0, 1]; grid_shapes: per-level (ny, nx).

    Returns one LevelTargets per level, padded/truncated to `cap` rows
    (default: 5 * na * n rounded up to a bucket, so jit retraces rarely).
    """
    nkpt = spec.nkpt
    na = spec.na
    n = labels.shape[0]
    want_cols = 6 + 2 * nkpt
    if labels.size and labels.shape[1] != want_cols:
        raise ValueError(f"labels must have {want_cols} cols, got "
                         f"{labels.shape[1]}")
    if cap <= 0:
        cap = _bucket(5 * na * max(n, 1))

    out: List[LevelTargets] = []
    # anchors in grid units per level (reference divides by stride,
    # models/yolo.py:346)
    for lvl, (ny, nx) in enumerate(grid_shapes):
        anchors = (np.asarray(spec.anchors[lvl], np.float32).reshape(-1, 2)
                   / float(spec.strides[lvl]))
        if n:
            # scale normalized labels to this grid
            t = np.tile(labels[None, :, :], (na, 1, 1)).astype(np.float32)
            gain = np.ones(want_cols, np.float32)
            gain[2:6] = [nx, ny, nx, ny]
            if nkpt:
                gain[6:6 + 2 * nkpt] = [nx, ny] * nkpt
            t = t * gain
            ai = np.tile(np.arange(na, dtype=np.float32)[:, None], (1, n))
            t = np.concatenate([t, ai[..., None]], axis=2)  # (na, n, C+1)

            r = t[:, :, 4:6] / anchors[:, None, :]
            keep = np.maximum(r, 1.0 / r).max(axis=2) < anchor_t
            t = t[keep]  # (m, C+1)

            if len(t):
                gxy = t[:, 2:4]
                gxi = np.array([nx, ny], np.float32) - gxy
                j, k = ((gxy % 1.0 < 0.5) & (gxy > 1.0)).T
                l, m = ((gxi % 1.0 < 0.5) & (gxi > 1.0)).T
                sel = np.stack([np.ones_like(j), j, k, l, m])
                t = np.tile(t[None], (5, 1, 1))[sel]
                offsets = (np.zeros_like(gxy)[None] + _OFF[:, None])[sel]
            else:
                offsets = np.zeros((0, 2), np.float32)

            b = t[:, 0].astype(np.int32)
            c = t[:, 1].astype(np.int32)
            gxy = t[:, 2:4]
            gwh = t[:, 4:6]
            gij = (gxy - offsets).astype(np.int64)
            gi = np.clip(gij[:, 0], 0, nx - 1).astype(np.int32)
            gj = np.clip(gij[:, 1], 0, ny - 1).astype(np.int32)
            a = t[:, -1].astype(np.int32)
            tbox = np.concatenate([gxy - gij.astype(np.float32), gwh], 1)
            if nkpt:
                tkpt = t[:, 6:6 + 2 * nkpt].copy()
                for kp in range(nkpt):
                    cols = slice(6 + 2 * kp, 6 + 2 * (kp + 1))
                    nz = t[:, cols] != 0
                    tk = t[:, cols] - gij.astype(np.float32) * nz
                    tkpt[:, 2 * kp:2 * kp + 2] = np.where(
                        nz, tk, 0.0)
            else:
                tkpt = np.zeros((len(t), 0), np.float32)
            anc = anchors[a]
        else:
            b = a = gj = gi = np.zeros((0,), np.int32)
            c = np.zeros((0,), np.int32)
            tbox = np.zeros((0, 4), np.float32)
            tkpt = np.zeros((0, 2 * nkpt), np.float32)
            anc = np.zeros((0, 2), np.float32)

        m = len(b)
        if m > cap:
            warnings.warn(
                f"build_targets: truncating {m - cap} of {m} target rows "
                f"at level {lvl} (cap={cap}); dense scenes lose "
                f"supervision — raise the cap", stacklevel=2)
            b, a, gj, gi = b[:cap], a[:cap], gj[:cap], gi[:cap]
            tbox, tkpt, c, anc = tbox[:cap], tkpt[:cap], c[:cap], anc[:cap]
            m = cap

        def pad(x, fill=0):
            shape = (cap,) + x.shape[1:]
            padded = np.full(shape, fill, x.dtype)
            padded[:m] = x
            return padded

        mask = np.zeros(cap, bool)
        mask[:m] = True
        out.append(LevelTargets(
            b=pad(b), a=pad(a), gj=pad(gj), gi=pad(gi),
            tbox=pad(tbox), tkpt=pad(tkpt), tcls=pad(c),
            anchors=pad(anc), mask=mask))
    return out


def build_targets_batched(labels: np.ndarray, batch_size: int,
                          spec: ModelSpec,
                          grid_shapes: Sequence[Tuple[int, int]],
                          anchor_t: float = 4.0,
                          cap_per_image: int | None = None
                          ) -> Dict[str, tuple]:
    """Per-image fixed-capacity targets, stacked to (B, cap, ...) arrays.

    This is the SPMD-friendly layout: every array's leading dim is the
    batch, so a data-parallel mesh shards targets alongside images and the
    loss gathers stay shard-local (no cross-device indexing).

    `cap_per_image=None` (default) sizes the capacity from the densest
    image in the batch: each label contributes at most 3 cells x na
    anchors per level (center + <=2 neighbors, utils/loss.py:216-245), so
    `_bucket(3 * na * max_labels)` is a lossless upper bound — crowded
    WIDER/mosaic images never silently lose supervision (the reference
    build_targets has no cap). Bucketing keeps the jit shape set small.
    An explicit cap is honored but truncation now warns (see
    build_targets).
    """
    if cap_per_image is None:
        if len(labels):
            counts = np.bincount(labels[:, 0].astype(np.int64),
                                 minlength=batch_size)
            max_n = max(int(counts.max()), 1)
        else:
            max_n = 1
        cap_per_image = _bucket(3 * spec.na * max_n, quantum=128)
    per_level_stacks: List[List[LevelTargets]] = [[] for _ in grid_shapes]
    for b in range(batch_size):
        rows = labels[labels[:, 0] == b] if len(labels) else labels
        rows = np.array(rows, np.float32)
        if len(rows):
            rows = rows.copy()
            rows[:, 0] = 0
        levels = build_targets(rows, spec, grid_shapes, anchor_t,
                               cap=cap_per_image)
        for i, lt in enumerate(levels):
            per_level_stacks[i].append(lt)

    def stack(field):
        return tuple(
            np.stack([getattr(lt, field) for lt in lvl])
            for lvl in per_level_stacks)

    return {
        "a": stack("a"), "gj": stack("gj"), "gi": stack("gi"),
        "tbox": stack("tbox"), "tkpt": stack("tkpt"), "tcls": stack("tcls"),
        "anchors": stack("anchors"), "mask": stack("mask"),
    }


def _bucket(n: int, quantum: int = 256) -> int:
    """Round capacity up to a quantum so jit sees few distinct shapes."""
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


def targets_to_arrays(levels: Sequence[LevelTargets]) -> Dict[str, tuple]:
    """Pack per-level targets into a pytree of stacked tuples for jit."""
    return {
        "b": tuple(t.b for t in levels),
        "a": tuple(t.a for t in levels),
        "gj": tuple(t.gj for t in levels),
        "gi": tuple(t.gi for t in levels),
        "tbox": tuple(t.tbox for t in levels),
        "tkpt": tuple(t.tkpt for t in levels),
        "tcls": tuple(t.tcls for t in levels),
        "anchors": tuple(t.anchors for t in levels),
        "mask": tuple(t.mask for t in levels),
    }
