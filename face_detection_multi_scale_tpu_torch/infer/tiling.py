"""Tiled execution of giant pyramid scales.

A copy of the JAX package's infer/tiling.py, with the seam dedup's keep
mask on a chosen device. The TTA pyramid's top scale (3840 px, reference
multi_scale_face_detector.py:33) is one batch-1 giant-spatial forward;
this module turns that S x S scale into a g x g batch of halo'd tiles:

    plan = plan_tiles(3840, grid=2, halo=256, stride=64)
    tiles = extract_tiles(letterboxed, plan)      # (4, 2176, 2176, 3)
    dets  = detector.run_network(tiles)           # ONE engine call
    rows  = assemble_rows(rows_per_tile, plan)    # full-frame coords

Correctness contract (why this is safe on the TOP scale): every kept
detection's center lies >= halo px from any cropped tile edge (tile
ownership splits the overlap down the middle, and the overlap is
2 x halo), so each face sees >= halo px of true image context despite the
crop's zero padding. Faces wider than about 2 x halo in the scale frame
may be clipped at a seam; at the top scale those are LARGE faces, which
the lower pyramid scales detect and the scale-aware weighted merge
already owns. Near-duplicate detections from both sides of a seam are
removed by the same weighted-NMS merge, run over the assembled rows as a
single-scale group.

This is an approximation (detections near seams can differ from the
untiled forward by conv-context effects inside the halo); it is OFF by
default and enabled per detector with ``FaceDetector(tile_top_scale=2)``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from face_detection_multi_scale_tpu_torch.ops import nms as NMS
from face_detection_multi_scale_tpu_torch.utils.general import check_img_size


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Geometry of a g x g halo'd tiling of an S x S scale frame."""

    size: int              # S: the letterboxed scale side
    grid: int              # g: tiles per axis
    tile: int              # T: tile side (stride multiple, < S)
    origins: Tuple[int, ...]   # per-axis tile origins (len g, ascending)
    bounds: Tuple[int, ...]    # per-axis ownership boundaries (len g-1)

    @property
    def n_tiles(self) -> int:
        return self.grid * self.grid


def plan_tiles(size: int, grid: int = 2, halo: int = 256,
               stride: int = 64) -> TilePlan:
    """Plan a g x g tiling of an S x S frame with >= halo px of overlap
    context, the tile side rounded UP to a stride multiple.

    Ownership boundaries sit at the midpoint of each overlap, so a
    detection kept by its owning tile has >= overlap/2 >= halo px of real
    image context beyond its center in every direction that was
    cropped."""
    if grid < 2:
        raise ValueError("grid must be >= 2 (grid=1 is the untiled path)")
    if size % stride:
        raise ValueError(f"size {size} not a multiple of stride {stride}")
    tile = check_img_size(-(-size // grid) + halo, stride)  # ceil + round
    tile = min(tile, size)
    if grid * tile - size < (grid - 1) * 2 * halo:
        # the requested halo does not fit: tiles would overlap by less
        # than 2*halo somewhere. Grow the tile (still capped at S).
        tile = min(size, check_img_size(-(-size // grid) + 2 * halo,
                                        stride))
    if tile >= size:
        # g*g full-frame copies: g^2 x the untiled compute for nothing
        raise ValueError(
            f"halo {halo} too large for size {size} / grid {grid}: "
            f"tiles degenerate to the full frame — shrink halo or grid, "
            f"or run untiled")
    span = size - tile
    origins = tuple(round(i * span / (grid - 1)) for i in range(grid))
    bounds = tuple((origins[i] + tile + origins[i + 1]) // 2
                   for i in range(grid - 1))
    return TilePlan(size=size, grid=grid, tile=tile, origins=origins,
                    bounds=bounds)


def extract_tiles(frame: np.ndarray, plan: TilePlan) -> np.ndarray:
    """(S, S, C) frame -> (g*g, T, T, C) tile batch, row-major tiles."""
    if frame.shape[0] != plan.size or frame.shape[1] != plan.size:
        raise ValueError(f"frame {frame.shape[:2]} != plan size "
                         f"{plan.size}")
    t = plan.tile
    return np.stack([frame[oy:oy + t, ox:ox + t]
                     for oy in plan.origins for ox in plan.origins])


def owner_interval(plan: TilePlan, i: int) -> Tuple[int, int]:
    """Per-axis half-open ownership interval [lo, hi) of tile index i."""
    lo = 0 if i == 0 else plan.bounds[i - 1]
    hi = plan.size if i == plan.grid - 1 else plan.bounds[i]
    return lo, hi


def assemble_rows(rows_per_tile: Sequence[np.ndarray], plan: TilePlan,
                  iou_thres: float = 0.45, device="cuda") -> np.ndarray:
    """Tile-frame detection rows -> deduped full-frame rows.

    rows_per_tile: one (n_i, >=6) array [x1, y1, x2, y2, conf, cls, ...]
    per tile, row-major tile order, coordinates in the TILE frame.
    Offsets each tile's rows to the S x S frame, keeps a row only if its
    center lies in the tile's ownership cell, then removes seam
    near-duplicates with the weighted-NMS merge (single-scale group),
    whose keep mask runs on `device` (the kernel on the card); a frame
    whose tiles own no row makes no merge call."""
    kept: List[np.ndarray] = []
    for idx, rows in enumerate(rows_per_tile):
        if rows is None or len(rows) == 0:
            continue
        iy, ix = divmod(idx, plan.grid)
        rows = np.asarray(rows, np.float64).copy()
        rows[:, [0, 2]] += plan.origins[ix]
        rows[:, [1, 3]] += plan.origins[iy]
        if rows.shape[1] > 6:
            # landmark triplets (x, y, conf), reference row layout
            # utils/general.py:509
            rows[:, 6::3] += plan.origins[ix]
            rows[:, 7::3] += plan.origins[iy]
        cx = (rows[:, 0] + rows[:, 2]) / 2
        cy = (rows[:, 1] + rows[:, 3]) / 2
        x_lo, x_hi = owner_interval(plan, ix)
        y_lo, y_hi = owner_interval(plan, iy)
        own = ((cx >= x_lo) & (cx < x_hi) & (cy >= y_lo) & (cy < y_hi))
        if own.any():
            kept.append(rows[own])
    if not kept:
        return np.zeros((0, 6))
    merged = np.vstack(kept)
    # seam dedup: a single-scale weighted-NMS pass (scale_idx column 0)
    with_scale = np.hstack([merged[:, :6], np.zeros((len(merged), 1))])
    keep = NMS.weighted_nms_merge(with_scale, 1, iou_thres, device=device)
    return merged[keep]
