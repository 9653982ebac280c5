"""The comparison that decides `correct`: what the timed path served,
against the plain reference on the same inputs, weights and gate.

Rows are [x1, y1, x2, y2, conf, cls, landmarks...] in input pixels. The
distance of two rows is the largest of their coordinate gaps (px) and
100 times their conf gaps. The numbers:

- `conf_gap`, `box_gap`, `box_rel_gap`, `kpt_gap`: the forward and the
  decode. Each served row is matched to the nearest of the reference's
  rows of conf at least 0.9 of the gate (before the NMS), and the widest
  over every served row is taken of: |conf - the reference's|; the
  largest box coordinate gap (px); that gap over the reference box's side
  (its width for x, its height for y) plus BOX_PAD px; the largest
  landmark coordinate gap (px);
- `n_gated_gap`: the gate, over every judged image, the sum of
  |the program's n_gated - the reference's| over the sum of the
  reference's;
- `keep_gap`: the postprocess's choice of rows. A reference keeper is
  missed, and a served row is extra, when the nearest row of the other
  side is another row: a box coordinate off by more than KEEP_REL of the
  side (plus BOX_PAD px), or conf off by more than KEEP_CONF; the missed
  and the extra rows over the keepers of both sides, over every judged
  image;
- `keep_overlaps`: pairs of rows served for one image whose IoU exceeds
  the NMS threshold by more than OVERLAP_MARGIN: greedy keepers never
  overlap above it, so the reference and its control read 0;
- `empty_answers`: images served no row where the reference keeps
  MIN_KEPT rows or more.

A cell's limits file (`limits/<cell>.json`) says which of them it
compares: those that its control reads well above its sound runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.reference import postprocess as RP

CONF_PX = 100.0   # a conf gap of 0.01 weighs as a pixel
BOX_PAD = 16.0    # px added to a box's side before a gap is taken over it
KEEP_REL = 0.05   # box coordinate gaps, over the side + BOX_PAD, of one row
KEEP_CONF = 0.02  # conf gap of one row
OVERLAP_MARGIN = 1e-3  # IoU over the threshold that is no rounding
MIN_KEPT = 10     # reference keepers that make an empty answer a fault


def served_form(rows: torch.Tensor) -> torch.Tensor:
    """Decoded rows (N, 6 + E) -> [x1, y1, x2, y2, conf, cls, E...]."""
    return torch.cat([RP.xywh2xyxy(rows[:, :4]),
                      (rows[:, 4] * rows[:, 5])[:, None],
                      torch.zeros_like(rows[:, :1]), rows[:, 6:]], 1)


def _weights(width: int, device) -> torch.Tensor:
    w = torch.ones(width, device=device)
    w[4], w[5] = CONF_PX, 0.0
    w[8::3] = CONF_PX  # landmark confs
    return w


def nearest(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The index of each row of `a`'s nearest row of `b` (`b` not empty)."""
    w = _weights(a.shape[1], a.device)
    ids = []
    step = max(1, 2 ** 24 // (len(b) * a.shape[1]))
    for lo in range(0, len(a), step):
        ids.append(((a[lo:lo + step, None, :] - b[None]).abs() * w
                    ).amax(-1).argmin(1))
    return torch.cat(ids) if ids else torch.zeros(0, dtype=torch.long,
                                                  device=a.device)


def _served_gaps(p: torch.Tensor, near: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """Each served row against the reference row at its anchor: the box,
    relative box, conf and landmark coordinate gaps."""
    if not len(p) or not len(near):
        return {}
    m = near[nearest(p, near)]
    d = (p - m).abs()
    side = torch.stack([m[:, 2] - m[:, 0], m[:, 3] - m[:, 1]] * 2, 1
                       ).clamp(min=0) + BOX_PAD
    out = {"box": d[:, :4].amax(1), "box_rel": (d[:, :4] / side).amax(1),
           "conf": d[:, 4]}
    if p.shape[1] > 6:
        xy = [c for c in range(6, p.shape[1]) if (c - 6) % 3 != 2]
        out["kpt"] = d[:, xy].amax(1)
    return out


def _unmatched(a: torch.Tensor, b: torch.Tensor) -> int:
    """Rows of `a` that are no row of `b`: the nearest row of `b` lies
    farther than KEEP_REL of the box's side (plus BOX_PAD px) in a box
    coordinate, or KEEP_CONF in conf."""
    if not len(a):
        return 0
    if not len(b):
        return len(a)
    m = b[nearest(a, b)]
    side = torch.stack([a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]] * 2, 1
                       ).clamp(min=0) + BOX_PAD
    off = (((a[:, :4] - m[:, :4]).abs() / side).amax(1) > KEEP_REL) | (
        (a[:, 4] - m[:, 4]).abs() > KEEP_CONF)
    return int(off.sum())


def judge_images(served: Sequence[np.ndarray], n_gated: np.ndarray,
                 ref_rows: torch.Tensor, post: List[Dict], gate: float,
                 iou_thres: float) -> Dict[str, list]:
    """One network call: each image's served rows and gated count against
    the reference's decoded rows (B, N, no) and its postprocess."""
    out: Dict[str, list] = {}

    def add(k, v):
        out.setdefault(k, []).append(torch.as_tensor(v).float().reshape(-1))

    for b, rows in enumerate(served):
        p = torch.as_tensor(rows, dtype=torch.float32, device=ref_rows.device)
        cand = served_form(ref_rows[b])
        for k, v in _served_gaps(p, cand[cand[:, 4] >= 0.9 * gate]).items():
            add(k, v)
        keepers = torch.as_tensor(post[b]["rows"], dtype=torch.float32,
                                  device=p.device)
        add("keep_off", _unmatched(keepers, p) + _unmatched(p, keepers))
        add("keep_n", len(keepers) + len(p))
        add("gated_off", abs(int(n_gated[b]) - post[b]["n_gated"]))
        add("gated_n", post[b]["n_gated"])
        iou = RP.box_iou(p[:, :4], p[:, :4]).triu(1)
        add("overlaps", int((iou > iou_thres + OVERLAP_MARGIN).sum()))
        add("empty", float(not len(rows) and len(keepers) >= MIN_KEPT))
    return out


def summarize(parts: List[Dict[str, list]]) -> Dict[str, float]:
    """The cell's numbers over every judged call."""
    keys = ("box", "box_rel", "conf", "kpt", "empty", "keep_off", "keep_n",
            "gated_off", "gated_n", "overlaps")
    cat = {k: torch.cat([t.cpu() for p in parts for t in p.get(k, [])]
                        or [torch.zeros(0)]) for k in keys}

    def widest(k):
        return float(cat[k].max()) if len(cat[k]) else 0.0

    def share(k):
        return float(cat[k + "_off"].sum() / cat[k + "_n"].sum().clamp(min=1))

    out = {"box_gap": widest("box"), "box_rel_gap": widest("box_rel"),
           "conf_gap": widest("conf"), "n_gated_gap": share("gated"),
           "keep_gap": share("keep"),
           "keep_overlaps": float(cat["overlaps"].sum()),
           "empty_answers": float(cat["empty"].sum())}
    if len(cat["kpt"]):
        out["kpt_gap"] = widest("kpt")
    return out


def limit_checks(numbers: Dict[str, float], limits: Optional[Dict]):
    """(correct, {name: {"value", "limit"}}): each number the cell compares
    against its limit; without a limits file nothing is correct."""
    if limits is None:
        return False, {k: {"value": v, "limit": None}
                       for k, v in numbers.items()}
    checks = {k: {"value": numbers[k], "limit": lim["limit"]}
              for k, lim in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
