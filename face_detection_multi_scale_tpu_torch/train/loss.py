"""Device-side detection loss: EIoU box + balanced objectness BCE +
class BCE + Wing landmark loss + landmark-visibility BCE.

The port's counterpart of the JAX package's train/loss.py, on the
fixed-capacity targets of train/targets.py: every gather has a static
shape, masked rows contribute exactly zero, and means divide by the true
(masked) counts, so padded capacity never changes the value. The input
is the train-mode raws of `YoloFace`, (bs, na, ny, nx, no) per level.

Loss formula parity (reference utils/loss.py):
  lbox  = mean(1 - EIoU(pred, target))                 (:160-163)
  lobj  = sum_l balance[l] * BCE(obj_logits, tobj)     (:188-189)
          with tobj = (1-gr) + gr * clamp(iou, 0)      (:176)
  lcls  = BCE with label smoothing, nc > 1 only        (:179-182)
  lkptv = BCE(kpt_score_logits, kpt_mask)              (:171)
  lkpt  = Wing(kpt_xy, target) averaged over the mask  (:164-173, :87-113)
  total = (box*lbox + obj*lobj + cls*lcls + cls*lkptv + kpt*lkpt) * bs

Duplicate target cells combine their objectness targets by max, the
JAX package's deterministic stand-in for the reference's in-order
overwrite (`scatter_reduce(..., "amax")` here).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from face_detection_multi_scale_tpu_torch.ops.boxes import bbox_iou

BALANCE_3 = (4.0, 1.0, 0.4)
BALANCE_P6 = (4.0, 1.0, 0.25, 0.06, 0.02)


def smooth_bce(eps: float = 0.1) -> Tuple[float, float]:
    """Positive/negative label-smoothing targets (utils/loss.py:10-12)."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def bce_with_logits(logits, targets, pos_weight=1.0):
    """Elementwise BCE-with-logits with positive weighting (matches
    torch.nn.BCEWithLogitsLoss(pos_weight) before reduction)."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def focal_scale(logits, targets, gamma: float, alpha: float = 0.25):
    """Focal-loss modulation factor (utils/loss.py:32-57, TF formulation)."""
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    alpha_t = targets * alpha + (1 - targets) * (1 - alpha)
    return alpha_t * (1.0 - p_t) ** gamma


def wing(diff, w: float = 10.0, e: float = 2.0):
    """Wing loss on |diff| (utils/loss.py:87-103)."""
    c = w - w * math.log(1 + w / e)
    ad = diff.abs()
    return torch.where(ad < w, w * torch.log(1 + ad / e), ad - c)


def targets_to_device(targets: Dict[str, tuple],
                      device) -> Dict[str, tuple]:
    """The numpy target arrays of train/targets.py (or tensors) as tensors
    on `device`: indices as int64, `mask` as float32, the rest float32."""
    def conv(key, x):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        if key == "mask":
            t = t.float()
        elif key in ("b", "a", "gj", "gi", "tcls"):
            t = t.long()
        else:
            t = t.float()
        return t.to(device, non_blocking=True)

    return {k: tuple(conv(k, x) for x in v) for k, v in targets.items()}


def _max_scatter(shape, index: Tuple[torch.Tensor, ...],
                 val: torch.Tensor) -> torch.Tensor:
    """zeros(shape) with val max-combined at the index tuple (the JAX
    `.at[index].max(val)`); val >= 0 and carries no gradient."""
    lin = index[0]
    for ix, n in zip(index[1:], shape[1:]):
        lin = lin * n + ix
    flat = val.new_zeros(math.prod(shape))
    flat.scatter_reduce_(0, lin.reshape(-1), val.reshape(-1), "amax")
    return flat.reshape(shape)


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """bf16 / f16 raws to float32 (the JAX loss's cast); float64 raws stay
    (a float64 model's loss, the exact reference of a float32 step)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _level_terms(pi, ps, index, mask, tbox, anchors, tkpt, tcls, hyp,
                 nc, nkpt, gr, balance, den=None):
    """One level's (lbox, lobj, lcls, lkpt, lkptv) from its raw map `pi`,
    the gathered rows `ps` (..., no), the gather's index tuple into
    pi.shape[:4] and the level's targets; shared by both loss layouts.
    `den` is None, or the global batch's (target rows, visible landmark
    coordinates, objectness cells) of this level under a data mesh: the
    means then divide this rank's sums by the global counts."""
    cp, cn = smooth_bce(hyp.get("label_smoothing", 0.0))
    fl_gamma = hyp.get("fl_gamma", 0.0)
    cls_pw = hyp.get("cls_pw", 1.0)
    obj_pw = hyp.get("obj_pw", 1.0)
    zero = pi.new_zeros(())
    n_rows = mask.sum() if den is None else den[0]
    denom = n_rows.clamp(min=1.0)

    pxy = torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5
    pwh = (torch.sigmoid(ps[..., 2:4]) * 2.0) ** 2 * anchors
    pbox = torch.cat([pxy, pwh], dim=-1)
    iou = bbox_iou(pbox, tbox, xywh=True, kind="eiou")
    lbox = ((1.0 - iou) * mask).sum() / denom

    lkpt = lkptv = zero
    if nkpt:
        pkpt_x = ps[..., 6::3] * 2.0 - 0.5
        pkpt_y = ps[..., 7::3] * 2.0 - 0.5
        pkpt_score = ps[..., 8::3]
        vis = (tkpt[..., 0::2] != 0).float()
        kpt_mask = vis * mask[..., None]
        v = bce_with_logits(pkpt_score, vis, cls_pw) * mask[..., None]
        lkptv = v.sum() / (n_rows * pkpt_score.shape[-1]).clamp(min=1.0)
        ksum = (kpt_mask.sum() if den is None else den[1]).clamp(min=1e-9)
        lx = wing((pkpt_x - tkpt[..., 0::2]) * kpt_mask).sum() / ksum
        ly = wing((pkpt_y - tkpt[..., 1::2]) * kpt_mask).sum() / ksum
        lkpt = (lx + ly) / 2.0

    val = ((1.0 - gr) + gr * iou.detach().clamp(min=0.0)) * mask
    tobj = _max_scatter(pi.shape[:4], index, val)
    obj_bce = bce_with_logits(pi[..., 4], tobj, obj_pw)
    if fl_gamma > 0:
        obj_bce = obj_bce * focal_scale(pi[..., 4], tobj, fl_gamma)
    lobj = (obj_bce.mean() if den is None
            else obj_bce.sum() / den[2]) * balance

    lcls = zero
    if nc > 1:
        t = cn + F.one_hot(tcls, nc).float() * (cp - cn)
        cls_bce = bce_with_logits(ps[..., 5:5 + nc], t, cls_pw)
        if fl_gamma > 0:
            cls_bce = cls_bce * focal_scale(ps[..., 5:5 + nc], t, fl_gamma)
        lcls = (cls_bce * mask[..., None]).sum() / (denom * nc)
    return lbox, lobj, lcls, lkpt, lkptv


def _total(sums, hyp, bs):
    lbox, lobj, lcls, lkpt, lkptv = sums
    lbox = lbox * hyp["box"]
    lobj = lobj * hyp["obj"]
    lcls = lcls * hyp["cls"]
    lkptv = lkptv * hyp["cls"]
    lkpt = lkpt * hyp["kpt"]
    total = lbox + lobj + lcls + lkpt + lkptv
    components = torch.stack([lbox, lobj, lcls, lkpt, lkptv, total])
    return total * bs, components


def compute_loss(raw_preds: Sequence[torch.Tensor],
                 targets: Dict[str, tuple], hyp: Dict[str, float], *,
                 nc: int, nkpt: int, gr: float = 1.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """raw_preds: per-level (bs, na, ny, nx, no) maps; targets: tensors of
    `targets_to_arrays` (flat rows with an image index "b"). Returns
    (loss * bs, components (lbox, lobj, lcls, lkpt, lkptv, total))."""
    nl = len(raw_preds)
    balance = BALANCE_3 if nl == 3 else BALANCE_P6
    sums = [raw_preds[0].new_zeros((), dtype=torch.float32)] * 5
    for i, pi in enumerate(raw_preds):
        pi = _at_least_f32(pi)
        index = (targets["b"][i], targets["a"][i], targets["gj"][i],
                 targets["gi"][i])
        terms = _level_terms(
            pi, pi[index], index, targets["mask"][i],
            targets["tbox"][i], targets["anchors"][i], targets["tkpt"][i],
            targets["tcls"][i], hyp, nc, nkpt, gr, balance[i])
        sums = [s + t for s, t in zip(sums, terms)]
    return _total(sums, hyp, raw_preds[0].shape[0])


def _global_counts(raw_preds, targets, nkpt: int, mesh):
    """Each level's (target rows, visible landmark coordinates,
    objectness cells) over the mesh's global batch: the two sums in one
    collective; the cells from the equal row counts of the ranks."""
    local = []
    for i in range(len(raw_preds)):
        mask = targets["mask"][i]
        local.append(mask.sum())
        local.append(((targets["tkpt"][i][..., 0::2] != 0).float()
                      * mask[..., None]).sum() if nkpt
                     else mask.new_zeros(()))
    sums = mesh.all_reduce(torch.stack(local).float())
    return [(sums[2 * i], sums[2 * i + 1],
             pi[..., 4].numel() * mesh.size)
            for i, pi in enumerate(raw_preds)]


def compute_loss_batched(raw_preds: Sequence[torch.Tensor],
                         targets: Dict[str, tuple],
                         hyp: Dict[str, float], *, nc: int, nkpt: int,
                         gr: float = 1.0, mesh=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loss on the (B, cap, ...) targets of `build_targets_batched`:
    each image gathers its own rows. Numerically the same as
    `compute_loss` (the same reference semantics).

    Under a data mesh (a parallel.mesh.DataMesh, as active_mesh gives it;
    `raw_preds` and `targets` are this rank's rows) only the counts cross
    the ranks, as the JAX package's sharded loss reduces only its final
    scalars: every mean divides this rank's sum by the global count, and
    the total is scaled by the global batch, so the ranks' losses and
    components sum to those of the global batch, and the sum of the
    ranks' gradients is the global batch's gradient."""
    nl = len(raw_preds)
    balance = BALANCE_3 if nl == 3 else BALANCE_P6
    bs = global_bs = raw_preds[0].shape[0]
    dens = [None] * nl
    if mesh is not None:
        dens = _global_counts(raw_preds, targets, nkpt, mesh)
        global_bs *= mesh.size
    sums = [raw_preds[0].new_zeros((), dtype=torch.float32)] * 5
    for i, pi in enumerate(raw_preds):
        pi = _at_least_f32(pi)
        a = targets["a"][i]  # (B, cap)
        b = torch.arange(bs, device=a.device)[:, None].expand_as(a)
        index = (b, a, targets["gj"][i], targets["gi"][i])
        terms = _level_terms(
            pi, pi[index], index, targets["mask"][i],
            targets["tbox"][i], targets["anchors"][i], targets["tkpt"][i],
            targets["tcls"][i], hyp, nc, nkpt, gr, balance[i], dens[i])
        sums = [s + t for s, t in zip(sums, terms)]
    return _total(sums, hyp, global_bs)
