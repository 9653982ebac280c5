"""Validation: P / R / mAP@.5 / mAP@.5:.95 over a dataset.

The port's counterpart of the JAX package's infer/validate.py, itself the
equivalent of the reference test.py `test()` (reference test.py:41-379):
batched forward + NMS at conf 0.001 / IoU 0.6, predictions rescaled to
native image space, greedy IoU-ladder matching, ap_per_class.

It takes the `YoloFace` module, whose weights live in it, where the JAX
function takes `(model, variables)`. There is no jit: the forward runs
eagerly on the module's device under `torch.inference_mode()`, in full
float32 (TF32 off) for a float32 module, and the keep mask of a batch on
the card is one `nms_keep` kernel launch.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from face_detection_multi_scale_tpu_torch.data.dataset import (
    DataLoader, FaceDataset)
from face_detection_multi_scale_tpu_torch.data.letterbox import scale_coords
from face_detection_multi_scale_tpu_torch.eval.metrics import (
    IOUV, ap_per_class, match_predictions)
from face_detection_multi_scale_tpu_torch.infer.augment import (
    forward_augment, forward_flip_test)
from face_detection_multi_scale_tpu_torch.models.head import decode
from face_detection_multi_scale_tpu_torch.models.model import (
    YoloFace, full_fp32)
from face_detection_multi_scale_tpu_torch.ops import nms as NMS
from face_detection_multi_scale_tpu_torch.utils.general import (
    _xywh2xyxy_np)

MAX_CANDIDATES = 4096  # the JAX validate's pre-NMS capacity


@torch.inference_mode()
def _engine(model: YoloFace, images_u8: np.ndarray, *, conf_thres: float,
            iou_thres: float, max_det: int, augment: bool,
            flip_test: bool) -> NMS.Detections:
    """uint8 NHWC batch -> Detections on the module's device (the JAX
    validate's jitted `run`)."""
    param = next(model.parameters())
    x = torch.as_tensor(images_u8).to(param.device).float() / 255.0
    x = x.to(param.dtype)
    if augment:
        preds = forward_augment(model, x)
    elif flip_test:
        preds = forward_flip_test(model, x)
    else:
        with full_fp32():
            preds = decode(model(x), model.spec)
    spec = model.spec
    return NMS.non_max_suppression(
        preds, conf_thres, iou_thres, nc=spec.nc, nkpt=spec.nkpt,
        max_candidates=MAX_CANDIDATES, max_det=max_det)


def validate(model: YoloFace, dataset: FaceDataset, *,
             batch_size: int = 32, conf_thres: float = 0.001,
             iou_thres: float = 0.6, max_det: int = 300,
             augment: bool = False, flip_test: bool = False,
             verbose: bool = True, save_dir=None, save_txt: bool = False,
             save_conf: bool = False, save_json: bool = False,
             weights_name: str = "", anno_json=None) -> Dict[str, float]:
    """Run the mAP protocol; labels come from the dataset (normalized to
    the letterboxed frame), predictions and GT are both mapped to native
    space before matching (test.py:172-279).

    Save formats (the reference test.py long tail):
    * save_txt: per-image normalized-xywh label files under
      <save_dir>/labels/ — `cls x y w h [conf]` (test.py:197-204).
    * save_json: COCO-format predictions <save_dir>/
      {weights_name}_predictions.json (test.py:225-239, 324-330) with
      keypoints when the model predicts landmarks. The reference ships
      with its 'bbox' field commented out (test.py:232) — broken for
      any COCO consumer — so the bbox IS written here. If `anno_json`
      exists and pycocotools is importable, the COCO eval runs
      (test.py:331-345); both are optional, matching the reference's
      try/except.
    """
    if save_dir is not None:
        save_dir = Path(save_dir)
        (save_dir / "labels" if save_txt else save_dir).mkdir(
            parents=True, exist_ok=True)
    jdict = []

    loader = DataLoader(dataset, batch_size, shuffle=False, drop_last=False)
    stats = []
    gated_counts = []
    t_infer = 0.0
    n_images = 0
    for images, labels, paths, shapes in loader:
        # (h_in, w_in) is the network input frame: the square img_size by
        # default, or the per-batch rect shape when the dataset was built
        # with rect=True
        h_in, w_in = images.shape[1:3]
        t0 = time.perf_counter()
        dets = _engine(model, images, conf_thres=conf_thres,
                       iou_thres=iou_thres, max_det=max_det,
                       augment=augment, flip_test=flip_test)
        rows_list = NMS.detections_to_numpy(dets)
        t_infer += time.perf_counter() - t0
        gated_counts.extend(dets.n_gated.cpu().numpy().tolist())
        for bi, rows in enumerate(rows_list):
            n_images += 1
            (h0, w0), ((rh, rw), pad) = shapes[bi]
            l = labels[labels[:, 0] == bi]
            tcls = l[:, 1]
            pred = rows[:, :6].astype(np.float64).copy()
            kpts = None
            if len(pred):
                scale_coords((h_in, w_in), pred[:, :4],
                             (h0, w0), ratio_pad=((rh, rw), pad))
                if rows.shape[1] > 6:
                    kpts = rows[:, 6:].astype(np.float64).copy()
                    scale_coords((h_in, w_in), kpts, (h0, w0),
                                 ratio_pad=((rh, rw), pad),
                                 kpt=True, step=3)
            if save_dir is not None and len(pred):
                stem = Path(paths[bi]).stem
                if save_txt:
                    # normalized xywh `cls x y w h [conf]`
                    # (test.py:198-204)
                    gn = np.array([w0, h0, w0, h0], np.float64)
                    with open(save_dir / "labels" / f"{stem}.txt",
                              "a") as f:
                        for p in pred:
                            x1, y1, x2, y2, conf, cls = p
                            xywh = np.array(
                                [(x1 + x2) / 2, (y1 + y2) / 2,
                                 x2 - x1, y2 - y1]) / gn
                            line = ((cls, *xywh, conf) if save_conf
                                    else (cls, *xywh))
                            f.write(("%g " * len(line)).rstrip()
                                    % line + "\n")
                if save_json:
                    # COCO dicts (test.py:225-239): xywh top-left,
                    # numeric image_id when the stem is numeric
                    image_id = (int(stem) if stem.isnumeric() else stem)
                    for pi, p in enumerate(pred):
                        x1, y1, x2, y2, conf, cls = p
                        d = {"image_id": image_id,
                             "category_id": int(cls),
                             "bbox": [round(v, 3) for v in
                                      (x1, y1, x2 - x1, y2 - y1)],
                             "score": round(float(conf), 5)}
                        if kpts is not None:
                            d["keypoints"] = [round(float(v), 3)
                                              for v in kpts[pi]]
                        jdict.append(d)
            if len(l):
                # the JAX package's xywh2xyxy runs in float32
                tbox = _xywh2xyxy_np((l[:, 2:6] * [w_in, h_in, w_in, h_in])
                                     .astype(np.float32))
                tbox = scale_coords((h_in, w_in),
                                    tbox.astype(np.float64), (h0, w0),
                                    ratio_pad=((rh, rw), pad))
                correct = match_predictions(pred, tbox, tcls)
            else:
                correct = np.zeros((len(pred), len(IOUV)), bool)
            stats.append((correct, pred[:, 4] if len(pred) else
                          np.zeros(0), pred[:, 5] if len(pred) else
                          np.zeros(0), tcls))

    out = {"mp": 0.0, "mr": 0.0, "map50": 0.0, "map": 0.0,
           "images": n_images,
           "ms_per_image": 1000 * t_infer / max(n_images, 1)}
    if stats:
        tp = np.concatenate([s[0] for s in stats])
        conf = np.concatenate([s[1] for s in stats])
        pcls = np.concatenate([s[2] for s in stats])
        tcls = np.concatenate([s[3] for s in stats])
        if tp.size and tcls.size:
            p, r, ap, f1, _ = ap_per_class(tp, conf, pcls, tcls)
            out.update(mp=float(p.mean()), mr=float(r.mean()),
                       map50=float(ap[:, 0].mean()),
                       map=float(ap.mean()))
    if save_json and save_dir is not None and jdict:
        w = Path(weights_name).stem if weights_name else ""
        pred_json = save_dir / f"{w}_predictions.json"
        with open(pred_json, "w") as f:
            json.dump(jdict, f)
        out["pred_json"] = str(pred_json)
        if verbose:
            print(f"saved {len(jdict)} predictions -> {pred_json}")
        # optional COCO eval, exactly as optional as the reference's
        # (test.py:331-345 wraps it in try/except)
        if anno_json and Path(anno_json).exists():
            try:
                from pycocotools.coco import COCO
                from pycocotools.cocoeval import COCOeval

                anno = COCO(str(anno_json))
                cpred = anno.loadRes(str(pred_json))
                ev = COCOeval(anno, cpred, "bbox")
                ev.evaluate()
                ev.accumulate()
                ev.summarize()
                out["coco_map"], out["coco_map50"] = \
                    float(ev.stats[0]), float(ev.stats[1])
            except Exception as e:  # noqa: BLE001 — parity: soft-fail
                print(f"pycocotools unable to run: {e}")
    trunc = NMS.truncation_stats(gated_counts, MAX_CANDIDATES)
    out["truncated_images"] = trunc["truncated_images"]
    if verbose:
        print(f"val: {out['images']} images  P {out['mp']:.4f}  "
              f"R {out['mr']:.4f}  mAP50 {out['map50']:.4f}  "
              f"mAP {out['map']:.4f}  "
              f"{out['ms_per_image']:.1f} ms/img")
        if trunc["truncated_images"]:
            print(f"WARNING: {trunc['truncated_images']}/{trunc['images']} "
                  f"images exceeded the {MAX_CANDIDATES} pre-NMS candidate "
                  f"cap ({trunc['dropped_total']} candidates dropped)")
    return out
