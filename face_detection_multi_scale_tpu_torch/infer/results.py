"""Inference results object — the torch.hub `Detections` equivalent
(reference models/common.py:642-726) in plain numpy; a copy of the JAX
package's infer/results.py. It holds host arrays only, so it is the same
whichever device computed the rows.

Holds per-image detection rows [x1, y1, x2, y2, conf, cls] in original
pixel coordinates plus the RGB images, and exposes the same surface:
xyxy / xywh / xyxyn / xywhn views, pandas() DataFrames with the
reference's exact column names, print/save/crop/render, tolist().
"""

from __future__ import annotations

from copy import copy
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from face_detection_multi_scale_tpu_torch.utils.general import (
    _xyxy2xywh_np, increment_path, save_one_box)


class Detections:
    def __init__(self, imgs: Sequence[np.ndarray],
                 pred: Sequence[np.ndarray], files: Sequence[str],
                 times: Optional[Tuple[float, ...]] = None,
                 names: Sequence[str] = ("face",),
                 shape: Optional[Tuple[int, ...]] = None):
        # per-image normalization vector [w, h, w, h, 1, 1]
        # (models/common.py:646)
        gn = [np.array([im.shape[1], im.shape[0], im.shape[1],
                        im.shape[0], 1.0, 1.0]) for im in imgs]
        self.imgs = list(imgs)
        self.pred = [np.asarray(p, np.float64).reshape(-1, 6)
                     for p in pred]
        self.names = list(names)
        self.files = list(files)
        self.xyxy = self.pred
        self.xywh = [np.concatenate(
            [_xyxy2xywh_np(p[:, :4]), p[:, 4:]], axis=1)
            for p in self.pred]
        self.xyxyn = [p / g for p, g in zip(self.xyxy, gn)]
        self.xywhn = [p / g for p, g in zip(self.xywh, gn)]
        self.n = len(self.pred)
        self.t = (tuple(1000 * (times[i + 1] - times[i]) / self.n
                        for i in range(3)) if times else (0.0,) * 3)
        self.s = shape

    # ------------------------------------------------------------------

    def display(self, pprint=False, show=False, save=False, crop=False,
                render=False, save_dir=Path("")):
        from face_detection_multi_scale_tpu_torch.utils.plotting import (
            draw_detection)

        for i, (im, pred) in enumerate(zip(self.imgs, self.pred)):
            msg = (f"image {i + 1}/{self.n}: "
                   f"{im.shape[0]}x{im.shape[1]} ")
            im = np.ascontiguousarray(im)
            for c in np.unique(pred[:, 5]).astype(int):
                n = int((pred[:, 5] == c).sum())
                msg += f"{n} {self.names[c]}{'s' * (n > 1)}, "
            if show or save or render or crop:
                for row in pred:
                    box, conf, cls = row[:4], row[4], int(row[5])
                    if crop:
                        # im is RGB; save_one_box's default BGR=False
                        # performs the cv2 channel swap itself
                        # (models/common.py:673 passes RGB too)
                        save_one_box(
                            box, im,
                            file=Path(save_dir) / "crops"
                            / self.names[cls] / self.files[i])
                    else:
                        draw_detection(im, box, conf, cls,
                                       f"{self.names[cls]} {conf:.2f}")
            if pprint:
                print(msg.rstrip(", "))
            if show or save:
                from PIL import Image

                pim = Image.fromarray(im.astype(np.uint8))
                if show:
                    pim.show(self.files[i])
                if save:
                    pim.save(Path(save_dir) / self.files[i])
            if render:
                self.imgs[i] = im

    def print(self):
        self.display(pprint=True)
        print("Speed: %.1fms pre-process, %.1fms inference, %.1fms NMS "
              "per image at shape %s" % (*self.t, tuple(self.s or ())))

    def show(self):
        self.display(show=True)

    def save(self, save_dir="runs/hub/exp"):
        save_dir = increment_path(save_dir,
                                  exist_ok=save_dir != "runs/hub/exp",
                                  mkdir=True)
        self.display(save=True, save_dir=save_dir)
        return save_dir

    def crop(self, save_dir="runs/hub/exp"):
        save_dir = increment_path(save_dir,
                                  exist_ok=save_dir != "runs/hub/exp",
                                  mkdir=True)
        self.display(crop=True, save_dir=save_dir)
        return save_dir

    def render(self):
        self.display(render=True)
        return self.imgs

    def pandas(self):
        """DataFrame views with the reference's exact column names
        (models/common.py:703-710)."""
        import pandas as pd

        new = copy(self)
        ca = ("xmin", "ymin", "xmax", "ymax", "confidence", "class",
              "name")
        cb = ("xcenter", "ycenter", "width", "height", "confidence",
              "class", "name")
        for k, c in zip(["xyxy", "xyxyn", "xywh", "xywhn"],
                        [ca, ca, cb, cb]):
            a = [[list(row[:5]) + [int(row[5]),
                                   self.names[int(row[5])]]
                  for row in arr] for arr in getattr(self, k)]
            setattr(new, k, [pd.DataFrame(x, columns=c) for x in a])
        return new

    def tolist(self) -> List["Detections"]:
        out = []
        for i in range(self.n):
            d = Detections([self.imgs[i]], [self.pred[i]],
                           [self.files[i]], None, self.names, self.s)
            for k in ("imgs", "pred", "xyxy", "xyxyn", "xywh", "xywhn"):
                setattr(d, k, getattr(d, k)[0])
            out.append(d)
        return out

    def __len__(self):
        return self.n
