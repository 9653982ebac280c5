"""WIDER FACE annotation browser and statistics.

    python -m face_detection_multi_scale_tpu_torch.cli.visualize_widerface \
        {stats,show,to-labels} --annot wider_face_val_bbx_gt.txt \
        [--images ROOT] [--image REL_PATH] [--out PATH] [--skip-invalid]

The port's counterpart of the JAX package's cli/visualize_widerface.py
(the reference visualize_widerface.py): parse the 10-field bbx_gt
annotations; `stats` prints the dataset statistics by size, blur and
occlusion as JSON, `show` draws one image's ground-truth boxes into a
png, `to-labels` writes training label txts (reference
data/test.py:10-20). Host code (OpenCV for `show`, PIL for `to-labels`),
no model and no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from face_detection_multi_scale_tpu_torch.data.widerface_annotations import (
    annotations_to_labels, dataset_statistics, load_annotations)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("command", choices=["stats", "show", "to-labels"])
    ap.add_argument("--annot", required=True,
                    help="wider_face_*_bbx_gt.txt path")
    ap.add_argument("--images", default=None, help="images root")
    ap.add_argument("--image", default=None,
                    help="relative image path for `show`")
    ap.add_argument("--out", default=None,
                    help="output png (show) / labels root (to-labels)")
    ap.add_argument("--skip-invalid", action="store_true")
    args = ap.parse_args(argv)

    annots = load_annotations(args.annot)

    if args.command == "stats":
        stats = dataset_statistics(annots)
        print(json.dumps(stats, indent=2, sort_keys=True))
    elif args.command == "show":
        if not (args.images and args.image):
            ap.error("show needs --images and --image")
        import cv2

        from face_detection_multi_scale_tpu_torch.utils.plotting import (
            draw_detection)

        img = cv2.imread(os.path.join(args.images, args.image))
        faces = annots.get(args.image, [])
        for face in faces:
            x, y, w, h = face["bbox"]
            label = (f"b{face['blur']} o{face['occlusion']}"
                     + (" INV" if face["invalid"] else ""))
            draw_detection(img, [x, y, x + w, y + h], label=label,
                           cls=face["blur"])
        out = args.out or "widerface_view.png"
        cv2.imwrite(out, img)
        print(f"{args.image}: {len(faces)} faces -> {out}")
    elif args.command == "to-labels":
        if not (args.images and args.out):
            ap.error("to-labels needs --images and --out")
        n = annotations_to_labels(annots, args.images, args.out,
                                  skip_invalid=args.skip_invalid)
        print(f"wrote {n} label files to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
