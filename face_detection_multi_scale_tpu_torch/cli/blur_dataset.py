"""Blur-robustness dataset generation.

    python -m face_detection_multi_scale_tpu_torch.cli.blur_dataset \
        --wider-path WIDER_train [--output-dir blur_dataset] \
        [--total-images 500] [--min-face 32] [--val-path WIDER_val \
        --val-blur-level medium] [--seed 0]

The port's counterpart of the JAX package's cli/blur_dataset.py (the
reference blur_dataset_generator.py __main__ flow): sample WIDER train
images by difficulty, blur each with one of the nine blur configs, copy
the labels, write metadata.json, and optionally blur a val split. Host
code (OpenCV), no model and no card.
"""

from __future__ import annotations

import argparse
import sys

from face_detection_multi_scale_tpu_torch.data.blur import (
    BlurDatasetGenerator)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--wider-path", required=True,
                    help="WIDER train root (images/ + labels/)")
    ap.add_argument("--output-dir", default="blur_dataset")
    ap.add_argument("--total-images", type=int, default=500)
    ap.add_argument("--min-face", type=int, default=32)
    ap.add_argument("--val-path", default=None,
                    help="also blur this val split")
    ap.add_argument("--val-blur-level", default="medium",
                    choices=["light", "medium", "heavy"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    gen = BlurDatasetGenerator(args.wider_path, seed=args.seed)
    stats = gen.create_blur_dataset(args.total_images, args.output_dir,
                                    min_face=args.min_face)
    print(f"train blur set: {stats}")
    if args.val_path:
        n = gen.create_blur_val(args.val_path, args.output_dir,
                                args.val_blur_level)
        print(f"val blur set: {n} images")
    return 0


if __name__ == "__main__":
    sys.exit(main())
