"""Training hyperparameter presets (a copy of the JAX package's train/hyp.py).

Values mirror the reference hyp files (reference data/hyp.scratch.p6.yaml,
data/hyp.scratch.p5.yaml, data/hyp.scratch.tiny.yaml,
data/hyp.finetune.yaml). `HYP_SCRATCH_P6` is the training default
(reference train.py:597).
"""

from __future__ import annotations

HYP_SCRATCH_P6 = {
    "lr0": 0.01, "lrf": 0.2, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_epochs": 3.0, "warmup_momentum": 0.8, "warmup_bias_lr": 0.1,
    "box": 0.05, "kpt": 0.005, "cls": 0.3, "obj": 0.7,
    "cls_pw": 1.0, "obj_pw": 1.0, "iou_t": 0.20, "anchor_t": 4.0,
    "fl_gamma": 0.0, "label_smoothing": 0.0,
    "hsv_h": 0.0, "hsv_s": -1.0, "hsv_v": -0.5,
    "degrees": 0.0, "translate": 0.0, "scale": 0.0, "shear": 0.0,
    "perspective": 0.0, "flipud": 0.0, "fliplr": 0.5,
    "mosaic": 0.0, "mixup": 0.0, "copy_paste": 0.0, "paste_in": 0.0,
}

HYP_SCRATCH_P5 = dict(HYP_SCRATCH_P6, lrf=0.1, hsv_h=0.015, hsv_s=0.7,
                      hsv_v=0.4, translate=0.2, scale=0.9, mosaic=1.0,
                      mixup=0.15, paste_in=0.15)

HYP_SCRATCH_TINY = dict(HYP_SCRATCH_P6, lrf=0.01, cls=0.5, obj=1.0,
                        hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, translate=0.1,
                        scale=0.5, mosaic=1.0, mixup=0.05, paste_in=0.05)

HYP_FINETUNE = dict(HYP_SCRATCH_P6, lr0=0.001, lrf=0.1, hsv_h=0.015,
                    hsv_s=0.7, hsv_v=0.4, translate=0.1, scale=0.5,
                    mosaic=0.8, mixup=0.1, label_smoothing=0.1)

PRESETS = {
    "scratch.p6": HYP_SCRATCH_P6,
    "scratch.p5": HYP_SCRATCH_P5,
    "scratch.tiny": HYP_SCRATCH_TINY,
    "finetune": HYP_FINETUNE,
}


def get_hyp(name_or_path: str) -> dict:
    """Look up a preset or load a reference-format hyp YAML file."""
    if name_or_path in PRESETS:
        return dict(PRESETS[name_or_path])
    import yaml
    with open(name_or_path) as f:
        loaded = yaml.safe_load(f)
    hyp = dict(HYP_SCRATCH_P6)
    hyp.update({k: v for k, v in loaded.items() if v is not None})
    return hyp
