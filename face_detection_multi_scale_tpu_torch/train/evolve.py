"""Hyperparameter evolution: genetic search over the hyp space (a copy
of the JAX package's train/evolve.py).

Reference semantics (reference train.py:674-754 + utils/general.py:651-679
print_mutation ledger): per-key (mutation gain, lower, upper) metadata,
parent selected from the top-5 ledger entries weighted by fitness,
gaussian multiplicative mutation (p=0.8, sigma=0.2, factors clipped
0.3..3), limits + 5-digit rounding, one short training run per
generation, results appended to evolve.txt.
"""

from __future__ import annotations

import json
import os
import random
from typing import Callable, Dict, List, Tuple

import numpy as np

# (mutation scale 0-1, lower limit, upper limit) — reference
# train.py:676-704
META: Dict[str, Tuple[float, float, float]] = {
    "lr0": (1, 1e-5, 1e-1),
    "lrf": (1, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1, 0.0, 0.001),
    "warmup_epochs": (1, 0.0, 5.0),
    "warmup_momentum": (1, 0.0, 0.95),
    "warmup_bias_lr": (1, 0.0, 0.2),
    "box": (1, 0.02, 0.2),
    "kpt": (1, 0.001, 0.2),
    "cls": (1, 0.2, 4.0),
    "cls_pw": (1, 0.5, 2.0),
    "obj": (1, 0.2, 4.0),
    "obj_pw": (1, 0.5, 2.0),
    "iou_t": (0, 0.1, 0.7),
    "anchor_t": (1, 2.0, 8.0),
    "fl_gamma": (0, 0.0, 2.0),
    "hsv_h": (1, 0.0, 0.1),
    "hsv_s": (1, 0.0, 0.9),
    "hsv_v": (1, 0.0, 0.9),
    "degrees": (1, 0.0, 45.0),
    "translate": (1, 0.0, 0.9),
    "scale": (1, 0.0, 0.9),
    "shear": (1, 0.0, 10.0),
    "perspective": (0, 0.0, 0.001),
    "flipud": (1, 0.0, 1.0),
    "fliplr": (0, 0.0, 1.0),
    "mosaic": (1, 0.0, 1.0),
    "mixup": (1, 0.0, 1.0),
}


def read_ledger(path: str) -> List[Dict]:
    if not os.path.exists(path):
        return []
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                entries.append(json.loads(line))
    return entries


def append_ledger(path: str, hyp: Dict, fitness: float, results: Dict):
    with open(path, "a") as f:
        f.write(json.dumps({"fitness": fitness, "results": results,
                            "hyp": hyp}) + "\n")


def mutate(hyp: Dict, ledger: List[Dict], rng: np.random.Generator,
           mp: float = 0.8, sigma: float = 0.2) -> Dict:
    """One mutation step: pick a fitness-weighted parent from the top-5
    ledger entries (or the incoming hyp when the ledger is empty), then
    multiply evolvable keys by clipped gaussian factors."""
    keys = [k for k in META if k in hyp]
    if ledger:
        top = sorted(ledger, key=lambda e: -e["fitness"])[:5]
        weights = np.array([e["fitness"] for e in top], float)
        weights = weights - weights.min() + 1e-6
        parent = random.choices(top, weights=weights.tolist())[0]["hyp"]
        base = {k: parent.get(k, hyp[k]) for k in keys}
    else:
        base = {k: hyp[k] for k in keys}

    gains = np.array([META[k][0] for k in keys])
    v = np.ones(len(keys))
    while (v == 1).all():
        v = (gains * (rng.random(len(keys)) < mp) * rng.standard_normal(
            len(keys)) * rng.random() * sigma + 1).clip(0.3, 3.0)
    out = dict(hyp)
    for i, k in enumerate(keys):
        val = float(base[k]) * float(v[i])
        val = min(max(val, META[k][1]), META[k][2])
        out[k] = round(val, 5)
    return out


def evolve(train_once: Callable[[Dict], Tuple[float, Dict]],
           base_hyp: Dict, generations: int = 300,
           ledger_path: str = "evolve.txt", seed: int = 0) -> Dict:
    """Run the evolution loop. `train_once(hyp) -> (fitness, results)`.
    Returns the best hyp found."""
    rng = np.random.default_rng(seed)
    best_hyp, best_fit = dict(base_hyp), -1.0
    for gen in range(generations):
        ledger = read_ledger(ledger_path)
        hyp = mutate(base_hyp, ledger, rng)
        fit, results = train_once(hyp)
        append_ledger(ledger_path, hyp, fit, results)
        if fit > best_fit:
            best_fit, best_hyp = fit, hyp
        print(f"evolve gen {gen}: fitness {fit:.5f} (best {best_fit:.5f})")
    return best_hyp
