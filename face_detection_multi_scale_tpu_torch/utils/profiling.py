"""Training metrics sink (the JAX package's utils/profiling.py
`MetricsLogger`; the rest of that module is not ported)."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np


class MetricsLogger:
    """Training metrics sink: always JSONL (`metrics.jsonl` in log_dir);
    TensorBoard events when `tensorboard` is importable (through
    torch.utils.tensorboard); Weights & Biases when available and enabled
    (the reference's TensorBoard + W&B stack, train.py:499-507,
    utils/wandb_logging/wandb_utils.py)."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True,
                 use_wandb: bool = False, wandb_project: str = "fdms-tpu",
                 config: Optional[Dict] = None,
                 run_id: Optional[str] = None):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self.tb = None
        self.wandb = None
        self.run_id = run_id
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(log_dir)
            except ImportError:
                self.tb = None
        if use_wandb:
            try:
                import wandb

                # resume-by-id: a run id recovered from a checkpoint's
                # metadata reattaches to the same tracker run (the
                # check_wandb_resume path, wandb_utils.py:42-53,96-104)
                self.wandb = wandb.init(
                    project=wandb_project, config=config or {},
                    id=run_id, resume="allow" if run_id else None)
                self.run_id = getattr(self.wandb, "id", run_id)
            except Exception as e:  # noqa: BLE001 — tracking is optional
                print(f"wandb unavailable: {e}")
                self.wandb = None

    def log(self, step: int, metrics: Dict[str, float]):
        clean = {k: float(v) for k, v in metrics.items()
                 if isinstance(v, (int, float, np.floating, np.integer))}
        self.jsonl.write(json.dumps({"step": step, **clean}) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in clean.items():
                self.tb.add_scalar(k, v, global_step=step)
            self.tb.flush()
        if self.wandb is not None:
            self.wandb.log(clean, step=step)

    def log_artifact(self, path, name: str, type: str = "model",
                     metadata: Optional[Dict] = None) -> bool:
        """Version a file (weights, dataset snapshot) as a tracker
        artifact (the log_model/log_dataset_artifact surface,
        utils/wandb_logging/wandb_utils.py:127-158,201-215). No-op
        without an active W&B run; returns whether it was uploaded."""
        if self.wandb is None:
            return False
        import wandb

        art = wandb.Artifact(name, type=type, metadata=metadata or {})
        art.add_file(str(path))
        self.wandb.log_artifact(art)
        return True

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
