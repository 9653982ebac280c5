"""Timing, tracing and model-introspection helpers, and the training
metrics sink: the JAX package's utils/profiling.py, every function of
it. `time_synchronized` waits for the card (the reference's CUDA-sync
timing idiom, utils/torch_utils.py:89-93); `trace` is a torch.profiler
context that writes a Chrome trace; `cost_analysis` counts FLOPs with
torch.utils.flop_counter (the convolutions' and matmuls' multiply-adds,
2 FLOPs each; XLA's cost analysis, the JAX package's, also counts the
elementwise ops, so its totals run a few percent higher); `model_info`
returns the JAX keys.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils import _pytree


def time_synchronized(result=None) -> float:
    """time.perf_counter() after the work that produces `result` is done:
    the device of its last tensor (a tensor, or any nest of them such as
    a Detections) is synchronized first (CPU tensors are ready as they
    are)."""
    if result is not None:
        leaves = [t for t in _pytree.tree_leaves(result)
                  if isinstance(t, torch.Tensor)]
        if leaves and leaves[-1].is_cuda:
            torch.cuda.synchronize(leaves[-1].device)
    return time.perf_counter()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A torch.profiler context over the CPU and, where there is one, the
    card; yields the profiler (its `key_averages()` and `events()` read
    what ran) and on exit writes the Chrome trace `<log_dir>/trace.json`
    (open it in Perfetto or chrome://tracing). `log_dir` defaults to
    `fdms-torch-trace` under the temporary directory."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "fdms-torch-trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_busy_ms(prof) -> float:
    """Milliseconds in which the card ran at least one kernel, copy or
    set of a `trace` (the union of the device events' intervals); over a
    synchronized call's host-clock time it is the call's busy share."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3


def param_count(model: torch.nn.Module) -> int:
    """The number of parameter elements (the JAX `params` collection's;
    BatchNorm running statistics are buffers and not counted)."""
    return sum(p.numel() for p in model.parameters())


def cost_analysis(fn, *example_args) -> Dict[str, Any]:
    """{"flops": ...} of one call fn(*example_args), counted by
    torch.utils.flop_counter.FlopCounterMode (the thop GFLOPs
    equivalent). The arguments may live on the meta device, which counts
    without computing."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*example_args)
    return {"flops": float(counter.get_total_flops())}


def model_info(model, img_size: int = 640,
               verbose: bool = True) -> Dict[str, Any]:
    """Summary like the reference model_info (utils/torch_utils.py:
    204-225), the JAX keys: name, parameters, gflops, img_size, levels,
    strides. The GFLOPs are those of one unfused forward of a
    (1, img_size, img_size, 3) input, counted on a meta-device twin of
    the model (built from its spec: no weights copied, nothing
    computed)."""
    spec = model.spec
    n_params = param_count(model)
    with torch.device("meta"):
        twin = type(model)(spec)
        x = torch.zeros(1, img_size, img_size, spec.in_ch)
    gflops = cost_analysis(twin, x)["flops"] / 1e9
    info = {"name": spec.name, "parameters": n_params, "gflops": gflops,
            "img_size": img_size, "levels": spec.nl,
            "strides": list(spec.strides)}
    if verbose:
        print(f"{info['name']}: {n_params:,} parameters, "
              f"{gflops:.1f} GFLOPs @ {img_size}px")
    return info


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
