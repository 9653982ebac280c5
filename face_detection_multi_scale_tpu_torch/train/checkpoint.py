"""Checkpoint save/resume with torch.save, and the stripped inference
weights in the JAX package's .npz layout.

The port's counterpart of the JAX package's train/checkpoint.py (which
writes orbax): `last` every epoch, `best` by fitness, a strip step
producing EMA-only inference weights; resume restores optimizer / EMA /
epoch (reference train.py:509-534, utils/general.py:635-648). A
checkpoint is `<ckpt_dir>/<tag>.pt` (the TrainState's tensors on the
host, and its counters) plus the JSON sidecar `<tag>.meta.json`.

The crash contract is the JAX package's: the state is written to
`<tag>.pt.tmp` and swapped in by renames, so a crash at any point leaves
a restorable checkpoint, either the old one (at `<tag>.pt`, or parked at
`<tag>.pt.old`, which load_checkpoint falls back to) or the complete new
one. `AsyncCheckpointWriter` writes on a background thread while the
next epoch trains, the swap running at completion.

`save_inference_weights` writes the flat .npz of the JAX package's
function of that name ("params/model_0/conv/kernel", HWIO kernels,
"batch_stats/.../mean"), so both packages' loaders read what the port
trains (`models/convert.load_inference_weights` here).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from face_detection_multi_scale_tpu_torch.models.convert import (
    load_inference_weights, state_dict_to_jax)
from face_detection_multi_scale_tpu_torch.train.trainer import TrainState

__all__ = ["save_checkpoint", "load_checkpoint", "peek_meta",
           "AsyncCheckpointWriter", "strip_to_inference",
           "save_inference_weights", "load_inference_weights"]


def _paths(ckpt_dir: str, tag: str) -> Tuple[str, str]:
    base = os.path.abspath(os.path.join(ckpt_dir, tag))
    return base + ".pt", base + ".meta.json"


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _payload(state: TrainState) -> Dict[str, Any]:
    """The state's tensors copied to the host now (a background write
    must capture this step's values) and its counters."""
    return {
        "model": _host(state.model.state_dict()),
        "momentum_buf": _host(state.momentum_buf),
        "second_moment": (None if state.second_moment is None
                          else _host(state.second_moment)),
        "ema_params": _host(state.ema_params),
        "step": int(state.step), "ema_updates": int(state.ema_updates)}


def save_checkpoint(ckpt_dir: str, tag: str, state: TrainState,
                    meta: Dict[str, Any]) -> None:
    """Save a TrainState under ckpt_dir/<tag>.pt (last/best) + meta json,
    crash-safe (the module docstring)."""
    path, meta_path = _paths(ckpt_dir, tag)
    _pre_save(path)
    torch.save(_payload(state), path + ".tmp")
    _finalize_swap(path, meta_path, meta)


def _pre_save(path: str) -> None:
    """Clear a stale .tmp and resolve a parked .old BEFORE a new write:
    if a previous save crashed mid-swap, <tag>.pt.old holds the only
    restorable state — ADOPT it back instead of deleting it."""
    tmp, old = path + ".tmp", path + ".old"
    if os.path.exists(tmp):
        os.remove(tmp)
    if os.path.exists(old):
        if not os.path.exists(path):
            os.rename(old, path)
        else:
            os.remove(old)


def _finalize_swap(path: str, meta_path: str, meta: Dict[str, Any]) -> None:
    """Swap a COMPLETE <tag>.pt.tmp in: write the meta sidecar, park the
    live checkpoint at .old, move the new one in, drop .old. Each step is
    a rename (atomic) or a delete of a spare copy."""
    old = path + ".old"
    meta_tmp = meta_path + ".tmp"
    with open(meta_tmp, "w") as f:
        json.dump(meta, f)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(path + ".tmp", path)
    os.replace(meta_tmp, meta_path)
    if os.path.exists(old):
        os.remove(old)


class AsyncCheckpointWriter:
    """Non-blocking checkpoint saves: the write of epoch N runs on a
    background thread while epoch N+1 trains (the reference's torch.save
    blocks the loop, train.py:517-534). The state is copied to the host
    when `save` is called.

    At most one save is in flight; a new save() waits for the previous.
    The crash contract matches save_checkpoint exactly — the tmp/old
    swap runs only at completion (inside wait()/the next save()/
    close()), so a crash at ANY point leaves a restorable <tag> or
    <tag>.old, and a completed-but-unswapped .tmp counts as never saved
    (the next save's _pre_save discards it). A failed write raises from
    the wait that collects it."""

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(1)
        self._pending = None  # (future, path, meta path, meta)

    def save(self, ckpt_dir: str, tag: str, state: TrainState,
             meta: Dict[str, Any]) -> None:
        self.wait()
        path, meta_path = _paths(ckpt_dir, tag)
        _pre_save(path)
        future = self._pool.submit(torch.save, _payload(state),
                                   path + ".tmp")
        self._pending = (future, path, meta_path, dict(meta))

    def wait(self) -> None:
        """Block until the in-flight save (if any) is durable: its .tmp
        written AND the atomic swap run."""
        if self._pending is None:
            return
        future, path, meta_path, meta = self._pending
        self._pending = None
        future.result()
        _finalize_swap(path, meta_path, meta)

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown()


def load_checkpoint(ckpt_dir: str, tag: str,
                    state: TrainState) -> Tuple[TrainState, Dict]:
    """Restore a checkpoint written by save_checkpoint into `state` (a
    state of the same model and optimizer), in place on its device;
    returns (state, meta)."""
    path, meta_path = _paths(ckpt_dir, tag)
    if not os.path.exists(path) and os.path.exists(path + ".old"):
        # a crash mid-swap can leave the previous checkpoint parked at
        # <tag>.pt.old with nothing at <tag>.pt yet
        path = path + ".old"
    saved = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(saved["model"])
    with torch.no_grad():
        for key in ("momentum_buf", "ema_params", "second_moment"):
            mine, theirs = getattr(state, key), saved[key]
            if (mine is None) != (theirs is None) or (
                    mine is not None and set(mine) != set(theirs)):
                raise ValueError(f"checkpoint {path}: {key} does not "
                                 f"match the state")
            for name, t in (mine or {}).items():
                t.copy_(theirs[name])
    state.step, state.ema_updates = saved["step"], saved["ema_updates"]
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta


def peek_meta(ckpt_dir: str, tag: str) -> Dict[str, Any]:
    """Read just the metadata sidecar without restoring the state —
    used before logger construction to recover the experiment-tracker
    run id (the check_wandb_resume equivalent,
    utils/wandb_logging/wandb_utils.py:42-53)."""
    meta_path = _paths(ckpt_dir, tag)[1]
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def strip_to_inference(state: TrainState) -> Dict[str, Any]:
    """EMA-preferred inference variables (the strip_optimizer equivalent,
    utils/general.py:635-648 + attempt_load EMA preference,
    models/experimental.py:113-141): the EMA parameters with the live BN
    statistics, as the JAX package's variables tree of numpy arrays."""
    sd = state.model.state_dict()
    sd.update(state.ema_params)
    return state_dict_to_jax(sd, model=state.model)


def save_inference_weights(path: str, variables: Dict[str, Any]) -> None:
    """Flat .npz of inference variables, keys "<collection>/<module
    path>/<leaf>" (the JAX package's layout)."""
    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(prefix + (k,), v)
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v)

    walk((), variables)
    np.savez(path, **flat)
