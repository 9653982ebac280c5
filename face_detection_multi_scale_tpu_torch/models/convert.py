"""Weight bridge: a JAX-package variables tree -> this package's state dict.

Inverts the JAX package's models/convert.py, whose flax names were chosen
to mirror the reference torch module paths:

  ("model_8", "cv1", "conv", "kernel")      -> "model.8.cv1.conv.weight"
  ("model_105", "m_kpt_0_3", "conv", ...)   -> "model.105.m_kpt.0.3.conv..."

Rules:
  * a trailing run of "_<digits>" splits off as ".<digits>" components
    (the inverse of convert.py's numeric merge) only where the JAX names
    came from such a merge: `model_{i}` (and `model_{i}_{j}` of a
    repeated node), the head's `m_{l}`, `ia_{l}`, `im_{l}`,
    `m_kpt_{l}(_{k})`, a CSP block's (or MixConv2d's) `m_{j}`, and the
    Sequential indices `branchK_N`, `conv_N`, `shortcut_N` and a
    transformer block's `tr_N`; a name such as StemBlock's `stem_1` stays
    whole
  * the JAX names of reference submodules: CrossConv's `cv2_conv` /
    `cv2_bn` -> `cv2.conv` / `cv2.bn`, a TransformerLayer's `ma_out` ->
    `ma.out_proj` (the reference nn.MultiheadAttention's)
  * conv kernels HWIO (kh, kw, I/g, O) -> OIHW (O, I/g, kh, kw); Dense
    kernels (in, out) -> Linear weights (out, in)
  * BN params scale/bias -> weight/bias; batch_stats mean/var ->
    running_mean/running_var; num_batches_tracked is added as 0
  * implicit-knowledge params and the ACON activations' p1 / p2 / beta
    (C,) -> (1, C, 1, 1); Sum's `w` as it is

The result loads with `load_state_dict(strict=True)` into the YoloFace of
the same spec. A reference checkpoint's state dict loads through
`load_reference_state_dict`, which drops what the model does not keep as
weights (the JAX converter's rule). `state_dict_to_jax` is the way back,
a copy of the JAX package's `convert_state_dict` (numeric components
merge into the name before them) with the renames above reversed; a
CrossConv's `cv2.conv` is told from any other block's only by the model,
which `state_dict_to_jax(..., model=)` takes.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from face_detection_multi_scale_tpu_torch.models.layers_extra import (
    CrossConv)

_NUMERIC_TAIL = re.compile(r"^(.*?)((?:_\d+)*)$")
# the bases whose numeric tails came from merging torch path components
_MERGED_BASES = re.compile(
    r"^(model|m|m_kpt|ia|im|conv|branch\d+|shortcut|tr)$")
# JAX names of reference submodule paths (CrossConv's second conv, the
# output projection of the reference's nn.MultiheadAttention)
_RENAMED = {"cv2_conv": "cv2.conv", "cv2_bn": "cv2.bn",
            "ma_out": "ma.out_proj"}
# per-channel parameters kept (1, C, 1, 1) in torch and (C,) in JAX
_CHANNEL_PARAMS = ("implicit", "p1", "p2", "beta")
# the reference TransformerLayer's in-projection, which the JAX layer
# (and so this package's) does not compute
IN_PROJ_LEAVES = ("in_proj_weight", "in_proj_bias")
# last key components of a reference state dict that are no weights: the
# head's anchor buffers (the model takes anchors from its spec) and BN's
# batch counter
SKIPPED_LEAVES = ("anchors", "anchor_grid", "num_batches_tracked")


def _split_component(name: str) -> str:
    if name in _RENAMED:
        return _RENAMED[name]
    base, tail = _NUMERIC_TAIL.match(name).groups()
    if not _MERGED_BASES.match(base):
        return name
    return ".".join([base] + [d for d in tail.split("_") if d])


def _leaves(tree: Mapping[str, Any], prefix=()) -> Iterator[
        Tuple[Tuple[str, ...], Any]]:
    for key in tree.keys():
        node = tree[key]
        if hasattr(node, "keys"):
            yield from _leaves(node, prefix + (key,))
        else:
            yield prefix + (key,), node


def flax_path_to_torch_key(path: Tuple[str, ...]) -> str:
    """("model_8", "cv1", "conv", "kernel") -> "model.8.cv1.conv.weight"
    (the leaf is renamed by `jax_to_state_dict`)."""
    return ".".join(_split_component(p) for p in path)


def jax_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} of numpy-convertible arrays ->
    torch state dict (float32 tensors on the CPU)."""
    out: Dict[str, torch.Tensor] = {}

    def put(key: str, value):
        key = key.lstrip(".")  # a leaf of the tree's root module
        if key in out:
            raise ValueError(f"two JAX leaves map to {key!r}")
        out[key] = value

    for path, value in _leaves(variables.get("params", {})):
        v = np.asarray(value, np.float32)
        module = flax_path_to_torch_key(path[:-1])
        leaf = path[-1]
        if leaf == "kernel":
            if v.ndim not in (2, 4):
                raise ValueError(f"unhandled kernel shape {v.shape} at "
                                 f"{path}")
            put(f"{module}.weight", torch.from_numpy(np.ascontiguousarray(
                v.T if v.ndim == 2 else v.transpose(3, 2, 0, 1))))
        elif leaf == "scale":
            put(f"{module}.weight", torch.from_numpy(v.copy()))
        elif leaf == "bias":
            put(f"{module}.bias", torch.from_numpy(v.copy()))
        elif leaf in _CHANNEL_PARAMS:
            put(f"{module}.{leaf}",
                torch.from_numpy(v.reshape(1, -1, 1, 1).copy()))
        elif leaf == "w":
            put(f"{module}.w", torch.from_numpy(v.copy()))
        else:
            raise ValueError(f"unhandled leaf {leaf!r} at {path}")
    for path, value in _leaves(variables.get("batch_stats", {})):
        v = np.asarray(value, np.float32)
        module = flax_path_to_torch_key(path[:-1])
        leaf = {"mean": "running_mean", "var": "running_var"}.get(path[-1])
        if leaf is None:
            raise ValueError(f"unhandled batch stat {path[-1]!r} at {path}")
        put(f"{module}.{leaf}", torch.from_numpy(v.copy()))
        if leaf == "running_mean":
            put(f"{module}.num_batches_tracked",
                torch.tensor(0, dtype=torch.long))
    return out


def _merge_numeric(parts):
    out = []
    for p in parts:
        if p.isdigit() and out:
            out[-1] = f"{out[-1]}_{p}"
        else:
            out.append(p)
    return out


def torch_key_to_flax_path(key: str) -> Tuple[Tuple[str, ...], str]:
    """"model.8.cv1.conv.weight" -> (("model_8", "cv1", "conv"), "weight"),
    the inverse of `flax_path_to_torch_key` (the leaf is renamed by
    `state_dict_to_jax`)."""
    parts = key.split(".")
    leaf = parts.pop()
    return tuple(_merge_numeric(parts)), leaf


def _jax_keys(state_dict: Mapping[str, Any], model) -> Dict[str, str]:
    """Each key of `state_dict` with the JAX names of reference submodule
    paths: `ma.out_proj` -> `ma_out`, and a CrossConv's `cv2.` (a
    CrossConv of `model`) -> `cv2_`."""
    cross = [] if model is None else [
        f".{name}.cv2.".replace("..", ".") for name, mod in
        model.named_modules() if isinstance(mod, CrossConv)]
    out = {}
    for key in state_dict:
        new = ("." + key).replace(".ma.out_proj.", ".ma_out.")
        for p in cross:
            if new.startswith(p):
                new = p[:-1] + "_" + new[len(p):]
        out[key] = new[1:]
    return out


def state_dict_to_jax(state_dict: Mapping[str, Any],
                      model: Optional[torch.nn.Module] = None
                      ) -> Dict[str, Any]:
    """A state dict of this package's YoloFace (or a reference one) ->
    the JAX package's variables {"params": ..., "batch_stats": ...} of
    float32 numpy arrays: OIHW kernels to HWIO, Linear weights to (in,
    out) Dense kernels, BN weight -> scale, running_mean/var -> mean/var,
    implicit and p1 / p2 / beta (1, C, 1, 1) -> (C,); num_batches_tracked
    and the anchor buffers are dropped. A model with a CrossConv needs
    `model` (the YoloFace the state dict belongs to) for its `cv2_conv`
    / `cv2_bn` names."""
    names = _jax_keys(state_dict, model)
    bn_modules = {torch_key_to_flax_path(names[k])[0] for k in state_dict
                  if k.endswith("running_mean")}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree, path, leaf, value):
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value

    for key, value in state_dict.items():
        path, leaf = torch_key_to_flax_path(names[key])
        if leaf in SKIPPED_LEAVES:
            continue
        v = (value.detach().cpu().float().numpy()
             if isinstance(value, torch.Tensor)
             else np.asarray(value, np.float32))
        if leaf == "weight" and v.ndim == 4:
            put(params, path, "kernel", v.transpose(2, 3, 1, 0).copy())
        elif leaf == "weight" and v.ndim == 2:
            put(params, path, "kernel", v.T.copy())
        elif leaf == "weight" and v.ndim == 1 and path in bn_modules:
            put(params, path, "scale", v)
        elif leaf == "bias":
            put(params, path, "bias", v)
        elif leaf in ("running_mean", "running_var"):
            put(stats, path, leaf[len("running_"):], v)
        elif leaf in _CHANNEL_PARAMS:
            put(params, path, leaf, v.reshape(-1))
        elif leaf == "w":
            put(params, path, "w", v)
        else:
            raise ValueError(f"unhandled leaf {leaf!r} of shape {v.shape} "
                             f"at {key}")
    return {"params": params, "batch_stats": stats}


def load_reference_state_dict(net: torch.nn.Module,
                              state_dict: Mapping[str, Any]) -> None:
    """Load a state dict with reference key names into `net`, skipping the
    keys whose last component is in SKIPPED_LEAVES; every other key of
    either side must match (a BN counter left out stays as it was). A
    reference TransformerLayer's in-projection (`ma.in_proj_weight` /
    `ma.in_proj_bias`) raises naming the key: the layer this package
    computes (the JAX package's) has none, so the weights would load into
    a different function."""
    for k in state_dict:
        if k.rsplit(".", 1)[-1] in IN_PROJ_LEAVES:
            raise ValueError(
                f"{k}: the reference nn.MultiheadAttention's in-projection "
                f"is not part of the TransformerLayer computed here (the "
                f"JAX package's, without one); this checkpoint does not "
                f"load")
    kept = {k: v for k, v in state_dict.items()
            if k.rsplit(".", 1)[-1] not in SKIPPED_LEAVES}
    missing, unexpected = net.load_state_dict(kept, strict=False)
    missing = [k for k in missing
               if k.rsplit(".", 1)[-1] not in SKIPPED_LEAVES]
    if missing or unexpected:
        raise RuntimeError(f"state dict does not match the model: missing "
                           f"{missing}, unexpected {unexpected}")


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference .pt checkpoint -> its (EMA-preferred) float state dict,
    as the JAX package's `load_torch_checkpoint`: a training checkpoint
    dict gives its "ema" entry, else its "model"; a bare module or a raw
    state dict is taken as it is. Load it with
    `load_reference_state_dict`, which drops the anchor buffers."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and ("ema" in ckpt or "model" in ckpt):
        model = ckpt.get("ema") or ckpt.get("model")
    else:
        model = ckpt
    if hasattr(model, "float"):
        return dict(model.float().state_dict())
    return {k: v.float() if v.is_floating_point() else v
            for k, v in model.items()}


def load_inference_weights(path: str) -> Dict[str, Dict[str, Any]]:
    """The flat .npz of the JAX package's `save_inference_weights` (keys
    "<collection>/<module>/.../<leaf>") -> the nested variables tree
    {"params": ..., "batch_stats": ...} of numpy arrays, the input of
    `jax_to_state_dict`."""
    cols: Dict[str, Dict[str, Any]] = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = cols
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = flat[key]
    return cols
