"""The yardstick's arithmetic: published peaks of one H100 SXM, the FLOPs
of a forward counted on the reference model on the meta device, and the
least time the fused group kernel and the keep-mask kernel could take for
a call's inputs."""

from __future__ import annotations

import functools
import json
from typing import Dict, Sequence, Tuple

import torch

from portbench.reference.model import Reference

# NVIDIA H100 SXM data sheet, dense rates
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# one float32 IoU of a candidate and an earlier keeper, as the greedy scan
# needs it: about 12 operations
OPS_PER_IOU = 12


@functools.lru_cache(maxsize=None)
def _forward_flops(cfg_json: str, shape: Tuple[int, ...]) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    cfg = json.loads(cfg_json)
    with torch.device("meta"):
        model = Reference(cfg)
        x = torch.zeros(shape)
    with FlopCounterMode(display=False) as counter:
        model(x)
    return float(counter.get_total_flops())


def forward_flops(cfg: Dict, batch: int, hw: Tuple[int, int]) -> float:
    """FLOPs of one forward of `batch` images of `hw` (2 a multiply-add of
    every convolution)."""
    return _forward_flops(json.dumps(cfg, sort_keys=True),
                          (batch, 3, int(hw[0]), int(hw[1])))


def group_bound_s(x_shape: Sequence[int], x_bytes: int,
                  weights: Sequence[Tuple[Sequence[int], int]],
                  out_shape: Sequence[int]) -> Tuple[float, float, float]:
    """(bound seconds, FLOPs, bytes) of one fused group call: every conv
    of the group computes at the output's (h, w), 2 FLOPs a multiply-add
    of each 4-D kernel; x, the weights and the output are moved once, each
    in its own element size (the output in x's). The bound is the larger
    of FLOPs at the bf16 peak and bytes at the HBM rate."""
    b, _, h, w = out_shape
    macs = sum(int(torch.Size(s).numel()) for s, _ in weights if len(s) == 4)
    flops = 2.0 * b * h * w * macs
    nbytes = (torch.Size(x_shape).numel() * x_bytes
              + sum(torch.Size(s).numel() * e for s, e in weights)
              + torch.Size(out_shape).numel() * x_bytes)
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S), flops, nbytes


def keep_bound_s(keep: torch.Tensor, valid: torch.Tensor) -> float:
    """Least time of one keep-mask call, (B, K) keep and valid: 18 bytes a
    candidate (its box, its valid flag, its keep flag) at the HBM rate,
    against 12 float32 operations for every pair of a valid candidate and
    an earlier keeper at the float32 peak."""
    b, k = keep.shape
    kept_before = keep.long().cumsum(1) - keep.long()
    pairs = float((kept_before * valid.long()).sum())
    return max(b * k * 18 / HBM_BYTES_PER_S, pairs * OPS_PER_IOU / F32_FLOPS)
