"""Building blocks of yolov7-w6-face and yolov7-tiny-face as torch modules.

Counterpart of the JAX package's models/layers.py. The JAX modules are
NHWC; these run NCHW, PyTorch's native layout, and the model's public
functions convert at the boundary. Submodule names follow the reference
PyTorch module paths (`conv`, `bn`, `cv1`..`cv7`, `implicit`), so a
reference state dict loads by name.

Parity targets (reference file:line):
  Conv/DWConv            models/common.py:85-105
  MP/SP/SPF              models/common.py:28-52
  ImplicitA/ImplicitM    models/common.py:55-74
  ReOrg                  models/common.py:77-82
  SPPCSPC                models/common.py:294-312
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

# every BatchNorm of the model family (torch YOLO convention; the JAX
# package's layers.py uses the same eps, not torch's default 1e-5)
BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def autopad(k: int, p=None) -> int:
    """Same-padding helper (reference models/common.py:22-26)."""
    return k // 2 if p is None else p


def act_fn(name):
    """Resolve an activation spec. True/'silu' -> SiLU, 'leaky' ->
    LeakyReLU(0.1), 'relu' -> ReLU, False/None/'none' -> identity."""
    if name is True or name == "silu":
        return F.silu
    if name == "leaky":
        return lambda x: F.leaky_relu(x, negative_slope=0.1)
    if name == "relu":
        return F.relu
    if name in (False, None, "none"):
        return lambda x: x
    raise ValueError(f"unknown activation {name!r}")


def max_pool(x: torch.Tensor, k: int, s: int, p: int = 0) -> torch.Tensor:
    """NCHW max pool with torch.nn.MaxPool2d(k, s, p) semantics (padding
    counts as -inf), the JAX package's `max_pool` without ceil_mode."""
    return F.max_pool2d(x, k, s, p)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (nn.Upsample(scale_factor=2))."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def reorg(x: torch.Tensor) -> torch.Tensor:
    """Space-to-depth 2x2 with the reference ReOrg channel order
    [(0,0), (1,0), (0,1), (1,1)] over (h, w) offsets."""
    return torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                      x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=1)


class ConvBN(nn.Module):
    """conv2d(bias=False) + BatchNorm(eps=1e-3) + activation == reference
    `Conv`. `models/fuse.fold_bn` folds the BN into the conv for serving
    and sets `bn` to None."""

    def __init__(self, c1: int, c2: int, k=1, s: int = 1, p=None, g: int = 1,
                 act=True):
        super().__init__()
        k = tuple(k) if isinstance(k, (tuple, list)) else (k, k)
        pad = tuple(p) if isinstance(p, (tuple, list)) else \
            tuple(autopad(kk, p) for kk in k)
        self.conv = nn.Conv2d(c1, c2, k, s, pad, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act_fn(act)

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


def DWConvBN(c1: int, c2: int, k: int = 1, s: int = 1, act=True) -> ConvBN:
    """Depthwise conv block == reference `DWConv` (groups = gcd(c1, c2))."""
    return ConvBN(c1, c2, k, s, g=math.gcd(c1, c2), act=act)


class SPPCSPC(nn.Module):
    """CSP SPP with parallel pools (reference models/common.py:294-312)."""

    def __init__(self, c1: int, c2: int, e: float = 0.5,
                 k: Tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        c_ = int(2 * c2 * e)
        self.k = k
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c1, c_, 1, 1)
        self.cv3 = ConvBN(c_, c_, 3, 1)
        self.cv4 = ConvBN(c_, c_, 1, 1)
        self.cv5 = ConvBN(4 * c_, c_, 1, 1)
        self.cv6 = ConvBN(c_, c_, 3, 1)
        self.cv7 = ConvBN(2 * c_, c2, 1, 1)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        pools = [max_pool(x1, k, 1, k // 2) for k in self.k]
        y1 = self.cv6(self.cv5(torch.cat([x1] + pools, dim=1)))
        y2 = self.cv2(x)
        return self.cv7(torch.cat([y1, y2], dim=1))


class ImplicitA(nn.Module):
    """Learned additive prior, parameter shape (1, C, 1, 1) as in the
    reference (models/common.py:55-63). Its parameter stays float32 in a
    bf16 model (models/model.cast_model), as the JAX module has no dtype:
    a bf16 input gives a float32 output by type promotion."""

    def __init__(self, channels: int):
        super().__init__()
        self.implicit = nn.Parameter(torch.zeros(1, channels, 1, 1))

    def forward(self, x):
        return x + self.implicit


class ImplicitM(nn.Module):
    """Learned multiplicative prior (reference models/common.py:66-74);
    float32 in a bf16 model, as ImplicitA."""

    def __init__(self, channels: int):
        super().__init__()
        self.implicit = nn.Parameter(torch.ones(1, channels, 1, 1))

    def forward(self, x):
        return x * self.implicit
