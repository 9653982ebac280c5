"""The remaining building blocks: experimental ops, transformer blocks, CSP
variants and the alternative activations.

Counterpart of the JAX package's models/layers_extra.py, every block of
it, as NCHW torch modules built from `models/layers.py`. Submodule names
follow the reference PyTorch modules, so a reference state dict loads by
name, and `models/convert.py` maps the JAX names onto them:

  JAX name                      torch key
  CrossConv  cv2_conv / cv2_bn  cv2.conv / cv2.bn
  GhostBottleneck conv_N        conv.N (a Sequential; conv.1 is an
                                Identity at s = 1)
             shortcut_N         shortcut.N
  MixConv2d  m_N                m.N (a ModuleList)
  C3TR       m/tr_N             m.tr.N
  TransformerLayer ma_out       ma.out_proj
  Sum        w                  w

Where the JAX package and the reference differ, this module computes the
JAX package's function:
  * CrossConv strides the height only: cv1 is (1, k) at stride 1 and cv2
    (k, 1) at stride (s, 1); the reference's cv1 strides the width;
  * TransformerLayer has no in-projection (the reference's
    nn.MultiheadAttention applies `in_proj_weight` to q, k and v);
  * TransformerBlock maps tokens back in (h, w) order, where the
    reference's reshape(b, c2, w, h) swaps them on a non-square map.

Reference sources:
  CrossConv / Sum / GhostConv / GhostBottleneck / MixConv2d
      models/experimental.py:11-95
  TransformerLayer / TransformerBlock / C3TR
      models/common.py:107-150, 238-243
  BottleneckCSPF / BottleneckCSP2 / SPPCSP
      models/common.py:185-220, 271-291
  ConvFocus / Contract / Expand / Classify
      models/common.py:366-409, 729-739
  activations (SiLU..MetaAconC)
      utils/activations.py:9-98
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from face_detection_multi_scale_tpu_torch.models import layers as L
from face_detection_multi_scale_tpu_torch.models.layers import (
    Bottleneck, Conv2d, ConvBN, DWConvBN, autopad, batch_norm, max_pool)


class Linear(nn.Linear):
    """nn.Linear computing in `compute_dtype`, flax's `Dense(dtype=)`: the
    input, weight and bias are cast to it (`layers.Conv2d`'s rule)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else \
        torch.Generator().manual_seed(0)


class CrossConv(nn.Module):
    """Cross (1 x k then k x 1) convolution (reference
    models/experimental.py:11-23, with the JAX package's strides)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1,
                 e: float = 1.0, shortcut: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, (1, k), 1)
        self.cv2 = ConvBN(c_, c2, (k, 1), (s, 1), g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class Sum(nn.Module):
    """(Weighted) sum of n inputs (reference models/experimental.py:26-44):
    with `weight`, input i + 1 is scaled by 2 sigmoid(w[i]), w starting at
    -(1, 2, ..., n - 1) / 2. `w` stays float32 in a bf16 model
    (models/model.cast_model), so a bf16 sum comes out float32, as the JAX
    module's does."""

    def __init__(self, n: int, weight: bool = False):
        super().__init__()
        self.n = n
        self.weight = weight
        if weight:
            self.w = nn.Parameter(-torch.arange(1.0, n) / 2)

    def forward(self, xs: Sequence[torch.Tensor]):
        y = xs[0]
        if self.weight:
            w = torch.sigmoid(self.w) * 2
            # JAX promotes a bf16 input times the float32 weight to
            # float32; torch would keep bf16 for a 0-dim weight
            dt = torch.promote_types(y.dtype, w.dtype)
            for i in range(self.n - 1):
                y = y + xs[i + 1].to(dt) * w[i]
        else:
            for i in range(self.n - 1):
                y = y + xs[i + 1]
        return y


class GhostConv(nn.Module):
    """Ghost convolution (reference models/experimental.py:47-57)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 act=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBN(c1, c_, k, s, g=g, act=act)
        self.cv2 = ConvBN(c_, c_, 5, 1, g=c_, act=act)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], dim=1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck (reference models/experimental.py:60-73): `conv`
    and `shortcut` are the reference's Sequentials."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(
            GhostConv(c1, c_, 1, 1),
            DWConvBN(c_, c_, k, s, act=False) if s == 2 else nn.Identity(),
            GhostConv(c_, c2, 1, 1, act=False))
        self.shortcut = nn.Sequential(
            DWConvBN(c1, c1, k, s, act=False),
            ConvBN(c1, c2, 1, 1, act=False)) if s == 2 else nn.Identity()

    def forward(self, x):
        return self.conv(x) + self.shortcut(x)


def mixconv_split(c2: int, groups: int) -> List[int]:
    """MixConv2d's output channels per kernel size (equal_ch grouping):
    the JAX package's floor(jnp.linspace(0, groups - 1e-6, c2)) counted
    per group, computed in float32 as jnp.linspace does (start (1 - t) +
    stop t with t = i / (c2 - 1), the last point the stop itself); a
    float64 linspace puts some boundary channels in another group."""
    stop = np.float32(groups - 1e-6)
    if c2 > 1:
        t = np.arange(c2 - 1, dtype=np.float32) / np.float32(c2 - 1)
        pts = np.concatenate([np.float32(0) * (np.float32(1) - t) + stop * t,
                              [stop]]).astype(np.float32)
    else:
        pts = np.zeros(c2, np.float32)
    idx = np.floor(pts)
    return [int((idx == g).sum()) for g in range(groups)]


class MixConv2d(nn.Module):
    """Mixed-kernel conv with a residual (reference
    models/experimental.py:76-95, equal_ch grouping): one bias-free conv
    per kernel size over the whole input, concatenated, BN, ReLU, plus
    the input."""

    def __init__(self, c1: int, c2: int, k: Tuple[int, ...] = (1, 3),
                 s: int = 1):
        super().__init__()
        c_ = mixconv_split(c2, len(k))
        self.m = nn.ModuleList(
            Conv2d(c1, c_[g], kk, s, kk // 2, bias=False)
            for g, kk in enumerate(k))
        self.bn = batch_norm(c2)

    def forward(self, x):
        y = torch.cat([m(x) for m in self.m], dim=1)
        return x + F.relu(self.bn(y))


class MultiheadOut(nn.Module):
    """The part of the reference's nn.MultiheadAttention that the JAX
    TransformerLayer computes: its output projection `out_proj`."""

    def __init__(self, c: int):
        super().__init__()
        self.out_proj = Linear(c, c)

    def forward(self, x):
        return self.out_proj(x)


class TransformerLayer(nn.Module):
    """ViT layer without layernorm (reference models/common.py:107-121), as
    the JAX package computes it: q, k, v projections, heads split, softmax
    attention, `ma.out_proj`, residual, fc1, fc2, residual. Plain tensor
    arithmetic on (seq, batch, c), as in JAX (no fused attention
    kernel)."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q = Linear(c, c, bias=False)
        self.k = Linear(c, c, bias=False)
        self.v = Linear(c, c, bias=False)
        self.ma = MultiheadOut(c)
        self.fc1 = Linear(c, c, bias=False)
        self.fc2 = Linear(c, c, bias=False)

    def forward(self, x):
        seq, b, c = x.shape
        hd = c // self.num_heads

        def split(t):
            return t.reshape(seq, b * self.num_heads, hd).transpose(0, 1)

        qh, kh, vh = split(self.q(x)), split(self.k(x)), split(self.v(x))
        attn = torch.softmax(qh @ kh.transpose(1, 2) / math.sqrt(hd), dim=-1)
        out = (attn @ vh).transpose(0, 1).reshape(seq, b, c)
        x = self.ma(out) + x
        return self.fc2(self.fc1(x)) + x


class TransformerBlock(nn.Module):
    """ViT block over a feature map (reference models/common.py:124-150):
    the map's pixels in (h, w) order as tokens, a learned linear
    embedding added, `num_layers` TransformerLayers, and back."""

    def __init__(self, c1: int, c2: int, num_heads: int, num_layers: int):
        super().__init__()
        self.conv = ConvBN(c1, c2) if c1 != c2 else None
        self.linear = Linear(c2, c2)
        self.tr = nn.Sequential(*(TransformerLayer(c2, num_heads)
                                  for _ in range(num_layers)))
        self.c2 = c2

    def forward(self, x):
        if L.SPATIAL is not None:  # attention reads the whole plane
            return L.SPATIAL.global_op(self, x)
        if self.conv is not None:
            x = self.conv(x)
        b, _, h, w = x.shape
        p = x.flatten(2).permute(2, 0, 1)  # (h w, b, c)
        y = self.tr(p + self.linear(p))
        return y.permute(1, 2, 0).reshape(b, self.c2, h, w)


class C3TR(nn.Module):
    """C3 with a transformer block core (reference models/common.py:
    238-243): 4 heads, `n` layers."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c1, c_, 1, 1)
        self.cv3 = ConvBN(2 * c_, c2, 1)
        self.m = TransformerBlock(c_, c_, 4, n)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class BottleneckCSPF(nn.Module):
    """CSP variant without cv3 (reference models/common.py:185-201): the
    bare conv `cv2` and the bottleneck chain meet in one BatchNorm `bn`
    (a precomputed affine after models/fuse.fold_bn)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = Conv2d(c1, c_, 1, 1, bias=False)
        self.cv4 = ConvBN(2 * c_, c2, 1, 1)
        self.bn = batch_norm(2 * c_)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, 1.0)
                                 for _ in range(n)))

    def forward(self, x):
        y = torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1)
        return self.cv4(F.silu(self.bn(y)))


class BottleneckCSP2(nn.Module):
    """CSP2 variant (reference models/common.py:204-220): cv2 runs on cv1's
    output, and the concat feeds one BatchNorm `bn`."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False,
                 g: int = 1):
        super().__init__()
        c_ = int(c2)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = Conv2d(c_, c_, 1, 1, bias=False)
        self.cv3 = ConvBN(2 * c_, c2, 1, 1)
        self.bn = batch_norm(2 * c_)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, 1.0)
                                 for _ in range(n)))

    def forward(self, x):
        x1 = self.cv1(x)
        y = torch.cat([self.m(x1), self.cv2(x1)], dim=1)
        return self.cv3(F.silu(self.bn(y)))


class SPPCSP(nn.Module):
    """CSP SPP whose cross path is a bare conv into a concat-fed
    BatchNorm (reference models/common.py:271-291)."""

    def __init__(self, c1: int, c2: int, e: float = 0.5,
                 k: Tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        c_ = int(2 * c2 * e)
        self.k = tuple(k)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = Conv2d(c1, c_, 1, 1, bias=False)
        self.cv3 = ConvBN(c_, c_, 3, 1)
        self.cv4 = ConvBN(c_, c_, 1, 1)
        self.cv5 = ConvBN((len(self.k) + 1) * c_, c_, 1, 1)
        self.cv6 = ConvBN(c_, c_, 3, 1)
        self.bn = batch_norm(2 * c_)
        self.cv7 = ConvBN(2 * c_, c2, 1, 1)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        pools = [max_pool(x1, kk, 1, kk // 2) for kk in self.k]
        y1 = self.cv6(self.cv5(torch.cat([x1] + pools, dim=1)))
        y = torch.cat([y1, self.cv2(x)], dim=1)
        return self.cv7(F.silu(self.bn(y)))


class ConvFocus(nn.Module):
    """Conv-based focus stem (reference models/common.py:366-381): a 3x3
    stride-2 conv to 4 c1 channels, then a k x k conv."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, act=True):
        super().__init__()
        self.conv_slice = ConvBN(c1, 4 * c1, 3, 2, act=act)
        self.conv = ConvBN(4 * c1, c2, k, s, act=act)

    def forward(self, x):
        return self.conv(self.conv_slice(x))


def contract(x: torch.Tensor, gain: int = 2) -> torch.Tensor:
    """Space to channels (reference models/common.py:384-395): output
    channel (sh gain + sw) C + c takes the pixel at offset (sh, sw) of
    each gain x gain cell."""
    if L.SPATIAL is not None:
        return L.SPATIAL.fold(x, gain, lambda t: contract(t, gain))
    b, c, h, w = x.shape
    s = gain
    y = x.reshape(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(b, c * s * s, h // s, w // s)


def expand(x: torch.Tensor, gain: int = 2) -> torch.Tensor:
    """Channels to space (reference models/common.py:398-409), the inverse
    of `contract`."""
    if L.SPATIAL is not None:
        return L.SPATIAL.unfold(x, gain, lambda t: expand(t, gain),
                                x.shape[1] // gain ** 2)
    b, c, h, w = x.shape
    s = gain
    y = x.reshape(b, s, s, c // s ** 2, h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(b, c // s ** 2, h * s, w * s)


class Classify(nn.Module):
    """Classification head (reference models/common.py:729-739): global
    average pool of each input, concatenated, a k x k conv (with bias),
    flattened to (b, c2)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, autopad(k))

    def forward(self, x):
        if L.SPATIAL is not None:  # the pools read the whole plane
            return L.SPATIAL.global_op(self, x)
        xs = x if isinstance(x, (list, tuple)) else [x]
        z = torch.cat([v.mean(dim=(2, 3), keepdim=True) for v in xs], dim=1)
        return self.conv(z).flatten(1)


# ---------------------------------------------------------------------------
# alternative activations (reference utils/activations.py:9-98)
# ---------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def hardswish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


# the reference's MemoryEfficientMish differs only in its hand-written
# backward; autograd's is the same function
memory_efficient_mish = mish


class FReLU(nn.Module):
    """Funnel activation max(x, BN(depthwise conv(x))) (reference
    utils/activations.py:62-71)."""

    def __init__(self, c1: int, k: int = 3):
        super().__init__()
        self.conv = Conv2d(c1, c1, k, 1, k // 2, groups=c1, bias=False)
        self.bn = batch_norm(c1)

    def forward(self, x):
        return torch.maximum(x, self.bn(self.conv(x)))


def _acon(x, p1, p2, beta):
    dpx = (p1 - p2) * x
    return dpx * torch.sigmoid(beta * dpx) + p2 * x


class AconC(nn.Module):
    """ACON-C with learnable p1, p2 and beta, each (1, c1, 1, 1) (reference
    utils/activations.py:75-89). p1 and p2 are drawn from N(0, 1) with
    `generator` (a fixed seed without one), beta starts at 1."""

    def __init__(self, c1: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = _generator(generator)
        self.p1 = nn.Parameter(torch.randn(1, c1, 1, 1, generator=gen))
        self.p2 = nn.Parameter(torch.randn(1, c1, 1, 1, generator=gen))
        self.beta = nn.Parameter(torch.ones(1, c1, 1, 1))

    def forward(self, x):
        return _acon(x, self.p1, self.p2, self.beta)


class MetaAconC(nn.Module):
    """ACON-C whose beta comes from a squeeze-excite MLP of the input
    (reference utils/activations.py:92-98): 1x1 convs fc1 (c1 -> max(r,
    c1 // r)) and fc2 (back to c1), with biases; p1 and p2 as AconC's."""

    def __init__(self, c1: int, r: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c2 = max(r, c1 // r)
        gen = _generator(generator)
        self.p1 = nn.Parameter(torch.randn(1, c1, 1, 1, generator=gen))
        self.p2 = nn.Parameter(torch.randn(1, c1, 1, 1, generator=gen))
        self.fc1 = Conv2d(c1, c2, 1, 1)
        self.fc2 = Conv2d(c2, c1, 1, 1)

    def forward(self, x):
        if L.SPATIAL is not None:  # the mean reads the whole plane
            return L.SPATIAL.global_op(self, x)
        y = x.mean(dim=(2, 3), keepdim=True)
        beta = torch.sigmoid(self.fc2(self.fc1(y)))
        return _acon(x, self.p1, self.p2, beta)


# modules whose own parameters stay float32 in a bf16 model: the JAX
# modules take no dtype, so their float32 parameters promote
FLOAT32_PARAMS = (Sum, AconC, MetaAconC)
