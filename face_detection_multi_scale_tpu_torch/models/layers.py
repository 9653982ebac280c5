"""Building blocks of the YOLOv7-face model family as torch modules.

Counterpart of the JAX package's models/layers.py, every module of it.
The JAX modules are NHWC; these run NCHW, PyTorch's native layout, and
the model's public functions convert at the boundary. Submodule names
follow the reference PyTorch module paths (`conv`, `bn`, `cv1`..`cv7`,
`m`, `stem_1`, `conv1`/`bn1`, `branch1`/`branch2` as Sequentials,
`implicit`), so a reference state dict loads by name. Every BatchNorm
has eps 1e-3.

Parity targets (reference file:line):
  Conv/DWConv            models/common.py:85-105
  MP/SP/SPF              models/common.py:28-52
  ImplicitA/ImplicitM    models/common.py:55-74
  ReOrg                  models/common.py:77-82
  SPPF                   models/common.py:335-348
  SPPCSPC                models/common.py:294-312
  SPPFCSPC               models/common.py:314-333
  StemBlock              models/common.py:422-437
  DWConvblock            models/common.py:452-471
  Shuffle_Block          models/common.py:483-539
  Bottleneck/C3/CSP fam  models/common.py:153-243
  Focus                  models/common.py:350-364
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# every BatchNorm of the model family (torch YOLO convention; the JAX
# package's layers.py uses the same eps, not torch's default 1e-5)
BN_EPS = 1e-3
BN_MOMENTUM = 0.03

# the spatial forward's hook (parallel/spatial.py sets it for the length of
# a forward over one rank's block of the plane, and clears it): the
# geometric ops below (Conv2d, max_pool, upsample2x_nearest, reorg, Focus's
# space to depth, zero_pad, and layers_extra's contract, expand and global
# ops) hand it their input. None: the one-process ops.
SPATIAL = None


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


def max_pool(x: torch.Tensor, k: int, s: int, p: int = 0,
             ceil_mode: bool = False) -> torch.Tensor:
    """NCHW max pool with torch.nn.MaxPool2d(k, s, p, ceil_mode)
    semantics (padding counts as -inf), the JAX package's `max_pool`."""
    if SPATIAL is not None:
        return SPATIAL.max_pool(x, k, s, p, ceil_mode)
    return F.max_pool2d(x, k, s, p, ceil_mode=ceil_mode)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (nn.Upsample(scale_factor=2))."""
    if SPATIAL is not None:
        return SPATIAL.unfold(x, 2, upsample2x_nearest, x.shape[1])
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def reorg(x: torch.Tensor) -> torch.Tensor:
    """Space-to-depth 2x2 with the reference ReOrg channel order
    [(0,0), (1,0), (0,1), (1,1)] over (h, w) offsets."""
    if SPATIAL is not None:
        return SPATIAL.fold(x, 2, reorg)
    return torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                      x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=1)


def zero_pad(x: torch.Tensor, pads) -> torch.Tensor:
    """nn.ZeroPad2d: `pads` in torch order (left, right, top, bottom)."""
    if SPATIAL is not None:
        return SPATIAL.zero_pad(x, pads)
    return F.pad(x, tuple(pads))


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """ShuffleNet channel shuffle (reference models/common.py:483-492):
    NCHW viewed as (b, groups, c / groups, h, w), dims 1-2 swapped."""
    b, c, h, w = x.shape
    return x.reshape(b, groups, c // groups, h, w).transpose(1, 2).reshape(
        b, c, h, w)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `compute_dtype`, flax's `Conv(dtype=)`: the
    input, kernel and bias are cast to it, and the parameters keep their
    own dtype. A bf16 training model (`YoloFace(spec, dtype=bfloat16)`)
    so convolves in bf16 with float32 parameters, whose gradients come
    back float32 through the casts. None (the default) computes in the
    kernel's dtype: a float32, float64 or `cast_model`-cast model casts
    only its input, as flax's float32 Conv casts a bf16 input."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if SPATIAL is not None:
            return SPATIAL.conv2d(self, x)
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class BatchNorm(nn.BatchNorm2d):
    """nn.BatchNorm2d whose training forward follows flax's nn.BatchNorm,
    the JAX package's: normalise with the batch mean and biased variance
    and update the running statistics as
    `ra = (1 - momentum) * ra + momentum * batch_stat` with the *biased*
    variance, where torch's own BatchNorm folds in the unbiased one
    (n / (n - 1) larger). The eval forward (the running statistics), the
    parameters and the state-dict keys are nn.BatchNorm2d's.

    The batch statistics come from the normalising F.batch_norm call
    itself (momentum 1 into fresh float32 vectors: the batch mean and the
    unbiased variance), so the map is read once. A bf16 map (a bf16
    training model) is so normalised as flax's `BatchNorm(dtype=
    bfloat16)` does it: float32 batch statistics (flax's
    `force_float32_reductions`), float32 running statistics, and a bf16
    output (F.batch_norm with a bf16 input and float32 parameters
    normalises in float32 and rounds once).

    Under a data mesh (`set_batchnorm_mesh`) the training forward takes
    the statistics of the global batch, SyncBN's semantics and what XLA
    computes for the JAX package over its mesh (`_GlobalBatchNorm`: one
    collective forward, one backward); the running statistics take the
    biased variance, as without a mesh (nn.SyncBatchNorm's would take
    the unbiased one). The variance is computed from each rank's centred
    sums, not as flax's float32 E[x^2] - E[x]^2, whose cancellation
    moves a random model's float32 gradients further from the exact ones
    than the one-process step's."""

    # a parallel.mesh.DataMesh with a process group: global batch
    # statistics; None: this process's batch
    mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.mesh is not None:
            return self._forward_mesh(x)
        stat = torch.promote_types(self.running_mean.dtype, torch.float32)
        mean = torch.zeros(self.num_features, dtype=stat, device=x.device)
        var = torch.ones(self.num_features, dtype=stat, device=x.device)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        with torch.no_grad():
            n = x.numel() // x.shape[1]
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean, alpha=self.momentum)
            # var is the unbiased batch variance: back to the biased one
            self.running_var.mul_(keep).add_(
                var, alpha=self.momentum * (n - 1) / n)
            self.num_batches_tracked.add_(1)
        return y

    def _forward_mesh(self, x: torch.Tensor) -> torch.Tensor:
        stat = torch.promote_types(self.running_mean.dtype, torch.float32)
        y, mean, var = _GlobalBatchNorm.apply(
            x.to(stat), self.weight, self.bias, self.mesh, self.eps)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean, alpha=self.momentum)
            self.running_var.mul_(keep).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


class _GlobalBatchNorm(torch.autograd.Function):
    """Batch norm over a data mesh's global batch, SyncBN's algorithm in
    plain torch: the forward combines each rank's mean and centred sum of
    squares (Chan et al.; one collective of every rank's pair) into the
    global mean and biased variance; the backward is batch norm's own
    gradient, dx = w / sigma (dy - mean(dy) - x_hat mean(dy x_hat)) with
    the two means over the global batch (one collective). The weight and
    bias gradients are this rank's sums, which the trainer sums over the
    mesh with every other gradient. Every rank holds as many rows."""

    @staticmethod
    def forward(ctx, x, weight, bias, mesh, eps):
        c = x.shape[1]
        shape = (1, c, 1, 1)
        n = x.numel() // c
        mean_r = x.mean((0, 2, 3))
        local = torch.stack([mean_r, (x - mean_r.reshape(shape)).square()
                             .sum((0, 2, 3))])
        every = mesh.all_reduce(torch.stack([
            local if r == mesh.rank else torch.zeros_like(local)
            for r in range(mesh.size)]))
        means = every[:, 0]
        mean = means.mean(0)
        var = (every[:, 1].sum(0) + n * (means - mean).square().sum(0)) / (
            n * mesh.size)
        invstd = torch.rsqrt(var + eps)
        x_hat = (x - mean.reshape(shape)) * invstd.reshape(shape)
        ctx.save_for_backward(x_hat, weight, invstd)
        ctx.mesh, ctx.count = mesh, n * mesh.size
        ctx.mark_non_differentiable(mean, var)
        return (x_hat * weight.reshape(shape) + bias.reshape(shape), mean,
                var)

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x_hat, weight, invstd = ctx.saved_tensors
        c = x_hat.shape[1]
        shape = (1, c, 1, 1)
        sum_dy = dy.sum((0, 2, 3))
        sum_dy_xhat = (dy * x_hat).sum((0, 2, 3))
        total = ctx.mesh.all_reduce(torch.cat([sum_dy, sum_dy_xhat]))
        dx = (dy - (total[:c] / ctx.count).reshape(shape)
              - x_hat * (total[c:] / ctx.count).reshape(shape)) * (
                  invstd * weight).reshape(shape)
        return dx, sum_dy_xhat, sum_dy, None, None


def set_batchnorm_mesh(model: nn.Module, mesh) -> nn.Module:
    """Give every BatchNorm of `model` the data mesh `mesh` (one with a
    process group, parallel.mesh.active_mesh; None: back to this
    process's batch statistics); returns `model`."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh
    return model


def batch_norm(c: int) -> BatchNorm:
    """The model family's BatchNorm (eps 1e-3, momentum 0.03)."""
    return BatchNorm(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class ConvBN(nn.Module):
    """conv2d(bias=False) + BatchNorm(eps=1e-3) + activation == reference
    `Conv`. `models/fuse.fold_bn` folds the BN into the conv for serving
    and replaces `bn` with an identity."""

    def __init__(self, c1: int, c2: int, k=1, s: int = 1, p=None, g: int = 1,
                 act=True):
        super().__init__()
        k = tuple(k) if isinstance(k, (tuple, list)) else (k, k)
        pad = tuple(p) if isinstance(p, (tuple, list)) else \
            tuple(autopad(kk, p) for kk in k)
        self.conv = Conv2d(c1, c2, k, s, pad, groups=g, bias=False)
        self.bn = batch_norm(c2)
        self.act = act_fn(act)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


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


class SPF(nn.Module):
    """Stacked 3x3 stride-s max pools equivalent to a k x k pool
    (reference models/common.py:45-52)."""

    def __init__(self, k: int = 3, s: int = 1):
        super().__init__()
        self.k, self.s = k, s

    def forward(self, x):
        for _ in range((self.k - 1) // 2):
            x = max_pool(x, 3, self.s, 1)
        return x


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast (reference models/common.py:335-348)."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(4 * c_, c2, 1, 1)

    def forward(self, x):
        x = self.cv1(x)
        y1 = max_pool(x, self.k, 1, self.k // 2)
        y2 = max_pool(y1, self.k, 1, self.k // 2)
        y3 = max_pool(y2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


class SPPFCSPC(nn.Module):
    """CSP SPP with sequential (fast) pools (reference
    models/common.py:314-333)."""

    def __init__(self, c1: int, c2: int, e: float = 0.5, k: int = 5):
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
        x2 = max_pool(x1, self.k, 1, self.k // 2)
        x3 = max_pool(x2, self.k, 1, self.k // 2)
        x4 = max_pool(x3, self.k, 1, self.k // 2)
        y1 = self.cv6(self.cv5(torch.cat([x1, x2, x3, x4], dim=1)))
        return self.cv7(torch.cat([y1, self.cv2(x)], dim=1))


class SPP(nn.Module):
    """Classic SPP, each k x k pool as stacked 3x3 pools (reference
    models/common.py:246-268)."""

    def __init__(self, c1: int, c2: int, k: Tuple[int, ...] = (3, 3, 3)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c_ * (len(self.k) + 1), c2, 1, 1)

    def forward(self, x):
        x = self.cv1(x)
        outs = [x]
        for pk in self.k:
            y = x
            for _ in range(1 + (pk - 3) // 2):
                y = max_pool(y, 3, 1, 1)
            outs.append(y)
        return self.cv2(torch.cat(outs, dim=1))


class StemBlock(nn.Module):
    """PeleeNet-style stem (reference models/common.py:422-437)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2):
        super().__init__()
        self.stem_1 = ConvBN(c1, c2, k, s)
        self.stem_2a = ConvBN(c2, c2 // 2, 1, 1, p=0)
        self.stem_2b = ConvBN(c2 // 2, c2, 3, 2, p=1)
        self.stem_3 = ConvBN(2 * c2, c2, 1, 1, p=0)

    def forward(self, x):
        s1 = self.stem_1(x)
        s2b = self.stem_2b(self.stem_2a(s1))
        s2p = max_pool(s1, 2, 2, 0, ceil_mode=True)
        return self.stem_3(torch.cat([s2b, s2p], dim=1))


class DWConvblock(nn.Module):
    """Depthwise + pointwise conv pair (reference models/common.py:452-471):
    conv1/bn1 depthwise k x k stride s, conv2/bn2 pointwise, SiLU after
    each."""

    def __init__(self, c1: int, c2: int, k: int, s: int):
        super().__init__()
        self.conv1 = Conv2d(c1, c1, k, s, k // 2, groups=c1, bias=False)
        self.bn1 = batch_norm(c1)
        self.conv2 = Conv2d(c1, c2, 1, 1, 0, bias=False)
        self.bn2 = batch_norm(c2)

    def forward(self, x):
        x = F.silu(self.bn1(self.conv1(x)))
        return F.silu(self.bn2(self.conv2(x)))


class ShuffleBlock(nn.Module):
    """ShuffleNetV2 unit (reference models/common.py:494-539). `branch1`
    and `branch2` are Sequentials with the reference's indices (convs,
    BNs and SiLUs); with stride 1, branch1 is empty and the input's two
    channel halves feed the identity and branch2."""

    def __init__(self, c1: int, c2: int, stride: int):
        super().__init__()
        self.stride = stride
        bf = c2 // 2
        if stride > 1:
            self.branch1 = nn.Sequential(
                Conv2d(c1, c1, 3, stride, 1, groups=c1, bias=False),
                batch_norm(c1),
                Conv2d(c1, bf, 1, 1, 0, bias=False),
                batch_norm(bf), nn.SiLU())
            c_in = c1
        else:
            self.branch1 = nn.Sequential()
            c_in = bf
        self.branch2 = nn.Sequential(
            Conv2d(c_in, bf, 1, 1, 0, bias=False), batch_norm(bf),
            nn.SiLU(),
            Conv2d(bf, bf, 3, stride, 1, groups=bf, bias=False),
            batch_norm(bf),
            Conv2d(bf, bf, 1, 1, 0, bias=False), batch_norm(bf),
            nn.SiLU())

    def forward(self, x):
        if self.stride > 1:
            b1, x2 = self.branch1(x), x
        else:
            b1, x2 = x.chunk(2, dim=1)
        return channel_shuffle(torch.cat([b1, self.branch2(x2)], dim=1), 2)


class ConvBnReluMaxpool(nn.Module):
    """3x3/2 conv + BN + SiLU, then a 3x3/2 max pool (reference
    models/common.py:439-450); `conv` is a Sequential (conv.0, conv.1)."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.conv = nn.Sequential(Conv2d(c1, c2, 3, 2, 1, bias=False),
                                  batch_norm(c2), nn.SiLU())

    def forward(self, x):
        return max_pool(self.conv(x), 3, 2, 1)


class Bottleneck(nn.Module):
    """Standard bottleneck (reference models/common.py:153-163)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, act=True):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1, 1, act=act)
        self.cv2 = ConvBN(c_, c2, 3, 1, g=g, act=act)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs (reference models/common.py:223-235)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5, act=True):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1, 1, act=act)
        self.cv2 = ConvBN(c1, c_, 1, 1, act=act)
        self.cv3 = ConvBN(2 * c_, c2, 1, act=act)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, 1.0, act=act)
                                 for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class BottleneckCSP(nn.Module):
    """CSP bottleneck (reference models/common.py:166-182): cv2 and cv3
    are bare convs whose concat feeds one BatchNorm `bn` (a precomputed
    affine after models/fuse.fold_bn)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = Conv2d(c1, c_, 1, 1, bias=False)
        self.cv3 = Conv2d(c_, c_, 1, 1, bias=False)
        self.cv4 = ConvBN(2 * c_, c2, 1, 1)
        self.bn = batch_norm(2 * c_)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, 1.0)
                                 for _ in range(n)))

    def forward(self, x):
        y1 = self.cv3(self.m(self.cv1(x)))
        y2 = self.cv2(x)
        return self.cv4(F.silu(self.bn(torch.cat([y1, y2], dim=1))))


class Focus(nn.Module):
    """Space-to-depth stem (reference models/common.py:350-364), with the
    JAX package's channel order: channel (2 sh + sw) * C + c takes the
    pixel at offset (sh, sw) of each 2 x 2 cell."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, act=True):
        super().__init__()
        self.conv = ConvBN(4 * c1, c2, k, s, act=act)

    def forward(self, x):
        return self.conv(focus_fold(x))


def focus_fold(x: torch.Tensor) -> torch.Tensor:
    """Focus's space to depth: channel (2 sh + sw) C + c takes the pixel
    at offset (sh, sw) of each 2 x 2 cell."""
    if SPATIAL is not None:
        return SPATIAL.fold(x, 2, focus_fold)
    b, c, h, w = x.shape
    y = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(b, 4 * c, h // 2, w // 2)


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
