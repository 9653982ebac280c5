"""The graph-executing model: runs a ModelSpec's node list with
from-routing, ending in the detection head.

Counterpart of the JAX package's models/model.py (and of the reference
models/yolo.py Model.forward_once). The top-level modules live in
`self.model` as an nn.ModuleList, so state-dict keys read
`model.{i}.<submodule>...` exactly as in the reference checkpoints.

The executor builds every op of the JAX package's models/model.py: the
blocks of its layers.py and layers_extra.py (models/layers_extra.py), the
stateless ops (Contract and Expand among them) and `Sum`, whose weights
live at `model.{i}.w`. A repeated node (n > 1 after the depth multiple)
is an nn.Sequential of its blocks, keys `model.{i}.{j}.*`. An op that
neither package knows raises NotImplementedError naming it.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from face_detection_multi_scale_tpu_torch.models import layers as L
from face_detection_multi_scale_tpu_torch.models import layers_extra as LX
from face_detection_multi_scale_tpu_torch.models.head import (
    DetectionHead, det_bias_prior, reshape_level)
from face_detection_multi_scale_tpu_torch.models.spec import (
    HEAD_OPS, ModelSpec, Node)


@contextlib.contextmanager
def full_fp32():
    """cuDNN convolutions in full float32 (its default is TF32, about
    three decimal digits); restores the previous setting on exit."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def resolve_act(spec: ModelSpec, node_args, default=True):
    """Effective activation for a node: a trailing string activation arg
    (tiny cfg rows) or the model-level override (models/yolo.py:502-504)."""
    if node_args and isinstance(node_args[-1], str) and \
            node_args[-1] in ("leaky", "relu", "silu", "none"):
        return node_args[-1]
    if spec.act is not None:
        return spec.act
    return default


def build_node_block(spec: ModelSpec, node: Node) -> nn.Module:
    """The torch module for one parametric node: one block, or an
    nn.Sequential of node.n_resolved blocks (a `Sum` is one, as in the JAX
    executor)."""
    if node.n_resolved > 1 and node.op != "Sum":
        return nn.Sequential(*(_build_block(spec, node)
                               for _ in range(node.n_resolved)))
    return _build_block(spec, node)


def _build_block(spec: ModelSpec, node: Node) -> nn.Module:
    op, args, c1, c2 = node.op, node.args, node.c1, node.c2
    if op == "Conv":
        k = args[1] if len(args) > 1 else 1
        k = tuple(int(v) for v in k) if isinstance(k, (list, tuple)) \
            else int(k)
        s = int(args[2]) if len(args) > 2 else 1
        p = args[3] if len(args) > 3 else None
        g = int(args[4]) if len(args) > 4 and not isinstance(args[4], str) \
            else 1
        return L.ConvBN(c1, c2, k, s, p=p, g=g, act=resolve_act(spec, args))
    if op == "DWConv":
        k = int(args[1]) if len(args) > 1 else 1
        s = int(args[2]) if len(args) > 2 else 1
        return L.DWConvBN(c1, c2, k, s, act=resolve_act(spec, args))
    if op == "SPPF":
        return L.SPPF(c1, c2, int(args[1]) if len(args) > 1 else 5)
    if op == "SPPCSPC":
        return L.SPPCSPC(c1, c2)
    if op == "SPPFCSPC":
        return L.SPPFCSPC(c1, c2)
    if op == "SPP":
        return L.SPP(c1, c2, tuple(args[1]) if len(args) > 1 else (3, 3, 3))
    if op == "StemBlock":
        k = int(args[1]) if len(args) > 1 else 3
        s = int(args[2]) if len(args) > 2 else 2
        return L.StemBlock(c1, c2, k, s)
    if op == "Shuffle_Block":
        return L.ShuffleBlock(c1, c2, int(args[1]))
    if op == "DWConvblock":
        return L.DWConvblock(c1, c2, int(args[1]), int(args[2]))
    if op == "conv_bn_relu_maxpool":
        return L.ConvBnReluMaxpool(c1, c2)
    if op == "Sum":
        # the JAX executor's Sum: n from the routing, `weight` from args[1]
        return LX.Sum(len(node.f), bool(args[1]) if len(args) > 1 else False)
    sc = bool(args[1]) if len(args) > 1 else True
    if op == "Bottleneck":
        return L.Bottleneck(c1, c2, sc, act=resolve_act(spec, args))
    if op == "C3":
        return L.C3(c1, c2, node.repeats, sc, act=resolve_act(spec, args))
    if op == "BottleneckCSP":
        return L.BottleneckCSP(c1, c2, node.repeats, sc)
    if op == "Focus":
        k = int(args[1]) if len(args) > 1 else 1
        return L.Focus(c1, c2, k, act=resolve_act(spec, args))

    def arg(i, default):
        return int(args[i]) if len(args) > i else default

    if op == "ConvFocus":
        return LX.ConvFocus(c1, c2, arg(1, 1), act=resolve_act(spec, args))
    if op == "CrossConv":
        return LX.CrossConv(c1, c2, arg(1, 3), arg(2, 1))
    if op == "GhostConv":
        return LX.GhostConv(c1, c2, arg(1, 1), arg(2, 1),
                            act=resolve_act(spec, args))
    if op == "GhostBottleneck":
        return LX.GhostBottleneck(c1, c2, arg(1, 3), arg(2, 1))
    if op == "MixConv2d":
        ks = tuple(int(v) for v in args[1]) if len(args) > 1 else (1, 3)
        return LX.MixConv2d(c1, c2, ks, arg(2, 1))
    if op == "C3TR":
        return LX.C3TR(c1, c2, node.repeats)
    if op == "BottleneckCSPF":
        return LX.BottleneckCSPF(c1, c2, node.repeats, sc)
    if op == "BottleneckCSP2":
        return LX.BottleneckCSP2(c1, c2, node.repeats)
    if op == "SPPCSP":
        return LX.SPPCSP(c1, c2)
    raise NotImplementedError(f"op {op!r}")


STATELESS_OPS = {"Concat", "ADD", "Upsample", "ZeroPad2d", "MaxPool2d",
                 "MP", "SP", "SPF", "ReOrg", "Contract", "Expand"}


def apply_stateless_op(op: str, args, inp):
    """Execute one parameter-free graph op on NCHW tensors. `inp` is the
    routed input (a list for multi-input ops)."""
    if op == "Concat":
        return torch.cat(inp, dim=1)
    if op == "ADD":
        # torch.add(x1, x2, alpha): the lite cfgs pass alpha 1; the
        # reference class default 0.5 is never used by a face cfg
        alpha = float(args[0]) if args else 0.5
        return inp[0] + alpha * inp[1]
    if op == "Upsample":
        return L.upsample2x_nearest(inp)
    if op == "ZeroPad2d":
        # torch padding order (left, right, top, bottom)
        return F.pad(inp, tuple(int(v) for v in args[0]))
    if op == "MaxPool2d":
        k = int(args[0])
        s = int(args[1]) if len(args) > 1 else k
        p = int(args[2]) if len(args) > 2 else 0
        return L.max_pool(inp, k, s, p)
    if op == "MP":
        k = int(args[0]) if args else 2
        return L.max_pool(inp, k, k, 0)
    if op == "SP":
        k = int(args[0]) if args else 3
        s = int(args[1]) if len(args) > 1 else 1
        return L.max_pool(inp, k, s, k // 2)
    if op == "SPF":
        return L.SPF(int(args[0]) if args else 3)(inp)
    if op == "ReOrg":
        return L.reorg(inp)
    if op == "Contract":
        return LX.contract(inp, int(args[0]) if args else 2)
    if op == "Expand":
        return LX.expand(inp, int(args[0]) if args else 2)
    raise NotImplementedError(f"stateless op {op!r}")


class Stateless(nn.Module):
    """A parameter-free node, kept as a module so that node i is
    `self.model[i]` for every i, as in the reference."""

    def __init__(self, node: Node):
        super().__init__()
        self.op, self.args = node.op, node.args

    def forward(self, inp):
        return apply_stateless_op(self.op, self.args, inp)


class YoloFace(nn.Module):
    """YOLOv7-face model over a resolved ModelSpec.

    forward takes float NHWC images (the JAX package's layout), runs NCHW
    inside and returns the per-level raw maps as (bs, na, ny, nx, no), the
    training-mode output contract of the reference head
    (models/yolo.py:273-274). `models.head.decode` gives inference rows.

    `dtype` is the compute dtype, the JAX `YoloFace(dtype=)`: with
    bfloat16 every conv computes in bf16 on float32 parameters (mixed
    precision, `layers.Conv2d`), every BatchNorm takes float32 statistics
    and returns bf16, and the implicit priors stay float32. The
    parameters, their gradients and the BN running statistics stay
    float32, so the trainer, the EMA model and `validate` run a bf16
    model with no dtype argument of their own. float32 (the default)
    computes in the parameters' dtype.
    """

    def __init__(self, spec: ModelSpec, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = spec.resolve()
        mods = []
        for node in self.spec.nodes:
            if node.op in HEAD_OPS:
                variant = {"Detect": "detect", "IDetect": "idetect",
                           "IKeypoint": "ikeypoint"}[node.op]
                mods.append(DetectionHead(self.spec, variant,
                                          self.spec.head_in_ch))
            elif node.op in STATELESS_OPS:
                mods.append(Stateless(node))
            else:
                mods.append(build_node_block(self.spec, node))
        self.model = nn.ModuleList(mods)
        self._save = set(self.spec.save)
        self.compute_dtype = None if dtype == torch.float32 else dtype
        for mod in self.modules():
            if isinstance(mod, (L.Conv2d, LX.Linear)):
                mod.compute_dtype = self.compute_dtype

    def forward(self, x: torch.Tensor,
                reshape_heads: bool = True) -> List[torch.Tensor]:
        """With `reshape_heads=False` each level comes back in the JAX
        conv layout (bs, ny, nx, na*no) (a view of the NCHW map), the
        input of ops/nms.non_max_suppression_from_raws."""
        spec = self.spec
        x = x.permute(0, 3, 1, 2)
        saved: List[Optional[torch.Tensor]] = []
        for i, (node, m) in enumerate(zip(spec.nodes, self.model)):
            if isinstance(node.f, int):
                inp = x if node.f == i - 1 else saved[node.f]
            else:
                inp = [x if j == i - 1 else saved[j] for j in node.f]
            if node.op in HEAD_OPS:
                return head_output(m(inp), spec, reshape_heads)
            x = m(inp)
            saved.append(x if i in self._save else None)
        raise RuntimeError("spec has no detection head as its last node")


def head_output(raws: List[torch.Tensor], spec: ModelSpec,
                reshape_heads: bool) -> List[torch.Tensor]:
    """The head's NCHW maps as the forward returns them: (bs, na, ny, nx,
    no) per level, or with `reshape_heads=False` the JAX conv layout
    (bs, ny, nx, na*no)."""
    if not reshape_heads:
        return [r.permute(0, 2, 3, 1) for r in raws]
    return [reshape_level(r, spec.na, spec.no) for r in raws]


def compute_strides(spec: ModelSpec, img_size: int = 128
                    ) -> Tuple[int, ...]:
    """Derive the per-level strides from a shape-only forward on the meta
    device (no weights, no arithmetic; the reference's stride computation,
    models/yolo.py:345, and the JAX `compute_strides`) and write them back
    into `spec`. A cfg whose pyramid does not start at P3 (a P4/P5 head)
    needs it: the cfg parser assumes (8, 16, 32, ...)."""
    spec.resolve()
    with torch.device("meta"):
        raws = YoloFace(spec)(torch.zeros(1, img_size, img_size,
                                          spec.in_ch))
    spec.strides = tuple(img_size // r.shape[2] for r in raws)
    return spec.strides


def cast_model(model: YoloFace, dtype: torch.dtype) -> YoloFace:
    """Cast a (BN-folded) model to `dtype` in place as the JAX
    `YoloFace(dtype=)` computes: every conv, its bias and the decode's
    input in `dtype`, except the head's implicit priors, which the JAX
    package keeps float32 (ImplicitA/ImplicitM take no dtype). So in
    bf16 an implicit head's det conv sees bf16(x + ia), its output times
    im is float32, the concatenated raw maps are float32, and the decode
    runs in float32; the kpt channels carry bf16 values. A plain
    `Detect` head has no priors, so its raws and decode are bf16, as in
    the JAX package. Every BatchNorm left after the fold (the CSP blocks'
    and MixConv2d's concat-fed affines) computes in `dtype` too, and so
    does every Linear of a transformer block; `Sum`'s weights (and an ACON
    activation's p1, p2 and beta) stay float32, as the JAX modules take
    no dtype, so a bf16 weighted sum comes out float32. Returns `model`."""
    model.to(dtype)
    for mod in model.modules():
        if isinstance(mod, (L.ImplicitA, L.ImplicitM)):
            mod.float()
        elif isinstance(mod, LX.FLOAT32_PARAMS):
            for p in mod.parameters(recurse=False):
                p.data = p.data.float()
    return model


@torch.no_grad()
def init_weights(model: YoloFace, generator: torch.Generator) -> YoloFace:
    """Seeded random init that follows the JAX init where it matters:
    conv and linear kernels lecun-normal (flax's default: truncated
    normal, fan-in variance), their biases zero except the head's
    det-bias priors, BN at identity statistics, ImplicitA ~ N(0, 0.02)
    and ImplicitM ~ 1 + N(0, 0.02), an ACON activation's p1 and p2 ~ N(0,
    1); `Sum`'s weights keep their fixed start. Draws come from
    `generator` on the CPU, so the same seed gives the same weights on
    every device."""
    for mod in model.modules():
        if isinstance(mod, (LX.AconC, LX.MetaAconC)):
            for p in (mod.p1, mod.p2):
                p.copy_(torch.randn(p.shape, generator=generator))
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = torch.empty(mod.weight.shape)
            fan_in = w[0].numel()
            # flax lecun_normal: truncated to +-2 std, rescaled so the
            # truncated distribution keeps variance 1/fan_in
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            mod.weight.copy_(w * (math.sqrt(1.0 / fan_in)
                                  / .87962566103423978))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, L.ImplicitA):
            mod.implicit.copy_(torch.empty(mod.implicit.shape).normal_(
                0.0, 0.02, generator=generator))
        elif isinstance(mod, L.ImplicitM):
            mod.implicit.copy_(1.0 + torch.empty(mod.implicit.shape).normal_(
                0.0, 0.02, generator=generator))
    head = model.model[-1]
    for lvl, conv in enumerate(head.m):
        conv.bias.copy_(det_bias_prior(model.spec, lvl))
    return model
