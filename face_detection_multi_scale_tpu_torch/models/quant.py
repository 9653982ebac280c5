"""W8A8 int8 serving: int8 weights and int8 activations between convs,
int32 accumulation, the requant folded into each conv's epilogue.

Counterpart of the JAX package's models/quant.py, whose tags it keeps as
the keys of the qparams, so the two compare key for key: `model_12`,
`model_12/cv1` (a ConvBN module), `model_3@conv1,bn1` (a raw conv / BN
leaf pair of a lite block), `model_{i}_{j}` (a repeated node) and
`model_{i}.add` (an ADD's requant).

Scheme (as in the JAX package):
  * per-output-channel symmetric weights, w_q = round(w_folded / s_w[c]),
    with the BN folded in float32 (`fold_by_tag`);
  * per-tensor symmetric activations, s_out = amax / 127 from a float32
    calibration walk, with the tensors that meet in a Concat or an ADD
    unified to one scale (union-find), so an int8 concat is exact;
    max pool, nearest upsample, ReOrg, channel split and shuffle keep
    their producer's scale;
  * each conv, fused: y32 = conv(x_q, w_q) in int32, z = act(y32 *
    alpha[c] + bias[c]) in float32 with alpha = s_in * s_w, x_q' =
    clip(round(z * inv_out), -127, 127) as int8. On the card that is one
    launch of the hand-written kernel (`qconv`, ops/qconv_kernel.py,
    csrc/qconv.cu); on the CPU its plain version;
  * the detection head runs in the detector's dtype on the dequantized
    inputs (the port's models/head.py module).

Activations flow NHWC (channels last), as in the JAX package: a concat
is along the last axis. Weights are kept OHWI (Cout, kh, kw, Cin/groups),
the kernel's layout. The qparams are plain tensors:
{"convs": {tag: {"w", "alpha", "bias", "inv_out"}}, "adds": {tag: ratio},
"head_scales": (n_levels,)}; `qparams_from_jax` carries the JAX package's
qparams across.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from face_detection_multi_scale_tpu_torch.models import layers as L
from face_detection_multi_scale_tpu_torch.models.convert import (
    _split_component)
from face_detection_multi_scale_tpu_torch.models.model import (
    apply_stateless_op, full_fp32, head_output, resolve_act)
from face_detection_multi_scale_tpu_torch.models.spec import (
    HEAD_OPS, ModelSpec, Node)
from face_detection_multi_scale_tpu_torch.ops.qconv_kernel import qconv

BN_EPS = 1e-3  # models/layers.py BatchNorm epsilon
S_IN = 1.0 / 127.0  # input image scale: x in [0, 1] -> x_q = round(127 x)


# ---------------------------------------------------------------------------
# BN folding by tag
# ---------------------------------------------------------------------------

def fold_by_tag(model: nn.Module, tag: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Effective (kernel OIHW float32, bias float32) of the conv `tag` of a
    YoloFace, with its BN folded in float32 as the JAX `fold_convbn`:
    g = scale * rsqrt(var + eps), (w * g, beta - mean * g). A BN already
    folded by models/fuse.fold_bn is an identity beside a conv with a
    bias, which is returned as it is. Two forms: "model_3/cv1" names a
    ConvBN module ({conv, bn}); "model_3@conv1,bn1" names a conv / BN
    pair of a lite block's own leaves. A component maps to module names by
    models/convert.py's rule (`model_12` -> `model.12`, `branch1_0` ->
    `branch1.0`, `stem_1` stays)."""
    if "@" in tag:
        base, pair = tag.split("@")
        ck, bk = pair.split(",")
        parent = model.get_submodule(".".join(
            _split_component(p) for p in base.split("/")))
        conv = parent.get_submodule(_split_component(ck))
        bn = parent.get_submodule(_split_component(bk))
    else:
        mod = model.get_submodule(".".join(
            _split_component(p) for p in tag.split("/")))
        conv, bn = mod.conv, mod.bn
    w = conv.weight.detach().float()
    if isinstance(bn, nn.BatchNorm2d):
        g = bn.weight.detach().float() * torch.rsqrt(
            bn.running_var.float() + BN_EPS)
        return (w * g.reshape(-1, 1, 1, 1),
                bn.bias.detach().float() - bn.running_mean.float() * g)
    if conv.bias is None:
        return w, torch.zeros(w.shape[0], device=w.device)
    return w, conv.bias.detach().float()


@dataclasses.dataclass(frozen=True)
class ConvDesc:
    """Static description of one ConvBN application inside the graph."""
    tag: str          # unique id, e.g. "model_12" or "model_47/cv3"
    k: Tuple[int, int]
    s: int
    pads: Tuple[Tuple[int, int], Tuple[int, int]]
    groups: int
    act: str


def _conv_desc(tag: str, k, s: int, p, g: int, act) -> ConvDesc:
    kk = tuple(int(v) for v in k) if isinstance(k, (tuple, list)) \
        else (int(k), int(k))
    if p is None:
        pads = tuple((v // 2, v // 2) for v in kk)
    elif isinstance(p, (tuple, list)):
        pads = tuple((int(v), int(v)) for v in p)
    else:
        pads = ((int(p), int(p)),) * 2
    if act is True:
        act = "silu"
    return ConvDesc(tag, kk, int(s), pads, int(g), act)


# ---------------------------------------------------------------------------
# NHWC stateless ops (int8 or float)
# ---------------------------------------------------------------------------

def _nchw_pool(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """An NCHW max pool of the port's layers on an NHWC tensor. int8 goes
    through float16, in which every int8 value is exact; the channels-last
    view pools without a transpose and comes back NHWC."""
    y = x.permute(0, 3, 1, 2)
    if not y.is_floating_point():
        y = y.to(torch.float16)
    return fn(y).to(x.dtype).permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor, k: int, s: int, p: int = 0,
             ceil_mode: bool = False) -> torch.Tensor:
    """NHWC max pool with torch.nn.MaxPool2d(k, s, p, ceil_mode)
    semantics."""
    return _nchw_pool(lambda y: L.max_pool(y, k, s, p, ceil_mode), x)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest-neighbour 2x upsample."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def reorg(x: torch.Tensor) -> torch.Tensor:
    """NHWC space-to-depth 2x2, the reference ReOrg channel order
    [(0,0), (1,0), (0,1), (1,1)] over (h, w) offsets."""
    return torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                      x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """NHWC ShuffleNet channel shuffle (the JAX `channel_shuffle`)."""
    b, h, w, c = x.shape
    return x.reshape(b, h, w, groups, c // groups).transpose(3, 4).reshape(
        b, h, w, c)


# ---------------------------------------------------------------------------
# the shared graph walker
# ---------------------------------------------------------------------------

# value flowing through the walk: (NHWC tensor, producing-scale tag)
Value = Tuple[torch.Tensor, str]


def _node_act(spec: ModelSpec, node: Node) -> str:
    act = resolve_act(spec, node.args)
    return "silu" if act is True else str(act)


def _walk(spec: ModelSpec, x: Value,
          conv: Callable[[ConvDesc, Value], Value],
          head: Callable[[int, Node, List[Value]], Any],
          on_concat: Optional[Callable[[List[str]], str]] = None,
          add: Optional[Callable[[int, float, List[Value]], Value]] = None):
    """Run the resolved node list with from-routing, dispatching every
    ConvBN through `conv` and the final head through `head` (the JAX
    `_walk`). Composite SPP / lite blocks are inlined so their internal
    tensors are quantization points of their own. `on_concat` unifies
    scale groups (calibration) or picks the representative tag (the
    quantized run). `add` handles the ADD node (i, alpha, inputs) ->
    Value; it owns the requant, since a sum exceeds the shared input
    scale's int8 range."""
    spec = spec.resolve()
    nodes = spec.nodes
    save = set(spec.save)
    saved: List[Optional[Value]] = []
    if on_concat is None:
        on_concat = lambda tags: tags[0]  # noqa: E731

    def cat(vals: List[Value]) -> Value:
        tag = on_concat([t for _, t in vals])
        return torch.cat([a for a, _ in vals], dim=-1), tag

    def conv_args(node: Node, tag: str) -> ConvDesc:
        a = node.args
        k = a[1] if len(a) > 1 else 1
        s = int(a[2]) if len(a) > 2 else 1
        p = a[3] if len(a) > 3 else None
        g = int(a[4]) if len(a) > 4 and not isinstance(a[4], str) else 1
        return _conv_desc(tag, k, s, p, g, _node_act(spec, node))

    def spp_csp(node: Node, i: int, v: Value, fast: bool) -> Value:
        # SPPFCSPC (models/common.py:314-333) / SPPCSPC (:294-312)
        act = _node_act(spec, node)
        t = f"model_{i}"
        cv = lambda n, k, w: conv(  # noqa: E731
            _conv_desc(f"{t}/{n}", k, 1, None, 1, act), w)
        x1 = cv("cv1", 1, v)
        x1 = cv("cv3", 3, x1)
        x1 = cv("cv4", 1, x1)
        if fast:
            k = 5
            p2 = (max_pool(x1[0], k, 1, k // 2), x1[1])
            p3 = (max_pool(p2[0], k, 1, k // 2), p2[1])
            p4 = (max_pool(p3[0], k, 1, k // 2), p3[1])
            y1 = cat([x1, p2, p3, p4])
        else:
            pools = [(max_pool(x1[0], k, 1, k // 2), x1[1])
                     for k in (5, 9, 13)]
            y1 = cat([x1] + pools)
        y1 = cv("cv5", 1, y1)
        y1 = cv("cv6", 3, y1)
        y2 = cv("cv2", 1, v)
        out = cat([y1, y2])
        return cv("cv7", 1, out)

    def sppf(node: Node, i: int, v: Value) -> Value:
        # SPPF (models/common.py:335-348)
        k = int(node.args[1]) if len(node.args) > 1 else 5
        act = _node_act(spec, node)
        t = f"model_{i}"
        x1 = conv(_conv_desc(f"{t}/cv1", 1, 1, None, 1, act), v)
        y1 = (max_pool(x1[0], k, 1, k // 2), x1[1])
        y2 = (max_pool(y1[0], k, 1, k // 2), y1[1])
        y3 = (max_pool(y2[0], k, 1, k // 2), y2[1])
        out = cat([x1, y1, y2, y3])
        return conv(_conv_desc(f"{t}/cv2", 1, 1, None, 1, act), out)

    def stem(node: Node, t: str, v: Value) -> Value:
        # StemBlock (models/common.py:422-437)
        k = int(node.args[1]) if len(node.args) > 1 else 3
        s = int(node.args[2]) if len(node.args) > 2 else 2
        s1 = conv(_conv_desc(f"{t}/stem_1", k, s, None, 1, "silu"), v)
        s2a = conv(_conv_desc(f"{t}/stem_2a", 1, 1, 0, 1, "silu"), s1)
        s2b = conv(_conv_desc(f"{t}/stem_2b", 3, 2, 1, 1, "silu"), s2a)
        s2p = (max_pool(s1[0], 2, 2, 0, ceil_mode=True), s1[1])
        out = cat([s2b, s2p])
        return conv(_conv_desc(f"{t}/stem_3", 1, 1, 0, 1, "silu"), out)

    def shuffle(node: Node, t: str, v: Value) -> Value:
        # ShuffleNetV2 unit (models/common.py:494-539): split and shuffle
        # are channel permutations that keep the per-tensor scale
        c1, c2 = node.c1, node.c2
        stride = int(node.args[1])
        bf = c2 // 2
        if stride > 1:
            b1 = conv(_conv_desc(f"{t}@branch1_0,branch1_1", 3, stride,
                                 1, c1, "none"), v)
            b1 = conv(_conv_desc(f"{t}@branch1_2,branch1_3", 1, 1, 0, 1,
                                 "silu"), b1)
            x2 = v
        else:
            b1 = (v[0][..., :bf], v[1])
            x2 = (v[0][..., bf:], v[1])
        b2 = conv(_conv_desc(f"{t}@branch2_0,branch2_1", 1, 1, 0, 1,
                             "silu"), x2)
        b2 = conv(_conv_desc(f"{t}@branch2_3,branch2_4", 3, stride, 1,
                             bf, "none"), b2)
        b2 = conv(_conv_desc(f"{t}@branch2_5,branch2_6", 1, 1, 0, 1,
                             "silu"), b2)
        out = cat([b1, b2])
        return (channel_shuffle(out[0], 2), out[1])

    def dwblock(node: Node, t: str, v: Value) -> Value:
        # DWConvblock (models/common.py:452-471): dw k x k then pw 1x1
        k = int(node.args[1])
        s = int(node.args[2])
        v = conv(_conv_desc(f"{t}@conv1,bn1", k, s, k // 2, node.c1,
                            "silu"), v)
        return conv(_conv_desc(f"{t}@conv2,bn2", 1, 1, 0, 1, "silu"), v)

    def cbrm(node: Node, t: str, v: Value) -> Value:
        # conv_bn_relu_maxpool (models/common.py:439-450): the activation
        # is silu despite the reference name
        v = conv(_conv_desc(f"{t}@conv_0,conv_1", 3, 2, 1, 1, "silu"), v)
        return (max_pool(v[0], 3, 2, 1), v[1])

    lite_blocks = {"StemBlock": stem, "Shuffle_Block": shuffle,
                   "DWConvblock": dwblock, "conv_bn_relu_maxpool": cbrm}

    for i, node in enumerate(nodes):
        if isinstance(node.f, int):
            inp = x if node.f == i - 1 else saved[node.f]
        else:
            inp = [x if j == i - 1 else saved[j] for j in node.f]

        op = node.op
        if op in HEAD_OPS:
            return head(i, node, inp)
        if op == "Conv":
            reps = node.n_resolved
            if reps > 1:
                v = inp
                for j in range(reps):
                    v = conv(conv_args(node, f"model_{i}_{j}"), v)
                x = v
            else:
                x = conv(conv_args(node, f"model_{i}"), inp)
        elif op == "DWConv":
            k = int(node.args[1]) if len(node.args) > 1 else 1
            s = int(node.args[2]) if len(node.args) > 2 else 1
            g = math.gcd(node.c1, node.c2)
            x = conv(_conv_desc(f"model_{i}", k, s, None, g,
                                _node_act(spec, node)), inp)
        elif op == "Concat":
            x = cat(inp)
        elif op == "ADD":
            alpha = float(node.args[0]) if node.args else 0.5
            if add is None:
                raise NotImplementedError(
                    "ADD requires the walk's `add` callback")
            x = add(i, alpha, inp)
        elif op == "Upsample":
            x = (upsample2x_nearest(inp[0]), inp[1])
        elif op == "ReOrg":
            x = (reorg(inp[0]), inp[1])
        elif op in ("MP", "SP", "SPF", "MaxPool2d"):
            arr = _nchw_pool(
                lambda y: apply_stateless_op(op, node.args, y), inp[0])
            x = (arr, inp[1])
        elif op == "SPPCSPC":
            x = spp_csp(node, i, inp, fast=False)
        elif op == "SPPFCSPC":
            x = spp_csp(node, i, inp, fast=True)
        elif op == "SPPF":
            x = sppf(node, i, inp)
        elif op in lite_blocks:
            # repeated blocks expand to model_{i}_{j} subtrees
            # (n_resolved, e.g. lite's stacked stride-1 Shuffle_Blocks)
            reps = node.n_resolved
            v = inp
            for j in range(reps):
                base = f"model_{i}_{j}" if reps > 1 else f"model_{i}"
                v = lite_blocks[op](node, base, v)
            x = v
        else:
            raise NotImplementedError(
                f"quantized executor does not support op {op!r}")
        saved.append(x if i in save else None)
    raise RuntimeError("spec has no detection head as its last node")


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

class _Unify:
    """Union-find over scale tags."""

    def __init__(self):
        self.parent: Dict[str, str] = {}

    def find(self, t: str) -> str:
        self.parent.setdefault(t, t)
        while self.parent[t] != t:
            self.parent[t] = self.parent[self.parent[t]]
            t = self.parent[t]
        return t

    def union(self, tags: Sequence[str]) -> str:
        root = self.find(tags[0])
        for t in tags[1:]:
            self.parent[self.find(t)] = root
        return root


@dataclasses.dataclass
class CalibResult:
    amax: Dict[str, float]          # per-tag activation |max| (grouped)
    in_tag: Dict[str, str]          # conv tag -> its input's scale tag
    groups: _Unify                  # tag unification
    head_in_tags: Tuple[str, ...]   # scale tags feeding the head
    add_in: Dict[str, str] = dataclasses.field(default_factory=dict)
    # ADD tag ("model_i.add") -> its (unified) input scale tag


def _conv_f32(desc: ConvDesc, x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """The float32 conv of one desc on NHWC x, OIHW w: act(conv + b), the
    JAX `_run_conv_f32`."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, None, desc.s,
                 (desc.pads[0][0], desc.pads[1][0]), 1, desc.groups)
    return L.act_fn(desc.act)(y + b.reshape(1, -1, 1, 1)).permute(0, 2, 3, 1)


@torch.inference_mode()
def _trace(spec: ModelSpec, model: nn.Module, x: torch.Tensor):
    """The float32 walk over `x` (NHWC, [0, 1]): (CalibResult without
    amax, the tags in walk order, each tag's max |y| as a 0-d tensor)."""
    uf = _Unify()
    order: List[str] = []
    stats: List[torch.Tensor] = []
    res = CalibResult(amax={}, in_tag={}, groups=uf, head_in_tags=())

    def conv(desc: ConvDesc, val: Value) -> Value:
        arr, src = val
        w, b = fold_by_tag(model, desc.tag)
        y = _conv_f32(desc, arr, w.to(arr.device), b.to(arr.device))
        res.in_tag[desc.tag] = src
        order.append(desc.tag)
        stats.append(y.abs().amax())
        return (y, desc.tag)

    def add(i, alpha, vals):
        src = uf.union([t for _, t in vals])
        y = vals[0][0] + alpha * vals[1][0]
        t = f"model_{i}.add"
        res.add_in[t] = src
        order.append(t)
        stats.append(y.abs().amax())
        return (y, t)

    def head(i, node, inp):
        res.head_in_tags = tuple(t for _, t in inp)

    with full_fp32():
        _walk(spec, (x.float(), "in"), conv, head,
              on_concat=lambda tags: uf.union(tags), add=add)
    return res, order, stats


def calibrate(spec: ModelSpec, model: nn.Module,
              x_calib: torch.Tensor) -> CalibResult:
    """Float32 walk over calibration images (cuDNN's TF32 off) recording
    each tensor's max |y|, grouped over unified tags; `x_calib` is (b, h,
    w, 3) float in [0, 1] on the model's device."""
    res, order, stats = _trace(spec, model, x_calib)
    amaxes = torch.stack(stats).float().cpu().tolist()
    # group-max over unified tags; "in" is the fixed input scale point
    grouped: Dict[str, float] = {}
    for t, v in zip(order, amaxes):
        r = res.groups.find(t)
        grouped[r] = max(grouped.get(r, 0.0), v)
    res.amax = {t: grouped[res.groups.find(t)] for t in order}
    return res


def calibrate_shape_only(spec: ModelSpec, model: nn.Module,
                         img_size: int = 64) -> CalibResult:
    """Structure-only calibration: the tag graph (in_tag map, concat
    unification, head tags) from a walk on the meta device (no compute,
    as `compute_strides`), every amax 1.0. Raises NotImplementedError for
    an op outside the executor. Scales are arbitrary but structurally
    valid: for measurement, never for accuracy."""
    res, order, _ = _trace(spec, model, torch.zeros(
        1, img_size, img_size, 3, device="meta"))
    res.amax = {t: 1.0 for t in order}
    return res


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def quantize(spec: ModelSpec, model: nn.Module, calib: CalibResult) -> Dict:
    """The runtime qparams from a calibration, on the model's device
    (each conv's `inv_out` on the host): {"convs": {tag: {"w": int8 OHWI,
    "alpha": f32 (C,), "bias": f32 (C,), "inv_out": f32 ()}}, "adds": {tag:
    f32 ()}, "head_scales": f32 (n_levels,)}. The head's weights stay in
    the model."""
    convs: Dict[str, Dict[str, torch.Tensor]] = {}

    def s_of(tag: str) -> float:
        if tag == "in":
            return S_IN
        return max(calib.amax[tag], 1e-12) / 127.0

    with torch.inference_mode():
        for tag, src in calib.in_tag.items():
            w, b = fold_by_tag(model, tag)
            s_w = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / 127.0
            w_q = torch.clamp(torch.round(w / s_w.reshape(-1, 1, 1, 1)),
                              -127, 127).to(torch.int8)
            convs[tag] = {
                "w": w_q.permute(0, 2, 3, 1).contiguous(),
                "alpha": s_w * s_of(src),
                "bias": b.clone(),  # not the model's own parameter
                # on the host: the kernel takes it as a launch argument,
                # which a device scalar would cost a sync a conv to read
                "inv_out": torch.tensor(1.0 / s_of(tag), dtype=torch.float32),
            }
        dev = next(iter(convs.values()))["w"].device
        head_scales = torch.tensor([s_of(t) for t in calib.head_in_tags],
                                   dtype=torch.float32, device=dev)
        # ADD outputs requant from the unified input scale to their own
        adds = {t: torch.tensor(s_of(src) / s_of(t), dtype=torch.float32,
                                device=dev)
                for t, src in calib.add_in.items()}
    return {"convs": convs, "adds": adds, "head_scales": head_scales}


def quantize_model(spec: ModelSpec, model: nn.Module,
                   x_calib: torch.Tensor) -> Dict:
    """Calibrate and quantize in one step; returns the qparams."""
    return quantize(spec, model, calibrate(spec, model, x_calib))


def qparams_from_jax(tree) -> Dict:
    """The JAX package's qparams (numpy-convertible arrays; its "head"
    entry, the float head weights, is left out: the port's head module
    holds them) -> the port's qparams on the CPU, int8 weights HWIO ->
    OHWI."""
    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.array(a)).to(dtype)

    return {
        "convs": {tag: {
            "w": t(np.transpose(np.asarray(q["w"]), (3, 0, 1, 2)),
                   torch.int8).contiguous(),
            "alpha": t(q["alpha"]), "bias": t(q["bias"]),
            "inv_out": t(q["inv_out"])}
            for tag, q in tree["convs"].items()},
        "adds": {tag: t(v) for tag, v in tree["adds"].items()},
        "head_scales": t(tree["head_scales"]),
    }


# ---------------------------------------------------------------------------
# quantized forward
# ---------------------------------------------------------------------------

@torch.inference_mode()
def quant_apply(spec: ModelSpec, qparams: Dict, x: torch.Tensor,
                head: nn.Module, reshape_heads: bool = True,
                dtype: torch.dtype = torch.bfloat16) -> List[torch.Tensor]:
    """W8A8 forward. `x` is (b, h, w, 3) float in [0, 1] (or uint8 0..255,
    divided here); `head` is the model's DetectionHead in `dtype`. Returns
    the per-level raw maps with the contract of YoloFace.forward: (bs, na,
    ny, nx, no), or with `reshape_heads=False` the conv layout (bs, ny,
    nx, na*no). Every conv is one `qconv` call: the kernel on the card,
    its plain version on the CPU."""
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    x_q = torch.clamp(torch.round(x.float() * 127.0), -127, 127).to(
        torch.int8)
    convs = qparams["convs"]

    def conv(desc: ConvDesc, v: Value) -> Value:
        q = convs[desc.tag]
        y = qconv(v[0].contiguous(), q["w"], q["alpha"], q["bias"],
                     q["inv_out"], stride=desc.s,
                     pads=(desc.pads[0][0], desc.pads[1][0]),
                     groups=desc.groups, act=desc.act)
        return (y, desc.tag)

    def add(i, alpha, vals):
        # the inputs share one scale (calibration unified them); the sum
        # is requanted to its own calibrated scale by the stored ratio
        t = f"model_{i}.add"
        y = (vals[0][0].float() + float(np.float32(alpha))
             * vals[1][0].float()) * qparams["adds"][t]
        return (torch.clamp(torch.round(y), -127, 127).to(torch.int8), t)

    def run_head(i, node, inp):
        scales = qparams["head_scales"]
        xs = [(arr.to(dtype) * scales[j].to(dtype)).permute(0, 3, 1, 2)
              for j, (arr, _) in enumerate(inp)]
        return head_output(head(xs), spec, reshape_heads)

    return _walk(spec, (x_q, "in"), conv, run_head, add=add)
