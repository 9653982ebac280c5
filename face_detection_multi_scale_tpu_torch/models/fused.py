"""Serving-graph executor with fused-ELAN blocks.

Counterpart of the JAX package's models/fused.py, with the same names. It
walks a YoloFace's resolved node list as `YoloFace.forward` does, but runs
each E-ELAN group (two 1x1 branches + a 3x3 chain + concat + 1x1
transition, reference cfg/yolov7-w6.yaml backbone and head groups) as one
`ops/elan_kernel.fused_elan` launch, which keeps every intermediate out of
the tensors the executor sees. Every node outside a group (the extra
blocks of models/layers_extra.py and `Sum` among them, as in the JAX
executor) runs through the same module `model.model[i]` that
`YoloFace.forward` runs, so `blocks=[]` is bit-identical to it.

Pattern contract (find_elan_blocks): a Concat of >= 3 tensors whose
members are exactly {the two sibling 1x1 convs, some of a consecutive 3x3
chain hanging off one of them}, followed by a 1x1 transition conv, with a
uniform supported activation, stride 1, groups 1, and no intermediate
consumed outside the group.

One difference from the JAX executor, by design: the JAX one leaves a
group unfused when its TPU VMEM plan finds no strip height
(`choose_strip_height` returns 0); this one fuses every block that
`find_elan_blocks` returns (the card's kernel falls back to a
block-private workspace instead), so at 640 px w6 makes 11 launches per
forward and tiny 8. Outputs agree within float32 tolerance either way.

bfloat16, as the JAX executor's `dtype=`: the model's modules in bf16 run
every node outside a group, and each group gets bf16 conv kernels with
float32 biases (`pack_elan_weights(..., dtype)`), packed from the
float32 folded model so that the biases are the JAX package's float32
ones (`elan_weights`, which the FaceDetector calls before it casts its
model). On the card a bf16 group whose shape the kernel's TMA route
takes gets a channels_last input and returns a channels_last output, so
cuDNN's convs between such groups run channels_last too; float32 groups
and the rest stay NCHW.

Inference only: the fused kernel has no backward.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from face_detection_multi_scale_tpu_torch.models.model import (
    YoloFace, head_output, resolve_act)
from face_detection_multi_scale_tpu_torch.models.spec import (
    HEAD_OPS, ModelSpec, Node)
from face_detection_multi_scale_tpu_torch.ops.elan_kernel import (
    ElanShape, ElanWeights, fused_elan, tma_shape_ok)


def apply_variant(shape: ElanShape, expr: str) -> ElanShape:
    """Apply a "+"-joined kernel-variant expression to an ElanShape, with
    the JAX package's grammar: taps | flat | im2col | im2col9 | ab | ct |
    nopad | gN | bN | relu ("flat_im2col" is accepted). The layout parts
    set their fields and change no numbers; relu sets the activation.
    The TPU ablation "nomask" is not ported and raises
    NotImplementedError."""
    shp = shape
    for part in expr.replace("flat_im2col", "flat+im2col").split("+"):
        if part == "taps":
            pass
        elif part == "im2col":
            shp = dataclasses.replace(shp, im2col=True)
        elif part == "flat":
            shp = dataclasses.replace(shp, flat_mm=True)
        elif part == "im2col9":
            shp = dataclasses.replace(shp, flat_mm=True, im2col9=True)
        elif part == "ab":
            shp = dataclasses.replace(shp, pack_ab=True)
        elif part == "ct":
            shp = dataclasses.replace(shp, flat_mm=True, concat_trans=True)
        elif part == "nopad":
            shp = dataclasses.replace(shp, host_pad=False)
        elif part.startswith("g") and part[1:].isdigit():
            shp = dataclasses.replace(shp, flat_mm=True, group=int(part[1:]))
        elif part.startswith("b") and part[1:].isdigit():
            shp = dataclasses.replace(shp, vmem_budget_mb=int(part[1:]))
        elif part == "relu":
            shp = dataclasses.replace(shp, act="relu")
        elif part == "nomask":
            raise NotImplementedError(
                "fused-ELAN variant part 'nomask' (the TPU ablation that "
                "skips the SAME-pad zeroing) is not ported")
        else:
            raise ValueError(f"unknown fused-ELAN variant part {part!r}")
    return shp


@dataclasses.dataclass(frozen=True)
class ElanBlock:
    """One fusable ELAN group located in a spec's node list."""
    a: int                    # route 1x1 conv node index
    b: int                    # chain-input 1x1 conv node index
    chain: Tuple[int, ...]    # consecutive 3x3 conv node indices
    concat: int               # Concat node index
    trans: int                # transition 1x1 conv node index
    shape: ElanShape
    pre: Optional[int] = None  # absorbed 3x3 feed conv, when shape.has_pre

    @property
    def start(self) -> int:
        first = min(self.a, self.b)
        return self.pre if self.pre is not None else first


def _norm_f(nodes: Sequence[Node], i: int) -> List[int]:
    f = nodes[i].f
    fs = [f] if isinstance(f, int) else list(f)
    return [i - 1 if s == -1 else s for s in fs]


def _act_name(spec: ModelSpec, node: Node) -> str:
    act = resolve_act(spec, node.args)
    return "silu" if act is True else str(act)


def _is_conv(node: Node, k: int, stride: int = 1) -> bool:
    if node.op != "Conv" or node.n_resolved != 1:
        return False
    args = node.args
    kk = args[1] if len(args) > 1 else 1
    if isinstance(kk, (list, tuple)):
        return False
    s = int(args[2]) if len(args) > 2 else 1
    p = args[3] if len(args) > 3 else None
    g = int(args[4]) if len(args) > 4 and not isinstance(args[4], str) else 1
    return int(kk) == k and s == stride and g == 1 and p is None


def find_elan_blocks(spec: ModelSpec,
                     absorb_pre: bool = False) -> List[ElanBlock]:
    """Locate every fusable ELAN group in a resolved spec.

    With `absorb_pre`, a 3x3 stride-1/2 Conv that feeds ONLY the group's
    two 1x1s (the backbone downsample preceding each E-ELAN, reference
    cfg/yolov7-w6.yaml rows 14/23/32/41) is absorbed into the kernel."""
    spec = spec.resolve()
    nodes = spec.nodes
    consumers: Dict[int, set] = {i: set() for i in range(len(nodes))}
    for i in range(len(nodes)):
        for s in _norm_f(nodes, i):
            if s >= 0:
                consumers[s].add(i)

    blocks: List[ElanBlock] = []
    for k, node in enumerate(nodes):
        if node.op != "Concat" or isinstance(node.f, int):
            continue
        mem = [m if m >= 0 else k + m for m in node.f]
        if len(mem) < 3 or len(set(mem)) != len(mem) or k + 1 >= len(nodes):
            continue
        tr = nodes[k + 1]
        if not _is_conv(tr, 1) or _norm_f(nodes, k + 1) != [k]:
            continue
        srt = sorted(set(mem))
        a, b = srt[0], srt[1]
        if b != a + 1:
            continue
        if not (_is_conv(nodes[a], 1) and _is_conv(nodes[b], 1)):
            continue
        fa, fb = _norm_f(nodes, a), _norm_f(nodes, b)
        if fa != fb or len(fa) != 1:
            continue
        # the 3x3 chain hangs off one of the two 1x1s
        j = b + 1
        chain: List[int] = []
        chain_src: Optional[int] = None
        while j < k and _is_conv(nodes[j], 3):
            src = _norm_f(nodes, j)
            if len(src) != 1:
                break
            if not chain:
                if src[0] not in (a, b):
                    break
                chain_src = src[0]
            elif src[0] != chain[-1]:
                break
            chain.append(j)
            j += 1
        if not chain or chain_src is None:
            continue
        route = a if chain_src == b else b
        if set(mem) - ({a, b} | set(chain)):
            continue
        # uniform, supported activation across the whole group
        acts = {_act_name(spec, nodes[i]) for i in (a, b, *chain, k + 1)}
        if len(acts) != 1 or acts.pop() not in ("silu", "leaky", "relu"):
            continue
        # nothing outside the group may read an intermediate
        ok = consumers[route] <= {k}
        ok &= consumers[chain_src] <= {chain[0], k}
        for idx, c in enumerate(chain):
            allowed = {k} | ({chain[idx + 1]} if idx + 1 < len(chain)
                             else set())
            ok &= consumers[c] <= allowed
        ok &= consumers[k] == {k + 1}
        if not ok:
            continue
        ccv = nodes[a].c2
        if nodes[b].c2 != ccv:
            continue
        cch = nodes[chain[0]].c2
        if any(nodes[c].c2 != cch for c in chain):
            continue

        def mname(i: int) -> str:
            if i == route:
                return "a"
            if i == chain_src:
                return "b"
            return f"y{chain.index(i) + 1}"

        pre: Optional[int] = None
        pre_cin, pre_stride = 0, 1
        if absorb_pre:
            src = fa[0]
            if (0 <= src == a - 1  # the group is one contiguous node run
                    and (_is_conv(nodes[src], 3, 2)
                         or _is_conv(nodes[src], 3, 1))
                    and consumers[src] == {a, b}
                    and _act_name(spec, nodes[src]) ==
                    _act_name(spec, nodes[a])):
                pre = src
                pre_cin = nodes[src].c1
                pre_stride = int(nodes[src].args[2]) \
                    if len(nodes[src].args) > 2 else 1
        shape = ElanShape(
            cin=nodes[a].c1, ccv=ccv, cch=cch, cout=nodes[k + 1].c2,
            n_chain=len(chain), members=tuple(mname(m) for m in mem),
            act=_act_name(spec, nodes[a]),
            pre_cin=pre_cin, pre_stride=pre_stride)
        blocks.append(ElanBlock(a=route, b=chain_src, chain=tuple(chain),
                                concat=k, trans=k + 1, shape=shape,
                                pre=pre))
    return blocks


# ---------------------------------------------------------------------------
# weight packing
# ---------------------------------------------------------------------------

@torch.no_grad()
def _conv_eff(model: YoloFace, idx: int, dtype: torch.dtype
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Effective OIHW kernel in `dtype` and (C,) float32 bias of ConvBN
    node `idx` with the BN folded. After models/fuse.fold_bn (`bn` is an
    identity) they are the conv's own; otherwise w' = w * g, b' = beta - mean
    * g, g = gamma / sqrt(var + eps), in float32 as the JAX packer
    computes them; the kernel is then cast to `dtype` and the bias stays
    float32 (the JAX `_conv_eff`)."""
    mod = model.model[idx]
    w = mod.conv.weight.detach().float()
    if not isinstance(mod.bn, torch.nn.BatchNorm2d):
        bias = mod.conv.bias.detach().float()
    else:
        bn = mod.bn
        g = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
        bias = bn.bias.float() - bn.running_mean.float() * g
        w = w * g.reshape(-1, 1, 1, 1)
    return w.to(dtype).contiguous(), bias.contiguous()


def pack_elan_weights(model: YoloFace, block: ElanBlock,
                      dtype: Optional[torch.dtype] = None,
                      device: Optional[torch.device] = None) -> ElanWeights:
    """The flat weight list of ops/elan_kernel.fused_elan for `block`, on
    `device` (default the model's): [pre,] a, b, chain..., transition,
    each as (OIHW kernel in `dtype`, (C,) float32 bias), with the bf16
    TMA route's packing of the kernels where the route takes the group
    (ElanWeights). `dtype` defaults to the model's own."""
    if dtype is None:
        dtype = next(model.parameters()).dtype
    idxs = ([block.pre] if block.pre is not None else []) + \
        [block.a, block.b, *block.chain, block.trans]
    ws: List[torch.Tensor] = []
    for idx in idxs:
        ws += [t.to(device) for t in _conv_eff(model, idx, dtype)]
    return ElanWeights(ws, block.shape)


def elan_weights(model: YoloFace, blocks: Sequence[ElanBlock],
                 dtype: torch.dtype, device: Optional[torch.device] = None
                 ) -> Dict[ElanBlock, ElanWeights]:
    """`fused_apply`'s weight cache filled for `blocks`, on `device`
    (default the model's): the packed weights of every block and, for a
    block with an absorbed pre conv, of its bare form too (the fall-back
    when the input does not divide by the pre conv's stride)."""
    out: Dict[ElanBlock, ElanWeights] = {}
    for blk in blocks:
        for b in (blk, _bare(blk)):
            if b not in out:
                out[b] = pack_elan_weights(model, b, dtype, device)
    return out


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

def _bare(blk: ElanBlock) -> ElanBlock:
    """The block without its absorbed pre conv."""
    return dataclasses.replace(
        blk, pre=None,
        shape=dataclasses.replace(blk.shape, pre_cin=0, pre_stride=1))


def _group_input(inp: torch.Tensor, shape: ElanShape) -> torch.Tensor:
    """A group's input in the layout of its kernel route: channels_last
    for a bf16 group on the card whose shape the TMA route takes
    (ops/elan_kernel.elan_route; the kernel then writes channels_last, so
    the modules between groups run channels_last too), else NCHW."""
    if (inp.device.type == "cuda" and inp.dtype == torch.bfloat16
            and tma_shape_ok(shape)):
        return inp.contiguous(memory_format=torch.channels_last)
    return inp.contiguous()


def fused_apply(model: YoloFace, x: torch.Tensor,
                blocks: Optional[Sequence[ElanBlock]] = None,
                weights: Optional[Dict[ElanBlock, List[torch.Tensor]]] = None,
                reshape_heads: bool = True) -> List[torch.Tensor]:
    """Inference forward matching `model(x, reshape_heads)` (NHWC float
    images in, raw per-level maps (bs, na, ny, nx, no) out, or the conv
    layout (bs, ny, nx, na*no) with `reshape_heads=False`), with the given
    ELAN blocks run as fused kernels, in the model's dtype (x's dtype must
    match).

    `blocks=None` fuses every block of the spec; `blocks=[]` runs every
    node through its own module. `weights` caches the packed weights per
    block (pack_elan_weights); missing entries are packed from `model` in
    its dtype and added (a bf16 model's biases are then bf16 values: fill
    the cache from the float32 model with `elan_weights` for the JAX
    package's float32 biases). When the input of a block with an absorbed
    pre conv is not divisible by the conv's stride, the pre conv runs as a
    node and the group fuses bare."""
    spec = model.spec
    if blocks is None:
        blocks = find_elan_blocks(spec)
    if weights is None:
        weights = {}
    by_start = {}
    for blk in blocks:
        by_start[blk.start] = blk
        if blk.pre is not None:
            by_start.setdefault(_bare(blk).start, _bare(blk))

    nodes = spec.nodes
    save = set(spec.save)
    x = x.permute(0, 3, 1, 2)
    saved: List[Optional[torch.Tensor]] = []
    i = 0
    while i < len(nodes):
        blk = by_start.get(i)
        if blk is not None:
            feed = blk.pre if blk.pre is not None else blk.a
            src = _norm_f(nodes, feed)[0]
            inp = x if src == i - 1 else saved[src]
            s = blk.shape.pre_stride if blk.shape.has_pre else 1
            if inp.shape[2] % s == 0 and inp.shape[3] % s == 0:
                if blk not in weights:
                    weights[blk] = pack_elan_weights(model, blk)
                x = fused_elan(_group_input(inp, blk.shape), weights[blk],
                               blk.shape)
                while i < blk.trans:
                    saved.append(None)
                    i += 1
                saved.append(x if i in save else None)
                i += 1
                continue
            # not divisible by the pre conv's stride: run it as a node

        node, m = nodes[i], model.model[i]
        if isinstance(node.f, int):
            inp = x if node.f == i - 1 else saved[node.f]
        else:
            inp = [x if j == i - 1 else saved[j] for j in node.f]
        if node.op in HEAD_OPS:
            return head_output(m(inp), spec, reshape_heads)
        x = m(inp)
        saved.append(x if i in save else None)
        i += 1
    raise RuntimeError("spec has no detection head as its last node")
