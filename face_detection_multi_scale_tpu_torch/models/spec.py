"""Model architecture specs, the graph/channel resolver and the cfg
parser (a copy of the JAX package's `Node`, `ModelSpec`, `resolve()`,
`spec_from_yolo_yaml` and `load_spec`; framework-free).

A `ModelSpec` is a flat list of nodes with `from`-routing plus
detection-head metadata. `resolve()` performs the channel arithmetic of the
reference `parse_model` (reference models/yolo.py:475-535): width/depth
multiples, make_divisible(c2 * gw, 8) rounding, per-op output-channel
rules, and the savelist of outputs needed by later skip connections.

`spec_from_yolo_yaml()` ingests the reference cfg/*.yaml dict format
(module names like "Conv", "nn.Upsample", activation instances like
"nn.LeakyReLU(0.1)"), so users of the reference bring their own configs
unchanged; `load_spec(path)` reads such a file (PyYAML, imported there
only).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from face_detection_multi_scale_tpu_torch.utils.general import make_divisible

# Ops whose first arg is an output channel count scaled by width_multiple
# (reference models/yolo.py:492-498).
_CH_SCALED = {
    "Conv", "DWConv", "GhostConv", "Bottleneck", "GhostBottleneck", "SPP",
    "MixConv2d", "Focus", "ConvFocus", "CrossConv", "BottleneckCSP", "C3",
    "C3TR", "BottleneckCSPF", "BottleneckCSP2", "SPPCSP", "SPPCSPC",
    "SPPFCSPC", "SPPF", "conv_bn_relu_maxpool", "Shuffle_Block",
    "DWConvblock", "StemBlock",
}
# Ops that receive the repeat count as a constructor arg rather than being
# replicated (reference models/yolo.py:499-501).
_REPEATS_AS_ARG = {
    "BottleneckCSP", "C3", "C3TR", "BottleneckCSPF", "BottleneckCSP2",
    "SPPCSP", "SPPCSPC",
}
HEAD_OPS = {"Detect", "IDetect", "IKeypoint"}


@dataclasses.dataclass
class Node:
    f: Union[int, Tuple[int, ...]]  # input node index / indices (-1 = prev)
    n: int                          # repeat count (pre depth-multiple)
    op: str                         # op name (reference module names)
    args: Tuple[Any, ...] = ()
    # resolved by ModelSpec.resolve():
    c1: int = -1                    # input channels (or per-input for lists)
    c2: int = -1                    # output channels
    n_resolved: int = 1             # post depth-multiple replication count
    repeats: int = 1                # internal repeats (CSP family)


@dataclasses.dataclass
class ModelSpec:
    name: str
    nc: int
    nkpt: int
    anchors: Tuple[Tuple[float, ...], ...]  # per level, pixel units
    strides: Tuple[int, ...]
    nodes: List[Node]
    depth_multiple: float = 1.0
    width_multiple: float = 1.0
    dw_conv_kpt: bool = False
    act: Optional[str] = None       # global activation override
    in_ch: int = 3
    _resolved: bool = False

    @property
    def na(self) -> int:
        return len(self.anchors[0]) // 2

    @property
    def nl(self) -> int:
        return len(self.anchors)

    @property
    def no_det(self) -> int:
        return self.nc + 5

    @property
    def no_kpt(self) -> int:
        return 3 * self.nkpt

    @property
    def no(self) -> int:
        return self.no_det + self.no_kpt

    @property
    def head_node(self) -> Node:
        return self.nodes[-1]

    @property
    def head_in_ch(self) -> Tuple[int, ...]:
        return tuple(self.nodes[i].c2 for i in self.head_node.f)

    @property
    def max_stride(self) -> int:
        return max(self.strides)

    def resolve(self) -> "ModelSpec":
        """Fill c1/c2/repeats on every node and compute the savelist."""
        if self._resolved:
            return self
        gd, gw = self.depth_multiple, self.width_multiple
        ch: List[int] = [self.in_ch]
        for i, node in enumerate(self.nodes):
            f, n, op, args = node.f, node.n, node.op, list(node.args)
            n = max(round(n * gd), 1) if n > 1 else n
            if op in _CH_SCALED:
                c1 = ch[f] if isinstance(f, int) else ch[f[0]]
                c2 = int(args[0])
                c2 = make_divisible(c2 * gw, 8) if gw != 1.0 else c2
                node.c1, node.c2 = c1, c2
                if op in _REPEATS_AS_ARG:
                    node.repeats, n = n, 1
            elif op == "Concat":
                node.c2 = sum(ch[x] for x in f)
            elif op == "ADD":
                node.c2 = sum(ch[x] for x in f) // 2
            elif op in HEAD_OPS:
                node.c1 = -1
                node.c2 = self.no * self.na
            elif op == "ReOrg":
                node.c1 = ch[f]
                node.c2 = ch[f] * 4
            elif op == "Contract":
                node.c2 = ch[f] * int(args[0]) ** 2
            elif op == "Expand":
                node.c2 = ch[f] // int(args[0]) ** 2
            else:  # MP / SP / SPF / Upsample / BatchNorm: channel-preserving
                node.c1 = ch[f] if isinstance(f, int) else ch[f[0]]
                node.c2 = node.c1
            if node.c1 == -1 and isinstance(f, int):
                node.c1 = ch[f]
            node.n_resolved = n
            if i == 0:
                ch = []
            ch.append(node.c2)
        # normalize `from` indices to absolute positions
        for i, node in enumerate(self.nodes):
            if isinstance(node.f, int):
                node.f = node.f if node.f >= 0 else i + node.f
            else:
                node.f = tuple(x if x >= 0 else i + x for x in node.f)
        self.save = sorted({
            x for node in self.nodes
            for x in ((node.f,) if isinstance(node.f, int) else node.f)
        })
        self._resolved = True
        return self


def _parse_yaml_module(name: str) -> str:
    return {"nn.Upsample": "Upsample", "nn.BatchNorm2d": "BatchNorm",
            "nn.MaxPool2d": "MaxPool2d",
            "nn.ZeroPad2d": "ZeroPad2d"}.get(name, name)


def _parse_yaml_arg(a: Any) -> Any:
    """Translate reference YAML arg tokens: activation instances become
    string tags; 'nearest'/None/numbers pass through."""
    if isinstance(a, str):
        if a.startswith("nn.LeakyReLU"):
            return "leaky"
        if a.startswith("nn.ReLU"):
            return "relu"
        if a.startswith("nn.SiLU"):
            return "silu"
        if a == "None":
            return None
    return a


def spec_from_yolo_yaml(d: Dict[str, Any], name: str = "model",
                        strides: Optional[Sequence[int]] = None
                        ) -> ModelSpec:
    """Build a resolved ModelSpec from a reference-format cfg dict
    (nc/nkpt/depth_multiple/width_multiple/anchors/backbone/head rows of
    [from, number, module, args]). Without `strides` the levels are taken
    as P3 onwards, (8, 16, 32[, 64]); `models.model.compute_strides`
    derives the real ones."""
    anchors = tuple(tuple(float(v) for v in row) for row in d["anchors"])
    if strides is None:
        strides = tuple(8 * 2 ** i for i in range(len(anchors)))
    nodes: List[Node] = []
    for f, n, m, args in list(d["backbone"]) + list(d["head"]):
        op = _parse_yaml_module(m)
        args = [_parse_yaml_arg(a) for a in args]
        if op in HEAD_OPS or op == "Upsample":
            # head params come from the spec's fields; Upsample is always
            # [None, 2, 'nearest'] in the model family
            args = []
        f = tuple(f) if isinstance(f, list) else f
        nodes.append(Node(f=f, n=int(n), op=op, args=tuple(args)))
    act = d.get("act")
    return ModelSpec(
        name=name, nc=int(d["nc"]), nkpt=int(d.get("nkpt", 0) or 0),
        anchors=anchors, strides=tuple(strides), nodes=nodes,
        depth_multiple=float(d.get("depth_multiple", 1.0)),
        width_multiple=float(d.get("width_multiple", 1.0)),
        dw_conv_kpt=bool(d.get("dw_conv_kpt", False)),
        act=_parse_yaml_arg(act) if act else None).resolve()


def load_spec(path: str, name: Optional[str] = None) -> ModelSpec:
    """Load a reference-format YAML cfg file; the spec is named after the
    file unless `name` is given."""
    import yaml

    with open(path) as f:
        d = yaml.safe_load(f)
    return spec_from_yolo_yaml(
        d, name or os.path.splitext(os.path.basename(path))[0])
