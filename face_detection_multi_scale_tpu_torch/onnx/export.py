"""Native ONNX export for the port: the ATen graph of a `torch.export` ->
ONNX-13, no onnx / tf2onnx / torch.onnx.

The counterpart of the JAX package's onnx/export.py, which maps a jaxpr.
Here the inference function (export_model.InferenceModule: uint8 NHWC
frames, /255, the BN-folded `YoloFace`, the decode; or the W8A8 int8
walk of models/quant.py) is exported non-strict with `torch.export`, and
each ATen node of its graph becomes standard ONNX-13 nodes, written
through the protobuf bindings in onnx_pb2.py (a copy of the JAX
package's, wire-compatible with upstream ONNX).

Design notes:
  * Layout: the ATen graph is already NCHW with OIHW conv weights, so the
    float graph needs no transposes of its own: the model's permute of
    the NHWC `images` input is the one Transpose, and the outputs come in
    the JAX file's layouts (decoded (bs, N, no), raw (bs, na, ny, nx,
    no)).
  * Weights become initializers named `p.<state-dict key>` of the
    `YoloFace` (the int8 walk's `p.convs.<tag>.<field>`, its OHWI int8
    kernels stored OIHW as `p.convs.<tag>.w.oihw`). An initializer no
    node reads is never written.
  * Nodes whose inputs are all known (the decode's grids and anchors, a
    scale picked from a constant, no-op casts of a weight) are evaluated
    by torch at export time and written as initializers, so the graph is
    static-shape like the JAX one.
  * An ATen op that onnx/runner.py, the independent judge of every file,
    does not execute is lowered to ops it does: clamp to Max and Min,
    leaky_relu to Where, silu to Sigmoid times x, BatchNorm (a folded
    model keeps none but a concat-fed affine) to Mul and Add, a
    ceil-mode max pool to the same MaxPool with its end padded.
  * The int8 walk's convs are `fdms_torch.qconv` nodes (the custom op of
    ops/qconv_kernel.py), each mapped to a Transpose pair around
    `ConvInteger` over the int8 initializers and `qconv_plain`'s epilogue
    as float ops in its order: Cast, Mul alpha, Add bias, the
    activation, Mul inv_out, Round, Max -127, Min 127, Cast int8.
  * The fused-NMS tail (`_append_nms_postprocess`) and the model's
    assembly (`_Builder`, `_finalize_model`) are copies of the JAX
    file's, so a consumer sees the same contract: opset 13, input
    `images` uint8 [B, H, W, 3], outputs out_0.. (a dynamic K after the
    NonMaxSuppression tail).
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from face_detection_multi_scale_tpu_torch.onnx import onnx_pb2 as pb

OPSET = 13
IR_VERSION = 8

_DTYPES = {
    "float32": pb.TensorProto.FLOAT,
    "float64": pb.TensorProto.DOUBLE,
    "float16": pb.TensorProto.FLOAT16,
    "int8": pb.TensorProto.INT8,
    "int32": pb.TensorProto.INT32,
    "int64": pb.TensorProto.INT64,
    "uint8": pb.TensorProto.UINT8,
    "bool": pb.TensorProto.BOOL,
}
_TORCH_NP = {torch.float32: np.float32, torch.float64: np.float64,
             torch.float16: np.float16, torch.int8: np.int8,
             torch.int32: np.int32, torch.int64: np.int64,
             torch.uint8: np.uint8, torch.bool: np.bool_}

# one ATen op -> one ONNX op on the same inputs
_UNARY = {"sigmoid": "Sigmoid"}
_ARITH = {"add": "Add", "sub": "Sub", "mul": "Mul", "div": "Div"}
# ops that hand back their input's values (same dtype): no node
_PASS = {"contiguous", "detach_", "lift_fresh_copy"}
# ops that check metadata and compute nothing
_SKIP = {"_assert_tensor_metadata"}


def _onnx_dtype(dt) -> int:
    if isinstance(dt, torch.dtype):
        if dt not in _TORCH_NP:
            raise NotImplementedError(f"ONNX export: unsupported dtype {dt}")
        dt = _TORCH_NP[dt]
    name = np.dtype(dt).name
    if name not in _DTYPES:
        raise NotImplementedError(f"ONNX export: unsupported dtype {dt}")
    return _DTYPES[name]


class _Builder:
    """Accumulates ONNX nodes/initializers with unique tensor names (a copy
    of the JAX emitter's)."""

    def __init__(self):
        self.nodes: List[pb.NodeProto] = []
        self.initializers: Dict[str, pb.TensorProto] = {}
        self._n = 0

    def name(self, hint: str = "t") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def node(self, op: str, inputs: Sequence[str], n_out: int = 1,
             name_hint: Optional[str] = None,
             outputs: Optional[Sequence[str]] = None,
             **attrs) -> List[str]:
        outs = list(outputs) if outputs is not None else \
            [self.name(name_hint or op.lower()) for _ in range(n_out)]
        n = pb.NodeProto()
        n.op_type = op
        n.name = self.name(f"node_{op}")
        n.input.extend(inputs)
        n.output.extend(outs)
        for k, v in attrs.items():
            a = n.attribute.add()
            a.name = k
            if isinstance(v, float):
                a.type = pb.AttributeProto.FLOAT
                a.f = v
            elif isinstance(v, (bool, int, np.integer)):
                a.type = pb.AttributeProto.INT
                a.i = int(v)
            elif isinstance(v, str):
                a.type = pb.AttributeProto.STRING
                a.s = v.encode()
            elif isinstance(v, (list, tuple)) and all(
                    isinstance(x, (int, np.integer)) for x in v):
                a.type = pb.AttributeProto.INTS
                a.ints.extend(int(x) for x in v)
            elif isinstance(v, (list, tuple)):
                a.type = pb.AttributeProto.FLOATS
                a.floats.extend(float(x) for x in v)
            else:
                raise NotImplementedError(f"attr {k}={v!r}")
        self.nodes.append(n)
        return outs

    def tensor(self, arr: np.ndarray, name: Optional[str] = None) -> str:
        arr = np.asarray(arr)
        name = name or self.name("const")
        t = pb.TensorProto()
        t.name = name
        t.dims.extend(arr.shape)
        t.data_type = _onnx_dtype(arr.dtype)
        t.raw_data = np.ascontiguousarray(arr).tobytes()
        self.initializers[name] = t
        return name

    def i64(self, values) -> str:
        return self.tensor(np.asarray(values, np.int64))


@dataclasses.dataclass(eq=False)
class _Const:
    """A value known at export time (a weight, or a node folded by torch):
    the CPU tensor and the initializer name it takes when a node reads it
    (None: a fresh `const_<n>`)."""
    value: torch.Tensor
    name: Optional[str] = None


def _op_name(target) -> str:
    """`aten.convolution.default` -> "convolution", the custom
    `fdms_torch.qconv.default` -> "fdms_torch.qconv"."""
    ns = getattr(target, "namespace", "aten")
    base = target._opname if hasattr(target, "_opname") else str(target)
    return base if ns == "aten" else f"{ns}.{base}"


def _pair(v) -> List[int]:
    """An int or a 1- or 2-sequence as [a, b]."""
    v = [v] if isinstance(v, int) else list(v)
    return v * (2 // len(v))


def _flat(x) -> list:
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _flat(item)]
    return [x]


class _Converter:
    """Walks the ATen graph of an ExportedProgram, node by node, into a
    _Builder. A value is an ONNX tensor name (computed in the graph), a
    _Const (known), a list of those (a node with several outputs) or a
    Python scalar / list (an argument)."""

    def __init__(self, b: _Builder):
        self.b = b
        self.env: Dict[Any, Any] = {}
        self.dtypes: Dict[str, torch.dtype] = {}  # graph tensor -> dtype
        self.shapes: Dict[str, tuple] = {}        # node output -> shape
        # id(_Const) -> (the _Const, its initializer)
        self._written: Dict[int, tuple] = {}
        self._oihw: Dict[int, str] = {}  # id(int8 OHWI _Const) -> OIHW
        self._bias: Dict[int, tuple] = {}  # id(bias) -> (it, (C, 1, 1))

    # -- values -------------------------------------------------------
    def read(self, v) -> str:
        """The ONNX tensor name of a value, writing a _Const once."""
        if isinstance(v, str):
            return v
        if isinstance(v, _Const):
            key = id(v)
            if key not in self._written:
                arr = v.value.detach().cpu()
                if arr.dtype == torch.bfloat16:
                    raise NotImplementedError(
                        "ONNX export: bfloat16 weights (export float32)")
                name = self.b.tensor(arr.numpy(), name=v.name)
                self.dtypes[name] = arr.dtype
                # the entry holds `v`, so its id is never reused
                self._written[key] = (v, name)
            return self._written[key][1]
        raise TypeError(f"not a tensor value: {v!r}")

    def dtype_of(self, v) -> torch.dtype:
        if isinstance(v, _Const):
            return v.value.dtype
        return self.dtypes[v]

    def emit(self, op: str, inputs: Sequence, dtype: torch.dtype,
             **attrs) -> str:
        out = self.b.node(op, [self.read(v) for v in inputs], **attrs)[0]
        self.dtypes[out] = dtype
        return out

    def cast(self, v, dtype: torch.dtype):
        """`v` in `dtype` (a Cast node, or a converted constant)."""
        if isinstance(v, (bool, int, float)):
            return _Const(torch.tensor(v, dtype=dtype))
        if self.dtype_of(v) == dtype:
            return v
        if isinstance(v, _Const):
            return _Const(v.value.to(dtype))
        return self.emit("Cast", [v], dtype, to=_onnx_dtype(dtype))

    # -- the walk -----------------------------------------------------
    def arg(self, a):
        if isinstance(a, torch.fx.Node):
            return self.env[a]
        if isinstance(a, (list, tuple)):
            return type(a)(self.arg(v) for v in a)
        return a

    def call(self, node: torch.fx.Node):
        if node.target is operator.getitem:
            return self.env[node.args[0]][node.args[1]]
        name = _op_name(node.target)
        if name in _SKIP:
            return None
        args = [self.arg(a) for a in node.args]
        kwargs = {k: self.arg(v) for k, v in node.kwargs.items()}
        meta = node.meta.get("val")
        if name in _PASS or (name == "to" and isinstance(
                meta, torch.Tensor) and meta.dtype == self.dtype_of(args[0])):
            return args[0]
        values = _flat(args) + _flat(list(kwargs.values()))
        if not any(isinstance(v, str) for v in values) and \
                not name.startswith("fdms_torch."):
            return self.fold(node, args, kwargs)
        if name.startswith("fdms_torch."):
            handler = getattr(self, "custom_" + name.split(".", 1)[1], None)
        else:
            handler = getattr(self, "op_" + name, None)
        if handler is not None:
            return handler(meta, *args, **kwargs)
        if name in _UNARY:
            return self.emit(_UNARY[name], [args[0]], meta.dtype)
        if name in _ARITH:
            return self.arith(_ARITH[name], meta, *args, **kwargs)
        raise NotImplementedError(
            f"ONNX export: unhandled ATen op {node.target} ({node.format_node()})")

    def fold(self, node, args, kwargs):
        """Evaluate a node of known inputs with torch, on the CPU."""
        def real(v):
            if isinstance(v, _Const):
                return v.value
            if isinstance(v, (list, tuple)):
                return type(v)(real(x) for x in v)
            return v

        out = node.target(*real(args), **_cpu(real(kwargs)))
        if isinstance(out, (list, tuple)):
            return [_Const(t) if isinstance(t, torch.Tensor) else t
                    for t in out]
        return _Const(out) if isinstance(out, torch.Tensor) else out

    # -- elementwise --------------------------------------------------
    def arith(self, op: str, meta, a, b, alpha=1):
        dt = meta.dtype
        if alpha != 1:
            b = self.emit("Mul", [self.cast(b, dt), self.cast(alpha, dt)], dt)
        return self.emit(op, [self.cast(a, dt), self.cast(b, dt)], dt)

    def op_pow(self, meta, x, e):
        if not isinstance(e, (int, float)):
            raise NotImplementedError("pow with a tensor exponent")
        return self.emit("Pow", [x, self.cast(float(e), meta.dtype)],
                         meta.dtype)

    def op_round(self, meta, x, decimals=None):
        # torch.round is half to even, ONNX Round's contract
        if decimals:
            raise NotImplementedError("round with decimals")
        return self.emit("Round", [x], meta.dtype)

    def op_relu(self, meta, x):
        return self.emit("Max", [x, self.cast(0.0, meta.dtype)], meta.dtype)

    def op_silu(self, meta, x):
        return self.emit("Mul", [x, self.emit("Sigmoid", [x], meta.dtype)],
                         meta.dtype)

    def op_leaky_relu(self, meta, x, slope=0.01):
        return self.leaky(x, slope, meta.dtype)

    def leaky(self, x, slope: float, dt):
        pos = self.emit("Greater", [x, self.cast(0.0, dt)], torch.bool)
        return self.emit("Where", [pos, x, self.emit(
            "Mul", [x, self.cast(float(slope), dt)], dt)], dt)

    def op_clamp(self, meta, x, lo=None, hi=None):
        dt = meta.dtype
        if lo is not None:
            x = self.emit("Max", [x, self.cast(lo, dt)], dt)
        if hi is not None:
            x = self.emit("Min", [x, self.cast(hi, dt)], dt)
        return x

    def op_to(self, meta, x, *_, **__):
        return self.cast(x, meta.dtype)

    # -- shapes and layout --------------------------------------------
    def reshape(self, meta, x):
        return self.emit("Reshape", [x, self.b.i64(list(meta.shape))],
                         meta.dtype)

    def op_reshape(self, meta, x, *_):
        return self.reshape(meta, x)

    op_unsqueeze = op_reshape

    def op_permute(self, meta, x, dims):
        nd = len(dims)
        return self.emit("Transpose", [x], meta.dtype,
                         perm=[d % nd for d in dims])

    def op_transpose(self, meta, x, d0, d1):
        nd = len(meta.shape)
        perm = list(range(nd))
        perm[d0 % nd], perm[d1 % nd] = perm[d1 % nd], perm[d0 % nd]
        return self.emit("Transpose", [x], meta.dtype, perm=perm)

    def op_expand(self, meta, x, *_, **__):
        return self.emit("Expand", [x, self.b.i64(list(meta.shape))],
                         meta.dtype)

    def op_cat(self, meta, xs, dim=0):
        return self.emit("Concat", [self.cast(x, meta.dtype) for x in xs],
                         meta.dtype, axis=dim % len(meta.shape))

    def op_stack(self, meta, xs, dim=0):
        nd = len(meta.shape)
        shape = list(meta.shape)
        shape[dim % nd] = 1
        parts = [self.emit("Reshape", [x, self.b.i64(shape)], meta.dtype)
                 for x in xs]
        return self.emit("Concat", parts, meta.dtype, axis=dim % nd)

    def slice(self, x, dim: int, start: int, end: int, step: int, dtype):
        return self.emit("Slice", [x, self.b.i64([start]), self.b.i64([end]),
                                   self.b.i64([dim]), self.b.i64([step])],
                         dtype)

    def op_slice(self, meta, x, dim=0, start=None, end=None, step=1):
        size = self.shape_of(x)[dim]
        start = 0 if start is None else start
        end = size if end is None else min(end, size)
        return self.slice(x, dim, start, end, step, meta.dtype)

    def op_select(self, meta, x, dim, index):
        size = self.shape_of(x)[dim]
        return self.emit("Gather", [x, self.b.tensor(
            np.asarray(index % size, np.int64))], meta.dtype, axis=dim)

    def op_chunk(self, meta, x, chunks, dim=0):
        out, start = [], 0
        for m in meta:
            size = m.shape[dim]
            out.append(self.slice(x, dim, start, start + size, 1, m.dtype))
            start += size
        return out

    def op_repeat_interleave(self, meta, x, repeats, dim=None, **_):
        """A scalar `repeats` along `dim`: a new axis after `dim`, expanded
        to `repeats`, merged back."""
        if not isinstance(repeats, int) or dim is None:
            raise NotImplementedError("repeat_interleave by a tensor")
        shape = list(self.shape_of(x))
        dim %= len(shape)
        mid = shape[:dim + 1] + [1] + shape[dim + 1:]
        big = shape[:dim + 1] + [repeats] + shape[dim + 1:]
        y = self.emit("Reshape", [x, self.b.i64(mid)], meta.dtype)
        y = self.emit("Expand", [y, self.b.i64(big)], meta.dtype)
        return self.reshape(meta, y)

    def op_pad(self, meta, x, pad, mode="constant", value=None):
        if mode != "constant":
            raise NotImplementedError(f"pad mode {mode!r}")
        return self.op_constant_pad_nd(meta, x, pad, value or 0.0)

    def op_constant_pad_nd(self, meta, x, pad, value=0.0):
        nd = len(meta.shape)
        lo, hi = [0] * nd, [0] * nd
        for i in range(len(pad) // 2):  # torch: last dim first
            lo[nd - 1 - i], hi[nd - 1 - i] = pad[2 * i], pad[2 * i + 1]
        return self.emit("Pad", [x, self.b.i64(lo + hi),
                                 self.cast(float(value), meta.dtype)],
                         meta.dtype, mode="constant")

    # -- spatial ------------------------------------------------------
    def op_conv2d(self, meta, x, w, b=None, stride=(1, 1), padding=(0, 0),
                  dilation=(1, 1), groups=1):
        if isinstance(padding, str) or not isinstance(w, _Const):
            raise NotImplementedError("conv2d needs known weights and "
                                      "numeric padding")
        y = self.emit("Conv", [x, w], meta.dtype, strides=_pair(stride),
                      pads=_pair(padding) * 2, dilations=_pair(dilation),
                      group=int(groups))
        if b is None:
            return y
        # the bias as its own Add (the runner's Conv takes no bias),
        # stored (C, 1, 1) under the parameter's name
        if id(b) not in self._bias:
            self._bias[id(b)] = (b, _Const(b.value.reshape(-1, 1, 1),
                                           b.name))
        return self.emit("Add", [y, self._bias[id(b)][1]], meta.dtype)

    def op_max_pool2d(self, meta, x, kernel, stride=(), padding=0,
                      dilation=1, ceil_mode=False):
        kernel = _pair(kernel)
        stride = _pair(stride or kernel)
        padding = _pair(padding)
        if _pair(dilation) != [1, 1]:
            raise NotImplementedError("dilated max pool")
        h, w = self.shape_of(x)[-2:]
        # the end pads that give torch's output size by floor division
        # (ceil_mode's last window is one more stride; it starts inside
        # the input, so the padded cells never win the max)
        ends = [(o - 1) * s + k - n - p for o, s, k, n, p in zip(
            meta.shape[-2:], stride, kernel, (h, w), padding)]
        return self.emit("MaxPool", [x], meta.dtype, kernel_shape=kernel,
                         strides=stride, pads=padding + ends)

    def op_batch_norm(self, meta, x, w, b, mean, var, training, momentum,
                      eps, *_):
        """BN on running statistics as the affine x * g + (b - mean * g),
        g = w / sqrt(var + eps), channel axis 1."""
        if training:
            raise NotImplementedError("batch_norm in training mode")
        g = w.value / torch.sqrt(var.value + eps)
        shift = b.value - mean.value * g
        view = [-1] + [1] * (len(meta.shape) - 2)
        y = self.emit("Mul", [x, _Const(g.reshape(view))], meta.dtype)
        return self.emit("Add", [y, _Const(shift.reshape(view))],
                         meta.dtype)

    # -- the W8A8 conv ------------------------------------------------
    def custom_qconv(self, meta, x, w, alpha, bias, inv_out, stride, pads,
                     groups, act):
        """fdms_torch.qconv: NHWC int8 x, OHWI int8 w -> NHWC int8, as
        `qconv_plain` computes it (ops/qconv_kernel.py)."""
        key = id(w)
        if key not in self._oihw:
            oihw = w.value.permute(0, 3, 1, 2).contiguous()
            self._oihw[key] = self.read(_Const(
                oihw, f"{w.name}.oihw" if w.name else None))
        f32 = torch.float32
        xt = self.emit("Transpose", [x], torch.int8, perm=[0, 3, 1, 2])
        y = self.emit("ConvInteger", [xt, self._oihw[key]], torch.int32,
                      strides=[stride, stride],
                      pads=[pads[0], pads[1], pads[0], pads[1]],
                      dilations=[1, 1], group=int(groups))
        y = self.emit("Transpose", [y], torch.int32, perm=[0, 2, 3, 1])
        z = self.emit("Cast", [y], f32, to=_onnx_dtype(f32))
        z = self.emit("Mul", [z, alpha], f32)
        z = self.emit("Add", [z, bias], f32)
        if act == "silu":
            z = self.emit("Mul", [z, self.emit("Sigmoid", [z], f32)], f32)
        elif act == "leaky":
            z = self.leaky(z, 0.1, f32)
        elif act == "relu":
            z = self.emit("Max", [z, self.cast(0.0, f32)], f32)
        elif act != "none":
            raise NotImplementedError(f"qconv activation {act!r}")
        z = self.emit("Mul", [z, self.cast(float(inv_out), f32)], f32)
        z = self.emit("Round", [z], f32)
        z = self.emit("Max", [z, self.cast(-127.0, f32)], f32)
        z = self.emit("Min", [z, self.cast(127.0, f32)], f32)
        return self.emit("Cast", [z], torch.int8,
                         to=_onnx_dtype(torch.int8))

    def shape_of(self, v) -> Sequence[int]:
        return v.value.shape if isinstance(v, _Const) else self.shapes[v]


def _cpu(kwargs: dict) -> dict:
    """kwargs of a folded op with any device moved to the CPU."""
    return {k: (torch.device("cpu") if k == "device" else v)
            for k, v in kwargs.items()}


def trace(module: torch.nn.Module, example: torch.Tensor):
    """The ExportedProgram of module(example), non-strict (the ATen graph
    as torch.export leaves it: decomposing it too would take longer than
    the export, for ops the converter maps as they come)."""
    return torch.export.export(module, (example,), strict=False)


def _convert(ep, names: Callable[[str, torch.Tensor], Optional[str]]):
    """(builder, graph inputs, [(name, elem type, dims)] outputs) of a
    decomposed program whose one user input is the `images` frames.
    `names(target, tensor)` names a weight's initializer (None: a fresh
    const name)."""
    from torch.export.graph_signature import InputKind

    b = _Builder()
    conv = _Converter(b)
    sig = ep.graph_signature
    placeholders = [n for n in ep.graph_module.graph.nodes
                    if n.op == "placeholder"]
    inputs, graph_inputs = {}, []
    for node, spec in zip(placeholders, sig.input_specs):
        if spec.kind == InputKind.USER_INPUT:
            meta = node.meta["val"]
            vi = pb.ValueInfoProto()
            vi.name = "images"
            vi.type.tensor_type.elem_type = _onnx_dtype(meta.dtype)
            for d in meta.shape:
                vi.type.tensor_type.shape.dim.add().dim_value = int(d)
            graph_inputs.append(vi)
            inputs[node.name] = "images"
            conv.dtypes["images"] = meta.dtype
            conv.shapes["images"] = tuple(meta.shape)
            continue
        if spec.kind == InputKind.CONSTANT_TENSOR or \
                spec.target not in ep.state_dict:
            t = ep.constants[spec.target]
        else:
            t = ep.state_dict[spec.target]
        inputs[node.name] = _Const(t.detach(), names(spec.target, t))
    if len(graph_inputs) != 1:
        raise ValueError(f"expected one user input, got {len(graph_inputs)}")

    outs = []
    for node in ep.graph_module.graph.nodes:
        if node.op == "placeholder":
            conv.env[node] = inputs[node.name]
        elif node.op == "call_function":
            val = conv.call(node)
            conv.env[node] = val
            # each computed output's shape, for the handlers that need it
            metas = node.meta.get("val")
            for v, m in zip(_flat(val) if isinstance(val, list) else [val],
                            _flat(metas) if isinstance(val, list)
                            else [metas]):
                if isinstance(v, str) and isinstance(m, torch.Tensor):
                    conv.shapes.setdefault(v, tuple(m.shape))
        elif node.op == "output":
            for n in _flat(node.args[0]):
                v = conv.env[n]
                m = n.meta["val"]
                outs.append((conv.read(v), _onnx_dtype(m.dtype),
                             list(m.shape)))
    return b, graph_inputs, outs


def _finalize_model(b: _Builder, graph_inputs, outputs, *,
                    graph_name: str, doc: str = "") -> pb.ModelProto:
    """Assemble the ModelProto (a copy of the JAX emitter's). `outputs` is
    a list of (src_tensor_name, onnx_elem_type, dims) where a dim may be
    None for a dynamic (data-dependent) dimension; each output is renamed
    to the contract name out_{i} via an Identity."""
    out_infos = []
    for oi, (src, elem, dims) in enumerate(outputs):
        ident = b.node("Identity", [src], outputs=[f"out_{oi}"])[0]
        out_infos.append((ident, elem, dims))

    # prune initializers no node consumes
    used = {i for n in b.nodes for i in n.input}
    for name in [k for k in b.initializers if k not in used]:
        del b.initializers[name]

    m = pb.ModelProto()
    m.ir_version = IR_VERSION
    op = m.opset_import.add()
    op.domain = ""
    op.version = OPSET
    m.producer_name = "face_detection_multi_scale_tpu_torch"
    m.doc_string = doc
    g = m.graph
    g.name = graph_name
    g.node.extend(b.nodes)
    g.initializer.extend(b.initializers.values())
    g.input.extend(graph_inputs)
    for name, elem, dims in out_infos:
        vi = g.output.add()
        vi.name = name
        vi.type.tensor_type.elem_type = elem
        for d in dims:
            dim = vi.type.tensor_type.shape.dim.add()
            if d is None:
                dim.dim_param = "n_detections"
            else:
                dim.dim_value = int(d)
    return m


def _append_nms_postprocess(b: _Builder, pred: str, pred_shape, *,
                            nc: int, conf_thres: float, iou_thres: float,
                            max_det: int):
    """Append the serving postprocess as standard ONNX ops
    (NonMaxSuppression + Gather), a copy of the JAX emitter's: the
    contract equivalent of the reference's --export-nms graph.

    Input: decoded predictions (bs, N, no) named `pred`. Emitted outputs
    (dynamic leading dim K = total selected):
      boxes (K, 4) xyxy network-input pixels, scores (K,),
      classes (K,) f32, extras (K, no-5-nc) landmark triplets,
      batch_index (K,) int64.
    Selection semantics match ops/nms.non_max_suppression for nc=1:
    conf = obj * cls, gate conf > conf_thres, greedy IoU > iou_thres
    suppression, at most max_det keeps per image."""
    bs, n, no = (int(d) for d in pred_shape)
    if nc != 1:
        raise NotImplementedError(
            "fused ONNX postprocess is single-class (face); nc>1 needs "
            "ArgMax/class-offset plumbing")
    f32 = np.float32

    def sl(lo, hi):
        return b.node("Slice", [pred, b.i64([lo]), b.i64([hi]),
                                b.i64([2]), b.i64([1])])[0]

    cx, cy, w, h = sl(0, 1), sl(1, 2), sl(2, 3), sl(3, 4)
    obj, cls = sl(4, 5), sl(5, 6)
    conf = b.node("Mul", [obj, cls])[0]                    # (bs, N, 1)
    half = b.tensor(np.asarray(0.5, f32))
    w2 = b.node("Mul", [w, half])[0]
    h2 = b.node("Mul", [h, half])[0]
    x1 = b.node("Sub", [cx, w2])[0]
    y1 = b.node("Sub", [cy, h2])[0]
    x2 = b.node("Add", [cx, w2])[0]
    y2 = b.node("Add", [cy, h2])[0]
    boxes = b.node("Concat", [x1, y1, x2, y2], axis=2)[0]  # (bs, N, 4)

    scores = b.node("Transpose", [conf], perm=[0, 2, 1])[0]  # (bs,1,N)
    sel = b.node(
        "NonMaxSuppression",
        [boxes, scores,
         b.tensor(np.asarray(max_det, np.int64)),
         b.tensor(np.asarray(iou_thres, f32)),
         b.tensor(np.asarray(conf_thres, f32))],
        center_point_box=0)[0]                             # (K, 3)

    ax1 = b.i64([1])
    batch_i = b.node("Gather", [sel, b.i64([0])], axis=1)[0]
    box_i = b.node("Gather", [sel, b.i64([2])], axis=1)[0]
    batch_idx = b.node("Squeeze", [batch_i, ax1])[0]       # (K,)
    box_idx = b.node("Squeeze", [box_i, ax1])[0]
    n_const = b.tensor(np.asarray(n, np.int64))
    flat = b.node("Add", [b.node("Mul", [batch_idx, n_const])[0],
                          box_idx])[0]                     # (K,)

    def take(src3d, width):
        fl = b.node("Reshape",
                    [src3d, b.i64([bs * n, width])])[0]
        return b.node("Gather", [fl, flat], axis=0)[0]

    out_boxes = take(boxes, 4)                             # (K, 4)
    out_scores = b.node("Squeeze", [take(conf, 1), ax1])[0]  # (K,)
    out_classes = b.node("Sub", [out_scores, out_scores])[0]  # zeros (K,)
    rows = take(pred, no)                                  # (K, no)
    extras = b.node("Slice", [rows, b.i64([5 + nc]), b.i64([no]),
                              ax1, b.i64([1])])[0]

    e_f = pb.TensorProto.FLOAT
    return [
        (out_boxes, e_f, [None, 4]),
        (out_scores, e_f, [None]),
        (out_classes, e_f, [None]),
        (extras, e_f, [None, no - 5 - nc]),
        (batch_idx, pb.TensorProto.INT64, [None]),
    ]


def _state_names(target: str, tensor) -> Optional[str]:
    """Initializer name `p.<state-dict key>` of a weight of the inference
    module's `YoloFace` (its attribute `net`)."""
    return "p." + target.removeprefix("net.")


def _model_proto(module, example, names, *, graph_name: str, doc: str,
                 nms: Optional[dict] = None) -> pb.ModelProto:
    """Export `module` on `example`, convert it, and append the fused-NMS
    tail to its one decoded output when `nms` holds its settings."""
    b, graph_inputs, outs = _convert(trace(module, example), names)
    if nms is not None:
        (pred_name, _, pred_shape), = outs
        outs = _append_nms_postprocess(b, pred_name, pred_shape, **nms)
    return _finalize_model(b, graph_inputs, outs, graph_name=graph_name,
                           doc=doc)


def _write(m: pb.ModelProto, path: str) -> str:
    with open(path, "wb") as f:
        f.write(m.SerializeToString())
    return path


def _float_module(model, spec, raw_heads: bool, fold_batchnorm: bool):
    from face_detection_multi_scale_tpu_torch import export_model as EM

    net = EM.serving_model(model, torch.float32, "cpu", fold=fold_batchnorm)
    return EM.InferenceModule(net, spec, raw_heads=raw_heads)


def _frames(batch: int, img_size: int) -> torch.Tensor:
    return torch.zeros((batch, img_size, img_size, 3), dtype=torch.uint8)


def export_onnx_native(model, spec, path: str, *, img_size: int = 640,
                       batch: int = 1, raw_heads: bool = False,
                       fold_batchnorm: bool = True) -> str:
    """Export the inference forward (uint8 NHWC input, /255 built in, the
    contract of export_model._build_fn) of the `YoloFace` `model` as a
    native ONNX file. raw_heads=True emits the per-stride undecoded maps
    (the reference cpp/export.py contract); the default emits decoded
    (bs, N, no) predictions."""
    m = _model_proto(
        _float_module(model, spec, raw_heads, fold_batchnorm),
        _frames(batch, img_size), _state_names,
        graph_name=f"{spec.name}-{img_size}",
        doc=(f"{spec.name} {img_size}px "
             f"{'raw heads' if raw_heads else 'decoded'}; input uint8 "
             "NHWC RGB network-input frame; exported natively "
             "(no onnx/tf2onnx) from the torch.export ATen graph"))
    return _write(m, path)


def export_onnx_native_fused(model, spec, path: str, *,
                             img_size: int = 640, batch: int = 1,
                             conf_thres: float = 0.25,
                             iou_thres: float = 0.45,
                             max_det: int = 300,
                             fold_batchnorm: bool = True) -> str:
    """Native --export-nms equivalent: model + decode + NMS postprocess
    in one ONNX-13 graph. Output contract (all dynamic K = total
    selections across the batch): out_0 boxes (K,4) xyxy, out_1 scores
    (K,), out_2 classes (K,), out_3 extras (K, 3*nkpt), out_4 batch_index
    (K,) int64."""
    m = _model_proto(
        _float_module(model, spec, False, fold_batchnorm),
        _frames(batch, img_size), _state_names,
        graph_name=f"{spec.name}-{img_size}-nms",
        doc=(f"{spec.name} {img_size}px decoded + fused NMS "
             f"(conf {conf_thres}, iou {iou_thres}, max_det {max_det}); "
             "input uint8 NHWC RGB network-input frame; outputs "
             "boxes/scores/classes/extras/batch_index with dynamic K; "
             "exported natively (no onnx/tf2onnx) from the torch.export "
             "ATen graph"),
        nms=dict(nc=spec.nc, conf_thres=conf_thres, iou_thres=iou_thres,
                 max_det=max_det))
    return _write(m, path)


def _qparams_names(qparams) -> Dict[int, str]:
    """id(tensor) -> `p.<qparams path>` for every tensor of the qparams."""
    names = {}
    for tag, q in qparams["convs"].items():
        for field, t in q.items():
            names[id(t)] = f"p.convs.{tag}.{field}"
    for tag, t in qparams["adds"].items():
        names[id(t)] = f"p.adds.{tag}"
    names[id(qparams["head_scales"])] = "p.head_scales"
    return names


def export_onnx_native_quant(spec, qparams, path: str, *, model,
                             img_size: int = 640, batch: int = 1,
                             raw_heads: bool = False,
                             include_postprocess: bool = False,
                             conf_thres: float = 0.25,
                             iou_thres: float = 0.45,
                             max_det: int = 300) -> str:
    """Export the W8A8 walk (models/quant.quant_apply on the port's
    qparams, the float head of `model`, a `YoloFace`, BN folded) as a
    self-contained int8 ONNX graph: int8 weight initializers,
    `ConvInteger` (int32 accumulate) a conv, the requant epilogues as
    float ops, the float head and decode. include_postprocess=True
    appends the NonMaxSuppression tail of export_onnx_native_fused."""
    from face_detection_multi_scale_tpu_torch import export_model as EM

    if raw_heads and include_postprocess:
        raise ValueError("raw_heads and include_postprocess are "
                         "mutually exclusive")
    qp = EM.qparams_to(qparams, "cpu")
    net = EM.serving_model(model, torch.float32, "cpu")
    ids = _qparams_names(qp)

    def names(target: str, tensor) -> Optional[str]:
        return ids.get(id(tensor)) or (
            _state_names(target, tensor) if target.startswith("net.")
            else None)

    doc_tail = ("; W8A8 int8 (ConvInteger) with calibrated requant "
                "epilogues; input uint8 NHWC RGB network-input frame; "
                "exported natively (no onnx/tf2onnx) from the torch.export "
                "ATen graph")
    nms = None
    if include_postprocess:
        nms = dict(nc=spec.nc, conf_thres=conf_thres, iou_thres=iou_thres,
                   max_det=max_det)
        what = (f"decoded + fused NMS (conf {conf_thres}, iou {iou_thres}, "
                f"max_det {max_det})")
    else:
        what = "raw heads" if raw_heads else "decoded"
    m = _model_proto(
        EM.QuantInferenceModule(net, spec, qp, raw_heads=raw_heads),
        _frames(batch, img_size), names,
        graph_name=f"{spec.name}-{img_size}-int8"
        + ("-nms" if include_postprocess else ""),
        doc=f"{spec.name} {img_size}px {what}" + doc_tail, nms=nms)
    return _write(m, path)
