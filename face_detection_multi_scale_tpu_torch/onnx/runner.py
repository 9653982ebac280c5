"""Independent numpy executor for the ONNX op subset the emitters write.

A copy of the JAX package's onnx/runner.py (numpy only; nothing of
torch or JAX), the judge of every file that onnx/export.py writes: the
serialized graph is re-parsed from bytes and re-executed here, then
compared with the port's and the JAX package's own forwards
(tests/test_torch_onnx.py). Ops follow the ONNX-13 operator spec: NCHW
Conv/MaxPool, numpy-style broadcasting on elementwise ops,
Slice/Pad/Expand with tensor operands. An op the emitter needs and this
executor lacks is lowered by the emitter, never added here.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from face_detection_multi_scale_tpu_torch.onnx import onnx_pb2 as pb

_ONNX_TO_NP = {
    pb.TensorProto.FLOAT: np.float32,
    pb.TensorProto.DOUBLE: np.float64,
    pb.TensorProto.FLOAT16: np.float16,
    pb.TensorProto.INT8: np.int8,
    pb.TensorProto.INT32: np.int32,
    pb.TensorProto.INT64: np.int64,
    pb.TensorProto.UINT8: np.uint8,
    pb.TensorProto.BOOL: np.bool_,
}


def tensor_to_np(t: pb.TensorProto) -> np.ndarray:
    if t.data_type not in _ONNX_TO_NP:
        raise NotImplementedError(f"tensor dtype {t.data_type}")
    dt = _ONNX_TO_NP[t.data_type]
    if t.raw_data:
        arr = np.frombuffer(t.raw_data, dtype=dt)
    elif t.data_type == pb.TensorProto.FLOAT:
        arr = np.asarray(t.float_data, np.float32)
    elif t.data_type == pb.TensorProto.INT64:
        arr = np.asarray(t.int64_data, np.int64)
    else:
        raise NotImplementedError("unsupported tensor encoding")
    return arr.reshape(tuple(t.dims))


def _attrs(node: pb.NodeProto) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for a in node.attribute:
        if a.type == pb.AttributeProto.INT:
            out[a.name] = int(a.i)
        elif a.type == pb.AttributeProto.FLOAT:
            out[a.name] = float(a.f)
        elif a.type == pb.AttributeProto.STRING:
            out[a.name] = a.s.decode()
        elif a.type == pb.AttributeProto.INTS:
            out[a.name] = [int(v) for v in a.ints]
        elif a.type == pb.AttributeProto.FLOATS:
            out[a.name] = [float(v) for v in a.floats]
        else:
            raise NotImplementedError(f"attr type {a.type}")
    return out


def _conv2d(x, w, strides, pads, dilations, group, acc_dtype=np.float32):
    n, c, h, wd = x.shape
    o, ci, kh, kw = w.shape
    sh, sw = strides
    dh, dw = dilations
    p0h, p0w, p1h, p1w = pads
    xp = np.pad(x, ((0, 0), (0, 0), (p0h, p1h), (p0w, p1w)))
    eh = (kh - 1) * dh + 1
    ew = (kw - 1) * dw + 1
    out_h = (xp.shape[2] - eh) // sh + 1
    out_w = (xp.shape[3] - ew) // sw + 1
    out = np.zeros((n, o, out_h, out_w), acc_dtype)
    cg = c // group
    og = o // group
    for g in range(group):
        xg = xp[:, g * cg:(g + 1) * cg]
        wg = w[g * og:(g + 1) * og]
        acc = np.zeros((n, og, out_h, out_w), acc_dtype)
        for i in range(kh):
            for j in range(kw):
                xs = xg[:, :, i * dh: i * dh + out_h * sh: sh,
                        j * dw: j * dw + out_w * sw: sw]
                acc += np.einsum("nchw,oc->nohw", xs, wg[:, :, i, j],
                                 dtype=acc_dtype)
        out[:, g * og:(g + 1) * og] = acc
    return out


def _maxpool2d(x, kernel, strides, pads):
    kh, kw = kernel
    sh, sw = strides
    p0h, p0w, p1h, p1w = pads
    lowest = (np.iinfo(x.dtype).min if x.dtype.kind in "iu"
              else -np.inf)  # int8 pooling (the W8A8 export's SPP)
    xp = np.pad(x, ((0, 0), (0, 0), (p0h, p1h), (p0w, p1w)),
                constant_values=lowest)
    out_h = (xp.shape[2] - kh) // sh + 1
    out_w = (xp.shape[3] - kw) // sw + 1
    out = np.full((x.shape[0], x.shape[1], out_h, out_w), lowest,
                  x.dtype)
    for i in range(kh):
        for j in range(kw):
            np.maximum(out, xp[:, :, i: i + out_h * sh: sh,
                               j: j + out_w * sw: sw], out=out)
    return out


def _nms_onnx(boxes, scores, max_out, iou_thr, score_thr,
              center_point_box=0):
    """ONNX-13 NonMaxSuppression: boxes (bs, N, 4), scores (bs, C, N)
    -> selected (K, 3) rows [batch, class, box], batch-major,
    class-major, score-descending within each (batch, class).  IoU is
    symmetric in the two coordinate axes, so corner boxes work for
    either [y1,x1,y2,x2] or [x1,y1,x2,y2] labeling."""
    sel = []
    for bi in range(boxes.shape[0]):
        bxs = boxes[bi].astype(np.float64)
        if center_point_box:
            cx, cy, w, h = (bxs[:, i] for i in range(4))
            x1, y1 = cx - w / 2, cy - h / 2
            x2, y2 = cx + w / 2, cy + h / 2
        else:
            x1, y1, x2, y2 = (bxs[:, i] for i in range(4))
        areas = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        for ci in range(scores.shape[1]):
            s = scores[bi, ci]
            cand = np.nonzero(s > score_thr)[0]
            order = cand[np.argsort(-s[cand], kind="stable")]
            kept: List[int] = []
            for i in order:
                ok = True
                for j in kept:
                    iw = max(0.0, min(x2[i], x2[j]) - max(x1[i], x1[j]))
                    ih = max(0.0, min(y2[i], y2[j]) - max(y1[i], y1[j]))
                    inter = iw * ih
                    union = areas[i] + areas[j] - inter
                    if union > 0 and inter / union > iou_thr:
                        ok = False
                        break
                if ok:
                    kept.append(int(i))
                    if len(kept) >= max_out:
                        break
            sel.extend([bi, ci, i] for i in kept)
    return np.asarray(sel, np.int64).reshape(-1, 3)


def _slice(data, starts, ends, axes, steps):
    idx: List[slice] = [slice(None)] * data.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        dim = data.shape[ax]
        if sp > 0:
            st2 = min(max(st + dim if st < 0 else st, 0), dim)
            en2 = min(max(en + dim if en < 0 else en, 0), dim)
            idx[ax] = slice(st2, en2, sp)
        else:
            st2 = min(max(st + dim if st < -dim else st, -dim - 1), dim - 1)
            en2 = en if en >= -dim - 1 else -dim - 1
            idx[ax] = slice(st2, None if en2 == -dim - 1 else en2, sp)
    return data[tuple(idx)]


def run_model(model: pb.ModelProto, feeds: Dict[str, np.ndarray]):
    g = model.graph
    env: Dict[str, np.ndarray] = {}
    for t in g.initializer:
        env[t.name] = tensor_to_np(t)
    for vi in g.input:
        env[vi.name] = np.asarray(feeds[vi.name])

    for node in g.node:
        op = node.op_type
        a = _attrs(node)
        x = [env[nm] for nm in node.input]
        if op == "Conv":
            y = _conv2d(x[0].astype(np.float32), x[1].astype(np.float32),
                        a.get("strides", [1, 1]), a.get("pads", [0] * 4),
                        a.get("dilations", [1, 1]), a.get("group", 1))
        elif op == "ConvInteger":
            # int8/uint8 conv with exact int32 accumulate (the W8A8
            # export).  Optional zero points (inputs 2/3) are
            # subtracted per spec; our symmetric export omits them.
            xi = x[0].astype(np.int64)
            wi = x[1].astype(np.int64)
            if len(x) > 2 and x[2].size:
                xi = xi - x[2].astype(np.int64)
            if len(x) > 3 and x[3].size:
                wi = wi - x[3].astype(np.int64).reshape(-1, 1, 1, 1)
            y = _conv2d(xi, wi, a.get("strides", [1, 1]),
                        a.get("pads", [0] * 4),
                        a.get("dilations", [1, 1]), a.get("group", 1),
                        acc_dtype=np.int64).astype(np.int32)
        elif op == "Round":
            # ONNX Round is half-to-even, numpy's default
            y = np.round(x[0])
        elif op == "MaxPool":
            y = _maxpool2d(x[0], a["kernel_shape"],
                           a.get("strides", [1, 1]), a.get("pads", [0] * 4))
        elif op == "Transpose":
            y = np.transpose(x[0], a["perm"])
        elif op == "Sigmoid":
            y = 1.0 / (1.0 + np.exp(-x[0].astype(np.float32)))
        elif op == "Add":
            y = x[0] + x[1]
        elif op == "Sub":
            y = x[0] - x[1]
        elif op == "Mul":
            y = x[0] * x[1]
        elif op == "Div":
            y = x[0] / x[1]
        elif op == "Max":
            y = np.maximum(x[0], x[1])
        elif op == "Min":
            y = np.minimum(x[0], x[1])
        elif op == "Neg":
            y = -x[0]
        elif op == "Exp":
            y = np.exp(x[0])
        elif op == "Log":
            y = np.log(x[0])
        elif op == "Sqrt":
            y = np.sqrt(x[0])
        elif op == "Reciprocal":
            y = 1.0 / x[0]
        elif op == "Abs":
            y = np.abs(x[0])
        elif op == "Sign":
            y = np.sign(x[0])
        elif op == "Floor":
            y = np.floor(x[0])
        elif op == "Ceil":
            y = np.ceil(x[0])
        elif op == "Tanh":
            y = np.tanh(x[0])
        elif op == "Pow":
            y = np.power(x[0], x[1])
        elif op == "Greater":
            y = x[0] > x[1]
        elif op == "GreaterOrEqual":
            y = x[0] >= x[1]
        elif op == "Less":
            y = x[0] < x[1]
        elif op == "LessOrEqual":
            y = x[0] <= x[1]
        elif op == "Equal":
            y = x[0] == x[1]
        elif op == "And":
            y = np.logical_and(x[0], x[1])
        elif op == "Or":
            y = np.logical_or(x[0], x[1])
        elif op == "Not":
            y = np.logical_not(x[0])
        elif op == "Where":
            y = np.where(x[0], x[1], x[2])
        elif op == "Concat":
            y = np.concatenate(x, axis=a["axis"])
        elif op == "Reshape":
            y = x[0].reshape(tuple(int(v) for v in x[1]))
        elif op == "Expand":
            y = np.broadcast_to(x[0], tuple(int(v) for v in x[1]))
        elif op == "Identity":
            y = x[0]
        elif op == "Cast":
            to = {v: k for k, v in pb.TensorProto.DataType.items()}
            np_dt = _ONNX_TO_NP[a["to"]]
            del to
            y = x[0].astype(np_dt)
        elif op == "Slice":
            y = _slice(x[0], [int(v) for v in x[1]], [int(v) for v in x[2]],
                       [int(v) for v in x[3]], [int(v) for v in x[4]])
        elif op == "Pad":
            pads = [int(v) for v in x[1]]
            nd = x[0].ndim
            width = [(pads[i], pads[nd + i]) for i in range(nd)]
            cval = float(x[2]) if len(x) > 2 else 0.0
            y = np.pad(x[0], width, constant_values=cval)
        elif op == "ReduceMax":
            y = x[0].max(axis=tuple(a["axes"]),
                         keepdims=bool(a.get("keepdims", 1)))
        elif op == "ReduceSum":
            y = x[0].sum(axis=tuple(int(v) for v in x[1]),
                         keepdims=bool(a.get("keepdims", 1)))
        elif op == "MatMul":
            y = x[0] @ x[1]
        elif op == "Gather":
            y = np.take(x[0], x[1].astype(np.int64),
                        axis=a.get("axis", 0))
        elif op == "Squeeze":
            axes = tuple(int(v) for v in x[1]) if len(x) > 1 else None
            y = np.squeeze(x[0], axis=axes)
        elif op == "Unsqueeze":
            y = np.expand_dims(x[0], tuple(int(v) for v in x[1]))
        elif op == "NonMaxSuppression":
            y = _nms_onnx(
                x[0].astype(np.float32), x[1].astype(np.float32),
                int(x[2]) if len(x) > 2 else 2 ** 31,
                float(x[3]) if len(x) > 3 else 0.0,
                float(x[4]) if len(x) > 4 else -np.inf,
                a.get("center_point_box", 0))
        else:
            raise NotImplementedError(f"runner: op {op}")
        env[node.output[0]] = np.asarray(y)

    return [env[vi.name] for vi in g.output]


def load_model(path: str) -> pb.ModelProto:
    m = pb.ModelProto()
    with open(path, "rb") as f:
        m.ParseFromString(f.read())
    return m


def run_onnx(path: str, feeds: Dict[str, np.ndarray]):
    return run_model(load_model(path), feeds)
