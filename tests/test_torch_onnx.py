"""The port's native ONNX emitter (onnx/export.py, export_model.export_onnx)
against the JAX package, on the CPU: every file is re-parsed from bytes
and run by the port's copy of the numpy executor (onnx/runner.py), then
compared with the JAX package's own forward on the same weights (a
numpy-seeded variables tree, test_torch_model.random_variables, carried
into the port by the bridge), with the JAX suite's tolerances
(tests/test_onnx_native.py):

- decoded rows and raw heads of narrowed yolov7-tiny-face against
  `model.apply(fold_bn(variables))`: atol 5e-4 / rtol 1e-4 (float32
  convolutions in another order), and the file's structure as JAX checks
  it;
- the fused NonMaxSuppression tail against the JAX live NMS on the same
  weights plus 0.05 weight noise (an untrained net scores a wall of ties
  that two greedy NMSs break differently): per image the same count,
  scores atol 5e-4 / rtol 1e-4, boxes and landmarks atol 5e-3;
- the W8A8 int8 graph with the JAX qparams (`qparams_from_jax`) against
  the JAX `quant_apply`: decoded rows atol 2e-3 / rtol 1e-3 (a Round tie
  may flip one int8 value), and with the fused tail the JAX row bounds
  (scores 2e-3 / 1e-3, boxes 5e-2); ConvInteger over int8 initializers,
  one a conv;
- a port-emitted file run by the JAX runner and by the port's copy: bit
  for bit; a JAX-emitted and a port-emitted file of the same weights
  within 5e-4 of each other; the sidecar as JAX writes it.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from face_detection_multi_scale_tpu import export_model as JEM
from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import quant as JQ
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.models.fuse import fold_bn as j_fold_bn
from face_detection_multi_scale_tpu.models.head import decode as j_decode
from face_detection_multi_scale_tpu.onnx import runner as jrunner
from face_detection_multi_scale_tpu.ops import nms as JN
from face_detection_multi_scale_tpu_torch import export_model as EM
from face_detection_multi_scale_tpu_torch.models import quant as TQ
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.onnx import onnx_pb2 as pb
from face_detection_multi_scale_tpu_torch.onnx import runner
from face_detection_multi_scale_tpu_torch.onnx.export import (
    export_onnx_native, export_onnx_native_fused, export_onnx_native_quant)

from test_torch_detector import jax_apply
from test_torch_model import narrowed, port_model, random_variables

NAME, SIZE, BATCH = "yolov7-tiny-face", 64, 2
TOL = dict(atol=5e-4, rtol=1e-4)
CONF, IOU, MAX_DET = 0.05, 0.5, 20


def noisy(variables):
    """The tree plus 0.05 seeded normal noise on every leaf, as the JAX
    fused-NMS tests add it."""
    prng = np.random.RandomState(3)
    leaves, treedef = jax.tree.flatten(variables)
    return jax.tree.unflatten(
        treedef, [l + 0.05 * prng.normal(size=l.shape).astype(np.float32)
                  for l in leaves])


@pytest.fixture(scope="module")
def tiny():
    """(JAX spec, variables, port spec, frames) of narrowed tiny."""
    jspec, tspec = narrowed(JZ, NAME), narrowed(TZ, NAME)
    frames = np.random.RandomState(0).randint(0, 255,
                                              (BATCH, SIZE, SIZE, 3),
                                              np.uint8)
    return jspec, random_variables(jspec, seed=3), tspec, frames


@pytest.fixture(scope="module")
def weights(tiny):
    """{"plain": the tree, "noisy": the tree plus the noise}."""
    return {"plain": tiny[1], "noisy": noisy(tiny[1])}


@pytest.fixture(scope="module")
def jax_raws(tiny, weights):
    """kind -> the JAX raw maps of the frames (BN folded) for those
    weights, each computed once."""
    jspec, _, _, frames = tiny

    @functools.lru_cache(maxsize=None)
    def raws(kind):
        return [np.asarray(r) for r in jax_apply(NAME)(
            j_fold_bn(weights[kind]), frames.astype(np.float32) / 255.0)]
    return raws


@pytest.fixture(scope="module")
def decoded_file(tiny, tmp_path_factory):
    jspec, variables, tspec, _ = tiny
    path = str(tmp_path_factory.mktemp("onnx") / "tiny.onnx")
    EM.export_onnx(port_model(tspec, variables), tspec, path, img_size=SIZE,
                   batch=BATCH)
    return path


@pytest.mark.parametrize("raw_heads", [False, True])
def test_float_graph_matches_jax(tiny, jax_raws, decoded_file, tmp_path,
                                 raw_heads):
    jspec, variables, tspec, frames = tiny
    if raw_heads:
        path = str(tmp_path / "raw.onnx")
        export_onnx_native(port_model(tspec, variables), tspec, path,
                           img_size=SIZE, batch=BATCH, raw_heads=True)
    else:
        path = decoded_file
    outs = runner.run_onnx(path, {"images": frames})
    raws = jax_raws("plain")
    refs = raws if raw_heads else [np.asarray(j_decode(raws, jspec))]
    assert len(outs) == len(refs)
    for ref, got in zip(refs, outs):
        assert ref.shape == got.shape
        np.testing.assert_allclose(ref, got, **TOL)


def test_float_graph_structure(tiny, decoded_file):
    """The JAX suite's structural checks on the artifact."""
    m = runner.load_model(decoded_file)
    assert m.ir_version >= 7
    assert m.opset_import[0].version == 13
    g = m.graph
    assert [vi.name for vi in g.input] == ["images"]
    dims = [d.dim_value for d in g.input[0].type.tensor_type.shape.dim]
    assert dims == [BATCH, SIZE, SIZE, 3]
    assert g.input[0].type.tensor_type.elem_type == pb.TensorProto.UINT8
    ops = [n.op_type for n in g.node]
    assert {"Conv", "MaxPool", "Sigmoid", "Concat"} <= set(ops)
    # the NHWC input's one transpose: the model's own permute
    assert g.node[[n.op_type for n in g.node].index("Transpose")].input[0] \
        .startswith("div")
    init_names = [t.name for t in g.initializer]
    assert "p.model.0.conv.weight" in init_names
    assert len(init_names) == len(set(init_names))
    convs = [n for n in g.node if n.op_type == "Conv"]
    assert all(n.input[1].startswith("p.") for n in convs)
    assert [o.name for o in g.output] == ["out_0"]


def test_runners_agree_and_jax_file_matches(tiny, decoded_file, tmp_path):
    """The port's file through both runners, bit for bit; the JAX
    package's file of the same weights within 5e-4; the sidecars."""
    jspec, variables, tspec, frames = tiny
    got = runner.run_onnx(decoded_file, {"images": frames})
    via_jax = jrunner.run_onnx(decoded_file, {"images": frames})
    for a, b in zip(got, via_jax):
        np.testing.assert_array_equal(a, b)
    jpath = str(tmp_path / "jax.onnx")
    JEM.export_onnx(JM.YoloFace(spec=jspec), variables, jspec, jpath,
                    img_size=SIZE, batch=BATCH)
    (want,) = runner.run_onnx(jpath, {"images": frames})
    np.testing.assert_allclose(got[0], want, atol=5e-4)
    jmeta, meta = (json.load(open(p + ".json"))
                   for p in (jpath, decoded_file))
    assert meta == jmeta


def test_export_onnx_argument_checks(tiny, tmp_path):
    _, variables, tspec, _ = tiny
    net = port_model(tspec, variables)
    path = str(tmp_path / "m.onnx")
    with pytest.raises(ValueError, match="opset 13"):
        EM.export_onnx(net, tspec, path, img_size=SIZE, opset=11)
    with pytest.raises(ValueError, match="mutually exclusive"):
        EM.export_onnx(net, tspec, path, img_size=SIZE,
                       include_postprocess=True, raw_heads=True)
    with pytest.raises(ValueError, match="tf2onnx"):
        EM.export_onnx(net, tspec, path, img_size=SIZE, raw_heads=True,
                       engine="tf2onnx")


def jax_nms(preds):
    """The JAX live NMS (jitted) of decoded rows at the fused tests'
    settings."""
    return jax.jit(functools.partial(
        JN.non_max_suppression, conf_thres=CONF, iou_thres=IOU, nc=1,
        nkpt=5, max_candidates=256, max_det=MAX_DET, backend="xla"))(preds)


def assert_fused_matches(outs, d, *, score_tol, box_atol, extra_atol):
    boxes, scores, classes, extras, batch_idx = outs
    total = int(np.asarray(d.valid).sum())
    assert total > 0
    assert boxes.shape == (total, 4) and extras.shape == (total, 15)
    assert classes.shape == scores.shape == batch_idx.shape == (total,)
    np.testing.assert_array_equal(classes, 0.0)
    for bi in range(BATCH):
        sel = batch_idx == bi
        v = np.asarray(d.valid[bi])
        assert int(sel.sum()) == int(v.sum())
        np.testing.assert_allclose(scores[sel], np.asarray(d.scores[bi])[v],
                                   **score_tol)
        np.testing.assert_allclose(boxes[sel], np.asarray(d.boxes[bi])[v],
                                   atol=box_atol)
        if extra_atol is not None:
            np.testing.assert_allclose(extras[sel],
                                       np.asarray(d.extras[bi])[v],
                                       atol=extra_atol)


def test_fused_nms_matches_the_jax_live_nms(tiny, weights, jax_raws,
                                            tmp_path):
    jspec, _, tspec, frames = tiny
    path = str(tmp_path / "fused.onnx")
    export_onnx_native_fused(port_model(tspec, weights["noisy"]), tspec,
                             path, img_size=SIZE, batch=BATCH,
                             conf_thres=CONF, iou_thres=IOU,
                             max_det=MAX_DET)
    outs = runner.run_onnx(path, {"images": frames})
    d = jax_nms(j_decode(jax_raws("noisy"), jspec))
    assert_fused_matches(outs, d, score_tol=TOL, box_atol=5e-3,
                         extra_atol=5e-3)


@pytest.fixture(scope="module")
def int8_case(tiny, weights):
    """JAX qparams of the noisy weights (calibrated on seeded frames), the
    port's copy of them, and the JAX int8 walk's decoded rows."""
    jspec, _, tspec, frames = tiny
    variables = weights["noisy"]
    rng = np.random.RandomState(7)
    calib = jnp.asarray(rng.rand(2, SIZE, SIZE, 3), jnp.float32)
    jq = JQ.quantize_model(jspec, variables, calib)
    preds = np.asarray(jax.jit(lambda q, x: j_decode(JQ.quant_apply(
        jspec, q, x, dtype=jnp.float32), jspec))(jq, jnp.asarray(frames)))
    return variables, jq, TQ.qparams_from_jax(jq), preds


@pytest.mark.parametrize("fused", [False, True])
def test_int8_graph_matches_jax_quant_apply(tiny, int8_case, tmp_path,
                                            fused):
    jspec, _, tspec, frames = tiny
    variables, jq, qp, preds = int8_case
    path = str(tmp_path / "int8.onnx")
    net = port_model(tspec, variables)
    if fused:
        export_onnx_native_quant(tspec, qp, path, model=net, img_size=SIZE,
                                 batch=BATCH, include_postprocess=True,
                                 conf_thres=CONF, iou_thres=IOU,
                                 max_det=MAX_DET)
        outs = runner.run_onnx(path, {"images": frames})
        d = jax_nms(preds)
        assert_fused_matches(outs, d, score_tol=dict(atol=2e-3, rtol=1e-3),
                             box_atol=5e-2, extra_atol=None)
        return
    EM.export_onnx(net, tspec, path, img_size=SIZE, batch=BATCH,
                   qparams=qp)
    (got,) = runner.run_onnx(path, {"images": frames})
    assert preds.shape == got.shape
    np.testing.assert_allclose(preds, got, atol=2e-3, rtol=1e-3)
    # structure: the body's convs are ConvInteger over int8 weights, one
    # a conv of the walk; the float head keeps standard Conv
    m = runner.load_model(path)
    ops = {n.op_type for n in m.graph.node}
    assert {"ConvInteger", "Conv", "Round", "Cast"} <= ops
    int8_inits = [t for t in m.graph.initializer
                  if t.data_type == pb.TensorProto.INT8]
    n_convint = sum(n.op_type == "ConvInteger" for n in m.graph.node)
    assert n_convint == len(qp["convs"]) == len(int8_inits)
    assert "p.convs.model_0.w.oihw" in {t.name for t in int8_inits}
    assert json.load(open(path + ".json"))["quantize"] == "int8"
