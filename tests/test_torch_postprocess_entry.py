"""The port's other postprocess entry points against the JAX package's
ops/nms.py, on the CPU, with the same inputs made with numpy:

- `non_max_suppression_from_raws` on the same conv-layout raw maps of a
  narrowed tiny and w6 model, from the float32 and the bf16 JAX network
  (`YoloFace(dtype=bf16)`; their raws are float32, the implicit priors
  promote): the same valid counts and n_gated, rows within the decoded-row
  tolerance of tests/test_model_parity.py (atol 5e-3, rtol 1e-3), since
  the two frameworks' sigmoids differ by ulps. Thresholds and the top-K
  cut sit in the widest gaps of the rows' own values (as in
  tests/test_torch_detector.py), so those ulps cannot flip a gate, a
  suppression or the cut. The port's from_raws also matches its own
  `decode` + `non_max_suppression` at that tolerance;
- `non_max_suppression(agnostic=True/False)` at nc = 3, bit for bit
  against the JAX `backend="xla"` route (tests/test_torch_nms.py's rule);
- `nms_indices` index for index on tests/test_nms.py's cases;
- `merge_nms_boxes` within 1e-5 of max |box|;
- `YoloFace(x, reshape_heads=False)` and `fused_apply(...,
  reshape_heads=False)` raws within tests/test_torch_model.py's raw
  tolerance (atol 2e-4, rtol 1e-3) of the JAX model's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.models.fuse import fold_bn as j_fold_bn
from face_detection_multi_scale_tpu.ops import nms as JN
from face_detection_multi_scale_tpu_torch.models import fused as TF
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.models.head import (
    decode, reshape_level)
from face_detection_multi_scale_tpu_torch.ops import nms as TN

from test_torch_detector import assert_rows_match, settings_for_rows
from test_torch_model import (
    RAW_TOL, images, narrowed, port_model, random_variables)
from test_torch_nms import assert_same, make_pred

MERGE_REL = 1e-5


def random_dets(n, seed, size=640):
    """tests/test_nms.py's candidates (that module skips itself without
    the reference checkout, so it is not imported here)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, size, (n, 2)).astype(np.float32)
    wh = rng.uniform(4, 120, (n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], 1)
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    return boxes, scores


@functools.lru_cache(maxsize=None)
def conv_raws(name, dtype_name, size):
    """JAX conv-layout raws (per level (2, ny, nx, na*no), float32 numpy)
    of a narrowed model with folded weights on 2 seeded images, and the
    variables and images they came from."""
    spec = narrowed(JZ, name)
    variables = random_variables(spec, seed=8)
    x = images(2, size, seed=9)
    dtype = jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32
    apply = jax.jit(functools.partial(
        JM.YoloFace(spec=spec, dtype=dtype).apply, train=False,
        reshape_heads=False))
    raws = apply(j_fold_bn(variables), jnp.asarray(x).astype(dtype))
    assert {str(r.dtype) for r in raws} == {"float32"}
    return [np.array(r) for r in raws], variables, x


def rows_of(raws, spec):
    """The port's decoded rows of conv-layout raws."""
    return decode([reshape_level(torch.from_numpy(r).permute(0, 3, 1, 2),
                                 spec.na, spec.no) for r in raws], spec)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,size", [("yolov7-tiny-face", 128),
                                       ("yolov7-w6-face", 128)])
def test_from_raws_matches_jax(name, size, dtype_name):
    raws, _, _ = conv_raws(name, dtype_name, size)
    spec_t = narrowed(TZ, name)
    rows = rows_of(raws, spec_t)
    conf, iou, k = settings_for_rows(rows.numpy(), capacity=(96, 160))
    want = JN.non_max_suppression_from_raws(
        [jnp.asarray(r) for r in raws], narrowed(JZ, name), conf, iou,
        max_candidates=k, max_det=300, backend="xla")
    got = TN.non_max_suppression_from_raws(
        [torch.from_numpy(r) for r in raws], spec_t, conf, iou,
        max_candidates=k, max_det=300)
    np.testing.assert_array_equal(got.n_gated.numpy(),
                                  np.asarray(want.n_gated))
    assert (got.n_gated.numpy() > k).any()  # the cut truncates
    np.testing.assert_array_equal(got.valid.sum(1).numpy(),
                                  np.asarray(want.valid).sum(1))
    assert not got.classes.any()
    for g, w in zip(TN.detections_to_numpy(got),
                    JN.detections_to_numpy(want)):
        assert len(g) > 0 and g.shape[1] == 6 + 3 * spec_t.nkpt
        assert_rows_match(g, np.asarray(w))
    # and the port's own decode + non_max_suppression on the same raws
    std = TN.non_max_suppression(rows, conf, iou, nc=spec_t.nc,
                                 max_candidates=k, max_det=300)
    np.testing.assert_array_equal(got.n_gated.numpy(), std.n_gated.numpy())
    np.testing.assert_array_equal(got.valid.numpy(), std.valid.numpy())
    for g, w in zip(TN.detections_to_numpy(got),
                    TN.detections_to_numpy(std)):
        assert_rows_match(g, w)


def test_from_raws_without_landmarks_or_candidates():
    """A zero gate count (threshold above every conf) gives no valid row
    and zero landmark blocks of the right width."""
    raws, _, _ = conv_raws("yolov7-tiny-face", "float32", 128)
    spec_t = narrowed(TZ, "yolov7-tiny-face")
    got = TN.non_max_suppression_from_raws(
        [torch.from_numpy(r) for r in raws], spec_t, 1.0, 0.5,
        max_candidates=64, max_det=16)
    assert got.boxes.shape == (2, 16, 4)
    assert got.extras.shape == (2, 16, 3 * spec_t.nkpt)
    assert not got.valid.any() and not got.n_gated.any()
    assert not got.scores.any()


@pytest.mark.parametrize("agnostic", [False, True])
@pytest.mark.parametrize("bs,n,max_cand,max_det,conf,iou", [
    (2, 900, 4096, 300, 0.2, 0.45), (3, 1500, 1024, 100, 0.05, 0.5)])
def test_agnostic_matches_jax(agnostic, bs, n, max_cand, max_det, conf,
                              iou):
    pred = make_pred(bs, n, seed=n + 3, nc=3)
    want = JN.non_max_suppression(jnp.asarray(pred), conf, iou, nc=3,
                                  nkpt=5, max_candidates=max_cand,
                                  max_det=max_det, agnostic=agnostic,
                                  backend="xla")
    got = TN.non_max_suppression(torch.from_numpy(pred), conf, iou, nc=3,
                                 nkpt=5, max_candidates=max_cand,
                                 max_det=max_det, agnostic=agnostic)
    assert_same(got, want)
    assert len(set(got.classes[got.valid].tolist())) == 3


def test_agnostic_suppresses_across_classes():
    """Two boxes of other classes at IoU 0.9: per-class NMS keeps both,
    agnostic NMS the better one."""
    pred = np.zeros((1, 2, 5 + 3 + 15), np.float32)
    pred[0, :, :4] = [[100, 100, 40, 40], [101, 100, 40, 40]]
    pred[0, :, 4] = 1.0
    pred[0, 0, 5 + 1] = 0.9
    pred[0, 1, 5 + 2] = 0.8
    p = torch.from_numpy(pred)
    per_class = TN.non_max_suppression(p, 0.25, 0.5, nc=3)
    agnostic = TN.non_max_suppression(p, 0.25, 0.5, nc=3, agnostic=True)
    assert int(per_class.valid.sum()) == 2
    assert int(agnostic.valid.sum()) == 1
    assert float(agnostic.classes[0, 0]) == 1.0


@pytest.mark.parametrize("n,iou_thres,seed,max_det,masked", [
    (64, 0.45, 0, 64, 0), (256, 0.5, 1, 256, 0), (1024, 0.6, 2, 1024, 0),
    (8, 0.3, 3, 8, 0), (500, 0.99, 7, 10, 0), (128, 0.5, 9, 128, 78)])
def test_nms_indices_matches_jax(n, iou_thres, seed, max_det, masked):
    boxes, scores = random_dets(n, seed)
    if masked:  # invalid candidates at NEG_INF
        scores[n - masked:] = TN.NEG_INF
    want_idx, want_v = JN.nms_indices(boxes, scores, iou_thres, max_det)
    idx, v = TN.nms_indices(torch.from_numpy(boxes),
                            torch.from_numpy(scores), iou_thres, max_det)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    # the same keepers as the keep-mask route, in the same order
    k_idx, k_v = TN.nms_keep_matrix(torch.from_numpy(boxes),
                                    torch.from_numpy(scores), iou_thres,
                                    max_det)
    np.testing.assert_array_equal(idx[v].numpy(), k_idx[k_v].numpy())


@pytest.mark.parametrize("iou_thres", [0.3, 0.6])
def test_merge_nms_boxes_matches_jax(iou_thres):
    pred = make_pred(2, 800, seed=int(iou_thres * 10))
    want = JN.non_max_suppression(jnp.asarray(pred), 0.2, iou_thres,
                                  max_candidates=512, max_det=100,
                                  backend="xla")
    boxes, conf, _, _, valid, _, _ = JN._gather_candidates_planar(
        jnp.asarray(pred), nc=1, conf_thres=0.2, k=512, agnostic=False)
    conf = jnp.where(valid, conf, 0.0)  # the gated candidates weigh
    merged_j = JN.merge_nms_boxes(want, boxes, conf, iou_thres)
    dets = TN.non_max_suppression(torch.from_numpy(pred), 0.2, iou_thres,
                                  max_candidates=512, max_det=100)
    merged_t = TN.merge_nms_boxes(dets, torch.from_numpy(np.asarray(boxes)),
                                  torch.from_numpy(np.asarray(conf)),
                                  iou_thres)
    want_b = np.asarray(merged_j.boxes)
    scale = np.abs(want_b).max()
    np.testing.assert_allclose(merged_t.boxes.numpy(), want_b, rtol=0,
                               atol=MERGE_REL * scale)
    # every other field passes through; a kept box moved, none NaN
    assert torch.equal(merged_t.scores, dets.scores)
    v = dets.valid.numpy()
    assert np.isfinite(merged_t.boxes.numpy()).all()
    assert (np.abs(merged_t.boxes.numpy()[v] - dets.boxes.numpy()[v])
            > 1e-3).any()


@pytest.mark.parametrize("name", ["yolov7-tiny-face", "yolov7-w6-face"])
def test_conv_layout_raws_match_jax(name):
    """reshape_heads=False: the port's raws in the JAX conv layout, from
    the model and from the fused executor (CPU: the plain groups), within
    the raw tolerance of the JAX model's; with reshape_heads=True the same
    values as the reshaped levels."""
    want, variables, x = conv_raws(name, "float32", 128)
    spec = narrowed(TZ, name)
    net = port_model(spec, variables, fuse=True)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = net(xt, reshape_heads=False)
        fused = TF.fused_apply(net, xt, reshape_heads=False)
        reshaped = net(xt)
    assert len(got) == len(want) == spec.nl
    for g, f, r, w in zip(got, fused, reshaped, want):
        assert g.shape == w.shape == (2, *w.shape[1:3], spec.na * spec.no)
        np.testing.assert_allclose(g.numpy(), w, **RAW_TOL)
        np.testing.assert_allclose(f.numpy(), w, **RAW_TOL)
        assert torch.equal(reshape_level(g.permute(0, 3, 1, 2), spec.na,
                                         spec.no), r)
