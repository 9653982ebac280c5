"""The port's FaceDetector (device="cpu") against the JAX FaceDetector with
the same variables (through the weight bridge), on `run_network` (the
host-preprocess entry points are in tests/test_torch_detector_host.py).

Thresholds are placed in the widest gap of the JAX side's own values (the
gated confidences and the candidates' pairwise IoUs), and the top-K cut at
the widest confidence step, so the frameworks' ulp-level differences
cannot flip a gate, a suppression or the cut; detections then
agree in count, and boxes, scores and landmarks agree within the decoded-
row tolerance of tests/test_model_parity.py (atol 5e-3, rtol 1e-3)."""

import functools

import jax
import numpy as np
import pytest

from face_detection_multi_scale_tpu.infer.detector import (
    FaceDetector as JFaceDetector)
from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.models.fuse import fold_bn as j_fold_bn
from face_detection_multi_scale_tpu.models.head import decode as j_decode
from face_detection_multi_scale_tpu.ops import nms as JN
from face_detection_multi_scale_tpu_torch.infer.detector import (
    FaceDetector as TFaceDetector)
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.ops import nms as TN

from test_torch_model import narrowed, random_variables

ROW_TOL = dict(atol=5e-3, rtol=1e-3)


def widest_gap(values, lo, hi):
    """Midpoint of the widest gap between consecutive sorted values that
    lies inside [lo, hi]."""
    v = np.unique(np.concatenate([[lo, hi], values[(values > lo)
                                                   & (values < hi)]]))
    i = int(np.argmax(np.diff(v)))
    return float((v[i] + v[i + 1]) / 2)


def safe_settings(spec, variables, frames_u8, capacity):
    """(conf_thres, iou_thres, max_candidates) far from every JAX-side
    value that decides a gate, a suppression or the top-K cut on these
    frames. `capacity` (lo, hi) asks for a cut that truncates some image;
    None leaves room for every gated row."""
    rows = np.asarray(j_decode(jax_apply(spec.name)(
        j_fold_bn(variables), frames_u8.astype(np.float32) / 255.0), spec))
    return settings_for_rows(rows, capacity)


def settings_for_rows(rows, capacity):
    """safe_settings' choice on decoded rows (numpy): (B, N, no), or a
    list of (N_i, no) blocks of images of other sizes."""
    rows = [np.asarray(r) for r in rows]
    every = np.concatenate(rows)
    obj, conf = every[:, 4], every[:, 5] * every[:, 4]
    lo, hi = np.quantile(conf, [0.6, 0.8])
    conf_thres = widest_gap(np.concatenate([obj.ravel(), conf.ravel()]),
                            lo, hi)
    ious, gated_conf = [], []
    for r in rows:
        gated = r[(r[:, 4] > conf_thres) & (r[:, 5] * r[:, 4] > conf_thres)]
        gated_conf.append(np.sort(gated[:, 5] * gated[:, 4])[::-1])
        xy, wh = gated[:, :2], gated[:, 2:4] / 2
        boxes = np.concatenate([xy - wh, xy + wh], 1)
        ious.append(np.asarray(JN.box_iou(boxes, boxes)).ravel())
    iou_thres = widest_gap(np.concatenate(ious), 0.4, 0.6)
    if capacity is None:
        return conf_thres, iou_thres, max(len(r) for r in rows)

    def margin(k):  # the smallest conf step at the cut over cut images
        steps = [c[k - 1] - c[k] for c in gated_conf if len(c) > k]
        return min(steps) if steps else -1.0

    k = max(range(*capacity), key=margin)
    assert margin(k) > 0
    return conf_thres, iou_thres, k


@functools.lru_cache(maxsize=None)
def jax_apply(name):
    """One jitted JAX forward per narrowed zoo model, shared by the tests
    of this file (the compile is most of a test's time)."""
    return jax.jit(functools.partial(
        JM.YoloFace(spec=narrowed(JZ, name)).apply, train=False))


@functools.lru_cache(maxsize=None)
def shared_variables(name):
    return random_variables(narrowed(JZ, name), seed=4)


def detectors(name, frames_u8, capacity=None, **extra):
    spec_j, spec_t = narrowed(JZ, name), narrowed(TZ, name)
    variables = shared_variables(name)
    conf, iou, max_candidates = safe_settings(spec_j, variables, frames_u8,
                                              capacity)
    size = frames_u8.shape[1]
    kw = dict(img_sizes=(size,), conf_thres=conf, iou_thres=iou,
              max_candidates=max_candidates, max_det=300, **extra)
    jdet = JFaceDetector(spec_j, variables=variables, **kw)
    tdet = TFaceDetector(spec_t, variables=variables, device="cpu", **kw)
    return jdet, tdet


def assert_rows_match(got, want):
    """Same rows up to order: equal-score neighbours may come out in either
    order, so each port row is paired with the nearest JAX row (box and
    score), one to one, and the pairs must agree within ROW_TOL."""
    assert got.shape == want.shape, (got.shape, want.shape)
    dist = np.abs(got[:, None, :5] - want[None, :, :5]).max(-1)
    pair = dist.argmin(1)
    assert len(set(pair.tolist())) == len(pair), "rows pair up twice"
    np.testing.assert_allclose(got, want[pair], **ROW_TOL)


@pytest.mark.parametrize("name", ["yolov7-tiny-face", "yolov7-w6-face"])
def test_run_network_matches_jax(name):
    frames = np.random.default_rng(5).integers(0, 256, (2, 128, 128, 3),
                                               dtype=np.uint8)
    jdet, tdet = detectors(name, frames, capacity=(96, 160))
    jd, td = jdet.run_network(frames), tdet.run_network(frames)
    np.testing.assert_array_equal(td.n_gated.numpy(), np.asarray(jd.n_gated))
    np.testing.assert_array_equal(td.valid.sum(1).numpy(),
                                  np.asarray(jd.valid).sum(1))
    for g, w in zip(TN.detections_to_numpy(td), JN.detections_to_numpy(jd)):
        assert len(g) > 0
        assert_rows_match(g, np.asarray(w))
    assert tdet.truncation_report() == jdet.truncation_report()
    assert tdet.truncation_report()["truncated_images"] > 0


def test_reference_state_dict_with_anchor_buffers_loads():
    """A state dict with reference key names that carries the head's anchor
    buffers (as a reference checkpoint does) loads into the port's
    FaceDetector, and its raw maps match the JAX FaceDetector fed the JAX
    converter's tree of the same dict (atol 2e-4 / rtol 1e-3, as
    tests/test_torch_model.py)."""
    import torch
    from face_detection_multi_scale_tpu.models import convert as JC
    from face_detection_multi_scale_tpu_torch.models.convert import (
        jax_to_state_dict)

    name = "yolov7-tiny-face"
    spec_j, spec_t = narrowed(JZ, name), narrowed(TZ, name)
    sd = jax_to_state_dict(shared_variables(name))
    head = sorted({k.split(".")[1] for k in sd}, key=int)[-1]
    assert head == "77"
    anchors = torch.tensor(spec_t.anchors, dtype=torch.float32).view(
        spec_t.nl, spec_t.na, 2)
    sd[f"model.{head}.anchors"] = anchors / torch.tensor(
        spec_t.strides, dtype=torch.float32).view(-1, 1, 1)
    sd[f"model.{head}.anchor_grid"] = anchors.view(spec_t.nl, 1, spec_t.na,
                                                   1, 1, 2)
    tdet = TFaceDetector(spec_t, variables=sd, img_sizes=(96,),
                         device="cpu")
    jdet = JFaceDetector(spec_j, variables=JC.convert_state_dict(sd),
                         img_sizes=(96,))
    x = np.random.default_rng(6).random((2, 96, 96, 3), np.float32)
    with torch.no_grad():
        raws_t = tdet.model(torch.from_numpy(x))
    raws_j = jdet._forward(jdet._serving_variables(), x)
    assert len(raws_t) == len(raws_j) == spec_t.nl
    for rt, rj in zip(raws_t, raws_j):
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=2e-4,
                                   rtol=1e-3)
    with pytest.raises(RuntimeError, match="missing"):
        TFaceDetector(spec_t, variables={k: v for k, v in sd.items()
                                         if not k.endswith(".weight")},
                      device="cpu")
