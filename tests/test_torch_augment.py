"""The port's augmented and ensemble inference (infer/augment.py,
infer/ensemble.py) against the JAX package's, on the CPU, with the same
weights (numpy-seeded JAX trees through the weight bridge) and inputs:

- `scale_img` at 1.0, 0.83 and 0.67 (images in [0, 1]) within 1e-6 of
  the JAX function run op by op (`jax.disable_jit()`, the arithmetic as
  written: the port builds JAX's per-axis weight matrices), and within
  2e-5 of the jitted JAX function. XLA compiles `jax.image.resize`'s
  weights with other roundings (the division by the kernel scale becomes
  a multiply by its reciprocal, among others), which moves the jitted
  output up to 1.1e-5 from the op-by-op one; `F.interpolate(antialias=
  True)` is off by 1.2e-5 even from the op-by-op one;
- `descale_pred`: the lr and ud flips are involutions at scale 1, the
  scale divides the box columns only;
- `forward_augment` and `forward_flip_test` rows within the decoded-row
  tolerance of tests/test_model_parity.py (atol 5e-3, rtol 1e-3);
- `EnsembleDetector.run_network` over (tiny, lite-t), narrowed, against
  the JAX EnsembleDetector: the same n_gated and valid counts, rows at
  that tolerance (thresholds in the widest gaps of the merged rows, as in
  tests/test_torch_detector.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.infer import augment as JA
from face_detection_multi_scale_tpu.infer.detector import (
    FaceDetector as JFaceDetector)
from face_detection_multi_scale_tpu.infer.ensemble import (
    EnsembleDetector as JEnsemble)
from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.models.fuse import fold_bn as j_fold_bn
from face_detection_multi_scale_tpu.ops import nms as JN
from face_detection_multi_scale_tpu_torch.infer import augment as TA
from face_detection_multi_scale_tpu_torch.infer.detector import (
    FaceDetector as TFaceDetector)
from face_detection_multi_scale_tpu_torch.infer.ensemble import (
    EnsembleDetector as TEnsemble)
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.ops import nms as TN

from test_torch_detector import assert_rows_match, settings_for_rows
from test_torch_model import ROW_TOL, images, narrowed, port_model
from test_torch_model import random_variables
from test_torch_zoo_models import model_variables, narrow

SCALE_TOL = 1e-6      # against JAX run op by op
SCALE_JIT_TOL = 2e-5  # against jitted JAX, whose own roundings differ


@pytest.mark.parametrize("ratio", [1.0, 0.83, 0.67])
@pytest.mark.parametrize("hw,gs", [((128, 96), 32), ((200, 312), 64),
                                   ((512, 640), 64)])
def test_scale_img_matches_jax(ratio, hw, gs):
    x = np.random.default_rng(int(ratio * 100)).random((2, *hw, 3),
                                                       np.float32)
    with jax.disable_jit():
        want = np.asarray(JA.scale_img(jnp.asarray(x), ratio, gs=gs))
    want_jit = np.asarray(jax.jit(functools.partial(
        JA.scale_img, ratio=ratio, gs=gs))(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    got = TA.scale_img(xt, ratio, gs=gs)
    assert got.shape == want.shape == want_jit.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SCALE_TOL)
    np.testing.assert_allclose(got.numpy(), want_jit, rtol=0,
                               atol=SCALE_JIT_TOL)
    if ratio == 1.0:
        assert got is xt
    else:  # a gs-multiple canvas whose pad carries PAD_VALUE
        assert got.shape[1] % gs == 0 and got.shape[2] % gs == 0
        assert float(got[0, -1, -1, 0]) == pytest.approx(TA.PAD_VALUE)


def test_descale_pred_round_trips():
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.uniform(0, 640, (1, 50, 21)).astype(np.float32))
    for flip in ("lr", "ud"):
        once = TA.descale_pred(p, flip, 1.0, (480, 640))
        assert torch.allclose(TA.descale_pred(once, flip, 1.0, (480, 640)),
                              p, atol=1e-4)
        want = JA.descale_pred(jnp.asarray(p.numpy()), flip, 1.0, (480, 640))
        np.testing.assert_array_equal(once.numpy(), np.asarray(want))
    scaled = TA.descale_pred(p, None, 2.0, (640, 640))
    assert torch.equal(scaled[..., :4], p[..., :4] / 2)
    assert torch.equal(scaled[..., 4:], p[..., 4:])  # landmarks untouched
    assert not scaled.data_ptr() == p.data_ptr()


@functools.lru_cache(maxsize=None)
def jax_model(name):
    spec = narrowed(JZ, name)
    return JM.YoloFace(spec=spec), j_fold_bn(random_variables(spec, seed=5))


@pytest.mark.parametrize("name", ["yolov7-tiny-face", "yolov7-w6-face"])
def test_forward_augment_and_flip_test_match_jax(name):
    model, jvars = jax_model(name)
    x = images(2, 128, seed=6)
    want_aug = jax.jit(lambda v, x: JA.forward_augment(model, v, x))(
        jvars, jnp.asarray(x))
    want_flip = jax.jit(lambda v, x: JA.forward_flip_test(model, v, x))(
        jvars, jnp.asarray(x))
    net = port_model(narrowed(TZ, name), random_variables(
        narrowed(JZ, name), seed=5), fuse=True)
    got_aug = TA.forward_augment(net, torch.from_numpy(x))
    got_flip = TA.forward_flip_test(net, torch.from_numpy(x))
    n1 = sum(3 * (128 // s) ** 2 for s in net.spec.strides)
    assert got_flip.shape == (2, 2 * n1, net.spec.no)
    assert got_aug.shape[1] > 2 * n1
    for got, want in ((got_aug, want_aug), (got_flip, want_flip)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROW_TOL)


def test_forward_augment_then_nms_on_the_cpu():
    """The augmented rows go through non_max_suppression like any rows
    (the keep mask's plain version on the CPU)."""
    name = "yolov7-tiny-face"
    net = port_model(narrowed(TZ, name), random_variables(
        narrowed(JZ, name), seed=5), fuse=True)
    rows = TA.forward_augment(net, torch.from_numpy(images(1, 96, seed=7)),
                              scales=(1.0, 0.67), flips=(None, "ud"))
    dets = TN.non_max_suppression(rows, 0.1, 0.5, max_candidates=512,
                                  max_det=50)
    assert dets.boxes.shape == (1, 50, 4) and int(dets.valid.sum()) > 0


def ensemble_pair():
    """(JAX ensemble, port ensemble) over narrowed tiny and lite-t with
    the same weights, thresholds in the widest gaps of the merged rows."""
    specs = [(narrowed(JZ, "yolov7-tiny-face"),
              narrowed(TZ, "yolov7-tiny-face")),
             (narrow(JZ, "yolov7-lite-t"), narrow(TZ, "yolov7-lite-t"))]
    variables = [random_variables(specs[0][0], seed=11),
                 model_variables(specs[1][0], seed=12)]
    frames = np.random.default_rng(13).integers(0, 256, (2, 128, 128, 3),
                                                dtype=np.uint8)
    tdets = [TFaceDetector(st, variables=v, img_sizes=(128,), device="cpu")
             for (_, st), v in zip(specs, variables)]
    rows = torch.cat([d.forward_rows(frames) for d in tdets], dim=1)
    conf, iou, k = settings_for_rows(rows.numpy(), capacity=(96, 160))
    kw = dict(conf_thres=conf, iou_thres=iou, max_candidates=k, max_det=300)
    for d in tdets:
        for key, value in kw.items():
            setattr(d, key, value)
    jens = JEnsemble([JFaceDetector(sj, variables=v, img_sizes=(128,), **kw)
                      for (sj, _), v in zip(specs, variables)])
    return jens, TEnsemble(tdets), frames, k


def test_ensemble_matches_jax():
    jens, tens, frames, k = ensemble_pair()
    want, got = jens.run_network(frames), tens.run_network(frames)
    n_rows = sum(3 * sum((128 // s) ** 2 for s in d.spec.strides)
                 for d in tens.detectors)
    assert n_rows == 2 * 1008
    np.testing.assert_array_equal(got.n_gated.numpy(),
                                  np.asarray(want.n_gated))
    assert (got.n_gated.numpy() > k).any()
    np.testing.assert_array_equal(got.valid.sum(1).numpy(),
                                  np.asarray(want.valid).sum(1))
    for g, w in zip(TN.detections_to_numpy(got),
                    JN.detections_to_numpy(want)):
        assert len(g) > 0
        assert_rows_match(g, np.asarray(w))
    assert tens.stride == max(d.stride for d in tens.detectors)
    with pytest.raises(ValueError):
        TEnsemble([])
