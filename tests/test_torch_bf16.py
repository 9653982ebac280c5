"""The port's bfloat16 serving path against the JAX package's
`dtype=jnp.bfloat16`, on the CPU, with the same inputs made with numpy.

Tolerances, with their reasons:
- a fused group (`fused_elan` on bf16 CPU tensors, i.e. its plain
  `reference_elan`) within 1e-2 of max |ref| of the JAX bf16 reference and
  of the JAX bf16 Pallas kernel in interpret mode: each intermediate is
  rounded to bf16 (8 significant bits, 2^-9 relative), and the frameworks'
  f32 sums in another order can round a value to the neighbouring bf16;
- raw maps within 2e-2 of max |JAX float32 raw| per level of the JAX bf16
  raws, unfused (`YoloFace(dtype=bf16)`) and fused (`fused_apply(...,
  dtype=bf16)`, Pallas in interpret mode): a bf16 network against a bf16
  network rounds at other points in every layer (measured 0.6-1.2% at
  width 0.25). The raws are float32 on both sides: the head's implicit
  priors are float32 and promote;
- the postprocess exactly: the same bf16 decoded rows through the port's
  `non_max_suppression` and through the JAX TPU route (the keep mask on
  float32 boxes, `ops/nms.py:287`), compared after a cast to float32.
  The JAX functions run eagerly, one operation at a time, so every bf16
  intermediate is rounded as the port rounds it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.models import fused as JF
from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.models.fuse import fold_bn as j_fold_bn
from face_detection_multi_scale_tpu.ops import nms as JN
from face_detection_multi_scale_tpu.ops import pallas_elan as JE
from face_detection_multi_scale_tpu.ops.pallas_nms import nms_keep_pallas
from face_detection_multi_scale_tpu_torch.infer.detector import (
    FaceDetector as TFaceDetector)
from face_detection_multi_scale_tpu_torch.models import fused as TF
from face_detection_multi_scale_tpu_torch.models import model as TM
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.ops import elan_kernel as TE
from face_detection_multi_scale_tpu_torch.ops import nms as TN

from test_torch_fused_elan import GROUP_CASES, port_shape, to_port_weight
from test_torch_model import images, narrowed, port_model, random_variables

BF = jnp.bfloat16
GROUP_REL = 1e-2
RAW_REL = 2e-2


def bf16_pair(a32: np.ndarray):
    """The same bf16 values for both frameworks: a float32 numpy array
    rounded to bf16 by each (both round to nearest even)."""
    return jnp.asarray(a32).astype(BF), torch.from_numpy(a32).bfloat16()


def f32(a) -> np.ndarray:
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("case", GROUP_CASES, ids=[c[0] for c in GROUP_CASES])
def test_bf16_group_matches_jax(case):
    """Per group case: the port's fused_elan on bf16 CPU tensors against
    the JAX bf16 reference_elan and the JAX bf16 Pallas kernel (interpret
    mode): bf16 x and kernels, float32 biases, a bf16 output."""
    _, kw, (b, h, w), th = case
    shape = JE.ElanShape(**kw)
    rng = np.random.RandomState(0)
    c = shape.pre_cin if shape.has_pre else shape.cin
    x32 = rng.randn(b, h, w, c).astype(np.float32)
    ws32 = [np.asarray(v) for v in jax_weights_f32(rng, shape)]
    xj, _ = bf16_pair(x32)
    # kernels bf16, biases ((1, C)) float32: the JAX packer's bf16 form
    wj = [jnp.asarray(v) if v.shape[0] == 1 else jnp.asarray(v).astype(BF)
          for v in ws32]
    want_ref = JE.reference_elan(xj, wj, shape)
    want_kernel = JE.fused_elan(xj, wj, shape, th=th, interpret=True)
    assert want_ref.dtype == want_kernel.dtype == BF
    xt = torch.from_numpy(x32).permute(0, 3, 1, 2).contiguous().bfloat16()
    wt = [to_port_weight(v) for v in ws32]
    wt = [t.bfloat16() if t.dim() == 4 else t for t in wt]
    got = TE.fused_elan(xt, wt, port_shape(shape))
    assert got.dtype == torch.bfloat16
    got = f32(got).transpose(0, 2, 3, 1)
    for want in (want_ref, want_kernel):
        want = f32(want)
        assert got.shape == want.shape
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < GROUP_REL, err


def jax_weights_f32(rng, shape):
    """tests/test_fused_elan.py's _rand_weights, as float32 numpy."""
    def w(*s):
        return (rng.randn(*s) * 0.2).astype(np.float32)

    ws = []
    if shape.has_pre:
        ws += [w(3, 3, shape.pre_cin, shape.cin), w(1, shape.cin)]
    ws += [w(shape.cin, shape.ccv), w(1, shape.ccv),
           w(shape.cin, shape.ccv), w(1, shape.ccv)]
    cin_k = shape.ccv
    for _ in range(shape.n_chain):
        ws += [w(3, 3, cin_k, shape.cch), w(1, shape.cch)]
        cin_k = shape.cch
    ws += [w(shape.concat_width, shape.cout), w(1, shape.cout)]
    return ws


def jax_raws(name, x32, variables):
    """The JAX raws of one narrowed model on x32 (NHWC float32 in [0, 1]):
    float32 YoloFace, YoloFace(dtype=bf16) and fused_apply(dtype=bf16)
    with the Pallas kernel in interpret mode, folded weights (the
    detector's), each jitted; float32 numpy per level, and the bf16
    forwards' raw dtypes."""
    spec = narrowed(JZ, name)
    jvars = j_fold_bn(variables)
    xb, _ = bf16_pair(x32)
    blocks = JF.find_elan_blocks(spec)
    want32 = jax.jit(functools.partial(JM.YoloFace(spec=spec).apply,
                                       train=False))(jvars, jnp.asarray(x32))
    want_bf = jax.jit(functools.partial(
        JM.YoloFace(spec=spec, dtype=BF).apply, train=False))(jvars, xb)
    want_fused = jax.jit(lambda v, x: JF.fused_apply(
        spec, v, x, blocks=blocks, dtype=BF, interpret=True))(jvars, xb)
    dtypes = {str(r.dtype) for r in [*want_bf, *want_fused]}
    return ([f32(r) for r in want32], [f32(r) for r in want_bf],
            [f32(r) for r in want_fused], dtypes)


@pytest.mark.parametrize("name,size", [("yolov7-w6-face", 128),
                                       ("yolov7-tiny-face", 96)])
def test_bf16_raws_match_jax(name, size):
    """The port's bf16 raws, unfused (the folded model cast to bf16) and
    fused (bf16 kernels and float32 biases packed from the float32 folded
    model), against JAX YoloFace(dtype=bf16) and JAX fused_apply(dtype=
    bf16), per level within RAW_REL of max |JAX float32 raw|. The raws
    are float32 on both sides (the implicit priors promote)."""
    variables = random_variables(narrowed(JZ, name), seed=3)
    x32 = images(2, size, seed=4)
    want32, want_bf, want_fused, dtypes = jax_raws(name, x32, variables)
    assert dtypes == {"float32"}
    spec = narrowed(TZ, name)
    net = port_model(spec, variables, fuse=True)
    blocks = TF.find_elan_blocks(spec)
    weights = TF.elan_weights(net, blocks, torch.bfloat16)
    assert all(w.dtype == (torch.bfloat16 if w.dim() == 4 else torch.float32)
               for ws in weights.values() for w in ws)
    TM.cast_model(net, torch.bfloat16)
    _, x = bf16_pair(x32)
    with torch.no_grad():
        got = net(x)
        got_fused = TF.fused_apply(net, x, blocks, weights)
    for lvl, scale in enumerate(np.abs(r).max() for r in want32):
        for g, wants in ((got, (want_bf, want_fused)),
                         (got_fused, (want_fused, want_bf))):
            assert g[lvl].dtype == torch.float32
            for want in wants:
                err = np.abs(f32(g[lvl]) - want[lvl]).max() / scale
                assert err < RAW_REL, (lvl, err)


def synthetic_rows(seed, n=4096, nkpt=5):
    """Decoded rows (2, n, 6 + 3 nkpt) of the decode's form, float32:
    clustered boxes (so suppression has work), obj and cls in (0, 1),
    landmarks near the boxes. As bf16, many confidences tie."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 640, (2, 40, 2))
    xy = centers[:, rng.integers(0, 40, n)] + rng.normal(0, 6, (2, n, 2))
    wh = rng.uniform(8, 200, (2, n, 2))
    score = rng.uniform(0, 1, (2, n, 2))
    kpt = np.concatenate([xy[..., None, :] + rng.normal(0, 10, (2, n, nkpt, 2)),
                          rng.uniform(0, 1, (2, n, nkpt, 1))], -1)
    return np.concatenate([xy, wh, score, kpt.reshape(2, n, -1)],
                          -1).astype(np.float32)


@pytest.mark.parametrize("k,conf,iou,max_det", [(1024, 0.3, 0.5, 300),
                                                (2048, 0.55, 0.45, 100)])
def test_bf16_postprocess_matches_jax_tpu_route(k, conf, iou, max_det):
    """The same bf16 rows through the port's non_max_suppression and
    through the JAX route a TPU takes (gather, the keep mask on float32
    boxes by the Pallas kernel in interpret mode, select): Detections
    equal after a cast to float32, n_gated equal. One image truncates at
    K = 1024."""
    pj, pt = bf16_pair(synthetic_rows(seed=k))
    boxes, cf, cls, nms_boxes, valid, top_idx, n_gated = \
        JN._gather_candidates_planar(pj, nc=1, conf_thres=conf, k=k,
                                     agnostic=False)
    keep = nms_keep_pallas(nms_boxes.astype(jnp.float32), valid, iou,
                           interpret=True)
    want = JN._select_kept_planar(keep, boxes, cf, cls, top_idx, pj, nc=1,
                                  max_det=max_det)
    got = TN.non_max_suppression(pt, conf, iou, nc=1, max_candidates=k,
                                 max_det=max_det)
    assert got.boxes.dtype == torch.bfloat16
    assert int(got.valid.sum()) > 0
    for field in ("boxes", "scores", "classes", "extras", "valid"):
        np.testing.assert_array_equal(f32(getattr(got, field)),
                                      f32(getattr(want, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(got.n_gated.numpy(), np.asarray(n_gated))
    rows = TN.detections_to_numpy(got)
    assert all(r.dtype == np.float32 and r.shape[1] == 21 for r in rows)


@pytest.fixture(scope="module")
def bf16_detector():
    """A narrowed tiny bf16 FaceDetector on the CPU, pyramid (64, 128),
    with a gate that the random net's rows clear."""
    det = TFaceDetector(narrowed(TZ, "yolov7-tiny-face"),
                        img_sizes=(64, 128), dtype=torch.bfloat16,
                        max_candidates=512, device="cpu")
    frames = np.random.default_rng(5).integers(0, 256, (2, 100, 140, 3),
                                               dtype=np.uint8)
    rows = det.forward_rows(np.zeros((1, 128, 128, 3), np.uint8))
    conf = (rows[..., 4] * rows[..., 5]).float().flatten()
    det.conf_thres = float(conf.sort(descending=True)[0][len(conf) // 8])
    return det, frames


def test_bf16_detector_entry_points_run(bf16_detector):
    """FaceDetector(dtype=bf16, device="cpu"): bf16 convs, float32 rows
    (the implicit head promotes, as in JAX), and detect_single_scale,
    detect_multi_scale and detect_batch in their output contracts."""
    det, frames = bf16_detector
    assert det.model.model[0].conv.weight.dtype == torch.bfloat16
    assert det.model.model[-1].im[0].implicit.dtype == torch.float32
    rows = det.forward_rows(frames[:, :64, :64])
    assert rows.dtype == torch.float32
    dets = det.run_network(frames[:, :64, :64])
    assert all(r.dtype == np.float32 for r in TN.detections_to_numpy(dets))
    out, shape, _ = det.detect_single_scale(frames[0], 128)
    assert shape == frames[0].shape and out.shape[1] == 7
    final, shape = det.detect_multi_scale(frames[1])
    assert shape == frames[1].shape and final.shape[1] == 7
    assert len(final) > 0 and set(final[:, 6].tolist()) <= {0, 1}
    batch = det.detect_batch(list(frames), 128)
    assert len(batch) == 2 and all(r.shape[1] == 21 for r in batch)
    assert det.truncation_report()["images"] > 0


def test_bf16_tiled_and_batched_entry_points_run():
    """The tiled branches in bf16 on the CPU: a narrowed tiny detector with
    its 256 px scale as 2 x 2 tiles of 192 (API preprocess) through
    detect_multi_scale_batch, detect_single_scale and detect_batch, with
    one truncation entry an image."""
    det = TFaceDetector(narrowed(TZ, "yolov7-tiny-face"), img_sizes=(64, 256),
                        dtype=torch.bfloat16, use_api_preprocess=True,
                        tile_top_scale=2, tile_halo=64, tile_min_size=256,
                        max_candidates=512, device="cpu")
    assert det._tile_plan(256).tile == 192 and det._tile_plan(64) is None
    rows = det.forward_rows(np.zeros((1, 192, 192, 3), np.uint8))
    conf = (rows[..., 4] * rows[..., 5]).float().flatten()
    det.conf_thres = float(conf.sort(descending=True)[0][len(conf) // 8])
    frames = np.random.default_rng(8).integers(0, 256, (2, 100, 140, 3),
                                               dtype=np.uint8)
    outs = det.detect_multi_scale_batch(list(frames))
    assert len(outs) == 2 and all(o.shape[1] == 7 and len(o) for o in outs)
    assert all(set(o[:, 6].tolist()) <= {0, 1} for o in outs)
    images = det.truncation_report()["images"]
    out, shape, _ = det.detect_single_scale(frames[0], 256)
    assert shape == frames[0].shape and out.shape[1] == 7 and len(out)
    batch = det.detect_batch(list(frames), 256)
    assert len(batch) == 2 and all(r.shape[1] == 21 for r in batch)
    assert det.truncation_report()["images"] == images + 3


@pytest.mark.parametrize("size", [96, 128])
def test_bf16_device_preprocess_matches_jax(size):
    """The bf16 device preprocess (cast, then resize and pad in bf16)
    against the JAX one. Each rounds the resized pixel to bf16 (steps of
    1/255 between 128/255 and 1) and again after the /255, at its own
    points of the resize, so each lies within 2/255 of the float32
    preprocess and the two within 4/255 of each other."""
    from face_detection_multi_scale_tpu.infer import device_preprocess as JD
    from face_detection_multi_scale_tpu_torch.infer import (
        device_preprocess as TD)
    img = np.random.default_rng(6).integers(0, 256, (1, 90, 130, 3),
                                            dtype=np.uint8)
    geom = TD.letterbox_geometry((90, 130), size, auto=False, stride=32)
    jgeom = JD.letterbox_geometry((90, 130), size, auto=False, stride=32)
    pairs = [
        (TD.device_letterbox(torch.from_numpy(img), geom,
                             dtype=torch.bfloat16),
         JD.device_letterbox(jnp.asarray(img), jgeom, dtype=BF),
         TD.device_letterbox(torch.from_numpy(img), geom)),
        (TD.device_preprocess_api(torch.from_numpy(img), size,
                                  dtype=torch.bfloat16),
         JD.device_preprocess_api(jnp.asarray(img), size, dtype=BF),
         TD.device_preprocess_api(torch.from_numpy(img), size))]
    for got, want, exact in pairs:
        assert got.dtype == torch.bfloat16 and want.dtype == BF
        assert got.shape == exact.shape == want.shape
        np.testing.assert_allclose(f32(got), exact.numpy(), atol=2 / 255)
        np.testing.assert_allclose(f32(want), exact.numpy(), atol=2 / 255)
        np.testing.assert_allclose(f32(got), f32(want), atol=4 / 255)


def test_bf16_fused_detector_matches_unfused():
    """A fused ("pre:") bf16 detector: float32 biases in its weight cache,
    and rows those of the unfused bf16 detector within RAW_REL of their
    largest value."""
    spec = narrowed(TZ, "yolov7-tiny-face")
    kw = dict(img_sizes=(64,), dtype=torch.bfloat16, device="cpu")
    plain = TFaceDetector(spec, **kw)
    fused = TFaceDetector(spec, fuse_elan="pre:", **kw)
    assert all(w.dtype == torch.float32 for ws in fused._elan_weights.values()
               for w in ws if w.dim() == 1)
    frames = np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    a, b = plain.forward_rows(frames), fused.forward_rows(frames)
    err = float((a.float() - b.float()).abs().max() / a.float().abs().max())
    assert err < RAW_REL, err


def test_unported_dtype_raises():
    with pytest.raises(NotImplementedError, match="float16"):
        TFaceDetector(narrowed(TZ, "yolov7-tiny-face"), dtype=torch.float16,
                      device="cpu")
