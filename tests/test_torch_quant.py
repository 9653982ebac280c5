"""The port's W8A8 int8 serving (models/quant.py, ops/qconv_kernel.py,
FaceDetector(quantize="int8")) against the JAX package's models/quant.py
and its int8 FaceDetector, on the CPU. About 90 s on one worker.

Weights are numpy-seeded random ones (test_torch_model.random_variables:
lecun-scaled kernels, random BN statistics and biases), so activations
have real ranges, as the JAX suite's `_noisy_model` gives them, without
its flax init (20 s a model here); both packages get the same tree. The
JAX functions run jitted. Tolerances, with their reasons:
- calibration amax within 1e-5 relative: two float32 walks whose convs
  sum in another order;
- alpha and inv_out within 1e-5 relative (they follow the amax); each
  conv's bias within 1e-5 of its max |bias|: bias = beta - mean * g, and
  XLA's rsqrt (g) differs from the correctly rounded one in the last bit,
  which a bias near cancellation turns into a large relative error; the
  int8 weights equal, except where w / s_w lies within 1e-4 of a half
  integer, where the float32 folds may round to either side (at most 1
  apart);
- one conv (`qconv_plain` against XLA's int32 conv and the JAX epilogue):
  the int32 sums bit for bit; the int8 outputs equal, except at most 1
  apart where the pre-round value lies within 1e-4 of a half integer
  (the activations' last bits differ between the frameworks);
- the int8 walk with the same qparams (`qparams_from_jax`): raws within
  2e-2 of max |JAX raw| per level and correlation > 0.9999 (a flipped
  int8 code near a rounding tie moves later layers slightly);
- the detectors, each calibrating itself: the same detection count, the
  top box within 1.0 px and its conf within 1e-2, tighter than the JAX
  suite's int8-against-float bounds (2.0 px, 0.02).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.infer.detector import (
    FaceDetector as JFaceDetector)
from face_detection_multi_scale_tpu.models import layers as JL
from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import quant as JQ
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.models.spec import Node
from face_detection_multi_scale_tpu_torch.infer.detector import (
    FaceDetector as TFaceDetector)
from face_detection_multi_scale_tpu_torch.models import model as TM
from face_detection_multi_scale_tpu_torch.models import quant as TQ
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.ops import qconv_kernel as QK

from test_quant import _calib_batch
from test_torch_model import port_model, random_variables

MODELS = ("yolov7-tiny-face", "yolov7s-face", "yolov7-lite-t")
REL = 1e-5
HALF_TOL = 1e-4
RAW_SHARE = 2e-2


def near_half(v: np.ndarray) -> np.ndarray:
    return np.abs(v - np.floor(v) - 0.5) < HALF_TOL


def rel_close(got, want, what, per_tensor=False):
    """|got - want| <= REL * |want| elementwise, or REL * max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    ref = np.abs(want).max() if per_tensor else np.abs(want)
    assert (err <= REL * ref + 1e-30).all(), (what, err.max())


@functools.cache
def noisy_model(name):
    """(JAX spec, variables) of one zoo model, numpy-seeded."""
    jspec = JZ.get_spec(name).resolve()
    return jspec, random_variables(jspec, seed=3)


@functools.cache
def pair(name):
    """JAX and port calibrations and qparams of one model at 64 px, from
    the same variables and images."""
    jspec, variables = noisy_model(name)
    x = _calib_batch()
    jcal = JQ.calibrate(jspec, variables, jnp.asarray(x))
    jq = jax.jit(lambda v: JQ.quantize(jspec, v, jcal))(variables)
    net = port_model(TZ.get_spec(name).resolve(), variables)
    tcal = TQ.calibrate(net.spec, net, torch.from_numpy(x))
    tq = TQ.quantize(net.spec, net, tcal)
    return jspec, variables, x, jcal, jq, net, tcal, tq


def partitions(cal):
    return {t: frozenset(u for u in cal.amax
                         if cal.groups.find(u) == cal.groups.find(t))
            for t in cal.amax}


@pytest.mark.parametrize("name", MODELS)
def test_calibration_matches_jax(name):
    _, variables, _, jcal, _, net, tcal, _ = pair(name)
    assert tcal.in_tag == jcal.in_tag
    assert tcal.head_in_tags == jcal.head_in_tags
    assert tcal.add_in == jcal.add_in
    assert partitions(tcal) == partitions(jcal)
    assert set(tcal.amax) == set(jcal.amax)
    for t, v in jcal.amax.items():
        rel_close(tcal.amax[t], v, t)
    # the structural walk on the meta device finds the same graph
    shape = TQ.calibrate_shape_only(net.spec, net)
    assert shape.in_tag == jcal.in_tag
    assert shape.head_in_tags == jcal.head_in_tags
    assert shape.add_in == jcal.add_in
    assert partitions(shape) == partitions(jcal)
    assert set(shape.amax.values()) == {1.0}
    if name == "yolov7-lite-t":
        assert jcal.add_in  # the requanted ADDs are exercised


@pytest.mark.parametrize("name", MODELS)
def test_quantize_matches_jax(name):
    _, variables, _, jcal, jq, _, _, tq = pair(name)
    assert set(tq["convs"]) == set(jq["convs"])
    for tag, q in jq["convs"].items():
        t = tq["convs"][tag]
        for key in ("alpha", "bias", "inv_out"):
            rel_close(t[key].numpy(), np.asarray(q[key]), f"{tag} {key}",
                      per_tensor=key == "bias")
        want = np.transpose(np.asarray(q["w"]), (3, 0, 1, 2))
        got = t["w"].numpy()
        assert got.dtype == np.int8 and got.shape == want.shape, tag
        w, _ = JQ.fold_by_tag(variables, tag)
        s_w = np.maximum(np.abs(np.asarray(w)).max(axis=(0, 1, 2)),
                         1e-12) / 127.0
        ratio = np.transpose(np.asarray(w) / s_w, (3, 0, 1, 2))
        diff = np.abs(got.astype(int) - want.astype(int))
        assert (diff <= 1).all() and (diff[~near_half(ratio)] == 0).all(), \
            (tag, int((diff > 0).sum()))
    assert set(tq["adds"]) == set(jq["adds"])
    for tag, v in jq["adds"].items():
        rel_close(tq["adds"][tag].numpy(), np.asarray(v), tag)
    rel_close(tq["head_scales"].numpy(), np.asarray(jq["head_scales"]),
              "head_scales")


ACTS = ("none", "silu", "leaky", "relu")
CONV_CASES = [(act, k, s, dw) for act in ACTS for k in (1, 3)
              for s in (1, 2) for dw in (False, True)]


@pytest.mark.parametrize("act,k,s,dw", CONV_CASES)
def test_qconv_plain_matches_jax_conv(act, k, s, dw):
    """qconv_plain (and the wrapper on CPU tensors) against XLA's int32
    conv and the JAX epilogue (quant.py:521-530), ragged Cin."""
    rng = np.random.default_rng(CONV_CASES.index((act, k, s, dw)))
    cin = (3, 12, 56, 13)[(k + 2 * s) % 4]
    cout, groups = (cin, cin) if dw else (24, 1)
    x = rng.integers(-127, 128, (2, 11, 13, cin), dtype=np.int8)
    w = rng.integers(-127, 128, (k, k, cin // groups, cout), dtype=np.int8)
    alpha = rng.uniform(1e-5, 2e-4, cout).astype(np.float32)
    bias = rng.normal(0, 0.5, cout).astype(np.float32)
    inv_out = np.float32(37.7)
    p = k // 2
    y32 = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (s, s), [(p, p), (p, p)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32)
    yf = y32.astype(jnp.float32) * jnp.asarray(alpha).reshape(1, 1, 1, -1) \
        + jnp.asarray(bias).reshape(1, 1, 1, -1)
    z = np.asarray(JQ._act_apply(act, yf) * jnp.float32(inv_out))
    want = np.asarray(jnp.clip(jnp.round(z), -127, 127).astype(jnp.int8))

    tx = torch.from_numpy(x)
    tw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 0, 1, 2)))
    ta, tb = torch.from_numpy(alpha), torch.from_numpy(bias)
    sums = QK.conv_sums(tx, tw, s, (p, p), groups)
    assert sums.dtype == torch.int32
    np.testing.assert_array_equal(sums.numpy(), np.asarray(y32))
    inv = torch.tensor(inv_out)
    for got in (QK.qconv_plain(tx, tw, ta, tb, inv, s, (p, p), groups, act),
                QK.qconv(tx, tw, ta, tb, inv, s, (p, p), groups, act)):
        assert got.dtype == torch.int8 and got.shape == want.shape
        diff = np.abs(got.numpy().astype(int) - want.astype(int))
        assert (diff <= 1).all() and (diff[~near_half(z)] == 0).all()


def test_qconv_rejects_bad_inputs():
    x = torch.zeros(1, 8, 8, 4, dtype=torch.int8)
    w = torch.zeros(6, 3, 3, 4, dtype=torch.int8)
    a, b = torch.ones(6), torch.zeros(6)
    with pytest.raises(TypeError):
        QK.qconv(x.float(), w, a, b, 1.0, 1, (1, 1))
    with pytest.raises(ValueError):
        QK.qconv(x, w, a, b, 1.0, 1, (1, 1), groups=2)
    with pytest.raises(ValueError):
        QK.qconv(x, w, a[:3], b, 1.0, 1, (1, 1))
    with pytest.raises(ValueError):
        QK.qconv(x, w, a, b, 1.0, 1, (1, 1), act="gelu")
    assert QK.qconv(x, w, a, b, 1.0, 1, (1, 1)).shape == (1, 8, 8, 6)


@pytest.mark.parametrize("op", ["pool5", "pool_ceil", "pool3s2", "upsample",
                                "reorg", "shuffle", "mp", "spf"])
def test_int8_stateless_ops_match_jax(op):
    """The NHWC int8 ops of the walk against the JAX ones on the same
    int8 values (JAX pools int8 directly)."""
    rng = np.random.default_rng(len(op))
    x = rng.integers(-127, 128, (2, 9, 11, 8), dtype=np.int8)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    fns = {
        "pool5": (lambda a: JL.max_pool(a, 5, 1, 2),
                  lambda a: TQ.max_pool(a, 5, 1, 2)),
        "pool_ceil": (lambda a: JL.max_pool(a, 2, 2, 0, ceil_mode=True),
                      lambda a: TQ.max_pool(a, 2, 2, 0, ceil_mode=True)),
        "pool3s2": (lambda a: JL.max_pool(a, 3, 2, 1),
                    lambda a: TQ.max_pool(a, 3, 2, 1)),
        "upsample": (JL.upsample2x_nearest, TQ.upsample2x_nearest),
        "reorg": (lambda a: JL.reorg(a[:, :8, :10]),
                  lambda a: TQ.reorg(a[:, :8, :10])),
        "shuffle": (lambda a: JL.channel_shuffle(a, 2),
                    lambda a: TQ.channel_shuffle(a, 2)),
    }
    if op in ("mp", "spf"):
        node = Node(-1, 1, op.upper(), (2,) if op == "mp" else (5,))
        fns[op] = (lambda a: JM.apply_stateless_op(node.op, node, a),
                   lambda a: TQ._nchw_pool(lambda y: TQ.apply_stateless_op(
                       node.op, node.args, y), a))
    jfn, tfn = fns[op]
    got = tfn(tx)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(jx)))


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_apply_matches_jax(name, dtype):
    """Both int8 walks with JAX's qparams (carried by qparams_from_jax),
    the head in float32 or bf16."""
    jspec, variables, x, _, jq, _, _, _ = pair(name)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    want = [np.asarray(r, np.float32) for r in jax.jit(
        lambda q, xx: JQ.quant_apply(jspec, q, xx, dtype=jdt))(
            jq, jnp.asarray(x))]
    net = TM.cast_model(port_model(TZ.get_spec(name).resolve(), variables,
                                fuse=True), tdt)
    got = TQ.quant_apply(net.spec, TQ.qparams_from_jax(jq),
                         torch.from_numpy(x), net.model[-1], dtype=tdt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.float().numpy()
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.abs(g - w).max() <= RAW_SHARE * np.abs(w).max()
        assert np.corrcoef(g.ravel(), w.ravel())[0, 1] > 0.9999


@pytest.mark.parametrize("name", ["yolov7-tiny-face", "yolov7-lite-t"])
def test_detector_int8_matches_jax(name):
    """FaceDetector(quantize="int8") in both packages, each calibrating
    lazily on its first batch, as the JAX suite's end-to-end test."""
    _, variables = noisy_model(name)
    img = np.random.RandomState(11).randint(0, 255, (96, 128, 3), np.uint8)
    kw = dict(model=name, img_sizes=(64,), conf_thres=0.05, iou_thres=0.5,
              max_det=20, max_candidates=256, quantize="int8")
    jdet = JFaceDetector(variables=variables, **kw)
    tdet = TFaceDetector(variables=variables, device="cpu", **kw)
    assert tdet._qparams is None  # lazy
    want, _, _ = jdet.detect_single_scale(img, 64)
    got, _, _ = tdet.detect_single_scale(img, 64)
    assert tdet._qparams is not None
    qid = id(tdet._qparams)
    again, _, _ = tdet.detect_single_scale(img, 64)
    assert id(tdet._qparams) == qid  # the calibration is reused
    np.testing.assert_array_equal(again, got)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got[0][:4], want[0][:4], atol=1.0)
    assert abs(got[0][4] - want[0][4]) < 1e-2


def test_detector_int8_errors():
    spec = "yolov7-lite-t"
    with pytest.raises(ValueError, match="mutually exclusive"):
        TFaceDetector(spec, quantize="int8", fuse_elan=True, device="cpu")
    with pytest.raises(ValueError, match="quantize must be"):
        TFaceDetector(spec, quantize="int4", device="cpu")
    img = np.random.RandomState(3).randint(0, 255, (96, 128, 3), np.uint8)
    det = TFaceDetector(spec, img_sizes=(64,), quantize="int8",
                        use_device_preprocess=True, device="cpu")
    with pytest.raises(RuntimeError, match="explicit calibration"):
        det.detect_single_scale(img, 64)
    with pytest.raises(RuntimeError, match="explicit calibration"):
        det.detect_batch([img, img], 64)
    with pytest.raises(RuntimeError, match="before warmup"):
        det.warmup(64)
    # calib_images= calibrates at construction; then both work
    frames = np.random.RandomState(4).randint(0, 255, (2, 64, 64, 3),
                                              np.uint8)
    det = TFaceDetector(spec, img_sizes=(64,), quantize="int8",
                        use_device_preprocess=True, calib_images=frames,
                        device="cpu")
    assert det._qparams is not None
    det.warmup(64)
    rows, _, _ = det.detect_single_scale(img, 64)
    assert rows.shape[1] == 7 and np.isfinite(rows).all()


@pytest.mark.parametrize("name", TZ.available())
def test_zoo_entries_build_int8(name):
    """Every zoo entry constructs with quantize="int8": the structural walk
    covers each backbone conv of the model with one tag. The weights come
    as a state dict (the module's default init), which skips the seeded
    init's truncated-normal draws, 6 s for w6 here."""
    weights = TM.YoloFace(TZ.get_spec(name).resolve()).state_dict()
    det = TFaceDetector(name, weights, img_sizes=(64,), quantize="int8",
                        device="cpu")
    cal = TQ.calibrate_shape_only(det.spec, det._float_model)
    convs = sum(isinstance(m, torch.nn.Conv2d)
                for m in det._float_model.model[:-1].modules())
    assert len(cal.in_tag) == convs
    assert len(cal.head_in_tags) == det.spec.nl
