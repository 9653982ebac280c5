"""The port's TTA pyramid against the JAX package on the CPU: the
cross-scale merge (`scale_weights`, `weighted_nms`, `weighted_nms_merge`,
`nms_keep_matrix(max_det)`), the device preprocess
(infer/device_preprocess.py), and the FaceDetector entry points that use
them (`detect_multi_scale`, `detect_multi_scale_batch`, and the device
branches of `detect_single_scale` and `detect_batch`), in the standard
and API preprocess modes, with the same variables on both sides.

Tolerances: merge indices and scale weights exactly; the device
preprocess within 1e-5 of the JAX functions (two float32 bilinear resizes
that round differently) and within tests/test_device_preprocess.py's
2.5/255 max / 0.5/255 mean of host cv2; detections in the same number,
boxes within 1 px (both sides .round() after the inverse letterbox),
confidences and landmarks within the decoded-row tolerance ROW_TOL.
Thresholds lie in the widest gaps of the JAX side's own values over every
network input a detector serves, as tests/test_torch_detector.py's
`safe_settings` places them."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.data import letterbox as JLB
from face_detection_multi_scale_tpu.infer import device_preprocess as JDP
from face_detection_multi_scale_tpu.infer.detector import (
    FaceDetector as JFaceDetector)
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.models.fuse import fold_bn as j_fold_bn
from face_detection_multi_scale_tpu.models.head import decode as j_decode
from face_detection_multi_scale_tpu.ops import nms as JN
from face_detection_multi_scale_tpu_torch.infer import device_preprocess as TDP
from face_detection_multi_scale_tpu_torch.infer.detector import (
    FaceDetector as TFaceDetector)
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.ops import nms as TN
from face_detection_multi_scale_tpu_torch.ops.boxes import box_iou

from test_torch_detector import (
    ROW_TOL, assert_rows_match, jax_apply, shared_variables, widest_gap)
from test_torch_model import narrowed

SHAPES = [(480, 640), (1080, 1920), (500, 375), (640, 640), (123, 457)]
MERGE_NS = [0, 1, 127, 128, 129, 600]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU work on one thread for this module: beside the
    other test workers, torch's thread pool oversubscribes the cores
    (tests/test_torch_quant.py's port-only cases ran 20x slower beside
    one other test process)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand_img(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------

def merged_rows(n, seed):
    """(n, 7) pyramid rows [x1, y1, x2, y2, conf, cls, scale_idx] in
    original-image pixels, rounded as the pyramid rounds them; conf on 8
    levels, so weighted scores tie, and every 5th box a duplicate."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 300, (n, 2))
    wh = rng.uniform(4, 200, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).round()
    boxes[5::5] = boxes[:len(boxes[5::5])]
    conf = rng.choice(np.linspace(0.55, 0.9, 8), n)
    scale = rng.integers(0, 2, n)
    return np.concatenate([boxes, conf[:, None], np.zeros((n, 1)),
                           scale[:, None]], 1)


@pytest.mark.parametrize("num_scales", [1, 2, 3, 5])
def test_scale_weights_bit_exact(num_scales):
    """Sizes on both sides of 1024 and 16384 and on them, every scale
    index: the same float32 weights and weighted scores, bit for bit."""
    rng = np.random.default_rng(num_scales)
    n = 512
    area = rng.choice([1000., 1023.5, 1024., 1024.5, 16000., 16383.,
                       16384., 16385., 20000.], n) * rng.uniform(
                           0.999, 1.001, n)
    w = rng.uniform(8, 256, n)
    xy = rng.uniform(0, 500, (n, 2))
    boxes = np.concatenate([xy, xy + np.stack([w, area / w], 1)], 1)
    boxes[:4] = [[0, 0, 32, 32], [10, 10, 42, 42], [0, 0, 128, 128],
                 [3, 5, 131, 133]]  # exactly 1024 and 16384
    boxes = boxes.astype(np.float32)
    scale = rng.integers(0, num_scales, n).astype(np.float32)
    conf = rng.uniform(0.3, 1.0, n).astype(np.float32)
    want = np.asarray(JN.scale_weights(jnp.asarray(boxes),
                                       jnp.asarray(scale), num_scales))
    got = TN.scale_weights(torch.from_numpy(boxes), torch.from_numpy(scale),
                           num_scales).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal((conf * got).view(np.int32),
                                  np.asarray(jnp.asarray(conf) * want)
                                  .view(np.int32))
    assert len(np.unique(got)) == min(3, num_scales + 1)


@pytest.mark.parametrize("n", MERGE_NS)
def test_nms_keep_matrix_max_det_matches_jax(n):
    rows = merged_rows(n, seed=n)
    boxes = rows[:, :4].astype(np.float32)
    scores = rows[:, 4].astype(np.float32)
    scores[3::11] = TN.NEG_INF
    for max_det in sorted({0, min(n, 50), n}):
        want_idx, want_ok = JN.nms_keep_matrix(boxes, scores, 0.45, max_det)
        idx, ok = TN.nms_keep_matrix(torch.from_numpy(boxes),
                                     torch.from_numpy(scores), 0.45, max_det)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    with pytest.raises(ValueError):
        TN.nms_keep_matrix(torch.from_numpy(boxes), torch.from_numpy(scores),
                           0.45, n + 1)


@pytest.mark.parametrize("n", MERGE_NS)
def test_weighted_nms_matches_jax_at_and_off_the_bucket(n):
    """At the JAX bucket (n padded to a power of two, min 128, with invalid
    rows) the port's indices equal the JAX ones slot for slot; at K = n,
    where the port's merge runs, the kept indices are the same."""
    rows = merged_rows(n, seed=100 + n).astype(np.float32)
    cap = max(128, 1 << max(n - 1, 0).bit_length())
    pad = np.zeros((cap, 7), np.float32)
    pad[:n] = rows
    valid = np.arange(cap) < n
    want_idx, want_ok = JN.weighted_nms(
        jnp.asarray(pad[:, :4]), jnp.asarray(pad[:, 4]),
        jnp.asarray(pad[:, 6]), jnp.asarray(valid), 2, 0.5, cap)
    t = torch.from_numpy(pad)
    idx, ok = TN.weighted_nms(t[:, :4], t[:, 4], t[:, 6],
                              torch.from_numpy(valid), 2, 0.5, cap)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    t = torch.from_numpy(rows)
    idx_n, ok_n = TN.weighted_nms(t[:, :4], t[:, 4], t[:, 6],
                                  torch.ones(n, dtype=torch.bool), 2, 0.5, n)
    np.testing.assert_array_equal(idx_n[ok_n].numpy(), idx[ok].numpy())


@pytest.mark.parametrize("n", MERGE_NS)
@pytest.mark.parametrize("num_scales", [2, 3])
def test_weighted_nms_merge_matches_jax(n, num_scales):
    rows = merged_rows(n, seed=200 + n)
    rows[:, 6] = np.random.default_rng(n).integers(0, num_scales, n)
    want = JN.weighted_nms_merge(rows, num_scales, 0.5)
    got = TN.weighted_nms_merge(rows, num_scales, 0.5, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len(got) == 0 if n == 0 else 0 < len(got) <= n


# ---------------------------------------------------------------------------
# device preprocess
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("auto", [True, False])
@pytest.mark.parametrize("hw", SHAPES)
def test_geometry_matches_jax(hw, auto):
    for size in (640, 200):
        for got, want in (
                (TDP.letterbox_geometry(hw, size, auto=auto, stride=32),
                 JDP.letterbox_geometry(hw, size, auto=auto, stride=32)),
                (TDP.check_img_size_geometry(hw, size, 64, auto),
                 JDP.check_img_size_geometry(hw, size, 64, auto)),
                (TDP.geometry_for_api(hw, size),
                 JDP.geometry_for_api(hw, size))):
            assert dataclasses.astuple(got) == dataclasses.astuple(want)


def close_to_host(dev, host_u8):
    diff = np.abs(dev - host_u8.astype(np.float32) / 255.0)
    assert diff.max() <= 2.5 / 255.0, diff.max()
    assert diff.mean() <= 0.5 / 255.0, diff.mean()


@pytest.mark.parametrize("hw", SHAPES)
def test_device_letterbox_matches_jax_and_cv2(hw):
    img = rand_img(*hw, seed=1)
    for auto in (True, False):
        geom = TDP.letterbox_geometry(hw, 640, auto=auto, stride=32)
        got = TDP.device_letterbox(torch.from_numpy(img[None]), geom)[0]
        want = np.asarray(JDP.device_letterbox(jnp.asarray(img[None]),
                                               JDP.letterbox_geometry(
                                                   hw, 640, auto=auto)))[0]
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        close_to_host(got.numpy(), JLB.preprocess_standard(img, 640, 32,
                                                           auto=auto))


@pytest.mark.parametrize("hw", SHAPES)
def test_device_api_chain_matches_jax_and_cv2(hw):
    img_rgb = rand_img(*hw, seed=2)
    got = TDP.device_preprocess_api(torch.from_numpy(img_rgb[None]), 640)[0]
    want = np.asarray(JDP.device_preprocess_api(jnp.asarray(img_rgb[None]),
                                                640))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    close_to_host(got.numpy(), JLB.preprocess_api(img_rgb, 640, 32))


@pytest.mark.parametrize("src,dst", [((5, 7), (13, 17)), ((37, 23), (11, 9)),
                                     ((8, 8), (3, 29)), ((31, 2), (64, 1))])
def test_resize_matches_jax_at_both_edges(src, dst):
    """Up- and downscales, whole image and its first and last rows and
    columns on their own: torch clamps the source index at the border,
    JAX renormalizes the weights of the pixels that exist."""
    x = np.random.default_rng(3).uniform(0, 255, (1, *src, 3)) \
        .astype(np.float32)
    got = TDP._resize(torch.from_numpy(x).permute(0, 3, 1, 2), dst) \
        .permute(0, 2, 3, 1).numpy()[0] / 255.0
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, *dst, 3),
                                       method="linear",
                                       antialias=False))[0] / 255.0
    for sl in (np.s_[:], np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_allclose(got[sl], want[sl], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the FaceDetector entry points
# ---------------------------------------------------------------------------

SCALES = {"yolov7-tiny-face": (64, 128), "yolov7-w6-face": (128, 192)}
# two BGR images, landscape and portrait, for the pyramid entry points
IMAGES = [rand_img(90, 120, seed=11), rand_img(120, 100, seed=12)]
# two frames of one shape for the device branch of detect_batch
FRAMES = [rand_img(72, 96, seed=13), rand_img(72, 96, seed=14)]


def jax_inputs(name, api, dev):
    """Every network input (float32 HWC in [0, 1]) a detector in this mode
    gives the engine for IMAGES (per image at each scale, and as the
    square batch of `detect_multi_scale_batch` without device preprocess)
    and for FRAMES (device `detect_batch` at the first scale), computed by
    the JAX package."""
    stride = narrowed(JZ, name).max_stride
    out = []
    for size in SCALES[name]:
        for img in IMAGES:
            if dev and api:
                x = JDP.device_preprocess_api(jnp.asarray(img[None, :, :, ::-1]),
                                              size)[0]
            elif dev:
                x = JDP.device_letterbox(jnp.asarray(img[None]),
                                         JDP.letterbox_geometry(
                                             img.shape[:2], size, auto=True,
                                             stride=stride))[0]
            elif api:
                x = JLB.preprocess_api(img[:, :, ::-1], size, stride) / 255.0
            else:
                x = JLB.preprocess_standard(img, size, stride,
                                            auto=True) / 255.0
                out.append(JLB.preprocess_standard(
                    img, size, stride, auto=False) / 255.0)
            out.append(np.asarray(x, np.float32))
    if dev:
        size = SCALES[name][0]
        for img in FRAMES:
            x = (JDP.device_preprocess_api(jnp.asarray(img[None, :, :, ::-1]),
                                           size) if api else
                 JDP.device_letterbox(jnp.asarray(img[None]),
                                      JDP.letterbox_geometry(
                                          img.shape[:2], size, auto=False,
                                          stride=stride)))
            out.append(np.asarray(x[0], np.float32))
    return out


@functools.lru_cache(maxsize=None)
def folded(name):
    return j_fold_bn(shared_variables(name))


@functools.lru_cache(maxsize=None)
def jax_rows(name):
    """The JAX forward and decode of the narrowed model as one jitted
    function, compiled once per input shape (the decode run eagerly
    dispatched its ops one by one for every input)."""
    spec = narrowed(JZ, name)
    return jax.jit(lambda v, x: j_decode(jax_apply(name)(v, x), spec))


@functools.lru_cache(maxsize=None)
def shared_detectors(name, modes):
    """(JAX, port) FaceDetectors over the narrowed model with the same
    variables, at SCALES[name], with conf and IoU thresholds in the widest
    gaps of the JAX side's values over every input of `jax_inputs` in each
    (api, dev) mode of `modes`, and room for every gated row. The tests
    switch one pair between modes, so the JAX side compiles each engine
    shape once."""
    spec = narrowed(JZ, name)
    rows = [np.asarray(jax_rows(name)(folded(name), x[None]))[0]
            for api, dev in modes for x in jax_inputs(name, api, dev)]
    every = np.concatenate(rows)
    obj, conf = every[:, 4], every[:, 5] * every[:, 4]
    lo, hi = np.quantile(conf, [0.6, 0.8])
    conf_thres = widest_gap(np.concatenate([obj, conf]), lo, hi)
    ious = []
    for r in rows:
        gated = r[(r[:, 4] > conf_thres) & (r[:, 5] * r[:, 4] > conf_thres)]
        xy, wh = gated[:, :2], gated[:, 2:4] / 2
        boxes = torch.from_numpy(np.concatenate([xy - wh, xy + wh], 1))
        # the IoUs of the JAX boxes, by the port's function: JAX's would
        # compile once for every count of gated rows
        ious.append(box_iou(boxes, boxes).numpy().ravel())
    iou_thres = widest_gap(np.concatenate(ious), 0.4, 0.6)
    kw = dict(img_sizes=SCALES[name], conf_thres=conf_thres,
              iou_thres=iou_thres, max_candidates=max(len(r) for r in rows),
              max_det=300)
    return (JFaceDetector(spec, variables=shared_variables(name), **kw),
            TFaceDetector(narrowed(TZ, name),
                          variables=shared_variables(name), device="cpu",
                          **kw))


def pyramid_detectors(name, api, dev):
    """The shared pair for `name`, switched to the (api, dev) mode."""
    modes = (((False, True),) if name == "yolov7-w6-face" else
             tuple((a, d) for a in (False, True) for d in (False, True)))
    pair = shared_detectors(name, modes)
    for det in pair:
        det.use_api_preprocess, det.use_device_preprocess = api, dev
    return pair


def assert_pyramid_rows_match(got, want):
    """(n, 7) rows [x1, y1, x2, y2, conf, cls, scale_idx], up to the order
    of near-equal scores: each port row paired with the nearest JAX row,
    one to one; boxes within 1 px, conf within ROW_TOL, class and scale
    equal."""
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.shape[1] == 7 and len(got) > 0
    dist = np.abs(got[:, None, :5] - want[None, :, :5]).max(-1)
    pair = dist.argmin(1)
    assert len(set(pair.tolist())) == len(pair), "rows pair up twice"
    want = want[pair]
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=1)
    np.testing.assert_allclose(got[:, 4], want[:, 4], **ROW_TOL)
    np.testing.assert_array_equal(got[:, 5:], want[:, 5:])


@pytest.mark.parametrize("dev", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("api", [False, True], ids=["standard", "api"])
def test_detect_multi_scale_matches_jax(api, dev):
    jdet, tdet = pyramid_detectors("yolov7-tiny-face", api, dev)
    scales = set()
    for img in IMAGES:
        want, want_shape = jdet.detect_multi_scale(img)
        got, got_shape = tdet.detect_multi_scale(img)
        assert tuple(got_shape) == tuple(want_shape) == img.shape
        assert_pyramid_rows_match(got, np.asarray(want))
        scales |= set(got[:, 6].tolist())
    assert scales == {0, 1}  # both scales survive the merge somewhere


def test_detect_multi_scale_w6_device_matches_jax():
    jdet, tdet = pyramid_detectors("yolov7-w6-face", False, True)
    for img in IMAGES:
        want, _ = jdet.detect_multi_scale(img)
        got, _ = tdet.detect_multi_scale(img)
        assert_pyramid_rows_match(got, np.asarray(want))


@pytest.mark.parametrize("api", [False, True], ids=["standard", "api"])
def test_detect_multi_scale_batch_matches_jax(api):
    jdet, tdet = pyramid_detectors("yolov7-tiny-face", api, False)
    want = jdet.detect_multi_scale_batch(IMAGES)
    got = tdet.detect_multi_scale_batch(IMAGES)
    assert len(got) == len(want) == len(IMAGES)
    for g, w in zip(got, want):
        assert_pyramid_rows_match(g, np.asarray(w))
    if api:  # the same pyramid as detect_multi_scale, image by image
        for g, img in zip(got, IMAGES):
            assert_pyramid_rows_match(g, tdet.detect_multi_scale(img)[0])


@pytest.mark.parametrize("api", [False, True], ids=["standard", "api"])
def test_device_detect_single_scale_matches_jax(api):
    """The device branch without the pyramid's shared upload: the frame is
    uploaded by the call itself."""
    jdet, tdet = pyramid_detectors("yolov7-tiny-face", api, True)
    for size in SCALES["yolov7-tiny-face"]:
        for img in IMAGES:
            want, want_shape, _ = jdet.detect_single_scale(img, size)
            got, got_shape, _ = tdet.detect_single_scale(img, size)
            assert tuple(got_shape) == tuple(want_shape)
            assert_pyramid_rows_match(got, np.asarray(want))


@pytest.mark.parametrize("api", [False, True], ids=["standard", "api"])
def test_device_detect_batch_matches_jax(api):
    """Frames of one shape: raw upload, device letterbox (auto=False) or
    API chain, one engine call; rows with landmarks in original pixels."""
    jdet, tdet = pyramid_detectors("yolov7-tiny-face", api, True)
    size = SCALES["yolov7-tiny-face"][0]
    before = [d.truncation_report() for d in (jdet, tdet)]
    want = jdet.detect_batch(FRAMES, size)
    got = tdet.detect_batch(FRAMES, size)
    assert len(got) == len(want) == len(FRAMES)
    for g, w in zip(got, want):
        assert g.shape[1] == 6 + 15 and len(g) > 0
        assert_rows_match(g, np.asarray(w))
    # this call's telemetry: one image each, the same counts
    jrep, trep = ({k: d.truncation_report()[k] - b[k] for k in
                   ("images", "truncated_images", "dropped_total")}
                  for d, b in zip((jdet, tdet), before))
    assert trep == jrep and trep["images"] == len(FRAMES)
