"""The port's hub inference surface against the JAX package's, on the CPU:
`FaceDetector.predict` / `__call__`, the `Detections` results object
(infer/results.py), the detector's helpers (`save_detection_result`,
`visualize_multi_scale_results`, `export_to_json`,
`compare_preprocessing_methods`) and the constructor's parameter order.

The JAX and port detectors share narrowed-tiny variables (through the
weight bridge). Their conf and IoU thresholds sit in the widest gaps of
the port's own rows over every network input a call gives the engine,
with room for every gated row (as tests/test_torch_detector.py does), so
the frameworks' ulp-level differences cannot flip a gate or a
suppression: `predict`'s rows agree at the decoded-row tolerance of
tests/test_model_parity.py (atol 5e-3, rtol 1e-3) after the inverse
letterbox; rows that went through `.round()` (the pyramid helpers) agree
within 1 px (tests/test_torch_multiscale.py's rule). The `Detections`
object is plain numpy on both sides: its views are equal, and what it
writes is equal byte for byte or pixel for pixel.
"""

import inspect
import json

import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.data import letterbox as JLB
from face_detection_multi_scale_tpu.infer.detector import (
    FaceDetector as JFaceDetector)
from face_detection_multi_scale_tpu.infer.results import (
    Detections as JDetections)
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu_torch import hub
from face_detection_multi_scale_tpu_torch.infer.detector import (
    FaceDetector as TFaceDetector)
from face_detection_multi_scale_tpu_torch.infer.results import (
    Detections as TDetections)
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.parallel.mesh import (
    make_data_mesh)

from test_torch_detector import (
    assert_rows_match, settings_for_rows, shared_variables)
from test_torch_model import narrowed
from test_torch_multiscale import assert_pyramid_rows_match

NAME = "yolov7-tiny-face"


def rng_img(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def pair(inputs, **kw):
    """(JAX, port) FaceDetectors over narrowed tiny with the same
    variables; thresholds in the widest gaps of the port's rows over
    `inputs` (uint8 HWC network inputs), no top-K cut."""
    tdet = TFaceDetector(narrowed(TZ, NAME), variables=shared_variables(NAME),
                         device="cpu", **kw)
    rows = [tdet.forward_rows(x[None])[0].numpy() for x in inputs]
    conf, iou, k = settings_for_rows(rows, capacity=None)
    tdet.conf_thres, tdet.iou_thres, tdet.max_candidates = conf, iou, k
    jdet = JFaceDetector(narrowed(JZ, NAME), variables=shared_variables(NAME),
                         conf_thres=conf, iou_thres=iou, max_candidates=k,
                         **kw)
    return jdet, tdet


def predict_inputs(tmp_path):
    """A file, a PIL image, HWC, CHW and grayscale arrays (the JAX
    test_hub_detections.py kinds); the file is written with cv2."""
    import cv2
    from PIL import Image

    path = str(tmp_path / "img.jpg")
    cv2.imwrite(path, rng_img(2, (160, 240, 3)))
    return [path, Image.fromarray(rng_img(3, (120, 180, 3))),
            rng_img(4, (200, 140, 3)), rng_img(5, (3, 96, 128)),
            rng_img(6, (100, 100))]


def network_batch(det, batch, size):
    """The uint8 batch `predict` gives the engine (captured)."""
    seen = []
    run = det.run_network
    det.run_network = lambda x, **kw: seen.append(x) or run(x, **kw)
    try:
        det.predict(batch, size=size)
    finally:
        del det.run_network
    return seen[0]


def test_predict_matches_jax(tmp_path):
    batch = predict_inputs(tmp_path)
    probe = TFaceDetector(narrowed(TZ, NAME), device="cpu")
    x = network_batch(probe, batch, 128)
    assert x.shape == (5, 128, 128, 3) and x.dtype == np.uint8
    jdet, tdet = pair(list(x), img_sizes=(128,))
    want = jdet.predict(batch, size=128)
    got = tdet.predict(batch, size=128)
    assert isinstance(got, TDetections) and len(got) == len(want) == 5
    assert got.files == want.files and got.files[0] == "img.jpg"
    assert got.s == want.s and got.names == want.names == ["face"]
    assert len(got.t) == 3 and all(t >= 0 for t in got.t)
    kept = 0
    for g, w, gi, wi in zip(got.pred, want.pred, got.imgs, want.imgs):
        np.testing.assert_array_equal(gi, wi)
        assert g.dtype == np.float64 and g.shape[1] == 6
        assert_rows_match(g, w)
        kept += len(g)
    assert kept > 0
    for view in ("xyxyn", "xywh"):
        for g, w in zip(getattr(got, view), getattr(want, view)):
            assert g.shape == w.shape
    # the callable alias, one array
    one = tdet(batch[2], size=128)
    assert len(one) == 1 and one.s == jdet(batch[2], size=128).s


@pytest.mark.parametrize("shapes,size,want", [
    ([(160, 240, 3), (240, 120, 3)], 128, (128, 128)),
    ([(100, 200, 3)], 128, (64, 128)),   # a rectangle, not a square
    ([(90, 100, 3), (50, 300, 3)], 160, (160, 160)),
    ([(512, 640, 3), (640, 640, 3)], 640, (640, 640))])
def test_predict_common_shape_matches_jax(shapes, size, want):
    """max(per-image scaled shapes) rounded up to the stride (JAX
    tests/test_hub_detections.py:141, models/common.py:615-619)."""
    imgs = [rng_img(i, s) for i, s in enumerate(shapes)]
    jdet = JFaceDetector(narrowed(JZ, NAME), variables=shared_variables(NAME),
                         img_sizes=(size,), max_candidates=256)
    tdet = TFaceDetector(narrowed(TZ, NAME), variables=shared_variables(NAME),
                         img_sizes=(size,), max_candidates=256, device="cpu")
    got = tdet.predict(imgs, size=size)
    assert tuple(got.s[1:3]) == want
    assert got.s == jdet.predict(imgs, size=size).s == (len(imgs), *want, 3)


def test_aligned_arrays_need_no_opencv(monkeypatch):
    """Arrays already at the common rectangle are letterboxed without cv2
    (the card machine has no OpenCV): the same batch as with it."""
    import builtins
    import sys

    imgs = [rng_img(7, (96, 128, 3)), rng_img(8, (96, 128, 3))]
    tdet = TFaceDetector(narrowed(TZ, NAME), img_sizes=(128,),
                         max_candidates=256, device="cpu")
    want = tdet.predict(imgs, size=128)
    real_import = builtins.__import__

    def no_cv2(name, *args, **kw):
        if name == "cv2":
            raise ImportError("no OpenCV")
        return real_import(name, *args, **kw)

    monkeypatch.delitem(sys.modules, "cv2", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    got = tdet.predict(imgs, size=128)
    assert got.s == want.s == (2, 96, 128, 3)
    for g, w in zip(got.pred, want.pred):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ImportError):  # a frame to pad to 128 x 128
        tdet.predict([imgs[0], rng_img(9, (128, 128, 3))], size=128)


def synthetic(seed, n_img=2):
    """Images and rows [x1, y1, x2, y2, conf, cls] as the JAX test makes
    them (test_hub_detections.py `_synthetic`)."""
    rng = np.random.default_rng(seed)
    imgs, preds = [], []
    for _ in range(n_img):
        h, w = int(rng.integers(100, 300)), int(rng.integers(100, 300))
        imgs.append(rng.integers(0, 255, (h, w, 3), np.uint8))
        n = int(rng.integers(1, 5))
        x1 = rng.uniform(0, w * 0.6, n)
        y1 = rng.uniform(0, h * 0.6, n)
        preds.append(np.stack([
            x1, y1, x1 + rng.uniform(5, w * 0.4, n),
            y1 + rng.uniform(5, h * 0.4, n),
            rng.uniform(0.2, 1.0, n), rng.integers(0, 2, n)], axis=1))
    return imgs, preds


def both(seed, names=("face", "hand")):
    imgs, preds = synthetic(seed)
    kw = dict(times=(0.0, 0.001, 0.003, 0.0035), names=list(names),
              shape=(2, 128, 128, 3))
    return (JDetections([im.copy() for im in imgs], preds,
                        ["a.jpg", "b.jpg"], **kw),
            TDetections([im.copy() for im in imgs], preds,
                        ["a.jpg", "b.jpg"], **kw))


def test_detections_views_pandas_tolist_match_jax():
    want, got = both(0)
    for k in ("pred", "xyxy", "xywh", "xyxyn", "xywhn"):
        for g, w in zip(getattr(got, k), getattr(want, k)):
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert got.t == want.t and got.s == want.s and got.n == want.n == 2
    gp, wp = got.pandas(), want.pandas()
    for k in ("xyxy", "xyxyn", "xywh", "xywhn"):
        for g, w in zip(getattr(gp, k), getattr(wp, k)):
            assert list(g.columns) == list(w.columns)
            assert g.equals(w), k
    assert list(gp.xyxy[0].columns) == ["xmin", "ymin", "xmax", "ymax",
                                        "confidence", "class", "name"]
    for g, w in zip(got.tolist(), want.tolist()):
        assert len(g) == len(w) == 1
        for k in ("pred", "xyxy", "xywh", "xyxyn", "xywhn"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
        assert g.files == w.files and g.s == w.s


def test_detections_save_crop_render_print_match_jax(tmp_path, capsys):
    import cv2
    from PIL import Image

    want, got = both(1)
    dirs = {}
    for tag, d in (("jax", want), ("port", got)):
        dirs[tag] = (d.save(save_dir=tmp_path / tag / "sv"),
                     d.crop(save_dir=tmp_path / tag / "cr"))
    for (gs, gc), (ws, wc) in [(dirs["port"], dirs["jax"])]:
        names = sorted(p.name for p in gs.iterdir())
        assert names == sorted(p.name for p in ws.iterdir()) == \
            ["a.jpg", "b.jpg"]
        for name in names:
            np.testing.assert_array_equal(np.asarray(Image.open(gs / name)),
                                          np.asarray(Image.open(ws / name)))
        crops = sorted((gc / "crops").rglob("*.jpg"))
        assert [p.relative_to(gc) for p in crops] == \
            [p.relative_to(wc) for p in sorted((wc / "crops").rglob("*.jpg"))]
        assert len(crops) == sum(len(p) for p in got.pred)
        for p in crops:
            np.testing.assert_array_equal(cv2.imread(str(p)),
                                          cv2.imread(str(wc / p.relative_to(
                                              gc))))
    for g, w in zip(got.render(), want.render()):
        np.testing.assert_array_equal(g, w)
    capsys.readouterr()
    got.print()
    printed_port = capsys.readouterr().out
    want.print()
    assert printed_port == capsys.readouterr().out
    assert "image 1/2" in printed_port and "Speed:" in printed_port


@pytest.fixture(scope="module")
def helper_pair():
    """A pair at the pyramid (64, 128), its thresholds safe over every
    input the helpers give the engine for HELPER_IMG: the standard
    (auto=True) and API inputs at both scales."""
    img = rng_img(10, (90, 120, 3))
    stride = narrowed(JZ, NAME).max_stride
    inputs = [JLB.preprocess_standard(img, s, stride, auto=True)
              for s in (64, 128)]
    inputs += [JLB.preprocess_api(img[:, :, ::-1], s, stride)
               for s in (64, 128)]
    jdet, tdet = pair(inputs, img_sizes=(64, 128))
    return jdet, tdet, img


def test_compare_preprocessing_methods_matches_jax(helper_pair):
    jdet, tdet, img = helper_pair
    want = jdet.compare_preprocessing_methods(img, 128)
    got = tdet.compare_preprocessing_methods(img, 128)
    assert set(got) == {"api", "standard"}
    for mode in got:
        assert got[mode]["count"] == want[mode]["count"] > 0
        np.testing.assert_allclose(got[mode]["mean_conf"],
                                   want[mode]["mean_conf"], atol=1e-3)
        assert got[mode]["seconds"] >= 0
    assert not tdet.use_api_preprocess  # restored


def test_visualize_multi_scale_results_matches_jax(helper_pair, tmp_path):
    jdet, tdet, img = helper_pair
    w_scales, w_final = jdet.visualize_multi_scale_results(
        img, str(tmp_path / "j.png"))
    g_scales, g_final = tdet.visualize_multi_scale_results(
        img, str(tmp_path / "t.png"))
    assert len(g_scales) == len(w_scales) == 2
    for g, w in zip(g_scales + [g_final], w_scales + [w_final]):
        assert_pyramid_rows_match(g, np.asarray(w))
    assert (tmp_path / "t.png").stat().st_size > 0


def test_export_and_save_detection_result_match_jax(helper_pair, tmp_path):
    """The same detections through both helpers: byte-equal JSON and a
    pixel-equal PNG."""
    import cv2

    jdet, tdet, img = helper_pair
    final, shape = jdet.detect_multi_scale(img)
    final = np.asarray(final)
    assert len(final) > 0
    final[0, 6] = 7  # a scale index off the pyramid: "unknown" / "?"
    for tag, det in (("j", jdet), ("t", tdet)):
        det.export_to_json(final, shape, str(tmp_path / f"{tag}.json"))
        det.save_detection_result(img, final, str(tmp_path / f"{tag}.png"))
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    data = json.loads((tmp_path / "t.json").read_text())
    tensors = {t["name"]: t for t in data["yolo_face_prediction"]}
    assert tensors["yolo-face-bboxes"]["shape"] == [1, len(final), 4]
    assert tensors["yolo-face-scale_used"]["data"][0][0] == "unknown"
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "t.png")),
                                  cv2.imread(str(tmp_path / "j.png")))


def test_constructor_parameters_follow_jax():
    """The port's FaceDetector takes every parameter of the JAX
    FaceDetector in its order, through calib_images (then `device`), with
    the JAX defaults, so a positional call builds the same serving mode; a
    mesh (ported: tests/test_torch_mesh.py) of one process without a
    process group serves as no mesh."""
    jsig = inspect.signature(JFaceDetector.__init__).parameters
    tsig = inspect.signature(TFaceDetector.__init__).parameters
    jnames, tnames = list(jsig), list(tsig)
    assert jnames[-2:] == ["quantize", "calib_images"]
    assert tnames == jnames + ["device"]
    for name in ("quantize", "calib_images", "tile_min_size", "fuse",
                 "fuse_elan", "micro_batch", "mesh"):
        assert tsig[name].default == jsig[name].default, name
    spec = narrowed(TZ, NAME)
    meshed = TFaceDetector(spec, mesh=make_data_mesh(), device="cpu")
    assert meshed._mesh is None
    # ROADMAP's fault: index 12 is `fuse`, so BN is folded and ELAN is not
    # fused
    det = TFaceDetector(spec, None, None, (64,), 0.5, 0.5, False,
                        torch.float32, 300, 4096, 0, None, True,
                        device="cpu")
    assert det._elan_blocks == []
    assert not any(isinstance(m, torch.nn.BatchNorm2d)
                   for m in det.model.modules())


def test_hub_create_is_callable():
    """hub.create(...) gives a detector whose __call__ (predict) returns a
    Detections of one image."""
    det = hub.create("yolov7-lite-t", device="cpu")
    img = rng_img(11, (96, 128, 3))
    res = det(img)
    assert isinstance(res, TDetections) and len(res) == 1
    assert res.s == (1, 480, 640, 3)
    assert res.pred[0].shape[1] == 6 and np.isfinite(res.pred[0]).all()
