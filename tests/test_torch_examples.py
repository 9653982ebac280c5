"""The port's examples (examples/*_torch.py, examples/demo_torch.ipynb) and
its container (deploy/Dockerfile.torch) on the CPU, against the JAX
package's calls that the JAX examples make, with the same weights: the
JAX `save_inference_weights` file of numpy-seeded yolov7-lite-t variables
(test_torch_model.random_variables), which both packages load from disk.

- (a) demo_torch.run against the JAX hub.create detector with the same
  calls on the same frame: single-scale rows at the decoded-row
  tolerance (tests/test_torch_detector.py's `assert_rows_match`, atol
  5e-3 / rtol 1e-3), the multi-scale merge at the tolerance of
  tests/test_torch_multiscale.py (`assert_pyramid_rows_match`: boxes,
  rounded to pixels on both sides, within 1 px; conf within the row
  tolerance).
- (b) detect_simple_torch.run against the JAX FaceDetector.detect_batch,
  at the same tolerance. One JAX detector serves (a) and (b), switched
  between the API and the standard preprocess, with thresholds in the
  widest gaps of the JAX side's own values over every network input the
  two cases give it (`settings_for_rows`).
- (c) exported_inference_torch: the loaded `.pt2`'s rows equal the live
  FaceDetector's on the same input and weights, and the ONNX consumer's
  count is the one the script prints.
- (d) each example's main() on a small seeded image written with cv2, in
  the test's directory: the outputs the JAX script writes.
- (e) the notebook's code cells, in order, in one namespace, under
  matplotlib's Agg backend.
- (f) deploy/Dockerfile.torch: every COPY source exists, and the entry
  point's module parses the entry point's flags.
"""

import contextlib
import io
import json
import re
import shlex
import sys
import tempfile
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu import hub as JH
from face_detection_multi_scale_tpu.data import letterbox as JLB
from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.models.fuse import fold_bn as j_fold_bn
from face_detection_multi_scale_tpu.models.head import decode as j_decode
from face_detection_multi_scale_tpu.train.checkpoint import (
    save_inference_weights)
from face_detection_multi_scale_tpu_torch import export_model as EM
from face_detection_multi_scale_tpu_torch.cli import serve as TSERVE
from face_detection_multi_scale_tpu_torch.data import letterbox as TLB
from face_detection_multi_scale_tpu_torch.infer import detector as TDET
from face_detection_multi_scale_tpu_torch.ops import nms as TN

from test_torch_detector import assert_rows_match, settings_for_rows
from test_torch_model import random_variables
from test_torch_multiscale import assert_pyramid_rows_match

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))

import demo_torch  # noqa: E402
import detect_simple_torch  # noqa: E402
import exported_inference_torch  # noqa: E402

MODEL, SIZES = "yolov7-lite-t", (128, 256)
# the JAX demo's frame: 480x640 BGR noise
FRAME = np.random.default_rng(0).integers(0, 255, (480, 640, 3), np.uint8)


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


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX-written .npz of lite-t's numpy-seeded variables."""
    path = tmp_path_factory.mktemp("weights") / "lite-t.npz"
    save_inference_weights(str(path), random_variables(
        JZ.get_spec(MODEL).resolve(), seed=31))
    return str(path)


@pytest.fixture(scope="module")
def jax_case(weights):
    """The one JAX build: hub.create as the JAX demo calls it, at
    thresholds in the widest gaps of the JAX rows over every network input
    of (a) and (b): the API preprocess at both sizes, the standard one at
    the first."""
    from face_detection_multi_scale_tpu.train.checkpoint import (
        load_inference_weights)

    spec = JZ.get_spec(MODEL).resolve()
    variables = j_fold_bn(load_inference_weights(weights))
    apply = jax.jit(lambda v, x: j_decode(JM.YoloFace(spec=spec).apply(
        v, x, train=False), spec))
    inputs = [JLB.preprocess_api(FRAME[:, :, ::-1], s, spec.max_stride)
              for s in SIZES]
    inputs.append(JLB.preprocess_standard(FRAME, SIZES[0], spec.max_stride))
    rows = [np.asarray(apply(variables, (x[None] / 255.0).astype(
        np.float32)))[0] for x in inputs]
    conf, iou, _ = settings_for_rows(rows, None)
    jdet = JH.create(MODEL, weights=weights, img_sizes=SIZES,
                     conf_thres=conf, iou_thres=iou, use_api_preprocess=True)
    return jdet, conf, iou


def test_demo_run_matches_jax(weights, jax_case):
    jdet, conf, iou = jax_case
    jdet.use_api_preprocess = True
    out = demo_torch.run(FRAME, weights, model=MODEL, img_sizes=SIZES,
                         conf_thres=conf, iou_thres=iou, device="cpu")
    assert out["det"].img_sizes == list(SIZES)
    want, want_shape, _ = jdet.detect_single_scale(FRAME, SIZES[0])
    assert tuple(want_shape) == FRAME.shape
    assert len(out["rows"]) > 0
    assert_rows_match(out["rows"], np.asarray(want))
    want, want_shape = jdet.detect_multi_scale(FRAME)
    assert tuple(out["shape"]) == tuple(want_shape) == FRAME.shape
    assert_pyramid_rows_match(out["final"], np.asarray(want))
    assert set(out["final"][:, 6].tolist()) == {0, 1}


def test_detect_simple_run_matches_jax(weights, jax_case):
    jdet, conf, iou = jax_case
    jdet.use_api_preprocess = False  # FaceDetector's default
    rows, seconds = detect_simple_torch.run(
        FRAME, weights, model=MODEL, img_size=SIZES[0], conf_thres=conf,
        iou_thres=iou, device="cpu")
    want = jdet.detect_batch([FRAME], SIZES[0], kpt=True)[0]
    assert rows.shape[1] == 6 + 15 and len(rows) > 0 and seconds > 0
    assert_rows_match(rows, np.asarray(want))


def image_file(tmp_path: Path, seed: int) -> str:
    img = np.random.default_rng(seed).integers(0, 255, (96, 128, 3),
                                               np.uint8)
    path = tmp_path / "img.png"
    assert cv2.imwrite(str(path), img)
    return str(path)


def run_main(mod, argv, where: Path, **override):
    """mod.main(argv) in `where`, with `run` wrapped to keep what it was
    given and what it returned, its keywords updated by `override`;
    (main's return, run's result, stdout, run's arguments)."""
    kept, given = [], []
    real = mod.run

    def run(*a, **k):
        given.append((a, k))
        kept.append(real(*a, **{**k, **override}))
        return kept[-1]

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.chdir(where)
        mp.setattr(mod, "run", run)
        rc = mod.main(argv)
    assert len(kept) == 1
    return rc, kept[0], buf.getvalue(), given[0]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """exported_inference_torch.main on a seeded image, on the CPU."""
    where = tmp_path_factory.mktemp("exported")
    img = image_file(where, 41)
    return where, img, run_main(exported_inference_torch,
                                [img, "--device", "cpu"], where)


def test_exported_program_matches_live_detector(exported):
    _, _, (rc, out, stdout, _) = exported
    assert rc == 0
    spec, net, x = out["spec"], out["model"], out["x"]
    assert spec.name == MODEL and x.shape == (1, 256, 256, 3)
    live = TDET.FaceDetector(spec, variables=net.state_dict(),
                             img_sizes=(256,), conf_thres=0.25,
                             iou_thres=0.45, max_candidates=EM.MAX_CANDIDATES,
                             max_det=300, device="cpu")
    rows = TN.detections_to_numpy(live.run_network(x))[0].astype(np.float64)
    ratio, pad = out["ratio_pad"]
    shape = out["image"].shape[:2]
    if len(rows):
        TLB.scale_coords((256, 256), rows[:, :4], shape,
                         ratio_pad=(ratio, pad))
        rows[:, 6:] = TLB.scale_coords((256, 256), rows[:, 6:], shape,
                                       ratio_pad=(ratio, pad), kpt=True,
                                       step=3)
    assert len(out["rows"]) > 0
    np.testing.assert_array_equal(out["rows"], rows)
    n = len(out["onnx_keep"])
    assert n > 0 and len(set(out["onnx_keep"].tolist())) == n
    assert (f"ONNX consumer path: {n} detections (fused-artifact path "
            f"found {len(out['rows'])})") in stdout


def test_exported_main_writes_result(exported):
    where, _, (rc, out, stdout, _) = exported
    img = cv2.imread(str(where / "exported_result.jpg"))
    assert rc == 0 and img is not None
    assert img.shape == out["image"].shape == (96, 128, 3)
    assert f"{len(out['rows'])} detections" in stdout


def test_demo_main_writes_result(tmp_path, weights):
    """main with the JAX demo's arguments (image, weights); its `run`
    computes on lite-t at (128, 256) instead of the default tiny at
    (640, 1280), which (a) and chip_smoke phase 28 drive."""
    img = image_file(tmp_path, 42)
    _, out, stdout, (args, kw) = run_main(
        demo_torch, [img, weights, "--device", "cpu"], tmp_path,
        model=MODEL, img_sizes=SIZES)
    assert args[1] == weights and kw == {"device": "cpu"}
    assert args[0].shape == (96, 128, 3)
    assert out["det"].img_sizes == list(SIZES)
    assert cv2.imread(str(tmp_path / "demo_result.jpg")).shape == (96, 128,
                                                                  3)
    doc = json.loads((tmp_path / "demo_result.json").read_text())
    assert "yolo_face_prediction" in doc
    assert f"{len(out['final'])} faces" in stdout


def test_detect_simple_main_writes_result(tmp_path, weights):
    img = image_file(tmp_path, 44)
    argv = ["--image", img, "--model", MODEL, "--weights", weights,
            "--img-size", "128", "--device", "cpu"]
    rc, (rows, _), stdout, _ = run_main(detect_simple_torch, argv,
                                        tmp_path)
    assert rc == 0 and f"{len(rows)} faces" in stdout
    drawn = cv2.imread(str(tmp_path / "img_det.png"))
    assert drawn is not None and drawn.shape == (96, 128, 3)


def test_notebook_runs(tmp_path, monkeypatch):
    import matplotlib

    matplotlib.use("Agg")
    nb = json.loads((ROOT / "examples" / "demo_torch.ipynb").read_text())
    cells = ["".join(c["source"]) for c in nb["cells"]
             if c["cell_type"] == "code"]
    assert len(cells) == 7  # the JAX notebook's code cells, one for one
    monkeypatch.chdir(ROOT / "examples")  # the first cell's repo root
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ns = {"__name__": "__main__"}
    with contextlib.redirect_stdout(io.StringIO()):
        for i, src in enumerate(cells):
            exec(compile(src, f"demo_torch.ipynb cell {i}", "exec"), ns)
    assert ns["DEVICE"] == "cpu"
    assert ns["rows"].shape[1] == 7 and len(ns["final"]) > 0
    assert ns["det"].img_sizes == [128, 256]
    assert "yolo_face_prediction" in ns["doc"]


def test_dockerfile_torch(monkeypatch):
    text = (ROOT / "deploy" / "Dockerfile.torch").read_text()
    lines = re.sub(r"\\\n", " ", text).splitlines()
    copies = [shlex.split(l)[1:-1] for l in lines if l.startswith("COPY")]
    assert copies and all((ROOT / src).exists()
                          for srcs in copies for src in srcs)
    assert "ARG BASE" in text and "FROM ${BASE}" in text
    entry = json.loads(next(l for l in lines if l.startswith("ENTRYPOINT"))
                       [len("ENTRYPOINT"):])
    assert entry[:3] == ["python", "-m",
                         "face_detection_multi_scale_tpu_torch.cli.serve"]
    # the entry point's flags reach the server: a stand-in detector and
    # server, so nothing is built or bound
    seen = {}

    class Detector:
        def __init__(self, model, **kw):
            seen["detector"] = (model, kw)

        def warmup(self, size):
            seen["warmup"] = size

    class Server:
        def __init__(self, addr, handler):
            seen["addr"] = addr

        def serve_forever(self):
            seen["served"] = True

    monkeypatch.setattr(TDET, "FaceDetector", Detector)
    monkeypatch.setattr(TSERVE, "ThreadingHTTPServer", Server)
    with contextlib.redirect_stdout(io.StringIO()):
        assert TSERVE.main(entry[3:]) == 0
    assert seen["addr"] == ("0.0.0.0", 5000) and seen["served"]
    assert seen["detector"][1]["device"] == "cuda"  # the card by default
