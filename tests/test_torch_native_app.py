"""The port's standalone native detector app (native/, csrc/fdms_detect.cpp)
and its host postprocess bindings against the JAX package's, and
`cli.export` on the CPU.

- The app against the JAX pipeline on the same raw head maps (yolov7-
  lite-t, numpy-seeded weights, 128 px, conf 0.1, iou 0.45): the same
  row count, boxes within atol 2e-2 and confidences within 1e-4, the
  tolerances of the JAX suite's tests/test_native_app.py; the port's
  dump of the maps as torch tensors is byte for byte the JAX package's
  dump of them as arrays.
- `greedy_nms`, `decode_level` and `scale_coords_inverse` equal the JAX
  bindings' outputs (the same C++ source) on seeded inputs.
- `python -m face_detection_multi_scale_tpu_torch.cli.export --device
  cpu` for pt2, onnx and onnx --quantize int8 --calib-images <npy>:
  each artifact loads and runs, the pt2 one launching `nms_keep` as its
  op, the float ONNX within the JAX suite's 5e-4 of the port's forward.
"""

import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu import native as JNAT
from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.models.head import decode as j_decode
from face_detection_multi_scale_tpu.ops import nms as JN
from face_detection_multi_scale_tpu_torch import export_model as EM
from face_detection_multi_scale_tpu_torch import native as TNAT
from face_detection_multi_scale_tpu_torch.cli import export as CLI
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.onnx import runner

from test_torch_model import random_variables

needs_native = pytest.mark.skipif(
    not (JNAT.available() and TNAT.available()),
    reason="native toolchain unavailable")


@needs_native
def test_app_matches_the_jax_pipeline(tmp_path):
    import jax

    spec = JZ.get_spec("yolov7-lite-t").resolve()
    variables = random_variables(spec, seed=5)
    x = np.random.default_rng(5).random((1, 128, 128, 3), np.float32)
    model = JM.YoloFace(spec=spec)
    raws = [np.asarray(r) for r in jax.jit(
        lambda v, xx: model.apply(v, xx, train=False))(variables, x)]
    rows = JN.detections_to_numpy(jax.jit(lambda r: JN.non_max_suppression(
        j_decode(r, spec), 0.1, 0.45, nc=1, nkpt=5, max_candidates=2048,
        max_det=300, backend="xla"))(raws))[0]
    want = np.asarray(rows)[:, :5]

    tspec = TZ.get_spec("yolov7-lite-t").resolve()
    path = str(tmp_path / "heads.bin")
    TNAT.dump_raw_heads(path, [torch.tensor(r) for r in raws], tspec)
    jpath = str(tmp_path / "jax_heads.bin")
    JNAT.dump_raw_heads(jpath, raws, spec)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    got = TNAT.run_native_detector(path, 0.1, 0.45, 300)
    assert len(want) > 0 and got.shape == want.shape
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=2e-2)
    np.testing.assert_allclose(got[:, 4], want[:, 4], atol=1e-4)
    assert TNAT.app_path().parent.name == "_build"


@needs_native
def test_bindings_equal_the_jax_bindings():
    rng = np.random.default_rng(11)
    xy = rng.uniform(0, 600, (300, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 120, (300, 2))], 1)
    scores = rng.random(300)
    for thr, max_det in ((0.45, None), (0.3, 40)):
        np.testing.assert_array_equal(
            TNAT.greedy_nms(boxes, scores, thr, max_det),
            JNAT.greedy_nms(boxes, scores, thr, max_det))
    raw = rng.normal(0, 2, (3, 5, 7, 21)).astype(np.float32)
    anchors = np.asarray([[4, 5], [6, 8], [10, 12]], np.float32)
    np.testing.assert_array_equal(TNAT.decode_level(raw, anchors, 8.0, 1, 5),
                                  JNAT.decode_level(raw, anchors, 8.0, 1, 5))
    coords = rng.uniform(-20, 660, (50, 4))
    np.testing.assert_array_equal(
        TNAT.scale_coords_inverse(coords, (640, 640), (480, 600)),
        JNAT.scale_coords_inverse(coords, (640, 640), (480, 600)))


def test_build_app_raises_without_a_compiler(monkeypatch, tmp_path):
    """No quiet None: without g++ the app's build raises."""
    monkeypatch.setattr(TNAT, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        TNAT.build_app()


@pytest.mark.parametrize("fmt", ["pt2", "onnx", "onnx-int8"])
def test_cli_export_on_the_cpu(fmt, tmp_path):
    name, size = "yolov7-lite-t", 64
    args = ["--model", name, "--img-size", str(size), "--device", "cpu"]
    frames = np.random.default_rng(1).integers(0, 256, (1, size, size, 3),
                                               dtype=np.uint8)
    if fmt == "pt2":
        out = str(tmp_path / "m.pt2")
        assert CLI.main(args + ["--output", out, "--conf-thres",
                                "0.05"]) == 0
        prog = EM.load_program(out)
        assert prog.meta["include_postprocess"] is True  # pt2's default
        assert EM.op_count(prog.exported, "fdms_torch.nms_keep") == 1
        boxes, scores, classes, extras, valid = prog(frames)
        assert boxes.shape == (1, 252, 4) and valid.dtype == torch.bool
        return
    out = str(tmp_path / "m.onnx")
    extra = []
    if fmt == "onnx-int8":
        calib = str(tmp_path / "calib.npy")
        np.save(calib, frames)
        extra = ["--quantize", "int8", "--calib-images", calib]
    assert CLI.main(args + ["--format", "onnx", "--output", out]
                    + extra) == 0
    (got,) = runner.run_onnx(out, {"images": frames})
    assert got.shape == (1, 252, 21) and np.isfinite(got).all()
    m = runner.load_model(out)
    ops = {n.op_type for n in m.graph.node}
    assert ("NonMaxSuppression" in ops) is False  # onnx's default
    if fmt == "onnx-int8":
        assert "ConvInteger" in ops
        return
    spec, net = CLI.build_model(name, None)
    with torch.no_grad():
        want = EM.InferenceModule(EM.serving_model(net), spec)(
            torch.from_numpy(frames))
    np.testing.assert_allclose(got, want.numpy(), atol=5e-4, rtol=1e-4)


def test_cli_export_refuses_the_jax_formats(capsys):
    for fmt in ("stablehlo", "savedmodel"):
        with pytest.raises(SystemExit):
            CLI.main(["--format", fmt, "--device", "cpu"])
        assert "pt2" in capsys.readouterr().err
