"""The port's micro-batching (`FaceDetector(micro_batch=)`) and local
checkpoint loading (`FaceDetector(torch_weights=)`) against the JAX
FaceDetector on the CPU, with the same weights.

Micro-batching: the chunked engine gives the whole batch's Detections
(the same keepers, values within 1e-4: each chunk's convolutions sum in
another order) on `run_network` and `run_network_raw`, runs the whole
batch with one "does not divide" warning when the chunk does not divide
it, and matches the JAX detector's `micro_batch` (lax.map) at the
decoded-row tolerance ROW_TOL. Thresholds and the top-K cut lie in the
widest gaps of the JAX side's values (`safe_settings`).

Checkpoints, each written in the test's own directory: an EMA-keyed
half-precision `.pt` (a training checkpoint whose "model" holds other
weights), a model-keyed one with `ema: None`, a raw state dict carrying
the head's anchor buffers, and the JAX package's inference `.npz`
(`save_inference_weights`). The port's raw maps match the JAX
FaceDetector loading the same file within atol 2e-4 / rtol 1e-3
(tests/test_torch_model.py)."""

import copy
import warnings

import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.infer.detector import (
    FaceDetector as JFaceDetector)
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.ops import nms as JN
from face_detection_multi_scale_tpu.train.checkpoint import (
    save_inference_weights)
from face_detection_multi_scale_tpu_torch.infer.detector import (
    FaceDetector as TFaceDetector)
from face_detection_multi_scale_tpu_torch.models import model as TM
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.models.convert import (
    jax_to_state_dict)
from face_detection_multi_scale_tpu_torch.ops import nms as TN
from face_detection_multi_scale_tpu_torch.utils import downloads as TD

from test_torch_detector import (
    assert_rows_match, safe_settings, shared_variables)
from test_torch_model import narrowed
from torch_shared import release_redirect

NAME = "yolov7-tiny-face"
SIZE = 128
MB = 4
RAW_TOL = dict(atol=2e-4, rtol=1e-3)
FRAMES = np.random.default_rng(8).integers(0, 256, (12, SIZE, SIZE, 3),
                                           dtype=np.uint8)


# ---------------------------------------------------------------------------
# micro_batch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def settings():
    """Detector keywords with thresholds and a truncating top-K cut safe
    for the frames and for their channel swap (the raw path's network
    input)."""
    conf, iou, k = safe_settings(
        narrowed(JZ, NAME), shared_variables(NAME),
        np.concatenate([FRAMES, FRAMES[..., ::-1]]), (96, 160))
    return dict(img_sizes=(SIZE,), conf_thres=conf, iou_thres=iou,
                max_candidates=k, max_det=300)


def port_detector(settings, micro_batch=None):
    return TFaceDetector(narrowed(TZ, NAME), variables=shared_variables(NAME),
                         micro_batch=micro_batch, device="cpu", **settings)


def engine(entry, det, frames):
    if entry == "run_network":
        return det.run_network(frames)
    dets, geom = det.run_network_raw(torch.from_numpy(frames), SIZE,
                                     auto=False)
    assert geom.out_hw == (SIZE, SIZE)
    return dets


def assert_same_detections(got, want):
    """The same keepers in the same slots, values within 1e-4."""
    for name in ("valid", "n_gated", "classes"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in ("boxes", "scores", "extras"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("entry", ["run_network", "run_network_raw"])
@pytest.mark.parametrize("batch", [12, 9])
def test_micro_batch_matches_whole_batch(settings, entry, batch):
    """12 frames run as 3 chunks of 4; 9 frames run whole, with one
    warning that 4 does not divide 9."""
    frames = FRAMES[:batch]
    whole = port_detector(settings)
    chunked = port_detector(settings, micro_batch=MB)
    calls = []
    forward = chunked.forward_rows if entry == "run_network" else \
        chunked.forward_input

    def counted(x):
        calls.append(x.shape[0])
        return forward(x)

    if entry == "run_network":
        chunked.forward_rows = counted
    else:
        chunked.forward_input = counted
    if batch % MB:
        with pytest.warns(RuntimeWarning, match="does not divide"):
            got = engine(entry, chunked, frames)
        with warnings.catch_warnings():  # once
            warnings.simplefilter("error")
            engine(entry, chunked, frames)
        assert calls == [batch, batch]
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = engine(entry, chunked, frames)
        assert calls == [MB] * (batch // MB)
    want = engine(entry, whole, frames)
    assert got.boxes.shape[0] == batch
    assert_same_detections(got, want)
    assert int(got.valid.sum()) > 0
    rep = chunked.truncation_report()
    assert rep["images"] == batch * (2 if batch % MB else 1)
    if not batch % MB:
        assert rep == whole.truncation_report()
        assert rep["truncated_images"] > 0


def test_micro_batch_matches_jax(settings):
    jdet = JFaceDetector(narrowed(JZ, NAME), variables=shared_variables(NAME),
                         micro_batch=MB, **settings)
    tdet = port_detector(settings, micro_batch=MB)
    jd, td = jdet.run_network(FRAMES), tdet.run_network(FRAMES)
    np.testing.assert_array_equal(td.n_gated.numpy(), np.asarray(jd.n_gated))
    np.testing.assert_array_equal(td.valid.sum(1).numpy(),
                                  np.asarray(jd.valid).sum(1))
    for g, w in zip(TN.detections_to_numpy(td), JN.detections_to_numpy(jd)):
        assert len(g) > 0
        assert_rows_match(g, np.asarray(w))
    assert tdet.truncation_report() == jdet.truncation_report()


# ---------------------------------------------------------------------------
# torch_weights=
# ---------------------------------------------------------------------------

def reference_state_dict(spec):
    """The shared weights under reference key names, with the head's
    anchor buffers as a reference checkpoint carries them."""
    sd = jax_to_state_dict(shared_variables(NAME))
    head = max({k.split(".")[1] for k in sd}, key=int)
    anchors = torch.tensor(spec.anchors, dtype=torch.float32).view(
        spec.nl, spec.na, 2)
    sd[f"model.{head}.anchors"] = anchors / torch.tensor(
        spec.strides, dtype=torch.float32).view(-1, 1, 1)
    sd[f"model.{head}.anchor_grid"] = anchors.view(spec.nl, 1, spec.na,
                                                   1, 1, 2)
    return sd


class Holder(torch.nn.Module):
    """A picklable stand-in for a reference checkpoint's module: nested
    submodules named after the state dict's keys, holding its tensors
    (floating ones as parameters, the rest as buffers)."""

    def __init__(self, state_dict):
        super().__init__()
        for key, value in state_dict.items():
            *path, leaf = key.split(".")
            mod = self
            for part in path:
                if part not in mod._modules:
                    mod.add_module(part, torch.nn.Module())
                mod = mod._modules[part]
            if value.is_floating_point():
                mod.register_parameter(leaf, torch.nn.Parameter(
                    value.clone(), requires_grad=False))
            else:
                mod.register_buffer(leaf, value.clone())


def write_checkpoint(kind, spec, path):
    """Write `kind` to `path`; returns the state dict the detector must
    end up with (reference key names, float32)."""
    sd = reference_state_dict(spec)
    if kind == "ema_half":
        ema = Holder(sd).half()
        other = TM.init_weights(TM.YoloFace(spec),
                                torch.Generator().manual_seed(1))
        other = Holder(other.state_dict()).half()
        torch.save({"epoch": 7, "model": other, "ema": ema,
                    "optimizer": None}, path)
        return {k: v.half().float() if v.is_floating_point() else v
                for k, v in sd.items()}
    if kind == "model_no_ema":
        torch.save({"epoch": 7, "model": Holder(sd), "ema": None}, path)
    elif kind == "raw_with_anchors":
        torch.save(sd, path)
    else:  # the JAX package's inference weights
        save_inference_weights(str(path), shared_variables(NAME))
    return sd


def raws(det, x):
    if isinstance(det, TFaceDetector):
        with torch.no_grad():
            return [r.numpy() for r in det.model(torch.from_numpy(x))]
    return [np.asarray(r) for r in det._forward(det._serving_variables(), x)]


@pytest.mark.parametrize("kind", ["ema_half", "model_no_ema",
                                  "raw_with_anchors", "npz"])
def test_torch_weights_matches_jax(tmp_path, kind):
    spec_t, spec_j = narrowed(TZ, NAME), narrowed(JZ, NAME)
    path = tmp_path / ("w.npz" if kind == "npz" else "w.pt")
    expected = write_checkpoint(kind, spec_t, path)
    tdet = TFaceDetector(spec_t, torch_weights=path, img_sizes=(96,),
                         device="cpu")
    jdet = JFaceDetector(spec_j, torch_weights=str(path), img_sizes=(96,))
    x = np.random.default_rng(6).random((2, 96, 96, 3), np.float32)
    got = raws(tdet, x)
    assert len(got) == spec_t.nl
    for rt, rj in zip(got, raws(jdet, x)):
        np.testing.assert_allclose(rt, rj, **RAW_TOL)
    # the very weights of the file: EMA over "model", the half rounding
    same = TFaceDetector(spec_t, variables=copy.deepcopy(expected),
                         img_sizes=(96,), device="cpu")
    for rt, rs in zip(got, raws(same, x)):
        np.testing.assert_array_equal(rt, rs)


@pytest.mark.parametrize("name", ["nope.pt", "nope.npz"])
def test_torch_weights_missing_path_raises(tmp_path, monkeypatch, name):
    """A missing weights file is fetched from the release first, as in
    JAX; the release here is an empty local directory, so the fetch fails
    and the detector raises FileNotFoundError naming the file."""
    path = tmp_path / name
    calls = []
    monkeypatch.setattr(TD, "download_url", release_redirect(
        TD, (tmp_path / "release").as_uri(), calls))
    with pytest.raises(FileNotFoundError, match=name):
        TFaceDetector(narrowed(TZ, NAME), torch_weights=path, device="cpu")
    assert calls == [f"{TD.DEFAULT_RELEASE}/{name}"]
    assert not path.exists() and not (tmp_path / (name + ".part")).exists()
