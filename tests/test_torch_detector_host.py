"""The port's FaceDetector host-preprocess entry points (`detect_batch`,
`detect_single_scale`) and its `variables=` forms, against the JAX
FaceDetector with the same variables; settings and tolerances as in
tests/test_torch_detector.py, whose helpers this file shares."""

import numpy as np
import pytest

from face_detection_multi_scale_tpu.data import letterbox as JLB
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu_torch.infer.detector import (
    FaceDetector as TFaceDetector)
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.models.convert import (
    jax_to_state_dict)

from test_torch_detector import assert_rows_match, detectors
from test_torch_model import narrowed, random_variables


def test_detect_batch_matches_jax():
    rng = np.random.default_rng(6)
    imgs = [rng.integers(0, 256, shape, dtype=np.uint8)
            for shape in ((100, 150, 3), (128, 90, 3), (128, 128, 3))]
    frames = np.stack([JLB.preprocess_standard(im, 128, 32, auto=False)
                       for im in imgs])
    jdet, tdet = detectors("yolov7-tiny-face", frames)
    want = jdet.detect_batch(imgs, 128)
    got = tdet.detect_batch(imgs, 128)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape[1] == 6 + 15 and len(g) > 0
        assert_rows_match(g, w)
    assert tdet.truncation_report() == jdet.truncation_report()


def test_variables_as_jax_tree_or_state_dict():
    """`variables=` takes the JAX tree (through the bridge) or the torch
    state dict it maps to; both serve the same network."""
    spec = narrowed(TZ, "yolov7-tiny-face")
    variables = random_variables(narrowed(JZ, "yolov7-tiny-face"), seed=7)
    frames = np.random.default_rng(8).integers(0, 256, (1, 64, 64, 3),
                                               dtype=np.uint8)
    a = TFaceDetector(spec, variables=variables, device="cpu")
    b = TFaceDetector(spec, variables=jax_to_state_dict(variables),
                      device="cpu")
    assert (a.forward_rows(frames) == b.forward_rows(frames)).all()


@pytest.mark.parametrize("api", [False, True])
def test_detect_single_scale_matches_jax(api):
    """One image through the host preprocess (standard auto=True
    letterbox, or the API pad-to-square chain), the engine, and the
    inverse: (n, 7) rows in original pixels, rounded as the reference."""
    img = np.random.default_rng(9).integers(0, 256, (90, 120, 3),
                                            dtype=np.uint8)
    inp = (JLB.preprocess_api(img[:, :, ::-1], 128, 32) if api
           else JLB.preprocess_standard(img, 128, 32, auto=True))
    jdet, tdet = detectors("yolov7-tiny-face", inp[None],
                           use_api_preprocess=api)
    want, want_shape, _ = jdet.detect_single_scale(img, 128)
    got, got_shape, _ = tdet.detect_single_scale(img, 128)
    assert got_shape == want_shape
    assert got.shape[1] == 7 and len(got) > 0
    assert_rows_match(got, want)
