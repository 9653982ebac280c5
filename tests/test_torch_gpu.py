"""Tests of the port that need the card (marker `gpu`). They skip without
one; on a machine with a card and without JAX run them with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

This file imports neither JAX nor the JAX package."""

import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu_torch.infer.detector import FaceDetector
from face_detection_multi_scale_tpu_torch.models import zoo
from face_detection_multi_scale_tpu_torch.ops import nms_kernel as K

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import or
    collection, so every xdist worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def candidates(b, k, seed, frac_valid, device):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 600, (b, k, 2)).astype(np.float32)
    wh = rng.uniform(5, 150, (b, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    if k >= 8:  # duplicates and zero-area boxes
        boxes[:, k // 2:k // 2 + k // 8] = boxes[:, :k // 8]
        boxes[:, -k // 8:, 2] = boxes[:, -k // 8:, 0]
    valid = np.zeros((b, k), bool)
    valid[:, :int(k * frac_valid)] = True
    return (torch.from_numpy(boxes).to(device),
            torch.from_numpy(valid).to(device))


@pytest.mark.parametrize("b,k,thr,frac", [
    (2, 1024, 0.5, 1.0), (1, 2048, 0.3, 1.0), (1, 1024, 0.5, 0.4),
    (1, 1024, 0.9, 1.0), (2, 1, 0.5, 1.0), (3, 300, 0.5, 0.7),
    (2, 4095, 0.5, 0.9), (16, 4096, 0.5, 1.0), (2, 16384, 0.5, 0.8)])
def test_kernel_matches_plain(cuda_device, b, k, thr, frac):
    boxes, valid = candidates(b, k, seed=k + b, frac_valid=frac,
                              device=cuda_device)
    launches = K.nms_keep.launches
    got = K.nms_keep(boxes, valid, thr)
    torch.cuda.synchronize()
    assert K.nms_keep.launches == launches + 1
    assert torch.equal(got, K.nms_keep_plain(boxes, valid, thr))
    assert not got[~valid].any()


def test_kernel_rejects_non_contiguous(cuda_device):
    boxes, valid = candidates(2, 64, seed=0, frac_valid=1.0,
                              device=cuda_device)
    with pytest.raises(ValueError):
        K.nms_keep(boxes.transpose(0, 1).contiguous().transpose(0, 1),
                   valid, 0.5)


def test_engine_on_card_matches_cpu_postprocess(cuda_device):
    """A narrowed tiny model on the card: one kernel launch per engine
    call, and Detections equal to the CPU postprocess of the same rows."""
    spec = zoo.get_spec("yolov7-tiny-face")
    spec.width_multiple = 0.25
    spec._resolved = False
    det = FaceDetector(spec, img_sizes=(128,), conf_thres=0.01,
                       max_candidates=512, device=cuda_device)
    frames = np.random.default_rng(0).integers(0, 256, (4, 128, 128, 3),
                                               dtype=np.uint8)
    launches = K.nms_keep.launches
    dets = det.run_network(frames)
    assert K.nms_keep.launches == launches + 1
    rows = det.forward_rows(frames)
    for got, want in zip(det.postprocess(rows), det.postprocess(rows.cpu())):
        assert torch.equal(got.cpu(), want)
    assert dets.valid.any()
