"""Tests of the port that need the card (marker `gpu`). They skip without
one; on a machine with a card and without JAX run them with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

This file imports neither JAX nor the JAX package."""

import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu_torch.infer import device_preprocess as DP
from face_detection_multi_scale_tpu_torch.infer.detector import (
    FaceDetector, full_fp32)
from face_detection_multi_scale_tpu_torch.models import zoo
from face_detection_multi_scale_tpu_torch.models.fused import find_elan_blocks
from face_detection_multi_scale_tpu_torch.ops import elan_kernel as E
from face_detection_multi_scale_tpu_torch.ops import nms as NMS
from face_detection_multi_scale_tpu_torch.ops import nms_kernel as K
from face_detection_multi_scale_tpu_torch.tools import probe_mm as PM

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


@pytest.mark.parametrize("b,k,thr,frac", [
    (2, 1024, 0.5, 1.0), (1, 2048, 0.3, 1.0), (1, 1024, 0.5, 0.4),
    (1, 1024, 0.9, 1.0), (2, 1, 0.5, 1.0), (3, 300, 0.5, 0.7),
    (2, 4095, 0.5, 0.9), (16, 4096, 0.5, 1.0)])
def test_fixpoint_kernel_matches_plain(cuda_device, b, k, thr, frac):
    boxes, valid = candidates(b, k, seed=k + b, frac_valid=frac,
                              device=cuda_device)
    seq, fix = K.nms_keep.launches, K.nms_keep.fixpoint_launches
    got = K.nms_keep(boxes, valid, thr, kernel_version="fixpoint")
    torch.cuda.synchronize()
    assert K.nms_keep.fixpoint_launches == fix + 1
    assert K.nms_keep.launches == seq
    assert torch.equal(got, K.nms_keep_plain(boxes, valid, thr))


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


def elan_shapes():
    """Every distinct group shape of w6 and tiny, bare and with the
    absorbed pre conv."""
    out = []
    for name in ("yolov7-w6-face", "yolov7-tiny-face"):
        for pre in (False, True):
            for blk in find_elan_blocks(zoo.get_spec(name), absorb_pre=pre):
                if blk.shape not in out:
                    out.append(blk.shape)
    return out


def elan_inputs(shape, h, w, seed, device):
    """x and lecun-scaled weights for `shape` at group size h x w."""
    rng = np.random.default_rng(seed)
    s = shape.pre_stride if shape.has_pre else 1
    c = shape.pre_cin if shape.has_pre else shape.cin
    x = rng.standard_normal((2, c, h * s, w * s)).astype(np.float32)
    ws = []
    for shp in E.weight_shapes(shape):
        fan_in = int(np.prod(shp[1:])) if len(shp) == 4 else 10
        ws.append(rng.normal(0, 1 / np.sqrt(fan_in), shp).astype(np.float32))
    return (torch.from_numpy(x).to(device),
            [torch.from_numpy(v).to(device) for v in ws])


@pytest.mark.parametrize("hw", [(12, 20), (30, 37)])
@pytest.mark.parametrize("idx", range(22))
def test_fused_elan_matches_reference(cuda_device, idx, hw):
    """The kernel vs reference_elan through cuDNN with TF32 off, at full
    width, on 2 images of 12 x 20 (one tile each) and of 30 x 37 (2 x 2
    tiles of 15 x 19, every tile touching two borders), in the workspace
    route with clusters of 8; scale-relative error below 1e-5."""
    shapes = elan_shapes()
    assert len(shapes) == 22
    shape = shapes[idx]
    h, w = hw
    x, ws = elan_inputs(shape, h, w, seed=idx, device=cuda_device)
    launches = E.fused_elan.launches
    got = E.fused_elan(x, ws, shape)
    torch.cuda.synchronize()
    assert E.fused_elan.launches == launches + 1
    with full_fp32():
        want = E.reference_elan(x, ws, shape)
    assert got.shape == want.shape == (2, shape.cout, h, w)
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-5, err


@pytest.mark.parametrize("idx", range(22))
def test_fused_elan_tiled(cuda_device, idx):
    """Every group shape at 2 x 72 x 76 (W no multiple of the tile): 180
    tiles of 8 x 8 in shared memory where the tile's working set fits,
    else 16 x 16 tiles in the device-memory workspace, with interior
    tiles, border tiles and ragged last tiles."""
    shape = elan_shapes()[idx]
    x, ws = elan_inputs(shape, 72, 76, seed=idx, device=cuda_device)
    got = E.fused_elan(x, ws, shape)
    with full_fp32():
        want = E.reference_elan(x, ws, shape)
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-5, err


def test_fused_elan_single_tile_and_uneven_members(cuda_device):
    shape = E.ElanShape(cin=8, ccv=8, cch=8, cout=8, n_chain=4,
                        members=("y3", "b"), act="relu")
    x, ws = elan_inputs(shape, 5, 7, seed=1, device=cuda_device)
    got = E.fused_elan(x, ws, shape)
    with full_fp32():
        want = E.reference_elan(x, ws, shape)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


def test_fused_elan_rejects_bad_inputs(cuda_device):
    shape = elan_shapes()[0]
    x, ws = elan_inputs(shape, 8, 8, seed=0, device=cuda_device)
    with pytest.raises(ValueError):   # non-contiguous
        E.fused_elan(x.transpose(2, 3).contiguous().transpose(2, 3), ws,
                     shape)
    with pytest.raises(TypeError):    # not float32
        E.fused_elan(x.double(), ws, shape)
    with pytest.raises(ValueError):   # channels that do not fit
        E.fused_elan(x[:, :-1].contiguous(), ws, shape)
    with pytest.raises(ValueError):   # a weight on the CPU
        E.fused_elan(x, [ws[0].cpu()] + ws[1:], shape)


def test_fused_engine_on_card_matches_cpu_postprocess(cuda_device):
    """A narrowed tiny model with fuse_elan on the card: one fused launch
    per group and engine call, and Detections equal to the CPU
    postprocess of the same rows."""
    spec = zoo.get_spec("yolov7-tiny-face")
    spec.width_multiple = 0.25
    spec._resolved = False
    det = FaceDetector(spec, img_sizes=(128,), conf_thres=0.01,
                       max_candidates=512, fuse_elan=True,
                       device=cuda_device)
    frames = np.random.default_rng(0).integers(0, 256, (4, 128, 128, 3),
                                               dtype=np.uint8)
    launches = E.fused_elan.launches
    dets = det.run_network(frames)
    assert E.fused_elan.launches == launches + 8
    rows = det.forward_rows(frames)
    for got, want in zip(det.postprocess(rows), det.postprocess(rows.cpu())):
        assert torch.equal(got.cpu(), want)
    assert dets.valid.any()


@pytest.mark.parametrize("cells", [1, 133, 512])
@pytest.mark.parametrize("variant", PM.VARIANTS)
def test_probe_mm_matches_plain(cuda_device, variant, cells):
    """The probe kernel vs its plain version within REL_TOL of max |plain|,
    at the tool's 512 cells and at ragged grids; every row the same."""
    inputs = PM.make_inputs(cuda_device)
    launches = PM.probe_mm.launches
    got = PM.probe_mm(variant, *inputs, cells)
    torch.cuda.synchronize()
    assert PM.probe_mm.launches == launches + 1
    want = PM.probe_mm_plain(variant, *inputs, cells)
    assert got.shape == want.shape == (cells, PM.N)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= PM.REL_TOL, rel
    assert bool((got == got[0]).all())


def test_probe_mm_rejects_misaligned_inputs(cuda_device):
    x, x2, w, w9 = PM.make_inputs(cuda_device)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)
    with pytest.raises(ValueError):  # 2 bytes off a 16-byte boundary
        PM.probe_mm("flat", flat[1:].view(x.shape), x2, w, w9, 4)


def merge_rows(n, seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 300, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 200, (n, 2))], 1).round()
    boxes[5::5] = boxes[:len(boxes[5::5])]
    conf = rng.choice(np.linspace(0.55, 0.9, 8), n)
    return np.concatenate([boxes, conf[:, None], np.zeros((n, 1)),
                           rng.integers(0, 2, (n, 1))], 1)


@pytest.mark.parametrize("n", [1, 600])
def test_merge_through_the_kernel_matches_plain(cuda_device, n):
    """weighted_nms_merge on the card: one seq keep-mask launch, and the
    keep indices of the CPU merge (the plain keep mask)."""
    rows = merge_rows(n, seed=n)
    launches = K.nms_keep.launches
    got = NMS.weighted_nms_merge(rows, 2, 0.5, device=cuda_device)
    assert K.nms_keep.launches == launches + 1
    np.testing.assert_array_equal(
        got, NMS.weighted_nms_merge(rows, 2, 0.5, device="cpu"))


def test_nms_keep_matrix_launches_the_kernel(cuda_device):
    rows = torch.from_numpy(merge_rows(300, seed=3)).float()
    launches = K.nms_keep.launches
    idx, ok = NMS.nms_keep_matrix(rows[:, :4].to(cuda_device),
                                  rows[:, 4].to(cuda_device), 0.5, 100)
    assert K.nms_keep.launches == launches + 1
    want_idx, want_ok = NMS.nms_keep_matrix(rows[:, :4], rows[:, 4], 0.5, 100)
    assert torch.equal(ok.cpu(), want_ok) and torch.equal(idx.cpu(), want_idx)


@pytest.mark.parametrize("hw", [(1080, 1920), (500, 375), (123, 457)])
def test_device_preprocess_matches_cpu(cuda_device, hw):
    """Letterbox (auto and square) and the API chain on the card within
    1e-5 of the same functions on the CPU."""
    img = torch.from_numpy(np.random.default_rng(hw[0]).integers(
        0, 256, (1, *hw, 3), dtype=np.uint8))
    for size in (640, 3840):
        for auto in (True, False):
            geom = DP.letterbox_geometry(hw, size, auto=auto, stride=64)
            got = DP.device_letterbox(img.to(cuda_device), geom).cpu()
            want = DP.device_letterbox(img, geom)
            assert got.shape == want.shape == (1, *geom.out_hw, 3)
            assert float((got - want).abs().max()) <= 1e-5
        got = DP.device_preprocess_api(img.to(cuda_device), size).cpu()
        assert float((got - DP.device_preprocess_api(img, size))
                     .abs().max()) <= 1e-5


def test_detect_multi_scale_on_card(cuda_device):
    """A narrowed tiny pyramid with device preprocessing on the card: one
    keep-mask launch per scale and one for the merge, and rows of the
    (n, 7) contract inside the image."""
    spec = zoo.get_spec("yolov7-tiny-face")
    spec.width_multiple = 0.25
    spec._resolved = False
    det = FaceDetector(spec, img_sizes=(64, 128),
                       use_device_preprocess=True, device=cuda_device)
    img = np.random.default_rng(0).integers(0, 256, (90, 120, 3),
                                            dtype=np.uint8)
    # a gate that a quarter of the small scale's rows clear
    x, _ = det.device_input(det.upload(img[None]), 64, auto=True)
    rows = det.forward_input(x)
    conf = (rows[..., 4] * rows[..., 5]).flatten().sort(descending=True)[0]
    det.conf_thres = float(conf[len(conf) // 4])
    launches = K.nms_keep.launches
    out, shape = det.detect_multi_scale(img)
    assert shape == img.shape and out.shape[1] == 7 and len(out) > 0
    assert K.nms_keep.launches == launches + 3
    assert (out[:, [0, 2]] <= 120).all() and (out[:, [1, 3]] <= 90).all()
    assert set(out[:, 6].tolist()) <= {0, 1}
