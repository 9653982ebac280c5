"""Tests of the port that need the card (marker `gpu`). They skip without
one; on a machine with a card and without JAX run them with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

This file imports neither JAX nor the JAX package."""

import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu_torch.infer import device_preprocess as DP
from face_detection_multi_scale_tpu_torch.infer import tiling
from face_detection_multi_scale_tpu_torch.infer.detector import (
    FaceDetector, full_fp32)
from face_detection_multi_scale_tpu_torch.models import zoo
from face_detection_multi_scale_tpu_torch.models import quant as TQ
from face_detection_multi_scale_tpu_torch.models.fused import find_elan_blocks
from face_detection_multi_scale_tpu_torch.ops import elan_kernel as E
from face_detection_multi_scale_tpu_torch.ops import nms as NMS
from face_detection_multi_scale_tpu_torch.ops import nms_kernel as K
from face_detection_multi_scale_tpu_torch.ops import qconv_kernel as QK
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


def check_fixpoint(boxes, valid, thr):
    """The fixpoint kernel twice: one count a launch and none on the seq
    counter, both results equal, and equal to the plain keep mask and
    sweep counts. Returns the keep mask."""
    seq, fix = K.nms_keep.launches, K.nms_keep.fixpoint_launches
    got = K.nms_keep(boxes, valid, thr, kernel_version="fixpoint")
    sweeps = K.nms_keep.last_fixpoint_sweeps
    again = K.nms_keep(boxes, valid, thr, kernel_version="fixpoint")
    torch.cuda.synchronize()
    assert K.nms_keep.fixpoint_launches == fix + 2
    assert K.nms_keep.launches == seq
    assert torch.equal(got, again)
    assert torch.equal(sweeps, K.nms_keep.last_fixpoint_sweeps)
    assert torch.equal(got, K.nms_keep_plain(boxes, valid, thr))
    assert torch.equal(sweeps, K.fixpoint_sweeps_plain(boxes, valid, thr))
    return got


@pytest.mark.parametrize("b,k,thr,frac", [
    (2, 1024, 0.5, 1.0), (1, 2048, 0.3, 1.0), (1, 1024, 0.5, 0.4),
    (1, 1024, 0.9, 1.0), (2, 1, 0.5, 1.0), (3, 300, 0.5, 0.7),
    (2, 4095, 0.5, 0.9), (16, 4096, 0.5, 1.0), (2, 16384, 0.5, 0.8)])
def test_fixpoint_kernel_matches_plain(cuda_device, b, k, thr, frac):
    boxes, valid = candidates(b, k, seed=k + b, frac_valid=frac,
                              device=cuda_device)
    check_fixpoint(boxes, valid, thr)


def chain_boxes(b, k, device):
    """Boxes 10 wide, 3 apart, in score order: each overlaps the next by
    IoU 7/13 > 0.5 and the one after by 4/16, so the keep mask alternates
    and every decision depends on the one before, across tile edges."""
    x = torch.arange(k, dtype=torch.float32) * 3
    one = torch.stack([x, torch.zeros(k), x + 10, torch.full((k,), 10.)], 1)
    return (one.expand(b, k, 4).contiguous().to(device),
            torch.ones(b, k, dtype=torch.bool, device=device))


@pytest.mark.parametrize("b,k,case", [
    (64, 1024, "random"), (3, 63, "random"), (3, 64, "random"),
    (3, 65, "random"), (2, 4097, "random"), (2, 1024, "invalid"),
    (1, 4097, "chain"), (2, 200, "chain")])
def test_two_pass_kernel_cases(cuda_device, b, k, case):
    """Many blocks per pass (B = 64), K around a 64-row word and one past
    4096, rows all invalid, and long suppression chains."""
    if case == "chain":
        boxes, valid = chain_boxes(b, k, cuda_device)
    else:
        boxes, valid = candidates(b, k, seed=k + 7, frac_valid=0.9,
                                  device=cuda_device)
    if case == "invalid":
        valid[0] = False
    launches = K.nms_keep.launches
    got = K.nms_keep(boxes, valid, 0.5)
    torch.cuda.synchronize()
    assert K.nms_keep.launches == launches + 1
    assert torch.equal(got, K.nms_keep_plain(boxes, valid, 0.5))
    if case == "chain":
        assert torch.equal(got[0], torch.arange(k, device=cuda_device) % 2
                           == 0)
    if case == "invalid":
        assert not got[0].any()


@pytest.mark.parametrize("b,k,case", [
    (64, 1024, "random"), (3, 63, "random"), (3, 64, "random"),
    (3, 65, "random"), (2, 1024, "invalid"), (1, 4097, "chain"),
    (2, 200, "chain")])
def test_fixpoint_kernel_cases(cuda_device, b, k, case):
    """Clusters in waves (B = 64), K around a 64-row word (K = 65 leaves
    most of a 16-block cluster without a word), an image with no valid
    row, and chains that take K sweeps."""
    if case == "chain":
        boxes, valid = chain_boxes(b, k, cuda_device)
    else:
        boxes, valid = candidates(b, k, seed=k + 11, frac_valid=0.9,
                                  device=cuda_device)
    if case == "invalid":
        valid[0] = False
    got = check_fixpoint(boxes, valid, 0.5)
    if case == "chain":
        assert torch.equal(got, (torch.arange(k, device=cuda_device) % 2
                                 == 0).expand(b, k))
        assert K.nms_keep.last_fixpoint_sweeps.tolist() == [k] * b
    if case == "invalid":
        assert not got[0].any()
        assert K.nms_keep.last_fixpoint_sweeps[0] == 1


@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
def test_fixpoint_sweeps_any_cluster(cuda_device, cluster):
    """The sweep kernel gives the same mask and counts at any cluster
    size, through the launch helper (which counts nothing)."""
    boxes, valid = candidates(5, 3000, seed=3, frac_valid=0.8,
                              device=cuda_device)
    mask = torch.empty(K.mask_words(5, 3000), dtype=torch.int64,
                       device=cuda_device)
    keep = torch.empty(5, 3000, dtype=torch.bool, device=cuda_device)
    sweeps = torch.empty(5, dtype=torch.int32, device=cuda_device)
    fix = K.nms_keep.fixpoint_launches
    K.launch_mask(boxes, valid, 0.5, mask)
    K.launch_sweeps(mask, valid, keep, sweeps, cluster)
    torch.cuda.synchronize()
    assert K.nms_keep.fixpoint_launches == fix
    assert torch.equal(keep, K.nms_keep_plain(boxes, valid, 0.5))
    assert torch.equal(sweeps, K.fixpoint_sweeps_plain(boxes, valid, 0.5))
    assert K.fixpoint_max_active_clusters(3000, cluster, 0) >= 1


def test_fixpoint_refused_cluster_raises(cuda_device, monkeypatch):
    """A cluster size the card cannot schedule raises; nothing falls back
    to another kernel or the plain version, and the next launch works."""
    boxes, valid = candidates(2, 1024, seed=5, frac_valid=1.0,
                              device=cuda_device)
    assert K.fixpoint_max_active_clusters(1024, 32, 0) == 0
    monkeypatch.setattr(K, "FIXPOINT_CLUSTER", 32)
    seq, fix = K.nms_keep.launches, K.nms_keep.fixpoint_launches
    with pytest.raises(RuntimeError):
        K.nms_keep(boxes, valid, 0.5, kernel_version="fixpoint")
    assert (K.nms_keep.launches, K.nms_keep.fixpoint_launches) == (seq, fix)
    monkeypatch.undo()
    check_fixpoint(boxes, valid, 0.5)


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
    tiles of 15 x 19, every tile touching two borders), with clusters of
    8; scale-relative error below 1e-5."""
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
    """Every group shape at 2 x 72 x 76 (neither side a multiple of the
    tile): WS_TILE_H x WS_TILE_W tiles in the device-memory workspace, with
    interior tiles, border tiles and ragged last tiles."""
    shape = elan_shapes()[idx]
    x, ws = elan_inputs(shape, 72, 76, seed=idx, device=cuda_device)
    got = E.fused_elan(x, ws, shape)
    with full_fp32():
        want = E.reference_elan(x, ws, shape)
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-5, err


@pytest.mark.parametrize("tile", [(32, 16), (24, 40), (96, 104)])
def test_fused_elan_large_ragged_tiles(cuda_device, monkeypatch, tile):
    """Tiles larger than 16 px, not square, with ragged last tiles on both
    sides (2 x 70 x 75), on the w6 head shape and the pre stride-2 shape;
    at 96 x 104 the image is one tile whose window rows outgrow a halo
    stage, so its 3x3 convs stage A chunk by chunk."""
    monkeypatch.setattr(E, "WS_TILE_H", tile[0])
    monkeypatch.setattr(E, "WS_TILE_W", tile[1])
    shapes = elan_shapes()
    for shape in (shapes[5], next(s for s in shapes if s.pre_stride == 2)):
        x, ws = elan_inputs(shape, 70, 75, seed=3, device=cuda_device)
        plan = E.elan_plan(shape, 2, 70, 75, 132)
        assert (plan["tile_h"], plan["tile_w"]) == tile
        got = E.fused_elan(x, ws, shape)
        with full_fp32():
            want = E.reference_elan(x, ws, shape)
        err = float((got - want).abs().max() / want.abs().max())
        assert err < 1e-5, err


def test_fused_elan_profile_build(cuda_device, monkeypatch):
    """The profiling build of the kernel (tools/elan_profile.py) computes
    the same group and counts clocks in the phases that run."""
    from face_detection_multi_scale_tpu_torch.tools import elan_profile as EP
    shape = elan_shapes()[5]
    x, ws = elan_inputs(shape, 40, 44, seed=4, device=cuda_device)
    monkeypatch.setattr(E, "NVCC_FLAGS",
                        E.NVCC_FLAGS + ("-DFDMS_ELAN_PROFILE",))
    E._library.cache_clear()
    try:
        n_sm = torch.cuda.get_device_properties(
            cuda_device).multi_processor_count
        blocks = E.elan_plan(shape, 2, 40, 44, n_sm)["grid"]
        got = E.fused_elan(x, ws, shape)
        torch.cuda.synchronize()
        EP.read_counters(E._library(), blocks)
        got = E.fused_elan(x, ws, shape)
        torch.cuda.synchronize()
        c = dict(zip(EP.PHASES, EP.read_counters(E._library(), blocks)))
    finally:
        E._library.cache_clear()
    with full_fp32():
        want = E.reference_elan(x, ws, shape)
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-5, err
    assert c["chunks"] > 0 and c["math"] > 0 and c["issue"] > 0
    assert sum(c[n] for n in EP.SHOWN) <= c["total"]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,groups", [
    ("yolov7-face", 8), ("yolov7s-face", 8), ("yolov7-lite-t", 0),
    ("yolov7-lite-s", 0)])
def test_new_models_on_card_match_cpu_postprocess(cuda_device, name, groups,
                                                  dtype):
    """The other four zoo models narrowed (width 0.25) on the card with
    fuse_elan="pre:": one launch of the dtype's fused kernel per group and
    engine call (none for the lite models, which serve unfused), one
    nms_keep launch, and Detections equal to the CPU postprocess of the
    same rows."""
    spec = zoo.get_spec(name)
    spec.width_multiple = 0.25
    spec._resolved = False
    det = FaceDetector(spec, img_sizes=(128,), conf_thres=0.01,
                       max_candidates=512, fuse_elan="pre:", dtype=dtype,
                       device=cuda_device)
    assert len(det._elan_blocks) == groups
    frames = np.random.default_rng(1).integers(0, 256, (4, 128, 128, 3),
                                               dtype=np.uint8)
    counts = (E.fused_elan.launches, E.fused_elan.bf16_launches,
              K.nms_keep.launches)
    dets = det.run_network(frames)
    bf16 = dtype == torch.bfloat16
    assert (E.fused_elan.launches, E.fused_elan.bf16_launches,
            K.nms_keep.launches) == (counts[0] + groups * (not bf16),
                                       counts[1] + groups * bf16,
                                       counts[2] + 1)
    rows = det.forward_rows(frames)
    for got, want in zip(det.postprocess(rows), det.postprocess(rows.cpu())):
        assert torch.equal(got.cpu(), want)
    assert dets.valid.any()


BF16_REL_TOL = 1e-2  # a few bf16 roundings apart (2^-8 each)
# the cases of tests/test_fused_elan.py (GROUP_CASES of
# tests/test_torch_fused_elan.py), then the groups of the other zoo
# models: ElanShape fields and the input's (h, w)
GROUP_CASES = [
    dict(cin=12, ccv=8, cch=8, cout=16, n_chain=4,
         members=("y4", "y2", "b", "a")),
    dict(cin=12, ccv=16, cch=8, cout=16, n_chain=4,
         members=("y4", "y3", "y2", "y1", "b", "a")),
    dict(cin=12, ccv=8, cch=8, cout=16, n_chain=2,
         members=("y2", "y1", "b", "a"), act="leaky"),
    dict(cin=12, ccv=8, cch=8, cout=16, n_chain=4,
         members=("y4", "y2", "b", "a"), pre_cin=6, pre_stride=1),
    dict(cin=12, ccv=8, cch=8, cout=16, n_chain=4,
         members=("y4", "y2", "b", "a"), pre_cin=6, pre_stride=2),
    dict(cin=8, ccv=8, cch=8, cout=8, n_chain=4, members=("y3", "b"),
         act="relu"),
    # the groups of yolov7s-face and yolov7-face: channel counts that are
    # no multiple of the kernel's 32-channel K chunk or 64-channel N tile,
    # the absorbed stride-2 conv, and yolov7-face's widest group
    dict(cin=56, ccv=32, cch=32, cout=104, n_chain=4,
         members=("y4", "y2", "b", "a")),
    dict(cin=216, ccv=104, cch=56, cout=104, n_chain=4,
         members=("y4", "y3", "y2", "y1", "b", "a")),
    dict(cin=416, ccv=208, cch=104, cout=208, n_chain=4,
         members=("y4", "y3", "y2", "y1", "b", "a")),
    dict(cin=56, ccv=32, cch=32, cout=104, n_chain=4,
         members=("y4", "y2", "b", "a"), pre_cin=32, pre_stride=2),
    dict(cin=1024, ccv=512, cch=256, cout=512, n_chain=4,
         members=("y4", "y3", "y2", "y1", "b", "a")),
]
GROUP_HW = [(16, 16), (16, 16), (16, 16), (16, 20), (32, 40), (12, 20),
            (20, 24), (16, 16), (12, 20), (40, 48), (10, 10)]


def bf16_inputs(shape, h, w, seed, device):
    """elan_inputs in the bf16 form: x and the conv kernels bf16, the
    biases float32 (models/fused.pack_elan_weights with dtype bf16)."""
    x, ws = elan_inputs(shape, h, w, seed, device)
    return x.bfloat16(), [t.bfloat16() if t.dim() == 4 else t for t in ws]


def check_bf16_group(x, ws, shape):
    """One bf16 launch (counted apart from the float32 ones), a bf16
    output within BF16_REL_TOL of max |plain| of reference_elan (float32
    convs of the bf16 values through cuDNN with TF32 off, each
    intermediate rounded to bf16)."""
    f32, bf16 = E.fused_elan.launches, E.fused_elan.bf16_launches
    got = E.fused_elan(x, ws, shape)
    torch.cuda.synchronize()
    assert (E.fused_elan.launches, E.fused_elan.bf16_launches) == (f32,
                                                                   bf16 + 1)
    with full_fp32():
        want = E.reference_elan(x, ws, shape)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    err = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    assert err < BF16_REL_TOL, err


@pytest.mark.parametrize("idx", range(len(GROUP_CASES)))
def test_fused_elan_group_cases(cuda_device, idx):
    """The float32 kernel on GROUP_CASES, within 1e-5 of max |plain| of
    reference_elan through cuDNN with TF32 off, one launch each."""
    shape = E.ElanShape(**GROUP_CASES[idx])
    h, w = GROUP_HW[idx]
    s = shape.pre_stride if shape.has_pre else 1
    x, ws = elan_inputs(shape, h // s, w // s, seed=idx, device=cuda_device)
    launches = E.fused_elan.launches
    got = E.fused_elan(x, ws, shape)
    torch.cuda.synchronize()
    assert E.fused_elan.launches == launches + 1
    with full_fp32():
        want = E.reference_elan(x, ws, shape)
    assert got.shape == want.shape
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-5, err


@pytest.mark.parametrize("idx", range(len(GROUP_CASES)))
def test_fused_elan_bf16_group_cases(cuda_device, idx):
    """The bf16 kernel on GROUP_CASES (ragged channel counts: 12 and 6
    channels are no whole 16-byte run of bf16; 56, 104 and 216 no whole
    K chunk or N tile)."""
    shape = E.ElanShape(**GROUP_CASES[idx])
    h, w = GROUP_HW[idx]
    s = shape.pre_stride if shape.has_pre else 1
    x, ws = bf16_inputs(shape, h // s, w // s, seed=idx, device=cuda_device)
    check_bf16_group(x, ws, shape)


@pytest.mark.parametrize("hw", [(12, 20), (30, 37), (72, 76)])
@pytest.mark.parametrize("idx", range(22))
def test_fused_elan_bf16_matches_reference(cuda_device, idx, hw):
    """The bf16 kernel on every full-width w6 and tiny group shape, bare
    and with the absorbed pre conv: one tile an image, 2 x 2 tiles, and
    the workspace tiles with ragged last tiles."""
    shape = elan_shapes()[idx]
    x, ws = bf16_inputs(shape, *hw, seed=idx, device=cuda_device)
    check_bf16_group(x, ws, shape)


def test_fused_elan_dtype_routes(cuda_device):
    """float32 inputs still launch the float32 kernel (its counter only,
    a float32 result within 1e-5 of plain); bf16 the bf16 kernel; any
    other mix raises TypeError."""
    shape = elan_shapes()[5]
    x, ws = elan_inputs(shape, 20, 24, seed=9, device=cuda_device)
    f32, bf16 = E.fused_elan.launches, E.fused_elan.bf16_launches
    got = E.fused_elan(x, ws, shape)
    torch.cuda.synchronize()
    assert (E.fused_elan.launches, E.fused_elan.bf16_launches) == (f32 + 1,
                                                                   bf16)
    with full_fp32():
        want = E.reference_elan(x, ws, shape)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
    xb, wb = bf16_inputs(shape, 20, 24, seed=9, device=cuda_device)
    check_bf16_group(xb, wb, shape)
    for bad in ([t.bfloat16() for t in ws],            # bf16 biases
                [t.float() for t in wb],               # f32 kernels
                [t.half() if t.dim() == 4 else t for t in ws]):
        with pytest.raises(TypeError):
            E.fused_elan(xb, bad, shape)
    with pytest.raises(TypeError):
        E.fused_elan(x.half(), [t.half() if t.dim() == 4 else t
                                for t in ws], shape)


@pytest.mark.parametrize("fuse_elan", [False, True])
def test_bf16_engine_on_card_matches_cpu_postprocess(cuda_device,
                                                     fuse_elan):
    """A narrowed tiny bf16 detector on the card, unfused and fused: bf16
    convs, one keep-mask launch a request, 8 bf16 fused launches a request
    (none of the float32 kernel), and Detections equal to the CPU
    postprocess of the same rows."""
    det = FaceDetector(narrow_tiny(), img_sizes=(128,), conf_thres=0.01,
                       max_candidates=512, fuse_elan=fuse_elan,
                       dtype=torch.bfloat16, device=cuda_device)
    frames = np.random.default_rng(0).integers(0, 256, (4, 128, 128, 3),
                                               dtype=np.uint8)
    seq = K.nms_keep.launches
    f32, bf16 = E.fused_elan.launches, E.fused_elan.bf16_launches
    dets = det.run_network(frames)
    torch.cuda.synchronize()
    assert K.nms_keep.launches == seq + 1
    assert E.fused_elan.launches == f32
    assert E.fused_elan.bf16_launches == bf16 + (8 if fuse_elan else 0)
    rows = det.forward_rows(frames)
    # float32: the head's implicit priors stay float32 and promote (JAX)
    assert rows.dtype == torch.float32
    for got, want in zip(det.postprocess(rows), det.postprocess(rows.cpu())):
        assert torch.equal(got.cpu(), want)
    assert dets.valid.any()
    assert all(r.dtype == np.float32 for r in NMS.detections_to_numpy(dets))


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


@pytest.mark.parametrize("variant", PM.VARIANTS)
def test_probe_mm_is_bit_identical_across_launches_and_cells(cuda_device,
                                                             variant):
    """Two launches, the second at 264 cells (two a streaming
    multiprocessor), give bit-identical rows: a block's order of sums is
    fixed."""
    inputs = PM.make_inputs(cuda_device)
    first = PM.probe_mm(variant, *inputs, 7)
    second = PM.probe_mm(variant, *inputs, 264)
    torch.cuda.synchronize()
    assert bool((second == first[0]).all()) and bool((first == first[0]).all())
    want = PM.probe_mm_plain(variant, *inputs, 1)
    rel = float((first[0] - want[0]).abs().max() / want.abs().max())
    assert rel <= PM.REL_TOL, rel


@pytest.mark.parametrize("variant", PM.VARIANTS)
def test_probe_mm_stages_the_planned_bytes(cuda_device, variant):
    """The counting instantiation's cp.asyncs read exactly the plan's
    bytes a cell, at one cell and at 133, and it computes what the probe
    computes, bit for bit, without adding to the launch counter."""
    inputs = PM.make_inputs(cuda_device)
    want = PM.probe_mm(variant, *inputs, 1)[0]
    launches = PM.probe_mm.launches
    for cells in (1, 133):
        out, staged = PM.count_staged(variant, *inputs, cells)
        assert staged == PM.staged_bytes(variant), (cells, staged)
        assert bool((out == want).all())
    assert PM.probe_mm.launches == launches


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


def narrow_tiny():
    spec = zoo.get_spec("yolov7-tiny-face")
    spec.width_multiple = 0.25
    spec._resolved = False
    return spec


def test_tiled_call_on_card_matches_cpu_assembly(cuda_device):
    """A narrowed tiny detector tiled at 256 (4 tiles of 192 a frame) on
    the card: one keep-mask launch for the tile batch of both frames and
    one per frame's seam dedup, each frame's rows equal to the CPU
    assemble_rows of the same tile rows, one truncation entry a frame."""
    det = FaceDetector(narrow_tiny(), img_sizes=(256,),
                       use_api_preprocess=True, tile_top_scale=2,
                       tile_halo=64, tile_min_size=256, max_candidates=512,
                       device=cuda_device)
    frames = np.random.default_rng(3).integers(0, 256, (2, 256, 256, 3),
                                               dtype=np.uint8)
    plan = det._tile_plan(256)
    assert (plan.tile, plan.origins) == (192, (0, 64))
    tiles = np.concatenate([tiling.extract_tiles(f, plan) for f in frames])
    rows = det.forward_rows(tiles)
    conf = (rows[..., 4] * rows[..., 5]).flatten().sort(descending=True)[0]
    det.conf_thres = float(conf[len(conf) // 8])
    posts, post = [], det.postprocess

    def record(r):
        posts.append(post(r))
        return posts[-1]

    det.postprocess = record
    launches = K.nms_keep.launches
    images = det.truncation_report()["images"]
    out = det._run_tiled_batch(list(frames), plan)
    torch.cuda.synchronize()
    assert len(posts) == 1 and posts[0].boxes.shape[0] == 8
    tile_rows = NMS.detections_to_numpy(posts[0])
    for i, got in enumerate(out):
        want = tiling.assemble_rows(tile_rows[4 * i:4 * i + 4], plan,
                                    det.iou_thres, device="cpu")
        assert len(want) > 0
        np.testing.assert_array_equal(got, want)
    assert K.nms_keep.launches == launches + 1 + len(frames)
    assert det.truncation_report()["images"] == images + len(frames)


def test_micro_batch_on_card_keeps_the_whole_batch(cuda_device):
    """micro_batch=4 over 8 frames: one keep-mask launch a chunk, the
    whole batch's keepers per image, rows within ROW_TOL."""
    kw = dict(img_sizes=(128,), conf_thres=0.01, max_candidates=512,
              device=cuda_device)
    whole = FaceDetector(narrow_tiny(), **kw)
    chunked = FaceDetector(narrow_tiny(), micro_batch=4, **kw)
    frames = np.random.default_rng(4).integers(0, 256, (8, 128, 128, 3),
                                               dtype=np.uint8)
    want = whole.run_network(frames)
    launches = K.nms_keep.launches
    got = chunked.run_network(frames)
    torch.cuda.synchronize()
    assert K.nms_keep.launches == launches + 2
    assert torch.equal(got.valid.sum(1), want.valid.sum(1))
    for g, w in zip(NMS.detections_to_numpy(got),
                    NMS.detections_to_numpy(want)):
        assert len(g) > 0
        pair = np.abs(g[:, None, :5] - w[None, :, :5]).max(-1).argmin(1)
        assert len(set(pair.tolist())) == len(pair)
        np.testing.assert_allclose(g, w[pair], atol=5e-3, rtol=1e-3)


def test_predict_on_card_matches_cpu_postprocess(cuda_device):
    """predict on arrays already at the common rectangle (no OpenCV on
    the card's machine): one keep-mask launch, and each image's rows those
    of the CPU postprocess of the card's rows, through the same inverse
    letterbox."""
    from face_detection_multi_scale_tpu_torch.data import letterbox as LB

    det = FaceDetector(narrow_tiny(), img_sizes=(128,), conf_thres=0.01,
                       max_candidates=512, device=cuda_device)
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
            for _ in range(3)]
    launches = K.nms_keep.launches
    res = det.predict(imgs, size=128)
    assert K.nms_keep.launches == launches + 1
    assert len(res) == 3 and res.s == (3, 96, 128, 3)
    rows = det.forward_rows(np.stack(imgs))
    want = NMS.detections_to_numpy(det.postprocess(rows.cpu()))
    for got, w in zip(res.pred, want):
        w = w[:, :6].astype(np.float64)
        LB.scale_coords((96, 128), w[:, :4], (96, 128))
        assert len(got) > 0
        np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_from_raws_on_card_matches_cpu(cuda_device, dtype):
    """non_max_suppression_from_raws on the card's conv-layout raws: one
    keep-mask launch, and the CPU version on the same raws gives the same
    n_gated and valid counts and the same kept rows within atol 5e-3 /
    rtol 1e-3. The sigmoids differ by an ulp between the devices on some
    rows, so the gate and IoU threshold are chip_smoke's
    `decisive_settings` (no gate, top-K or suppression decision differs),
    with max_det = K."""
    import chip_smoke
    from face_detection_multi_scale_tpu_torch.models.head import (
        decode, reshape_level)

    det = FaceDetector(narrow_tiny(), img_sizes=(128,), dtype=dtype,
                       device=cuda_device)
    frames = np.random.default_rng(6).integers(0, 256, (4, 128, 128, 3),
                                               dtype=np.uint8)
    x = torch.from_numpy(frames).to(cuda_device).to(dtype) / 255.0
    raws = det._forward(x, reshape_heads=False)
    spec = det.spec
    assert raws[0].shape[-1] == spec.na * spec.no
    rows = [decode([reshape_level(r.permute(0, 3, 1, 2), spec.na, spec.no)
                    for r in rs], spec)
            for rs in (raws, [r.cpu() for r in raws])]
    conf, iou = chip_smoke.decisive_settings(*rows, k=512)
    launches = K.nms_keep.launches
    got = NMS.non_max_suppression_from_raws(raws, spec, conf, iou,
                                            max_candidates=512, max_det=512)
    torch.cuda.synchronize()
    assert K.nms_keep.launches == launches + 1
    want = NMS.non_max_suppression_from_raws([r.cpu() for r in raws],
                                             spec, conf, iou,
                                             max_candidates=512, max_det=512)
    assert torch.equal(got.n_gated.cpu(), want.n_gated)
    assert torch.equal(got.valid.sum(1).cpu(), want.valid.sum(1))
    assert got.valid.any()
    for g, w in zip(NMS.detections_to_numpy(got),
                    NMS.detections_to_numpy(want)):
        pair = np.abs(g[:, None, :5] - w[None, :, :5]).max(-1).argmin(1) \
            if len(g) else np.zeros(0, int)
        assert len(set(pair.tolist())) == len(pair)
        np.testing.assert_allclose(g, w[pair], atol=5e-3, rtol=1e-3)


@pytest.mark.parametrize("agnostic", [False, True])
def test_agnostic_nms_on_card_matches_cpu(cuda_device, agnostic):
    """nc = 3 rows through non_max_suppression on the card and on the CPU:
    one keep-mask launch, Detections equal bit for bit."""
    rng = np.random.default_rng(7)
    n = 3000
    centers = rng.uniform(0, 640, (2, 24, 2))
    cxy = centers[:, rng.integers(0, 24, n)] + rng.normal(0, 12, (2, n, 2))
    pred = np.concatenate([cxy, rng.uniform(8, 90, (2, n, 2)),
                           rng.uniform(0, 1, (2, n, 4)),
                           rng.uniform(0, 640, (2, n, 15))], -1)
    pred = torch.from_numpy(pred.astype(np.float32))
    launches = K.nms_keep.launches
    got = NMS.non_max_suppression(pred.to(cuda_device), 0.2, 0.45, nc=3,
                                  max_candidates=2048, agnostic=agnostic)
    torch.cuda.synchronize()
    assert K.nms_keep.launches == launches + 1
    want = NMS.non_max_suppression(pred, 0.2, 0.45, nc=3,
                                   max_candidates=2048, agnostic=agnostic)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_ensemble_launches_the_kernel_once(cuda_device, monkeypatch):
    """EnsembleDetector over two narrowed tiny models on the card: one
    keep-mask launch for the concatenated rows (captured as the NMS gets
    them), and Detections equal to the CPU postprocess of those rows."""
    from face_detection_multi_scale_tpu_torch.infer import ensemble
    from face_detection_multi_scale_tpu_torch.infer.ensemble import (
        EnsembleDetector)

    seen = []
    nms = NMS.non_max_suppression
    monkeypatch.setattr(ensemble.NMS, "non_max_suppression",
                        lambda pred, *a, **kw: seen.append(pred)
                        or nms(pred, *a, **kw))

    kw = dict(img_sizes=(128,), conf_thres=0.01, max_candidates=1024,
              device=cuda_device)
    members = [FaceDetector(narrow_tiny(), seed=s, **kw) for s in (0, 1)]
    ens = EnsembleDetector(members)
    frames = np.random.default_rng(8).integers(0, 256, (2, 128, 128, 3),
                                               dtype=np.uint8)
    seq, fused = K.nms_keep.launches, E.fused_elan.launches
    got = ens.run_network(frames)
    torch.cuda.synchronize()
    assert K.nms_keep.launches == seq + 1
    assert E.fused_elan.launches == fused
    monkeypatch.undo()
    rows = seen[0].cpu()
    assert rows.shape[:2] == (2, 2 * 1008)
    want = NMS.non_max_suppression(rows, 0.01, ens.iou_thres,
                                   max_candidates=1024)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# ---------------------------------------------------------------------------
# the int8 conv (csrc/qconv.cu) and int8 serving
# ---------------------------------------------------------------------------

def qconv_case(b, h, w, cin, cout, k, groups, seed, device):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)
    wq = rng.integers(-127, 128, (cout, k, k, cin // groups), dtype=np.int8)
    alpha = rng.uniform(1e-5, 3e-4, cout).astype(np.float32)
    bias = rng.normal(0, 0.5, cout).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, wq, alpha, bias)]


def check_qconv(got, x, w, alpha, bias, inv_out, stride, pads, groups, act):
    """The kernel's output equals the plain version's, except at most 1
    apart where the plain pre-round value lies within 1e-4 of a half
    integer (the activation's last bits)."""
    z = QK.pre_round(QK.conv_sums(x, w, stride, pads, groups), alpha, bias,
                     inv_out, act)
    want = torch.clamp(torch.round(z), -127, 127).to(torch.int8)
    assert got.shape == want.shape and got.dtype == torch.int8
    diff = (got.int() - want.int()).abs()
    near = (z - torch.floor(z) - 0.5).abs() < 1e-4
    assert int(diff.max()) <= 1 and not bool(diff[~near].any())


@pytest.mark.parametrize("act", list(QK.ACTS))
@pytest.mark.parametrize("b,h,w,cin,cout,k,s,groups", [
    (2, 17, 19, 3, 32, 3, 2, 1), (2, 16, 16, 12, 64, 3, 1, 1),
    (1, 20, 20, 56, 104, 3, 2, 1), (2, 9, 11, 64, 64, 1, 1, 1),
    (1, 13, 13, 216, 40, 3, 1, 1), (1, 8, 8, 1024, 512, 1, 1, 1),
    (3, 33, 31, 104, 200, 1, 1, 1), (2, 15, 15, 24, 24, 3, 2, 24),
    (2, 16, 16, 48, 48, 3, 1, 48), (1, 12, 12, 32, 64, 3, 1, 2),
    # the wgmma route at w6's shapes: a 10-px map at b8 (M = 800) that
    # splits K four ways, 1x1 convs that split two ways, 3x3 stride 2,
    # Cout 192 and 960 (N tiles of 64), 1280 channels
    (8, 10, 10, 512, 512, 3, 1, 1), (8, 10, 10, 1024, 512, 1, 1, 1),
    (2, 40, 40, 128, 256, 3, 2, 1), (2, 20, 20, 384, 192, 3, 1, 1),
    (2, 20, 20, 384, 960, 3, 1, 1), (2, 10, 10, 512, 1280, 1, 1, 1),
    # 64- and 32-byte K steps, a Cin of 16 mod 32 (half-empty last runs),
    # an N tail and a Cout that is not a multiple of 16
    (2, 24, 24, 64, 128, 3, 1, 1), (2, 17, 23, 32, 64, 3, 2, 1),
    (2, 13, 11, 48, 96, 3, 1, 1), (2, 12, 12, 16, 48, 1, 1, 1),
    (1, 9, 9, 64, 40, 3, 1, 1),
    # more tiles than blocks: each persistent block walks several
    (8, 64, 64, 32, 64, 3, 1, 1), (4, 80, 80, 128, 256, 3, 1, 1),
    # a K of 48 bytes on 400 tiles: the route rule's mma (lite-t's shape)
    (8, 80, 80, 48, 48, 1, 1, 1)])
def test_qconv_matches_plain(cuda_device, b, h, w, cin, cout, k, s, groups,
                             act):
    """Ragged Cin (3, 12, 56, 104, 216: 1-, 4- and 8-byte staging),
    M and N not multiples of the tile, 1x1 at 1024 channels, depthwise
    and grouped convs, every activation; every route (wgmma for 16-byte
    channel runs, split over a cluster on small grids), each counted, and
    the library's launched plan equal to `qconv_plan`'s; where the route
    rule keeps such a conv on mma, the wgmma route equal to it too."""
    x, wq, alpha, bias = qconv_case(b, h, w, cin, cout, k, groups,
                                    seed=cin + cout + k, device=cuda_device)
    inv = torch.tensor(41.3)
    pads = (k // 2, k // 2)
    plan = QK.plan_for(x, wq, s, pads, groups)
    tma = cin % 16 == 0 and groups == 1  # 16-byte runs and pointers
    ho, wo = QK.out_hw(h, w, (k, k), s, pads)
    tiles = -(-b * ho * wo // 128) * -(-cout // (128 if cout % 128 == 0
                                                 else 64))
    short = (k * k * cin < QK.WGMMA_MIN_K
             and tiles > QK.device_sms(x.get_device()))
    want_route = ("direct" if groups > 1 else
                  "wgmma" if tma and not short else "mma")
    assert plan.route == want_route
    before = (QK.qconv.launches, QK.qconv.depthwise_launches,
              QK.qconv.wgmma_launches, QK.qconv.split_launches)
    got = QK.qconv(x, wq, alpha, bias, inv, s, pads, groups, act)
    torch.cuda.synchronize()
    assert QK.last_plan() == plan.row()
    after = (QK.qconv.launches, QK.qconv.depthwise_launches,
             QK.qconv.wgmma_launches, QK.qconv.split_launches)
    assert [a - c for a, c in zip(after, before)] == [
        1, plan.route == "direct", plan.route == "wgmma",
        plan.route == "wgmma" and plan.split > 1]
    check_qconv(got, x, wq, alpha, bias, inv, s, pads, groups, act)
    if tma and plan.route == "mma":
        # a conv the route rule keeps off wgmma: that route agrees too
        wg = QK._route_plan("wgmma", b, h, w, cin, cout, k, k, s, 1, 16, 16,
                            pads, sms=QK.device_sms(x.get_device()))
        y = QK._launch(wg, x, wq, alpha, bias, inv, s, pads, 1, act)
        torch.cuda.synchronize()
        assert QK.last_plan() == wg.row()
        assert torch.equal(y, got)


@pytest.mark.parametrize("split", [1, 2, 3, 6])
def test_qconv_wgmma_splits(cuda_device, split):
    """Every K split of a 10-px 3x3 conv (18 K steps), and asymmetric pads,
    on the wgmma route equal the plain version and the mma route bit for
    bit."""
    x, wq, alpha, bias = qconv_case(2, 10, 10, 256, 128, 3, 1, 7,
                                    cuda_device)
    args = (x, wq, alpha, bias, 17.5)
    for pads in ((1, 1), (1, 0), (0, 2)):
        plan = QK._route_plan("wgmma", 2, 10, 10, 256, 128, 3, 3, 1, 1, 16,
                              16, pads, split=split)
        assert plan.split == split and plan.k_steps == 18
        splits = QK.qconv.split_launches
        got = QK._launch(plan, *args, 1, pads, 1, "silu")
        torch.cuda.synchronize()
        assert QK.last_plan() == plan.row()
        assert QK.qconv.split_launches == splits + (split > 1)
        check_qconv(got, x, wq, alpha, bias, 17.5, 1, pads, 1, "silu")
        mma = QK._route_plan("mma", 2, 10, 10, 256, 128, 3, 3, 1, 1, 16, 16,
                             pads)
        assert torch.equal(got, QK._launch(mma, *args, 1, pads, 1, "silu"))


def test_qconv_misaligned_and_rejects(cuda_device):
    """A tensor at an odd byte offset takes the mma route, stages byte by
    byte and still agrees; a non-contiguous input raises."""
    x, wq, alpha, bias = qconv_case(1, 10, 10, 64, 64, 3, 1, 5, cuda_device)
    flat = torch.empty(x.numel() + 1, dtype=torch.int8, device=cuda_device)
    xo = flat[1:].view(x.shape)
    xo.copy_(x)
    wgmma = QK.qconv.wgmma_launches
    got = QK.qconv(xo, wq, alpha, bias, 20.0, 1, (1, 1), 1, "silu")
    assert QK.last_plan()[0] == QK.ROUTES["mma"]  # TMA needs 16 bytes
    assert QK.qconv.wgmma_launches == wgmma
    check_qconv(got, x, wq, alpha, bias, 20.0, 1, (1, 1), 1, "silu")
    with pytest.raises(ValueError, match="contiguous"):
        QK.qconv(x.transpose(1, 2), wq, alpha, bias, 20.0, 1, (1, 1))


@pytest.mark.parametrize("name", ["yolov7-tiny-face", "yolov7-lite-t"])
def test_int8_engine_on_card_matches_cpu_postprocess(cuda_device, name):
    """An int8 detector on the card: one qconv launch per conv of the walk
    and one nms_keep launch a request; raws within 1e-2 of max |raw| per
    level of the same walk with the plain conv swapped in; Detections
    equal to the CPU postprocess of the same rows."""
    frames = np.random.default_rng(0).integers(0, 256, (2, 128, 128, 3),
                                               dtype=np.uint8)
    det = FaceDetector(name, img_sizes=(128,), conf_thres=0.01,
                       max_candidates=512, quantize="int8",
                       calib_images=frames, device=cuda_device)
    convs = len(det._qparams["convs"])
    grouped = sum(q["w"].shape[-1] == 1 and q["w"].shape[0] > 1
                  for q in det._qparams["convs"].values())
    seq, launches = K.nms_keep.launches, QK.qconv.launches
    dw = QK.qconv.depthwise_launches
    dets = det.run_network(frames)
    torch.cuda.synchronize()
    assert K.nms_keep.launches == seq + 1
    assert QK.qconv.launches == launches + convs
    assert QK.qconv.depthwise_launches == dw + grouped
    x = torch.from_numpy(frames).to(cuda_device).float() / 255.0
    raws = det._forward(x)
    TQ.qconv = QK.qconv_plain
    try:
        plain = det._forward(x)
    finally:
        TQ.qconv = QK.qconv
    for g, p in zip(raws, plain):
        assert bool(torch.isfinite(g).all())
        assert float((g - p).abs().max()) <= 1e-2 * float(p.abs().max())
    rows = det.forward_rows(frames)
    for got, want in zip(det.postprocess(rows), det.postprocess(rows.cpu())):
        assert torch.equal(got.cpu(), want)
    assert dets.valid.any()


# ---------------------------------------------------------------------------
# evaluation (WIDER writer, int8 eval batch) and the eval point of nms_keep
# ---------------------------------------------------------------------------

def test_nms_keep_at_the_eval_point(cuda_device):
    """B = 16, K = 16384 (cli/test_widerface's batch and max_candidates):
    one launch; the keep masks of the first and last images equal to
    nms_keep_plain's."""
    boxes, valid = candidates(16, 16384, seed=77, frac_valid=0.9,
                              device=cuda_device)
    launches = K.nms_keep.launches
    got = K.nms_keep(boxes, valid, 0.5)
    torch.cuda.synchronize()
    assert K.nms_keep.launches == launches + 1
    for i in (0, 15):
        want = K.nms_keep_plain(boxes[i:i + 1], valid[i:i + 1], 0.5)
        assert torch.equal(got[i:i + 1], want)
    assert not bool(got[~valid].any())


def test_wider_writer_on_card_matches_cpu_postprocess(cuda_device,
                                                      tmp_path):
    """cli/test_widerface.write_buckets on the card, narrowed tiny, two
    letterboxed buckets: one nms_keep launch an engine call, each call's
    Detections equal to the CPU postprocess of its rows, and each txt's
    count line its image's kept rows."""
    from face_detection_multi_scale_tpu_torch.cli import test_widerface as TW
    from face_detection_multi_scale_tpu_torch.eval.widerface import (
        read_pred_file)

    det = FaceDetector(narrow_tiny(), img_sizes=(192,), conf_thres=0.01,
                       max_det=1024, max_candidates=2048,
                       device=cuda_device)
    rng = np.random.default_rng(21)
    buckets = {hw: [(f"{b}--E/i{b}_{i}.jpg", (2 * hw[0], 2 * hw[1], 3),
                     rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
                    for i in range(3)]
               for b, hw in enumerate(((128, 192), (192, 128)))}
    seen = []
    post = det.postprocess
    det.postprocess = lambda rows: seen.append((rows, post(rows))) or \
        seen[-1][1]
    launches = K.nms_keep.launches
    out = TW.write_buckets(det, buckets, str(tmp_path), img_size=192,
                           batch_size=2)
    torch.cuda.synchronize()
    assert out["batches"] == len(seen) == 4
    assert K.nms_keep.launches == launches + 4
    for rows, dets in seen:
        for got, want in zip(dets, post(rows.cpu())):
            assert torch.equal(got.cpu(), want)
    kept = [int(v) for _, d in seen for v in d.valid.sum(1).cpu()]
    names = [n for items in buckets.values() for n, _, _ in items]
    for name, n in zip(names, kept):
        assert len(read_pred_file(str(tmp_path / (name[:-4] + ".txt")))[1]) \
            == n
    assert sum(kept) > 0


def test_int8_eval_batch_every_conv_exact(cuda_device):
    """An int8 tiny detector calibrated lazily on a B = 16 batch of 640 x
    512 network inputs (the --quantize eval's batch): every qconv launch
    of that batch equal to qconv_plain (chip_smoke.qconv_exact, which also
    holds the launched plan to qconv_plan's), one nms_keep launch."""
    import chip_smoke
    from face_detection_multi_scale_tpu_torch.models import quant as Q

    frames = np.random.default_rng(5).integers(0, 256, (16, 640, 512, 3),
                                               dtype=np.uint8)
    det = FaceDetector("yolov7-tiny-face", img_sizes=(640,),
                       conf_thres=0.01, max_det=4096, max_candidates=16384,
                       quantize="int8", device=cuda_device)
    calls = []
    real = Q.qconv

    def record(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out

    seq = K.nms_keep.launches
    Q.qconv = record
    try:
        det.run_network(frames)
    finally:
        Q.qconv = real
    torch.cuda.synchronize()
    assert K.nms_keep.launches == seq + 1
    assert len(calls) == len(det._qparams["convs"])
    for args, kw, launched in calls:
        again, _, _, _, _ = chip_smoke.qconv_exact(args, kw, "int8 eval")
        assert torch.equal(again, launched)


@pytest.mark.parametrize("accumulate", [False, True])
def test_train_step_on_card_matches_cpu(cuda_device, accumulate):
    """Narrowed tiny at b4@64: one make_train_step (or two accumulated
    micro-steps and an apply) on the card and on the CPU from the same
    seeded state, at phase 22(a)'s tolerances (losses rtol 5e-4,
    parameters and EMA rtol 5e-3 / atol 5e-5, BN statistics rtol 1e-4):
    the card's float32 step within them of the CPU's, and
    chip_smoke.train_step_parity's check against the float64 step."""
    import chip_smoke

    out = chip_smoke.train_step_parity(narrow_tiny, 64, 4, seed=3,
                                       accumulate=accumulate)
    assert all(v <= 1.0 for v in out["card_cpu"].values()), out


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_checkpoint_round_trip_on_card(cuda_device, tmp_path, optimizer):
    """A card TrainState after a step saved (sync and by the background
    writer) and loaded into another card state: every tensor equal and
    still on the card, the counters and the meta back."""
    import chip_smoke
    from face_detection_multi_scale_tpu_torch.models.model import (
        YoloFace, init_weights)
    from face_detection_multi_scale_tpu_torch.train import checkpoint as C
    from face_detection_multi_scale_tpu_torch.train import trainer as TR
    from face_detection_multi_scale_tpu_torch.train.hyp import (
        HYP_SCRATCH_P6)
    from face_detection_multi_scale_tpu_torch.train.targets import (
        build_targets_batched)

    def state(seed):
        net = init_weights(YoloFace(narrow_tiny()),
                           torch.Generator().manual_seed(seed))
        return TR.create_train_state(net.to(cuda_device), optimizer)

    s = state(0)
    images, labels = chip_smoke.face_batch(np.random.default_rng(1), 2, 64)
    targets = build_targets_batched(labels, 2, s.model.spec, [
        (64 // st,) * 2 for st in s.model.spec.strides])
    step = TR.make_train_step(s.model, TR.TrainConfig(optimizer=optimizer),
                              dict(HYP_SCRATCH_P6), 64)
    s, _, _ = step(s, images, targets)
    meta = {"epoch": 4, "best_fitness": 0.5}
    C.save_checkpoint(str(tmp_path), "last", s, meta)
    writer = C.AsyncCheckpointWriter()
    writer.save(str(tmp_path), "best", s, meta)
    writer.close()
    for tag in ("last", "best"):
        other, got = C.load_checkpoint(str(tmp_path), tag, state(1))
        assert got == meta and chip_smoke.states_equal(other, s)
        assert all(t.is_cuda for t in other.ema_params.values())
        assert all(t.is_cuda for t in other.model.state_dict().values())


def test_program_on_card_launches_nms_keep(cuda_device, tmp_path):
    """yolov7-tiny-face (seeded weights) exported with its postprocess at
    b2@640 on the card, saved and loaded back: one fdms_torch.nms_keep
    node, one kernel launch a call (none of the fixpoint kernel), and
    the live card pipeline's Detections (`valid` exact, the rest within
    the decoded-row tolerance)."""
    from face_detection_multi_scale_tpu_torch import export_model as EM
    from face_detection_multi_scale_tpu_torch.models.head import decode
    from face_detection_multi_scale_tpu_torch.models.model import (
        YoloFace, init_weights)

    spec = zoo.get_spec("yolov7-tiny-face").resolve()
    net = init_weights(YoloFace(spec), torch.Generator().manual_seed(1))
    frames = np.random.default_rng(2).integers(0, 256, (2, 640, 640, 3),
                                               dtype=np.uint8)
    live = EM.serving_model(net, torch.float32, cuda_device)

    def live_dets(gate):
        with torch.inference_mode(), full_fp32():
            x = torch.from_numpy(frames).to(cuda_device).float() / 255.0
            rows = decode(live(x), spec)
            if gate is None:
                return rows
            return NMS.non_max_suppression(rows, gate, 0.5,
                                           max_candidates=2048, max_det=300)

    # a gate that about a thousand rows of each image pass (random
    # weights put most confidences far below the default 0.25)
    rows = live_dets(None)
    conf = (rows[..., 4] * rows[..., 5]).sort(dim=1, descending=True)[0]
    gate = float(conf[:, 1000].min())
    path = str(tmp_path / "tiny.pt2")
    EM.export_program(net, spec, path, img_size=640, batch=2,
                      conf_thres=gate, iou_thres=0.5, max_det=300,
                      device=cuda_device)
    prog = EM.load_program(path)
    assert EM.op_count(prog.exported, "fdms_torch.nms_keep") == 1
    seq, fix = K.nms_keep.launches, K.nms_keep.fixpoint_launches
    got = prog(frames)
    torch.cuda.synchronize()
    assert K.nms_keep.launches == seq + 1
    assert K.nms_keep.fixpoint_launches == fix
    want = live_dets(gate)
    assert torch.equal(got[4], want.valid) and int(want.valid.sum()) > 0
    for g, w in zip(got[:4], want[:4]):
        torch.testing.assert_close(g, w, atol=5e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# the extra cfg (models/layers_extra.py), chip_smoke phase 24 (a)-(c)
# ---------------------------------------------------------------------------

def extra_spec():
    import json
    from pathlib import Path

    from face_detection_multi_scale_tpu_torch.models.spec import (
        spec_from_yolo_yaml)
    path = Path(__file__).resolve().parent / "data" / \
        "yolov7s-face-extra.json"
    return spec_from_yolo_yaml(json.loads(path.read_text()),
                               "yolov7s-face-extra")


def extra_detector(device, **kw):
    det = FaceDetector(extra_spec(), img_sizes=(256,), max_candidates=1024,
                       seed=8, device=device, **kw)
    rows = det.forward_rows(EXTRA_FRAMES)
    conf = (rows[..., 4] * rows[..., 5]).sort(dim=1, descending=True)[0]
    det.conf_thres = float(conf[:, 1500].max())  # overfills K
    return det


EXTRA_FRAMES = np.random.default_rng(8).integers(0, 256, (2, 256, 256, 3),
                                                 dtype=np.uint8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fuse_elan", [False, True])
def test_extra_cfg_on_card(cuda_device, dtype, fuse_elan):
    """The extra cfg at full width, b2@256 on the card: one nms_keep launch
    a request and fused_elan once a group with fuse_elan; the Detections
    equal to the CPU postprocess of the card's rows; in float32 the rows
    within the decoded-row tolerance of a CPU forward (fused: of the
    unfused card forward too), in bf16 the raws within 5e-2 of max
    |float32 raw| of the card."""
    det = extra_detector(cuda_device, dtype=dtype, fuse_elan=fuse_elan)
    groups = len(find_elan_blocks(det.spec))
    assert groups == 8
    seq, f32, b16 = (K.nms_keep.launches, E.fused_elan.launches,
                     E.fused_elan.bf16_launches)
    dets = det.run_network(EXTRA_FRAMES)
    torch.cuda.synchronize()
    assert K.nms_keep.launches == seq + 1
    fused = groups if fuse_elan else 0
    bf16 = dtype == torch.bfloat16
    assert E.fused_elan.launches == f32 + (0 if bf16 else fused)
    assert E.fused_elan.bf16_launches == b16 + (fused if bf16 else 0)
    assert int(dets.n_gated.max()) > det.max_candidates
    rows = det.forward_rows(EXTRA_FRAMES)
    want = det.postprocess(rows.cpu())
    assert all(torch.equal(a.cpu(), b) for a, b in zip(dets, want))
    if not bf16:
        cpu = FaceDetector(extra_spec(), img_sizes=(256,), seed=8,
                           device="cpu")
        torch.testing.assert_close(rows.cpu(), cpu.forward_rows(
            EXTRA_FRAMES), atol=5e-3, rtol=1e-3)
        return
    ref = FaceDetector(extra_spec(), img_sizes=(256,), seed=8,
                       device=cuda_device)
    x = torch.as_tensor(EXTRA_FRAMES).to(cuda_device)
    with torch.inference_mode():
        got = det._forward(x.to(torch.bfloat16) / 255.0)
        want_raws = ref._forward(x.float() / 255.0)
    for g, w in zip(got, want_raws):
        share = float((g.float() - w).abs().max() / w.abs().max())
        assert share < 5e-2, share
