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
