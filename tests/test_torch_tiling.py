"""The port's tiled giant scales (infer/tiling.py and the FaceDetector's
tiled paths) against the JAX package on the CPU.

The geometry (`plan_tiles`, `extract_tiles`, `owner_interval`) must equal
the JAX module's field for field over the config space of
tests/test_tiling.py, rejections included; `assemble_rows` (offsets,
ownership, the seam dedup through the weighted merge) must give the JAX
rows exactly. The JAX marker-mock detector tests (tests/test_tiling.py)
run on the port's detector with the same mock network, returning torch
Detections, and against the JAX detector. One end-to-end test serves a
real narrowed network: tiled `detect_multi_scale_batch` and
`detect_batch` give the JAX detector's row counts, and rows within the
decoded-row tolerance ROW_TOL (boxes within 1 px where both sides
.round() them, as tests/test_torch_multiscale.py)."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.data import letterbox as JLB
from face_detection_multi_scale_tpu.infer import tiling as JT
from face_detection_multi_scale_tpu.infer.detector import (
    FaceDetector as JFaceDetector)
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu_torch.infer import tiling as TT
from face_detection_multi_scale_tpu_torch.infer.detector import (
    FaceDetector as TFaceDetector)
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.ops import nms as TN

from test_tiling import _marker_image, _marker_mock_run_network
from scipy.optimize import linear_sum_assignment

from test_torch_detector import ROW_TOL, safe_settings, shared_variables
from test_torch_model import narrowed

NAME = "yolov7-tiny-face"


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def plan_or_error(mod, *args):
    try:
        return mod.plan_tiles(*args)
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("grid", [2, 3, 4, 5])
def test_plan_tiles_matches_jax_over_config_space(grid):
    """Every (size, halo) of tests/test_tiling.py's fuzzed space (sizes
    64 x 2..64, halo 0..1024, stride 64), exhaustively: the same plan
    field for field and the same ownership cells, or the same
    ValueError."""
    plans = 0
    for size in range(128, 64 * 65, 64):
        for halo in range(1025):
            want = plan_or_error(JT, size, grid, halo, 64)
            got = plan_or_error(TT, size, grid, halo, 64)
            if isinstance(want, str):
                assert got == want
                continue
            plans += 1
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            assert got.n_tiles == want.n_tiles == grid * grid
            assert ([TT.owner_interval(got, i) for i in range(grid)]
                    == [JT.owner_interval(want, i) for i in range(grid)])
    assert plans > 1000


@pytest.mark.parametrize("args", [
    (256, 1, 64, 64), (250, 2, 64, 64), (2048, 2, 1000, 64),
    (3840, 2, 256, 64), (256, 2, 64, 32), (1920, 3, 128, 64),
    (640, 3, 64, 32), (96, 2, 0, 32)])
def test_plan_tiles_rejections_and_stride_32(args):
    want, got = plan_or_error(JT, *args), plan_or_error(TT, *args)
    if isinstance(want, str):
        assert got == want
    else:
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("args", [(256, 2, 64, 64), (640, 3, 64, 32),
                                  (3840, 2, 256, 64)])
def test_extract_tiles_matches_jax(args):
    plan_j, plan_t = JT.plan_tiles(*args), TT.plan_tiles(*args)
    size = args[0]
    frame = np.random.default_rng(size).integers(0, 256, (size, size, 3),
                                                 np.uint8)
    got = TT.extract_tiles(frame, plan_t)
    assert got.shape == (plan_t.n_tiles, plan_t.tile, plan_t.tile, 3)
    np.testing.assert_array_equal(got, JT.extract_tiles(frame, plan_j))
    for mod, plan in ((JT, plan_j), (TT, plan_t)):
        with pytest.raises(ValueError, match="plan size"):
            mod.extract_tiles(frame[:-1], plan)


# ---------------------------------------------------------------------------
# assemble_rows
# ---------------------------------------------------------------------------

def tile_rows(plan, seed, ncols, empty=()):
    """Seeded (n, ncols) rows per tile in TILE coordinates: boxes all over
    the tile (so many fall outside the tile's ownership cell), conf on 6
    levels (weighted scores tie), and for every row near an ownership
    bound a jittered copy in the neighbouring tile (a seam duplicate);
    tiles in `empty` get no rows."""
    rng = np.random.default_rng(seed)
    t = plan.tile
    per_tile = []
    for idx in range(plan.n_tiles):
        n = 0 if idx in empty else int(rng.integers(1, 40))
        xy = rng.uniform(0, t - 8, (n, 2))
        wh = rng.uniform(4, 60, (n, 2))
        rows = np.zeros((n, ncols))
        rows[:, :2], rows[:, 2:4] = xy, np.minimum(xy + wh, t)
        rows[:, 4] = rng.choice(np.linspace(0.5, 0.95, 6), n)
        if ncols > 6:
            rows[:, 6::3] = rng.uniform(0, t, (n, (ncols - 6) // 3))
            rows[:, 7::3] = rng.uniform(0, t, (n, (ncols - 6) // 3))
            rows[:, 8::3] = rng.uniform(0, 1, (n, (ncols - 6) // 3))
        per_tile.append(rows)
    # seam duplicates across the first vertical bound of tile row 0
    bound, (ox0, ox1) = plan.bounds[0], plan.origins[:2]
    if 0 not in empty and 1 not in empty:
        dup = per_tile[0][:4].copy()
        cx = bound - ox0 + rng.uniform(-1.5, 0.5, len(dup))
        half = (dup[:, 2] - dup[:, 0]) / 2
        dup[:, 0], dup[:, 2] = cx - half, cx + half
        per_tile[0][:4] = dup
        twin = dup.copy()
        twin[:, [0, 2]] += ox0 - ox1 + rng.uniform(0.6, 1.2, (len(dup), 1))
        twin[:, 4] *= 0.97
        per_tile[1] = np.vstack([per_tile[1], twin])
    return [r.astype(np.float32) for r in per_tile]


@pytest.mark.parametrize("plan_args,ncols,empty", [
    ((256, 2, 64, 64), 6, ()), ((256, 2, 64, 64), 21, ()),
    ((256, 2, 64, 64), 21, (2, 3)), ((640, 3, 64, 32), 21, (4,)),
    ((3840, 2, 256, 64), 21, ()), ((256, 2, 64, 64), 21, (0, 1, 2, 3))])
@pytest.mark.parametrize("seed", [0, 1])
def test_assemble_rows_matches_jax(plan_args, ncols, empty, seed):
    plan_j, plan_t = JT.plan_tiles(*plan_args), TT.plan_tiles(*plan_args)
    rows = tile_rows(plan_t, seed, ncols, empty)
    for iou in (0.3, 0.45):
        want = JT.assemble_rows(rows, plan_j, iou)
        got = TT.assemble_rows(rows, plan_t, iou, device="cpu")
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, np.asarray(want))
    if len(empty) < plan_t.n_tiles:
        assert 0 < len(got) < sum(len(r) for r in rows)


# ---------------------------------------------------------------------------
# the detector, with tests/test_tiling.py's marker mock network
# ---------------------------------------------------------------------------

def port_mock(max_det):
    """tests/test_tiling.py's marker network, returning torch Detections
    as the port's run_network does."""
    run = _marker_mock_run_network(max_det)

    def port_run(images_u8, _record=True):
        dets = run(np.asarray(images_u8))
        return TN.Detections(*(torch.from_numpy(np.asarray(x))
                               for x in dets))

    return port_run


@pytest.fixture(scope="module")
def mock_pair():
    """(JAX, port) detectors over the narrowed tiny model, tiled at 256
    with a 64 px halo, their networks replaced by the marker mock."""
    kw = dict(img_sizes=(256,), conf_thres=0.1, iou_thres=0.5,
              tile_top_scale=2, tile_halo=64, tile_min_size=256)
    jdet = JFaceDetector(narrowed(JZ, NAME), variables=shared_variables(NAME),
                         **kw)
    tdet = TFaceDetector(narrowed(TZ, NAME), device="cpu", **kw)
    jdet.run_network = _marker_mock_run_network(jdet.max_det)
    tdet.run_network = port_mock(tdet.max_det)
    return jdet, tdet


def by_conf(rows):
    return rows[np.argsort(rows[:, 4])]


def test_mock_batch_tiled_equals_untiled_and_jax(mock_pair):
    jdet, tdet = mock_pair
    img, n = _marker_image()
    tdet.tile_grid = jdet.tile_grid = 2
    tiled = tdet.detect_multi_scale_batch([img])[0]
    want = jdet.detect_multi_scale_batch([img])[0]
    tdet.tile_grid = 0
    untiled = tdet.detect_multi_scale_batch([img])[0]
    assert len(tiled) == len(untiled) == n
    np.testing.assert_allclose(by_conf(tiled), by_conf(untiled))
    np.testing.assert_array_equal(by_conf(tiled), by_conf(np.asarray(want)))


@pytest.mark.parametrize("raw_only", [False, True], ids=["host", "raw"])
def test_mock_single_scale_api_tiled_equals_untiled(mock_pair, raw_only):
    """API mode tiles per image. With device preprocessing the tiled
    scale letterboxes on the host: from the host frame, or from the raw
    upload when the caller handed only that."""
    jdet, tdet = mock_pair
    img, n = _marker_image()
    tdet.use_api_preprocess = jdet.use_api_preprocess = True
    try:
        tdet.tile_grid = jdet.tile_grid = 2
        want, _, _ = jdet.detect_single_scale(img, 256)
        if raw_only:
            tdet.use_device_preprocess = True
            tiled, shape_t, _ = tdet.detect_single_scale(
                None, 256, _raw_dev=torch.from_numpy(img[None]))
            tdet.use_device_preprocess = False
        else:
            tiled, shape_t, _ = tdet.detect_single_scale(img, 256)
        tdet.tile_grid = 0
        untiled, shape_u, _ = tdet.detect_single_scale(img, 256)
    finally:
        tdet.use_api_preprocess = jdet.use_api_preprocess = False
        tdet.use_device_preprocess = False
    assert tuple(shape_t) == tuple(shape_u) == img.shape
    assert len(tiled) == len(untiled) == n
    np.testing.assert_allclose(by_conf(tiled), by_conf(untiled))
    np.testing.assert_array_equal(by_conf(tiled), by_conf(np.asarray(want)))


def test_mock_detect_batch_tiled_equals_untiled(mock_pair):
    jdet, tdet = mock_pair
    img, n = _marker_image()
    tdet.tile_grid = jdet.tile_grid = 2
    tiled = tdet.detect_batch([img, img], 256, kpt=False)
    want = jdet.detect_batch([img, img], 256, kpt=False)
    tdet.tile_grid = 0
    untiled = tdet.detect_batch([img, img], 256, kpt=False)
    for t, u, w in zip(tiled, untiled, want):
        assert len(t) == len(u) == n
        np.testing.assert_allclose(by_conf(t), by_conf(u))
        np.testing.assert_array_equal(by_conf(t), by_conf(np.asarray(w)))


def test_mock_plan_gating(mock_pair):
    _, tdet = mock_pair
    tdet.tile_grid = 2
    plan = tdet._tile_plan(256)
    assert dataclasses.astuple(plan) == dataclasses.astuple(
        TT.plan_tiles(256, 2, 64, tdet.stride))
    assert tdet._tile_plan(128) is None     # below tile_min_size
    tdet.tile_grid = 0
    assert tdet._tile_plan(256) is None


def test_grid1_rejected_at_construction():
    with pytest.raises(ValueError, match="tile_top_scale=1"):
        TFaceDetector(narrowed(TZ, NAME), tile_top_scale=1, device="cpu")
    assert TFaceDetector(narrowed(TZ, NAME), tile_top_scale=True,
                         device="cpu").tile_grid == 2


@pytest.mark.parametrize("max_candidates", [4096, 1])
def test_mock_truncation_telemetry_per_image(mock_pair, max_candidates):
    """A tiled image is ONE report entry, not g^2 tiles; with a capacity
    of 1 every tile that sees two markers overflows, and the image counts
    once, as on the JAX detector."""
    img, _ = _marker_image()
    deltas = []
    for det in mock_pair:
        det.tile_grid, det.max_candidates = 2, max_candidates
        before = det.truncation_report()
        det.detect_multi_scale_batch([img, img])
        after = det.truncation_report()
        deltas.append({k: after[k] - before[k] for k in
                       ("images", "truncated_images", "dropped_total")})
        det.max_candidates = 4096
    assert deltas[1] == deltas[0]
    assert deltas[1]["images"] == 2
    assert deltas[1]["truncated_images"] == (2 if max_candidates == 1
                                             else 0)


def test_mock_standard_per_image_warns_once(mock_pair):
    _, tdet = mock_pair
    tdet.tile_grid = 2
    tdet._warned_tile_standard = False
    img, _ = _marker_image()
    assert not tdet.use_api_preprocess
    with pytest.warns(RuntimeWarning, match="tile_top_scale is inert"):
        tdet.detect_single_scale(img, 256)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tdet.detect_single_scale(img, 256)


# ---------------------------------------------------------------------------
# end to end, a real narrowed network
# ---------------------------------------------------------------------------

IMAGES = [np.random.default_rng(s).integers(0, 256, hw + (3,), np.uint8)
          for s, hw in ((11, (200, 256)), (12, (256, 180)))]
SIZE = 256


@pytest.fixture(scope="module")
def real_pair():
    """(JAX, port) detectors over the same narrowed tiny weights, tiled at
    256 (plan 192-px tiles at origins 0 and 64), with thresholds in the
    widest gaps of the JAX side's values over every tile both
    preprocess modes give, and room for every gated row and keeper (a
    max_det cut would fall among near-equal scores of the noise frames'
    flat pads)."""
    spec = narrowed(JZ, NAME)
    plan = JT.plan_tiles(SIZE, 2, 64, spec.max_stride)
    frames = [JLB.preprocess_api(im[:, :, ::-1], SIZE, spec.max_stride)
              for im in IMAGES]
    frames += [JLB.preprocess_standard(im, SIZE, spec.max_stride,
                                       auto=False) for im in IMAGES]
    tiles = np.concatenate([JT.extract_tiles(f, plan) for f in frames])
    conf, iou, cap = safe_settings(spec, shared_variables(NAME), tiles,
                                   None)
    kw = dict(img_sizes=(SIZE,), conf_thres=conf, iou_thres=iou,
              max_candidates=cap, max_det=cap, tile_top_scale=2,
              tile_halo=64,
              tile_min_size=SIZE)
    return (JFaceDetector(spec, variables=shared_variables(NAME), **kw),
            TFaceDetector(narrowed(TZ, NAME),
                          variables=shared_variables(NAME), device="cpu",
                          **kw))


def assert_rows_pair_up(got, want, box_tol):
    """Same rows up to order, paired one to one by the least total
    max |diff| over box and score (rows that the inverse letterbox clips
    to one box differ only in their near-equal scores, so a nearest-row
    pairing could pair two with one): boxes within `box_tol` (1 px where
    both sides .round() them), every other column within ROW_TOL."""
    assert got.shape == want.shape, (got.shape, want.shape)
    dist = np.abs(got[:, None, :5] - want[None, :, :5]).max(-1)
    rows, cols = linear_sum_assignment(dist)
    got, want = got[rows], want[cols]
    np.testing.assert_allclose(got[:, :4], want[:, :4], **box_tol)
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], **ROW_TOL)


@pytest.mark.parametrize("api", [False, True], ids=["standard", "api"])
def test_real_net_tiled_batch_entry_points_match_jax(real_pair, api):
    jdet, tdet = real_pair
    for det in real_pair:
        det.use_api_preprocess = api
        assert det._tile_plan(SIZE) is not None
    before = [d.truncation_report()["images"] for d in real_pair]
    want = jdet.detect_multi_scale_batch(IMAGES)
    got = tdet.detect_multi_scale_batch(IMAGES)
    for g, w in zip(got, want):
        assert g.shape[1] == 7 and len(g) > 0
        assert_rows_pair_up(g, np.asarray(w), dict(rtol=0, atol=1))
        np.testing.assert_array_equal(g[:, 5:], np.asarray(w)[:, 5:])
    want = jdet.detect_batch(IMAGES, SIZE)
    got = tdet.detect_batch(IMAGES, SIZE)
    for g, w in zip(got, want):
        assert g.shape[1] == 6 + 15 and len(g) > 0
        assert_rows_pair_up(g, np.asarray(w), ROW_TOL)
    after = [d.truncation_report()["images"] for d in real_pair]
    assert after[1] - before[1] == after[0] - before[0] == 2 * len(IMAGES)
