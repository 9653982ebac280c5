"""The port's `.pt2` export (export_model.py) against its own live pipeline
and the JAX package's, on the CPU, with the same weights: a numpy-seeded
JAX variables tree (test_torch_model.random_variables) carried into the
port by the bridge.

- The round trip with the postprocess fused in (export_program, save,
  load_program), yolov7-lite-t at 64 px: `valid` exact and the kept
  boxes within atol 1e-4 of the port's live pipeline, as the JAX suite
  holds its StableHLO round trip (tests/test_export.py); every field
  exact in fact, since the program runs the live ops. Against the JAX
  live pipeline on the same weights, as tests/test_torch_detector.py
  holds the two detectors: thresholds in the widest gaps of the JAX
  rows, so ulp-level forward differences flip no decision; then the same
  kept counts and rows within the decoded-row tolerance (atol 5e-3 /
  rtol 1e-3).
- The program holds exactly one `fdms_torch.nms_keep` node, and on the
  CPU its op runs the plain version: `nms_keep.launches` does not move.
- Raw heads against the JAX package's own StableHLO raw-heads artifact
  (which runs the unfolded `model.apply`): shapes equal, values within
  the raw-map tolerance (atol 2e-4 / rtol 1e-3, tests/test_torch_model.
  py); the sidecars' keys equal.
- bf16: the implicit priors stay float32 in the program, every other
  weight is bf16, and its outputs equal the live bf16 pipeline's.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu import export_model as JEM
from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.models.fuse import fold_bn as j_fold_bn
from face_detection_multi_scale_tpu.models.head import decode as j_decode
from face_detection_multi_scale_tpu.ops import nms as JN
from face_detection_multi_scale_tpu_torch import export_model as EM
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.models.head import decode
from face_detection_multi_scale_tpu_torch.ops import nms as TN
from face_detection_multi_scale_tpu_torch.ops import nms_kernel as K

from test_torch_detector import assert_rows_match, settings_for_rows
from test_torch_model import port_model, random_variables

NAME, SIZE, BATCH, MAX_DET = "yolov7-lite-t", 64, 2, 300
RAW_TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def case():
    """(JAX spec, variables, port spec, port model, frames, JAX decoded
    rows, the JAX model) of lite-t at 64 px."""
    jspec = JZ.get_spec(NAME).resolve()
    variables = random_variables(jspec, seed=7)
    tspec = TZ.get_spec(NAME).resolve()
    net = port_model(tspec, variables)
    frames = np.random.default_rng(0).integers(
        0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    jmodel = JM.YoloFace(spec=jspec)
    rows = np.asarray(jax.jit(lambda v, x: j_decode(jmodel.apply(
        v, x, train=False), jspec))(
            j_fold_bn(variables), frames.astype(np.float32) / 255.0))
    return jspec, variables, tspec, net, frames, rows, jmodel


@pytest.fixture(scope="module")
def postprocess_program(case, tmp_path_factory):
    """The lite-t program with the postprocess, saved and loaded back, at
    thresholds in the widest gaps of the JAX rows."""
    _, _, tspec, net, _, rows, _ = case
    conf, iou, _ = settings_for_rows(rows, None)
    path = str(tmp_path_factory.mktemp("pt2") / "m.pt2")
    EM.export_program(net, tspec, path, img_size=SIZE, batch=BATCH,
                      conf_thres=conf, iou_thres=iou, max_det=MAX_DET,
                      device="cpu")
    return EM.load_program(path), path, conf, iou


def test_round_trip_matches_the_live_pipeline(case, postprocess_program):
    _, _, tspec, net, frames, _, _ = case
    prog, path, conf, iou = postprocess_program
    assert prog.meta["max_det"] == MAX_DET and prog.meta["img_size"] == SIZE
    boxes, scores, classes, extras, valid = prog(frames)
    k = min(2048, rows_of(tspec))
    assert boxes.shape == (BATCH, min(MAX_DET, k), 4)
    assert extras.shape == (BATCH, min(MAX_DET, k), 15)
    live = EM.serving_model(net)
    with torch.no_grad():
        want = TN.non_max_suppression(
            decode(live(torch.from_numpy(frames).float() / 255.0), tspec),
            conf, iou, max_candidates=2048, max_det=MAX_DET)
    assert torch.equal(valid, want.valid) and int(valid.sum()) > 0
    np.testing.assert_allclose(boxes[valid].numpy(),
                               want.boxes[want.valid].numpy(), atol=1e-4)
    for got, w in zip((boxes, scores, classes, extras), want[:4]):
        assert torch.equal(got, w)


def rows_of(spec) -> int:
    return sum(spec.na * (SIZE // s) ** 2 for s in spec.strides)


def test_round_trip_matches_the_jax_live_pipeline(case,
                                                   postprocess_program):
    jspec, variables, _, _, frames, rows, _ = case
    prog, _, conf, iou = postprocess_program
    got = TN.detections_to_numpy(TN.Detections(*prog(frames)))
    nms = jax.jit(functools.partial(
        JN.non_max_suppression, conf_thres=conf, iou_thres=iou, nc=1,
        nkpt=5, max_candidates=2048, max_det=MAX_DET, backend="xla"))
    want = JN.detections_to_numpy(nms(rows))
    for g, w in zip(got, want):
        assert len(g) > 0
        assert_rows_match(g, np.asarray(w))


def test_program_holds_one_nms_keep_op_and_counts_nothing_on_the_cpu(
        case, postprocess_program):
    _, _, _, _, frames, _, _ = case
    prog = postprocess_program[0]
    assert EM.op_count(prog.exported, "fdms_torch.nms_keep") == 1
    assert EM.op_count(prog.exported, "fdms_torch.qconv") == 0
    before = (K.nms_keep.launches, K.nms_keep.fixpoint_launches)
    prog(frames)
    assert (K.nms_keep.launches, K.nms_keep.fixpoint_launches) == before


def test_raw_heads_match_the_jax_artifact(case, tmp_path):
    """The port's raw-heads program against the JAX package's raw-heads
    StableHLO artifact of the same weights, and the two sidecars."""
    jspec, variables, tspec, net, frames, _, jmodel = case
    jpath = str(tmp_path / "raw.stablehlo")
    JEM.export_stablehlo(jmodel, variables, jspec, jpath, img_size=SIZE,
                         batch=BATCH, raw_heads=True)
    want = JEM.load_stablehlo(jpath)(frames)
    path = str(tmp_path / "raw.pt2")
    EM.export_program(net, tspec, path, img_size=SIZE, batch=BATCH,
                      raw_heads=True, device="cpu")
    got = EM.load_program(path)(frames)
    assert len(got) == len(want) == tspec.nl
    assert got[0].shape == (BATCH, 3, 8, 8, 21)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **RAW_TOL)
    jmeta, meta = (json.load(open(p + ".json")) for p in (jpath, path))
    assert list(meta) == list(jmeta)
    assert meta == jmeta


def test_bf16_program_keeps_the_priors_float32(case):
    _, _, tspec, net, frames, rows, _ = case
    conf, iou, _ = settings_for_rows(rows, None)
    ep = EM.trace_program(net, tspec, img_size=SIZE, batch=BATCH,
                          conf_thres=conf, iou_thres=iou, max_det=MAX_DET,
                          dtype=torch.bfloat16, device="cpu")
    dtypes = {k: v.dtype for k, v in ep.state_dict.items()}
    priors = {k for k in dtypes if k.endswith(".implicit")}
    assert priors and all(dtypes[k] == torch.float32 for k in priors)
    assert {dtypes[k] for k in dtypes if k not in priors} == \
        {torch.bfloat16}
    got = EM.Program(ep)(frames)
    live = EM.serving_model(net, torch.bfloat16)
    with torch.no_grad():
        want = TN.non_max_suppression(
            decode(live(torch.from_numpy(frames).to(torch.bfloat16)
                        / 255.0), tspec),
            conf, iou, max_candidates=2048, max_det=MAX_DET)
    assert int(want.valid.sum()) > 0
    for g, w in zip(got, want[:5]):
        assert g.dtype == w.dtype and torch.equal(g, w)
