"""The harness driven on the CPU at small sizes, past its look for a chip:
a sound run comes out correct under each cell's limits, and a run with the
timed path broken underneath comes out not correct, once for each fault a
serving cell can have (half of the batch left out; an answer altered where
it is produced; a keep mask that suppresses nothing, or is inverted).
The control, the reference with its convolutions in float8, at the cell's
own size on the card (marked `gpu`), and at a small size here.
"""

import copy

import pytest
import torch

from face_detection_multi_scale_tpu_torch.infer.detector import FaceDetector
from face_detection_multi_scale_tpu_torch.ops import nms as NMS

from portbench import compare, harness
from portbench.calibrate import control_numbers, limits_from
from portbench.run import run_once

MANIFEST = harness.load_json(harness.ROOT.parent / "BENCHMARK.json")
TINY = "configs/yolov7-tiny-face.bf16-fused.json"

# each cell at a size a CPU test holds: the tiny model, small inputs, the
# cell's own limits and route checks
SMALL = dict(batch=2, hw=[128, 160], pool=2)


def small_cell(name):
    cell = copy.deepcopy(harness.load_cell(MANIFEST, name))
    cell["cfg"] = harness.load_json(harness.ROOT / TINY)
    mix = cell["mix"]
    mix.update(SMALL)
    if mix["truncation"] == "some":
        mix.update(max_candidates=200, max_det=60)
    else:
        mix["gate"] = {"rows": 60}
    return cell


def half_batch(monkeypatch):
    """Half of the work left out: the network serves the first half of
    the batch and returns no rows for the rest."""
    real = FaceDetector.run_network

    def first_half(self, images_u8, **kw):
        dets = real(self, images_u8[: len(images_u8) // 2], **kw)
        return NMS.Detections(*(torch.cat([t, torch.zeros_like(t)])
                                for t in dets))

    monkeypatch.setattr(FaceDetector, "run_network", first_half)


def altered_answer(monkeypatch):
    """One served row altered where the postprocess produces it: its box
    moved 40 px."""
    real = FaceDetector.postprocess

    def moved(self, preds):
        dets = real(self, preds)
        boxes = dets.boxes.clone()
        boxes[0, 0] += 40.0
        return dets._replace(boxes=boxes)

    monkeypatch.setattr(FaceDetector, "postprocess", moved)


def keep_all_valid(monkeypatch):
    """The keep mask suppresses nothing: every valid candidate is kept."""
    monkeypatch.setattr(NMS, "nms_keep",
                        lambda boxes, valid, iou_thres, **kw: valid.clone())


def keep_inverted(monkeypatch):
    """The keep mask inverted: the valid candidates it suppressed are kept
    and its keepers dropped."""
    real = NMS.nms_keep

    def inverted(boxes, valid, iou_thres, **kw):
        return valid & ~real(boxes, valid, iou_thres, **kw)

    monkeypatch.setattr(NMS, "nms_keep", inverted)


FAULTS = {"half_batch": half_batch, "altered_answer": altered_answer,
          "keep_all_valid": keep_all_valid,
          "keep_inverted": keep_inverted}
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res, faults = run_once(MANIFEST, small_cell(name), 2 ** 31 + 21, 0.5,
                           False, "cpu")
    assert not faults
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    cell = small_cell(name)
    FAULTS[fault](monkeypatch)
    res, _ = run_once(MANIFEST, cell, 2 ** 31 + 22, 0.5, False, "cpu")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_the_program_here(name):
    """At a CPU size the float8 control reads above the program on every
    number the cell compares with a tolerance (the limits come from the
    card's readings; an exact comparison, limit 0, reads 0 on both)."""
    cell = small_cell(name)
    prog, _ = run_once(MANIFEST, cell, 31, 0.5, False, "cpu")
    ctrl = control_numbers(cell, 31, "cpu")
    for k, c in prog["checks"].items():
        if c["limit"]:
            assert ctrl[k] > c["value"], (k, ctrl[k], c["value"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name):
    """The control at the cell's own size on three seeds: not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell(MANIFEST, name)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        numbers = control_numbers(cell, seed, "cuda")
        correct, checks = compare.limit_checks(numbers, cell["limits"])
        assert not correct, (seed, checks)


def test_limits_sit_between_the_readings():
    """A number is held only where the control reads three times the
    program or more, at a limit between the two readings."""
    lines = [{"mode": "program", "numbers": {"conf_gap": 1e-3,
                                             "box_rel_gap": 1e-2,
                                             "keep_gap": 0.0}},
             {"mode": "program", "numbers": {"conf_gap": 2e-3,
                                             "box_rel_gap": 1e-2,
                                             "keep_gap": 0.0}},
             {"mode": "control", "numbers": {"conf_gap": 2e-2,
                                             "box_rel_gap": 2e-2,
                                             "keep_gap": 0.2}}]
    lim = limits_from(lines)
    assert set(lim) == {"conf_gap", "keep_gap", "keep_overlaps",
                        "empty_answers"}
    assert 2e-3 < lim["conf_gap"]["limit"] < 2e-2
    assert 0 < lim["keep_gap"]["limit"] < 0.2
    assert lim["empty_answers"]["limit"] == lim["keep_overlaps"]["limit"] == 0


def test_a_load_off_the_cell_is_a_fault(monkeypatch):
    """A program gated at half the cell's conf_thres serves another load
    than the cell states: the run reports it and is not correct."""
    real = harness.Run.build_program

    def half_gate(self):
        self.gate /= 2
        real(self)

    monkeypatch.setattr(harness.Run, "build_program", half_gate)
    res, faults = run_once(MANIFEST, small_cell("w6-bulk-b32-640"),
                           2 ** 31 + 23, 0.5, False, "cpu")
    assert any(f.startswith("gated rows") for f in faults), faults
    assert not res["correct"]
