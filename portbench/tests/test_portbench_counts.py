"""The yardstick's counts pinned to the figures the repository's records
hold: the forward FLOPs of the two models, the fused group bound of a w6
b8@640 forward, and the keep-mask bound."""

import json
from pathlib import Path

import pytest
import torch

from face_detection_multi_scale_tpu_torch.models import fused as FU
from face_detection_multi_scale_tpu_torch.models import zoo
from face_detection_multi_scale_tpu_torch.models.model import YoloFace

from portbench import counts

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.bf16-fused.json").read_text())


@pytest.mark.parametrize("name, hw, gflop", [
    ("yolov7-w6-face", (640, 640), 102.1),
    ("yolov7-w6-face", (384, 640), 61.3),
    ("yolov7-w6-face", (512, 640), 81.7),
    ("yolov7-w6-face", (2176, 3840), 2082.8),
    ("yolov7-tiny-face", (640, 640), 16.5),
])
def test_forward_flops(name, hw, gflop):
    assert round(counts.forward_flops(config(name), 1, hw) / 1e9, 1) == gflop
    assert counts.forward_flops(config(name), 8, hw) == pytest.approx(
        8 * counts.forward_flops(config(name), 1, hw))


def test_group_bound_of_a_w6_b8_forward(monkeypatch):
    """The 11 fused groups of a w6 b8@640 bf16 forward, their shapes
    captured on the meta device: 0.4533 ms at 989 TFLOP/s, each group
    bound by its operations."""
    spec = zoo.get_spec("yolov7-w6-face")
    calls = []

    def capture(x, weights, shape):
        out = torch.empty((x.shape[0], shape.cout,
                           x.shape[2] // (2 if shape.has_pre else 1),
                           x.shape[3] // (2 if shape.has_pre else 1)),
                          dtype=x.dtype, device=x.device)
        calls.append(counts.group_bound_s(
            x.shape, x.element_size(),
            [(w.shape, w.element_size()) for w in weights], out.shape))
        return out

    monkeypatch.setattr(FU, "fused_elan", capture)
    with torch.device("meta"):
        model = YoloFace(spec).to(torch.bfloat16)
        blocks = FU.find_elan_blocks(spec)
        weights = FU.elan_weights(model, blocks, torch.bfloat16,
                                  torch.device("meta"))
        FU.fused_apply(model, torch.zeros(8, 640, 640, 3,
                                          dtype=torch.bfloat16),
                       blocks, weights)
    assert len(calls) == 11
    assert round(sum(c[0] for c in calls) * 1e3, 4) == 0.4533
    for bound, flops, _ in calls:
        assert bound == flops / counts.BF16_FLOPS


def test_keep_bound():
    """Every candidate valid and kept at w6 b8, K = 4096: all pairs'
    operations, 0.01202 ms; none kept: the bytes, 0.176 us."""
    keep = torch.ones(8, 4096, dtype=torch.bool)
    assert round(counts.keep_bound_s(keep, keep) * 1e3, 5) == 0.01202
    none = torch.zeros_like(keep)
    assert counts.keep_bound_s(none, keep) == pytest.approx(
        8 * 4096 * 18 / counts.HBM_BYTES_PER_S)
