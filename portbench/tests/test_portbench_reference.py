"""The benchmark's plain reference against the port's own plain paths, on
the CPU at small sizes: the frozen layer tables, the forward and decode,
the postprocess, and the seeded weights' measured BN statistics."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu_torch.infer.detector import FaceDetector
from face_detection_multi_scale_tpu_torch.models import zoo
from face_detection_multi_scale_tpu_torch.models.model import YoloFace
from face_detection_multi_scale_tpu_torch.ops import nms as NMS

from portbench import inputs
from portbench.reference import model as RM
from portbench.reference import postprocess as RP

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
MODELS = ["yolov7-w6-face", "yolov7-tiny-face"]


def config(name):
    return json.loads((CONFIGS / f"{name}.bf16-fused.json").read_text())


@pytest.mark.parametrize("name", MODELS)
def test_layer_table_is_the_zoo_spec(name):
    cfg = config(name)
    spec = zoo._REGISTRY[name]()
    rows = [[list(n.f) if isinstance(n.f, tuple) else n.f, n.n, n.op,
             list(n.args)] for n in spec.nodes]
    assert cfg["layers"] == rows
    assert cfg["anchors"] == [list(a) for a in spec.anchors]
    assert cfg["strides"] == list(spec.strides)
    assert (cfg["nc"], cfg["nkpt"], cfg["dw_conv_kpt"]) == (
        spec.nc, spec.nkpt, spec.dw_conv_kpt)


@pytest.mark.parametrize("name", MODELS)
def test_state_dict_keys_match_the_port(name):
    with torch.device("meta"):
        ours = {k for k, v in RM.Reference(config(name)).state_dict().items()}
        port = set(YoloFace(zoo.get_spec(name)).state_dict())
    assert ours == port


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    name = request.param
    cfg = config(name)
    sd = inputs.make_weights(cfg, 2 ** 31 + 5, "cpu")
    det = FaceDetector(name, variables=sd, device="cpu", conf_thres=0.5)
    return cfg, det, RM.build(cfg, sd, "cpu")


def test_forward_and_decode_match_the_port(pair):
    cfg, det, ref = pair
    x = inputs.make_frames(7, 2, (128, 192, 3), "cpu")
    port = det.forward_rows(x)
    ours = RM.rows_of(ref, x)
    assert ours.shape == port.shape
    scale = ours.abs().amax(dim=(0, 1))
    assert ((ours - port).abs().amax(dim=(0, 1)) <= 1e-4 * scale + 1e-5).all()


def test_postprocess_matches_the_port(pair):
    cfg, det, ref = pair
    x = inputs.make_frames(8, 2, (128, 192, 3), "cpu")
    rows = RM.rows_of(ref, x)
    conf = (rows[..., 4] * rows[..., 5]).sort(dim=1, descending=True)[0]
    gate = float(conf[:, 60:62].mean())
    for k, max_det in ((4096, 300), (40, 12)):
        mine = RP.postprocess(rows, gate, 0.5, k, max_det)
        dets = NMS.non_max_suppression(rows, gate, 0.5, max_candidates=k,
                                       max_det=max_det)
        theirs = NMS.detections_to_numpy(dets)
        for b in range(2):
            assert mine[b]["n_gated"] == int(dets.n_gated[b])
            np.testing.assert_allclose(mine[b]["rows"], theirs[b],
                                       rtol=1e-6, atol=1e-5)


def test_bn_statistics_are_measured():
    """After `calibrate_bn`, the first conv's BN normalises its output on
    the calibration frames to mean beta and std bn_out_std x gamma."""
    cfg = config("yolov7-tiny-face")
    x = inputs.make_frames(10, 2, (96, 128, 3), "cpu")
    sd = inputs.calibrate_bn(cfg, inputs.make_weights(cfg, 11, "cpu"), x)
    conv = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2).float() / 255, sd["model.0.conv.weight"],
        stride=2, padding=1)
    y = torch.nn.functional.batch_norm(
        conv, sd["model.0.bn.running_mean"], sd["model.0.bn.running_var"],
        sd["model.0.bn.weight"], sd["model.0.bn.bias"], eps=RM.BN_EPS)
    std = cfg["seeded_weights"]["bn_out_std"]
    torch.testing.assert_close(y.mean((0, 2, 3)), sd["model.0.bn.bias"],
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(y.std((0, 2, 3)),
                               std * sd["model.0.bn.weight"], atol=0,
                               rtol=0.02)
