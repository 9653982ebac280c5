"""What each rank of tests/test_torch_spatial.py's process group runs. A
module of its own, without JAX: the ranks are spawned processes that
import it by name (parallel/mesh.run_ranks), and each would otherwise
import the test file's JAX.

OP_CASES holds single ops as data (kind, parameters): the ranks build and
run them over the grids, and the test file computes, from the same data
by brute force over receptive fields, the halo each rank must receive."""

import json
from pathlib import Path

import numpy as np
import torch
from torch import nn

from face_detection_multi_scale_tpu_torch.models import layers as L
from face_detection_multi_scale_tpu_torch.models import layers_extra as LX
from face_detection_multi_scale_tpu_torch.models import model as TM
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.models.convert import (
    jax_to_state_dict)
from face_detection_multi_scale_tpu_torch.models.spec import (
    spec_from_yolo_yaml)
from face_detection_multi_scale_tpu_torch.ops import nms as TN
from face_detection_multi_scale_tpu_torch.parallel import mesh as PM
from face_detection_multi_scale_tpu_torch.parallel import spatial as SP

GRIDS = {"2x2": 2, "1x4": 1, "4x1": 4}  # name: rows over 4 ranks
LITE_SIZE, LITE_SEED = 256, 0   # (a): lite-t's frame
W6_SIZE, W6_SEED = 192, 1       # (b), (c): the narrowed w6's frame
ZOO = {"yolov7-tiny-face": 11, "yolov7-face": 12, "yolov7s-face": 13,
       "yolov7-lite-s": 14, "yolov7s-face-extra": 15}  # (d): name: seed
ZOO_SIZE = 160
EXTRA_CFG = Path(__file__).resolve().parent / "data" / \
    "yolov7s-face-extra.json"
NMS_KW = dict(conf_thres=0.001, iou_thres=0.5, max_candidates=512,
              max_det=50)

# single ops: (name, kind, parameters, input (c, h, w)); conv parameters
# are per axis (h, w)
ODD, ODD4, EVEN = (3, 13, 11), (4, 13, 11), (4, 16, 12)
OP_CASES = [
    ("conv3", "conv", dict(k=(3, 3), s=(1, 1), p=(1, 1), d=(1, 1), g=1),
     ODD),
    ("conv3_s2", "conv", dict(k=(3, 3), s=(2, 2), p=(1, 1), d=(1, 1), g=1),
     ODD),
    ("dw5", "conv", dict(k=(5, 5), s=(1, 1), p=(2, 2), d=(1, 1), g=3), ODD),
    ("cross_k1x3_s2x1", "conv",
     dict(k=(1, 3), s=(2, 1), p=(0, 1), d=(1, 1), g=1), ODD),
    ("cross_k3x1", "conv", dict(k=(3, 1), s=(1, 1), p=(1, 0), d=(1, 1), g=1),
     ODD),
    ("dilated3", "conv", dict(k=(3, 3), s=(1, 1), p=(2, 2), d=(2, 2), g=1),
     ODD),
    ("conv1_s2", "conv", dict(k=(1, 1), s=(2, 2), p=(0, 0), d=(1, 1), g=1),
     ODD),
    ("pool3_s2", "pool", dict(k=3, s=2, p=1, ceil=False), ODD),
    ("pool2_ceil", "pool", dict(k=2, s=2, p=0, ceil=True), ODD),
    ("pool13", "pool", dict(k=13, s=1, p=6, ceil=False), ODD),
    ("upsample", "repeat", dict(g=2, fn="upsample"), ODD),
    ("zero_pad", "pad", dict(pads=(1, 2, 0, 3)), ODD),
    ("reorg", "fold", dict(g=2, fn="reorg"), EVEN),
    ("focus", "fold", dict(g=2, fn="focus"), EVEN),
    ("contract", "fold", dict(g=2, fn="contract"), EVEN),
    ("expand", "repeat", dict(g=2, fn="expand"), ODD4),
    ("meta_acon", "global", dict(), EVEN),
]


class FnModule(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def op_module(kind, prm, c):
    """The op of OP_CASES as a module, weights from seed 0."""
    torch.manual_seed(0)
    if kind == "conv":
        return L.Conv2d(c, 6, prm["k"], prm["s"], prm["p"], prm["d"],
                        groups=prm["g"])
    if kind == "pool":
        return FnModule(lambda x: L.max_pool(x, prm["k"], prm["s"],
                                             prm["p"], prm["ceil"]))
    if kind == "pad":
        return FnModule(lambda x: L.zero_pad(x, prm["pads"]))
    if kind == "global":
        return LX.MetaAconC(c, r=2)
    fn = {"upsample": L.upsample2x_nearest, "reorg": L.reorg,
          "focus": L.focus_fold,
          "contract": lambda x: LX.contract(x, prm["g"]),
          "expand": lambda x: LX.expand(x, prm["g"])}[prm["fn"]]
    return FnModule(fn)


def op_input(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, *shape)).astype(np.float32))


@torch.no_grad()
def run_op(name, mesh):
    """An op of OP_CASES over this rank's block, gathered: (the whole
    output, exchanges, halo bytes)."""
    _, kind, prm, shape = next(c for c in OP_CASES if c[0] == name)
    mod = op_module(kind, prm, shape[0]).eval()
    x = op_input(shape)
    (hs, ws) = PM.spatial_input_sharding(mesh).slices(*shape[1:])
    outs, shapes, run = SP.run_blocks(mod, x[:, :, hs, ws], tuple(x.shape),
                                      mesh)
    whole = PM.gather_blocks(mesh, outs, shapes, [
        (slice(None), slice(None), *run.slices(*s[2:])) for s in shapes])
    return whole[0].numpy(), run.exchanges, run.halo_bytes


def lite_spec():
    return TZ.get_spec("yolov7-lite-t").resolve()


def zoo_spec(name):
    """(d)'s spec of `name`, narrowed."""
    return extra_spec() if name.endswith("extra") else narrowed(name)


def narrowed(name, width=0.25):
    spec = TZ.get_spec(name)
    spec.width_multiple = width
    spec._resolved = False
    return spec.resolve()


def extra_spec(width=0.25):
    spec = spec_from_yolo_yaml(json.loads(EXTRA_CFG.read_text()),
                               "yolov7s-face-extra")
    spec.width_multiple = width
    spec._resolved = False
    return spec.resolve()  # its head is P3-P5: the parser's strides


def seeded_model(spec, seed):
    """The port model of `spec` from `seed`'s init, in eval mode."""
    return TM.init_weights(TM.YoloFace(spec),
                           torch.Generator().manual_seed(seed)).eval()


def bridged_model(spec, variables):
    net = TM.YoloFace(spec)
    net.load_state_dict(jax_to_state_dict(variables))
    return net.eval()


def images(size, seed):
    return np.random.default_rng(seed).integers(0, 256, (1, size, size, 3),
                                                np.uint8)


def post(preds):
    return TN.non_max_suppression(preds, nc=1, **NMS_KW)


def rank_main(box):
    """The cases without JAX variables first, then those that take them
    from `box` (lite-t and the narrowed w6). Everything else a rank makes
    from the constants above: arguments larger than a pipe's buffer
    would hold each spawned rank's start until the one before it had
    imported this module."""
    torch.set_num_threads(1)
    grids = {g: PM.make_spatial_mesh(rows=rows) for g, rows in GRIDS.items()}
    out = {"coords": {g: m.coords for g, m in grids.items()},
           "shapes": {g: m.shape for g, m in grids.items()},
           "neighbours": grids["2x2"].neighbours}

    def infer(net, x, grid, **kw):
        before = PM.spatial_infer.exchanges
        got = PM.spatial_infer(net, x, grids[grid], **kw)
        return got, PM.spatial_infer.exchanges - before

    # the single ops, every grid
    out["ops"] = {(name, grid): run_op(name, grids[grid])
                  for name, *_ in OP_CASES for grid in GRIDS}
    # (d) the other zoo models and the extra cfg over (2, 2)
    out["zoo"] = {}
    for name, seed in ZOO.items():
        net = seeded_model(zoo_spec(name), seed)
        out["zoo"][name] = infer(net, images(ZOO_SIZE, seed),
                                 "2x2")[0].numpy()
    # (f) a module without a spatial form raises before any exchange
    lite_x = images(LITE_SIZE, LITE_SEED)
    out["unknown"] = {}
    for case, swap in (("torch_maxpool", _swap_node),
                       ("torch_conv", _swap_conv)):
        net = seeded_model(lite_spec(), 0)
        swap(net)
        try:
            infer(net, lite_x, "2x2")
            out["unknown"][case] = None
        except NotImplementedError as e:
            out["unknown"][case] = str(e)
    variables = box.get(timeout=120.0)
    # (a) lite-t at 256 px over (2, 2)
    lite = bridged_model(lite_spec(), variables["lite_vars"])
    out["lite"] = infer(lite, lite_x, "2x2")[0].numpy()
    # (b) w6 narrowed at 192 px over (2, 2) and (1, 4); (c) with the NMS
    w6 = bridged_model(narrowed("yolov7-w6-face"), variables["w6_vars"])
    w6_x = images(W6_SIZE, W6_SEED)
    out["w6"], out["w6_nms"] = {}, {}
    for grid in ("2x2", "1x4"):
        rows, n = infer(w6, w6_x, grid)
        out["w6"][grid] = (rows.numpy(), n)
        dets = infer(w6, w6_x, grid, postprocess=post)[0]
        out["w6_nms"][grid] = [t.numpy() for t in dets]
    out["calls"] = PM.spatial_infer.calls
    return out


def _swap_node(net):
    net.model[1] = nn.MaxPool2d(3, 1, 1)


def _swap_conv(net):
    conv = net.model[0].stem_1.conv
    net.model[0].stem_1.conv = nn.Conv2d(
        conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride,
        conv.padding, bias=False)
