"""The port's other four zoo models (yolov7-face, yolov7s-face,
yolov7-lite-t, yolov7-lite-s), the blocks they and the cfg format use, the
cfg parser, `compute_strides`, the fused path on their E-ELAN groups and
the hub entry points, against the JAX package on the CPU: the same
numpy-seeded inputs and weights (a JAX variables tree carried into the
port by the weight bridge).

Tolerances are the JAX suite's, as in tests/test_torch_model.py and
tests/test_torch_bf16.py: raw maps atol 2e-4 / rtol 1e-3 and decoded rows
atol 5e-3 / rtol 1e-3 in float32 (tests/test_model_parity.py); a block's
output atol 2e-4 / rtol 1e-3; bf16 raws within 2e-2 of max |JAX float32
raw| per level (a bf16 network against a bf16 network rounds at other
points in every layer); fused raws at the raw-map tolerance."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from face_detection_multi_scale_tpu import hub as JH
from face_detection_multi_scale_tpu.models import fused as JF
from face_detection_multi_scale_tpu.models import layers as JL
from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import spec as JS
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.models.fuse import fold_bn as j_fold_bn
from face_detection_multi_scale_tpu.models.head import decode as j_decode
from face_detection_multi_scale_tpu.ops import nms as JN
from face_detection_multi_scale_tpu_torch import hub as TH
from face_detection_multi_scale_tpu_torch.models import fused as TF
from face_detection_multi_scale_tpu_torch.models import layers as TL
from face_detection_multi_scale_tpu_torch.models import model as TM
from face_detection_multi_scale_tpu_torch.models import spec as TS
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.models.convert import (
    jax_to_state_dict, load_reference_state_dict)
from face_detection_multi_scale_tpu_torch.models.fuse import fold_bn
from face_detection_multi_scale_tpu_torch.models.head import decode
from face_detection_multi_scale_tpu_torch.ops import nms as TN
from face_detection_multi_scale_tpu_torch.utils import downloads as TD

from test_torch_detector import assert_rows_match, widest_gap
from test_torch_model import RAW_TOL, ROW_TOL, images
from torch_shared import release_redirect

RAW_REL = 2e-2
NEW_MODELS = ["yolov7-face", "yolov7s-face", "yolov7-lite-t",
              "yolov7-lite-s"]


def fill(tree, seed):
    """A JAX variables tree of the shapes of `tree`, filled from a numpy
    seed as tests/test_torch_model.random_variables fills a model's:
    lecun-scaled kernels, non-trivial BN statistics (so the fold has
    work), implicit priors near 0 and 1."""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "implicit":
            v = rng.normal(0, 0.02, shape) + path[-2].key.startswith("im_")
        else:  # bias, mean
            v = rng.normal(0, 0.1, shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, dict(tree))


def model_variables(spec, seed):
    abstract = jax.eval_shape(
        functools.partial(JM.YoloFace(spec=spec).init, train=False),
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    return fill(abstract, seed)


def narrow(zoo, name, width=0.25, depth=0.33):
    """A zoo spec at `width`; depth 0.33 turns the lite models' repeats
    (2, 3, 5, 7) into 1 and 2, so repeated and single nodes both run."""
    spec = zoo.get_spec(name)
    spec.width_multiple, spec.depth_multiple = width, depth
    spec._resolved = False
    return spec.resolve()


# ---------------------------------------------------------------------------
# a custom cfg: C3, BottleneckCSP, Focus, SPP, ZeroPad2d, MaxPool2d, a plain
# Detect head, repeats as constructor args
# ---------------------------------------------------------------------------

ANCHORS = [[4, 5, 6, 8, 10, 12], [15, 19, 23, 30, 39, 52]]
CUSTOM_CFG = {
    "nc": 1, "nkpt": 5, "depth_multiple": 0.67, "width_multiple": 0.25,
    "anchors": ANCHORS,
    "backbone": [
        [-1, 1, "Focus", [64, 3]],                     # 0  /2
        [-1, 1, "Conv", [128, 3, 2]],                  # 1  /4
        [-1, 3, "C3", [128]],                          # 2
        [-1, 1, "Conv", [256, 3, 2]],                  # 3  /8
        [-1, 3, "BottleneckCSP", [256]],               # 4
        [-1, 1, "Conv", [512, 3, 2]],                  # 5  /16
        [-1, 1, "SPP", [512, [5, 9, 13]]],             # 6
        [-1, 1, "nn.ZeroPad2d", [[0, 1, 0, 1]]],       # 7
        [-1, 1, "nn.MaxPool2d", [2, 1, 0]],            # 8
    ],
    "head": [
        [-1, 1, "Conv", [256, 1, 1, None, 1, "nn.LeakyReLU(0.1)"]],  # 9
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],  # 10 /8
        [[-1, 4], 1, "Concat", [1]],                   # 11
        [-1, 1, "C3", [256, False]],                   # 12
        [-1, 1, "Bottleneck", [256]],                  # 13
        [[13, 9], 1, "Detect", ["nc", "anchors"]],     # 14
    ],
}
# the same with its head on P4/P5: the parser's default strides (8, 16)
# are wrong, compute_strides finds (16, 32)
P45_CFG = dict(CUSTOM_CFG, backbone=CUSTOM_CFG["backbone"] + [
    [-1, 1, "Conv", [512, 3, 2]],                      # 9  /32
], head=[
    [-1, 1, "Conv", [256, 1, 1]],                      # 10
    [[8, -1], 1, "Detect", ["nc", "anchors"]],         # 11 (/16, /32)
])


def zoo_cfg(spec):
    """The reference-format cfg dict of a zoo spec, as a user's yaml
    holds it: relative `from` where the first node has one, module names
    as the reference writes them."""
    rows = []
    for node in spec.nodes:
        name = {"Upsample": "nn.Upsample", "MaxPool2d": "nn.MaxPool2d",
                "ZeroPad2d": "nn.ZeroPad2d"}.get(node.op, node.op)
        args = list(node.args)
        if node.op == "Upsample":
            args = [None, 2, "nearest"]
        elif node.op in ("Detect", "IDetect", "IKeypoint"):
            args = ["nc", "anchors"]
        f = list(node.f) if isinstance(node.f, tuple) else node.f
        rows.append([f, node.n, name, args])
    return {"nc": spec.nc, "nkpt": spec.nkpt,
            "depth_multiple": spec.depth_multiple,
            "width_multiple": spec.width_multiple,
            "dw_conv_kpt": spec.dw_conv_kpt,
            "anchors": [list(a) for a in spec.anchors],
            "backbone": rows[:10], "head": rows[10:]}


def specs(name):
    """(JAX spec, port spec) of a narrowed new zoo model, or of the custom
    Detect cfg ("custom")."""
    if name == "custom":
        return (JS.spec_from_yolo_yaml(CUSTOM_CFG, "custom"),
                TS.spec_from_yolo_yaml(CUSTOM_CFG, "custom"))
    return narrow(JZ, name), narrow(TZ, name)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

BLOCKS = {  # name: (JAX module, port module, NHWC input shape)
    "SPF": (lambda: JL.SPF(5), lambda: TL.SPF(5), (2, 12, 10, 8)),
    "SPPF": (lambda: JL.SPPF(8, 16, 5), lambda: TL.SPPF(8, 16, 5),
             (2, 12, 10, 8)),
    "SPPFCSPC": (lambda: JL.SPPFCSPC(16), lambda: TL.SPPFCSPC(8, 16),
                 (2, 12, 10, 8)),
    "SPP": (lambda: JL.SPP(8, 16, (5, 9, 13)),
            lambda: TL.SPP(8, 16, (5, 9, 13)), (2, 12, 10, 8)),
    # odd sides: the stem's ceil-mode pool emits the partial last window
    "StemBlock": (lambda: JL.StemBlock(16, 3, 2),
                  lambda: TL.StemBlock(3, 16, 3, 2), (2, 13, 11, 3)),
    "DWConvblock": (lambda: JL.DWConvblock(8, 16, 3, 2),
                    lambda: TL.DWConvblock(8, 16, 3, 2), (2, 12, 10, 8)),
    "ShuffleBlock-s2": (lambda: JL.ShuffleBlock(8, 16, 2),
                        lambda: TL.ShuffleBlock(8, 16, 2), (2, 12, 10, 8)),
    "ShuffleBlock-s1": (lambda: JL.ShuffleBlock(16, 16, 1),
                        lambda: TL.ShuffleBlock(16, 16, 1), (2, 12, 10, 16)),
    "ConvBnReluMaxpool": (lambda: JL.ConvBnReluMaxpool(16),
                          lambda: TL.ConvBnReluMaxpool(8, 16),
                          (2, 13, 10, 8)),
    "Bottleneck": (lambda: JL.Bottleneck(8, 8, True, act="leaky"),
                   lambda: TL.Bottleneck(8, 8, True, act="leaky"),
                   (2, 12, 10, 8)),
    "C3": (lambda: JL.C3(8, 16, 2), lambda: TL.C3(8, 16, 2),
           (2, 12, 10, 8)),
    "BottleneckCSP": (lambda: JL.BottleneckCSP(8, 16, 2),
                      lambda: TL.BottleneckCSP(8, 16, 2), (2, 12, 10, 8)),
    "Focus": (lambda: JL.Focus(16, 3), lambda: TL.Focus(8, 16, 3),
              (2, 12, 10, 8)),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name):
    """Each new block on the same input and weights, unfolded and folded
    (the JAX fold of the variables, the port's fold of the module): its
    state dict's keys are exactly the bridge's, the output within the
    raw-map tolerance."""
    j_ctor, t_ctor, shape = BLOCKS[name]
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jmod, tmod = j_ctor(), t_ctor().eval()
    variables = fill(jax.eval_shape(
        functools.partial(jmod.init, train=False), jax.random.PRNGKey(0),
        jnp.asarray(x)), seed=2)
    if variables:
        state = jax_to_state_dict(variables)
        assert sorted(state) == sorted(tmod.state_dict())
        tmod.load_state_dict(state)
    for fold in (False, True):
        jv = j_fold_bn(variables) if fold and variables else variables
        if fold:
            fold_bn(tmod)
        want = np.asarray(jmod.apply(jv, jnp.asarray(x), train=False))
        with torch.no_grad():
            got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **RAW_TOL,
                                   err_msg=f"fold={fold}")


@pytest.mark.parametrize("fn,args", [
    ("channel_shuffle", (2,)), ("max_pool", (2, 2, 0, True)),
    ("max_pool", (3, 2, 1, True)), ("max_pool", (3, 2, 0, False))])
def test_functions_match_jax(fn, args):
    """channel_shuffle's channel order and max_pool with ceil_mode, bit
    for bit on odd sides."""
    x = np.random.default_rng(3).standard_normal((2, 13, 11, 6)).astype(
        np.float32)
    want = np.asarray(getattr(JL, fn)(jnp.asarray(x), *args))
    got = getattr(TL, fn)(torch.from_numpy(x).permute(0, 3, 1, 2), *args)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("alpha", [(1,), ()])
def test_stateless_new_ops_match_jax(alpha):
    """ADD with its alpha from the node's args (the lite cfgs pass 1; 0.5
    without one), ZeroPad2d's (left, right, top, bottom), MaxPool2d."""
    from face_detection_multi_scale_tpu.models.spec import Node
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal((2, 7, 9, 5)).astype(np.float32)
            for _ in range(2))
    t = [torch.from_numpy(v).permute(0, 3, 1, 2) for v in (a, b)]
    for op, args, j_in, t_in in (
            ("ADD", alpha, [jnp.asarray(a), jnp.asarray(b)], t),
            ("ZeroPad2d", ((1, 2, 0, 3),), jnp.asarray(a), t[0]),
            ("MaxPool2d", (3, 2, 1), jnp.asarray(a), t[0]),
            ("MaxPool2d", (2,), jnp.asarray(a), t[0])):
        want = np.asarray(JM.apply_stateless_op(op, Node(-1, 1, op, args),
                                                j_in))
        got = TM.apply_stateless_op(op, args, t_in)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      want, err_msg=op)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_forwards(name):
    """Jitted JAX float32 and bf16 forwards of a narrowed model."""
    spec, _ = specs(name)
    return (jax.jit(functools.partial(JM.YoloFace(spec=spec).apply,
                                      train=False)),
            jax.jit(functools.partial(
                JM.YoloFace(spec=spec, dtype=jnp.bfloat16).apply,
                train=False)))


def port_net(spec, variables, fold):
    net = TM.YoloFace(spec)
    net.load_state_dict(jax_to_state_dict(variables))
    if fold:
        fold_bn(net)
    return net.eval()


@pytest.mark.parametrize("name", NEW_MODELS + ["custom"])
def test_model_matches_jax(name):
    """Unfolded and folded float32 raws (bs, na, ny, nx, no) and decoded
    rows, and the folded model in bf16 (models/model.cast_model) against
    JAX YoloFace(dtype=bfloat16): per level within RAW_REL of max |JAX
    float32 raw|. The lite and yolov7-face heads are IKeypoint, so their
    bf16 raws are float32 on both sides; the custom cfg's plain Detect
    head gives bf16 raws and rows on both."""
    spec_j, spec_t = specs(name)
    variables = model_variables(spec_j, seed=5)
    x = images(2, 96, seed=6)
    f32, bf16 = jax_forwards(name)
    for fold in (False, True):
        jv = j_fold_bn(variables) if fold else variables
        raws_j = [np.asarray(r) for r in f32(jv, x)]
        net = port_net(spec_t, variables, fold)
        with torch.no_grad():
            raws_t = net(torch.from_numpy(x))
            rows_t = decode(raws_t, spec_t).numpy()
        assert len(raws_t) == len(raws_j) == spec_t.nl
        for lvl, (rt, rj) in enumerate(zip(raws_t, raws_j)):
            assert rt.shape == rj.shape
            np.testing.assert_allclose(rt.numpy(), rj, **RAW_TOL,
                                       err_msg=f"fold={fold} level {lvl}")
        np.testing.assert_allclose(
            rows_t, np.asarray(j_decode(raws_j, spec_j)), **ROW_TOL,
            err_msg=f"fold={fold} rows")
    want_bf = bf16(j_fold_bn(variables), jnp.asarray(x).astype(jnp.bfloat16))
    TM.cast_model(net, torch.bfloat16)
    with torch.no_grad():
        got_bf = net(torch.from_numpy(x).bfloat16())
        rows_bf = decode(got_bf, spec_t)
    plain = spec_t.nodes[-1].op == "Detect"
    want_dtype = "bfloat16" if plain else "float32"
    assert {str(r.dtype) for r in want_bf} == {want_dtype}
    assert {str(r.dtype) for r in got_bf} == {f"torch.{want_dtype}"}
    assert str(rows_bf.dtype) == f"torch.{want_dtype}"
    for lvl, (g, w, w32) in enumerate(zip(got_bf, want_bf, raws_j)):
        err = np.abs(g.float().numpy() - np.asarray(w, np.float32)).max()
        assert err / np.abs(w32).max() < RAW_REL, (lvl, err)


def test_repeated_nodes_are_sequentials():
    """A node repeated n > 1 times after the depth multiple is an
    nn.Sequential of n blocks (keys model.{i}.{j}.*), as in the
    reference; once, the block itself."""
    _, spec = specs("yolov7-lite-s")
    net = TM.YoloFace(spec)
    reps = {i: n.n_resolved for i, n in enumerate(spec.nodes)}
    assert sorted(set(reps.values())) == [1, 2]
    for i, n in reps.items():
        m = net.model[i]
        assert isinstance(m, torch.nn.Sequential) == (n > 1), i
        if n > 1:
            assert len(m) == n and all(isinstance(b, TL.ShuffleBlock)
                                       for b in m)
    keys = net.state_dict()
    assert "model.4.1.branch2.3.weight" in keys
    assert "model.0.stem_1.conv.weight" in keys


def test_reference_style_keys_load():
    """A state dict with the reference's names (StemBlock's stem_1 and
    stem_3, a repeated Shuffle_Block's model.{i}.{j}.branch2.{k}) loads
    into the full-width lite model, and the bridge names them so."""
    spec = TZ.get_spec("yolov7-lite-t")
    variables = model_variables(JZ.get_spec("yolov7-lite-t"), seed=7)
    state = jax_to_state_dict(variables)
    for key in ("model.0.stem_1.conv.weight", "model.0.stem_3.bn.running_var",
                "model.2.0.branch2.3.weight", "model.2.1.branch2.6.bias",
                "model.1.branch1.0.weight", "model.11.conv1.weight",
                "model.11.bn2.running_mean"):
        assert key in state, key
    net = TM.YoloFace(spec)
    load_reference_state_dict(net, state)
    assert torch.equal(net.state_dict()["model.2.0.branch2.3.weight"],
                       state["model.2.0.branch2.3.weight"])


# ---------------------------------------------------------------------------
# cfg parsing and strides
# ---------------------------------------------------------------------------

def same_spec(a, b):
    for f in ("name", "nc", "nkpt", "anchors", "strides", "depth_multiple",
              "width_multiple", "dw_conv_kpt", "act", "save"):
        assert getattr(a, f) == getattr(b, f), f
    assert [dataclasses.astuple(n) for n in a.nodes] == \
        [dataclasses.astuple(n) for n in b.nodes]


@pytest.mark.parametrize("name", JZ.available() + ["custom", "p4p5"])
def test_spec_from_yolo_yaml_matches_jax(name):
    """A cfg dict through both parsers: equal node for node (from,
    repeats, op, args, channels, internal repeats), and equal to the zoo's
    own spec for a zoo cfg; then through a yaml file and load_spec."""
    if name in ("custom", "p4p5"):
        cfg = CUSTOM_CFG if name == "custom" else P45_CFG
    else:
        cfg = zoo_cfg(JZ.get_spec(name))
    got = TS.spec_from_yolo_yaml(cfg, name)
    same_spec(got, JS.spec_from_yolo_yaml(cfg, name))
    if name in JZ.available():
        zoo = TZ.get_spec(name)
        assert [dataclasses.astuple(n) for n in got.nodes] == \
            [dataclasses.astuple(n) for n in zoo.nodes]


def test_load_spec_and_compute_strides(tmp_path):
    """load_spec of a yaml file names the spec after it; compute_strides
    (a shape-only forward on the meta device) equals the JAX one: P3/P4
    for the custom cfg, (16, 32) for the P4/P5 one whose parser default
    was (8, 16), each zoo model's pinned strides."""
    for cfg, stem, want in ((CUSTOM_CFG, "custom", (8, 16)),
                            (P45_CFG, "p45", (16, 32))):
        path = tmp_path / f"{stem}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        got, ref = TS.load_spec(str(path)), JS.load_spec(str(path))
        assert got.name == stem and got.strides == (8, 16)
        same_spec(got, ref)
        assert TM.compute_strides(got) == JM.compute_strides(ref) == want
        assert got.strides == want
    for name in TZ.available():
        spec = TZ.get_spec(name)
        pinned = spec.strides
        assert TM.compute_strides(spec) == pinned


# ---------------------------------------------------------------------------
# the fused path on the new groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,absorb_pre", [
    ("yolov7-face", False), ("yolov7s-face", True)])
def test_fused_apply_matches_jax(name, absorb_pre):
    """The fused executor's raws (each group through fused_elan's plain
    version on the CPU) against JAX fused_apply with its Pallas kernel in
    interpret mode and JAX YoloFace.apply, folded weights, width 0.25 at
    64 px: 8 groups each; with absorb_pre the first absorbs its stride-2
    conv."""
    spec_j, spec_t = narrow(JZ, name), narrow(TZ, name)
    variables = model_variables(spec_j, seed=8)
    x = images(1, 64, seed=9)
    jvars = j_fold_bn(variables)
    jblocks = JF.find_elan_blocks(spec_j, absorb_pre=absorb_pre)
    blocks = TF.find_elan_blocks(spec_t, absorb_pre=absorb_pre)
    assert len(blocks) == 8
    assert sum(b.pre is not None for b in blocks) == int(absorb_pre)
    assert [dataclasses.asdict(b) for b in blocks] == \
        [dataclasses.asdict(b) for b in jblocks]
    want_fused = JF.fused_apply(spec_j, jvars, jnp.asarray(x),
                                blocks=jblocks, interpret=True)
    want_model = JM.YoloFace(spec=spec_j).apply(jvars, jnp.asarray(x),
                                                train=False)
    net = port_net(spec_t, variables, fold=True)
    with torch.no_grad():
        got = TF.fused_apply(net, torch.from_numpy(x), blocks)
    assert len(got) == len(want_fused) == len(want_model)
    for g, wf, wm in zip(got, want_fused, want_model):
        np.testing.assert_allclose(g.numpy(), np.asarray(wf), **RAW_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(wm), **RAW_TOL)


# ---------------------------------------------------------------------------
# hub
# ---------------------------------------------------------------------------

def serving_settings(rows):
    """(conf_thres, iou_thres, max_candidates) for decoded rows (bs, N,
    no), each in the widest gap of the values that decide a gate or a
    suppression (tests/test_torch_detector.safe_settings for rows of any
    model), so the frameworks' ulp-level differences cannot flip one; the
    capacity holds every row."""
    obj, conf = rows[..., 4], rows[..., 5] * rows[..., 4]
    lo, hi = np.quantile(conf, [0.6, 0.8])
    conf_thres = widest_gap(np.concatenate([obj.ravel(), conf.ravel()]),
                            lo, hi)
    ious = []
    for r in rows:
        gated = r[(r[:, 4] > conf_thres) & (r[:, 5] * r[:, 4] > conf_thres)]
        xy, wh = gated[:, :2], gated[:, 2:4] / 2
        boxes = np.concatenate([xy - wh, xy + wh], 1)
        ious.append(np.asarray(JN.box_iou(boxes, boxes)).ravel())
    return (conf_thres, widest_gap(np.concatenate(ious), 0.4, 0.6),
            rows.shape[1])


def hub_detectors(make_j, make_t, spec_t, variables, frames):
    """The JAX and port hub detectors with the same variables and
    serving settings from the port's CPU rows of `frames`."""
    net = port_net(spec_t, variables, fold=True)
    with torch.no_grad():
        rows = decode(net(torch.from_numpy(frames.astype(np.float32)
                                           / 255.0)), spec_t).numpy()
    conf, iou, k = serving_settings(rows)
    kw = dict(variables=variables, img_sizes=(frames.shape[1],),
              conf_thres=conf, iou_thres=iou, max_candidates=k)
    return make_j(**kw), make_t(device="cpu", **kw)


def assert_same_detections(jdet, tdet, frames):
    jd, td = jdet.run_network(frames), tdet.run_network(frames)
    np.testing.assert_array_equal(td.n_gated.numpy(), np.asarray(jd.n_gated))
    np.testing.assert_array_equal(td.valid.sum(1).numpy(),
                                  np.asarray(jd.valid).sum(1))
    for g, w in zip(TN.detections_to_numpy(td), JN.detections_to_numpy(jd)):
        assert len(g) > 0
        assert_rows_match(g, np.asarray(w))


def test_hub_create_matches_jax(monkeypatch, tmp_path):
    """hub.create of the full-width lite-s on the CPU against the JAX
    hub's detector with the same variables, on the same frames; the list
    of models is the JAX hub's; a missing weights file whose fetch fails
    raises FileNotFoundError; without device= and without a card it
    raises."""
    assert TH.available_models() == JH.available_models()
    name = "yolov7-lite-s"
    variables = model_variables(JZ.get_spec(name), seed=10)
    frames = np.random.default_rng(11).integers(0, 256, (1, 96, 96, 3),
                                                dtype=np.uint8)
    jdet, tdet = hub_detectors(
        functools.partial(JH.create, name), functools.partial(
            TH.create, name), TZ.get_spec(name), variables, frames)
    assert tdet.spec.name == name and tdet.img_sizes == [96]
    assert_same_detections(jdet, tdet, frames)
    # the fetch of the missing file goes to an empty local release
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(TD, "download_url", release_redirect(
        TD, (tmp_path / "release").as_uri()))
    with pytest.raises(FileNotFoundError):
        TH.create(name, weights="no/such/weights.pt", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TH.create(name)


def test_hub_custom_matches_jax(tmp_path):
    """hub.custom of the custom cfg's yaml (a plain Detect head, strides
    from the shape-only forward) on the CPU against the JAX hub.custom
    with the same variables."""
    path = tmp_path / "custom.yaml"
    path.write_text(yaml.safe_dump(CUSTOM_CFG))
    variables = model_variables(JS.load_spec(str(path)), seed=12)
    frames = np.random.default_rng(13).integers(0, 256, (2, 64, 64, 3),
                                                dtype=np.uint8)
    jdet, tdet = hub_detectors(
        functools.partial(JH.custom, str(path)), functools.partial(
            TH.custom, str(path)), TS.load_spec(str(path)), variables,
        frames)
    assert tdet.spec.strides == jdet.spec.strides == (8, 16)
    assert_same_detections(jdet, tdet, frames)


def test_detector_fuse_elan_on_new_models():
    """FaceDetector(fuse_elan=True) finds the 8 groups of yolov7s-face
    and none of a lite model, which then serves its unfused forward."""
    from face_detection_multi_scale_tpu_torch.infer.detector import (
        FaceDetector)
    spec = narrow(TZ, "yolov7s-face")
    fused = FaceDetector(spec, img_sizes=(64,), fuse_elan="pre:",
                         device="cpu")
    assert len(fused._elan_blocks) == 8
    assert fused._elan_blocks[0].pre is not None
    lite = FaceDetector(narrow(TZ, "yolov7-lite-t"), img_sizes=(64,),
                        fuse_elan=True, device="cpu")
    assert lite._elan_blocks == []
    frames = np.zeros((1, 64, 64, 3), np.uint8)
    assert lite.run_network(frames).boxes.shape[0] == 1
