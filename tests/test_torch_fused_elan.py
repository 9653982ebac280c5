"""The port's fused-ELAN path (ops/elan_kernel.py, models/fused.py, the
FaceDetector's fuse_elan) against the JAX package on the CPU, with the
same inputs and weights.

On the CPU the wrappers run their plain versions; the CUDA kernels are
held against those on the card (chip_smoke.py, tests/test_torch_gpu.py).
The JAX side runs its Pallas kernels in interpret mode. Tolerances are the
JAX suite's: a group atol 2e-5 / rtol 1e-5 (tests/test_fused_elan.py),
raw maps atol 2e-4 / rtol 1e-3 (two frameworks' f32 convolutions sum in
different orders), detections as in tests/test_torch_detector.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from face_detection_multi_scale_tpu.models import fused as JF
from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.models.fuse import fold_bn as j_fold_bn
from face_detection_multi_scale_tpu.ops import nms as JN
from face_detection_multi_scale_tpu.ops import pallas_elan as JE
from face_detection_multi_scale_tpu_torch.models import fused as TF
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.ops import elan_kernel as TE
from face_detection_multi_scale_tpu_torch.ops import nms as TN

from test_torch_detector import assert_rows_match, detectors
from test_torch_model import (RAW_TOL, images, narrowed, port_model,
                              random_variables)

GROUP_TOL = dict(atol=2e-5, rtol=1e-5)


def to_port_weight(w):
    """A JAX fused_elan weight (HWIO kernel, (cin, cout) 1x1, (1, C)
    bias) in the port's layout (OIHW, (cout, cin, 1, 1), (C,))."""
    w = np.asarray(w)
    if w.ndim == 4:
        return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    if w.shape[0] == 1:
        return torch.from_numpy(w.reshape(-1).copy())
    return torch.from_numpy(np.ascontiguousarray(w.T[:, :, None, None]))


def port_shape(shape):
    return TE.ElanShape(**dataclasses.asdict(shape))


def jax_weights(rng, shape):
    """tests/test_fused_elan.py's _rand_weights."""
    def w(*s):
        return jnp.asarray(rng.randn(*s) * 0.2, jnp.float32)

    ws = []
    if shape.has_pre:
        ws += [w(3, 3, shape.pre_cin, shape.cin), w(1, shape.cin)]
    ws += [w(shape.cin, shape.ccv), w(1, shape.ccv),
           w(shape.cin, shape.ccv), w(1, shape.ccv)]
    cin_k = shape.ccv
    for _ in range(shape.n_chain):
        ws += [w(3, 3, cin_k, shape.cch), w(1, shape.cch)]
        cin_k = shape.cch
    ws += [w(shape.concat_width, shape.cout), w(1, shape.cout)]
    return ws


GROUP_CASES = [  # the cases of tests/test_fused_elan.py, with a strip height
    ("w6 backbone", dict(cin=12, ccv=8, cch=8, cout=16, n_chain=4,
                         members=("y4", "y2", "b", "a")), (2, 16, 16), 8),
    ("w6 head", dict(cin=12, ccv=16, cch=8, cout=16, n_chain=4,
                     members=("y4", "y3", "y2", "y1", "b", "a")),
     (2, 16, 16), 8),
    ("tiny leaky", dict(cin=12, ccv=8, cch=8, cout=16, n_chain=2,
                        members=("y2", "y1", "b", "a"), act="leaky"),
     (2, 16, 16), 8),
    ("pre stride 1", dict(cin=12, ccv=8, cch=8, cout=16, n_chain=4,
                          members=("y4", "y2", "b", "a"), pre_cin=6,
                          pre_stride=1), (2, 16, 20), 8),
    ("pre stride 2", dict(cin=12, ccv=8, cch=8, cout=16, n_chain=4,
                          members=("y4", "y2", "b", "a"), pre_cin=6,
                          pre_stride=2), (2, 32, 40), 8),
    ("single strip, y3 b, relu", dict(cin=8, ccv=8, cch=8, cout=8,
                                      n_chain=4, members=("y3", "b"),
                                      act="relu"), (1, 12, 20), 12),
]


@pytest.mark.parametrize("case", GROUP_CASES, ids=[c[0] for c in GROUP_CASES])
def test_reference_elan_matches_jax(case):
    """The port's fused_elan on CPU tensors (its plain reference_elan) vs
    the JAX reference_elan and the JAX Pallas kernel in interpret mode."""
    _, kw, (b, h, w), th = case
    shape = JE.ElanShape(**kw)
    rng = np.random.RandomState(0)
    c = shape.pre_cin if shape.has_pre else shape.cin
    x = rng.randn(b, h, w, c).astype(np.float32)
    ws = jax_weights(rng, shape)
    want_ref = np.asarray(JE.reference_elan(jnp.asarray(x), ws, shape))
    want_kernel = np.asarray(JE.fused_elan(jnp.asarray(x), ws, shape, th=th,
                                           interpret=True))
    got = TE.fused_elan(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                        [to_port_weight(v) for v in ws], port_shape(shape))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want_ref.shape
    np.testing.assert_allclose(got, want_ref, **GROUP_TOL)
    np.testing.assert_allclose(got, want_kernel, **GROUP_TOL)


def narrow_group_shapes():
    """Every distinct group shape of w6 and tiny at width 0.25, bare and
    with the absorbed pre conv (JAX ElanShapes)."""
    out = []
    for name in ("yolov7-w6-face", "yolov7-tiny-face"):
        for pre in (False, True):
            for blk in JF.find_elan_blocks(narrowed(JZ, name), absorb_pre=pre):
                if blk.shape not in out:
                    out.append(blk.shape)
    return out


NARROW_SHAPES = narrow_group_shapes()


def split_reference_elan(x, weights, shape):
    """reference_elan with each conv as the kernel's 3xTF32 products:
    three float32 convolutions of the split operands, small terms first,
    plus bias, then the activation."""
    act = TE._act_fn(shape.act)

    def conv(v, w, b, **kw):
        vb, vs = TE.tf32_split(v)
        wb, wsm = TE.tf32_split(w)
        return act(F.conv2d(vs, wb, None, **kw) + F.conv2d(vb, wsm, None, **kw)
                   + F.conv2d(vb, wb, b, **kw))

    if shape.has_pre:
        x = conv(x, weights[0], weights[1], stride=shape.pre_stride,
                 padding=1)
        weights = weights[2:]
    outs = {"a": conv(x, weights[0], weights[1]),
            "b": conv(x, weights[2], weights[3])}
    cur = outs["b"]
    for k in range(shape.n_chain):
        cur = conv(cur, weights[4 + 2 * k], weights[5 + 2 * k], padding=1)
        outs[f"y{k + 1}"] = cur
    cat = torch.cat([outs[m] for m in shape.members], dim=1)
    return conv(cat, weights[-2], weights[-1])


def test_tf32_split_bits():
    """Round to nearest with ties away from zero at 10 mantissa bits, as
    cvt.rna.tf32.f32; big + small recovers v to about 2^-22 of |v|."""
    one = 1.0
    ulp = 2.0 ** -10
    v = torch.tensor([one, one + ulp / 2, one + ulp / 2 - 2 ** -23,
                      -(one + ulp / 2), one + 1.5 * ulp, 2.0 ** -100, 0.0],
                     dtype=torch.float32)
    big, small = TE.tf32_split(v)
    want = torch.tensor([one, one + ulp, one, -(one + ulp), one + 2 * ulp,
                         2.0 ** -100, 0.0], dtype=torch.float32)
    assert torch.equal(big, want)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((small.view(torch.int32) & 0x1FFF) == 0).all())
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10000).astype(np.float32))
    b, sm = TE.tf32_split(r)
    assert float(((b + sm - r).abs() / r.abs()).max()) < 2.0 ** -21


@pytest.mark.parametrize("idx", range(len(NARROW_SHAPES)))
def test_3xtf32_products_within_group_bound(idx):
    """Each w6 and tiny group shape at width 0.25: the kernel's 3xTF32
    arithmetic (three float32 convolutions of the split operands a conv)
    within 1e-5 of max |JAX reference_elan| on the same numpy inputs, the
    bound the card holds the kernel to (tests/test_fused_elan.py)."""
    shape = NARROW_SHAPES[idx]
    rng = np.random.RandomState(idx)
    s = shape.pre_stride if shape.has_pre else 1
    c = shape.pre_cin if shape.has_pre else shape.cin
    x = rng.randn(2, 12 * s, 10 * s, c).astype(np.float32)
    ws = jax_weights(rng, shape)
    want = np.asarray(JE.reference_elan(jnp.asarray(x), ws, shape))
    got = split_reference_elan(
        torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
        [to_port_weight(v) for v in ws], port_shape(shape))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 1e-5, rel


def test_fused_elan_wrapper_checks():
    shape = TE.ElanShape(cin=4, ccv=4, cch=4, cout=4, n_chain=2,
                         members=("y2", "b", "a"), group=2)
    ws = [torch.zeros(s) for s in TE.weight_shapes(shape)]
    x = torch.zeros(2, 4, 8, 8)
    assert TE.fused_elan(x, ws, shape).shape == (2, 4, 8, 8)
    with pytest.raises(AssertionError):        # batch % group, as in JAX
        TE.fused_elan(x[:1], ws, shape)
    with pytest.raises(ValueError):
        TE.fused_elan(x[:, :3], ws, shape)
    with pytest.raises(ValueError):
        TE.fused_elan(x, ws[:-1], shape)
    with pytest.raises(TypeError):
        TE.fused_elan(x.double(), ws, shape)
    with pytest.raises(ValueError):
        TE.fused_elan(x, ws, dataclasses.replace(shape, members=("y3", "a")))
    with pytest.raises(NotImplementedError, match="nomask"):
        TE.fused_elan(x, ws, dataclasses.replace(shape, debug_skip_mask=True))


PLAN_CASES = [  # (model, group, batch, h, w) -> (tile, n_tiles, cluster, grid)
    ("yolov7-w6-face", 0, 8, 160, 160, (40, 40), 128, 2, 256),
    ("yolov7-w6-face", 1, 8, 80, 80, (40, 40), 32, 8, 256),
    ("yolov7-w6-face", 2, 8, 40, 40, (20, 20), 32, 8, 256),
    ("yolov7-w6-face", 4, 8, 10, 10, (10, 10), 8, 8, 64),
    ("yolov7-tiny-face", 4, 8, 40, 40, (20, 20), 32, 8, 256),
    ("yolov7-w6-face", 0, 1, 24, 41, (40, 40), 2, 8, 16),
    ("yolov7-w6-face", 0, 3, 100, 100, (40, 40), 27, 8, 216),
]


@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[3]}x{c[4]}" for c in
                              PLAN_CASES])
def test_elan_plan_routes(case):
    """Tiles by image size: WS_TILE_H x WS_TILE_W on large images, half
    the image up to 40 px, the whole image up to 20 px; clusters grow to 8
    as tiles get fewer, teams of a cluster loop over the tiles, about
    BLOCKS_PER_SM blocks an SM; the workspace is the plan's layout."""
    name, g, b, h, w, tile, n_tiles, cluster, grid = case
    shape = TF.find_elan_blocks(TZ.get_spec(name))[g].shape
    plan = TE.elan_plan(shape, b, h, w, 132)
    assert (plan["tile_h"], plan["tile_w"]) == tile
    assert plan["n_tiles"] == n_tiles and plan["cluster"] == cluster
    assert plan["grid"] == grid == plan["teams"] * cluster
    assert plan["teams"] <= n_tiles
    assert (plan["offsets"], plan["floats"]) == TE.workspace_layout(
        shape, *tile)


def test_recompute_share():
    """Positions computed over output positions: b over the tile plus the
    halo n_chain inside the image, y_k with n_chain - k, a and out none;
    an image that is one tile recomputes nothing."""
    shape = TF.find_elan_blocks(TZ.get_spec("yolov7-w6-face"))[0].shape
    share = TE.recompute_share(shape, {"tile_h": 16, "tile_w": 16}, 160, 160)
    # 10 x 10 tiles; per axis the windows cover 160 + 2 * 4 * 9 points
    assert share["b"] == pytest.approx((232 / 160) ** 2)
    assert share["y4"] == 1.0 and share["a"] == 1.0 and share["out"] == 1.0
    assert share["y1"] == pytest.approx((214 / 160) ** 2)
    assert 1.0 < share["group"] < share["b"]
    one = TE.recompute_share(shape, {"tile_h": 10, "tile_w": 10}, 10, 10)
    assert set(one.values()) == {1.0}


@pytest.mark.parametrize("tile", [(8, 8), (16, 16), (10, 7)])
def test_workspace_layout(tile):
    """The regions the kernel writes, one after another with no gap or
    overlap, each as large as the window csrc/fused_elan.cu computes into
    it: x and b over the tile plus the halo n_chain, a over the tile, y_k
    over the tile plus n_chain - k."""
    th, tw = tile
    shapes = [b.shape for name in ("yolov7-w6-face", "yolov7-tiny-face")
              for pre in (False, True)
              for b in TF.find_elan_blocks(TZ.get_spec(name), pre)]
    shapes.append(TE.ElanShape(cin=8, ccv=8, cch=4, cout=8, n_chain=4,
                               members=("y3", "b")))
    for shape in shapes:
        offsets, total = TE.workspace_layout(shape, th, tw)
        p = shape.n_chain
        want = [shape.cin * (th + 2 * p) * (tw + 2 * p) * shape.has_pre,
                shape.ccv * (th + 2 * p) * (tw + 2 * p),
                shape.ccv * th * tw * ("a" in shape.members)]
        want += [shape.cch * (th + 2 * (p - k)) * (tw + 2 * (p - k))
                 for k in range(1, p + 1)]
        assert len(offsets) == 3 + p
        assert np.diff(offsets + [total]).tolist() == want, shape


@pytest.mark.parametrize("absorb_pre", [False, True])
def test_find_elan_blocks_matches_jax(absorb_pre):
    for name in JZ.available():
        want = JF.find_elan_blocks(JZ.get_spec(name), absorb_pre=absorb_pre)
        got = TF.find_elan_blocks(TZ.get_spec(name), absorb_pre=absorb_pre)
        assert [dataclasses.asdict(b) for b in got] == \
            [dataclasses.asdict(b) for b in want], name
    w6 = TF.find_elan_blocks(TZ.get_spec("yolov7-w6-face"), absorb_pre)
    tiny = TF.find_elan_blocks(TZ.get_spec("yolov7-tiny-face"), absorb_pre)
    assert len(w6) == 11 and len(tiny) == 8
    assert TF.find_elan_blocks(TZ.get_spec("yolov7-lite-t"), absorb_pre) == []
    pres = [b.pre for b in w6 if b.pre is not None]
    assert pres == ([2, 11, 20, 29, 38] if absorb_pre else [])
    assert [b.pre for b in tiny if b.pre is not None] == \
        ([1] if absorb_pre else [])


def test_apply_variant_matches_jax():
    base = dict(cin=128, ccv=64, cch=64, cout=128, n_chain=4,
                members=("y4", "y2", "b", "a"))
    for expr in ("taps", "flat", "im2col", "flat_im2col", "im2col9",
                 "flat+im2col9+ab+ct", "nopad", "g2", "flat+b28", "relu",
                 "im2col9+ct+nopad+g4+b20+relu"):
        want = JF.apply_variant(JE.ElanShape(**base), expr)
        got = TF.apply_variant(TE.ElanShape(**base), expr)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), expr
    for bad in ("bogus", "flat+x"):
        with pytest.raises(ValueError):
            TF.apply_variant(TE.ElanShape(**base), bad)
    with pytest.raises(NotImplementedError, match="nomask"):
        TF.apply_variant(TE.ElanShape(**base), "flat+nomask")


@pytest.mark.parametrize("fold", [False, True])
def test_pack_elan_weights_matches_jax(fold):
    spec_j, spec_t = narrowed(JZ, "yolov7-w6-face"), narrowed(
        TZ, "yolov7-w6-face")
    variables = random_variables(spec_j, seed=6)
    jvars = j_fold_bn(variables) if fold else variables
    net = port_model(spec_t, variables, fuse=fold)
    for blk_j, blk_t in zip(JF.find_elan_blocks(spec_j, absorb_pre=True),
                            TF.find_elan_blocks(spec_t, absorb_pre=True)):
        want = JF.pack_elan_weights(jvars, blk_j, jnp.float32)
        got = TF.pack_elan_weights(net, blk_t)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), to_port_weight(w).numpy(),
                                       atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["yolov7-w6-face", "yolov7-tiny-face"])
def test_no_blocks_is_the_model(name):
    spec = narrowed(TZ, name)
    net = port_model(spec, random_variables(narrowed(JZ, name), seed=7))
    x = torch.from_numpy(images(2, 64, seed=8))
    with torch.no_grad():
        want, got = net(x), TF.fused_apply(net, x, blocks=[])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name,absorb_pre", [
    ("yolov7-w6-face", False), ("yolov7-w6-face", True),
    ("yolov7-tiny-face", False), ("yolov7-tiny-face", True)])
def test_fused_apply_matches_jax(name, absorb_pre):
    """The fused executor's raws vs JAX fused_apply (Pallas interpret)
    and JAX YoloFace.apply, folded weights, width 0.25 at 64 px."""
    spec_j, spec_t = narrowed(JZ, name), narrowed(TZ, name)
    variables = random_variables(spec_j, seed=9)
    x = images(1, 64, seed=10)
    jvars = j_fold_bn(variables)
    want_fused = JF.fused_apply(spec_j, jvars, jnp.asarray(x),
                                blocks=JF.find_elan_blocks(spec_j, absorb_pre),
                                interpret=True)
    want_model = JM.YoloFace(spec=spec_j).apply(jvars, jnp.asarray(x),
                                                train=False)
    net = port_model(spec_t, variables, fuse=True)
    blocks = TF.find_elan_blocks(spec_t, absorb_pre=absorb_pre)
    with torch.no_grad():
        got = TF.fused_apply(net, torch.from_numpy(x), blocks)
    assert len(got) == len(want_fused) == len(want_model)
    for g, wf, wm in zip(got, want_fused, want_model):
        np.testing.assert_allclose(g.numpy(), np.asarray(wf), **RAW_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(wm), **RAW_TOL)


def test_fused_apply_pre_stride_fallback():
    """A block whose absorbed pre conv's stride does not divide its input:
    the pre conv runs as a node and the group fuses bare, as in JAX. (At
    sizes the zoo models take every stride divides, so the first block's
    stride is set to 3 against its 32-px input.)"""
    spec = narrowed(TZ, "yolov7-w6-face")
    net = port_model(spec, random_variables(narrowed(JZ, "yolov7-w6-face"),
                                            seed=11), fuse=True)
    blocks = TF.find_elan_blocks(spec, absorb_pre=True)
    first = blocks[0]
    blocks[0] = dataclasses.replace(
        first, shape=dataclasses.replace(first.shape, pre_stride=3))
    x = torch.from_numpy(images(1, 64, seed=12))
    weights = {}
    with torch.no_grad():
        want = net(x)
        got = TF.fused_apply(net, x, blocks, weights)
    assert blocks[0] not in weights and TF._bare(blocks[0]) in weights
    assert len(weights) == 11
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **RAW_TOL)


@pytest.mark.parametrize("name,flag", [
    ("yolov7-tiny-face", True), ("yolov7-tiny-face", "pre:flat+im2col9+ab+ct"),
    ("yolov7-w6-face", "pre:flat+im2col9+ab+ct")])
def test_detector_fuse_elan_matches_jax(name, flag):
    frames = np.random.default_rng(14).integers(0, 256, (2, 128, 128, 3),
                                                dtype=np.uint8)
    jdet, tdet = detectors(name, frames, fuse_elan=flag)
    assert [dataclasses.asdict(b) for b in tdet._elan_blocks] == \
        [dataclasses.asdict(b) for b in jdet._elan_blocks]
    if isinstance(flag, str):
        assert any(b.pre is not None for b in tdet._elan_blocks)
    jd, td = jdet.run_network(frames), tdet.run_network(frames)
    np.testing.assert_array_equal(td.n_gated.numpy(), np.asarray(jd.n_gated))
    for g, w in zip(TN.detections_to_numpy(td), JN.detections_to_numpy(jd)):
        assert len(g) > 0
        assert_rows_match(g, np.asarray(w))
