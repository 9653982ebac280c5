"""The port's model stack (spec, zoo, layers, head, YoloFace, weight bridge,
BN fold) against the JAX package on the CPU, with the same weights: a
numpy-seeded JAX variables tree, carried into the port by the bridge.

Tolerances are those of tests/test_model_parity.py: raw per-level maps
atol 2e-4 / rtol 1e-3 (two frameworks' f32 convolutions sum in different
orders), decoded rows atol 5e-3 / rtol 1e-3 (the decode scales xy by the
stride and wh by anchors of up to 925 px)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.models import convert as JC
from face_detection_multi_scale_tpu.models import layers as JL
from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.models.fuse import fold_bn as j_fold_bn
from face_detection_multi_scale_tpu.models.head import decode as j_decode
from face_detection_multi_scale_tpu.models.spec import Node
from face_detection_multi_scale_tpu_torch.models import layers as TL
from face_detection_multi_scale_tpu_torch.models import model as TM
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.models.convert import (
    jax_to_state_dict)
from face_detection_multi_scale_tpu_torch.models.fuse import fold_bn
from face_detection_multi_scale_tpu_torch.models.head import decode

RAW_TOL = dict(atol=2e-4, rtol=1e-3)
ROW_TOL = dict(atol=5e-3, rtol=1e-3)


def narrowed(zoo, name, width=0.25):
    spec = zoo.get_spec(name)
    spec.width_multiple = width
    spec._resolved = False
    return spec.resolve()


def random_variables(spec, seed):
    """A JAX variables tree for `spec` (structure from a shape-only init),
    filled from a numpy seed: lecun-scaled kernels, non-trivial BN
    statistics (so the fold has work), implicit priors near 0 and 1."""
    model = JM.YoloFace(spec=spec)
    abstract = jax.eval_shape(functools.partial(model.init, train=False),
                              jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        parent = path[-2].key
        if name == "kernel":
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "implicit":
            v = rng.normal(0, 0.02, shape) + parent.startswith("im_")
        else:  # bias, mean
            v = rng.normal(0, 0.1, shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(abstract))


def images(bs, size, seed):
    return np.random.default_rng(seed).random((bs, size, size, 3),
                                              np.float32)


def port_model(spec, variables, fuse=False):
    net = TM.YoloFace(spec)
    net.load_state_dict(jax_to_state_dict(variables))
    if fuse:
        fold_bn(net)
    return net.eval()


def test_zoo_matches_jax_zoo():
    assert TZ.available() == JZ.available()
    for name in JZ.available():
        want, got = JZ.get_spec(name), TZ.get_spec(name)
        for f in ("name", "nc", "nkpt", "anchors", "strides",
                  "depth_multiple", "width_multiple", "dw_conv_kpt", "act",
                  "save"):
            assert getattr(got, f) == getattr(want, f), (name, f)
        assert [dataclasses.astuple(n) for n in got.nodes] == \
            [dataclasses.astuple(n) for n in want.nodes], name


@pytest.mark.parametrize("name", ["yolov7-w6-face", "yolov7-tiny-face",
                                  "yolov7-face", "yolov7s-face",
                                  "yolov7-lite-t", "yolov7-lite-s"])
def test_bridge_round_trip(name):
    """Every JAX leaf lands in exactly one state-dict entry of the right
    shape, and the keys are exactly the port model's (StemBlock's
    `stem_1` stays whole; a repeated node's `model_{i}_{j}` becomes
    `model.{i}.{j}`); the JAX package's own converter maps the result
    back to the same tree, value for value."""
    spec_j, spec_t = narrowed(JZ, name), narrowed(TZ, name)
    variables = random_variables(spec_j, seed=0)
    state = jax_to_state_dict(variables)
    want = TM.YoloFace(spec_t).state_dict()
    assert sorted(state) == sorted(want)
    for key, v in state.items():
        assert v.shape == want[key].shape, key
    n_leaves = len(jax.tree.leaves(variables))
    assert n_leaves == sum(not k.endswith("num_batches_tracked")
                           for k in state)
    back = JC.convert_state_dict(state)
    JC.assert_tree_shapes_match(back, variables)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf,
                                      err_msg=str(path))


@pytest.mark.parametrize("name,size", [("yolov7-w6-face", 128),
                                       ("yolov7-tiny-face", 96)])
def test_raws_and_rows_match_jax(name, size):
    """Unfolded and folded: raw per-level maps (bs, na, ny, nx, no) and
    decoded rows of the port's YoloFace vs JAX YoloFace.apply."""
    spec_j, spec_t = narrowed(JZ, name), narrowed(TZ, name)
    variables = random_variables(spec_j, seed=1)
    x = images(2, size, seed=2)
    apply = jax.jit(functools.partial(JM.YoloFace(spec=spec_j).apply,
                                      train=False))
    for fuse in (False, True):
        jvars = j_fold_bn(variables) if fuse else variables
        raws_j = [np.asarray(r) for r in apply(jvars, x)]
        net = port_model(spec_t, variables, fuse=fuse)
        with torch.no_grad():
            raws_t = net(torch.from_numpy(x))
            rows_t = decode(raws_t, spec_t).numpy()
        assert len(raws_t) == len(raws_j) == spec_t.nl
        for lvl, (rt, rj) in enumerate(zip(raws_t, raws_j)):
            assert rt.shape == rj.shape
            np.testing.assert_allclose(rt.numpy(), rj, **RAW_TOL,
                                       err_msg=f"fuse={fuse} level {lvl}")
        rows_j = np.asarray(j_decode(raws_j, spec_j))
        np.testing.assert_allclose(rows_t, rows_j, **ROW_TOL,
                                   err_msg=f"fuse={fuse} rows")


@pytest.mark.parametrize("op,args", [("ReOrg", ()), ("MP", ()),
                                     ("SP", (5, 1)), ("SPF", (13,)),
                                     ("Upsample", ())])
def test_stateless_ops_match_jax(op, args):
    """NHWC JAX op vs NCHW port op on the same tensor, exactly: the channel
    order of ReOrg, the -inf padding of the pools, the nearest upsample."""
    x = np.random.default_rng(3).standard_normal((2, 12, 8, 5)).astype(
        np.float32)
    want = np.asarray(JM.apply_stateless_op(op, Node(-1, 1, op, args),
                                            jnp.asarray(x)))
    got = TM.apply_stateless_op(op, args,
                                torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_conv_bn_eps_and_activations():
    """ConvBN uses BN eps 1e-3 (not torch's 1e-5); act names resolve as
    in the JAX package."""
    blk = TL.ConvBN(4, 8, 3, act="leaky")
    assert blk.bn.eps == 1e-3 and TL.BN_EPS == 1e-3
    x = torch.linspace(-2, 2, 9)
    for name in (True, "silu", "leaky", "relu", "none", None, False):
        np.testing.assert_allclose(
            TL.act_fn(name)(x).numpy(),
            np.asarray(JL.act_fn(name)(jnp.asarray(x.numpy()))), atol=1e-6)
    with pytest.raises(ValueError):
        TL.act_fn("gelu")


@torch.no_grad()
def test_seeded_init_is_deterministic_and_follows_jax_priors():
    spec = narrowed(TZ, "yolov7-tiny-face")
    a = TM.init_weights(TM.YoloFace(spec), torch.Generator().manual_seed(3))
    b = TM.init_weights(TM.YoloFace(spec), torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    head = a.model[-1]
    bias = head.m[0].bias.reshape(spec.na, spec.no_det)
    np.testing.assert_allclose(bias[:, 4].numpy(),
                               np.log(8 / (640 / 8) ** 2), rtol=1e-6)
    np.testing.assert_allclose(bias[:, 5].numpy(), np.log(0.6 / 0.01),
                               rtol=1e-6)
    assert abs(float(head.ia[0].implicit.mean())) < 0.02
    assert abs(float(head.im[0].implicit.mean()) - 1) < 0.02


def test_unported_ops_raise_naming_the_op():
    """Every zoo model builds; a spec with an op of the JAX package's
    layers_extra.py (not ported) raises naming the op."""
    for name in TZ.available():
        TM.YoloFace(TZ.get_spec(name))
    for op, args in [("GhostConv", (64, 3, 2)), ("C3TR", (64,)),
                     ("CrossConv", (64, 3, 1))]:
        spec = TZ.get_spec("yolov7-tiny-face")
        spec.nodes[1] = Node(0, 1, op, args)
        with pytest.raises(NotImplementedError, match=op):
            TM.YoloFace(spec)
