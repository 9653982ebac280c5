"""The port's extra blocks (models/layers_extra.py), the executor's extra
ops (Contract, Expand, Sum) and a cfg built of them, against the JAX
package on the CPU: the same numpy-seeded weights (a JAX variables tree
carried into the port by the weight bridge) and inputs.

What is held, and at what tolerance:
  * every block, function and activation module alone: within 1e-5 of
    max |JAX output| in float32;
  * MixConv2d's channel split, for every c2 in 1..512 and 2 to 4 kernel
    sizes, equal to the JAX package's;
  * `contract`'s channel order against the reference's NCHW formula
    (written out here);
  * MINI_CFG, a small reference-format cfg with every op of the extra cfg
    tests/data/yolov7s-face-extra.json (ConvFocus, MixConv2d, GhostConv,
    GhostBottleneck at s = 1 and 2, CrossConv, C3TR, SPPCSP, Contract /
    Expand, BottleneckCSP2, BottleneckCSPF, a weighted Sum) and two E-ELAN
    groups, on a non-square input: raw maps unfused, folded (the port's
    fold against the JAX `fold_bn` output, then the forward) and fused
    (the port's fused executor, each group through fused_elan's plain
    version, against the JAX `fused_apply` with its Pallas kernel in
    interpret mode) at atol 2e-4 / rtol 1e-3, decoded rows at atol 5e-3
    / rtol 1e-3; its bf16 raws within 2e-2 of max |JAX float32 raw| of
    the JAX bf16 forward; int8 raising in both packages; the state-dict
    round trip (also of the extra cfg at full width); one train
    micro-step at the bounds of PERF.md §2 (loss rtol 2e-4; parameters
    and EMA rtol 5e-3 / atol 5e-5), the JAX step in float64
    (tests/test_torch_train_step.Case says why).

The JAX MixConv2d computes its channel split with jnp.linspace and
jnp.floor on Python numbers, which a trace (jit, eval_shape) cannot turn
into the ints its conv widths need (ConcretizationTypeError): the JAX
package runs a cfg with MixConv2d only eagerly. This file hands the JAX
module a `jnp` whose linspace runs eagerly (JAX's own, under
jax.ensure_compile_time_eval) and whose floor of that numpy result is
numpy's, so the JAX forwards and the train step can be jitted; the
values are the same."""

import functools
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.models import fused as JF
from face_detection_multi_scale_tpu.models import layers_extra as JLX
from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import quant as JQ
from face_detection_multi_scale_tpu.models import spec as JS
from face_detection_multi_scale_tpu.models.fuse import fold_bn as j_fold_bn
from face_detection_multi_scale_tpu.models.head import decode as j_decode
from face_detection_multi_scale_tpu.train import trainer as JR
from face_detection_multi_scale_tpu_torch.infer.detector import FaceDetector
from face_detection_multi_scale_tpu_torch.models import fused as TF
from face_detection_multi_scale_tpu_torch.models import layers_extra as TLX
from face_detection_multi_scale_tpu_torch.models import model as TM
from face_detection_multi_scale_tpu_torch.models import quant as TQ
from face_detection_multi_scale_tpu_torch.models import spec as TS
from face_detection_multi_scale_tpu_torch.models.convert import (
    jax_to_state_dict, load_reference_state_dict, state_dict_to_jax)
from face_detection_multi_scale_tpu_torch.models.fuse import fold_bn
from face_detection_multi_scale_tpu_torch.models.head import decode
from face_detection_multi_scale_tpu_torch.train import trainer as TR

import test_torch_train_step as TSTEP
from test_torch_model import RAW_TOL, ROW_TOL
from test_torch_zoo_models import fill

BLOCK_REL = 1e-5
BF16_REL = 2e-2
STEP_LOSS_RTOL = 2e-4
EXTRA_CFG = Path(__file__).resolve().parent / "data" / \
    "yolov7s-face-extra.json"
ANCHORS = [[4, 5, 6, 8, 10, 12], [15, 19, 23, 30, 39, 52],
           [72, 97, 123, 164, 209, 297]]
MINI_CFG = {
    "nc": 1, "nkpt": 5, "depth_multiple": 1.0, "width_multiple": 0.25,
    "anchors": ANCHORS,
    "backbone": [
        [-1, 1, "ConvFocus", [64, 3]],                 # 0  /2
        [-1, 1, "MixConv2d", [64, [1, 3], 1]],         # 1
        [-1, 1, "GhostConv", [128, 3, 2]],             # 2  /4
        [-1, 1, "Conv", [64, 1, 1]],                   # 3  E-ELAN group
        [-2, 1, "Conv", [64, 1, 1]],                   # 4
        [-1, 1, "Conv", [64, 3, 1]],                   # 5
        [-1, 1, "Conv", [64, 3, 1]],                   # 6
        [[-1, -2, -3, -4], 1, "Concat", [1]],          # 7
        [-1, 1, "Conv", [128, 1, 1]],                  # 8
        [-1, 1, "GhostBottleneck", [128, 3, 2]],       # 9  /8
        [-1, 1, "CrossConv", [128, 3, 1]],             # 10
        [-1, 1, "GhostBottleneck", [128, 3, 1]],       # 11
        [-1, 1, "Conv", [256, 3, 2]],                  # 12 /16
        [-1, 1, "Conv", [128, 1, 1]],                  # 13 E-ELAN group
        [-2, 1, "Conv", [128, 1, 1]],                  # 14
        [-1, 1, "Conv", [128, 3, 1]],                  # 15
        [-1, 1, "Conv", [128, 3, 1]],                  # 16
        [[-1, -2, -3, -4], 1, "Concat", [1]],          # 17
        [-1, 1, "Conv", [256, 1, 1]],                  # 18
        [-1, 1, "Conv", [512, 3, 2]],                  # 19 /32
        [-1, 2, "C3TR", [512, False]],                 # 20
        [-1, 1, "SPPCSP", [256]],                      # 21
    ],
    "head": [
        [-1, 1, "Contract", [2]],                      # 22 /64
        [-1, 1, "Conv", [1024, 1, 1]],                 # 23
        [-1, 1, "Expand", [2]],                        # 24 /32
        [-1, 1, "Conv", [256, 1, 1]],                  # 25
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],  # 26 /16
        [18, 1, "BottleneckCSP2", [256]],              # 27
        [[-1, 26], 1, "Concat", [1]],                  # 28
        [-1, 1, "BottleneckCSPF", [128]],              # 29
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],  # 30 /8
        [[-1, 11], 1, "Sum", [2, True]],               # 31
        [-1, 1, "Conv", [128, 1, 1]],                  # 32
        [29, 1, "Conv", [256, 1, 1]],                  # 33
        [25, 1, "Conv", [512, 1, 1]],                  # 34
        [[32, 33, 34], 1, "IKeypoint", ["nc", "anchors", "nkpt"]],
    ],
}
EXTRA_OPS = {"ConvFocus", "MixConv2d", "GhostConv", "GhostBottleneck",
             "CrossConv", "C3TR", "SPPCSP", "Contract", "Expand",
             "BottleneckCSP2", "BottleneckCSPF", "Sum"}
HW = (64, 128)  # non-square; the /32 map must split into 2 x 2 cells


class _EagerSplitJnp:
    """jax.numpy for the JAX layers_extra module, with `linspace` run
    eagerly (JAX's own, under jax.ensure_compile_time_eval) and `floor`
    of its numpy result taken in numpy (exact), so MixConv2d's channel
    split is concrete inside a trace; everything else is jax.numpy's."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def linspace(*args, **kwargs):
        with jax.ensure_compile_time_eval():
            return np.asarray(jnp.linspace(*args, **kwargs))

    @staticmethod
    def floor(x):
        return np.floor(x) if isinstance(x, np.ndarray) else jnp.floor(x)


@pytest.fixture(scope="module", autouse=True)
def traceable_mixconv():
    saved = JLX.jnp
    JLX.jnp = _EagerSplitJnp()
    yield
    JLX.jnp = saved


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU work on one thread for this module: beside the
    other test workers, torch's thread pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# each block alone
# ---------------------------------------------------------------------------

def _maps(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


# name: (JAX module, port module, NHWC input shapes, call kind)
BLOCKS = {
    "CrossConv": (lambda: JLX.CrossConv(8, 8, 3, 1),
                  lambda: TLX.CrossConv(8, 8, 3, 1), [(2, 6, 10, 8)],
                  "train"),
    "CrossConv_s2": (lambda: JLX.CrossConv(8, 16, 3, 2, e=0.5),
                     lambda: TLX.CrossConv(8, 16, 3, 2, e=0.5),
                     [(2, 6, 10, 8)], "train"),
    "Sum": (lambda: JLX.Sum(3), lambda: TLX.Sum(3),
            [(2, 4, 6, 8)] * 3, "list"),
    "Sum_weight": (lambda: JLX.Sum(3, True), lambda: TLX.Sum(3, True),
                   [(2, 4, 6, 8)] * 3, "list"),
    "GhostConv": (lambda: JLX.GhostConv(8, 16, 3, 2),
                  lambda: TLX.GhostConv(8, 16, 3, 2), [(2, 8, 12, 8)],
                  "train"),
    "GhostBottleneck": (lambda: JLX.GhostBottleneck(16, 16, 3, 1),
                        lambda: TLX.GhostBottleneck(16, 16, 3, 1),
                        [(2, 6, 10, 16)], "train"),
    "GhostBottleneck_s2": (lambda: JLX.GhostBottleneck(8, 16, 3, 2),
                           lambda: TLX.GhostBottleneck(8, 16, 3, 2),
                           [(2, 8, 12, 8)], "train"),
    "MixConv2d": (lambda: JLX.MixConv2d(16, 16, (1, 3, 5), 1),
                  lambda: TLX.MixConv2d(16, 16, (1, 3, 5), 1),
                  [(2, 6, 10, 16)], "train"),
    "TransformerBlock": (lambda: JLX.TransformerBlock(8, 16, 4, 2),
                         lambda: TLX.TransformerBlock(8, 16, 4, 2),
                         [(2, 3, 5, 8)], "train"),
    "C3TR": (lambda: JLX.C3TR(16, 16, 2), lambda: TLX.C3TR(16, 16, 2),
             [(2, 6, 10, 16)], "train"),
    "BottleneckCSPF": (lambda: JLX.BottleneckCSPF(16, 24, 2),
                       lambda: TLX.BottleneckCSPF(16, 24, 2),
                       [(2, 6, 10, 16)], "train"),
    "BottleneckCSP2": (lambda: JLX.BottleneckCSP2(16, 16, 2),
                       lambda: TLX.BottleneckCSP2(16, 16, 2),
                       [(2, 6, 10, 16)], "train"),
    "SPPCSP": (lambda: JLX.SPPCSP(16, 16), lambda: TLX.SPPCSP(16, 16),
               [(2, 14, 18, 16)], "train"),
    "ConvFocus": (lambda: JLX.ConvFocus(3, 16, 3),
                  lambda: TLX.ConvFocus(3, 16, 3), [(2, 8, 12, 3)],
                  "train"),
    "Classify": (lambda: JLX.Classify(24, 5), lambda: TLX.Classify(24, 5),
                 [(2, 6, 10, 16), (2, 3, 5, 8)], "list_train"),
    "FReLU": (lambda: JLX.FReLU(8), lambda: TLX.FReLU(8), [(2, 6, 10, 8)],
              "train"),
    "AconC": (lambda: JLX.AconC(8), lambda: TLX.AconC(8), [(2, 6, 10, 8)],
              "plain"),
    "MetaAconC": (lambda: JLX.MetaAconC(32, r=4),
                  lambda: TLX.MetaAconC(32, r=4), [(2, 6, 10, 32)],
                  "plain"),
}


def jax_block(make, xs, kind, seed):
    """(JAX output, the numpy-seeded variables) of one block."""
    mod = make()
    args = {"train": lambda v, x: mod.apply(v, x[0], train=False),
            "list": lambda v, x: mod.apply(v, list(x)),
            "list_train": lambda v, x: mod.apply(v, list(x), train=False),
            "plain": lambda v, x: mod.apply(v, x[0])}[kind]
    init = {"train": lambda k, x: mod.init(k, x[0], train=False),
            "list": lambda k, x: mod.init(k, list(x)),
            "list_train": lambda k, x: mod.init(k, list(x), train=False),
            "plain": lambda k, x: mod.init(k, x[0])}[kind]
    abstract = jax.eval_shape(init, jax.random.PRNGKey(0), xs)
    variables = fill(abstract, seed)
    return np.asarray(jax.jit(args)(variables, xs)), variables


def port_block(make, variables):
    mod = make()
    mod.load_state_dict(jax_to_state_dict(variables))
    return mod.eval()


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    make_j, make_t, shapes, kind = BLOCKS[name]
    xs = _maps(*shapes, seed=len(name))
    want, variables = jax_block(make_j, xs, kind, seed=1)
    net = port_block(make_t, variables)
    with torch.no_grad():
        if kind.startswith("list"):
            got = net([nchw(x) for x in xs])
        else:
            got = net(nchw(xs[0]))
    got = got.numpy() if got.ndim == 2 else to_nhwc(got)
    assert got.shape == want.shape
    assert rel_err(got, want) < BLOCK_REL, name


def test_crossconv_strides_the_height_only():
    """CrossConv at s = 2 follows the JAX package: the (k, 1) conv strides
    the height, the width keeps its size (the reference's cv1 strides the
    width instead)."""
    net = TLX.CrossConv(8, 16, 3, 2, e=0.5)
    assert net(torch.zeros(1, 8, 6, 10)).shape == (1, 16, 3, 10)


def test_transformer_layer_matches_jax():
    """A TransformerLayer on (seq, batch, c), its q/k/v Dense kernels
    transposed into Linear weights and `ma_out` into `ma.out_proj`."""
    x = _maps((15, 2, 16), seed=3)[0]
    mod = JLX.TransformerLayer(16, 4)
    variables = fill(jax.eval_shape(mod.init, jax.random.PRNGKey(0), x), 2)
    want = np.asarray(jax.jit(mod.apply)(variables, x))
    net = port_block(lambda: TLX.TransformerLayer(16, 4), variables)
    assert {k.rsplit(".", 1)[0] for k in net.state_dict()} == {
        "q", "k", "v", "ma.out_proj", "fc1", "fc2"}
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert rel_err(got, want) < BLOCK_REL


@pytest.mark.parametrize("fn", ["silu", "hardswish", "mish",
                                "memory_efficient_mish"])
def test_activation_functions_match_jax(fn):
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    want = np.asarray(getattr(JLX, fn)(jnp.asarray(x)))
    got = getattr(TLX, fn)(torch.from_numpy(x)).numpy()
    assert rel_err(got, want) < BLOCK_REL


@pytest.mark.parametrize("gain", [2, 4])
def test_contract_and_expand_match_jax(gain):
    x = _maps((2, 8, 12, 32), seed=4)[0]
    c = TLX.contract(nchw(x), gain)
    np.testing.assert_array_equal(to_nhwc(c),
                                  np.asarray(JLX.contract(x, gain)))
    e = TLX.expand(nchw(x), gain)
    np.testing.assert_array_equal(to_nhwc(e),
                                  np.asarray(JLX.expand(x, gain)))
    assert torch.equal(TLX.expand(c, gain), nchw(x))


def test_contract_matches_reference_channel_order():
    """The reference Contract (models/common.py:384-395) on NCHW:
    x.view(b, c, h/s, s, w/s, s).permute(0, 3, 5, 1, 2, 4) into
    (b, c s s, h/s, w/s), written out here."""
    x = torch.arange(2 * 3 * 4 * 6, dtype=torch.float32).reshape(2, 3, 4, 6)
    s = 2
    b, c, h, w = x.shape
    ref = x.view(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
    ref = ref.contiguous().view(b, c * s * s, h // s, w // s)
    assert torch.equal(TLX.contract(x, s), ref)


def test_mixconv_split_matches_jax_for_every_width():
    """mixconv_split(c2, g) == the JAX MixConv2d's floor(jnp.linspace(0,
    g - 1e-6, c2)) counts, for c2 in 1..512 and g in 2..4 (the three
    stops of one c2 in one jnp.linspace, every c2 in one jitted program;
    floor in numpy, which is exact)."""
    stops = np.array([g - 1e-6 for g in range(2, 5)])
    widths = range(1, 513)
    fn = jax.jit(lambda: jnp.concatenate(
        [jnp.linspace(0.0, stops, c2) for c2 in widths]))
    flat = np.floor(np.asarray(fn.lower().compile(
        compiler_options={"xla_backend_optimization_level": 0})()))
    offsets = np.cumsum([0] + list(widths))
    for c2, lo, hi in zip(widths, offsets[:-1], offsets[1:]):
        for j, g in enumerate(range(2, 5)):
            want = [int((flat[lo:hi, j] == i).sum()) for i in range(g)]
            assert TLX.mixconv_split(c2, g) == want, (c2, g)


def test_acon_parameters_come_from_the_generator():
    """AconC / MetaAconC draw p1 and p2 from the given generator, the same
    draws for the same seed; AconC leaves the global RNG alone."""
    state = torch.random.get_rng_state()
    a = TLX.AconC(8, torch.Generator().manual_seed(5))
    b = TLX.AconC(8, torch.Generator().manual_seed(5))
    assert torch.equal(torch.random.get_rng_state(), state)
    m = TLX.MetaAconC(32, generator=torch.Generator().manual_seed(5))
    n = TLX.MetaAconC(32, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.p1, b.p1) and torch.equal(a.p2, b.p2)
    assert torch.equal(m.p1, n.p1) and torch.equal(m.p2, n.p2)
    assert not torch.equal(a.p1, a.p2)
    assert torch.equal(a.beta, torch.ones(1, 8, 1, 1))
    assert m.fc1.out_channels == max(16, 32 // 16)


# ---------------------------------------------------------------------------
# the mini cfg: unfused, folded, fused, bf16, int8, the state dict
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def mini():
    """(JAX spec, port spec, numpy-seeded variables, NHWC images)."""
    spec_j = JS.spec_from_yolo_yaml(MINI_CFG, "mini-extra")
    spec_t = TS.spec_from_yolo_yaml(MINI_CFG, "mini-extra")
    abstract = jax.eval_shape(
        functools.partial(JM.YoloFace(spec=spec_j).init, train=False),
        jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
    variables = fill(abstract, seed=11)
    x = np.random.default_rng(12).random((2, *HW, 3), np.float32)
    return spec_j, spec_t, variables, x


@functools.lru_cache(maxsize=None)
def jax_apply(dtype):
    """The JAX forward of the mini cfg in `dtype`, jitted once (folded and
    unfolded variables share the compile)."""
    return jax.jit(functools.partial(
        JM.YoloFace(spec=mini()[0], dtype=dtype).apply, train=False))


@functools.lru_cache(maxsize=None)
def jax_raws(folded: bool, dtype=jnp.float32):
    _, _, variables, x = mini()
    v = j_fold_bn(variables) if folded else variables
    return [np.asarray(r, np.float32)
            for r in jax_apply(dtype)(v, jnp.asarray(x, dtype))]


def port_net(fold: bool):
    _, spec_t, variables, _ = mini()
    net = TM.YoloFace(spec_t)
    net.load_state_dict(jax_to_state_dict(variables))
    if fold:
        fold_bn(net)
    return net.eval()


def assert_raws(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, **RAW_TOL)


def test_mini_cfg_has_every_extra_op():
    ops = {row[2] for row in MINI_CFG["backbone"] + MINI_CFG["head"]}
    extra = json.loads(EXTRA_CFG.read_text())
    full_ops = {row[2] for row in extra["backbone"] + extra["head"]}
    assert EXTRA_OPS <= ops and EXTRA_OPS <= full_ops


@pytest.mark.parametrize("fold", [False, True])
def test_mini_cfg_matches_jax(fold):
    """Raw maps and decoded rows, unfolded and folded, on a non-square
    input."""
    spec_j, spec_t, _, x = mini()
    want = jax_raws(fold)
    with torch.no_grad():
        got = port_net(fold)(torch.from_numpy(x))
    assert_raws(got, want)
    np.testing.assert_allclose(
        decode(got, spec_t).numpy(),
        np.asarray(j_decode([jnp.asarray(w) for w in want], spec_j)),
        **ROW_TOL)


def test_fold_matches_jax_fold_bn():
    """The port's folded weights against the JAX `fold_bn` output: a BN
    folded into its conv (ConvBN, CrossConv's cv2) gives the JAX folded
    kernel and, as the conv's bias, the JAX BN's folded bias; a
    concat-fed BN (MixConv2d's, the CSP blocks', SPPCSP's) the JAX
    precomputed affine."""
    _, _, variables, _ = mini()
    want = jax_to_state_dict(j_fold_bn(variables))
    got = port_net(True).state_dict()
    checked = 0
    for key, value in got.items():
        if key.endswith("num_batches_tracked"):
            continue
        partner = key
        if key not in want:
            # a folded conv's bias: the JAX BN beside it holds it
            partner = re.sub(r"conv\.bias$", "bn.bias", key)
        np.testing.assert_allclose(value.numpy(), want[partner].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
        checked += 1
    assert checked > 100
    concat_fed = [k for k in got if k.endswith("bn.running_var")]
    # MixConv2d's, SPPCSP's, BottleneckCSP2's and BottleneckCSPF's
    assert len(concat_fed) == 4
    for key in concat_fed:
        np.testing.assert_allclose(got[key].numpy(), 1 - 1e-3, rtol=1e-7)


def test_fused_mini_cfg_matches_jax():
    """The fused executor (two groups, each through fused_elan's plain
    version on the CPU; Sum and the extra blocks between them through
    the model's own modules) against JAX fused_apply with its Pallas
    kernel in interpret mode, and against the JAX unfused forward."""
    spec_j, spec_t, variables, x = mini()
    jblocks = JF.find_elan_blocks(spec_j)
    blocks = TF.find_elan_blocks(spec_t)
    assert len(blocks) == len(jblocks) == 2
    assert [(b.start, b.trans) for b in blocks] == [(3, 8), (13, 18)]
    fused_j = jax.jit(lambda v, inp: JF.fused_apply(
        spec_j, v, inp, blocks=jblocks, interpret=True))
    want = [np.asarray(r) for r in fused_j(j_fold_bn(variables),
                                           jnp.asarray(x))]
    with torch.no_grad():
        got = TF.fused_apply(port_net(True), torch.from_numpy(x), blocks)
    assert_raws(got, want)
    assert_raws(got, jax_raws(True))


def test_bf16_mini_cfg_matches_jax():
    """The port's bf16 serving model (folded, then models/model.cast_model)
    against the JAX YoloFace(dtype=bfloat16) on the folded variables:
    each level within 2e-2 of max |JAX float32 raw|; Sum's weight stays
    float32, so the weighted sum (and the conv after it) sees float32 as
    in JAX."""
    _, _, _, x = mini()
    net = TM.cast_model(port_net(True), torch.bfloat16)
    assert net.model[31].w.dtype == torch.float32
    with torch.no_grad():
        got = net(torch.from_numpy(x).to(torch.bfloat16))
    want = jax_raws(True, jnp.bfloat16)
    ref32 = jax_raws(True)
    for g, w, r in zip(got, want, ref32):
        share = float(np.abs(g.float().numpy() - w).max() / np.abs(r).max())
        assert share < BF16_REL, share


def test_int8_raises_naming_the_op_in_both_packages():
    """Neither int8 walker has an extra op: the JAX structural walk and
    the port's FaceDetector(quantize="int8") raise NotImplementedError
    naming the first one (the ConvFocus stem)."""
    spec_j, spec_t, variables, _ = mini()
    with pytest.raises(NotImplementedError, match="ConvFocus"):
        JQ.calibrate_shape_only(spec_j, variables)
    with pytest.raises(NotImplementedError, match="ConvFocus"):
        FaceDetector(spec_t, variables=variables, quantize="int8",
                     device="cpu")
    with pytest.raises(NotImplementedError, match="ConvFocus"):
        TQ.calibrate_shape_only(spec_t, port_net(False))


def test_state_dict_round_trip():
    """Every JAX leaf of the mini cfg lands in one state-dict entry of the
    port model's keys and shapes (reference names: `m.tr.{i}`,
    `ma.out_proj`, `conv.{0,2}` / `shortcut.{0,1}`, `cv2.conv` of
    CrossConv, `m.{g}` of MixConv2d, Sum's `model.31.w`), and
    state_dict_to_jax(model=) maps it back value for value."""
    _, spec_t, variables, _ = mini()
    state = jax_to_state_dict(variables)
    net = TM.YoloFace(spec_t)
    want = net.state_dict()
    assert sorted(state) == sorted(want)
    for key, v in state.items():
        assert v.shape == want[key].shape, key
    for key in ("model.31.w", "model.20.m.tr.1.ma.out_proj.weight",
                "model.20.m.tr.0.q.weight", "model.20.m.linear.bias",
                "model.9.conv.0.cv1.conv.weight", "model.9.shortcut.1.bn.bias",
                "model.10.cv2.conv.weight", "model.10.cv2.bn.running_var",
                "model.1.m.1.weight", "model.0.conv_slice.conv.weight"):
        assert key in state, key
    back = state_dict_to_jax(state, model=net)
    flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(variables)}
    flat_back = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_leaves_with_path(back)}
    assert sorted(flat) == sorted(flat_back)
    for key, v in flat.items():
        np.testing.assert_array_equal(flat_back[key], v, err_msg=key)


def test_extra_cfg_builds_in_both_packages():
    """tests/data/yolov7s-face-extra.json (the card's extra cfg: yolov7s-
    face at full width with extra ops in its nodes) parses alike in both
    packages, and the JAX variables of its structure carry into the port
    model key for key and shape for shape; 8 E-ELAN groups stay intact."""
    cfg = json.loads(EXTRA_CFG.read_text())
    spec_j = JS.spec_from_yolo_yaml(cfg, "yolov7s-face-extra")
    spec_t = TS.spec_from_yolo_yaml(cfg, "yolov7s-face-extra")
    assert [(n.op, n.c1, n.c2, n.f) for n in spec_t.nodes] == \
        [(n.op, n.c1, n.c2, n.f) for n in spec_j.nodes]
    abstract = jax.eval_shape(
        functools.partial(JM.YoloFace(spec=spec_j).init, train=False),
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    net = TM.YoloFace(spec_t)
    want = {k: v.shape for k, v in net.state_dict().items()}
    got = {k: v.shape for k, v in jax_to_state_dict(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                     abstract)).items()}
    assert got == want
    assert len(TF.find_elan_blocks(spec_t)) == \
        len(JF.find_elan_blocks(spec_j)) == 8
    assert TM.compute_strides(spec_t) == (8, 16, 32)


def test_reference_in_projection_raises_naming_the_key():
    """A reference TransformerLayer's nn.MultiheadAttention in-projection
    has no place in the JAX package's layer (nor the port's): loading it
    raises naming the key instead of dropping it."""
    net = port_net(False)
    state = dict(net.state_dict())
    key = "model.20.m.tr.0.ma.in_proj_weight"
    state[key] = torch.zeros(3 * 16, 16)
    with pytest.raises(ValueError, match=re.escape(key)):
        load_reference_state_dict(net, state)


# ---------------------------------------------------------------------------
# one train micro-step
# ---------------------------------------------------------------------------

class ExtraCase(TSTEP.Case):
    """tests/test_torch_train_step.Case on the mini cfg at its 64 px, batch
    4 (the JAX step in float64)."""

    def __init__(self):
        self.x64 = True
        self.jspec = JS.spec_from_yolo_yaml(MINI_CFG, "mini-extra")
        self.tspec = TS.spec_from_yolo_yaml(MINI_CFG, "mini-extra")
        self.variables = mini()[2]
        self.batches = TSTEP.batches(self.jspec, 1, seed=7)
        self.jvariables = jax.tree.map(lambda v: np.asarray(v, np.float64),
                                       self.variables)
        with self.jax():
            self.jmodel = JM.YoloFace(spec=self.jspec, dtype=np.float64)
            zero = JR.TrainConfig(**dict(TSTEP.CFG, lr0=0.0),
                                  warmup_bias_lr=0.0, weight_decay=0.0)
            self._grad_step = JR.make_train_step(self.jmodel, zero,
                                                 TSTEP.HYP, TSTEP.SIZE)
        self._compiled = {}


def test_train_step_matches_jax():
    """One SGD make_train_step in warmup through every extra op: the loss
    and its components, every parameter (Sum's `w`, the attention's
    Linear weights, decayed as kernels), the BN statistics and the EMA
    against the JAX step's."""
    c = ExtraCase()
    cfg_kw = dict(TSTEP.CFG, optimizer="sgd")
    step = 2
    moments = c.moments(step)
    loss_j, comps_j, grads, stats = c.jax_grads(0)
    new_p, new_ema = c.jax_apply(cfg_kw, c.jvariables["params"], grads,
                                 moments, step, step)
    net = c.port()
    state = TSTEP.port_state(net, moments, "sgd", step)
    images, labels = c.batches[0]
    state, loss, comps = TR.make_train_step(
        net, TR.TrainConfig(**cfg_kw), TSTEP.HYP, TSTEP.SIZE)(
        state, images, TSTEP.targets_of(c.jspec, labels))
    np.testing.assert_allclose(float(loss), loss_j, rtol=STEP_LOSS_RTOL)
    np.testing.assert_allclose(comps.numpy(), comps_j, rtol=STEP_LOSS_RTOL,
                               atol=1e-7)
    TSTEP.assert_state(net, state.ema_params, new_p, stats, new_ema)
    assert TR._param_group("model.20.m.tr.0.q.weight",
                           net.model[20].m.tr[0].q.weight) == "kernel"
    assert TR._param_group("model.31.w", net.model[31].w) == "other"
