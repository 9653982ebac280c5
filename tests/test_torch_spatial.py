"""The port's spatial mesh (parallel/mesh.make_spatial_mesh,
spatial_input_sharding, spatial_infer; the halo exchanges of
parallel/spatial.py) on the CPU: one world of 4 gloo ranks, spawned once
for the module (its work in tests/torch_spatial_ranks.py), splits one
image's plane over (2, 2), (1, 4) and (4, 1) grids while this process
computes the references.

- (a) lite-t at 256 px over (2, 2) against the JAX spatial_infer over a
  4-device (2, 2) mesh and the JAX one-device forward with decode, atol
  2e-4 (tests/test_spatial_sharding.py's), and the port's one-process
  forward.
- (b) w6, narrowed, at 192 px over (2, 2) (96-px shards) and (1, 4)
  (48-px shards: 0.75 of a stride-64 cell, and at P6 one rank owns no
  column), against the JAX one-device forward at rtol 1e-4 / atol 1e-4
  (__graft_entry__.py's); (c) with the NMS as the postprocess
  (max_candidates 512, max_det 50), keepers against the JAX ones at atol
  1e-3 (boxes) and 1e-4 (scores), every rank the same Detections.
- (d) the other zoo models and the extra cfg, narrowed, at 160 px over
  (2, 2) (P5 splits 2 / 3), against the port's one-process forward at
  atol 2e-4: StemBlock's ceil_mode pool, depthwise, CrossConv and
  MixConv2d kernels, Contract / Expand, C3TR's attention on the gathered
  plane.
- (e) a 1x1 grid without a process group is bit-equal to forward and
  decode.
- (f) a module without a spatial form raises NotImplementedError naming
  it, on every rank, before anything is exchanged.
- (g) single ops (convs of every geometry the zoo uses, pools with and
  without ceil_mode, upsample, zero pad, reorg, Focus, contract, expand,
  a global op) on odd and even planes over every grid, against the
  one-process op; each rank's received blocks and halo bytes equal what
  the partition's geometry requires, counted here by brute force over
  each output's receptive field."""

import concurrent.futures
import functools
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.models.head import decode as j_decode
from face_detection_multi_scale_tpu.ops import nms as JN
from face_detection_multi_scale_tpu.parallel.mesh import (
    make_spatial_mesh as j_make_spatial_mesh, spatial_infer as j_spatial_infer)
from face_detection_multi_scale_tpu_torch.models.head import decode
from face_detection_multi_scale_tpu_torch.models.model import full_fp32
from face_detection_multi_scale_tpu_torch.ops import nms as TN
from face_detection_multi_scale_tpu_torch.parallel import mesh as PM
from face_detection_multi_scale_tpu_torch.parallel.mesh import split_extent

import torch_spatial_ranks as RANKS
from test_torch_model import narrowed, random_variables

WORLD = 4
JAX_ATOL = 2e-4            # tests/test_spatial_sharding.py:39
W6_TOL = dict(rtol=1e-4, atol=1e-4)   # __graft_entry__.py:230
BOX_ATOL, SCORE_ATOL = 1e-3, 1e-4     # tests/test_spatial_sharding.py:66-67
PORT_ATOL = 2e-4
CONV_ATOL = 1e-5  # a conv on a block against the plane: sums reordered


@functools.lru_cache(maxsize=None)
def inputs():
    """The specs and frames (no JAX work), as the ranks make them."""
    return {"lite_j": JZ.get_spec("yolov7-lite-t"),
            "w6_j": narrowed(JZ, "yolov7-w6-face"),
            "lite_spec": RANKS.lite_spec(),
            "lite_x": RANKS.images(RANKS.LITE_SIZE, RANKS.LITE_SEED),
            "w6_spec": RANKS.narrowed("yolov7-w6-face"),
            "w6_x": RANKS.images(RANKS.W6_SIZE, RANKS.W6_SEED)}


@functools.lru_cache(maxsize=None)
def weights():
    """The JAX variables of lite-t and of the narrowed w6, from numpy
    seeds."""
    x = inputs()
    return {"lite_vars": random_variables(x["lite_j"], seed=0),
            "w6_vars": random_variables(x["w6_j"], seed=1)}


@pytest.fixture(scope="module")
def world():
    """The 4 ranks' results (RANKS.rank_main), started at the first use and
    run beside this process's references; the ranks take the JAX
    variables from a queue once this process has made them, after their
    port-only cases."""
    box = mp.get_context("spawn").Queue()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(PM.run_ranks, RANKS.rank_main, WORLD, (box,),
                         timeout=240.0)
    for _ in range(WORLD):
        box.put(weights())
    yield future
    pool.shutdown()


def ranks(world):
    return world.result()


def one_process(net, x_u8):
    """The port's one-process forward and decode of uint8 NHWC frames."""
    with torch.inference_mode(), full_fp32():
        return decode(net(torch.as_tensor(x_u8).float() / 255.0), net.spec)


def jax_rows(spec, variables, x_u8):
    """The JAX one-device forward with decode (jitted with XLA's backend
    optimizations off, as the NMS below: half the compile)."""
    def fwd(v, x):
        return j_decode(JM.YoloFace(spec=spec).apply(
            v, x.astype(jnp.float32) / 255.0, train=False), spec)

    x = jnp.asarray(x_u8)
    return np.asarray(jax.jit(fwd).lower(variables, x).compile(
        compiler_options={"xla_backend_optimization_level": 0})(
            variables, x))


@pytest.fixture(scope="module")
def refs(world):
    """This process's JAX references, computed while the ranks run: lite-t
    through the JAX spatial_infer over a 4-device mesh and one device; w6
    on one device, and its NMS."""
    x = {**inputs(), **weights()}
    jmodel = JM.YoloFace(spec=x["lite_j"])
    lite_mesh = np.asarray(j_spatial_infer(
        jmodel, x["lite_vars"], x["lite_x"],
        j_make_spatial_mesh(jax.devices()[:WORLD])))
    w6 = jax_rows(x["w6_j"], x["w6_vars"], x["w6_x"])
    nms = jax.jit(functools.partial(JN.non_max_suppression, nc=1, nkpt=5,
                                    **RANKS.NMS_KW))
    dets = nms.lower(w6).compile(compiler_options={
        "xla_backend_optimization_level": 0})(w6)
    return {"lite_mesh": lite_mesh,
            "lite_one": jax_rows(x["lite_j"], x["lite_vars"], x["lite_x"]),
            "w6": w6, "w6_dets": JN.detections_to_numpy(dets)[0]}


def test_lite_matches_jax_spatial_and_one_device(world, refs):
    x = {**inputs(), **weights()}
    got_j, want_1 = refs["lite_mesh"], refs["lite_one"]
    one = one_process(RANKS.bridged_model(x["lite_spec"], x["lite_vars"]),
                      x["lite_x"]).numpy()
    results = ranks(world)
    for r in results[1:]:
        assert np.array_equal(r["lite"], results[0]["lite"])
    got = results[0]["lite"]
    assert got.shape == got_j.shape == want_1.shape == one.shape
    for want in (got_j, want_1):
        np.testing.assert_allclose(got, want, atol=JAX_ATOL)
    np.testing.assert_allclose(got, one, atol=PORT_ATOL)


def test_grids_follow_the_jax_rule(world):
    """make_spatial_mesh over 4 ranks: (2, 2) by the JAX rule, (1, 4) and
    (4, 1) by `rows`, row-major over the ranks; a rank's neighbours on
    the (2, 2) grid."""
    for rank, r in enumerate(ranks(world)):
        assert r["shapes"] == {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
        assert r["coords"] == {"2x2": divmod(rank, 2), "1x4": (0, rank),
                               "4x1": (rank, 0)}
        row, col = divmod(rank, 2)
        assert r["neighbours"] == {
            "up": rank - 2 if row else None,
            "down": None if row else rank + 2,
            "left": rank - 1 if col else None,
            "right": None if col else rank + 1}
    assert j_make_spatial_mesh(jax.devices()[:WORLD]).devices.shape == (2, 2)


@pytest.mark.parametrize("grid", ["2x2", "1x4"])
def test_w6_unaligned_shards_match_jax(world, refs, grid):
    want = refs["w6"]
    results = ranks(world)
    got, n = results[0]["w6"][grid]
    for r in results[1:]:
        assert np.array_equal(r["w6"][grid][0], got)
    assert all(r["w6"][grid][1] > 0 for r in results[1:])  # halos moved
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **W6_TOL)


@pytest.mark.parametrize("grid", ["2x2", "1x4"])
def test_w6_nms_postprocess_matches_jax(world, refs, grid):
    want = refs["w6_dets"]
    results = ranks(world)
    fields = results[0]["w6_nms"][grid]
    for r in results[1:]:
        assert all(np.array_equal(a, b)
                   for a, b in zip(r["w6_nms"][grid], fields))
    got = TN.detections_to_numpy(TN.Detections(
        *(torch.from_numpy(f) for f in fields)))[0]
    assert got.shape == want.shape and len(got) > 0
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=BOX_ATOL)
    np.testing.assert_allclose(got[:, 4], want[:, 4], atol=SCORE_ATOL)


@pytest.mark.parametrize("name", list(RANKS.ZOO))
def test_zoo_models_match_one_process(world, name):
    seed = RANKS.ZOO[name]
    want = one_process(RANKS.seeded_model(RANKS.zoo_spec(name), seed),
                       RANKS.images(RANKS.ZOO_SIZE, seed)).numpy()
    results = ranks(world)
    for r in results[1:]:
        assert np.array_equal(r["zoo"][name], results[0]["zoo"][name])
    got = results[0]["zoo"][name]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=PORT_ATOL)


@pytest.mark.parametrize("name", ["yolov7-lite-t", "yolov7-w6-face"])
def test_one_by_one_grid_is_the_one_process_forward(name):
    """Without a process group: a 1x1 grid, bit-equal to forward and
    decode (and with the NMS as the postprocess, to its Detections)."""
    x = {**inputs(), **weights()}
    spec, variables, frames = (
        (x["lite_spec"], x["lite_vars"], x["lite_x"]) if name.endswith("t")
        else (x["w6_spec"], x["w6_vars"], x["w6_x"]))
    net = RANKS.bridged_model(spec, variables)
    mesh = PM.make_spatial_mesh()
    assert mesh.shape == (1, 1) and mesh.group is None
    before = PM.spatial_infer.calls
    got = PM.spatial_infer(net, frames, mesh)
    want = one_process(net, frames)
    assert torch.equal(got, want)
    dets = PM.spatial_infer(net, frames, mesh, postprocess=RANKS.post)
    assert all(torch.equal(a, b) for a, b in zip(dets, RANKS.post(want)))
    assert PM.spatial_infer.calls == before + 2
    with pytest.raises(ValueError):
        PM.make_spatial_mesh([0, 1])


@pytest.mark.parametrize("case,where", [("torch_maxpool", "model.1"),
                                        ("torch_conv",
                                         "model.0.stem_1.conv")])
def test_module_without_spatial_form_raises(world, case, where):
    for r in ranks(world):
        msg = r["unknown"][case]
        assert msg is not None and where in msg, msg
        assert ("MaxPool2d" if case == "torch_maxpool" else "Conv2d") in msg


def _reads(kind, prm, axis, o):
    """The input indices that output o reads along `axis` (0: H, 1: W)."""
    if kind == "conv":
        k, s, p, d = (prm[key][axis] for key in "kspd")
        return {o * s - p + t * d for t in range(k)}
    if kind == "pool":
        return {o * prm["s"] - prm["p"] + t for t in range(prm["k"])}
    if kind == "pad":
        before = prm["pads"][2] if axis == 0 else prm["pads"][0]
        return {o - before}
    if kind == "fold":
        return {o * prm["g"] + t for t in range(prm["g"])}
    if kind == "repeat":
        return {o // prm["g"]}
    raise AssertionError(kind)


def expected_halo(kind, prm, shape, out_shape, grid, rank, itemsize=4):
    """(blocks received, bytes) of `rank` for one op: the rows in the
    span of those its outputs read that it does not own, with its own
    columns, then the columns in the span it does not own, with the rows
    of the span; in-plane indices only."""
    if kind == "global":
        return 0, 0
    rows, cols = grid
    coords = divmod(rank, cols)
    c = shape[0]
    read, owned, owners = [], [], []
    for axis, (n, e, eo) in enumerate(zip(grid, shape[1:], out_shape[2:])):
        k = coords[axis]
        lo, hi = split_extent(eo, n, k)
        # the span of the inputs that the outputs read, in the plane
        reads = set()
        for o in range(lo, hi):
            reads |= _reads(kind, prm, axis, o)
        need = (set(range(min(reads), max(reads) + 1)) & set(range(e))
                if reads else set())
        parts = [set(range(*split_extent(e, n, j))) for j in range(n)]
        read.append(need)
        owned.append(parts[k])
        owners.append(sum(1 for j in range(n) if j != k and need & parts[j]))
    recv_h = len(read[0] - owned[0]) * len(owned[1]) * c
    recv_w = len(read[1] - owned[1]) * len(read[0]) * c
    blocks = (owners[0] if len(owned[1]) else 0) + \
        (owners[1] if len(read[0]) else 0)
    return blocks, (recv_h + recv_w) * itemsize


@pytest.mark.parametrize("name", [c[0] for c in RANKS.OP_CASES])
def test_single_ops_and_halo_bytes(world, name):
    _, kind, prm, shape = next(c for c in RANKS.OP_CASES if c[0] == name)
    mod = RANKS.op_module(kind, prm, shape[0]).eval()
    with torch.no_grad():
        want = mod(RANKS.op_input(shape)).numpy()
    results = ranks(world)
    for grid, rows in RANKS.GRIDS.items():
        g = (rows, WORLD // rows)
        for rank, r in enumerate(results):
            got, blocks, nbytes = r["ops"][(name, grid)]
            assert got.shape == want.shape, (grid, rank)
            if kind == "conv":
                np.testing.assert_allclose(got, want, atol=CONV_ATOL)
            else:
                assert np.array_equal(got, want), (grid, rank)
            assert (blocks, nbytes) == expected_halo(
                kind, prm, shape, want.shape, g, rank), (grid, rank)
    # halos move on some grid, except for a global op (gathered whole)
    moved = [r["ops"][(name, grid)][2] for r in results for grid in
             RANKS.GRIDS]
    assert (max(moved) == 0) == (kind == "global")
