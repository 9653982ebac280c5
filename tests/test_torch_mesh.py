"""The port's data-parallel mesh (parallel/mesh.py, one process a card)
against the JAX package's 4-device mesh and the port's one-process run,
on the CPU: one world of 4 gloo ranks (spawned once for the module, its
work in tests/torch_mesh_ranks.py) serves and trains while this process
computes the references.

- Serving: FaceDetector("yolov7-lite-t", mesh=make_data_mesh()) on 11
  frames (padded to 12); every rank returns the same 11 Detections, equal
  within atol 1e-4 (tests/test_sharded_inference.py's) to the JAX
  detector over a 4-device mesh and to the port's one-process detector;
  the "inert under a mesh" warning fires once a detector.
- Training: lite-t at 64 px, global batch 8 (2 rows a rank), 3 steps of
  make_train_step and one make_accum_steps pair (2 micro-batches and an
  apply), against the one-process steps on the global batches: losses
  rtol 1e-5, parameters rtol 2e-3 / atol 1e-4, BN running statistics
  after one step rtol 1e-4 / atol 1e-6 (tests/test_multidevice_training.
  py's); the first step against the JAX step at
  tests/test_torch_train_step.py's tolerances; parameters bit-identical
  across ranks. The control: BatchNorm on each rank's own rows moves the
  running statistics by more than 1e-2 from the global batch's.
- Every caller of run_network (the single-scale, pyramid, tiled, batch
  and predict entry points) gives every rank the one-process arrays.
- Rank 0 alone writes checkpoints; cli.train.train_run over the first 2
  ranks (global batch 2; ranks 2 and 3 sit it out) writes results.txt
  once, and both ranks end with equal parameters, within the sharded-step
  parameter tolerance of train_run in one process."""

import concurrent.futures
import functools

import jax
import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.infer.detector import (
    FaceDetector as JFaceDetector)
from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.ops.nms import (
    detections_to_numpy as j_detections_to_numpy)
from face_detection_multi_scale_tpu.parallel.mesh import (
    make_data_mesh as j_make_data_mesh)
from face_detection_multi_scale_tpu.train import targets as JT
from face_detection_multi_scale_tpu.train import trainer as JR
from face_detection_multi_scale_tpu.train.hyp import HYP_SCRATCH_P6
from face_detection_multi_scale_tpu_torch.infer.detector import FaceDetector
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.ops import nms as TN
from face_detection_multi_scale_tpu_torch.parallel import mesh as PM

import torch_mesh_ranks as RANKS
from torch_shared import MESH_BN_TOL, MESH_LOSS_RTOL, MESH_PARAM_TOL
from test_torch_model import random_variables
from test_torch_train_step import (BN_MEAN_ATOL, BN_RTOL, LOSS_RTOL,
                                   PARAM_TOL, _jax_apply, packed,
                                   torch_tree, train_state, unpacked)

WORLD = 4
SIZE, BS = 64, 8
SERVE_FRAMES = 11
CFG = dict(epochs=10, steps_per_epoch=3, lr0=0.01, warmup_epochs=0.0,
           min_warmup_steps=4, batch_size=BS)
HYP = dict(HYP_SCRATCH_P6)
SHARDED_LOSS_RTOL = MESH_LOSS_RTOL
SHARDED_PARAM_TOL = MESH_PARAM_TOL
SHARDED_BN_TOL = MESH_BN_TOL
PER_SHARD_GAP = 1e-2
DET_ATOL = 1e-4


def global_batches(spec, n, seed):
    """n global (uint8 images, targets) batches of BS: 1-3 faces an image,
    5 landmarks each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        images = rng.integers(0, 256, (BS, SIZE, SIZE, 3), np.uint8)
        rows = []
        for b in range(BS):
            k = int(rng.integers(1, 4))
            xy = rng.uniform(0.25, 0.75, (k, 2))
            wh = rng.uniform(0.1, 0.45, (k, 2))
            kpt = xy[:, None] + rng.uniform(-0.1, 0.1, (k, 5, 2))
            rows.append(np.concatenate([np.full((k, 1), b), np.zeros((k, 1)),
                                        xy, wh, kpt.reshape(k, 10)], 1))
        labels = np.concatenate(rows).astype(np.float32)
        out.append((images, JT.build_targets_batched(
            labels, BS, spec, [(SIZE // s, SIZE // s)
                               for s in spec.strides])))
    return out


def train_sets():
    """train_run's in-memory sets: (seed, train images, validation
    images, size, stride) of RANKS.memory_sets."""
    return (5, 4, 2, SIZE, TZ.get_spec("yolov7-lite-t").max_stride)


def cli_args(project) -> list:
    """train_run's arguments: lite-t, global batch 2 (1 row a rank over
    2 ranks), 2 micro-batches an apply, one epoch."""
    return ["--model", "yolov7-lite-t", "--data", "in-memory",
            "--img-size", str(SIZE), "--batch-size", "2",
            "--nominal-batch", "4", "--epochs", "1",
            "--val-batch-size", "2", "--min-warmup-steps", "1",
            "--project", str(project), "--name", "run", "--noautoanchor",
            "--no-tensorboard", "--workers", "1", "--device", "cpu"]


def one_process_train_run(project) -> dict:
    """cli.train.train_run of cli_args in this process: the final model's
    state dict as numpy arrays."""
    RANKS.TCLI.train_run(RANKS.TCLI.parse_args(cli_args(project)),
                         datasets=RANKS.memory_sets(*train_sets()),
                         quiet=True)
    return RANKS.host(RANKS.TCLI.train_run.last["state"].model)


@functools.lru_cache(maxsize=None)
def inputs():
    jspec = JZ.get_spec("yolov7-lite-t")
    frames = np.random.default_rng(0).integers(
        0, 256, (SERVE_FRAMES, SIZE, SIZE, 3), np.uint8)
    batches = global_batches(jspec, 5, seed=7)
    return {"jspec": jspec, "tspec": TZ.get_spec("yolov7-lite-t"),
            "serve_variables": random_variables(jspec, seed=2),
            "train_variables": random_variables(jspec, seed=3),
            "frames": frames, "batches": batches[:3],
            "images": list(np.random.default_rng(1).integers(
                0, 256, (3, 100, 120, 3), np.uint8)),
            "accum_batches": batches[3:]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4 ranks' results (RANKS.rank_main), started at the first use and
    run beside this process's references; the run's directory."""
    tmp = tmp_path_factory.mktemp("mesh")
    x = inputs()
    payload = {
        "variables": x["serve_variables"], "frames": x["frames"],
        "images": x["images"],
        "spec": x["tspec"], "train_variables": x["train_variables"],
        "cfg": CFG, "hyp": HYP, "size": SIZE, "batches": x["batches"],
        "accum_batches": x["accum_batches"], "tmp": tmp,
        "sets": train_sets(), "cli": cli_args(tmp)}
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(PM.run_ranks, RANKS.rank_main, WORLD, (payload,),
                         timeout=240.0)
    yield future, tmp
    pool.shutdown()


@pytest.fixture(scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def refs(world, one_torch_thread, tmp_path_factory):
    """This process's references, computed while the ranks run: the JAX
    4-device mesh detector's and the port's one-process detector's
    Detections, the one-process callers' arrays, the port's one-process
    steps, train_run and the JAX step."""
    x = inputs()
    kw = dict(img_sizes=(SIZE,), conf_thres=0.05, max_det=50)
    jdet = JFaceDetector("yolov7-lite-t", variables=x["serve_variables"],
                         mesh=j_make_data_mesh(jax.devices()[:WORLD]), **kw)
    one = FaceDetector("yolov7-lite-t", variables=x["serve_variables"],
                       device="cpu", **kw)
    train = (x["tspec"], x["train_variables"], CFG, HYP, SIZE)
    return {
        "serve_jax": j_detections_to_numpy(jdet.run_network(x["frames"])),
        "serve_one": TN.detections_to_numpy(one.run_network(x["frames"])),
        "callers": RANKS.callers(x["serve_variables"], x["images"]),
        "steps": RANKS.train_steps(*train, x["batches"], None),
        "accum": RANKS.accumulated(*train, x["accum_batches"], None),
        "train_run": one_process_train_run(tmp_path_factory.mktemp("one")),
        "jax": jax_first_step()}


def ranks(world):
    return world[0].result()


def assert_close_trees(got, want, what, **tol):
    assert set(got) == set(want), what
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            assert got[key] == w, (what, key)
            continue
        np.testing.assert_allclose(got[key], w, err_msg=f"{what} {key}",
                                   **tol)


def bn_keys(tree):
    return [k for k in tree if k.endswith(("running_mean", "running_var"))]


def test_serving_matches_jax_mesh_and_one_process(world, refs):
    want_jax, want_one = refs["serve_jax"], refs["serve_one"]
    results = ranks(world)
    fields = [r["serve"][0] for r in results]
    for got in fields[1:]:  # every rank returns the same Detections
        assert all(np.array_equal(a, b) for a, b in zip(got, fields[0]))
    got = TN.detections_to_numpy(TN.Detections(
        *(torch.from_numpy(f) for f in fields[0])))
    assert len(got) == len(want_jax) == len(want_one) == SERVE_FRAMES
    assert sum(len(g) for g in got) > SERVE_FRAMES
    for want in (want_jax, want_one):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=DET_ATOL)
    for r in results:
        _, inert, report = r["serve"]
        assert inert == 1
        assert report["images"] == 2 * SERVE_FRAMES


def test_every_caller_of_run_network_under_a_mesh(world, refs):
    """detect_single_scale, detect_multi_scale, detect_multi_scale_batch
    (its 128 scale tiled: one batch of 12 tiles over the 4 ranks, the
    telemetry one entry an image), detect_batch and predict under the
    mesh give every rank the one-process detector's arrays within atol
    1e-4."""
    want, report = refs["callers"]
    for r in ranks(world):
        got, got_report = r["callers"]
        assert got_report == report
        assert len(got) == len(want) == 2 + 3 * len(inputs()["images"])
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=DET_ATOL)
    assert sum(len(w) for w in want) > 0


def test_training_matches_one_process(world, refs):
    want = refs
    results = ranks(world)
    for r in results[1:]:  # bit-identical across ranks
        for a, b in ((r["steps"][2], results[0]["steps"][2]),
                     (r["accum"][1], results[0]["accum"][1])):
            assert all(np.array_equal(a[k], b[k]) for k in b)
    got = results[0]
    losses = [loss for loss, _ in got["steps"][0]]
    np.testing.assert_allclose(losses, [loss for loss, _ in
                                        want["steps"][0]],
                               rtol=SHARDED_LOSS_RTOL)
    for (_, c), (_, w) in zip(got["steps"][0], want["steps"][0]):
        np.testing.assert_allclose(c, w, rtol=SHARDED_LOSS_RTOL, atol=1e-7)
    first, first_want = got["steps"][1], want["steps"][1]
    keys = bn_keys(first_want)
    assert keys
    assert_close_trees({k: first[k] for k in keys},
                       {k: first_want[k] for k in keys},
                       "BN after one step", **SHARDED_BN_TOL)
    assert_close_trees(got["steps"][2], want["steps"][2], "after 3 steps",
                       **SHARDED_PARAM_TOL)
    np.testing.assert_allclose(got["accum"][0], want["accum"][0],
                               rtol=SHARDED_LOSS_RTOL)
    assert_close_trees(got["accum"][1], want["accum"][1],
                       "after the accumulated apply", **SHARDED_PARAM_TOL)


def jax_first_step():
    """The JAX package's step on the first global batch from the same
    weights (lr 0 gives the gradient, then its optimizer and EMA apply):
    (loss, components, the new params and BN statistics as a port state
    dict)."""
    x = inputs()
    params = x["train_variables"]["params"]
    model = JM.YoloFace(spec=x["jspec"])
    zero = JR.TrainConfig(**dict(CFG, lr0=0.0), warmup_bias_lr=0.0,
                          weight_decay=0.0)
    args = (train_state(params, x["train_variables"]["batch_stats"]),
            *x["batches"][0])
    # XLA's backend optimizations off halve the compile of this one call
    new, loss, comps = JR.make_train_step(model, zero, HYP, SIZE).lower(
        *args).compile(compiler_options={
            "xla_backend_optimization_level": 0})(*args)
    grads = jax.tree.map(np.asarray, new.momentum_buf)
    zeros = jax.tree.map(np.zeros_like, params)
    state = train_state(packed(params), {}, momentum_buf=packed(zeros))
    new_p, _ = _jax_apply(tuple(sorted(CFG.items())))(
        state, packed(grads), np.int32(0))
    stats = jax.tree.map(np.asarray, new.batch_stats)
    tree = torch_tree(unpacked(new_p, params), stats)
    return float(loss), np.asarray(comps), {k: v.numpy()
                                            for k, v in tree.items()}


def test_training_matches_jax(world, refs):
    loss_j, comps_j, want = refs["jax"]
    (loss, comps), first = ranks(world)[0]["steps"][0][0], \
        ranks(world)[0]["steps"][1]
    np.testing.assert_allclose(loss, loss_j, rtol=LOSS_RTOL)
    np.testing.assert_allclose(comps, comps_j, rtol=LOSS_RTOL, atol=1e-7)
    checked = 0
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                first[key], w, rtol=BN_RTOL, err_msg=key,
                atol=BN_MEAN_ATOL if key.endswith("mean") else 0.0)
        else:
            np.testing.assert_allclose(first[key], w, err_msg=key,
                                       **PARAM_TOL)
        checked += 1
    assert checked == sum(not k.endswith("num_batches_tracked")
                          for k in first)


def test_per_shard_batchnorm_control(world, refs):
    """BatchNorm on each rank's own rows (the fault SyncBN semantics
    prevent) moves the running statistics by more than 1e-2 from the
    global batch's: the training tests above can see that fault."""
    want = refs["steps"][1]
    gaps = [max(float(np.abs(r["per_shard_bn"][k] - want[k]).max())
                for k in bn_keys(want)) for r in ranks(world)]
    assert min(gaps) > PER_SHARD_GAP, gaps


def test_only_rank_zero_writes(world):
    results = ranks(world)
    assert results[0]["gate_files"] == ["best.meta.json", "best.pt",
                                        "last.meta.json", "last.pt"]
    assert all(r["gate_files"] == [] for r in results[1:])
    tmp = world[1]
    run = tmp / "run"
    assert sorted(p.name for p in tmp.iterdir() if p.name.startswith(
        "run")) == ["run"]
    lines = (run / "results.txt").read_text().splitlines()
    assert len(lines) == 1 and lines[0].startswith("0 ")
    assert {"last.pt", "best.pt", "best_inference.npz"} <= {
        p.name for p in (run / "weights").iterdir()}
    # ranks 0 and 1 trained, with equal parameters; 2 and 3 sat it out
    trained = [r["train_run"] for r in results]
    assert trained[2] is None and trained[3] is None
    assert trained[0][0] == trained[1][0] == str(run)
    a, b = trained[0][1], trained[1][1]
    assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_train_run_matches_one_process(world, refs):
    """train_run over 2 ranks (each loading the seeded global batches and
    stepping on its row) ends within the sharded-step parameter tolerance
    of train_run in one process on the same batches, BN statistics
    included."""
    got = ranks(world)[0]["train_run"][1]
    assert_close_trees(got, refs["train_run"], "train_run over 2 ranks",
                       **SHARDED_PARAM_TOL)


def test_gather_rows_bit_exact_over_ranks(world):
    """gather_rows over the 4 gloo ranks gives every rank every rank's
    rows bit for bit, in rank order: floats (signed zeros, NaNs of both
    signs, infinities), bf16 and half, integers and bools."""
    for r in ranks(world):
        for dt in RANKS.GATHER_DTYPES:
            want = np.concatenate([RANKS.bits(RANKS.gather_case(i, dt))
                                   for i in range(WORLD)])
            assert np.array_equal(r["gather"][str(dt)], want), dt


def test_world_of_one_serves_as_without_a_mesh(one_torch_thread):
    """Without a process group make_data_mesh() is a world of one: its
    collectives return their input, shard_batch takes every row, and a
    detector with it serves bit for bit as one without a mesh, with no
    warning for micro_batch."""
    mesh = PM.make_data_mesh()
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    t = torch.arange(6.0)
    assert PM.gather_rows(mesh, t, 6) is t and mesh.all_reduce(t) is t
    tree = {"a": np.arange(4), "b": (torch.ones(4, 2),)}
    got = PM.shard_batch(mesh, tree)
    assert np.array_equal(got["a"], tree["a"]) and \
        torch.equal(got["b"][0], tree["b"][0])
    assert PM.is_main_process()
    x = inputs()
    kw = dict(img_sizes=(SIZE,), conf_thres=0.05, max_det=50,
              micro_batch=4, device="cpu")
    frames = x["frames"][:8]
    want = FaceDetector("yolov7-lite-t", variables=x["serve_variables"],
                        **kw).run_network(frames)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = FaceDetector("yolov7-lite-t", variables=x["serve_variables"],
                           mesh=mesh, **kw).run_network(frames)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
