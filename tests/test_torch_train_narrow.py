"""The port's train step on yolov7-tiny-face narrowed to width 0.25
(tests/test_torch_model.py's narrowing) against the JAX package's, with
the checks, weights, batches and tolerances of
tests/test_torch_train_step.py (which runs them on yolov7-lite-t); and
the BatchNorm update of models/layers.BatchNorm against flax's. The JAX
side runs in float64 here (test_torch_train_step.Case says why).

How far a float32 step sits from the exact (float64) one: on this state,
the JAX float32 step's distance from the JAX float64 step beside the
port's float32 distance (`test_float32_step_distance_beside_jax`); on the
full yolov7-face b2@256 state of chip_smoke's phase 22(a), the same with
the port's float64 step beside (`test_full_model_float32_step_distance`,
marked slow: two JAX compiles of the full training graph)."""

import functools

import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.train import trainer as JR
from face_detection_multi_scale_tpu_torch.models import layers as TLY
from face_detection_multi_scale_tpu_torch.train import trainer as TR

import test_torch_train_step as TS
from test_torch_train_step import (
    BN_MEAN_ATOL, LOSS_RTOL, PARAM_TOL, assert_bn, case, check_accumulated,
    check_freeze, check_one_step, port_state, targets_of, torch_tree)

BN_RTOL = 1e-4
KEY = "tiny"
# torch's CPU threads before this module's one-thread fixture
DEFAULT_THREADS = torch.get_num_threads()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU steps on one thread for this module: beside the
    other test workers, torch's thread pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("optimizer,step", [("sgd", 2), ("adam", 5)])
def test_one_step_matches_jax(optimizer, step):
    check_one_step(KEY, optimizer, step)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_accumulated_steps_match_jax(optimizer):
    check_accumulated(KEY, optimizer)


def test_freeze_summary_matches_jax():
    """freeze_summary's (frozen, trainable, layers) equal the JAX ones."""
    c = case(KEY)
    net = c.port()
    for freeze_until in (None, 0, 5, 40, 200):
        assert TR.freeze_summary(net, freeze_until) == JR.freeze_summary(
            c.variables["params"], freeze_until), freeze_until


@pytest.mark.parametrize("freeze_until", [0, 20])
def test_freeze_step_matches_jax(freeze_until):
    check_freeze(KEY, freeze_until)


def test_batch_norm_running_statistics_match_flax(monkeypatch):
    """One train-mode forward of narrowed tiny: every running_mean /
    running_var within rtol 1e-4 (means also atol 1e-5) of the JAX
    statistics, those of `model.apply(variables, images, train=True,
    mutable=["batch_stats"])` inside the JAX train step, whose BN folds
    in the biased batch variance. torch's own nn.BatchNorm2d update (the
    unbiased variance, n/(n-1) larger) misses them on the small maps."""
    c = case(KEY)
    images = c.batches[0][0].astype(np.float32) / 255.0
    stats = c.jax_grads(0)[3]
    want = torch_tree(c.variables["params"], stats)

    def stats_after_forward():
        net = c.port().train()
        with torch.no_grad():
            net(torch.from_numpy(images))
        return {k: v for k, v in net.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}

    got = stats_after_forward()
    assert len(got) == sum(k.endswith(("running_mean", "running_var"))
                           for k in want)
    for key, v in got.items():
        assert_bn(key, v, want[key])
    monkeypatch.setattr(TLY.BatchNorm, "forward",
                        torch.nn.BatchNorm2d.forward)
    plain = stats_after_forward()
    worst = max(float(((plain[k] - want[k]).abs()
                       / want[k].abs()).max()) for k in plain
                if k.endswith("running_var"))
    assert worst > 10 * BN_RTOL


def tolerance_ratio(got, want, rtol, atol=0.0) -> float:
    """max |got - want| / (atol + rtol |want|): within the tolerance iff
    <= 1 (chip_smoke.tolerance_ratio)."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def step_ratios(got, want, names):
    """Tolerance ratios of one step's (components, state dict, EMA) `got`
    against `want`, at this file's tolerances: the loss components, every
    parameter, every EMA parameter, every BN running statistic."""
    (cg, sg, eg), (cw, sw, ew) = got, want
    out = {"loss": tolerance_ratio(cg, cw, LOSS_RTOL, 1e-7),
           "param": max(tolerance_ratio(sg[n], sw[n], **PARAM_TOL)
                        for n in names),
           "ema": max(tolerance_ratio(eg[n], ew[n], **PARAM_TOL)
                      for n in names)}
    out["bn"] = max(tolerance_ratio(
        sg[k], sw[k], BN_RTOL,
        BN_MEAN_ATOL if k.endswith("mean") else 0.0)
        for k in sw if k.endswith(("running_mean", "running_var")))
    return out


@functools.lru_cache(maxsize=None)
def float32_case():
    """This file's case with the JAX side in float32: the same weights,
    batches and moments."""
    TS.MODELS[KEY + "-float32"] = (*TS.MODELS[KEY][:2], False)
    return TS.Case(KEY + "-float32")


def test_float32_step_distance_beside_jax():
    """One SGD step at optimizer step 2 (test_one_step_matches_jax's)
    from the same state: the JAX float32 step and the port's float32 step
    each against the JAX float64 step, as tolerance ratios (<= 1 is
    within). The port's float32 step is no further from the exact step
    than the JAX float32 step is, or within the tolerances."""
    step, cfg_kw = 2, dict(TS.CFG)
    exact, c32 = case(KEY), float32_case()
    moments = exact.moments(step)
    images, labels = exact.batches[0]

    def jax_step(c):
        _, comps, grads, stats = c.jax_grads(0)
        new_p, new_ema = c.jax_apply(cfg_kw, c.jvariables["params"], grads,
                                     moments, step, step)
        return (torch.as_tensor(np.array(comps)), torch_tree(new_p, stats),
                torch_tree(new_ema, {}))

    net = exact.port()
    state = port_state(net, moments, "sgd", step)
    _, _, comps = TR.make_train_step(net, TR.TrainConfig(**cfg_kw), TS.HYP,
                                     TS.SIZE)(
        state, images, targets_of(exact.jspec, labels))
    names = [n for n, _ in net.named_parameters()]
    want = jax_step(exact)
    port = step_ratios((comps, net.state_dict(), state.ema_params), want,
                       names)
    jax32 = step_ratios(jax_step(c32), want, names)
    print(f"narrowed tiny b{TS.BS}@{TS.SIZE}, one float32 step against the "
          f"JAX float64 step, tolerance ratios: port {port}, JAX {jax32}")
    for key, ratio in port.items():
        assert ratio <= max(1.0, jax32[key]), (key, port, jax32)


@pytest.mark.slow
def test_full_model_float32_step_distance():
    """chip_smoke phase 22(a)'s state (yolov7-face at full width, seeded
    port init, b2@256, one step past the warmup): the JAX float32 step
    against the JAX float64 step, and the port's float32 step against the
    port's float64 step, as tolerance ratios at chip_smoke's tolerances
    (TRAIN_LOSS_RTOL, TRAIN_PARAM_TOL, TRAIN_BN_RTOL); the port's float32
    step on one torch thread and on torch's default thread count. What
    sets the distance is the length of the float32 sums: the first
    convs' weight gradients sum over batch x 256 x 256 positions, and
    one thread sums them in one sequence. On the default threads the
    port's float32 distance is no more than twice the JAX package's, or
    within the tolerances."""
    import jax

    import chip_smoke as CS
    from face_detection_multi_scale_tpu.models import model as JM
    from face_detection_multi_scale_tpu.models import zoo as JZ
    from face_detection_multi_scale_tpu.train import trainer as JR
    from face_detection_multi_scale_tpu_torch.models import model as TM
    from face_detection_multi_scale_tpu_torch.models import zoo as TZ
    from face_detection_multi_scale_tpu_torch.models.convert import (
        jax_to_state_dict, state_dict_to_jax)
    from face_detection_multi_scale_tpu_torch.train.targets import (
        build_targets_batched)

    size, batch, seed = CS.PARITY_SIZE, CS.PARITY_BATCH, 7
    cfg_kw = dict(epochs=300, steps_per_epoch=10, warmup_epochs=0.0,
                  min_warmup_steps=1, batch_size=batch)
    images, labels = CS.face_batch(np.random.default_rng(seed), batch, size)
    init = TM.init_weights(TM.YoloFace(TZ.get_spec(CS.TRAIN_MODEL)),
                           torch.Generator().manual_seed(seed)).state_dict()
    spec = TZ.get_spec(CS.TRAIN_MODEL)
    grids = [(size // st, size // st) for st in spec.strides]
    targets = build_targets_batched(labels, batch, spec, grids)

    def port_step(dtype):
        net = TM.YoloFace(TZ.get_spec(CS.TRAIN_MODEL))
        net.load_state_dict(init)
        net.to(dtype)
        state = TR.create_train_state(net)
        state.step = state.ema_updates = 1
        _, _, comps = TR.make_train_step(
            net, TR.TrainConfig(**cfg_kw), dict(CS.HYP_SCRATCH_P6), size)(
            state, images, targets)
        return comps, net.state_dict(), state.ema_params

    def jax_step(x64):
        dtype = np.float64 if x64 else np.float32
        variables = jax.tree.map(lambda v: np.asarray(v, dtype),
                                 state_dict_to_jax(init))
        with jax.enable_x64(x64):
            model = JM.YoloFace(spec=JZ.get_spec(CS.TRAIN_MODEL),
                                dtype=dtype)
            state = TS.train_state(variables["params"],
                                   variables["batch_stats"], step=1,
                                   ema_updates=1)
            step = JR.make_train_step(model, JR.TrainConfig(**cfg_kw),
                                      dict(CS.HYP_SCRATCH_P6), size)
            new, _, comps = step(state, images, targets)
            host = lambda t: jax.tree.map(np.asarray, t)
            return (torch.as_tensor(np.asarray(comps)),
                    jax_to_state_dict({"params": host(new.params),
                                       "batch_stats": host(
                                           new.batch_stats)}),
                    jax_to_state_dict({"params": host(new.ema_params)}))

    def ratios(got, want):
        (cg, sg, eg), (cw, sw, ew) = got, want
        names = list(eg)
        return {
            "loss": tolerance_ratio(cg, cw, CS.TRAIN_LOSS_RTOL, 1e-7),
            "param": max(tolerance_ratio(sg[n], sw[n], **CS.TRAIN_PARAM_TOL)
                         for n in names),
            "ema": max(tolerance_ratio(eg[n], ew[n], **CS.TRAIN_PARAM_TOL)
                       for n in names),
            "bn": max(tolerance_ratio(
                sg[k], sw[k], CS.TRAIN_BN_RTOL,
                CS.TRAIN_BN_MEAN_ATOL if k.endswith("mean") else 0.0)
                for k in sw if k.endswith(("running_mean", "running_var")))}

    torch.set_num_threads(DEFAULT_THREADS)
    exact = port_step(torch.float64)
    port = {threads: None for threads in (1, DEFAULT_THREADS)}
    for threads in port:
        torch.set_num_threads(threads)
        port[threads] = ratios(port_step(torch.float32), exact)
    torch.set_num_threads(1)
    jax32 = ratios(jax_step(False), jax_step(True))
    print(f"{CS.TRAIN_MODEL} b{batch}@{size}, one float32 step against the "
          f"float64 step of the same framework, tolerance ratios: port on "
          f"1 and {DEFAULT_THREADS} threads {port}, JAX {jax32}")
    for key, ratio in port[DEFAULT_THREADS].items():
        assert ratio <= max(1.0, 2.0 * jax32[key]), (key, port, jax32)
