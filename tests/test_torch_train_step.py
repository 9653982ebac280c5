"""The port's train step (train/trainer.py, models/layers.BatchNorm in
train mode) against the JAX package's on the CPU, with the same weights
(tests/test_torch_model.random_variables through the weight bridge), the
same seeded optimizer state and the same batches. This file holds
yolov7-lite-t at 64 px (the model of tests/test_training_learns.py), the
schedule and the from-scratch init; tests/test_torch_train_narrow.py runs
the same checks on yolov7-tiny-face narrowed to width 0.25
(tests/test_torch_model.py) and the BatchNorm update.

The JAX side is compiled once per model: its `make_train_step` with a
learning rate and weight decay of 0 leaves the parameters as they are
and its momentum buffer holds the gradient (buf = 0 * momentum + g), so
one jitted step gives (loss, components, gradients, updated BN
statistics). The JAX package's own `optimizer_apply` and `ema_update`
then run (jitted per config) on those gradients, composed as its
`_optimize` and `make_accum_steps` compose them. The port runs its real
`make_train_step` / `make_accum_steps`.

The optimizer state starts from seeded moments, not zeros: from zeros,
Adam's first update is lr * sign(g), so a gradient within float32 noise
of 0 would flip a whole step (tests/test_trainer_lockstep.py's Adam
case says the same); with a second moment of 1e-3 the update is
proportional to the gradient, as SGD's is. Batches of 4 at 64 px: the
train-mode gradient of these small models is ill-conditioned on tiny
BN maps, less so at batch 4 than at batch 2.

Tolerances: losses rtol 5e-4; parameters and EMA parameters after the
apply rtol 5e-3 / atol 5e-5 (tests/test_trainer_lockstep.py's bounds);
BN running statistics rtol 1e-4 (means also atol 1e-5, see
BN_MEAN_ATOL); `lr_at` / `momentum_at` within 1e-7; uint8 against /255
float input rtol 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.models import head as JH
from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.train import targets as JT
from face_detection_multi_scale_tpu.train import trainer as JR
from face_detection_multi_scale_tpu.train.hyp import HYP_SCRATCH_P6
from face_detection_multi_scale_tpu_torch.models import layers as TLY
from face_detection_multi_scale_tpu_torch.models import model as TM
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.models.convert import (
    jax_to_state_dict)
from face_detection_multi_scale_tpu_torch.train import trainer as TR

from test_torch_model import narrowed, random_variables

LOSS_RTOL = 5e-4
PARAM_TOL = dict(rtol=5e-3, atol=5e-5)
BN_RTOL = 1e-4
# a running mean moves by 0.03 x the batch mean, and a mean that cancels
# near 0 has no relative precision: it is also held absolutely, at 0.03 x
# the activations' difference between the two forwards (a few 1e-4 deep
# in the net; tests/test_torch_model.py holds raws at atol 2e-4)
BN_MEAN_ATOL = 1e-5
SIZE, BS = 64, 4
# key: (zoo name, width multiple, JAX reference in float64 (see Case))
MODELS = {"lite-t": ("yolov7-lite-t", 1.0, False),
          "tiny": ("yolov7-tiny-face", 0.25, True)}
HYP = dict(HYP_SCRATCH_P6)
# warmup ends after 4 micro-iterations; a step at 2 is half-way
CFG = dict(epochs=10, steps_per_epoch=3, lr0=0.01, warmup_epochs=0.0,
           min_warmup_steps=4, batch_size=BS)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU steps on one thread for this module: beside the
    other test workers, torch's thread pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def batches(spec, n, seed):
    """n (uint8 images, labels) batches, faces with 5 landmarks."""
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
        out.append((images, np.concatenate(rows).astype(np.float32)))
    return out


def targets_of(spec, labels):
    return JT.build_targets_batched(labels, BS, spec, [
        (SIZE // s, SIZE // s) for s in spec.strides])


class Case:
    """One model: the JAX module, weights and gradient step, and the
    port's spec; `port()` builds a fresh port model with the weights.

    With `x64` the JAX side runs in float64 (inside `jax()`): flax's
    float32 BatchNorm takes the batch variance as E[x^2] - E[x]^2, and on
    narrowed tiny that cancellation puts its float32 train-mode gradients
    further from float64 than these tolerances, where the port's float32
    ones stay within them; the float64 JAX step is the reference there."""

    def __init__(self, key):
        name, width, self.x64 = MODELS[key]
        self.jspec = narrowed(JZ, name, width)
        self.tspec = narrowed(TZ, name, width)
        self.variables = random_variables(self.jspec, seed=3)
        self.batches = batches(self.jspec, 2, seed=7)
        # numpy trees on the JAX side: an eager JAX op on each leaf would
        # compile once per leaf shape
        dtype = np.float64 if self.x64 else np.float32
        self.jvariables = jax.tree.map(lambda x: np.asarray(x, dtype),
                                       self.variables)
        with self.jax():
            self.jmodel = JM.YoloFace(spec=self.jspec, dtype=dtype)
            zero = JR.TrainConfig(**dict(CFG, lr0=0.0), warmup_bias_lr=0.0,
                                  weight_decay=0.0)
            self._grad_step = JR.make_train_step(self.jmodel, zero, HYP,
                                                 SIZE)
        self._compiled = {}

    def jax(self):
        return jax.enable_x64(self.x64)

    def moments(self, seed):
        """Seeded optimizer moments: first ~ N(0, 1e-3), second 1e-3 to
        2e-3 (trees of the JAX params' structure)."""
        rng = np.random.default_rng(seed)
        return tuple(jax.tree.map(
            lambda p: draw(p.shape).astype(np.float32),
            self.variables["params"]) for draw in (
            lambda shape: rng.normal(0, 1e-3, shape),
            lambda shape: rng.uniform(1e-3, 2e-3, shape)))

    def port(self):
        net = TM.YoloFace(self.tspec)
        net.load_state_dict(jax_to_state_dict(self.variables))
        return net

    @functools.lru_cache(maxsize=None)
    def jax_grads(self, i):
        """(loss, components, gradients, new batch_stats) of one JAX train
        step from the weights on batch i, the BN statistics those left by
        batch i - 1 (as in an accumulation over the batches). Compiled
        with XLA's backend optimizations off, which halves the compile of
        the few calls made here."""
        params = self.jvariables["params"]
        stats = (self.jvariables["batch_stats"] if i == 0
                 else self.jax_grads(i - 1)[3])
        images, labels = self.batches[i]
        with self.jax():
            args = (train_state(params, stats), images,
                    targets_of(self.jspec, labels))
            key = str(jax.tree.map(np.shape, args[1:]))
            if key not in self._compiled:
                self._compiled[key] = self._grad_step.lower(*args).compile(
                    compiler_options={"xla_backend_optimization_level": 0})
            new, loss, comps = self._compiled[key](*args)
            host = lambda t: jax.tree.map(np.asarray, t)
            return float(loss), np.asarray(comps), host(new.momentum_buf), \
                host(new.batch_stats)

    def jax_apply(self, cfg_kw, params, grads, moments, step, sched_step,
                  ema_updates=0):
        """(new params, new EMA) of one JAX apply from the optimizer state
        `moments` at `step` applies and `ema_updates` EMA updates, EMA =
        params (see `packed`)."""
        assert cfg_kw.get("freeze_until") is None
        optimizer = cfg_kw.get("optimizer", "sgd")
        with self.jax():
            state = train_state(
                packed(params), {}, step=step, ema_updates=ema_updates,
                momentum_buf=packed(moments[0]),
                second_moment=(packed(moments[1]) if optimizer == "adam"
                               else None))
            new_p, ema = _jax_apply(tuple(sorted(cfg_kw.items())))(
                state, packed(grads), np.int32(sched_step))
            return unpacked(new_p, params), unpacked(ema, params)


def train_state(params, batch_stats, step=0, ema_updates=0,
                momentum_buf=None, second_moment=None):
    """A JAX TrainState of numpy leaves (create_train_state's, with
    zero momentum unless given, and the EMA equal to the params)."""
    zeros = jax.tree.map(np.zeros_like, params)
    return JR.TrainState(
        step=np.int32(step), params=params, batch_stats=batch_stats,
        momentum_buf=zeros if momentum_buf is None else momentum_buf,
        ema_params=jax.tree.map(np.copy, params),
        ema_updates=np.int32(ema_updates), second_moment=second_moment)


def packed(tree):
    """A JAX params-shaped tree as one leaf per parameter group,
    {"model_0": {"kernel": ..., "bias": ..., "other": ...}}, each the
    group's leaves raveled and concatenated in tree order. The JAX
    optimizer and EMA update each leaf on its own, by its group, so they
    compute the same on this tree, and compile in a second instead of
    several (one XLA op chain a leaf)."""
    groups = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        group = JR._param_group(tuple(k.key for k in kp))
        groups.setdefault(group, []).append(np.ravel(leaf))
    return {"model_0": {g: np.concatenate(v) for g, v in groups.items()}}


def unpacked(packed_tree, like):
    """The inverse of `packed`, into the structure of `like`."""
    flat = {g: np.asarray(v) for g, v in packed_tree["model_0"].items()}
    offsets = dict.fromkeys(flat, 0)
    out = []
    for kp, leaf in jax.tree_util.tree_flatten_with_path(like)[0]:
        group = JR._param_group(tuple(k.key for k in kp))
        start = offsets[group]
        offsets[group] += leaf.size
        out.append(flat[group][start:offsets[group]].reshape(leaf.shape))
    return jax.tree_util.tree_unflatten(jax.tree.structure(like), out)


@functools.lru_cache(maxsize=None)
def case(key):
    return Case(key)


@functools.lru_cache(maxsize=None)
def _jax_apply(items):
    """The JAX package's optimizer_apply then ema_update, as its `_optimize`
    and `make_accum_steps`' apply_fn compose them, jitted for one config
    (its counters traced, so one compile serves every step)."""
    cfg = JR.TrainConfig(**dict(items))

    def apply(state, grads, sched_step):
        new_p, new_m, new_v = JR.optimizer_apply(cfg, state, grads,
                                                 sched_step)
        ema = JR.ema_update(cfg, state.ema_params, new_p,
                            state.ema_updates + 1)
        return new_p, ema

    return jax.jit(apply)


def port_state(net, moments, optimizer, step, ema_updates=0):
    """The port's TrainState of `net` with the same moments and counters."""
    state = TR.create_train_state(net, optimizer)
    state.step, state.ema_updates = step, ema_updates
    for theirs, mine in zip(moments, (state.momentum_buf,
                                      state.second_moment)):
        if mine is not None:
            tree = jax_to_state_dict({"params": theirs})
            for name, t in mine.items():
                t.copy_(tree[name])
    return state


def torch_tree(params, batch_stats):
    return jax_to_state_dict({"params": params, "batch_stats": batch_stats})


def assert_bn(key, got, want):
    atol = BN_MEAN_ATOL if key.endswith("running_mean") else 0.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=BN_RTOL,
                               atol=atol, err_msg=key)


def assert_state(net, ema, params, batch_stats, ema_params):
    """The port's parameters, BN statistics and EMA against JAX trees."""
    want = torch_tree(params, batch_stats)
    want_ema = torch_tree(ema_params, batch_stats)
    got = net.state_dict()
    names = dict(net.named_parameters())
    checked = 0
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key in names:
            np.testing.assert_allclose(got[key].numpy(), w.numpy(),
                                       err_msg=key, **PARAM_TOL)
            np.testing.assert_allclose(ema[key].numpy(),
                                       want_ema[key].numpy(),
                                       err_msg="ema " + key, **PARAM_TOL)
        else:
            assert_bn(key, got[key], w)
        checked += 1
    assert checked == sum(not k.endswith("num_batches_tracked")
                          for k in got)


def check_one_step(key, optimizer, step):
    """One make_train_step from a state at optimizer step `step` (SGD in
    warmup, Adam after it): loss, parameters, BN statistics and EMA."""
    c = case(key)
    cfg_kw = dict(CFG, optimizer=optimizer)
    moments = c.moments(step)
    params = c.jvariables["params"]
    loss_j, comps_j, grads, stats = c.jax_grads(0)
    new_p, new_ema = c.jax_apply(cfg_kw, params, grads, moments, step,
                                 step)

    net = c.port()
    state = port_state(net, moments, optimizer, step)
    images, labels = c.batches[0]
    state, loss, comps = TR.make_train_step(
        net, TR.TrainConfig(**cfg_kw), HYP, SIZE)(
        state, images, targets_of(c.jspec, labels))
    assert state.step == step + 1 and state.ema_updates == 1
    np.testing.assert_allclose(float(loss), loss_j, rtol=LOSS_RTOL)
    np.testing.assert_allclose(comps.numpy(), comps_j, rtol=LOSS_RTOL,
                               atol=1e-7)
    assert_state(net, state.ema_params, new_p, stats, new_ema)


def check_accumulated(key, optimizer):
    """Two micro-batches through make_accum_steps' grad_fn (summed
    gradients, BN statistics chained) and one apply_fn at the global
    micro-iteration 3 with 1 apply done (Adam's bias correction counts
    applies, its lr the micro-iterations)."""
    c = case(key)
    cfg_kw = dict(CFG, optimizer=optimizer)
    moments = c.moments(1)
    params = c.jvariables["params"]
    losses, _, grads, stats = zip(*(c.jax_grads(i)
                                    for i in range(len(c.batches))))
    stats = stats[-1]
    acc = jax.tree.map(np.add, *grads)
    new_p, new_ema = c.jax_apply(cfg_kw, params, acc, moments, 1, 3,
                                 ema_updates=1)

    net = c.port()
    state = port_state(net, moments, optimizer, 1, ema_updates=1)
    grad_fn, apply_fn = TR.make_accum_steps(
        net, TR.TrainConfig(**cfg_kw), HYP, SIZE)
    acc_t = TR.zero_grads_like(state.params)
    for (images, labels), want in zip(c.batches, losses):
        state, acc_t, loss, _ = grad_fn(state, images,
                                        targets_of(c.jspec, labels), acc_t)
        np.testing.assert_allclose(float(loss), want, rtol=LOSS_RTOL)
    state = apply_fn(state, acc_t, 3)
    assert state.step == 2 and state.ema_updates == 2
    assert_state(net, state.ema_params, new_p, stats, new_ema)


def check_freeze(key, freeze_until):
    """A step with freeze_until leaves the frozen parameters bit-equal,
    still updates their BN statistics, and moves every other parameter
    where the JAX apply does."""
    c = case(key)
    params = c.jvariables["params"]
    net = c.port()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    cfg_kw = dict(CFG, freeze_until=freeze_until)
    moments = c.moments(2)
    _, _, grads, stats = c.jax_grads(0)
    # the JAX apply updates each leaf on its own: with freezing, a frozen
    # leaf stays and every other one moves as without it
    new_p, _ = c.jax_apply(CFG, params, grads, moments, 2, 2)
    state = port_state(net, moments, "sgd", 2)
    images, labels = c.batches[0]
    TR.make_train_step(net, TR.TrainConfig(**cfg_kw), HYP, SIZE)(
        state, images, targets_of(c.jspec, labels))
    frozen = {n for n, p in net.named_parameters() if not p.requires_grad}
    assert frozen and len(frozen) == sum(
        TR._frozen(n, freeze_until) for n, _ in net.named_parameters())
    after = net.state_dict()
    for n in frozen:
        assert torch.equal(after[n], before[n]), n
    assert not torch.equal(after["model.0.bn.running_var"],
                           before["model.0.bn.running_var"])
    want = torch_tree(new_p, stats)
    for n, p in net.named_parameters():
        if n not in frozen:
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       err_msg=n, **PARAM_TOL)


@pytest.mark.parametrize("optimizer,step", [("sgd", 2), ("adam", 5)])
def test_one_step_matches_jax(optimizer, step):
    check_one_step("lite-t", optimizer, step)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_accumulated_steps_match_jax(optimizer):
    check_accumulated("lite-t", optimizer)


def test_schedule_matches_jax():
    """lr_at for every group and momentum_at at every step of a
    warmup-plus-cosine schedule (and the linear one) within 1e-7."""
    for extra in ({}, {"linear_lr": True}):
        kw = dict(epochs=6, steps_per_epoch=5, lr0=0.01, lrf=0.2,
                  warmup_epochs=1.4, min_warmup_steps=3, **extra)
        jcfg, tcfg = JR.TrainConfig(**kw), TR.TrainConfig(**kw)
        assert tcfg.warmup_steps == jcfg.warmup_steps == 7
        for s in range(kw["epochs"] * kw["steps_per_epoch"]):
            for g in ("kernel", "bias", "other"):
                assert abs(tcfg.lr_at(s, g)
                           - float(jcfg.lr_at(jnp.int32(s), g))) < 1e-7
            assert abs(tcfg.momentum_at(s)
                       - float(jcfg.momentum_at(jnp.int32(s)))) < 1e-7
    assert TR.one_cycle_lf(3, 6, 0.2) == pytest.approx(
        float(JR.one_cycle_lf(3, 6, 0.2)), abs=1e-7)


def test_uint8_matches_normalized_float():
    """The step turns uint8 into /255 on the device: the same loss as a
    float batch divided by 255 (rtol 1e-5)."""
    c = case("lite-t")
    images, labels = c.batches[0]
    targets = targets_of(c.jspec, labels)
    losses = []
    for x in (images, images.astype(np.float32) / 255.0):
        net = c.port()
        step = TR.make_train_step(net, TR.TrainConfig(**CFG), HYP, SIZE)
        losses.append(float(step(TR.create_train_state(net), x,
                                 targets)[1]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


@pytest.mark.parametrize("name", ["yolov7-lite-t", "yolov7-face"])
def test_from_scratch_init_follows_jax_init(name):
    """A from-scratch model (models/model.init_weights) has the JAX init's
    head biases exactly (the det conv's focal priors: obj
    log(8 / (640 / stride)^2), cls log(0.6 / (nc - 0.99)); zero on the
    landmark convs, whose towers' BNs start at identity), implicit priors
    near 0 and 1 and lecun-scaled kernels; the head is the JAX head's
    init (DetectionHead, the module init_model initializes). Every other
    BN starts at identity and no other conv has a bias."""
    jspec, tspec = narrowed(JZ, name), narrowed(TZ, name)
    net = TM.init_weights(TM.YoloFace(tspec),
                          torch.Generator().manual_seed(0))
    got = net.state_dict()
    variant = {"Detect": "detect", "IDetect": "idetect",
               "IKeypoint": "ikeypoint"}[jspec.nodes[-1].op]
    head = JH.DetectionHead(spec=jspec, variant=variant)
    variables = jax.jit(head.init)(
        jax.random.PRNGKey(0), [jnp.zeros((1, 8, 8, c))
                                for c in jspec.head_in_ch])
    prefix = f"model.{len(jspec.nodes) - 1}."
    want = {prefix + k: v for k, v in jax_to_state_dict(
        {"params": variables["params"],
         "batch_stats": variables.get("batch_stats", {})}).items()}
    assert set(want) == {k for k in got if k.startswith(prefix)}
    for key, w in want.items():
        if key.endswith(("bias", "running_mean", "running_var",
                         "num_batches_tracked")) or (
                key.endswith("weight") and w.ndim == 1):
            assert torch.equal(got[key], w), key
        elif key.endswith("implicit"):
            np.testing.assert_allclose(got[key].numpy(), w.numpy(),
                                       atol=0.15)
        else:  # conv kernels: lecun-normal draws of their own
            assert abs(float(got[key].std()) * np.sqrt(w[0].numel())
                       - 1) < 0.5, key
    for key, v in got.items():
        if not key.startswith(prefix):
            if key.endswith(("running_var", "bn.weight")):
                assert torch.equal(v, torch.ones_like(v)), key
            elif key.endswith(("running_mean", "bn.bias")):
                assert torch.equal(v, torch.zeros_like(v)), key
