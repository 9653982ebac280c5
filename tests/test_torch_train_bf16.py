"""bf16 mixed-precision training in the port (`YoloFace(spec,
dtype=torch.bfloat16)`, `cli.train --dtype bfloat16`) against the JAX
package's `YoloFace(dtype=bfloat16)` on the CPU.

What the JAX package computes, and the port reproduces with explicit
casts (`models/layers.Conv2d`, `models/layers.BatchNorm`): every conv on
its input and kernel cast to bf16; every BatchNorm with float32 batch
statistics (flax's `force_float32_reductions`), float32 running
statistics and a bf16 output; the implicit priors and the loss in
float32; parameters, gradients, optimizer state and the EMA float32.
`torch.autocast` is not used: its per-device op lists would decide the
dtypes on the card apart from what this file checks on the CPU, and
validate and the EMA model would each need the context.

(i) The JAX `test_bf16_mixed_precision_train_step` setup (yolov7-lite-t,
b2@128): the state stays float32 and the bf16 loss is within rtol 0.05
of the float32 loss.

(ii) One SGD step of yolov7-lite-t at b4@64 from the same weights,
moments and batch as tests/test_torch_train_step.py, against the JAX
bf16 step, jitted as the JAX CLI jits it: XLA may keep float32 values
inside a fusion where the program rounds to bf16 (excess precision), as
the port's fused CPU and cuDNN kernels do inside theirs (F.silu and
F.batch_norm round once). Elementwise, two frameworks' bf16 steps
cannot agree closer than bf16's rounding: XLA's CPU sigmoid is not
correctly rounded (its bf16 silu differs from torch's by an ulp on ~40%
of values), and a random model's bf16 gradient is ill-conditioned (the
obj loss's gradient is nearly constant over a map, and each BatchNorm
backward subtracts that constant from values rounded to bf16), so the
gradients of two bf16 steps differ by tens of percent, as the JAX bf16
step's own differ from its float32 step's (the float32 port against the
float32 JAX step: 2e-4). So the step is held as a whole: the loss
components at LOSS_RTOL, the BN running statistics' move per tensor and
the parameters' and EMA's moves over the model by relative L2 distance
(BN_MOVE_REL, UPDATE_REL; this seed: 0.123, 0.61 and 0.61). The loss
components, a sum over every prediction where elementwise rounding
averages out and what bf16 changes systematically (the kernels rounded
to bf16, the same in both frameworks) remains, also tell bf16 from
float32: the port's bf16 step must be closer to the JAX bf16 step than
the port's float32 step is (this seed: 0.0014 against 0.0040 of the
largest component; with XLA's excess precision off, 0.0082 against
0.0112).

(iii) `models/layers.BatchNorm` on one bf16 map against flax's
`BatchNorm(dtype=bfloat16)`, train and eval: running statistics float32
within rtol 1e-5, outputs within one bf16 ulp.

(iv) `cli.train --dtype bfloat16 --device cpu`, one epoch of yolov7-lite-t
at 128 px from seeded random weights: float32 checkpoints and stripped
weights; the epoch-end validate of the bf16 EMA model against the JAX
validate of the same model in bf16 at tests/test_torch_validate.py's
tolerances (mAP@.5 and mAP@.5:.95 equal, P and R within 1e-3). The two
bf16 forwards' confidences differ by up to 4e-3 and the top ones tie at
bf16's resolution, so the operating point is one where no decision
depends on their order: the gate in the widest gap of both forwards'
confidences (a few detections an image), the IoU threshold in the
widest gap of their IoUs, and validation labels written from the kept
detections so that each is a true positive below IoU 0.725 and a false
positive above it (`write_shrunk_labels`), checked before use.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.data import dataset as JD
from face_detection_multi_scale_tpu.infer.validate import (
    validate as jvalidate)
from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.train import trainer as JR
from face_detection_multi_scale_tpu_torch.models import layers as TL
from face_detection_multi_scale_tpu_torch.models import model as TM
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.models.convert import (
    jax_to_state_dict)
from face_detection_multi_scale_tpu_torch.train import trainer as TR
from face_detection_multi_scale_tpu_torch.train.hyp import HYP_SCRATCH_P6
from face_detection_multi_scale_tpu_torch.train.targets import (
    build_targets_batched)

import test_torch_train_step as TS
from test_torch_model import random_variables

BF16 = torch.bfloat16
NAME = "yolov7-lite-t"
LOSS_RTOL = 1e-2
BN_MOVE_REL = 0.25
UPDATE_REL = 0.8
# the gate's rank range among the two forwards' conf values (a few
# detections an image)
GATE_RANKS = (8, 24)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU steps on one thread for this module: beside the
    other test workers, torch's thread pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def float32_everywhere(state: TR.TrainState) -> bool:
    tensors = list(state.model.state_dict().items()) + [
        (n, t) for tree in (state.momentum_buf, state.ema_params,
                            state.second_moment or {})
        for n, t in tree.items()]
    return all(t.dtype == torch.float32 for n, t in tensors
               if not n.endswith("num_batches_tracked"))


def test_bf16_step_keeps_float32_state_and_tracks_float32_loss():
    """(i) tests/test_train_features.py::test_bf16_mixed_precision_train_step
    on the port: the parameters, BN statistics, optimizer state and EMA
    are float32 before and after a bf16 step, its gradients are float32,
    its convs computed bf16, and its loss is within rtol 0.05 of the
    float32 step's."""
    spec = TZ.get_spec(NAME)
    rng = np.random.default_rng(3)
    b, s = 2, 128
    images = rng.integers(0, 255, (b, s, s, 3), np.uint8)
    labels = np.array([[0, 0, 0.3, 0.4, 0.2, 0.25] + [0.3, 0.4] * 5,
                       [1, 0, 0.5, 0.5, 0.3, 0.3] + [0.5, 0.5] * 5],
                      np.float32)
    targets = build_targets_batched(labels, b, spec, [
        (s // st, s // st) for st in spec.strides], cap_per_image=64)
    cfg = TR.TrainConfig(epochs=4, steps_per_epoch=4, batch_size=b,
                         min_warmup_steps=2)
    losses = {}
    for dtype in (torch.float32, BF16):
        net = TM.init_weights(TM.YoloFace(TZ.get_spec(NAME), dtype=dtype),
                              torch.Generator().manual_seed(0))
        state = TR.create_train_state(net)
        assert float32_everywhere(state)
        seen = set()
        hooks = [m.register_forward_hook(
            lambda m, i, o: seen.add(o.dtype)) for m in net.modules()
            if isinstance(m, torch.nn.Conv2d)]
        _, _, grads = TR._grad_fn(net, HYP_SCRATCH_P6)(images, targets)
        for h in hooks:
            h.remove()
        assert seen == {dtype}
        assert {g.dtype for g in grads.values()} == {torch.float32}
        state, loss, comps = TR.make_train_step(net, cfg, HYP_SCRATCH_P6,
                                                s)(state, images, targets)
        assert np.isfinite(float(loss)) and state.step == 1
        assert float32_everywhere(state)
        losses[dtype] = float(loss)
    np.testing.assert_allclose(losses[BF16], losses[torch.float32],
                               rtol=0.05)


class Bf16Case(TS.Case):
    """tests/test_torch_train_step.py's lite-t case with the JAX model in
    bf16 (its step: the JAX make_train_step at lr 0, so the momentum
    buffer is the gradient)."""

    def __init__(self):
        super().__init__("lite-t")
        self.jmodel = JM.YoloFace(spec=self.jspec, dtype=jnp.bfloat16)
        zero = JR.TrainConfig(**dict(TS.CFG, lr0=0.0), warmup_bias_lr=0.0,
                              weight_decay=0.0)
        self._grad_step = JR.make_train_step(self.jmodel, zero, TS.HYP,
                                             TS.SIZE)


@functools.lru_cache(maxsize=None)
def bf16_case():
    return Bf16Case()


def rel_l2(got, want):
    """Relative L2 distance over a dict of tensors taken as one vector."""
    num = sum(float(((got[k] - want[k]).double() ** 2).sum()) for k in want)
    den = sum(float((want[k].double() ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def test_bf16_step_matches_jax_bf16_step():
    """(ii) One SGD step at optimizer step 2 (in warmup), the port in bf16
    and in float32 against the JAX bf16 step (the docstring says how)."""
    c = bf16_case()
    step = 2
    moments = c.moments(step)
    params = c.jvariables["params"]
    _, comps_j, grads, stats = c.jax_grads(0)
    new_p, new_ema = c.jax_apply(TS.CFG, params, grads, moments, step, step)
    want = TS.torch_tree(new_p, stats)
    want_ema = TS.torch_tree(new_ema, stats)
    start = TS.torch_tree(params, c.jvariables["batch_stats"])
    moved = lambda tree, keys: {k: tree[k] - start[k] for k in keys}
    images, labels = c.batches[0]
    loss_rel = {}
    for dtype in (BF16, torch.float32):
        net = TM.YoloFace(c.tspec, dtype=dtype)
        net.load_state_dict(jax_to_state_dict(c.variables))
        state = TS.port_state(net, moments, "sgd", step)
        state, _, comps = TR.make_train_step(
            net, TR.TrainConfig(**TS.CFG), TS.HYP, TS.SIZE)(
            state, images, TS.targets_of(c.jspec, labels))
        assert state.step == step + 1 and float32_everywhere(state)
        loss_rel[dtype] = float(np.abs(comps.numpy() - comps_j).max()
                                / np.abs(comps_j).max())
        if dtype != BF16:
            continue
        np.testing.assert_allclose(comps.numpy(), comps_j, rtol=LOSS_RTOL,
                                   atol=1e-7)
        got = net.state_dict()
        for k in got:
            if k.endswith(("running_mean", "running_var")):
                assert rel_l2(moved(got, [k]), moved(want, [k])) \
                    <= BN_MOVE_REL, k
        names = [n for n, _ in net.named_parameters()]
        assert rel_l2(moved(got, names), moved(want, names)) <= UPDATE_REL
        assert rel_l2(moved(state.ema_params, names),
                      moved(want_ema, names)) <= UPDATE_REL
    assert loss_rel[BF16] < loss_rel[torch.float32], loss_rel


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_bf16_matches_flax(train):
    """(iii) models/layers.BatchNorm on a bf16 map against flax's
    BatchNorm(dtype=bfloat16) (eager, so no excess precision): a bf16
    output within one bf16 ulp; in train mode the running statistics
    float32 and within rtol 1e-5 (flax's E[x^2] - E[x]^2 against the
    port's two-pass variance, both in float32 over bf16 values)."""
    import flax.linen as nn

    rng = np.random.default_rng(5)
    c = 24
    x = (rng.normal(0, 1, (4, 10, 10, c)) * rng.uniform(0.5, 3, c)
         + rng.normal(0, 2, c)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    scale, bias = rng.uniform(0.8, 1.2, c), rng.normal(0, 0.1, c)
    mean, var = rng.normal(0, 0.1, c), rng.uniform(0.5, 1.5, c)
    variables = {"params": {"scale": scale.astype(np.float32),
                            "bias": bias.astype(np.float32)},
                 "batch_stats": {"mean": mean.astype(np.float32),
                                 "var": var.astype(np.float32)}}
    bn = nn.BatchNorm(use_running_average=not train, momentum=0.97,
                      epsilon=1e-3, dtype=jnp.bfloat16)
    if train:
        want, upd = bn.apply(variables, xb, mutable=["batch_stats"])
    else:
        want, upd = bn.apply(variables, xb), None
    assert want.dtype == jnp.bfloat16

    m = TL.batch_norm(c).train(train)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(mean))
        m.running_var.copy_(torch.from_numpy(var))
        got = m(torch.from_numpy(np.array(xb.astype(jnp.float32)))
                .to(BF16).permute(0, 3, 1, 2))
    assert got.dtype == BF16
    got = got.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert (np.abs(got - want)
            <= bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all()
    if train:
        for key, theirs in (("running_mean", "mean"), ("running_var", "var")):
            mine = getattr(m, key)
            assert mine.dtype == torch.float32
            np.testing.assert_allclose(
                mine.numpy(), np.asarray(upd["batch_stats"][theirs]),
                rtol=1e-5, err_msg=key)


def widest_gap(values, lo, hi):
    """The middle of the widest gap between sorted `values` inside
    [lo, hi]."""
    v = np.unique(np.concatenate([[lo, hi], values[(values > lo)
                                                    & (values < hi)]]))
    i = int(np.argmax(np.diff(v)))
    return float((v[i] + v[i + 1]) / 2)


def box_iou(a, b):
    """Pairwise IoU of xyxy boxes (n, 4) x (m, 4)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    area = lambda x: np.prod(x[:, 2:] - x[:, :2], -1)
    return inter / (area(a)[:, None] + area(b)[None] - inter)


def decisive_settings(rows, jrows):
    """A gate and an IoU threshold at which the port's and the JAX bf16 rows
    (B, N, no) decide alike, a few detections an image: the gate in the
    widest gap of the conf values of both (conf <= obj), ranked
    GATE_RANKS from the top; the IoU threshold in the widest gap in
    [0.4, 0.6] of the gated rows' pairwise IoUs."""
    score = lambda r: (r[..., 4] * r[..., 5]).ravel()
    top = np.sort(np.concatenate([score(rows), score(jrows)]))[::-1]
    conf = widest_gap(top, top[GATE_RANKS[1]], top[GATE_RANKS[0]])
    ious = []
    for r in (*rows, *jrows):
        g = r[(r[:, 4] > conf) & (r[:, 4] * r[:, 5] > conf)]
        xyxy = np.concatenate([g[:, :2] - g[:, 2:4] / 2,
                               g[:, :2] + g[:, 2:4] / 2], 1)
        ious.append(box_iou(xyxy, xyxy).ravel())
    return conf, widest_gap(np.concatenate(ious), 0.4, 0.6)


def write_shrunk_labels(dets, names, label_dir, rng, size=128):
    """Each image's label file: the box of every kept detection, clipped to the
    frame (validate clips an image's first 4 predictions, the
    reference's quirk), shrunk about its centre to IoU 0.725 with it
    (between the mAP thresholds 0.70 and 0.75), and one random box,
    normalized `0 cx cy w h` plus 5 keypoints `x y 2` inside the box.
    Every detection is so a true positive at the thresholds 0.50-0.70
    and a false positive at 0.75-0.95, whatever its confidence: no
    decision of P, R or mAP depends on the order of confidences that
    bf16 rounds alike (the two forwards' confidences differ by up to
    4e-3, and the top ones tie). Returns each image's label boxes
    (xyxy)."""
    out = []
    s = 0.725 ** 0.5
    for det, name in zip(dets, names):
        xyxy = det[:, :4].clip(0, size)
        centre, half = (xyxy[:, :2] + xyxy[:, 2:]) / 2, \
            (xyxy[:, 2:] - xyxy[:, :2]) / 2 * s
        xy = rng.uniform(10, size - 50, 2)
        boxes = np.concatenate([
            np.concatenate([centre - half, centre + half], 1),
            [[*xy, *(xy + rng.uniform(10, 40, 2))]]])
        lines = []
        for x1, y1, x2, y2 in boxes:
            cx, cy, w, h = (x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1
            kp = sum(([cx + rng.uniform(-w / 3, w / 3),
                       cy + rng.uniform(-h / 3, h / 3), 2.0 * size]
                      for _ in range(5)), [])
            row = [0, cx, cy, w, h] + kp
            lines.append(" ".join(f"{v / size:.6f}" if i else "0"
                                  for i, v in enumerate(row)))
        (label_dir / name).write_text("\n".join(lines) + "\n")
        out.append(boxes)
    return out


def assert_each_detection_its_label(dets, boxes, size=128):
    """The labels decide every detection alike in both forwards (their
    boxes differ by hundredths of a pixel): an image keeps at most 4
    detections (all clipped to the frame by validate), and each one's
    own label is its best match by 0.05 of IoU or more, against every
    other label and every other detection."""
    for det, label in zip(dets, boxes):
        assert 0 < len(det) <= 4
        iou = box_iou(det[:, :4].clip(0, size), label)
        own = np.diag(iou[:, :len(det)]).copy()
        np.testing.assert_allclose(own, 0.725, atol=1e-4)
        np.fill_diagonal(iou[:, :len(det)], 0.0)
        assert (iou.max(1) < own - 0.05).all()
        assert (iou[:, :len(det)].max(0) < own - 0.05).all()


def test_cli_train_bfloat16_epoch_checkpoints_and_validate(tmp_path,
                                                           monkeypatch):
    """(iv) cli.train --dtype bfloat16 --device cpu: one epoch of
    yolov7-lite-t at 128 px (2 micro-steps, 1 apply), float32
    checkpoints and stripped weights, and the epoch-end validate of the
    bf16 EMA model against the JAX validate of the same bf16 model (the
    module docstring says how the labels and thresholds are chosen). The
    CLI's validate call runs through a wrapper that picks them and runs
    both; what the CLI records is the port's result."""
    import shutil

    from face_detection_multi_scale_tpu.models.head import (
        decode as j_decode)
    from face_detection_multi_scale_tpu_torch.cli import train as TCLI
    from face_detection_multi_scale_tpu_torch.data import dataset as TD
    from face_detection_multi_scale_tpu_torch.data.synthetic import (
        make_synthetic_face_dataset)
    from face_detection_multi_scale_tpu_torch.infer import validate as TV
    from face_detection_multi_scale_tpu_torch.models.convert import (
        state_dict_to_jax)
    from face_detection_multi_scale_tpu_torch.models.head import decode
    from face_detection_multi_scale_tpu_torch.ops import nms as TN
    from face_detection_multi_scale_tpu_torch.train.checkpoint import (
        save_inference_weights)

    from test_torch_validate import PR_TOL, SIZE

    data = make_synthetic_face_dataset(str(tmp_path / "set"), n_images=8,
                                       img_size=SIZE, val_fraction=0.5,
                                       seed=13)
    validate, seen = TV.validate, {}

    def both_validates(model, dataset, batch_size, **kw):
        assert model.compute_dtype == BF16 and not model.training
        assert {p.dtype for p in model.parameters()} == {torch.float32}
        frames = np.stack([dataset.get(i)[0] for i in range(len(dataset))])
        x = frames.astype(np.float32) / 255.0
        with torch.no_grad():
            rows = decode(model(torch.from_numpy(x)), model.spec).float()
        variables = state_dict_to_jax(model.state_dict())
        jmodel = JM.YoloFace(spec=JZ.get_spec(NAME), dtype=jnp.bfloat16)
        jrows = np.asarray(j_decode(jax.jit(functools.partial(
            jmodel.apply, train=False))(variables, x), jmodel.spec),
            np.float32)
        conf, iou = decisive_settings(rows.numpy(), jrows)
        dets = [np.asarray(d) for d in TN.detections_to_numpy(
            TN.non_max_suppression(rows, conf, iou, nc=1,
                                   max_candidates=4096, max_det=300))]
        val = tmp_path / "set" / "val"
        names = [p.split("/")[-1][:-4] + ".txt" for p in dataset.img_files]
        boxes = write_shrunk_labels(dets, names, val / "labels" / "0--Syn",
                                    np.random.default_rng(14))
        assert_each_detection_its_label(dets, boxes)
        (val / "labels.labels.npz").unlink(missing_ok=True)
        dirs = {}
        for pkg in ("port", "jax"):
            shutil.copytree(val, tmp_path / pkg)
            dirs[pkg] = str(tmp_path / pkg / "images")
        dkw = dict(img_size=SIZE, augment=False, hyp={}, kpt_label=5,
                   stride=model.spec.max_stride)
        vkw = dict(conf_thres=conf, iou_thres=iou, batch_size=batch_size,
                   verbose=False)
        seen["jax"] = jvalidate(jmodel, variables,
                                JD.FaceDataset(dirs["jax"], **dkw), **vkw)
        seen["port"] = validate(model, TD.FaceDataset(dirs["port"], **dkw),
                                **vkw)
        return seen["port"]

    monkeypatch.setattr(TV, "validate", both_validates)
    # informative starting weights (a fresh init puts every conf within
    # 1e-4 of one value): tests/test_torch_model.random_variables
    variables = random_variables(JZ.get_spec(NAME), 4)
    init = str(tmp_path / "init.npz")
    save_inference_weights(init, variables)
    runs = tmp_path / "runs"
    assert TCLI.main([
        "--model", NAME, "--data", data, "--img-size", str(SIZE),
        "--batch-size", "2", "--nominal-batch", "4", "--epochs", "1",
        "--val-batch-size", "4", "--dtype", "bfloat16", "--device", "cpu",
        "--noautoanchor", "--no-tensorboard", "--workers", "1",
        "--min-warmup-steps", "2", "--project", str(runs),
        "--name", "bf16", "--weights", init]) == 0
    state = TCLI.train_run.last["state"]
    assert state.step == 1 and float32_everywhere(state)
    assert state.model.compute_dtype == BF16

    got, want = seen["port"], seen["jax"]
    assert got["images"] == want["images"] == 4
    assert 0.1 < want["map50"] < 0.99 and 0 < want["map"] < want["map50"]
    for key in ("map50", "map"):
        assert got[key] == want[key], (key, got[key], want[key])
    for key in ("mp", "mr"):
        assert abs(got[key] - want[key]) <= PR_TOL, (key, got, want)
    line = (runs / "bf16" / "results.txt").read_text().splitlines()[-1]
    assert json.loads(line.split(" ", 7)[-1].rsplit(" ", 1)[0]) == \
        json.loads(json.dumps(got))

    weights = runs / "bf16" / "weights"
    for tag in ("last", "best"):
        saved = torch.load(weights / f"{tag}.pt", weights_only=True)
        floats = [t for part in ("model", "momentum_buf", "ema_params")
                  for t in saved[part].values() if t.is_floating_point()]
        assert floats and {t.dtype for t in floats} == {torch.float32}
    with np.load(weights / "best_inference.npz") as f:
        assert {v.dtype for v in f.values()} == {np.dtype(np.float32)}
