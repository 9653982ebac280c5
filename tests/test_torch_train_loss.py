"""The port's box geometry, target assignment and loss (ops/boxes.py,
train/targets.py, train/loss.py) against the JAX package on the CPU.

Inputs come from numpy seeds: random boxes for the IoU family (every
variant within 1e-6), random labels for the targets (arrays exactly
equal, `_bucket` padding included), random raw maps at the shapes of
yolov7-lite-t (3 levels) and yolov7-w6-face (4 levels, the P6 balance)
at 128 px for the loss (components within rtol 2e-4, the JAX
tests/test_loss.py bound) and its gradient with respect to the raws
(rtol 1e-4 / atol 1e-6). The JAX loss and its gradient are jitted once
per case.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.ops import boxes as JB
from face_detection_multi_scale_tpu.train import loss as JL
from face_detection_multi_scale_tpu.train import targets as JT
from face_detection_multi_scale_tpu.train import trainer as JR
from face_detection_multi_scale_tpu.train.hyp import HYP_SCRATCH_P6
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.ops import boxes as TB
from face_detection_multi_scale_tpu_torch.train import loss as TL
from face_detection_multi_scale_tpu_torch.train import targets as TT
from face_detection_multi_scale_tpu_torch.train import trainer as TR

IOU_TOL = 1e-6
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
SIZE = 128


def random_boxes(rng, n, xywh):
    """(n, 4) float32 boxes: overlapping, disjoint and degenerate pairs."""
    xy = rng.uniform(0, 50, (n, 2))
    wh = rng.uniform(0.5, 30, (n, 2))
    wh[: n // 8] = 0.0  # zero-size boxes
    if xywh:
        return np.concatenate([xy, wh], 1).astype(np.float32)
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("xywh", [False, True])
@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou", "eiou",
                                  "siou"])
def test_bbox_iou_every_variant(kind, xywh):
    rng = np.random.default_rng(len(kind) + 7 * xywh)
    b1 = random_boxes(rng, 256, xywh)
    b2 = np.concatenate([b1[:128] + rng.normal(0, 2, (128, 4)).astype(
        np.float32), random_boxes(rng, 128, xywh)])
    b2[:, 2:] = np.abs(b2[:, 2:]) if xywh else np.maximum(b2[:, 2:],
                                                          b2[:, :2])
    want = np.asarray(JB.bbox_iou(jnp.asarray(b1), jnp.asarray(b2),
                                  xywh=xywh, kind=kind))
    got = TB.bbox_iou(torch.from_numpy(b1), torch.from_numpy(b2),
                      xywh=xywh, kind=kind).numpy()
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got))
    np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                               atol=IOU_TOL)


def test_box_helpers_match_jax():
    rng = np.random.default_rng(1)
    xyxy = random_boxes(rng, 64, xywh=False)
    wh1 = rng.uniform(1, 40, (7, 2)).astype(np.float32)
    wh2 = rng.uniform(1, 40, (5, 2)).astype(np.float32)
    norm = rng.uniform(0, 1, (9, 4)).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (TB.xyxy2xywh(t(xyxy)), JB.xyxy2xywh(jnp.asarray(xyxy))),
        (TB.box_area(t(xyxy)), JB.box_area(jnp.asarray(xyxy))),
        (TB.wh_iou(t(wh1), t(wh2)), JB.wh_iou(jnp.asarray(wh1),
                                              jnp.asarray(wh2))),
        (TB.xywhn2xyxy(t(norm), 320, 240, 3, 5),
         JB.xywhn2xyxy(jnp.asarray(norm), 320, 240, 3, 5)),
        (TB.xywh2xyxy(TB.xyxy2xywh(t(xyxy))), jnp.asarray(xyxy)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-5)


def make_labels(rng, bs, max_per_img, nkpt=5, nc=1):
    """[img, cls, x, y, w, h, kpts...] rows, some keypoints invisible (0),
    one image of the batch without labels."""
    rows = []
    for b in range(bs - 1):
        n = int(rng.integers(1, max_per_img + 1))
        xy = rng.uniform(0.1, 0.9, (n, 2))
        wh = rng.uniform(0.02, 0.4, (n, 2))
        kpts = rng.uniform(0.05, 0.95, (n, 2 * nkpt))
        kpts[rng.uniform(size=kpts.shape) < 0.2] = 0.0
        cls = rng.integers(0, nc, (n, 1))
        rows.append(np.concatenate([np.full((n, 1), b), cls, xy, wh, kpts],
                                   1))
    return np.concatenate(rows).astype(np.float32)


def specs(name, nc=1, nkpt=5):
    js, ts = JZ.get_spec(name), TZ.get_spec(name)
    js.nc = ts.nc = nc
    js.nkpt = ts.nkpt = nkpt
    return js.resolve(), ts.resolve()


def grids(spec, size=SIZE):
    return [(size // s, size // s) for s in spec.strides]


@pytest.mark.parametrize("name,bs,per,cap", [
    ("yolov7-lite-t", 3, 4, None), ("yolov7-w6-face", 2, 40, None),
    ("yolov7-lite-t", 2, 30, 16)])
def test_build_targets_batched_equal(name, bs, per, cap):
    """Every array exactly equal, the capacity's bucket included; with a
    small explicit cap both truncate (and warn) alike."""
    js, ts = specs(name)
    labels = make_labels(np.random.default_rng(bs * per), bs, per)
    with _maybe_warns(cap):
        want = JT.build_targets_batched(labels, bs, js, grids(js),
                                        cap_per_image=cap)
    with _maybe_warns(cap):
        got = TT.build_targets_batched(labels, bs, ts, grids(ts),
                                       cap_per_image=cap)
    assert sorted(got) == sorted(want)
    for key in want:
        for g, w in zip(got[key], want[key], strict=True):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
    assert TT._bucket(3 * 600) == JT._bucket(3 * 600) == 2048


def _maybe_warns(cap):
    if cap is None:
        return contextlib.nullcontext()
    return pytest.warns(UserWarning, match="truncating")


def test_build_targets_flat_equal():
    js, ts = specs("yolov7-lite-t")
    labels = make_labels(np.random.default_rng(5), 3, 6)
    want = JT.targets_to_arrays(JT.build_targets(labels, js, grids(js)))
    got = TT.targets_to_arrays(TT.build_targets(labels, ts, grids(ts)))
    for key in want:
        for g, w in zip(got[key], want[key], strict=True):
            np.testing.assert_array_equal(g, w, err_msg=key)


def random_raws(spec, bs, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1.5, (bs, spec.na, ny, nx, spec.no))
            .astype(np.float32) for ny, nx in grids(spec)]


HYPS = {
    "p6": dict(HYP_SCRATCH_P6),
    # the branches the default recipe leaves off: focal modulation, label
    # smoothing, positive weights, objectness from the raw IoU share
    "focal": dict(HYP_SCRATCH_P6, fl_gamma=1.5, label_smoothing=0.1,
                  cls_pw=1.3, obj_pw=0.8),
}


def jax_loss_and_grad(batched: bool, nc: int, nkpt: int, hyp, gr: float):
    fn = JL.compute_loss_batched if batched else JL.compute_loss

    def total(raws, targets):
        return fn(raws, targets, hyp, nc=nc, nkpt=nkpt, gr=gr)

    return jax.jit(jax.value_and_grad(total, has_aux=True))


def port_loss_and_grad(raws_np, targets, batched, nc, nkpt, hyp, gr):
    raws = [torch.tensor(r, requires_grad=True) for r in raws_np]
    fn = TL.compute_loss_batched if batched else TL.compute_loss
    loss, comps = fn(raws, TL.targets_to_device(targets, "cpu"), hyp,
                     nc=nc, nkpt=nkpt, gr=gr)
    grads = torch.autograd.grad(loss, raws)
    return (loss.detach().numpy(), comps.detach().numpy(),
            [g.numpy() for g in grads])


# (model, nc, nkpt, hyp, batched targets, gr, no labels): the loss reads
# landmarks at channels 6::3, the face layout with one class, so the
# class term (nc > 1) is held on a plain detector's layout (no landmarks)
@pytest.mark.parametrize("name,nc,nkpt,hyp_key,batched,gr,empty", [
    ("yolov7-lite-t", 1, 5, "p6", True, 1.0, False),
    ("yolov7-w6-face", 1, 5, "p6", True, 1.0, False),
    ("yolov7-lite-t", 1, 5, "focal", False, 0.7, False),
    ("yolov7-lite-t", 3, 0, "focal", True, 0.7, False),
    ("yolov7-lite-t", 3, 0, "p6", False, 1.0, False),
    ("yolov7-lite-t", 1, 5, "p6", True, 1.0, True),
])
def test_loss_components_and_grad_match_jax(name, nc, nkpt, hyp_key,
                                            batched, gr, empty):
    """compute_loss_batched (and the flat compute_loss) components within
    rtol 2e-4 and d loss / d raws within rtol 1e-4 / atol 1e-6; with no
    labels the box and landmark terms are 0 and the rest finite."""
    js, ts = specs(name, nc, nkpt)
    bs = 3
    rng = np.random.default_rng(11 + nc)
    labels = (np.zeros((0, 6 + 2 * nkpt), np.float32) if empty
              else make_labels(rng, bs, 5, nkpt=nkpt, nc=nc))
    if batched:
        targets = JT.build_targets_batched(labels, bs, js, grids(js))
    else:
        targets = JT.targets_to_arrays(JT.build_targets(labels, js,
                                                        grids(js)))
    raws = random_raws(js, bs, seed=nc)
    hyp = TR.scale_loss_gains(HYPS[hyp_key], ts.nl, ts.nc, SIZE)
    assert hyp == JR.scale_loss_gains(HYPS[hyp_key], js.nl, js.nc, SIZE)
    (want_loss, want_comps), want_grads = jax_loss_and_grad(
        batched, nc, nkpt, hyp, gr)(
        [jnp.asarray(r) for r in raws],
        jax.tree.map(jnp.asarray, targets))
    loss, comps, grads = port_loss_and_grad(raws, targets, batched, nc,
                                            nkpt, hyp, gr)
    np.testing.assert_allclose(comps, np.asarray(want_comps), **LOSS_TOL)
    np.testing.assert_allclose(loss, float(want_loss), rtol=2e-4)
    for g, w in zip(grads, want_grads, strict=True):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)
    if empty:
        assert comps[0] == 0 and comps[3] == 0 and np.isfinite(comps).all()
    else:
        assert (comps[:2] > 0).all()
        assert (comps[2] > 0) == (nc > 1)
        assert (comps[3:5] > 0).all() == (nkpt > 0)
