"""The port's serving postprocess (ops/nms.py) against the JAX package's
`non_max_suppression(backend="xla")` on the same decoded rows.

Equality is exact, field by field and index by index: both sides gate,
sort (stable, equal scores in index order), gather and suppress with the
same f32 operations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.ops import nms as JN
from face_detection_multi_scale_tpu_torch.ops import nms as TN


def make_pred(bs, n, seed, nc=1, nkpt=5, tie_levels=None):
    """Decoded-row-like (bs, n, 5+nc+3*nkpt) f32: boxes clustered so that
    suppression has work, obj/cls in (0, 1), landmarks anywhere."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 640, (bs, 24, 2))
    pick = rng.integers(0, 24, (bs, n))
    cxy = np.take_along_axis(centers, pick[..., None], 1) \
        + rng.normal(0, 12, (bs, n, 2))
    wh = rng.uniform(8, 90, (bs, n, 2))
    obj = rng.uniform(0, 1, (bs, n, 1))
    cls = rng.uniform(0, 1, (bs, n, nc))
    if tie_levels:  # massive ties in conf = obj * cls
        obj[:] = 1.0
        cls = rng.integers(1, tie_levels + 1, (bs, n, nc)) / tie_levels
    kpt = rng.uniform(-50, 700, (bs, n, 3 * nkpt))
    return np.concatenate([cxy, wh, obj, cls, kpt], -1).astype(np.float32)


def assert_same(got: TN.Detections, want: JN.Detections):
    for name in ("boxes", "scores", "classes", "extras", "valid",
                 "n_gated"):
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("bs,n,nc,max_cand,max_det,conf,iou,ties", [
    (2, 1500, 1, 1024, 300, 0.02, 0.45, None),  # K = max_candidates,
                                               # n_gated > max_candidates
    (2, 700, 1, 4096, 300, 0.3, 0.5, None),    # K = N < max_candidates
    (3, 900, 1, 4096, 40, 0.05, 0.7, None),    # survivors > max_det
    (2, 800, 1, 512, 100, 0.1, 0.5, 7),        # tied confidences
    (2, 600, 2, 4096, 300, 0.25, 0.45, None),  # class offsets, nc=2
])
def test_nms_matches_jax_xla(bs, n, nc, max_cand, max_det, conf, iou, ties):
    pred = make_pred(bs, n, seed=n + bs, nc=nc, tie_levels=ties)
    want = JN.non_max_suppression(jnp.asarray(pred), conf, iou, nc=nc,
                                  nkpt=5, max_candidates=max_cand,
                                  max_det=max_det, backend="xla")
    got = TN.non_max_suppression(torch.from_numpy(pred), conf, iou, nc=nc,
                                 max_candidates=max_cand, max_det=max_det)
    assert_same(got, want)
    # the cases exercise what they claim
    k = min(max_cand, n)
    n_gated = got.n_gated.numpy()
    if max_cand < n:
        assert (n_gated > max_cand).any()
    if max_det == 40:
        assert (got.valid.sum(1) == max_det).all()
    assert got.valid.sum() > 0
    assert (got.scores.numpy()[~got.valid.numpy()] == 0).all()
    assert got.boxes.shape == (bs, min(max_det, k), 4)


def test_invalid_rows_never_kept():
    """NEG_INF-masked rows tie massively; none may ever come out valid."""
    pred = make_pred(2, 500, seed=1)
    pred[:, 100:, 4] = 0.0  # fail the objectness gate
    got = TN.non_max_suppression(torch.from_numpy(pred), 0.3, 0.5,
                                 max_candidates=400, max_det=500)
    keep_rows = got.scores.numpy()[got.valid.numpy()]
    assert (keep_rows > 0.3).all()
    assert (got.n_gated.numpy() <= 100).all()
    assert got.valid.sum(1).max() <= 100


def test_keep_matrix_matches_jax():
    pred = make_pred(1, 400, seed=2, tie_levels=5)
    boxes = pred[0, :, :4].copy()
    boxes[:, 2:] += boxes[:, :2]
    scores = pred[0, :, 5] * pred[0, :, 4]
    scores[::7] = TN.NEG_INF
    want_idx, want_v = JN.nms_keep_matrix(boxes, scores, 0.5, max_det=400)
    idx, v = TN.nms_keep_matrix(torch.from_numpy(boxes),
                                torch.from_numpy(scores), 0.5)
    np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def test_detections_to_numpy_and_truncation_stats():
    pred = make_pred(2, 700, seed=3)
    dets = TN.non_max_suppression(torch.from_numpy(pred), 0.2, 0.5,
                                  max_candidates=256)
    want = JN.detections_to_numpy(JN.non_max_suppression(
        jnp.asarray(pred), 0.2, 0.5, max_candidates=256, backend="xla"))
    for g, w in zip(TN.detections_to_numpy(dets), want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert TN.truncation_stats(dets.n_gated.numpy(), 256) == \
        JN.truncation_stats(np.asarray(dets.n_gated.numpy()), 256)
