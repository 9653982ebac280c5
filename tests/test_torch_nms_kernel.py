"""The port's greedy-NMS keep mask (ops/nms_kernel.py) against the JAX
package's Pallas kernel (interpret mode) and its `nms_keep_matrix`.

On the CPU `nms_keep` runs the plain version; the CUDA kernel itself is
held against the plain version on the card (chip_smoke.py and
tests/test_torch_gpu.py). Equality is exact: the keep mask is a boolean function
of f32 IoUs computed with the same operations in the same order."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.ops import nms as JN
from face_detection_multi_scale_tpu.ops.pallas_nms import nms_keep_pallas
from face_detection_multi_scale_tpu_torch.ops import nms_kernel as K


def sorted_candidates(b, k, seed, frac_valid=1.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 600, (b, k, 2)).astype(np.float32)
    wh = rng.uniform(5, 150, (b, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = np.sort(rng.uniform(0, 1, (b, k)).astype(np.float32))[:, ::-1]
    valid = np.zeros((b, k), bool)
    valid[:, :int(k * frac_valid)] = True
    return boxes, np.ascontiguousarray(scores), valid


def with_degenerate_boxes(boxes, seed):
    """Duplicates (exact copies of earlier boxes), ties of one box with
    several later ones, and zero-area boxes (0/0 IoU = NaN, never > thr)."""
    rng = np.random.default_rng(seed)
    b, k, _ = boxes.shape
    boxes = boxes.copy()
    for i in range(b):
        dst = rng.choice(np.arange(1, k), size=k // 8, replace=False)
        src = rng.integers(0, dst)  # an earlier row for each
        boxes[i, dst] = boxes[i, src]
        zero = rng.choice(k, size=k // 16, replace=False)
        boxes[i, zero, 2] = boxes[i, zero, 0]          # zero width
        flat = rng.choice(k, size=k // 16, replace=False)
        boxes[i, flat, 3] = boxes[i, flat, 1]          # zero height
        pt = rng.choice(k, size=4, replace=False)
        boxes[i, pt, 2:] = boxes[i, pt, :2]            # points
    return boxes


def port_keep(boxes, valid, thr):
    keep = K.nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), thr)
    assert keep.dtype == torch.bool and keep.shape == valid.shape
    return keep.numpy()


def matrix_keep(boxes, scores, valid, thr):
    """JAX nms_keep_matrix as a (B, K) mask."""
    b, k = valid.shape
    out = np.zeros((b, k), bool)
    for i in range(b):
        idx, v = JN.nms_keep_matrix(
            boxes[i], np.where(valid[i], scores[i], JN.NEG_INF), thr,
            max_det=k)
        out[i, np.asarray(idx)[np.asarray(v)]] = True
    return out


CASES = [(2, 1024, 0.5, 1.0), (1, 2048, 0.3, 1.0), (3, 1024, 0.7, 1.0),
         (1, 1024, 0.5, 0.4),  # invalid tail crosses tile boundaries
         (1, 1024, 0.9, 1.0)]  # long suppression chains


@pytest.mark.parametrize("b,k,thr,frac", CASES)
def test_plain_matches_pallas_and_matrix(b, k, thr, frac):
    boxes, scores, valid = sorted_candidates(b, k, seed=k + 13,
                                             frac_valid=frac)
    got = port_keep(boxes, valid, thr)
    want = np.asarray(nms_keep_pallas(jnp.asarray(boxes), jnp.asarray(valid),
                                      thr, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, matrix_keep(boxes, scores, valid,
                                                   thr))
    assert not got[~valid].any()


@pytest.mark.parametrize("thr", [0.3, 0.5])
def test_plain_degenerate_boxes(thr):
    boxes, scores, valid = sorted_candidates(2, 1024, seed=5,
                                             frac_valid=0.8)
    boxes = with_degenerate_boxes(boxes, seed=6)
    got = port_keep(boxes, valid, thr)
    want = np.asarray(nms_keep_pallas(jnp.asarray(boxes), jnp.asarray(valid),
                                      thr, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, matrix_keep(boxes, scores, valid,
                                                   thr))
    assert not got[~valid].any()


@pytest.mark.parametrize("k", [1, 7, 300, 1000])
def test_plain_ragged_k_matches_matrix(k):
    """K that is no multiple of 1024 (the CUDA kernel takes any K)."""
    boxes, scores, valid = sorted_candidates(2, k, seed=k, frac_valid=0.7)
    got = port_keep(boxes, valid, 0.5)
    np.testing.assert_array_equal(got, matrix_keep(boxes, scores, valid,
                                                   0.5))


def test_plain_is_sequential_greedy():
    """The fixpoint equals the textbook loop: walk in score order, keep a
    valid box unless it overlaps a kept one by IoU > thr."""
    boxes, _, valid = sorted_candidates(1, 300, seed=3, frac_valid=0.9)
    boxes = with_degenerate_boxes(boxes, seed=4)
    t = torch.from_numpy(boxes[0])
    from face_detection_multi_scale_tpu_torch.ops.boxes import box_iou
    iou = box_iou(t, t).numpy()
    want = np.zeros(300, bool)
    for i in range(300):
        want[i] = valid[0, i] and not any(
            want[j] and iou[i, j] > 0.45 for j in range(i))
    np.testing.assert_array_equal(port_keep(boxes, valid, 0.45)[0], want)


def test_wrapper_rejects_bad_inputs():
    boxes = torch.zeros(2, 8, 4)
    valid = torch.ones(2, 8, dtype=torch.bool)
    with pytest.raises(ValueError):
        K.nms_keep(boxes[..., :3], valid, 0.5)
    with pytest.raises(ValueError):
        K.nms_keep(boxes, valid[:, :7], 0.5)
    with pytest.raises(TypeError):
        K.nms_keep(boxes.double(), valid, 0.5)
    with pytest.raises(TypeError):
        K.nms_keep(boxes, valid.int(), 0.5)


def test_import_and_cpu_path_need_no_build():
    """Importing the module and running it on CPU tensors neither builds
    nor loads the kernel, so it works without nvcc or a card."""
    code = (
        "import subprocess\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('subprocess started: ' + repr(a))\n"
        "subprocess.run = subprocess.Popen = boom\n"
        "import torch\n"
        "from face_detection_multi_scale_tpu_torch.ops import nms_kernel as K\n"
        "b = torch.tensor([[[0., 0., 10., 10.], [1., 1., 10., 10.]]])\n"
        "keep = K.nms_keep(b, torch.ones(1, 2, dtype=torch.bool), 0.5)\n"
        "assert keep.tolist() == [[True, False]], keep\n"
        "assert K._library.cache_info().currsize == 0\n"
        "assert K.nms_keep.launches == 0\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={"PATH": "", "CUDA_VISIBLE_DEVICES":
                                          "", "PYTHONPATH": ":".join(
                                              sys.path)})
    assert done.returncode == 0, done.stderr
