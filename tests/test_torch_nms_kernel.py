"""The port's greedy-NMS keep mask (ops/nms_kernel.py) against the JAX
package's Pallas kernel (interpret mode) and its `nms_keep_matrix`.

On the CPU `nms_keep` runs the plain version; the CUDA kernel itself is
held against the plain version on the card (chip_smoke.py and
tests/test_torch_gpu.py). Equality is exact: the keep mask is a boolean function
of f32 IoUs computed with the same operations in the same order."""

import math
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.ops import nms as JN
from face_detection_multi_scale_tpu.ops.pallas_nms import nms_keep_pallas
from face_detection_multi_scale_tpu_torch.ops import nms_kernel as K
from face_detection_multi_scale_tpu_torch.ops.boxes import box_iou


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


TILE = 64  # rows / columns of a tile of csrc/nms_keep.cu == bits a word


def decode_pair(p, n_tiles):
    """nms_mask_kernel's block index -> (row tile, column tile), the same
    float formula and fix-ups."""
    t2 = 2.0 * n_tiles + 1.0
    rt = int((t2 - math.sqrt(t2 * t2 - 8.0 * p)) / 2.0)
    rt = max(0, min(rt, n_tiles - 1))

    def first(r):
        return r * n_tiles - r * (r - 1) // 2

    while rt > 0 and first(rt) > p:
        rt -= 1
    while rt + 1 < n_tiles and first(rt + 1) <= p:
        rt += 1
    return rt, rt + p - first(rt)


def emulate_passes(boxes, valid, thr):
    """A torch emulation of the seq kernel's two passes with its tile, word
    and bit indexing: pass 1 writes, for every decoded (row tile, column
    tile) block, the 64-bit word of each row of the row tile (bit c: column
    64 * ct + c is later, both valid, IoU > thr; no division where the
    boxes do not intersect and thr >= 0) into a scratch of garbage, as
    torch.empty would leave it; pass 2 walks the tiles with the `removed`
    words, resolves a tile from its diagonal words alone, then ORs the
    kept rows' words right of the diagonal. Returns keep (B, K) bool."""
    boxes, valid = torch.from_numpy(boxes), torch.from_numpy(valid)
    b, k = valid.shape
    n_tiles = -(-k // TILE)
    kp = n_tiles * TILE
    # column j (later) against row i (earlier): IoU(j, i) as the kernel
    # calls overlaps(column, row)
    a, c = boxes[:, None, :, :], boxes[:, :, None, :]  # [b, i, j]
    iw = (torch.minimum(a[..., 2], c[..., 2])
          - torch.maximum(a[..., 0], c[..., 0])).clamp(min=0)
    ih = (torch.minimum(a[..., 3], c[..., 3])
          - torch.maximum(a[..., 1], c[..., 1])).clamp(min=0)
    inter = iw * ih
    iou = box_iou(boxes, boxes).transpose(1, 2)
    idx = torch.arange(k)
    bits = ((iou > thr) & ~((inter == 0) & (thr >= 0))
            & (idx[None, :] > idx[:, None]) & valid[:, :, None]
            & valid[:, None, :])
    bits = torch.nn.functional.pad(bits, (0, kp - k))
    weights = torch.ones(TILE, dtype=torch.int64) << torch.arange(TILE)
    words = (bits.view(b, k, n_tiles, TILE).long() * weights).sum(-1)
    mask = torch.full((b, k, n_tiles), 0x5A5A5A5A5A5A5A5A, dtype=torch.int64)
    seen = set()
    for p in range(n_tiles * (n_tiles + 1) // 2):
        rt, ct = decode_pair(p, n_tiles)
        assert rt <= ct < n_tiles and (rt, ct) not in seen
        seen.add((rt, ct))
        rows = slice(rt * TILE, min(k, (rt + 1) * TILE))
        mask[:, rows, ct] = words[:, rows, ct]
    full = (1 << TILE) - 1
    keep = torch.zeros(b, k, dtype=torch.bool)
    for n in range(b):
        m = [[int(v) & full for v in row] for row in mask[n].tolist()]
        removed = [0] * n_tiles
        for t in range(n_tiles):
            rows = range(t * TILE, min(k, (t + 1) * TILE))
            vb = sum(1 << (i - t * TILE) for i in rows if valid[n, i])
            cur, kept = removed[t], 0
            for i in rows:
                bit = 1 << (i - t * TILE)
                if vb & bit and not cur & bit:
                    kept |= bit
                    cur |= m[i][t]
            for i in rows:
                keep[n, i] = bool(kept >> (i - t * TILE) & 1)
                if kept >> (i - t * TILE) & 1:
                    for w in range(t + 1, n_tiles):
                        removed[w] |= m[i][w]
    return keep.numpy()


def padded_pallas_keep(boxes, valid, thr):
    """nms_keep_pallas (interpret) at any K: invalid rows pad K to the
    kernel's multiple of 1024 and change no earlier row's keep."""
    b, k = valid.shape
    kp = -(-k // 1024) * 1024
    pb = np.zeros((b, kp, 4), np.float32)
    pv = np.zeros((b, kp), bool)
    pb[:, :k], pv[:, :k] = boxes, valid
    return np.asarray(nms_keep_pallas(jnp.asarray(pb), jnp.asarray(pv), thr,
                                      interpret=True))[:, :k]


EMULATION_CASES = (
    [("case", b, k, thr, frac, False) for b, k, thr, frac in CASES]
    + [("ragged", 2, k, 0.5, 0.7, False) for k in (1, 7, 63, 64, 65, 300,
                                                   1000)]
    + [("degenerate", 2, 1024, thr, 0.8, True) for thr in (0.3, 0.5)])


@pytest.mark.parametrize("kind,b,k,thr,frac,degenerate", EMULATION_CASES,
                         ids=[f"{c[0]}-b{c[1]}-k{c[2]}-t{c[3]}"
                              for c in EMULATION_CASES])
def test_two_pass_emulation_matches_plain_and_pallas(kind, b, k, thr, frac,
                                                     degenerate):
    boxes, _, valid = sorted_candidates(b, k, seed=k + 29, frac_valid=frac)
    if degenerate:
        boxes = with_degenerate_boxes(boxes, seed=k)
    got = emulate_passes(boxes, valid, thr)
    np.testing.assert_array_equal(got, port_keep(boxes, valid, thr))
    np.testing.assert_array_equal(got, padded_pallas_keep(boxes, valid, thr))


def test_mask_words():
    assert K.mask_words(8, 4096) * 8 == 16_777_216      # 16.8 MB
    assert K.mask_words(2, 16384) * 8 == 67_108_864    # 64 MB
    assert K.mask_words(3, 65) == 3 * 65 * 2
    for t in [*range(1, 70), 256, 257]:  # K up to 4416, and 16384
        pairs = {decode_pair(p, t) for p in range(t * (t + 1) // 2)}
        assert pairs == {(r, c) for r in range(t) for c in range(r, t)}


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
