"""The port's greedy-NMS keep mask (ops/nms_kernel.py) against the JAX
package's Pallas kernel (interpret mode) and its `nms_keep_matrix`.

On the CPU `nms_keep` runs the plain version; the CUDA kernel itself is
held against the plain version on the card (chip_smoke.py and
tests/test_torch_gpu.py). Equality is exact: the keep mask is a boolean function
of f32 IoUs computed with the same operations in the same order."""

import functools
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


def pass1_words(boxes, valid, thr):
    """A torch emulation of pass 1 (nms_mask_kernel) with its tile, word and
    bit indexing: for every decoded (row tile, column tile) block, the
    64-bit word of each row of the row tile (bit c: column 64 * ct + c is
    later, both valid, IoU > thr; no division where the boxes do not
    intersect and thr >= 0) goes into a scratch of garbage, as torch.empty
    would leave it. Returns the scratch (B, K, ceil(K / 64)) int64."""
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
    return mask


FULL = (1 << TILE) - 1


def valid_words(valid_row, k, n_tiles):
    """One image's valid bits as 64-bit words, row i at bit i % 64 of word
    i // 64."""
    return [sum(1 << (i - w * TILE)
                for i in range(w * TILE, min(k, (w + 1) * TILE))
                if valid_row[i]) for w in range(n_tiles)]


def emulate_passes(boxes, valid, thr):
    """A torch emulation of the seq kernel's two passes: pass 1's words
    (`pass1_words`); pass 2 walks the tiles with the `removed` words,
    resolves a tile from its diagonal words alone, then ORs the kept rows'
    words right of the diagonal. Returns keep (B, K) bool."""
    mask = pass1_words(boxes, valid, thr)
    b, k, n_tiles = mask.shape
    keep = torch.zeros(b, k, dtype=torch.bool)
    for n in range(b):
        m = [[int(v) & FULL for v in row] for row in mask[n].tolist()]
        removed = [0] * n_tiles
        vbits = valid_words(valid[n], k, n_tiles)
        for t in range(n_tiles):
            rows = range(t * TILE, min(k, (t + 1) * TILE))
            vb = vbits[t]
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


def split_word(r, c, words):
    """csrc/nms_keep.cu's split_word: the first word of rank r of c, the
    least w with w (w + 1) c >= r words (words + 1)."""
    target = r * words * (words + 1)
    w = max(0, min(words, int(math.sqrt(target / c + 0.25) - 0.5)))
    while w > 0 and (w - 1) * w * c >= target:
        w -= 1
    while w < words and w * (w + 1) * c < target:
        w += 1
    return w


def emulate_fixpoint(boxes, valid, thr, cluster):
    """A torch emulation of the fixpoint version: pass 1's words
    (`pass1_words`, garbage left of the diagonal), then the sweep kernel
    with its word-to-block split: every rank of the cluster keeps its own
    copy of the keep words, double-buffered; in a sweep rank r ORs the
    words [lo, hi) it owns of every kept row above them (never a word left
    of a row's diagonal), writes its new words into every rank's next
    buffer and, where a word changed, the sweep's number into every rank's
    flag of that parity; after the barrier each rank reads its own flag.
    Returns keep (B, K) bool and sweeps (B,)."""
    mask = pass1_words(boxes, valid, thr)
    b, k, n_tiles = mask.shape
    lo = [split_word(r, cluster, n_tiles) for r in range(cluster + 1)]
    assert lo[0] == 0 and lo[-1] == n_tiles and lo == sorted(lo)
    keep = np.zeros((b, k), bool)
    sweeps = np.zeros(b, np.int64)
    for n in range(b):
        m = [[int(v) & FULL for v in row] for row in mask[n].tolist()]
        vbits = valid_words(valid[n], k, n_tiles)
        bufs = [[list(vbits), [None] * n_tiles] for _ in range(cluster)]
        flags = [[0, 0] for _ in range(cluster)]
        sweep = 0
        while True:
            cur, nxt = sweep & 1, (sweep + 1) & 1
            removed = []
            for r in range(cluster):  # every rank from its own copy
                own = [0] * (lo[r + 1] - lo[r])
                for u in range(lo[r + 1]):  # row tiles above the words
                    kb = bufs[r][cur][u]
                    for c in range(TILE):
                        if kb >> c & 1:
                            i = u * TILE + c
                            for w in range(max(lo[r], u), lo[r + 1]):
                                assert w >= i // TILE  # pass 1 wrote it
                                own[w - lo[r]] |= m[i][w]
                removed.append(own)
            sweep += 1
            for r in range(cluster):
                for w in range(lo[r], lo[r + 1]):
                    new = vbits[w] & ~removed[r][w - lo[r]] & FULL
                    for p in range(cluster):
                        bufs[p][nxt][w] = new
                    if new != bufs[r][cur][w]:
                        for p in range(cluster):
                            flags[p][cur] = sweep
            stop = {flags[p][cur] != sweep or sweep == k
                    for p in range(cluster)}
            assert len(stop) == 1  # every rank takes the same decision
            if stop.pop():
                break
        final = bufs[0][sweep & 1]
        assert all(bufs[p][sweep & 1] == final for p in range(cluster))
        for r in range(cluster):  # each rank writes its own words' rows
            for i in range(lo[r] * TILE, min(k, lo[r + 1] * TILE)):
                keep[n, i] = bool(final[i // TILE] >> (i % TILE) & 1)
        sweeps[n] = sweep
    return keep, sweeps


def padded_pallas_keep(boxes, valid, thr, kernel_version="seq"):
    """nms_keep_pallas (interpret) at any K: invalid rows pad K to the
    kernel's multiple of 1024 and change no earlier row's keep."""
    b, k = valid.shape
    kp = -(-k // 1024) * 1024
    pb = np.zeros((b, kp, 4), np.float32)
    pv = np.zeros((b, kp), bool)
    pb[:, :k], pv[:, :k] = boxes, valid
    return np.asarray(nms_keep_pallas(jnp.asarray(pb), jnp.asarray(pv), thr,
                                      interpret=True,
                                      kernel_version=kernel_version))[:, :k]


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


def chain_candidates(b, k):
    """Boxes 10 wide, 3 apart, in score order: each overlaps the next by
    IoU 7/13 > 0.5 and the one after by 4/16, so the keep mask alternates,
    each decision depends on the one before, and the Jacobi sweeps settle
    one candidate a sweep (K sweeps)."""
    x = np.arange(k, dtype=np.float32) * 3
    one = np.stack([x, np.zeros(k, np.float32), x + 10,
                    np.full(k, 10, np.float32)], 1)
    return (np.ascontiguousarray(np.broadcast_to(one, (b, k, 4))),
            np.ones((b, k), bool))


FIXPOINT_CASES = EMULATION_CASES + [("chain", 2, 200, 0.5, 1.0, False)]


@functools.cache
def fixpoint_case(kind, b, k, thr, frac, degenerate):
    """The inputs of a case and its references: the plain keep mask, the
    JAX fixpoint Pallas kernel's (interpret) and the plain sweep counts."""
    if kind == "chain":
        boxes, valid = chain_candidates(b, k)
    else:
        boxes, _, valid = sorted_candidates(b, k, seed=k + 31,
                                            frac_valid=frac)
        if degenerate:
            boxes = with_degenerate_boxes(boxes, seed=k + 1)
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    return (boxes, valid, port_keep(boxes, valid, thr),
            padded_pallas_keep(boxes, valid, thr, kernel_version="fixpoint"),
            K.fixpoint_sweeps_plain(tb, tv, thr).numpy())


@pytest.mark.parametrize("cluster", [1, 8, 16])
@pytest.mark.parametrize("kind,b,k,thr,frac,degenerate", FIXPOINT_CASES,
                         ids=[f"{c[0]}-b{c[1]}-k{c[2]}-t{c[3]}"
                              for c in FIXPOINT_CASES])
def test_fixpoint_emulation_matches_plain_pallas_and_sweeps(
        kind, b, k, thr, frac, degenerate, cluster):
    """The sweep kernel's split, buffers and flags over pass 1's words:
    the plain keep mask, the JAX fixpoint kernel's and the plain sweep
    counts, for clusters of 1, 8 and 16 (K = 65 at 16: blocks that own no
    word)."""
    boxes, valid, plain, pallas, sweeps = fixpoint_case(
        kind, b, k, thr, frac, degenerate)
    got, got_sweeps = emulate_fixpoint(boxes, valid, thr, cluster)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got_sweeps, sweeps)
    if kind == "chain":
        assert (got == (np.arange(k) % 2 == 0)).all()
        assert (got_sweeps == k).all()


@pytest.mark.parametrize("k", [1024, 2048])
def test_fixpoint_matches_jax_fixpoint(k):
    boxes, _, valid = sorted_candidates(2, k, seed=k + 1, frac_valid=0.9)
    got = K.nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5,
                     kernel_version="fixpoint").numpy()
    want = np.asarray(nms_keep_pallas(jnp.asarray(boxes), jnp.asarray(valid),
                                      0.5, interpret=True,
                                      kernel_version="fixpoint"))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        K.nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5,
                   kernel_version="matrix")


def test_fixpoint_sweeps_plain_counts():
    """Sweeps computed from keep = valid, the last one that changed
    nothing included, at most K: 1 when the first sweep changes nothing
    (no valid row, or no valid pair overlapping), 2 when one suppression
    settles everything, K on the alternating chain."""
    def count(boxes, valid):
        return K.fixpoint_sweeps_plain(torch.tensor(boxes),
                                       torch.tensor(valid), 0.5).tolist()

    apart = [[[0., 0., 10., 10.], [20., 0., 30., 10.], [40., 0., 50., 10.]]]
    assert count(apart, [[False] * 3]) == [1]
    assert count(apart, [[True] * 3]) == [1]
    pair = [[[0., 0., 10., 10.], [1., 0., 11., 10.], [40., 0., 50., 10.]]]
    assert count(pair, [[True] * 3]) == [2]
    boxes, valid = chain_candidates(2, 200)
    assert count(boxes, valid) == [200, 200]
    assert count(boxes[:, :7], valid[:, :7]) == [7, 7]


def test_sweep_ab_tool_variants_and_no_card(tmp_path, monkeypatch):
    """tools/nms_sweep_ab.py writes a variant as the source with the text
    replaced, takes "base" as the source itself, and exits without a
    card."""
    from face_detection_multi_scale_tpu_torch.ops import cuda_build
    from face_detection_multi_scale_tpu_torch.tools import nms_sweep_ab as AB

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    assert cuda_build.variant_source(K.SOURCE, "base", "ab0") == K.SOURCE
    path = cuda_build.variant_source(
        K.SOURCE, "kFixThreads = 512;=>kFixThreads = 1024;", "ab1")
    assert path.parent == tmp_path
    assert path.read_text() == K.SOURCE.read_text().replace(
        "kFixThreads = 512;", "kFixThreads = 1024;")
    with pytest.raises(SystemExit, match="no"):
        cuda_build.variant_source(K.SOURCE, "no such text=>x", "ab2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA"):
        AB.main(["base"])


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
