"""The int8 conv's launch plan (ops/qconv_kernel.qconv_plan) on the CPU.

The plan is plain Python, so its routes, tiles and splits are checked here
on every int8 conv of the seven zoo models at b8@640 and of w6 at the
2176x3840 TTA scale (shapes from the compute-free structural walk on the
meta device). A torch emulation of csrc/qconv.cu's wgmma route (the
producer's TMA coordinates, TMA's im2col traversal with its zero fill, the
weight boxes, the K split over a cluster, the epilogue's masks) is held
exactly against `conv_sums`, as tests/test_torch_probe_mm.py emulates
probe_mm.cu's tiling. The kernel itself runs only on the card
(tests/test_torch_gpu.py)."""

import functools

import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu_torch.models import model as TM
from face_detection_multi_scale_tpu_torch.models import quant as TQ
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.ops import qconv_kernel as QK

BATCH, SIZE = 8, 640
TTA_HW = (2176, 3840)  # the w6 pyramid's 3840 scale, letterboxed


@functools.cache
def conv_shapes(name, hw=(SIZE, SIZE), batch=BATCH):
    """((b, h, w, cin), (cout, kh, kw, cin/g), stride, pads, groups) of
    every int8 conv of `name`, in walk order, from the float walk of the
    structural calibration on the meta device."""
    spec = TZ.get_spec(name).resolve()
    with torch.device("meta"):
        net = TM.YoloFace(spec)
    seen = []
    real = TQ._conv_f32

    def record(desc, x, w, b):
        cout, cg, kh, kw = w.shape  # OIHW here, OHWI for the kernel
        seen.append(((batch,) + tuple(x.shape[1:]), (cout, kh, kw, cg),
                     desc.s, (desc.pads[0][0], desc.pads[1][0]),
                     desc.groups))
        return real(desc, x, w, b)

    mp = pytest.MonkeyPatch()
    mp.setattr(TQ, "_conv_f32", record)
    try:
        TQ._trace(spec, net, torch.zeros(1, *hw, 3, device="meta"))
    finally:
        mp.undo()
    return tuple(seen)


def plans(shapes, x_align=16, w_align=16):
    return [QK.qconv_plan(b, h, w, cin, cout, kh, kw, s, g, x_align, w_align,
                          pads)
            for (b, h, w, cin), (cout, kh, kw, _), s, pads, g in shapes]


def check_cover(plan, shape):
    """The grid's tiles cover M and N exactly once, and the split divides
    the K steps."""
    (b, h, w, cin), (cout, kh, kw, _), s, pads, g = shape
    ho, wo = QK.out_hw(h, w, (kh, kw), s, pads)
    m = b * ho * wo
    if plan.route == "direct":
        assert plan.grid == (-(-m * cout // QK.DIRECT_THREADS), 1)
        assert plan.grid[0] * QK.DIRECT_THREADS >= m * cout
        return
    tiles_m, tiles_n = -(-m // plan.bm), -(-cout // plan.bn)
    assert 1 <= plan.split <= QK.SPLIT_MAX
    assert plan.k_steps % plan.split == 0
    if plan.route == "wgmma":
        # one cluster a tile, or at most a block an SM walking the tiles
        tiles = tiles_m * tiles_n
        assert plan.grid == ((tiles * plan.split, 1) if plan.split > 1
                             else (min(tiles, QK.SMS), 1))
        assert plan.split == 1 or tiles * plan.split <= QK.SMS
        assert plan.bk in (32, 64, 128) and cin % 16 == 0
        assert plan.k_steps == kh * kw * -(-cin // plan.bk)
        assert plan.bk * (plan.k_steps // (kh * kw)) - cin < 32
        assert plan.bn in (64, 128) and plan.vec == 16
        assert plan.k_steps // plan.split >= min(plan.k_steps,
                                                 QK.SPLIT_MIN_STEPS)
    else:
        assert plan.grid == (tiles_m, tiles_n)
        assert (plan.bm, plan.bn, plan.bk) == QK.MMA_TILE
        assert plan.split == 1
        assert plan.k_steps == -(-kh * kw * cin // plan.bk)


def want_route(shape):
    """direct for groups > 1; wgmma for 16-byte channel runs (at 16-byte
    aligned pointers), except a K under WGMMA_MIN_K bytes whose 128 x BN
    tiles outnumber the SMs; mma for the rest."""
    (b, h, w, cin), (cout, kh, kw, _), s, pads, g = shape
    if g > 1:
        return "direct"
    if cin % 16:
        return "mma"
    ho, wo = QK.out_hw(h, w, (kh, kw), s, pads)
    bn = 128 if cout % 128 == 0 else 64
    tiles = -(-b * ho * wo // 128) * -(-cout // bn)
    return ("mma" if kh * kw * cin < QK.WGMMA_MIN_K and tiles > QK.SMS
            else "wgmma")


@pytest.mark.parametrize("name", TZ.available())
def test_plan_every_zoo_conv(name):
    """Routes as stated (`want_route`), and mma for any misaligned
    pointer; every tile plan covers its conv."""
    shapes = conv_shapes(name)
    got = plans(shapes)
    for plan, shape in zip(got, shapes):
        assert plan.route == want_route(shape), shape
        check_cover(plan, shape)
    for x_align, w_align in ((1, 16), (16, 8), (4, 4)):
        for plan, shape in zip(plans(shapes, x_align, w_align), shapes):
            assert plan.route == ("direct" if shape[4] > 1 else "mma")
            check_cover(plan, shape)
            if plan.route == "mma":
                cin = shape[0][3]
                assert plan.vec == next(
                    v for v in (16, 8, 4, 1) if cin % v == 0
                    and x_align % v == 0 and w_align % v == 0)
    routes = [p.route for p in got]
    if name in ("yolov7-w6-face", "yolov7-w6", "yolov7-tiny-face",
                "yolov7-face"):
        # every conv but the stem (Cin 3, or 12 after ReOrg)
        assert routes[1:] == ["wgmma"] * (len(routes) - 1)
        assert routes[0] == "mma"
    want = {"yolov7-w6-face": (107, 106, 0), "yolov7-tiny-face": (55, 54, 0),
            "yolov7-lite-t": (62, 29, 21)}.get(name)
    if want:
        assert (len(routes), routes.count("wgmma"),
                routes.count("direct")) == want


@pytest.mark.parametrize("b,h,cin,cout,k,sms,route", [
    (8, 320, 16, 8, 1, 132, "mma"),     # lite-t's 320-px 1x1: 6400 tiles
    (8, 80, 48, 48, 1, 132, "mma"),     # 400 tiles, K 48
    (8, 40, 48, 48, 1, 132, "wgmma"),   # 100 tiles: one wave
    (8, 80, 48, 48, 1, 400, "wgmma"),   # one wave on a larger card
    (8, 160, 64, 32, 1, 132, "wgmma"),  # tiny's K 64 at 160 px
    (8, 80, 32, 32, 3, 132, "wgmma"),   # K 288
])
def test_route_rule(b, h, cin, cout, k, sms, route):
    """Short K (under WGMMA_MIN_K bytes) goes to mma only where the wgmma
    tiles outnumber the card's SMs."""
    plan = QK.qconv_plan(b, h, h, cin, cout, k, k, 1, 1, 16, 16, sms=sms)
    assert plan.route == route


@pytest.mark.parametrize("name", ["yolov7-w6-face", "yolov7-tiny-face"])
def test_small_maps_split(name):
    """The maps of 20 px and less at b8 split K over a cluster where their
    tiles cannot fill the card; the large maps never split."""
    shapes = conv_shapes(name)
    split = 0
    for plan, shape in zip(plans(shapes), shapes):
        (b, h, w, _), (cout, kh, kw, _), s, pads, _ = shape
        ho, wo = QK.out_hw(h, w, (kh, kw), s, pads)
        tiles = -(-b * ho * wo // plan.bm) * -(-cout // plan.bn)
        if plan.split > 1:
            split += 1
            assert ho <= 20 and tiles < QK.SMS
        if tiles >= QK.SMS:
            assert plan.split == 1
    assert split > 0


def test_plan_w6_tta_scale():
    """w6 at the 2176x3840 scale (b1): the same routes, every tile plan
    covering its conv."""
    shapes = conv_shapes("yolov7-w6-face", TTA_HW, 1)
    got = plans(shapes)
    assert [p.route for p in got] == ["mma"] + ["wgmma"] * (len(got) - 1)
    for plan, shape in zip(got, shapes):
        check_cover(plan, shape)  # a split only where tiles fall short


def test_split_for():
    """Splits are divisors of the K steps, at most the portable cluster
    size, keep the grid to one wave, and never go below SPLIT_MIN_STEPS
    steps a block."""
    for tiles in (1, 7, 28, 75, 131, 132, 500):
        for steps in (1, 2, 4, 8, 9, 12, 16, 18, 27, 36, 54, 144):
            s = QK.split_for(tiles, steps)
            assert 1 <= s <= QK.SPLIT_MAX and steps % s == 0
            if s > 1:
                assert steps // s >= QK.SPLIT_MIN_STEPS
                assert tiles * s <= QK.SMS  # one wave
    assert QK.split_for(28, 36) == 3  # w6's 10-px 3x3 convs at 512
    assert QK.split_for(14, 1) == 1


def test_plan_row_and_align():
    plan = QK.qconv_plan(8, 10, 10, 512, 512, 3, 3, 1, 1, 16, 16)
    assert plan.row() == (2, 128, 128, 128, 3, 36, 84, 1, 16)
    assert QK.qconv_plan(8, 10, 10, 512, 512, 3, 3, 1, 1, 16, 16,
                         (1, 1)) == plan
    assert [QK.ptr_align(p) for p in (0, 1, 2, 12, 48, 4096 + 8)] == [
        16, 1, 2, 4, 16, 8]
    assert QK.qconv_plan(1, 9, 9, 24, 8, 3, 3, 2, 24, 16, 16).row()[0] == 0


# ---------------------------------------------------------------------------
# an emulation of the wgmma route's addressing
# ---------------------------------------------------------------------------

def im2col_box(x, c, w0, h0, n0, dx, dy, span, pixels, lower, upper,
               stride):
    """TMA's im2col box: `pixels` rows of `span` channels from c. The
    pixels walk the bounding box [lower, dim - 1 + upper] of W, then of H,
    then the images, from (w0, h0, n0) in steps of the traversal stride;
    each reads x at (w + dx, h + dy); whatever lies outside x (channels
    past Cin too) reads as zero."""
    b, h, w, cin = x.shape
    out = torch.zeros(pixels, span, dtype=torch.int64)
    pw, ph, n = w0, h0, n0
    for r in range(pixels):
        iw, ih = pw + dx, ph + dy
        if n < b and 0 <= ih < h and 0 <= iw < w and c < cin:
            run = x[n, ih, iw, c:c + span]
            out[r, :run.numel()] = run
        pw += stride
        if pw > w - 1 + upper[0]:
            pw = lower[0]
            ph += stride
            if ph > h - 1 + upper[1]:
                ph = lower[1]
                n += 1
    return out


def weight_box(w2, k, n0, span, bn):
    """The 2-D tiled box of the (Cout, K) weights: bn rows from n0, span K
    bytes from k, zeros outside."""
    cout, kk = w2.shape
    out = torch.zeros(bn, span, dtype=torch.int64)
    part = w2[n0:n0 + bn, k:k + span]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def emulate_wgmma(x, w, stride, pads, plan):
    """The int32 sums (M, Cout) as csrc/qconv.cu's wgmma route computes
    them: each cluster's walk over the tiles, per tile and rank the
    producer's window corner of the tile's first pixel, K steps (tap,
    channel run) with their TMA boxes, the partial tiles of a cluster
    summed by rank 0, the stores masked to M and Cout. Also returns how
    many times each output was written."""
    b, h, wd, cin = x.shape
    cout, kh, kw, _ = w.shape
    ho, wo = QK.out_hw(h, wd, (kh, kw), stride, pads)
    m = b * ho * wo
    span, bm, bn = plan.bk, plan.bm, plan.bn
    chunks = -(-cin // span)
    assert plan.k_steps == kh * kw * chunks
    lower = (-pads[1], -pads[0])
    upper = (pads[1] - (kw - 1), pads[0] - (kh - 1))
    w2 = w.reshape(cout, -1).long()
    y = torch.zeros(m, cout, dtype=torch.int64)
    writes = torch.zeros(m, cout, dtype=torch.int64)
    nk = plan.k_steps // plan.split
    tiles_n = -(-cout // bn)
    tiles = -(-m // bm) * tiles_n
    clusters = plan.grid[0] // plan.split
    for cluster in range(clusters):
        # the cluster's blocks walk tiles cluster, + clusters, ...; rank 0
        # gathers each tile's partial sums and stores it
        for t in range(cluster, tiles, clusters):
            m0, n0 = (t // tiles_n) * bm, (t % tiles_n) * bn
            img, rem = divmod(m0, ho * wo)
            oh, ow = divmod(rem, wo)
            w0, h0 = ow * stride - pads[1], oh * stride - pads[0]
            acc = torch.zeros(bm, bn, dtype=torch.int64)
            for rank in range(plan.split):
                for j in range(nk):
                    step = rank * nk + j
                    tap, ch = divmod(step, chunks)
                    c = ch * span
                    dy, dx = divmod(tap, kw)
                    a = im2col_box(x, c, w0, h0, img, dx, dy, span, bm,
                                   lower, upper, stride)
                    acc += a @ weight_box(w2, tap * cin + c, n0, span, bn).T
            rows = min(bm, m - m0)
            cols = min(bn, cout - n0)
            y[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
            writes[m0:m0 + rows, n0:n0 + cols] += 1
    return y, writes


@pytest.mark.parametrize("b,h,w,cin,cout,k,stride,pads,split", [
    (2, 7, 9, 32, 40, 3, 1, (1, 1), None),   # one tile across two images
    (3, 7, 7, 64, 64, 3, 1, (1, 1), 3),      # a tile from mid-image
    (2, 9, 7, 48, 64, 3, 2, (1, 1), 3),      # stride 2, half-empty runs
    (3, 6, 6, 64, 192, 1, 1, (0, 0), None),  # 1x1, N tiles of 64
    (1, 11, 13, 16, 24, 3, 2, (1, 0), None),  # asymmetric pads, Cin 16
    (1, 12, 12, 256, 128, 3, 2, (1, 1), 6),  # 128-byte runs, split 6
    (2, 8, 8, 32, 32, 3, 2, (1, 1), None),   # even map, stride 2
    (1, 10, 10, 128, 136, 3, 1, (0, 2), 3),  # a 1-channel N tail
])
def test_wgmma_addressing_emulation(b, h, w, cin, cout, k, stride, pads,
                                    split):
    """The emulated wgmma route equals the exact int32 conv, each output
    written once, for the plan's own split or a forced one."""
    rng = np.random.default_rng(cin + cout + k + stride)
    x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin),
                                      dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, k, k, cin),
                                       dtype=np.int8))
    plan = QK._route_plan("wgmma", b, h, w, cin, cout, k, k, stride, 1, 16,
                          16, pads, split=split)
    if split is None:
        assert plan == QK.qconv_plan(b, h, w, cin, cout, k, k, stride, 1,
                                     16, 16, pads)
    got, writes = emulate_wgmma(x, wq, stride, pads, plan)
    want = QK.conv_sums(x, wq, stride, pads).reshape(-1, cout)
    assert bool((writes == 1).all())
    assert torch.equal(got, want.long())


def test_persistent_walk_emulation():
    """Fewer blocks than tiles (a card of 3 SMs): each block walks several
    tiles, and every output is still written once and exact."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 12, 13, 32),
                                      dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (200, 3, 3, 32),
                                       dtype=np.int8))
    plan = QK._route_plan("wgmma", 2, 12, 13, 32, 200, 3, 3, 1, 1, 16, 16,
                          (1, 1), sms=3)
    assert plan.split == 1 and plan.grid == (3, 1)  # 2 x 4 tiles
    assert plan == QK.qconv_plan(2, 12, 13, 32, 200, 3, 3, 1, 1, 16, 16,
                                 sms=3)
    got, writes = emulate_wgmma(x, wq, 1, (1, 1), plan)
    want = QK.conv_sums(x, wq, 1, (1, 1)).reshape(-1, 200)
    assert bool((writes == 1).all())
    assert torch.equal(got, want.long())
