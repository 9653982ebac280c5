"""The bf16 fused group's TMA route (csrc/fused_elan_bf16.cu) on the CPU.

The route's plan (ops/elan_kernel.elan_tma_plan) is plain Python, so it is
checked here over every fused group of the seven zoo models and of the
extra cfg (tests/data/yolov7s-face-extra.json), bare and with the absorbed
pre conv, at b8@640, b16@512x640, b1@3840x3840 and b8@2176x2176 (input
shapes from a walk of the fused executor on the meta device): the route,
each conv's N tile, the shared memory, and the limits of TMA's boxes,
strides and corners. GROUP_CASES (12 and 6 channels) and every
NCHW-contiguous input stay on the cp.async kernel (csrc/fused_elan.cu).

A torch emulation of the kernel's walk (the strips, the block steps dealt
over the teams, the im2col boxes with TMA's zero fill, the packed weight
rows, one f32 accumulator over a block step's whole K, the epilogue's
rounding and masks, the zero rows of windows outside the image) is held
against the port's `reference_elan` in bf16, on small aligned shapes. The
kernel itself runs only on the card (tests/test_torch_gpu.py); no JAX
here: tests/test_torch_bf16.py holds `reference_elan` against the JAX
bf16 reference and Pallas kernel."""

import dataclasses
import functools
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from face_detection_multi_scale_tpu_torch.models import fused as FUSED
from face_detection_multi_scale_tpu_torch.models import model as TM
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.models.spec import (
    spec_from_yolo_yaml)
from face_detection_multi_scale_tpu_torch.ops import elan_kernel as E

# the cases of tests/test_fused_elan.py (the first six) with their (h, w),
# as the card tests hold them, without JAX
from test_torch_gpu import GROUP_CASES, GROUP_HW

EXTRA_CFG = (Path(__file__).resolve().parent / "data"
             / "yolov7s-face-extra.json")
SIZES = ((8, 640, 640), (16, 512, 640), (1, 3840, 3840), (8, 2176, 2176))
SMS = 132
GROUP_REL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: beside other workers its pool oversubscribes
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_spec(name):
    if name == "yolov7s-face-extra":
        return spec_from_yolo_yaml(json.loads(EXTRA_CFG.read_text()), name)
    return TZ.get_spec(name)


MODELS = tuple(TZ.available()) + ("yolov7s-face-extra",)


@functools.cache
def group_calls(name, absorb_pre, batch, h, w):
    """(x shape, ElanShape) of every fused_elan call of one fused forward
    of `name` at (batch, h, w), from the executor run on the meta
    device."""
    spec = model_spec(name).resolve()
    with torch.device("meta"):
        net = TM.YoloFace(spec)
    blocks = FUSED.find_elan_blocks(spec, absorb_pre=absorb_pre)
    seen = []

    def record(x, weights, shape):
        hh, ww = E._check(x, weights, shape)
        seen.append((tuple(x.shape), shape))
        return torch.empty(x.shape[0], shape.cout, hh, ww, device="meta")

    mp = pytest.MonkeyPatch()
    mp.setattr(FUSED, "fused_elan", record)
    try:
        with torch.no_grad():
            FUSED.fused_apply(net, torch.zeros(batch, h, w, 3, device="meta"),
                              blocks)
    finally:
        mp.undo()
    assert len(seen) == len(blocks)
    return tuple(seen)


def check_plan(plan, shape, batch, h, w):
    """Every limit the kernel and TMA put on a plan."""
    assert plan.route == "tma"
    assert plan.smem_bytes == E.TMA_SMEM <= 227 * 1024
    assert 1 <= plan.cluster <= 8 and plan.grid == plan.teams * plan.cluster
    assert plan.grid <= SMS and plan.teams <= plan.n_tiles
    assert plan.n_tiles == batch * plan.strips
    assert plan.strips * plan.th >= h > (plan.strips - 1) * plan.th
    assert plan.halo in (0, shape.n_chain)
    assert (plan.halo == 0) == (h <= E.TMA_SINGLE_ROWS)
    assert len(plan.maps) <= E.TMA_MAX_MAPS
    assert len(plan.convs) == (2 + ("a" in shape.members) + shape.n_chain
                               + shape.has_pre)
    # the boxes: 128 positions x 64 channels (im2col), 64 x 64 (weights)
    assert max(E.TMA_BM, E.TMA_KC, 64) <= E.BOX_LIMIT
    assert E.TMA_KC * 2 == 128  # the 128-byte swizzle's row
    for m in plan.maps:
        for stride in (2 * m.c, 2 * m.w * m.c, 2 * m.n_stride):
            assert stride % 16 == 0 and stride < 2 ** 40
        assert max(m.c, m.w, m.h, m.n) < 2 ** 31
        assert (2 * m.off) % 16 == 0
        assert all(-128 <= v <= 127 for v in (*m.lower, *m.upper))
        assert 1 <= m.stride <= 8
        # the bounding box holds at least one position each way
        assert m.w - 1 + m.upper[0] >= m.lower[0]
        assert m.h - 1 + m.upper[1] >= m.lower[1]
    for r in plan.regions:
        assert r.off % 64 == 0 and r.rows == plan.th + 2 * r.o
    assert plan.ws_elems >= max(r.off + plan.teams * r.rows * w * r.c
                                for r in plan.regions)
    assert plan.w_rows < 2 ** 31
    w_row = 0
    for c in plan.convs:
        assert c.bn in E.TMA_BN and c.c_out % 8 == 0
        # the narrowest N tile that holds c_out, halved only for a
        # cluster that would otherwise leave ranks idle
        want = next((b for b in E.TMA_BN if b >= c.c_out), E.TMA_BN[-1])
        assert c.bn <= want
        if c.bn < want:
            rows = min(plan.th + 2 * c.o_dst, h)
            steps = -(-rows * w // E.TMA_BM) * -(-c.c_out // (2 * c.bn))
            assert steps < plan.cluster
        assert c.w_row == w_row
        w_row += c.k_steps * c.c_out
        assert 1 <= len(c.srcs) <= E.TMA_MAX_MEMBERS
        for s in c.srcs:
            assert 0 <= s.map < len(plan.maps) and s.cin % 8 == 0
            m = plan.maps[s.map]
            assert (s.lw, s.lh) == m.lower and s.stride == m.stride
            assert m.c == s.cin and (m.base == "x") == s.image
            assert -128 <= s.lw <= 127 and -128 <= s.lh <= 127
        # the kernel's int coordinates: positions of the window
        assert (plan.th + 2 * c.o_dst) * w * max(plan.teams, batch) < 2 ** 31
    assert w_row == plan.w_rows


@pytest.mark.parametrize("name", MODELS)
def test_plan_every_zoo_group(name):
    """Every fused group of the model, bare and with the pre conv, at the
    four serving shapes lands on the TMA route with a plan TMA and the
    card take; w6's 64-wide convs keep a 64-channel N tile."""
    seen = 0
    for absorb_pre in (False, True):
        for batch, h, w in SIZES:
            for xs, shape in group_calls(name, absorb_pre, batch, h, w):
                s = shape.pre_stride if shape.has_pre else 1
                x = torch.empty(xs, dtype=torch.bfloat16, device="meta",
                                memory_format=torch.channels_last)
                assert E.tma_shape_ok(shape), shape
                ws = [torch.empty(t, dtype=torch.bfloat16 if len(t) == 4
                                  else torch.float32, device="meta")
                      for t in E.weight_shapes(shape)]
                assert E.elan_route(x, ws, shape) == "tma"
                assert E.elan_route(x.contiguous(), ws, shape) == "cp.async"
                plan = E.elan_tma_plan(shape, batch, xs[2] // s, xs[3] // s,
                                       SMS)
                check_plan(plan, shape, batch, xs[2] // s, xs[3] // s)
                if shape.cch == 64 and shape.ccv == 64:
                    assert all(c.bn == 64 for c in plan.convs
                               if c.c_out == 64)
                seen += 1
    groups = {"yolov7-lite-s": 0, "yolov7-lite-t": 0}.get(name, 1)
    assert (seen > 0) == bool(groups)


def conv_layout(plan):
    """What the packed weights depend on: each conv's name, width, first
    weight row and sources (taps, channels, concat offset)."""
    return [(c.name, c.c_out, c.w_row,
             [(s.taps, s.cin, s.w_off) for s in c.srcs]) for c in plan.convs]


@pytest.mark.parametrize("name", MODELS)
def test_packing_fits_every_size(name):
    """pack_tma_weights lays the kernels out by the plan at 1 x 1: at
    every serving shape the plan's convs, sources and weight rows are
    those, so weights packed once serve every size."""
    for absorb_pre in (False, True):
        for batch, h, w in SIZES:
            for xs, shape in group_calls(name, absorb_pre, batch, h, w):
                s = shape.pre_stride if shape.has_pre else 1
                plan = E.elan_tma_plan(shape, batch, xs[2] // s,
                                       xs[3] // s, SMS)
                one = E.elan_tma_plan(shape, 1, 1, 1, 1)
                assert conv_layout(plan) == conv_layout(one)
                assert plan.w_rows == one.w_rows


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_weights_carry_tma_packing(dtype):
    """models/fused.elan_weights builds each group's weights as an
    ElanWeights: in bf16 with the TMA route's packing of its kernels
    (pack_tma_weights' rows, each conv's first K step the kernel's first
    64 input channels of its first tap), in float32 with none; the
    packing counts among its tensors (what a mesh replicates)."""
    spec = TZ.get_spec("yolov7-tiny-face").resolve()
    torch.manual_seed(0)
    net = TM.YoloFace(spec).eval()
    blocks = FUSED.find_elan_blocks(spec, absorb_pre=True)
    got = FUSED.elan_weights(net, blocks, dtype)
    assert len(got) >= len(blocks) > 0
    for blk, ws in got.items():
        assert isinstance(ws, E.ElanWeights) and ws.shape == blk.shape
        assert [t.dtype for t in ws if t.dim() == 4] == [dtype] * (
            len(ws) // 2)
        if dtype == torch.float32:
            assert ws.tma is None and ws.tensors() == list(ws)
            continue
        plan = E.elan_tma_plan(blk.shape, 1, 1, 1, 1)
        assert ws.tma.shape == (plan.w_rows, E.TMA_KC)
        assert ws.tensors()[-1] is ws.tma
        by_name = E.conv_weights(blk.shape, ws)
        for c in plan.convs:
            src = c.srcs[0]
            cin = min(src.cin, E.TMA_KC)
            want = by_name[c.name][0][:, src.w_off:src.w_off + cin, 0, 0]
            assert torch.equal(ws.tma[c.w_row:c.w_row + c.c_out, :cin],
                               want)
            assert not ws.tma[c.w_row:c.w_row + c.c_out, cin:].any()


@pytest.mark.parametrize("idx", range(6))
def test_group_cases_route_to_cp_async(idx):
    """GROUP_CASES: an NCHW input goes to the cp.async kernel; the 12- and
    6-channel cases are no shape the TMA route takes, so even a
    channels_last input does not reach it (the executor hands them NCHW)."""
    shape = E.ElanShape(**GROUP_CASES[idx])
    b, (h, w) = 2, GROUP_HW[idx]
    c = shape.pre_cin if shape.has_pre else shape.cin
    x = torch.empty(b, c, h, w, dtype=torch.bfloat16)
    ws = [torch.empty(t, dtype=torch.bfloat16 if len(t) == 4
                      else torch.float32) for t in E.weight_shapes(shape)]
    assert E.elan_route(x, ws, shape) == "cp.async"
    ragged = any(v % 8 for v in (shape.cin, shape.ccv, shape.cch,
                                 shape.cout, shape.pre_cin))
    assert E.tma_shape_ok(shape) == (not ragged)
    if ragged:
        with pytest.raises(ValueError):
            E.elan_route(x.to(memory_format=torch.channels_last), ws, shape)


def test_route_rules():
    """float32 channels_last, more than four chain convs and misaligned
    pointers are refused by the TMA route."""
    shape = E.ElanShape(cin=16, ccv=16, cch=16, cout=16, n_chain=2,
                        members=("y2", "y1", "b", "a"))
    ws = [torch.empty(t, dtype=torch.bfloat16 if len(t) == 4
                      else torch.float32) for t in E.weight_shapes(shape)]
    x = torch.empty(2, 16, 8, 8, dtype=torch.bfloat16).to(
        memory_format=torch.channels_last)
    assert E.elan_route(x, ws, shape) == "tma"
    with pytest.raises(ValueError):
        E.elan_route(x.float(), [t.float() for t in ws], shape)
    long = dataclasses.replace(shape, n_chain=5, members=("y5", "b", "a"))
    assert not E.tma_shape_ok(long)
    flat = torch.empty(2 * 16 * 8 * 8 + 1, dtype=torch.bfloat16)
    odd = flat[1:].view(2, 8, 8, 16).permute(0, 3, 1, 2)
    assert odd.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        E.elan_route(odd, ws, shape)
    bias = torch.empty(17)[1:]          # a bias 4 bytes off 16
    with pytest.raises(ValueError):
        E.elan_route(x, ws[:-1] + [bias], shape)


# ---------------------------------------------------------------------------
# the emulation of csrc/fused_elan_bf16.cu's walk
# ---------------------------------------------------------------------------

def im2col_box(flat, m, c, w0, h0, n0, dx, dy):
    """TMA's im2col box over map `m` of the flat bf16 tensor `flat`: 128
    positions x 64 channels from c. The positions walk the bounding box
    [lower, dim - 1 + upper] of W, then of H, then N, from (w0, h0, n0) in
    steps of the traversal stride; each reads (w + dx, h + dy); whatever
    lies outside the tensor (channels past C too) reads as zero."""
    s = m.stride
    nw = (m.w - 1 + m.upper[0] - m.lower[0]) // s + 1
    nh = (m.h - 1 + m.upper[1] - m.lower[1]) // s + 1
    assert (w0 - m.lower[0]) % s == 0 and (h0 - m.lower[1]) % s == 0
    start = (n0 * nh + (h0 - m.lower[1]) // s) * nw + (w0 - m.lower[0]) // s
    lin = start + torch.arange(E.TMA_BM)
    n = lin // (nh * nw)
    iw = m.lower[0] + (lin % nw) * s + dx
    ih = m.lower[1] + (lin // nw % nh) * s + dy
    ok = (n < m.n) & (iw >= 0) & (iw < m.w) & (ih >= 0) & (ih < m.h)
    ch = c + torch.arange(E.TMA_KC)
    cok = ch < m.c
    idx = (m.off + n[:, None] * m.n_stride + (ih[:, None] * m.w
           + iw[:, None]) * m.c + ch[None, :])
    idx = torch.where(ok[:, None] & cok[None, :], idx, torch.zeros_like(idx))
    out = flat[idx].float()
    return torch.where(ok[:, None] & cok[None, :], out, torch.zeros_like(out))


def weight_box(packed, row, bn):
    """bn rows of the packed weights from `row` (64-row boxes; rows past
    the end read as zero)."""
    out = torch.zeros(bn, E.TMA_KC)
    part = packed[row:row + bn].float()
    out[:part.shape[0]] = part
    return out


def act_fn(name):
    return {"silu": F.silu, "relu": F.relu,
            "leaky": lambda v: F.leaky_relu(v, 0.1)}[name]


def emulate(x, weights, shape, plan):
    """The kernel's output for NCHW bf16 x, as csrc/fused_elan_bf16.cu
    computes it from `plan`: NaN-filled workspace and output, so a read of
    what nothing wrote, or a position nothing stored, shows."""
    b = x.shape[0]
    s = shape.pre_stride if shape.has_pre else 1
    h, w = x.shape[2] // s, x.shape[3] // s
    flat_x = x.permute(0, 2, 3, 1).contiguous().reshape(-1)
    ws = torch.full((plan.ws_elems,), float("nan"), dtype=torch.bfloat16)
    out = torch.full((b, h, w, shape.cout), float("nan"),
                     dtype=torch.bfloat16)
    packed = E.pack_tma_weights(shape, weights)
    biases = {c.name: E.conv_weights(shape, weights)[c.name][1]
              for c in plan.convs}
    act = act_fn(shape.act)
    for team in range(plan.teams):
        for tile in range(team, plan.n_tiles, plan.teams):
            n, ty = tile // plan.strips, tile % plan.strips * plan.th
            for c in plan.convs:
                wy0 = ty - c.o_dst
                y_lo = max(wy0, 0)
                m_all = max(min(ty + plan.th + c.o_dst, h) - y_lo, 0) * w
                n_nb = -(-c.c_out // c.bn)
                for t in range(-(-m_all // E.TMA_BM) * n_nb):
                    m0, n0 = t // n_nb * E.TMA_BM, t % n_nb * c.bn
                    y, xx = y_lo + m0 // w, m0 % w
                    acc = torch.zeros(E.TMA_BM, c.bn)
                    row = c.w_row + n0
                    for src in c.srcs:
                        m = plan.maps[src.map]
                        flat = flat_x if src.image else ws
                        k = 3 if src.taps == 9 else 1
                        col = src.lw + xx * src.stride
                        hrow = src.lh + (y * src.stride if src.image
                                         else y - wy0)
                        nn = n if src.image else team
                        for cb in range(0, src.cin, E.TMA_KC):
                            for tap in range(src.taps):
                                a = im2col_box(flat, m, cb, col, hrow, nn,
                                               tap % k, tap // k)
                                acc += a @ weight_box(packed, row, c.bn).T
                                row += c.c_out
                    co = n0 + torch.arange(c.bn)
                    bias = torch.zeros(c.bn)
                    bias[co < c.c_out] = biases[c.name][co[co < c.c_out]]
                    val = act(acc + bias).to(torch.bfloat16)
                    pos = m0 + torch.arange(E.TMA_BM)
                    keep_r = pos < m_all
                    keep_c = co < c.c_out
                    py, px = y_lo + pos // w, pos % w
                    for r in torch.nonzero(keep_r).flatten().tolist():
                        v = val[r, keep_c]
                        lo, hi = n0, n0 + int(keep_c.sum())
                        if c.dst < 0:
                            out[n, py[r], px[r], lo:hi] = v
                        else:
                            reg = plan.regions[c.dst]
                            at = reg.off + ((team * reg.rows + int(py[r])
                                             - wy0) * w + int(px[r])) * c.c_out
                            ws[at + lo:at + hi] = v
                if c.dst >= 0 and plan.halo > 0:
                    reg = plan.regions[c.dst]
                    wh = plan.th + 2 * c.o_dst
                    for j in range(wh):
                        if 0 <= wy0 + j < h:
                            continue
                        at = reg.off + (team * reg.rows + j) * w * c.c_out
                        ws[at:at + w * c.c_out] = 0
    return out.permute(0, 3, 1, 2)


def random_group(shape, b, h, w, seed):
    """bf16 x and kernels, float32 biases, scaled so the activations stay
    near 1 through the chain."""
    g = torch.Generator().manual_seed(seed)
    c = shape.pre_cin if shape.has_pre else shape.cin
    s = shape.pre_stride if shape.has_pre else 1
    x = torch.randn(b, c, h * s, w * s, generator=g).bfloat16()
    ws = []
    for t in E.weight_shapes(shape):
        if len(t) == 4:
            fan = t[1] * t[2] * t[3]
            ws.append((torch.randn(t, generator=g) * 1.5 / fan ** 0.5)
                      .bfloat16())
        else:
            ws.append(torch.randn(t, generator=g) * 0.1)
    return x, ws


EMU_CASES = [
    # (name, shape kwargs, (b, h, w), (single rows, strip rows), n_sm)
    ("cin16 one strip", dict(cin=16, ccv=16, cch=16, cout=32, n_chain=2,
                             members=("y2", "y1", "b", "a")),
     (2, 6, 9), (40, 32), 4),
    ("cin32 strips ragged", dict(cin=32, ccv=16, cch=16, cout=32, n_chain=2,
                                 members=("y2", "y1", "b", "a"),
                                 act="leaky"),
     (1, 11, 13), (4, 4), 5),
    ("pre stride 2 relu", dict(cin=16, ccv=16, cch=8, cout=24, n_chain=2,
                               members=("y2", "b", "a"), act="relu",
                               pre_cin=8, pre_stride=2),
     (2, 7, 6), (3, 3), 3),
    ("cin32 w6-like y4", dict(cin=32, ccv=16, cch=16, cout=72, n_chain=4,
                              members=("y4", "y3", "y2", "y1", "b", "a")),
     (1, 9, 10), (4, 3), 8),
    ("no a, pre stride 1", dict(cin=16, ccv=8, cch=16, cout=16, n_chain=3,
                                members=("y3", "b"), pre_cin=16,
                                pre_stride=1, act="leaky"),
     (2, 5, 7), (2, 2), 6),
]


@pytest.mark.parametrize("case", EMU_CASES, ids=[c[0] for c in EMU_CASES])
def test_emulated_walk_matches_reference(case, monkeypatch):
    """The emulated kernel against reference_elan in bf16 (1e-2 of max
    |plain|): one-strip images, strips with a halo and a ragged last
    strip, the pre conv at stride 1 and 2, teams that walk several strips
    and clusters whose block steps leave ranks idle."""
    _, kw, (b, h, w), (single, strip), n_sm = case
    monkeypatch.setattr(E, "TMA_SINGLE_ROWS", single)
    monkeypatch.setattr(E, "TMA_STRIP_ROWS", strip)
    shape = E.ElanShape(**kw)
    assert E.tma_shape_ok(shape)
    x, ws = random_group(shape, b, h, w, seed=len(kw) + h)
    plan = E.elan_tma_plan(shape, b, h, w, n_sm)
    check_plan(plan, shape, b, h, w)
    assert plan.halo == (0 if h <= single else shape.n_chain)
    got = emulate(x, ws, shape, plan)
    want = E.reference_elan(x, ws, shape)
    assert torch.isfinite(got.float()).all()
    err = float((got.float() - want.float()).abs().max())
    assert err <= GROUP_REL * float(want.float().abs().max()), err


def test_cpu_entry_keeps_memory_format():
    """On the CPU fused_elan runs reference_elan; a channels_last x gives
    a channels_last output of the same values."""
    shape = E.ElanShape(cin=16, ccv=8, cch=8, cout=16, n_chain=2,
                        members=("y2", "y1", "b", "a"))
    x, ws = random_group(shape, 1, 6, 5, seed=3)
    want = E.fused_elan(x, ws, shape)
    got = E.fused_elan(x.to(memory_format=torch.channels_last), ws, shape)
    assert got.is_contiguous(memory_format=torch.channels_last)
    err = float((got.float() - want.float()).abs().max())
    assert err <= GROUP_REL * float(want.float().abs().max()), err
