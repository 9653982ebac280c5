"""One fused E-ELAN group: the hand-written CUDA kernel and its plain version.

Counterpart of the JAX package's ops/pallas_elan.py. The YOLOv7 E-ELAN
group (reference cfg/yolov7-w6.yaml rows 15-24 and the head groups), each
conv followed by act(conv + bias) with BN already folded:

    x  = 3x3 stride-s conv of the input        (optional absorbed "pre")
    a  = 1x1(x),  b = 1x1(x)
    y1 = 3x3(b), ..., yn = 3x3(y_{n-1})        (SAME zero padding)
    out = 1x1(concat(members)),  members a subset of {a, b, y1..yn}

`fused_elan` replaces ops/pallas_elan.py::_elan_kernel (wrapper
`fused_elan`). Source: csrc/fused_elan.cu, CUDA C++ for sm_90a, compiled
by nvcc at first use (ops/cuda_build.py) and bound with ctypes.

What bounds it on the card: operations. In float32 the kernel computes
each conv on the tensor cores in 3xTF32 (every f32 operand split into two TF32 parts,
`tf32_split`, three TF32 products a multiply-add, f32 sums; wgmma), so
its bound is the group's FLOPs over 495 / 3 = 165 TFLOP/s, or its bytes
over 3.35 TB/s if larger. The result is within 1e-5 of max |plain| per
group (the JAX suite's bound), not bit-identical. The design keeps every
intermediate out of any tensor the caller sees, as the TPU kernel kept
them in VMEM: whole groups are computed for output tiles, recomputing the
intermediates on the tile's halo, in a private slice of a scratch
workspace in device memory (channels innermost) shared by a cluster of up
to 8 blocks that split each conv; K chunks are staged through a
three-stage cp.async ring (`elan_plan` picks the tiles and clusters;
PERF.md has the A/B evidence). See the source for the layout.

bfloat16 (the JAX package's `dtype=jnp.bfloat16`): x and the conv kernels
bf16, the biases float32, the output bf16. Each conv is one bf16
tensor-core product a multiply-add with f32 sums, then bias and
activation in f32 and a round to bf16 of every intermediate and of the
output, where the TPU kernel casts them (pallas_elan.py:407-432, 526);
the workspace holds bf16. The bound is the group's FLOPs over 989
TFLOP/s, or its bytes over 3.35 TB/s if larger. `reference_elan` rounds
at the same points. Two routes, one plan (`elan_route`), no fallback:
  * "tma": csrc/fused_elan_bf16.cu, a producer warp feeding a TMA /
    mbarrier ring, wgmma with A and B from shared memory, full-width
    strips (`elan_tma_plan`), for a channels_last x whose every channel
    count is a multiple of 8 (whole 16-byte runs), 16-byte aligned
    pointers and at most TMA_MAX_CHAIN chain convs; it writes a
    channels_last output;
  * "cp.async": the bf16 instantiation of csrc/fused_elan.cu
    (fdms_fused_elan_bf16), for an NCHW-contiguous x (and every float32
    group, its f32 instantiation); it writes NCHW.
The launches count apart: `fused_elan.launches` (float32),
`fused_elan.bf16_launches` (bf16, both routes) and
`fused_elan.bf16_tma_launches` (bf16, the "tma" route).

Layout: activations NCHW (bf16 also channels_last) and weights OIHW, the
executor's own tensors and torch's conv weights; the JAX
package's function takes NHWC / HWIO (tests transpose). The JAX kernel's
layout fields of `ElanShape` (im2col, flat_mm, im2col9, pack_ab,
concat_trans, host_pad, group, vmem_budget_mb) are Mosaic choices that
leave the math unchanged; they are kept so `apply_variant` round-trips,
and ignored here except `group`'s batch assertion. `strip_footprint` and
`choose_strip_height` plan TPU VMEM and are not ported.

On a CPU tensor `fused_elan` runs `reference_elan`, conv by conv; on a
CUDA tensor it launches the kernel or raises. Any other mix of dtypes
raises TypeError.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from face_detection_multi_scale_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "fused_elan.cu"
NVCC_FLAGS = cuda_build.BASE_FLAGS
WS_TILE_H = 40              # output tile of images larger than 2 * SMALL_IMAGE
WS_TILE_W = 40
SMALL_IMAGE = 20            # images up to this side are one tile
BLOCKS_PER_SM = 2           # grid per SM; one block is resident at a time
MAX_CHAIN = 8               # kMaxChain of the source
ACTS = {"silu": 0, "leaky": 1, "relu": 2}
# the bf16 TMA route (csrc/fused_elan_bf16.cu)
TMA_SOURCE = cuda_build.CSRC / "fused_elan_bf16.cu"
TMA_NVCC_FLAGS = cuda_build.BASE_FLAGS
TMA_STRIP_ROWS = 20         # output rows of a strip of a taller image
TMA_SINGLE_ROWS = 40        # images up to this height are one strip
TMA_MAX_CHAIN = 4           # kMaxConvs - 4 of the source
TMA_MAX_MEMBERS = 6         # kMaxSrc
TMA_MAX_MAPS = 16           # kMaxMaps
TMA_BM = 128                # positions a block step
TMA_KC = 64                 # channels a stage
TMA_STAGES = 4
TMA_BN = (64, 128)          # the N tiles the source instantiates
# kSmem: the ring (A 128 x 64, B 128 x 64 bf16 a stage), the f32 sums a
# block step hands to the epilogue (128 rows of 128 + 8 floats), the
# mbarriers, 1024 bytes of alignment
TMA_SMEM = (TMA_STAGES * (TMA_BM + TMA_BN[-1]) * TMA_KC * 2
            + TMA_BM * (TMA_BN[-1] + 8) * 4 + 16 * TMA_STAGES + 1024)
BOX_LIMIT = 256             # elements a TMA box dimension


@dataclasses.dataclass(frozen=True)
class ElanShape:
    """Static geometry of one fused ELAN group (a copy of the JAX
    package's, every field)."""
    cin: int              # input channels
    ccv: int              # width of the two 1x1 branches (a, b)
    cch: int              # width of the 3x3 chain convs
    cout: int             # transition conv output channels
    n_chain: int          # number of 3x3 convs in the chain
    members: Tuple[str, ...]  # concat order; entries in {a, b, y1..yn}
    act: str = "silu"     # activation of every conv in the group
    pre_cin: int = 0      # > 0: an absorbed 3x3 conv feeds the group
    pre_stride: int = 1
    # Mosaic layout choices of the TPU kernel (no effect on the math)
    im2col: bool = False
    flat_mm: bool = False
    im2col9: bool = False
    pack_ab: bool = False
    concat_trans: bool = False
    host_pad: bool = True
    group: int = 1
    vmem_budget_mb: int = 12
    # the TPU ablation that skips the SAME-pad zeroing (numerically
    # wrong); not ported: fused_elan raises when it is set
    debug_skip_mask: bool = False

    @property
    def has_pre(self) -> bool:
        return self.pre_cin > 0

    @property
    def halo(self) -> int:
        return self.n_chain

    def member_width(self, m: str) -> int:
        return self.ccv if m in ("a", "b") else self.cch

    @property
    def concat_width(self) -> int:
        return sum(self.member_width(m) for m in self.members)


def _act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "leaky":
        return lambda v: F.leaky_relu(v, negative_slope=0.1)
    if name == "relu":
        return F.relu
    raise ValueError(f"fused ELAN: unsupported activation {name!r}")


def weight_shapes(shape: ElanShape):
    """OIHW shapes of the flat weight list, biases as (C,)."""
    out = []
    if shape.has_pre:
        out += [(shape.cin, shape.pre_cin, 3, 3), (shape.cin,)]
    out += [(shape.ccv, shape.cin, 1, 1), (shape.ccv,)] * 2
    c_in = shape.ccv
    for _ in range(shape.n_chain):
        out += [(shape.cch, c_in, 3, 3), (shape.cch,)]
        c_in = shape.cch
    out += [(shape.cout, shape.concat_width, 1, 1), (shape.cout,)]
    return out


def reference_elan(x: torch.Tensor, weights: Sequence[torch.Tensor],
                   shape: ElanShape) -> torch.Tensor:
    """Plain PyTorch execution of the same folded group, conv by conv
    (pallas_elan.py::reference_elan in NCHW / OIHW). In bf16 each conv is
    a float32 conv of the bf16 values (exact products, f32 sums) plus the
    f32 bias, the activation in f32, then a cast to bf16, as the JAX
    reference and kernel round; in float32 the casts are no-ops."""
    act, dt = _act_fn(shape.act), x.dtype

    def conv(v, w, b, **kw):
        return act(F.conv2d(v.float(), w.float(), b, **kw)).to(dt)

    if shape.has_pre:
        x = conv(x, weights[0], weights[1], stride=shape.pre_stride,
                 padding=1)
        weights = weights[2:]
    wa, ba, wb, bb = weights[:4]
    outs = {"a": conv(x, wa, ba), "b": conv(x, wb, bb)}
    cur = outs["b"]
    for k in range(shape.n_chain):
        cur = conv(cur, weights[4 + 2 * k], weights[5 + 2 * k], padding=1)
        outs[f"y{k + 1}"] = cur
    wt, bt = weights[4 + 2 * shape.n_chain], weights[5 + 2 * shape.n_chain]
    cat = torch.cat([outs[m] for m in shape.members], dim=1)
    return conv(cat, wt, bt)


def tf32_split(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of the kernel's 3xTF32 products: big = v rounded to
    TF32 (10 mantissa bits, to nearest, ties away from zero: PTX
    cvt.rna.tf32.f32), small = the same rounding of v - big. Bit
    operations on float32; finite inputs."""
    def rna(t):
        u = t.contiguous().view(torch.int32)
        return ((u + 0x1000) & -0x2000).view(torch.float32)

    big = rna(v)
    return big, rna(v - big)


def _member_id(m: str) -> int:
    """The kernel's id of a member: -2 = a, -1 = b, k = y_{k+1}; -3 for a
    name that is none of these."""
    if m in ("a", "b"):
        return -2 if m == "a" else -1
    if m[:1] == "y" and m[1:].isdigit() and int(m[1:]) >= 1:
        return int(m[1:]) - 1
    return -3


def workspace_layout(shape: ElanShape, th: int, tw: int
                     ) -> Tuple[List[int], int]:
    """The one layout of a th x tw tile's workspace, which the kernel takes
    as given: the element offsets of its regions x (the pre conv's
    output; empty without pre), b, a (empty unless a member), y1..yn, and
    the total elements, each an element of the group's dtype (4 bytes in
    float32, 2 in bf16). Each region holds its window, channels innermost (a
    point's channels are contiguous): x and b the tile plus the halo
    n_chain, y_k the tile plus n_chain - k, a the bare tile."""
    p = shape.halo
    eh, ew = th + 2 * p, tw + 2 * p
    sizes = [shape.cin * eh * ew if shape.has_pre else 0,
             shape.ccv * eh * ew,
             shape.ccv * th * tw if "a" in shape.members else 0]
    sizes += [shape.cch * (eh - 2 * k) * (ew - 2 * k)
              for k in range(1, shape.n_chain + 1)]
    offsets = [sum(sizes[:i]) for i in range(len(sizes))]
    return offsets, sum(sizes)


def elan_plan(shape: ElanShape, batch: int, h: int, w: int,
              n_sm: int) -> Dict[str, object]:
    """How the kernel runs one group at (batch, h, w): the tile, its
    workspace layout (offsets and "floats", the elements of the group's
    dtype a team's slice holds), the cluster size and the grid.

    Tiles are the whole image up to SMALL_IMAGE a side (no recompute),
    half of it a side up to twice that, else WS_TILE_H x WS_TILE_W;
    clusters grow (up to 8, the portable size) as tiles get fewer, as far
    as BLOCKS_PER_SM blocks per SM hold them, so a group with few tiles
    still spreads over the card, and the teams of `cluster` blocks loop
    over the tiles, each with its own workspace slice. The rule and the
    sizes are from A/B timings on the card (tools/elan_plan_ab.py;
    PERF.md)."""
    if max(h, w) <= SMALL_IMAGE:
        th, tw = max(h, 1), max(w, 1)
    elif max(h, w) <= 2 * SMALL_IMAGE:
        th, tw = -(-h // 2), -(-w // 2)
    else:
        th, tw = WS_TILE_H, WS_TILE_W
    n = batch * (-(-h // th)) * (-(-w // tw))
    blocks = BLOCKS_PER_SM * n_sm
    cluster = max(1, min(8, blocks // n))
    teams = max(1, min(n, blocks // cluster))
    offsets, floats = workspace_layout(shape, th, tw)
    return {"tile_h": th, "tile_w": tw, "offsets": offsets, "floats": floats,
            "n_tiles": n, "cluster": cluster, "teams": teams,
            "grid": teams * cluster}


def recompute_share(shape: ElanShape, plan: Dict[str, object], h: int,
                    w: int) -> Dict[str, float]:
    """Positions the kernel computes over output positions, per conv (pre,
    b, a, y1..yn, out) and for the whole group weighted by each conv's
    multiply-adds a position: the halo's points inside the image, summed
    over the plan's tiles (`elan_plan`'s tiles, or an `elan_tma_plan`'s
    full-width strips, whose halo is 0 for a one-strip image). Neither
    route computes a window point outside the image: the TMA route stores
    such rows as zeros without computing them, and block steps' tails past
    a window's last position are not counted."""
    if isinstance(plan, TmaPlan):
        # full-width strips: the in-image rows of each strip's window
        th, tw, p = plan.th, w, plan.halo
    else:
        th, tw, p = plan["tile_h"], plan["tile_w"], shape.halo

    def points(o):  # in-image points of every tile's window with halo o
        o = max(o, 0)
        tot = 0
        for ty in range(0, h, th):
            ny = min(ty + th + o, h) - max(ty - o, 0)
            for tx in range(0, w, tw):
                tot += ny * (min(tx + tw + o, w) - max(tx - o, 0))
        return tot

    macs = {"b": shape.cin * shape.ccv, "a": shape.cin * shape.ccv}
    halo = {"b": p, "a": 0}
    if shape.has_pre:
        macs["pre"], halo["pre"] = 9 * shape.pre_cin * shape.cin, p
    for k in range(1, shape.n_chain + 1):
        macs[f"y{k}"] = 9 * (shape.ccv if k == 1 else shape.cch) * shape.cch
        halo[f"y{k}"] = p - k
    macs["out"], halo["out"] = shape.concat_width * shape.cout, 0
    if "a" not in shape.members:
        del macs["a"]
    share = {c: points(o) / (h * w) for c, o in halo.items() if c in macs}
    share["group"] = (sum(share[c] * macs[c] for c in macs)
                      / sum(macs.values()))
    return share


# ---------------------------------------------------------------------------
# the bf16 TMA route: one plan, in plain Python, that the kernel takes as
# given (csrc/fused_elan_bf16.cu)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TmaSrc:
    """One source of a conv: im2col map `map`, its lower corners (w, h),
    traversal stride, whether it is the group input (else a workspace
    region), taps (1 or 9) and channels; `w_off` is the first of its
    channels in the conv's OIHW weight."""
    map: int
    lw: int
    lh: int
    stride: int
    image: bool
    taps: int
    cin: int
    w_off: int

    @property
    def k_steps(self) -> int:
        return self.taps * -(-self.cin // TMA_KC)


@dataclasses.dataclass(frozen=True)
class TmaConv:
    """One conv of the group as the kernel runs it: `name` in (pre, b, a,
    y1..yn, out), its sources, output channels and N tile, destination
    region (-1: the output), output window rows ty - o_dst .. ty + th +
    o_dst, first packed weight row, stages a block step, and whether a
    cluster barrier follows."""
    name: str
    srcs: Tuple[TmaSrc, ...]
    c_out: int
    bn: int
    dst: int
    o_dst: int
    w_row: int
    sync: bool

    @property
    def k_steps(self) -> int:
        return sum(s.k_steps for s in self.srcs)


@dataclasses.dataclass(frozen=True)
class TmaMap:
    """One im2col tensor map: (c, w, h, n) bf16 at element `off` of the
    group input ("x") or the workspace ("ws"), n `n_stride` elements
    apart, the bounding box's lower and upper corners (w, h) and the
    traversal stride; boxes of TMA_BM positions x TMA_KC channels."""
    base: str
    off: int
    c: int
    w: int
    h: int
    n: int
    n_stride: int
    lower: Tuple[int, int]
    upper: Tuple[int, int]
    stride: int


@dataclasses.dataclass(frozen=True)
class TmaRegion:
    """A workspace region: `teams` windows of `rows` x w positions x `c`
    channels from element `off`; the window of a strip starting at row ty
    is rows ty - o .. ty + th + o."""
    name: str
    off: int
    c: int
    rows: int
    o: int


@dataclasses.dataclass(frozen=True)
class TmaPlan:
    """How the TMA route runs one bf16 group at (batch, h, w)."""
    route: str
    th: int               # output rows a strip
    halo: int             # rows of b's halo (0: one strip an image)
    strips: int
    n_tiles: int          # batch x strips
    cluster: int
    teams: int
    grid: int
    smem_bytes: int
    regions: Tuple[TmaRegion, ...]
    ws_elems: int
    maps: Tuple[TmaMap, ...]
    convs: Tuple[TmaConv, ...]
    w_rows: int           # rows of 64 bf16 of the packed weights

    def ints(self, batch: int, h: int, w: int, act: str) -> List[int]:
        """The int64 descriptor fdms_fused_elan_tma takes (its comment
        there gives the layout)."""
        out = [batch, h, w, self.th, self.strips, len(self.convs),
               self.cluster, self.grid, ACTS[act], int(self.halo > 0),
               len(self.maps), self.w_rows, len(self.regions)]
        for m in self.maps:
            out += [0 if m.base == "x" else 1, m.off, m.c, m.w, m.h, m.n,
                    m.n_stride, *m.lower, *m.upper, m.stride]
        for r in self.regions:
            out += [r.off, r.c, r.rows]
        for c in self.convs:
            out += [len(c.srcs), c.c_out, c.bn, c.dst, c.o_dst, c.w_row,
                    c.k_steps, int(c.sync), 0]
            for i in range(TMA_MAX_MEMBERS):
                if i < len(c.srcs):
                    t = c.srcs[i]
                    out += [t.map, t.lw, t.lh, t.stride, int(t.image),
                            t.taps, t.cin]
                else:
                    out += [0] * 7
        return out


def tma_shape_ok(shape: ElanShape) -> bool:
    """Whether the TMA route's source takes the group's shape: every
    channel count a multiple of 8 (a whole 16-byte run of bf16), at most
    TMA_MAX_CHAIN chain convs and TMA_MAX_MEMBERS members."""
    chans = [shape.cin, shape.ccv, shape.cch, shape.cout]
    if shape.has_pre:
        chans.append(shape.pre_cin)
    return (all(c % 8 == 0 and 0 < c < 32768 for c in chans)
            and 1 <= shape.n_chain <= TMA_MAX_CHAIN
            and len(shape.members) <= TMA_MAX_MEMBERS
            and shape.act in ACTS and shape.pre_stride in (1, 2))


def _tma_bn(c_out: int, m: int, cluster: int) -> int:
    """The N tile of a conv: the narrowest of TMA_BN that holds c_out
    (capped at the widest), halved while the conv's block steps (at `m`
    positions) leave ranks of the cluster without one."""
    bn = next((b for b in TMA_BN if b >= c_out), TMA_BN[-1])
    m_blocks = -(-m // TMA_BM)
    while bn > TMA_BN[0] and m_blocks * -(-c_out // bn) < cluster:
        bn //= 2
    return bn


def elan_tma_plan(shape: ElanShape, batch: int, h: int, w: int,
                  n_sm: int) -> TmaPlan:
    """The TMA route's plan (`_tma_plan`), cached per constants, shape and
    size: the wrapper asks once a launch."""
    return _tma_plan_cached(shape, batch, h, w, n_sm, TMA_STRIP_ROWS,
                            TMA_SINGLE_ROWS, TMA_BN)


@functools.lru_cache(maxsize=1024)
def _tma_plan_cached(shape, batch, h, w, n_sm, *constants) -> TmaPlan:
    return _tma_plan(shape, batch, h, w, n_sm)


def _tma_plan(shape: ElanShape, batch: int, h: int, w: int,
              n_sm: int) -> TmaPlan:
    """The TMA route's plan of one group at output size (batch, h, w): the
    strips, halo, cluster and grid, the workspace regions, the im2col maps
    (with their corners), and every conv's sources, N tile, window and
    weight rows. Plain Python; the kernel takes it as given.

    An image of at most TMA_SINGLE_ROWS rows is one strip without halo
    (each conv a SAME conv over the whole image); a taller one is strips
    of TMA_STRIP_ROWS rows with a halo of n_chain rows. One block an SM
    (the ring takes most of its shared memory); clusters of up to 8 blocks
    share a strip as far as the strips leave SMs over."""
    if h <= TMA_SINGLE_ROWS:
        th, halo = max(h, 1), 0
    else:
        th, halo = TMA_STRIP_ROWS, shape.n_chain
    strips = -(-h // th)
    n_tiles = batch * strips
    cluster = max(1, min(8, n_sm // max(n_tiles, 1)))
    teams = max(1, min(n_tiles, n_sm // cluster))

    regions: List[TmaRegion] = []
    off = 0

    def region(name, c, o):
        nonlocal off
        r = TmaRegion(name, off, c, th + 2 * o, o)
        regions.append(r)
        off += -(-teams * r.rows * w * c // 64) * 64
        return len(regions) - 1

    maps: List[TmaMap] = []

    def map_of(m: TmaMap) -> int:
        if m not in maps:
            maps.append(m)
        return maps.index(m)

    s = shape.pre_stride if shape.has_pre else 1
    c_img = shape.pre_cin if shape.has_pre else shape.cin

    def image_src(k, w_off, cin):
        pad = (k - 1) // 2
        m = TmaMap("x", 0, c_img, s * w, s * h, batch, s * h * s * w * c_img,
                   (-pad, -pad), (pad - (k - 1), pad - (k - 1)), s)
        return TmaSrc(map_of(m), -pad, -pad, s, True, k * k, cin, w_off)

    def region_src(ri, k, o_out, w_off):
        r = regions[ri]
        pad, d = (k - 1) // 2, r.o - o_out
        m = TmaMap("ws", r.off, r.c, w, r.rows, teams, r.rows * w * r.c,
                   (-pad, d - pad), (-pad, -d - pad), 1)
        return TmaSrc(map_of(m), -pad, d - pad, 1, False, k * k, r.c, w_off)

    def rows_in(o):
        return min(th + 2 * o, h)

    convs: List[dict] = []

    def conv(name, srcs, c_out, dst, o_dst, sync=True):
        convs.append(dict(name=name, srcs=tuple(srcs), c_out=c_out, dst=dst,
                          o_dst=o_dst, sync=sync))

    has_a = "a" in shape.members
    if shape.has_pre:
        rx = region("x", shape.cin, halo)
        conv("pre", [image_src(3, 0, shape.pre_cin)], shape.cin, rx, halo)
        feed = (lambda o_out: region_src(rx, 1, o_out, 0))
    else:
        feed = (lambda o_out: image_src(1, 0, shape.cin))
    rb = region("b", shape.ccv, halo)
    conv("b", [feed(halo)], shape.ccv, rb, halo, sync=not has_a)
    ra = None
    if has_a:
        ra = region("a", shape.ccv, 0)
        conv("a", [feed(0)], shape.ccv, ra, 0)
    ry = []
    prev = rb
    for k in range(1, shape.n_chain + 1):
        o = max(halo - k, 0)
        ry.append(region(f"y{k}", shape.cch, o))
        conv(f"y{k}", [region_src(prev, 3, o, 0)], shape.cch, ry[-1], o)
        prev = ry[-1]
    srcs, w_off = [], 0
    for m in shape.members:
        ri = ra if m == "a" else rb if m == "b" else ry[int(m[1:]) - 1]
        srcs.append(region_src(ri, 1, 0, w_off))
        w_off += shape.member_width(m)
    conv("out", srcs, shape.cout, -1, 0)

    done, w_row = [], 0
    for c in convs:
        bn = _tma_bn(c["c_out"], rows_in(c["o_dst"]) * w, cluster)
        tc = TmaConv(bn=bn, w_row=w_row, **c)
        w_row += tc.k_steps * tc.c_out
        done.append(tc)
    return TmaPlan(route="tma", th=th, halo=halo, strips=strips,
                   n_tiles=n_tiles, cluster=cluster, teams=teams,
                   grid=teams * cluster, smem_bytes=TMA_SMEM,
                   regions=tuple(regions), ws_elems=max(off, 64),
                   maps=tuple(maps), convs=tuple(done), w_rows=w_row)


def conv_weights(shape: ElanShape, weights: Sequence[torch.Tensor]
                 ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """The (OIHW kernel, bias) of each conv of the group by the plan's
    names (pre, b, a, y1..yn, out), from fused_elan's flat list."""
    ws = list(weights)
    out = {}
    if shape.has_pre:
        out["pre"] = (ws[0], ws[1])
        ws = ws[2:]
    out["a"], out["b"] = (ws[0], ws[1]), (ws[2], ws[3])
    for k in range(shape.n_chain):
        out[f"y{k + 1}"] = (ws[4 + 2 * k], ws[5 + 2 * k])
    out["out"] = (ws[-2], ws[-1])
    return out


def pack_tma_weights(shape: ElanShape,
                     weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kernels as the TMA route reads them: (w_rows, 64) bf16, each
    conv's K steps in the kernel's order (sources, then blocks of 64
    channels, then taps), a step's c_out x 64 block contiguous, zero past
    a source's channels. The plan's convs, sources and weight rows do not
    depend on the group's size, so the plan at 1 x 1 lays them out."""
    plan = elan_tma_plan(shape, 1, 1, 1, 1)
    by_name = conv_weights(shape, weights)
    blocks = []
    for c in plan.convs:
        wk = by_name[c.name][0]
        for src in c.srcs:
            k = 3 if src.taps == 9 else 1
            part = wk[:, src.w_off:src.w_off + src.cin].permute(0, 2, 3, 1)
            part = part.reshape(c.c_out, k * k, src.cin)
            nch = -(-src.cin // TMA_KC)
            part = F.pad(part, (0, nch * TMA_KC - src.cin))
            part = part.reshape(c.c_out, k * k, nch, TMA_KC)
            blocks.append(part.permute(2, 1, 0, 3).reshape(-1, TMA_KC))
    packed = torch.cat(blocks).to(torch.bfloat16).contiguous()
    assert packed.shape[0] == plan.w_rows, (packed.shape, plan.w_rows)
    return packed


class ElanWeights(list):
    """fused_elan's flat weight list for `shape`, holding besides, as
    `tma`, the TMA route's packing of its kernels (`pack_tma_weights`),
    made once here for a bf16 group the route takes (else None). The
    detector's groups are built so (models/fused.pack_elan_weights); a
    plain list is packed at each TMA launch."""

    def __init__(self, weights: Sequence[torch.Tensor], shape: ElanShape):
        super().__init__(weights)
        self.shape = shape
        self.tma = (pack_tma_weights(shape, self)
                    if self[0].dtype == torch.bfloat16
                    and tma_shape_ok(shape) else None)

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor held, the packing included."""
        return [*self, *([self.tma] if self.tma is not None else [])]


@functools.lru_cache(maxsize=1024)
def _plan_ints(plan: TmaPlan, batch: int, h: int, w: int, act: str):
    """plan.ints as the ctypes array fdms_fused_elan_tma takes, cached
    (the array is only read)."""
    ints = plan.ints(batch, h, w, act)
    return (ctypes.c_longlong * len(ints))(*ints)


def elan_route(x: torch.Tensor, weights: Sequence[torch.Tensor],
               shape: ElanShape) -> str:
    """The kernel route of a CUDA call: "tma" for a bf16, channels_last
    (and not NCHW-contiguous) x that the TMA route takes (`tma_shape_ok`;
    x and the biases, which the kernel reads in place, 16-byte aligned);
    "cp.async" (csrc/fused_elan.cu) for an NCHW-contiguous x with
    contiguous weights. Anything else raises."""
    if x.is_contiguous():
        if not all(t.is_contiguous() for t in weights):
            raise ValueError("fused ELAN takes contiguous tensors")
        return "cp.async"
    if (x.dtype == torch.bfloat16
            and x.is_contiguous(memory_format=torch.channels_last)
            and tma_shape_ok(shape) and x.data_ptr() % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in weights
                    if t.dim() == 1)):
        return "tma"
    raise ValueError(
        f"fused ELAN takes an NCHW-contiguous x, or a channels_last bf16 x "
        f"whose shape the TMA route takes; got {x.dtype} strides "
        f"{x.stride()} for {shape}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for fn in (lib.fdms_fused_elan, lib.fdms_fused_elan_bf16):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _tma_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_tma()))
    lib.fdms_fused_elan_tma.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_void_p]
    lib.fdms_fused_elan_tma.restype = ctypes.c_int
    lib.fdms_fused_elan_tma_smem.restype = ctypes.c_int
    if lib.fdms_fused_elan_tma_smem() != TMA_SMEM:
        raise RuntimeError(f"{TMA_SOURCE.name} takes "
                           f"{lib.fdms_fused_elan_tma_smem()} bytes of shared "
                           f"memory, the plan {TMA_SMEM}")
    return lib


def build():
    """Compile csrc/fused_elan.cu (once per source and flags); returns the
    shared library's path."""
    return cuda_build.build(SOURCE, NVCC_FLAGS)


def build_tma():
    """Compile csrc/fused_elan_bf16.cu, the bf16 TMA route (once per
    source and flags); returns the shared library's path."""
    return cuda_build.build(TMA_SOURCE, TMA_NVCC_FLAGS)


def _check(x: torch.Tensor, weights: Sequence[torch.Tensor],
           shape: ElanShape) -> Tuple[int, int]:
    """Validate the call; returns the group's (h, w)."""
    if shape.debug_skip_mask:
        raise NotImplementedError("fused ELAN: the 'nomask' ablation "
                                  "(debug_skip_mask) is not ported")
    if shape.act not in ACTS:
        raise ValueError(f"fused ELAN: unsupported activation {shape.act!r}")
    bad = [m for m in shape.members
           if not -2 <= _member_id(m) < shape.n_chain]
    if bad or not shape.members or len(set(shape.members)) != len(
            shape.members):
        raise ValueError(f"fused ELAN: bad members {shape.members}")
    if x.dim() != 4:
        raise ValueError(f"x must be NCHW, got {tuple(x.shape)}")
    bsz = x.shape[0]
    assert bsz % shape.group == 0, (bsz, shape.group)
    if shape.has_pre:
        s = shape.pre_stride
        if x.shape[1] != shape.pre_cin or x.shape[2] % s or x.shape[3] % s:
            raise ValueError(f"x {tuple(x.shape)} does not fit pre_cin "
                             f"{shape.pre_cin}, stride {s}")
        h, w = x.shape[2] // s, x.shape[3] // s
    else:
        if x.shape[1] != shape.cin:
            raise ValueError(f"x {tuple(x.shape)} does not fit cin "
                             f"{shape.cin}")
        h, w = x.shape[2], x.shape[3]
    want = weight_shapes(shape)
    if len(weights) != len(want):
        raise ValueError(f"expected {len(want)} weights, got {len(weights)}")
    for i, (t, s) in enumerate(zip(weights, want)):
        if tuple(t.shape) != s:
            raise ValueError(f"weight {i}: shape {tuple(t.shape)}, want {s}")
    for i, t in enumerate(weights):
        # conv kernels in x's dtype, biases float32
        want_dt = x.dtype if t.dim() == 4 else torch.float32
        if (x.dtype not in (torch.float32, torch.bfloat16)
                or t.dtype != want_dt):
            raise TypeError(
                f"fused ELAN takes float32 x and weights, or bf16 x and "
                f"kernels with float32 biases; got x {x.dtype}, weight {i} "
                f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"x on {x.device}, a weight on {t.device}")
    return h, w


def fused_elan(x: torch.Tensor, weights: Sequence[torch.Tensor],
               shape: ElanShape) -> torch.Tensor:
    """Run one fused ELAN group.

    x: (B, cin, H, W) float32 or bf16, or with shape.has_pre the absorbed
    conv's own input (B, pre_cin, s*H, s*W). weights: the flat list
    [wp (cin, pre_cin, 3, 3), bp (cin,),]   (only when has_pre)
    [wa (ccv, cin, 1, 1), ba (ccv,), wb, bb, w1 (cch, ccv, 3, 3), b1, ...,
    wn, bn, wt (cout, concat_width, 1, 1), bt (cout,)], BN folded in
    (models/fused.pack_elan_weights): kernels in x's dtype, biases
    float32. Returns (B, cout, H, W) in x's dtype and memory format. CPU
    tensors: `reference_elan`. CUDA tensors: the route `elan_route` names
    (an NCHW-contiguous x, or a channels_last bf16 one), launched or
    raised; `fused_elan.launches` counts the float32 launches,
    `fused_elan.bf16_launches` the bf16 ones and
    `fused_elan.bf16_tma_launches` those of them on the TMA route."""
    _check(x, weights, shape)
    if x.device.type == "cpu":
        return reference_elan(x, weights, shape)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    route = elan_route(x, weights, shape)
    out = launch_route(route, x, weights, shape)
    if x.dtype == torch.bfloat16:
        fused_elan.bf16_launches += 1
        fused_elan.bf16_tma_launches += route == "tma"
    else:
        fused_elan.launches += 1
    return out


def launch_route(route: str, x: torch.Tensor,
                 weights: Sequence[torch.Tensor], shape: ElanShape
                 ) -> torch.Tensor:
    """Launch one group on `route` ("tma" or "cp.async") as its plan lays
    it out, counting nothing: fused_elan's launch, and the way to time one
    route on inputs another call would route elsewhere (x must be in the
    route's layout). Raises when the library refuses the launch."""
    h, w = _check(x, weights, shape)
    bsz = x.shape[0]
    if shape.n_chain > MAX_CHAIN:
        raise ValueError(f"fused ELAN: n_chain {shape.n_chain} > "
                         f"{MAX_CHAIN}")
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    fmt = torch.channels_last if route == "tma" else torch.contiguous_format
    out = torch.empty((bsz, shape.cout, h, w), dtype=x.dtype,
                      device=x.device, memory_format=fmt)
    if bsz == 0 or h == 0 or w == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "tma":
        if not (x.dtype == torch.bfloat16 and tma_shape_ok(shape)
                and x.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError("the TMA route takes a channels_last bf16 x of "
                             "a shape tma_shape_ok accepts")
        plan = elan_tma_plan(shape, bsz, h, w, n_sm)
        ws = torch.empty(plan.ws_elems, dtype=x.dtype, device=x.device)
        packed = (weights.tma if isinstance(weights, ElanWeights)
                  and weights.shape == shape and weights.tma is not None
                  else pack_tma_weights(shape, weights))
        by_name = conv_weights(shape, weights)
        biases = [by_name[c.name][1].contiguous() for c in plan.convs]
        ptr = [x.data_ptr(), out.data_ptr(), ws.data_ptr(),
               packed.data_ptr(), *(b.data_ptr() for b in biases)]
        c_ptrs = (ctypes.c_void_p * len(ptr))(*ptr)
        c_ints = _plan_ints(plan, bsz, h, w, shape.act)
        err = _tma_library().fdms_fused_elan_tma(c_ptrs, c_ints,
                                                 x.device.index, stream)
        if err != 0:
            raise RuntimeError(f"fused_elan TMA kernel launch failed: CUDA "
                               f"error {err}")
        return out
    if route != "cp.async":
        raise ValueError(f"unknown fused ELAN route {route!r}")
    if not all(t.is_contiguous() for t in (x, *weights)):
        raise ValueError("fused ELAN takes contiguous tensors")
    plan = elan_plan(shape, bsz, h, w, n_sm)
    ws = torch.empty(plan["teams"] * plan["floats"], dtype=x.dtype,
                     device=x.device)
    if shape.has_pre:
        wp, bp, *rest = weights
    else:
        wp = bp = None
        rest = list(weights)
    wa, ba, wb, bb = rest[:4]
    chain = rest[4:4 + 2 * shape.n_chain]
    wt, bt = rest[-2:]
    # the kernel reads 3x3 weights as OHWI, a tap's input channels contiguous
    if wp is not None:
        wp = wp.permute(0, 2, 3, 1).contiguous()
    chain = [t.permute(0, 2, 3, 1).contiguous() if t.dim() == 4 else t
             for t in chain]
    ptr = [t.data_ptr() if t is not None else None
           for t in (x, out, ws, wp, bp, wa, ba, wb, bb, wt, bt, *chain)]
    ints = [bsz, h, w, shape.cin, shape.ccv, shape.cch, shape.cout,
            shape.n_chain, shape.pre_cin, shape.pre_stride, ACTS[shape.act],
            plan["tile_h"], plan["tile_w"], plan["grid"], plan["floats"],
            plan["cluster"], len(shape.members),
            *(_member_id(m) for m in shape.members),
            *plan["offsets"]]
    c_ptrs = (ctypes.c_void_p * len(ptr))(*ptr)
    c_ints = (ctypes.c_longlong * len(ints))(*ints)
    lib = _library()
    launch = (lib.fdms_fused_elan_bf16 if x.dtype == torch.bfloat16
              else lib.fdms_fused_elan)
    err = launch(c_ptrs, c_ints, x.device.index, stream)
    if err != 0:
        raise RuntimeError(f"fused_elan kernel launch failed: CUDA error "
                           f"{err}")
    return out


fused_elan.launches = 0
fused_elan.bf16_launches = 0
fused_elan.bf16_tma_launches = 0
