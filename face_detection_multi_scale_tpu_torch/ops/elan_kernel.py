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
bf16, the biases float32, the output bf16. The same kernel source in its
bf16 instantiation computes each conv as one bf16 tensor-core product a
multiply-add with f32 sums, then bias and activation in f32 and a round
to bf16 of every intermediate and of the output, where the TPU kernel
casts them (pallas_elan.py:407-432, 526); its workspace holds bf16. Its
bound is the group's FLOPs over 989 TFLOP/s, or its bytes over 3.35 TB/s
if larger. `reference_elan` rounds at the same points. The launches count
apart: `fused_elan.launches` (float32), `fused_elan.bf16_launches`.

Layout: activations NCHW and weights OIHW, the executor's own tensors and
torch's conv weights, so the fused path adds no transposes; the JAX
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
    over the plan's tiles."""
    th, tw, p = plan["tile_h"], plan["tile_w"], shape.halo

    def points(o):  # in-image points of every tile's window with halo o
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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for fn in (lib.fdms_fused_elan, lib.fdms_fused_elan_bf16):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def build():
    """Compile csrc/fused_elan.cu (once per source and flags); returns the
    shared library's path."""
    return cuda_build.build(SOURCE, NVCC_FLAGS)


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
    float32. Returns (B, cout, H, W) in x's dtype. CPU tensors:
    `reference_elan`. CUDA tensors: the kernel, contiguous inputs only;
    `fused_elan.launches` counts its float32 launches and
    `fused_elan.bf16_launches` its bf16 ones."""
    h, w = _check(x, weights, shape)
    if x.device.type == "cpu":
        return reference_elan(x, weights, shape)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not all(t.is_contiguous() for t in (x, *weights)):
        raise ValueError("fused ELAN takes contiguous tensors")
    if shape.n_chain > MAX_CHAIN:
        raise ValueError(f"fused ELAN: n_chain {shape.n_chain} > "
                         f"{MAX_CHAIN}")
    bsz = x.shape[0]
    out = torch.empty((bsz, shape.cout, h, w), dtype=x.dtype,
                      device=x.device)
    if bsz == 0 or h == 0 or w == 0:
        return out
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bf16 = x.dtype == torch.bfloat16
    lib = _library()
    launch = lib.fdms_fused_elan_bf16 if bf16 else lib.fdms_fused_elan
    err = launch(c_ptrs, c_ints, x.device.index, stream)
    if err != 0:
        raise RuntimeError(f"fused_elan kernel launch failed: CUDA error "
                           f"{err}")
    if bf16:
        fused_elan.bf16_launches += 1
    else:
        fused_elan.launches += 1
    return out


fused_elan.launches = 0
fused_elan.bf16_launches = 0
