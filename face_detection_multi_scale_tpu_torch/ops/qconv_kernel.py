"""The int8 conv of W8A8 serving: the hand-written CUDA kernel and its plain
version.

`qconv` computes one conv of the int8 walk (models/quant.py), fused as the
JAX package's quant.py:518-530, where XLA runs
`conv_general_dilated(..., preferred_element_type=int32)` and fuses the
requant into it:

    y32 = conv(x_q, w_q)                                  exact int32
    z   = act(float32(y32) * alpha[c] + bias[c])          float32, in order
    out = clip(round_half_even(z * inv_out), -127, 127)   int8

x_q is NHWC int8 (B, H, W, Cin), w_q OHWI int8 (Cout, kh, kw, Cin /
groups), alpha and bias float32 (Cout,), inv_out a float32 scalar; act is
"none", "silu", "leaky" (slope 0.1) or "relu"; symmetric pads (ph, pw).
The output is NHWC int8 (B, Ho, Wo, Cout).

Source: csrc/qconv.cu, CUDA C++ for sm_90a, compiled by nvcc at first use
(ops/cuda_build.py) and bound with ctypes; see the source for what bounds
it and its design. PyTorch has no int8 convolution on CUDA (F.conv2d
refuses int8, and `torch._int_mm` is a bare GEMM whose im2col and int32
output would each cost a pass over memory), so there is no library conv
to call.

The source has three routes, and `qconv_plan` (plain Python, one
definition) picks one for a conv and its tile and K split: "wgmma" (s8
wgmma fed by TMA, split over a cluster on small grids) for groups == 1
with 16-byte channel runs and pointers, "mma" (mma.sync, cp.async) for
the rest of groups == 1 and for a short K on many tiles (WGMMA_MIN_K),
"direct" for groups > 1. The wrapper passes the plan to the library,
which launches it or fails (never another route) and reports what it
launched (`last_plan`).

On a CPU tensor `qconv` runs `qconv_plain`; on a CUDA tensor it launches
the kernel or raises. `qconv.launches` counts the kernel's launches;
`qconv.depthwise_launches`, `qconv.wgmma_launches` and
`qconv.split_launches` those of them on the direct route (grouped convs,
depthwise in the zoo), on the wgmma route, and with K split over a
cluster.

`qconv` is also the torch custom op `fdms_torch::qconv` (a fake version
gives the output's shape), which `qconv` emits in its place under
`torch.compiler.is_exporting()`, so that an exported int8 walk holds one
node a conv (the ONNX emitter, onnx/export.py, maps it). The live int8
walk calls the wrapper directly: a dispatcher hop a conv would add host
time to a host-bound path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from face_detection_multi_scale_tpu_torch.models.layers import act_fn
from face_detection_multi_scale_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "qconv.cu"
# -fmad=false: y * alpha + bias must not contract into an FMA, or the last
# bit of z differs from the plain version's two rounded operations
NVCC_FLAGS = cuda_build.BASE_FLAGS + ("-fmad=false",)
ACTS = {"none": 0, "silu": 1, "leaky": 2, "relu": 3}


def out_hw(h: int, w: int, k: Tuple[int, int], stride: int,
           pads: Tuple[int, int]) -> Tuple[int, int]:
    return ((h + 2 * pads[0] - k[0]) // stride + 1,
            (w + 2 * pads[1] - k[1]) // stride + 1)


def conv_sums(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              pads: Tuple[int, int] = (0, 0), groups: int = 1
              ) -> torch.Tensor:
    """The exact int32 sums conv(x_q, w_q), NHWC (B, Ho, Wo, Cout): the
    int8 values through F.conv2d in float64, exact since |sum| <= 127^2 *
    kh * kw * Cin < 2^53 (rounded, so an algorithm that is not exact in
    float64 still lands on the integer)."""
    y = F.conv2d(x.permute(0, 3, 1, 2).double(),
                 w.permute(0, 3, 1, 2).double(), None, stride, tuple(pads),
                 1, groups)
    return torch.round(y).to(torch.int32).permute(0, 2, 3, 1).contiguous()


def pre_round(y32: torch.Tensor, alpha: torch.Tensor, bias: torch.Tensor,
              inv_out, act: str) -> torch.Tensor:
    """The float32 epilogue up to the rounding, op by op in the JAX order:
    act(f32(y32) * alpha + bias) * inv_out."""
    yf = y32.float() * alpha
    yf = yf + bias
    return act_fn(act)(yf) * inv_out


def qconv_plain(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
                bias: torch.Tensor, inv_out, stride: int = 1,
                pads: Tuple[int, int] = (0, 0), groups: int = 1,
                act: str = "none") -> torch.Tensor:
    """Plain PyTorch `qconv` (torch.round rounds half to even, as
    jnp.round)."""
    z = pre_round(conv_sums(x, w, stride, pads, groups), alpha, bias,
                  inv_out, act)
    return torch.clamp(torch.round(z), -127, 127).to(torch.int8)


ROUTES = {"direct": 0, "mma": 1, "wgmma": 2}
# csrc/qconv.cu's tiles (its kWBM, kBM / kBN / kBK and kDirectThreads,
# defined there; the library reports the tile it launched, `last_plan`)
WGMMA_BM = 128          # output pixels a wgmma block
MMA_TILE = (128, 64, 64)  # the mma route's pixels, channels, K bytes
DIRECT_THREADS = 256
SMS = 132               # an H100 SXM's SMs, where no card is named
SPLIT_MAX = 8           # the portable cluster size
SPLIT_MIN_STEPS = 2     # K steps a block of a split keeps at least
SPLIT_REDUCE_STEPS = 4  # what rank 0 pays to add one partial tile, in steps
# K bytes an output pixel below which a conv whose wgmma tiles outnumber
# the SMs takes the mma route (lite-t's 1x1 convs of 16-48 channels on
# maps of 80 px and up: PERF.md §6)
WGMMA_MIN_K = 64


@dataclasses.dataclass(frozen=True)
class QconvPlan:
    """One launch of csrc/qconv.cu: the route, the tile (bm pixels x bn
    channels, bk K bytes a step; 0 on the direct route), the blocks that
    split each tile's K steps (one cluster), the K steps of a tile, the
    grid and the mma route's copy width (16 on wgmma, 0 on direct). The
    wgmma route's grid is (tiles * split, 1) when it splits, else (at most
    SMS, 1) blocks that walk the tiles; the mma route's is (M tiles, N
    tiles)."""
    route: str
    bm: int
    bn: int
    bk: int
    split: int
    k_steps: int
    grid: Tuple[int, int]
    vec: int

    def row(self) -> Tuple[int, ...]:
        """The plan as fdms_qconv_last_plan reports it."""
        return (ROUTES[self.route], self.bm, self.bn, self.bk, self.split,
                self.k_steps, *self.grid, self.vec)


def ptr_align(ptr: int) -> int:
    """The alignment of a pointer in bytes, up to 16."""
    return min(16, ptr & -ptr) if ptr else 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wgmma_span(cin: int) -> int:
    """K bytes a wgmma step: the widest of 128, 64, 32 that divides Cin
    (32 for a Cin of 16 mod 32, whose last run per tap is half zeros)."""
    return 128 if cin % 128 == 0 else 64 if cin % 64 == 0 else 32


def takes_wgmma(cin: int, kh: int, kw: int, stride: int, groups: int,
                pads: Tuple[int, int], x_ptr_align: int,
                w_ptr_align: int) -> bool:
    """Whether TMA and the wgmma tile take the conv: 16-byte channel runs
    and pointers, the im2col window corners -pad and pad - (k - 1) in
    [-128, 127], a traversal stride of at most 8."""
    return (groups == 1 and cin % 16 == 0 and x_ptr_align % 16 == 0
            and w_ptr_align % 16 == 0 and stride <= 8
            and max(pads) <= 127 and min(pads[0] - kh + 1,
                                         pads[1] - kw + 1) >= -128)


def wgmma_bn(cout: int) -> int:
    """The wgmma route's N tile: 128, or 64 where Cout is not a multiple
    of 128."""
    return 128 if cout % 128 == 0 else 64


def split_for(tiles: int, k_steps: int, sms: int = SMS) -> int:
    """The blocks of a cluster that share a tile's K steps: the divisor
    s <= SPLIT_MAX of the steps that keeps the grid to one wave (tiles * s
    <= sms, a block an SM) and minimises the steps a block + the reduction
    (SPLIT_REDUCE_STEPS a partial tile), keeping SPLIT_MIN_STEPS steps a
    block."""
    best, cost = 1, k_steps
    for s in range(2, SPLIT_MAX + 1):
        if k_steps % s or k_steps // s < SPLIT_MIN_STEPS or tiles * s > sms:
            continue
        c = k_steps // s + SPLIT_REDUCE_STEPS * (s - 1)
        if c < cost:
            best, cost = s, c
    return best


def _route_plan(route: str, b: int, h: int, w: int, cin: int, cout: int,
                kh: int, kw: int, stride: int, groups: int,
                x_ptr_align: int, w_ptr_align: int,
                pads: Tuple[int, int], split: Optional[int] = None,
                sms: int = SMS) -> QconvPlan:
    """The plan of `route` for the conv (whether the route takes it is the
    caller's question) on a card of `sms` SMs; `split` overrides the wgmma
    route's choice."""
    ho, wo = out_hw(h, w, (kh, kw), stride, pads)
    m = b * ho * wo
    if route == "direct":
        return QconvPlan("direct", 0, 0, 0, 1, 0,
                         (_cdiv(m * cout, DIRECT_THREADS), 1), 0)
    if route == "mma":
        bm, bn, bk = MMA_TILE
        vec = next((v for v in (16, 8, 4) if cin % v == 0
                    and x_ptr_align % v == 0 and w_ptr_align % v == 0), 1)
        return QconvPlan("mma", bm, bn, bk, 1, _cdiv(kh * kw * cin, bk),
                         (_cdiv(m, bm), _cdiv(cout, bn)), vec)
    span = wgmma_span(cin)
    steps = kh * kw * _cdiv(cin, span)
    bn = wgmma_bn(cout)
    tiles = _cdiv(m, WGMMA_BM) * _cdiv(cout, bn)
    s = split_for(tiles, steps, sms) if split is None else split
    # split: one cluster a tile; else persistent, at most a block an SM
    blocks = tiles * s if s > 1 else min(tiles, sms)
    return QconvPlan("wgmma", WGMMA_BM, bn, span, s, steps, (blocks, 1), 16)


@functools.lru_cache(maxsize=4096)
def qconv_plan(b: int, h: int, w: int, cin: int, cout: int, kh: int,
               kw: int, stride: int, groups: int, x_ptr_align: int,
               w_ptr_align: int, pads: Optional[Tuple[int, int]] = None,
               sms: int = SMS) -> QconvPlan:
    """The launch `qconv` makes for a conv of x (b, h, w, cin), w (cout,
    kh, kw, cin / groups) at `stride` and `pads` (default k // 2), with x
    and w at pointers aligned to x_ptr_align and w_ptr_align bytes, on a
    card of `sms` SMs: the direct route for groups > 1, the wgmma route
    where TMA takes the conv (`takes_wgmma`), else the mma route; and the
    mma route also where K is under WGMMA_MIN_K bytes an output pixel and
    the wgmma tiles outnumber the SMs. There the mma route measured
    faster on an H100 (87 against 326 us at 320 px, K = 16, Cout = 8;
    PERF.md §6), likely because a persistent block's tiles, one or
    two wgmmas each, wait on its epilogue in turn; on one wave of tiles
    the wgmma route is the faster (10 against 12 us at 40 px, K = 48)."""
    pads = (kh // 2, kw // 2) if pads is None else tuple(pads)
    if groups > 1:
        route = "direct"
    elif not takes_wgmma(cin, kh, kw, stride, groups, pads, x_ptr_align,
                         w_ptr_align):
        route = "mma"
    else:
        ho, wo = out_hw(h, w, (kh, kw), stride, pads)
        tiles = _cdiv(b * ho * wo, WGMMA_BM) * _cdiv(cout, wgmma_bn(cout))
        route = ("mma" if kh * kw * cin < WGMMA_MIN_K and tiles > sms
                 else "wgmma")
    return _route_plan(route, b, h, w, cin, cout, kh, kw, stride, groups,
                       x_ptr_align, w_ptr_align, pads, sms=sms)


@functools.cache
def device_sms(index: int) -> int:
    """The SMs of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(x: torch.Tensor, w: torch.Tensor, stride: int,
             pads: Tuple[int, int], groups: int) -> QconvPlan:
    """`qconv_plan` for CUDA tensors x and w: their shapes, their pointers'
    alignment and their card's SMs."""
    return qconv_plan(*x.shape, w.shape[0], *w.shape[1:3], stride, groups,
                      ptr_align(x.data_ptr()), ptr_align(w.data_ptr()),
                      tuple(pads), device_sms(x.get_device()))


# (x and w shapes, stride, pads, groups, act, the pointers' low 4 bits, the
# device) -> (plan, output shape, the library's int array): one lookup a
# launch
_READY = {}


def reset_plans() -> None:
    """Forget every plan made (after a change to the plan's constants)."""
    qconv_plan.cache_clear()
    _READY.clear()


def build():
    """Compile csrc/qconv.cu (once per source and flags); returns the
    shared library's path."""
    return cuda_build.build(SOURCE, NVCC_FLAGS)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    vp = ctypes.c_void_p
    lib.fdms_qconv.argtypes = [vp, vp, vp, vp, ctypes.c_float, vp, vp, vp]
    lib.fdms_qconv.restype = ctypes.c_int
    lib.fdms_qconv_last_plan.argtypes = [vp]
    lib.fdms_qconv_last_plan.restype = None
    return lib


def last_plan() -> Tuple[int, ...]:
    """The plan of the library's last accepted launch, as `QconvPlan.row`
    (route -1 when its last call launched nothing)."""
    out = (ctypes.c_longlong * 9)()
    _library().fdms_qconv_last_plan(ctypes.addressof(out))
    return tuple(out)


def qconv(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
          bias: torch.Tensor, inv_out, stride: int = 1,
          pads: Tuple[int, int] = (0, 0), groups: int = 1,
          act: str = "none") -> torch.Tensor:
    """One fused int8 conv (see the module docstring). x (B, H, W, Cin)
    int8 and w (Cout, kh, kw, Cin / groups) int8 contiguous, alpha and
    bias float32 (Cout,) contiguous, all on one device; inv_out a float or
    a float32 scalar tensor. Returns (B, Ho, Wo, Cout) int8."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x and w must be 4-d, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    b, h, wd, cin = x.shape
    cout, kh, kw, cg = w.shape
    if groups < 1 or cin % groups or cout % groups or cg * groups != cin:
        raise ValueError(f"w {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)} with groups={groups}")
    if tuple(alpha.shape) != (cout,) or tuple(bias.shape) != (cout,):
        raise ValueError(f"alpha {tuple(alpha.shape)} and bias "
                         f"{tuple(bias.shape)} must be ({cout},)")
    if x.dtype != torch.int8 or w.dtype != torch.int8 or \
            alpha.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"need int8 x and w, float32 alpha and bias, got "
                        f"{x.dtype}, {w.dtype}, {alpha.dtype}, {bias.dtype}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {tuple(ACTS)}, got {act!r}")
    if stride < 1 or min(pads) < 0:
        raise ValueError(f"bad stride {stride} or pads {pads}")
    if len({t.device for t in (x, w, alpha, bias)}) != 1:
        raise ValueError("x, w, alpha and bias must be on one device")
    ho, wo = out_hw(h, wd, (kh, kw), stride, pads)
    if ho < 1 or wo < 1:
        raise ValueError(f"empty output {ho}x{wo}")
    if torch.compiler.is_exporting():
        return torch.ops.fdms_torch.qconv(x, w, alpha, bias, float(inv_out),
                                          stride, list(pads), groups, act)
    if x.device.type == "cpu":
        return qconv_plain(x, w, alpha, bias, inv_out, stride, pads, groups,
                           act)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not all(t.is_contiguous() for t in (x, w, alpha, bias)):
        raise ValueError("x, w, alpha and bias must be contiguous")
    if max(x.numel(), w.numel(), b * ho * wo * cout) >= 2 ** 31:
        raise ValueError("tensor too large for the kernel's indexing")
    pads = tuple(pads)
    xp, wp = x.data_ptr(), w.data_ptr()
    key = (x.shape, w.shape, stride, pads, groups, act, xp & 15, wp & 15,
           x.get_device())
    ready = _READY.get(key)
    if ready is None:
        if len(_READY) >= 4096:
            _READY.clear()
        ready = _READY[key] = _ready(plan_for(x, w, stride, pads, groups),
                                     x, w, stride, pads, groups, act)
    return _run(ready, x, w, alpha, bias, inv_out)


def _ready(plan: QconvPlan, x: torch.Tensor, w: torch.Tensor, stride: int,
           pads: Tuple[int, int], groups: int, act: str):
    """(plan, output shape, the library's int array and its address) of a
    launch of `plan`."""
    b, h, wd, cin = x.shape
    cout, kh, kw, _ = w.shape
    ho, wo = out_hw(h, wd, (kh, kw), stride, pads)
    ints = (ctypes.c_int * 18)(
        b, h, wd, cin, cout, kh, kw, stride, pads[0], pads[1], groups,
        ACTS[act], ROUTES[plan.route], plan.bn, plan.split, plan.grid[0],
        plan.vec, x.get_device())
    return plan, (b, ho, wo, cout), ints, ctypes.addressof(ints)


def _launch(plan: QconvPlan, x: torch.Tensor, w: torch.Tensor,
            alpha: torch.Tensor, bias: torch.Tensor, inv_out, stride: int,
            pads: Tuple[int, int], groups: int, act: str) -> torch.Tensor:
    """Launch `plan` on checked CUDA tensors; raises if the library
    refuses it. Counts the launch by route."""
    return _run(_ready(plan, x, w, stride, tuple(pads), groups, act), x, w,
                alpha, bias, inv_out)


def _run(ready, x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
         bias: torch.Tensor, inv_out) -> torch.Tensor:
    plan, shape, _, ints = ready  # the array is kept alive by `ready`
    y = torch.empty(shape, dtype=torch.int8, device=x.device)
    err = _library().fdms_qconv(
        x.data_ptr(), w.data_ptr(), alpha.data_ptr(), bias.data_ptr(),
        float(inv_out), y.data_ptr(), ints,
        # the raw stream handle: torch.cuda.current_stream builds a Stream
        # object, about 6 of the ~40 us of host time a conv took on an H100
        # machine
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"qconv kernel launch failed ({plan.route} "
                           f"route): CUDA error {err}")
    qconv.launches += 1
    if plan.route == "direct":
        qconv.depthwise_launches += 1
    elif plan.route == "wgmma":
        qconv.wgmma_launches += 1
        if plan.split > 1:
            qconv.split_launches += 1
    return y


qconv.launches = 0
qconv.depthwise_launches = 0
qconv.wgmma_launches = 0
qconv.split_launches = 0


@torch.library.custom_op("fdms_torch::qconv", mutates_args=())
def qconv_op(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
             bias: torch.Tensor, inv_out: float, stride: int,
             pads: List[int], groups: int, act: str) -> torch.Tensor:
    """`qconv` as a custom op (what an exported walk calls): the kernel on
    CUDA tensors, `qconv_plain` on CPU tensors."""
    if x.device.type == "cpu":
        return qconv_plain(x, w, alpha, bias, inv_out, stride, tuple(pads),
                           groups, act)
    return qconv(x, w, alpha, bias, inv_out, stride, tuple(pads), groups,
                 act)


@qconv_op.register_fake
def _qconv_fake(x, w, alpha, bias, inv_out, stride, pads, groups, act):
    ho, wo = out_hw(x.shape[1], x.shape[2], tuple(w.shape[1:3]), stride,
                    tuple(pads))
    return x.new_empty((x.shape[0], ho, wo, w.shape[0]))
