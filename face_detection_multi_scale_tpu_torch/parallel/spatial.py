"""Exact halo exchanges for a forward whose image plane is split over a
spatial mesh (parallel/mesh.SpatialMesh).

Every activation's H and W are split canonically: rank k of n along an
axis owns [floor(k E / n), floor((k + 1) E / n)) of the axis's extent E
(`mesh.split_extent`), so a rank may own nothing where the ranks
outnumber the extent. Each geometric op works out, from its own geometry,
which input rows and columns its block of the output reads, fetches those
it does not hold from the ranks that own them (point-to-point sends and
receives on the mesh's comm device: gloo on host copies, NCCL on card
copies), H first and then W on the rows so fetched, and pads only where
the range reaches past the plane's edge, as the one-process op pads there
(zeros for a conv and a zero pad, -inf for a max pool, `ceil_mode`
honoured). The op then runs unpadded on the fetched block, so its output
is exactly the rank's block of the one-process output. An internal seam
is never padded.

The ops reach this module through one hook, `models/layers.SPATIAL`, which
`forward_blocks` sets for the length of a forward: `layers.Conv2d`,
`max_pool`, `upsample2x_nearest`, `reorg`, Focus's space to depth, the
zero pad, `layers_extra.contract` / `expand`, and the global ops
(TransformerBlock's attention, MetaAconC's spatial mean, Classify), which
run on the gathered plane while each rank keeps its block. Every other op
of the model is local (elementwise, BatchNorm, concat, sums, channel
shuffles). A module outside this set raises NotImplementedError naming it
before anything is exchanged. The hook is the process's: one spatial
forward runs at a time in a process.

Each op needs the global extent of its input, which a block does not
carry: a shape-only forward of the whole plane on the meta device (no
weights copied, nothing computed) records, op by op, the kind and the
global (H, W) of each op's input, and the forward over the blocks reads
them in the same order, checking every block's shape against its
partition.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from face_detection_multi_scale_tpu_torch.models import layers as L
from face_detection_multi_scale_tpu_torch.models import layers_extra as LX
from face_detection_multi_scale_tpu_torch.models import head as H
from face_detection_multi_scale_tpu_torch.models import model as M
from face_detection_multi_scale_tpu_torch.parallel.mesh import (
    SpatialMesh, SpatialSharding, gather_blocks, split_extent)


# ---------------------------------------------------------------------------
# the geometry of an op along one axis
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Window:
    """Output o reads inputs o s - before + t d for t < k (a conv, a pool,
    a space to depth of gain s with k = s, a zero pad with k = 1)."""
    k: int
    s: int = 1
    before: int = 0
    after: int = 0
    d: int = 1
    ceil: bool = False

    def out_extent(self, e: int) -> int:
        span = e + self.before + self.after - self.d * (self.k - 1) - 1
        if not self.ceil:
            return span // self.s + 1
        # torch's pooling_output_shape: the last window starts inside the
        # input or its leading pad
        n = -(-span // self.s) + 1
        return n - 1 if (n - 1) * self.s >= e + self.before else n

    def need(self, a: int, b: int) -> Tuple[int, int]:
        """The input range that outputs [a, b) read (b > a)."""
        return (a * self.s - self.before,
                (b - 1) * self.s - self.before + self.d * (self.k - 1) + 1)

    def offset(self, a: int, lo: int) -> int:
        """Where output a lies in the op's output on inputs from lo."""
        return 0


@dataclasses.dataclass(frozen=True)
class Repeat:
    """Output o reads input o // s (nearest upsample, depth to space)."""
    s: int

    def out_extent(self, e: int) -> int:
        return e * self.s

    def need(self, a: int, b: int) -> Tuple[int, int]:
        return a // self.s, (b - 1) // self.s + 1

    def offset(self, a: int, lo: int) -> int:
        return a - lo * self.s


# ---------------------------------------------------------------------------
# the ops' hook: the shape-only record, then the forward over blocks
# ---------------------------------------------------------------------------

class _Hook:
    """What `models/layers.SPATIAL` holds during a forward: every
    geometric op hands it its input and the one-process op to run."""

    @contextlib.contextmanager
    def suspended(self):
        """The one-process ops, for an op's own computation."""
        L.SPATIAL = None
        try:
            yield
        finally:
            L.SPATIAL = self

    def conv2d(self, conv: L.Conv2d, x: torch.Tensor) -> torch.Tensor:
        if conv.padding_mode != "zeros" or isinstance(conv.padding, str):
            raise NotImplementedError(
                f"spatial conv with padding {conv.padding!r} "
                f"({conv.padding_mode})")
        dt = conv.compute_dtype or conv.weight.dtype
        (kh, kw), (sh, sw) = conv.kernel_size, conv.stride
        (ph, pw), (dh, dw) = conv.padding, conv.dilation
        bias = None if conv.bias is None else conv.bias.to(dt)

        def fn(t):
            return F.conv2d(t.to(dt), conv.weight.to(dt), bias, (sh, sw), 0,
                            (dh, dw), conv.groups)

        return self.apply("conv", x, Window(kh, sh, ph, ph, dh),
                          Window(kw, sw, pw, pw, dw), fn, conv, 0.0,
                          conv.out_channels, dt)

    def max_pool(self, x, k: int, s: int, p: int, ceil_mode: bool):
        def fn(t):
            return F.max_pool2d(t, k, s, 0)

        geo = Window(k, s, p, p, 1, ceil_mode)
        return self.apply("max_pool", x, geo, geo, fn,
                          lambda t: L.max_pool(t, k, s, p, ceil_mode),
                          float("-inf"), x.shape[1], x.dtype)

    def fold(self, x, gain: int, fn: Callable):
        """A space to depth of `gain` (reorg, Focus, contract)."""
        geo = Window(gain, gain)
        return self.apply("fold", x, geo, geo, fn, fn, 0.0,
                          x.shape[1] * gain * gain, x.dtype)

    def unfold(self, x, gain: int, fn: Callable, c_out: int):
        """A repeat of `gain` (nearest upsample, expand)."""
        geo = Repeat(gain)
        return self.apply("unfold", x, geo, geo, fn, fn, 0.0, c_out,
                          x.dtype)

    def zero_pad(self, x, pads: Sequence[int]):
        left, right, top, bottom = pads
        return self.apply("zero_pad", x, Window(1, 1, top, bottom),
                          Window(1, 1, left, right), lambda t: t,
                          lambda t: L.zero_pad(t, pads), 0.0, x.shape[1],
                          x.dtype)

    def apply(self, kind, x, geo_h, geo_w, fn, whole, fill, c_out, dtype):
        """The op of `kind` on `x`: `fn` computes it unpadded on the
        fetched input, `whole` is the one-process op, `fill` pads past the
        plane's edges, and an empty block has `c_out` channels of
        `dtype`."""
        raise NotImplementedError

    def global_op(self, module: nn.Module, x: torch.Tensor):
        raise NotImplementedError


class _Record(_Hook):
    """The shape-only forward of the whole plane: (kind, H, W) of each
    op's input, in the order the ops run."""

    def __init__(self):
        self.ops: List[Tuple[str, int, int]] = []

    def apply(self, kind, x, geo_h, geo_w, fn, whole, fill, c_out, dtype):
        h, w = x.shape[2], x.shape[3]
        self.ops.append((kind, h, w))
        with self.suspended():
            y = whole(x)
        if tuple(y.shape[1:]) != (c_out, geo_h.out_extent(h),
                                  geo_w.out_extent(w)):
            raise RuntimeError(
                f"spatial forward: {kind} on {h} x {w} gives "
                f"{tuple(y.shape[1:])}, not its geometry's {c_out} x "
                f"{geo_h.out_extent(h)} x {geo_w.out_extent(w)}")
        return y

    def global_op(self, module, x):
        for t in (x if isinstance(x, (list, tuple)) else [x]):
            self.ops.append(("global", t.shape[2], t.shape[3]))
        with self.suspended():
            return module(x)


class SpatialRun(_Hook):
    """The forward over this rank's blocks on `mesh`, reading `ops` (a
    `_Record`'s) in order; counts the blocks received (`exchanges`) and
    their bytes (`halo_bytes`)."""

    def __init__(self, mesh: SpatialMesh, ops: List[Tuple[str, int, int]]):
        self.mesh, self.ops, self.pos = mesh, ops, 0
        self.exchanges = self.halo_bytes = 0
        self._tag = 0

    def _next(self, kind: str, x: torch.Tensor) -> Tuple[int, int]:
        """The global (H, W) of this op's input, its block's shape
        checked against the partition."""
        if self.pos >= len(self.ops):
            raise RuntimeError(f"spatial forward: op {self.pos} ({kind}) "
                               f"beyond the {len(self.ops)} recorded")
        want, h, w = self.ops[self.pos]
        (r, c), (rows, cols) = self.mesh.coords, self.mesh.shape
        (h0, h1), (w0, w1) = split_extent(h, rows, r), split_extent(w, cols,
                                                                     c)
        if want != kind or tuple(x.shape[2:]) != (h1 - h0, w1 - w0):
            raise RuntimeError(
                f"spatial forward: op {self.pos} is {kind} on a "
                f"{tuple(x.shape[2:])} block, recorded {want} on {h} x {w} "
                f"(this rank's block {h1 - h0} x {w1 - w0})")
        self.pos += 1
        return h, w

    def apply(self, kind, x, geo_h, geo_w, fn, whole, fill, c_out, dtype):
        h, w = self._next(kind, x)
        (r, c), (rows, cols) = self.mesh.coords, self.mesh.shape
        ho, wo = geo_h.out_extent(h), geo_w.out_extent(w)
        needs_h = [_need(geo_h, split_extent(ho, rows, k))
                   for k in range(rows)]
        needs_w = [_need(geo_w, split_extent(wo, cols, k))
                   for k in range(cols)]
        x = self._exchange(x, 2, h, needs_h, r,
                           [self.mesh.at(k, c) for k in range(rows)])
        x = self._exchange(x, 3, w, needs_w, c,
                           [self.mesh.at(r, k) for k in range(cols)])
        (a, b), (a2, b2) = split_extent(ho, rows, r), split_extent(wo, cols,
                                                                   c)
        if a == b or a2 == b2:
            # an empty block never reaches the op (nor cuDNN)
            return x.new_empty((x.shape[0], c_out, b - a, b2 - a2),
                               dtype=dtype)
        (lo, hi), (lo2, hi2) = needs_h[r], needs_w[c]
        pads = (max(0, -lo2), max(0, hi2 - w), max(0, -lo), max(0, hi - h))
        if any(pads):
            x = F.pad(x, pads, value=fill)
        with self.suspended():
            y = fn(x)
        i, j = geo_h.offset(a, lo), geo_w.offset(a2, lo2)
        return y[:, :, i:i + b - a, j:j + b2 - a2]

    def _exchange(self, x, axis: int, extent: int, needs, me: int,
                  peers: Sequence[int]) -> torch.Tensor:
        """Rows (axis 2) or columns (axis 3) [lo, hi) of `needs[me]`
        clipped to [0, extent), from their owners along the axis (global
        ranks `peers`); sends each peer what it needs of this rank's
        block. An empty `needs[me]` gives an empty block."""
        n = len(peers)
        own = split_extent(extent, n, me)
        self._tag += 1
        ops, pieces, recv = [], [], []
        comm = self.mesh.comm_device
        for k in range(n):
            if k == me or needs[k] is None:
                continue
            lo, hi = max(own[0], needs[k][0]), min(own[1], needs[k][1])
            if lo >= hi:
                continue
            piece = x.narrow(axis, lo - own[0], hi - lo)
            if piece.numel():
                buf = piece.to(comm).contiguous()
                ops.append(dist.P2POp(dist.isend, buf, peers[k],
                                      self.mesh.group, self._tag))
        if needs[me] is not None:
            lo, hi = max(0, needs[me][0]), min(extent, needs[me][1])
            for k in range(n):
                a, b = split_extent(extent, n, k)
                a, b = max(a, lo), min(b, hi)
                if a >= b:
                    continue
                if k == me:
                    pieces.append(x.narrow(axis, a - own[0], b - a))
                    continue
                shape = list(x.shape)
                shape[axis] = b - a
                buf = torch.empty(shape, dtype=x.dtype, device=comm)
                pieces.append(buf)
                if buf.numel():
                    recv.append(buf)
                    ops.append(dist.P2POp(dist.irecv, buf, peers[k],
                                          self.mesh.group, self._tag))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        self.exchanges += len(recv)
        self.halo_bytes += sum(b.numel() * b.element_size() for b in recv)
        if not pieces:
            shape = list(x.shape)
            shape[axis] = 0
            return x.new_empty(shape)
        pieces = [p.to(x.device) for p in pieces]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, axis)

    def global_op(self, module, x):
        """`module` on the gathered plane (of each input, for a list);
        this rank keeps its block of an output of the plane's extent (or
        the whole of another)."""
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        shapes, indices = [], []
        for t in xs:
            h, w = self._next("global", t)
            shapes.append((*t.shape[:2], h, w))
            indices.append((slice(None), slice(None), *self.slices(h, w)))
        whole = gather_blocks(self.mesh, xs, shapes, indices)
        with self.suspended():
            y = module(whole if isinstance(x, (list, tuple)) else whole[0])
        if y.dim() == 4 and tuple(y.shape[2:]) == shapes[0][2:]:
            return y[indices[0]]
        return y

    def slices(self, h: int, w: int) -> Tuple[slice, slice]:
        """This rank's rows and columns of an (h, w) plane."""
        return SpatialSharding(self.mesh).slices(h, w)


def _need(geo, out: Tuple[int, int]) -> Optional[Tuple[int, int]]:
    return None if out[0] == out[1] else geo.need(*out)


# ---------------------------------------------------------------------------
# which modules have a spatial form
# ---------------------------------------------------------------------------

# composed of the hooked ops and local ones
LOCAL_OR_HOOKED = (
    M.YoloFace, M.Stateless, H.DetectionHead, nn.ModuleList, nn.Sequential,
    nn.Identity, nn.SiLU, L.Conv2d, L.BatchNorm, L.ConvBN, L.SPPCSPC, L.SPF,
    L.SPPF, L.SPPFCSPC, L.SPP, L.StemBlock, L.DWConvblock, L.ShuffleBlock,
    L.ConvBnReluMaxpool, L.Bottleneck, L.C3, L.BottleneckCSP, L.Focus,
    L.ImplicitA, L.ImplicitM, LX.CrossConv, LX.Sum, LX.GhostConv,
    LX.GhostBottleneck, LX.MixConv2d, LX.C3TR, LX.BottleneckCSPF,
    LX.BottleneckCSP2, LX.SPPCSP, LX.ConvFocus, LX.FReLU, LX.AconC)
# their output at one cell reads the whole plane: run on the gathered plane
GLOBAL = (LX.TransformerBlock, LX.MetaAconC, LX.Classify)


def check_spatial(model: nn.Module, where: str = "model") -> None:
    """NotImplementedError naming the first module of `model` without a
    spatial form (nothing computes a silently wrong block)."""
    if isinstance(model, GLOBAL):
        return
    if type(model) not in LOCAL_OR_HOOKED:
        raise NotImplementedError(
            f"spatial forward: {where} is a {type(model).__name__}, which "
            f"has no spatial form")
    if isinstance(model, M.Stateless) and model.op not in M.STATELESS_OPS:
        raise NotImplementedError(f"spatial forward: {where} is the "
                                  f"stateless op {model.op!r}")
    for name, child in model.named_children():
        check_spatial(child, f"{where}.{name}")


# ---------------------------------------------------------------------------
# the forward over blocks
# ---------------------------------------------------------------------------

# model -> {input shape: the ops' record and the outputs' global shapes}
_RECORDS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def record(model: nn.Module, shape: Tuple[int, ...], **kwargs):
    """(the ops' (kind, H, W) in order, each output's shape) of
    model(x, **kwargs) on a whole input of `shape`, from a shape-only
    forward on the meta device (the model's own modules, its parameters
    and buffers swapped for meta twins); cached per model and shape."""
    key = (tuple(shape), tuple(sorted(kwargs.items())))
    cache = _RECORDS.setdefault(model, {})
    if key not in cache:
        meta = {k: torch.empty_like(v, device="meta") for k, v in
                [*model.named_parameters(), *model.named_buffers()]}
        rec = _Record()
        L.SPATIAL = rec
        try:
            with torch.no_grad():
                outs = torch.func.functional_call(
                    model, meta, (torch.empty(shape, device="meta"),),
                    kwargs)
        finally:
            L.SPATIAL = None
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        cache[key] = (rec.ops, [tuple(o.shape) for o in outs])
    return cache[key]


def run_blocks(model: nn.Module, block: torch.Tensor,
               shape: Tuple[int, ...], mesh: SpatialMesh, **kwargs):
    """model(block, **kwargs) over this rank's `block` of a whole input of
    `shape` (the input's H and W at dims 2 and 3 of what the model's
    first op sees): (its outputs as this rank's blocks, their global
    shapes, the run). Every module of `model` must have a spatial form
    (`check_spatial`)."""
    ops, shapes = record(model, shape, **kwargs)
    run = SpatialRun(mesh, ops)
    L.SPATIAL = run
    try:
        outs = model(block, **kwargs)
    finally:
        L.SPATIAL = None
    if run.pos != len(ops):
        raise RuntimeError(f"spatial forward: {run.pos} ops ran, "
                           f"{len(ops)} recorded")
    return (outs if isinstance(outs, (list, tuple)) else [outs]), shapes, run


def forward_blocks(model: M.YoloFace, block: torch.Tensor,
                   shape: Tuple[int, ...], mesh: SpatialMesh):
    """The YoloFace forward of this rank's NHWC input `block` of a whole
    input of `shape`: (the head's per-level raw maps, NCHW (bs, na*no,
    ny, nx), whole on every rank from one exact gather, the run)."""
    check_spatial(model)
    outs, shapes, run = run_blocks(model, block, shape, mesh,
                                   reshape_heads=False)
    # the conv layout (bs, ny, nx, c) back to the head's NCHW maps
    blocks = [o.permute(0, 3, 1, 2) for o in outs]
    shapes = [(s[0], s[3], s[1], s[2]) for s in shapes]
    maps = gather_blocks(mesh, blocks, shapes, [
        (slice(None), slice(None), *run.slices(s[2], s[3])) for s in shapes])
    return maps, run
