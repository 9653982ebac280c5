"""The data-parallel mesh: one process a card in a torch.distributed
process group.

The port's counterpart of the data half of the JAX package's
parallel/mesh.py. The JAX package runs one controller over a 1-D "data"
mesh of devices, and XLA inserts the gradient and batch-norm reductions.
Here, as in the reference's DDP layout (train.py:649-658), every card has a
process of its own, and the mesh is the process group: every rank holds
the whole model, takes its rows of each batch (`shard_batch`), and the
reductions are explicit collectives (`DataMesh.all_reduce`,
`all_reduce_tensors` for gradients, `gather_rows` for results, and
BatchNorm's own in models/layers.py).

Backends: NCCL for a mesh of cards, gloo for a mesh of CPU processes. A
collective runs on the backend's own device: NCCL on card copies, gloo on
host copies, so a gloo group of processes that share one card stages each
collective through host memory. A failed collective raises; nothing falls
back to a one-process result. Without a process group, `make_data_mesh()`
is a world of one, whose collectives return their input.

The spatial half (`make_spatial_mesh`, `spatial_input_sharding`,
`spatial_infer`) splits one image's height and width over a (sp_h, sp_w)
grid of the same processes: each rank computes its block of every
activation, parallel/spatial.py exchanges the halos each conv and pool
needs, and the head's raw maps are gathered once, exactly.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing as mp
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

DATA_AXIS = "data"


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda", backend: Optional[str] = None,
                           timeout: float = 1800.0) -> None:
    """Join this process to a process group of `num_processes` (the
    reference's init_process_group, train.py:652-656). `coordinator` is
    "host:port" of rank 0; without it, and without the counts, torchrun's
    environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK)
    is read. A no-op for one process, as the JAX package's is.

    The backend is NCCL for `device` "cuda" (this process takes card
    LOCAL_RANK, or `process_id` modulo the cards) and gloo for "cpu";
    `backend` overrides it (gloo between processes that share one card).
    Raises where NCCL is asked for and there is no card or no NCCL."""
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if num_processes <= 1:
        return
    backend = backend or ("nccl" if torch.device(device).type == "cuda"
                          else "gloo")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("a NCCL mesh needs a CUDA card; pass "
                               "device='cpu' for a gloo mesh of CPU "
                               "processes")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL")
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=(f"tcp://{coordinator}" if coordinator
                              else "env://"),
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))


# the signed integer type of each element width
_INTS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@dataclasses.dataclass(frozen=True, eq=False)
class DataMesh:
    """A 1-D data mesh: the process group (None for a world of one
    without one), this process's rank in it, its size and the group's
    backend. Deep copies share it (a model that holds it is copied with
    the mesh, not with a copy of the group)."""
    group: Any
    rank: int
    size: int
    backend: Optional[str] = None

    def __deepcopy__(self, memo):
        return self

    @property
    def comm_device(self) -> torch.device:
        """Where this mesh's collectives run: the card for NCCL, the host
        for gloo."""
        return (torch.device("cuda", torch.cuda.current_device())
                if self.backend == "nccl" else torch.device("cpu"))

    def _collective(self, t: torch.Tensor, op: Callable) -> torch.Tensor:
        """op(buffer) on a contiguous copy of `t` on the comm device (or on
        `t` itself where it is one), written back into `t`."""
        if self.group is None:
            return t
        buf = (t if t.device == self.comm_device and t.is_contiguous()
               else t.detach().contiguous().to(self.comm_device))
        op(buf)
        if buf is not t:
            t.copy_(buf)
        return t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the mesh, in place; returns `t`."""
        return self._collective(t, lambda b: dist.all_reduce(
            b, group=self.group))

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """`t` of mesh rank 0 on every rank, in place; returns `t`."""
        src = self.src
        return self._collective(t, lambda b: dist.broadcast(
            b, src, group=self.group))

    @property
    def src(self) -> int:
        """The global rank of mesh rank 0."""
        return dist.get_global_rank(self.group, 0)

    def rows(self, n: int) -> slice:
        """This rank's rows of a leading dimension of n (the mesh size
        must divide n)."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not split over a mesh of "
                             f"{self.size}")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def make_data_mesh(devices: Optional[Sequence[int]] = None
                   ) -> Optional[DataMesh]:
    """The 1-D data mesh over every process of the group, or over the
    global ranks `devices` (a subgroup; every process must make the same
    call, and a process outside `devices` gets None). Without a process
    group, a world of one. A rank computes on its own device, which the
    caller chooses (the card of `initialize_distributed`)."""
    if not _initialized():
        if devices is not None and list(devices) != [0]:
            raise ValueError(f"ranks {list(devices)} without a process "
                             f"group")
        return DataMesh(None, 0, 1)
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r)
                                                        for r in devices]
    group = (dist.group.WORLD if ranks == list(range(world))
             else dist.new_group(ranks))
    me = dist.get_rank()
    if me not in ranks:
        return None
    return DataMesh(group, ranks.index(me), len(ranks),
                    dist.get_backend(group))


def active_mesh(mesh: Optional[DataMesh]) -> Optional[DataMesh]:
    """`mesh` where it has a process group, else None: a world of one
    without a group runs as no mesh. The entry points (FaceDetector,
    make_train_step, make_accum_steps, cli/train) take their mesh through
    this, so the layers below them test only `mesh is not None`."""
    return mesh if mesh is not None and mesh.group is not None else None


def batch_sharding(mesh: DataMesh, n: int) -> slice:
    """This rank's rows of a leading (batch) dimension of n."""
    return mesh.rows(n)


def shard_batch(mesh: DataMesh, tree):
    """This rank's rows of the leading dimension of every array or tensor
    in `tree` (dicts, lists and tuples of them): the DistributedSampler
    equivalent, where each rank owns a slice of the global batch."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    return tree[mesh.rows(tree.shape[0])]


def _bucketed(tensors: List[torch.Tensor], op: Callable) -> None:
    """op(flat) once per (dtype, device) bucket of `tensors`, written back
    into them."""
    buckets: Dict[Any, List[torch.Tensor]] = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for group in buckets.values():
        flat = _flatten_dense_tensors([t.detach() for t in group])
        op(flat)
        for t, v in zip(group, _unflatten_dense_tensors(flat, group)):
            t.copy_(v)


@torch.no_grad()
def replicated(mesh: DataMesh, tensors):
    """Mesh rank 0's values of `tensors` (a list, or a dict's values) on
    every rank, in place, in one broadcast a dtype; returns `tensors`."""
    if mesh.group is not None:
        _bucketed(_values(tensors), mesh.broadcast)
    return tensors


@torch.no_grad()
def all_reduce_tensors(mesh: DataMesh, tensors) -> None:
    """Sum each of `tensors` (a list, or a dict's values) over the mesh,
    in place, in one collective a dtype."""
    if mesh.group is not None:
        _bucketed(_values(tensors), mesh.all_reduce)


def _values(tensors) -> List[torch.Tensor]:
    return list(tensors.values() if isinstance(tensors, dict) else tensors)


def gather_rows(mesh: DataMesh, local: torch.Tensor, n: int
                ) -> torch.Tensor:
    """The global (n, ...) tensor on every rank from each rank's rows
    `mesh.rows(n)`, bit for bit (`gather_blocks`)."""
    return gather_blocks(mesh, [local], [(n, *local.shape[1:])],
                         [mesh.rows(n)])[0]


def gather_blocks(mesh: DataMesh, blocks: Sequence[torch.Tensor],
                  shapes: Sequence[Sequence[int]], indices: Sequence
                  ) -> List[torch.Tensor]:
    """Each global tensor of `shapes` on every rank, from each rank's
    `blocks[k]` at `indices[k]` (an index of the global tensor; the
    ranks' blocks do not overlap), bit for bit: each rank writes its
    blocks into zero buffers and the buffers are summed as integers (each
    element's bits as a signed integer, widened to at least 32 bits,
    which NCCL and gloo both sum), so the sum with zeros is exact for
    every value. One all-reduce for each integer width."""
    if mesh.group is None:
        return list(blocks)
    wide, bits_dtypes = [], []
    for b in blocks:
        bits = (b.view(_INTS[b.element_size()])
                if b.is_floating_point() or b.dtype == torch.bool else b)
        bits_dtypes.append(bits.dtype)
        wide.append(bits.to(torch.int32) if bits.element_size() < 4
                    else bits)
    out: List[Optional[torch.Tensor]] = [None] * len(blocks)
    # in the blocks' order, so that the ranks' collectives match
    for dt in dict.fromkeys(w.dtype for w in wide):
        ks = [k for k, w in enumerate(wide) if w.dtype == dt]
        sizes = [math.prod(shapes[k]) for k in ks]
        flat = wide[ks[0]].new_zeros(sum(sizes))
        views = [v.view(tuple(shapes[k])) for k, v in
                 zip(ks, flat.split(sizes))]
        for k, v in zip(ks, views):
            v[indices[k]] = wide[k]
        mesh.all_reduce(flat)
        for k, v in zip(ks, views):
            out[k] = v.to(bits_dtypes[k]).view(blocks[k].dtype)
    return out


def broadcast_object(mesh: DataMesh, obj):
    """Mesh rank 0's picklable `obj` on every rank (a rank's own `obj` is
    ignored)."""
    if mesh.group is None:
        return obj
    box = [obj if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=mesh.src, group=mesh.group)
    return box[0]


def is_main_process() -> bool:
    """Rank-0 gating (reference utils/torch_utils.py:27-36): True without
    a process group."""
    return not _initialized() or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# the spatial mesh: one image's plane over a grid of ranks
# ---------------------------------------------------------------------------

SPATIAL_AXES = ("sp_h", "sp_w")


@dataclasses.dataclass(frozen=True, eq=False)
class SpatialMesh(DataMesh):
    """A (sp_h, sp_w) grid of the ranks of a process group, row-major:
    `ranks[r * cols + c]` is the global rank at grid row r, column c, and
    `rank` (this process's place in `ranks`) is at `coords`. Its
    collectives are DataMesh's, on the same comm device. A 1x1 grid
    (size 1, with or without a group) computes as one process."""
    ranks: Tuple[int, ...] = (0,)
    shape: Tuple[int, int] = (1, 1)

    @property
    def coords(self) -> Tuple[int, int]:
        """This rank's (row, column) in the grid."""
        return divmod(self.rank, self.shape[1])

    def at(self, row: int, col: int) -> int:
        """The global rank at grid row `row`, column `col`."""
        return self.ranks[row * self.shape[1] + col]

    @property
    def neighbours(self) -> Dict[str, Optional[int]]:
        """The global ranks above, below, left and right of this one
        (None at the grid's edge)."""
        (r, c), (rows, cols) = self.coords, self.shape
        return {"up": self.at(r - 1, c) if r > 0 else None,
                "down": self.at(r + 1, c) if r + 1 < rows else None,
                "left": self.at(r, c - 1) if c > 0 else None,
                "right": self.at(r, c + 1) if c + 1 < cols else None}


def make_spatial_mesh(devices: Optional[Sequence[int]] = None,
                      rows: Optional[int] = None
                      ) -> Optional[SpatialMesh]:
    """A (sp_h, sp_w) grid over every process of the group, or over the
    global ranks `devices` (a subgroup; every process makes the same call
    and a process outside `devices` gets None): `rows` rows of n // rows
    ranks, row-major. Without `rows`, the JAX rule: int(sqrt(n)),
    lowered until it divides n (8 ranks: 2 x 4; 4: 2 x 2). Without a
    process group, a 1x1 grid. The port's answer to the reference
    pyramid's 3840 x 3840 scale (multi_scale_face_detector.py:33), run
    on one GPU there: one image's height and width split over the
    ranks."""
    if not _initialized():
        if devices is not None and list(devices) != [0]:
            raise ValueError(f"ranks {list(devices)} without a process "
                             f"group")
        if rows not in (None, 1):
            raise ValueError(f"{rows} rows without a process group")
        return SpatialMesh(None, 0, 1)
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r)
                                                        for r in devices]
    n = len(ranks)
    if rows is None:
        rows = math.isqrt(n)
        while n % rows:
            rows -= 1
    elif rows < 1 or n % rows:
        raise ValueError(f"{rows} rows do not divide {n} ranks")
    group = (dist.group.WORLD if ranks == list(range(world))
             else dist.new_group(ranks))
    me = dist.get_rank()
    if me not in ranks:
        return None
    return SpatialMesh(group, ranks.index(me), n, dist.get_backend(group),
                       ranks=tuple(ranks), shape=(rows, n // rows))


def split_extent(extent: int, parts: int, k: int) -> Tuple[int, int]:
    """[lo, hi) of part k when an extent is split over `parts` ranks:
    floor(k E / n) to floor((k + 1) E / n), so a part is empty where the
    ranks outnumber the extent."""
    return k * extent // parts, (k + 1) * extent // parts


@dataclasses.dataclass(frozen=True)
class SpatialSharding:
    """This rank's block of an NHWC plane on a spatial mesh (the JAX
    `NamedSharding(mesh, P(None, "sp_h", "sp_w", None))`): H split over
    the grid's rows, W over its columns, batch and channels whole."""
    mesh: SpatialMesh

    def slices(self, h: int, w: int) -> Tuple[slice, slice]:
        """This rank's rows and columns of an (h, w) plane."""
        (r, c), (rows, cols) = self.mesh.coords, self.mesh.shape
        return (slice(*split_extent(h, rows, r)),
                slice(*split_extent(w, cols, c)))

    def shard(self, x):
        """This rank's block of the NHWC array or tensor `x`."""
        hs, ws = self.slices(x.shape[1], x.shape[2])
        return x[:, hs, ws]


def spatial_input_sharding(mesh: SpatialMesh) -> SpatialSharding:
    """NHWC batch with H and W split over the spatial mesh's axes; batch
    and channels whole."""
    return SpatialSharding(mesh)


def spatial_infer(model, images_u8, mesh: SpatialMesh, postprocess=None,
                  dtype=None):
    """One (small-batch, huge-resolution) forward with the image plane
    split over the grid: every rank passes the whole uint8 NHWC batch,
    computes its block of every activation (parallel/spatial.py: the
    halo each conv and pool needs comes from the ranks that own it), the
    head's raw maps are gathered once, exactly, and every rank decodes
    them whole. Returns the decoded (bs, N, no) rows in the one-process
    order, or `postprocess(rows)`, on every rank. `model` is the
    YoloFace, in eval mode, with its weights on this rank's device (the
    JAX function's `variables` are inside it); the input is cast to
    `dtype` (float32 by default) and divided by 255, as the JAX function
    does. A 1x1 grid computes the one-process forward and decode, bit for
    bit, with no exchange. Convolutions in full float32 (TF32 off).

    Counts `spatial_infer.calls`, and this rank's `exchanges` (blocks
    received from other ranks) and `halo_bytes` (their bytes)."""
    from face_detection_multi_scale_tpu_torch.models.head import (
        decode, reshape_level)
    from face_detection_multi_scale_tpu_torch.models.model import full_fp32
    from face_detection_multi_scale_tpu_torch.parallel import spatial

    if model.training:
        raise ValueError("spatial_infer runs the model in eval mode "
                         "(call model.eval())")
    device = next(model.parameters()).device
    x = torch.as_tensor(images_u8)
    with torch.inference_mode(), full_fp32():
        if mesh.size == 1:
            raws = model(x.to(device).to(dtype or torch.float32) / 255.0)
        else:
            block = spatial_input_sharding(mesh).shard(x).to(device)
            maps, run = spatial.forward_blocks(
                model, block.to(dtype or torch.float32) / 255.0,
                tuple(x.shape), mesh)
            spatial_infer.exchanges += run.exchanges
            spatial_infer.halo_bytes += run.halo_bytes
            spec = model.spec
            raws = [reshape_level(m, spec.na, spec.no) for m in maps]
        preds = decode(raws, model.spec)
        out = postprocess(preds) if postprocess is not None else preds
    spatial_infer.calls += 1
    return out


spatial_infer.calls = spatial_infer.exchanges = spatial_infer.halo_bytes = 0


# ---------------------------------------------------------------------------
# a local world of spawned processes (tests, the card check)
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, backend, device, timeout, args, out):
    try:
        initialize_distributed(f"localhost:{port}", world, rank,
                               device=device, backend=backend,
                               timeout=timeout)
        try:
            result = (rank, True, fn(*args))
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        result = (rank, False, traceback.format_exc())
    out.put(result)


def run_ranks(fn: Callable, world: int, args=(), device="cpu",
              backend: Optional[str] = None, timeout: float = 600.0
              ) -> List[Any]:
    """fn(*args) in each of `world` spawned processes joined in one process
    group on localhost (a free port); returns the results in rank order.
    `fn` is picklable by its import path, and so are `args` and the
    results. Raises with the rank's traceback when a rank raises, when a
    rank exits without a result, or after `timeout` seconds; every process
    is stopped before it returns or raises."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, rank, world, port, backend, device, timeout, args, out))
        for rank in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(world)) - set(results))
                raise TimeoutError(f"ranks {late} did not finish in "
                                   f"{timeout} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:
                    # a late result may still be in the queue
                    try:
                        rank, ok, value = out.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
