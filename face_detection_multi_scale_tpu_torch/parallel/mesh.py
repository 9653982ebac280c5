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
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

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
    `mesh.rows(n)`, bit for bit: each rank writes its rows into a zero
    buffer and the buffers are summed as integers (each element's bits as
    a signed integer, widened to at least 32 bits, which NCCL and gloo
    both sum), so the sum with zeros is exact for every value."""
    if mesh.group is None:
        return local
    bits = (local.view(_INTS[local.element_size()])
            if local.is_floating_point() or local.dtype == torch.bool
            else local)
    wide = bits.to(torch.int32) if bits.element_size() < 4 else bits
    out = wide.new_zeros((n, *local.shape[1:]))
    out[mesh.rows(n)] = wide
    mesh.all_reduce(out)
    return out.to(bits.dtype).view(local.dtype)


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
