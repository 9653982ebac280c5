"""Greedy-NMS keep mask: the hand-written CUDA kernels and their plain version.

`nms_keep` replaces the JAX package's two keep-mask kernels, both reached
through `nms_keep_pallas(kernel_version=...)`:
  * "seq" (the serving path) replaces ops/pallas_nms.py::_kernel_seq;
  * "fixpoint" replaces ops/pallas_nms.py::_kernel, the whole-candidate
    fixpoint sweeps that the JAX package keeps as a cross-check.
Source: csrc/nms_keep.cu, CUDA C++ for sm_90a, compiled by nvcc at first
use (ops/cuda_build.py) and bound with ctypes.

What bounds them on the card: operations, not bytes. Each candidate costs
18 bytes of traffic, while the greedy scan needs one f32 IoU (about 12
operations) per pair of a candidate and an earlier keeper. Both versions
start with the same pass 1, which fills bit-packed suppression rows for
every (row tile, column tile >= row tile) pair of 64 candidates over the
whole card (B x T(T+1)/2 blocks, T = ceil(K / 64)), each pair's IoU
tested once. The rows go into a scratch buffer, `mask_words(B, K)` 64-bit
words: B * K * ceil(K / 64), 16.8 MB at B = 8, K = 4096 and 64 MB at
B = 2, K = 16384. "seq": pass 2, one block per image, walks the rows in
score order with a `removed` bit vector in shared memory. "fixpoint":
the sweep kernel, one thread-block cluster of `FIXPOINT_CLUSTER` blocks
per image, runs the Jacobi sweeps keep' = valid & ~OR(rows of the kept
candidates) over the same rows, each block its share of the words, the
keep vector double-buffered in every block's shared memory and exchanged
through distributed shared memory, one cluster barrier a sweep, until a
sweep changes nothing (at most K sweeps); it writes each image's sweep
count beside the mask (`nms_keep.last_fixpoint_sweeps`, the count that
`fixpoint_sweeps_plain` gives). See the source for the layout.

On a CPU tensor `nms_keep` runs `nms_keep_plain`, the same function by
the fixpoint of the JAX package's `nms_keep_matrix`, for either version;
on a CUDA tensor it launches the kernel or raises.

The keep mask is also the torch custom op `fdms_torch::nms_keep`, with a
fake version that gives the (B, K) bool shape, so that `torch.export`
carries the kernel into a serialized program (export_model.py). The live
paths call `nms_keep` directly; under `torch.compiler.is_exporting()`
`nms_keep` emits the op instead. The op's CUDA version is the wrapper
(the kernel, counted in `nms_keep.launches`, so a loaded program's calls
count too); its CPU version is `nms_keep_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from face_detection_multi_scale_tpu_torch.ops import cuda_build
from face_detection_multi_scale_tpu_torch.ops.boxes import box_iou

SOURCE = cuda_build.CSRC / "nms_keep.cu"
# -fmad=false: (area_i + area_j) - iw*ih must not contract into an FMA, or
# the last bit of the IoU differs from the plain version
NVCC_FLAGS = cuda_build.BASE_FLAGS + ("-fmad=false",)
KERNEL_VERSIONS = ("seq", "fixpoint")
# blocks of the fixpoint sweep kernel's cluster per image (a launch with a
# size the card refuses raises)
FIXPOINT_CLUSTER = 16


def _jacobi(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float):
    """The fixpoint loop of `nms_keep_matrix`: keep (B, K) bool and each
    image's sweeps (B,) int32 (sweeps computed, the last one that changed
    nothing included, at most K)."""
    b, k = valid.shape
    idx = torch.arange(k, device=boxes.device)
    sup = ((box_iou(boxes, boxes) > iou_thres)
           & (idx[None, :] < idx[:, None]) & valid[:, None, :])
    keep = valid
    sweeps = torch.full((b,), k, dtype=torch.int32, device=boxes.device)
    done = torch.zeros(b, dtype=torch.bool, device=boxes.device)
    for sweep in range(1, k + 1):
        new = valid & ~(sup & keep[:, None, :]).any(dim=-1)
        same = (new == keep).all(dim=1)
        sweeps[same & ~done] = sweep
        done |= same
        if bool(done.all()):
            break
        keep = new  # an image that is done stays at its fixpoint
    return keep, sweeps


def nms_keep_plain(boxes: torch.Tensor, valid: torch.Tensor,
                   iou_thres: float) -> torch.Tensor:
    """Plain PyTorch keep mask. boxes (B, K, 4) f32 sorted by descending
    score, valid (B, K) bool -> keep (B, K) bool.

    The fixpoint of `nms_keep_matrix`: sup[i, j] = IoU(i, j) > thr for a
    valid higher-ranked j < i; iterate keep = valid & ~any_j(sup & keep)
    until nothing changes. It equals sequential greedy NMS. Materializes
    the (B, K, K) matrix, so it is the reference, not a fast path."""
    return _jacobi(boxes, valid, iou_thres)[0]


def fixpoint_sweeps_plain(boxes: torch.Tensor, valid: torch.Tensor,
                          iou_thres: float) -> torch.Tensor:
    """Each image's sweeps (B,) int32 in the loop of `nms_keep_plain`:
    sweeps computed from keep = valid, the last one that changed nothing
    included, at most K. The fixpoint kernel's count
    (`nms_keep.last_fixpoint_sweeps`) must equal it."""
    return _jacobi(boxes, valid, iou_thres)[1]


def build():
    """Compile csrc/nms_keep.cu (once per source and flags); returns the
    shared library's path."""
    return cuda_build.build(SOURCE, NVCC_FLAGS)


def mask_words(b: int, k: int) -> int:
    """64-bit words of the seq kernel's suppression rows: B * K *
    ceil(K / 64)."""
    return b * k * -(-k // 64)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for fn, args in (
            (lib.fdms_nms_mask, [vp, vp, vp, i32, i32, ctypes.c_float, i32,
                                 vp]),
            (lib.fdms_nms_scan, [vp, vp, vp, i32, i32, i32, vp]),
            (lib.fdms_nms_sweep, [vp, vp, vp, vp, i32, i32, i32, i32, vp]),
            (lib.fdms_nms_sweep_clusters, [i32, i32, i32,
                                           ctypes.POINTER(i32)])):
        fn.argtypes = args
        fn.restype = i32
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"nms_keep ({what}) kernel launch failed: CUDA "
                           f"error {err}")


def launch_mask(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float,
                mask: torch.Tensor) -> None:
    """Pass 1 of the seq kernel alone: fills `mask` (mask_words(B, K)
    int64). No checks and no count: `nms_keep` is the entry point; this
    exists so a measurement can time the passes apart."""
    b, k = valid.shape
    _raise_on(_library().fdms_nms_mask(
        boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(), b, k,
        float(iou_thres), boxes.device.index,
        torch.cuda.current_stream(boxes.device).cuda_stream), "pass 1")


def launch_scan(mask: torch.Tensor, valid: torch.Tensor,
                keep: torch.Tensor) -> None:
    """Pass 2 of the seq kernel alone: keep (B, K) from pass 1's `mask`.
    As `launch_mask`, for measurements."""
    b, k = valid.shape
    _raise_on(_library().fdms_nms_scan(
        mask.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k,
        valid.device.index,
        torch.cuda.current_stream(valid.device).cuda_stream), "pass 2")


def launch_sweeps(mask: torch.Tensor, valid: torch.Tensor,
                  keep: torch.Tensor, sweeps: torch.Tensor,
                  cluster: int | None = None) -> None:
    """The fixpoint version's sweep kernel alone: keep (B, K) and sweeps
    (B,) int32 from pass 1's `mask`, clusters of `cluster` blocks
    (`FIXPOINT_CLUSTER` by default). As `launch_mask`, for measurements."""
    b, k = valid.shape
    _raise_on(_library().fdms_nms_sweep(
        mask.data_ptr(), valid.data_ptr(), keep.data_ptr(), sweeps.data_ptr(),
        b, k, FIXPOINT_CLUSTER if cluster is None else cluster,
        valid.device.index,
        torch.cuda.current_stream(valid.device).cuda_stream),
        "fixpoint sweeps")


def fixpoint_max_active_clusters(k: int, cluster: int, device: int) -> int:
    """How many sweep-kernel clusters of `cluster` blocks card `device`
    holds at once for K candidates (cudaOccupancyMaxActiveClusters)."""
    out = ctypes.c_int(0)
    _raise_on(_library().fdms_nms_sweep_clusters(k, cluster, device,
                                                 ctypes.byref(out)),
              "occupancy query")
    return out.value


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float,
             kernel_version: str = "seq") -> torch.Tensor:
    """Batched greedy-NMS keep mask. boxes (B, K, 4) float32 contiguous,
    sorted by descending score; valid (B, K) bool. Returns keep (B, K)
    bool in the same order. CPU tensors: the plain version. CUDA tensors:
    the `kernel_version` kernel ("seq" or "fixpoint", the same result),
    for any K (no tiling constraint). Either version is two kernels on
    the stream, pass 1 and its own second kernel, with a scratch buffer
    of `mask_words(B, K)` int64 between them. `nms_keep.launches` counts
    calls that launch the seq kernel, `nms_keep.fixpoint_launches` those
    that launch the fixpoint one, one per keep mask; the fixpoint version
    leaves each image's sweep count, int32 (B,) on the card, in
    `nms_keep.last_fixpoint_sweeps`."""
    if kernel_version not in KERNEL_VERSIONS:
        raise ValueError(f"kernel_version must be one of {KERNEL_VERSIONS}, "
                         f"got {kernel_version!r}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    if tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"valid {tuple(valid.shape)} does not match boxes "
                         f"{tuple(boxes.shape)}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"need float32 boxes and bool valid, got "
                        f"{boxes.dtype} and {valid.dtype}")
    if boxes.device != valid.device:
        raise ValueError(f"boxes on {boxes.device}, valid on {valid.device}")
    if torch.compiler.is_exporting():
        return torch.ops.fdms_torch.nms_keep(boxes, valid, float(iou_thres),
                                             kernel_version)
    return _keep(boxes, valid, iou_thres, kernel_version)


def _keep(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float,
          kernel_version: str) -> torch.Tensor:
    """`nms_keep` on checked tensors: the plain version on the CPU, the
    kernel on the card (counted)."""
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, valid, iou_thres)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned")
    b, k = valid.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    if b >= 2 ** 31 or k >= 2 ** 31:
        raise ValueError(f"shape {tuple(boxes.shape)} too large")
    mask = torch.empty(mask_words(b, k), dtype=torch.int64,
                       device=boxes.device)
    launch_mask(boxes, valid, iou_thres, mask)
    if kernel_version == "seq":
        launch_scan(mask, valid, keep)
        nms_keep.launches += 1
    else:
        sweeps = torch.empty(b, dtype=torch.int32, device=boxes.device)
        launch_sweeps(mask, valid, keep, sweeps)
        nms_keep.last_fixpoint_sweeps = sweeps
        nms_keep.fixpoint_launches += 1
    return keep


nms_keep.launches = 0
nms_keep.fixpoint_launches = 0
nms_keep.last_fixpoint_sweeps = None


@torch.library.custom_op("fdms_torch::nms_keep", mutates_args=())
def nms_keep_op(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float,
                kernel_version: str) -> torch.Tensor:
    """`nms_keep` as a custom op (what an exported program calls): the
    kernel on CUDA tensors, `nms_keep_plain` on CPU tensors."""
    if boxes.device.type == "cpu":
        # a fresh tensor: the plain loop may hand back `valid` itself
        return nms_keep_plain(boxes, valid, iou_thres).clone()
    return _keep(boxes, valid, iou_thres, kernel_version)


@nms_keep_op.register_fake
def _nms_keep_fake(boxes, valid, iou_thres, kernel_version):
    return torch.empty(valid.shape, dtype=torch.bool, device=valid.device)
