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
operations) per pair of a candidate and an earlier keeper. "seq" is two
kernels on the stream: pass 1 fills bit-packed suppression rows for every
(row tile, column tile >= row tile) pair of 64 candidates over the whole
card (B x T(T+1)/2 blocks, T = ceil(K / 64)); pass 2, one block per image,
walks the rows in score order with a `removed` bit vector in shared
memory. The rows go into a scratch buffer, `mask_words(B, K)` 64-bit
words: B * K * ceil(K / 64), 16.8 MB at B = 8, K = 4096 and 64 MB at
B = 2, K = 16384. "fixpoint": one block per image runs Jacobi sweeps
keep' = valid & ~any_{j<i}(IoU > thr & keep_j) over all candidates, the
keep vectors in shared memory, until a sweep changes nothing; it never
stores the K x K matrix. See the source for the layout.

On a CPU tensor `nms_keep` runs `nms_keep_plain`, the same function by
the fixpoint of the JAX package's `nms_keep_matrix`, for either version;
on a CUDA tensor it launches the kernel or raises.
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


def nms_keep_plain(boxes: torch.Tensor, valid: torch.Tensor,
                   iou_thres: float) -> torch.Tensor:
    """Plain PyTorch keep mask. boxes (B, K, 4) f32 sorted by descending
    score, valid (B, K) bool -> keep (B, K) bool.

    The fixpoint of `nms_keep_matrix`: sup[i, j] = IoU(i, j) > thr for a
    valid higher-ranked j < i; iterate keep = valid & ~any_j(sup & keep)
    until nothing changes. It equals sequential greedy NMS. Materializes
    the (B, K, K) matrix, so it is the reference, not a fast path."""
    k = boxes.shape[1]
    idx = torch.arange(k, device=boxes.device)
    sup = ((box_iou(boxes, boxes) > iou_thres)
           & (idx[None, :] < idx[:, None]) & valid[:, None, :])
    keep = valid
    for _ in range(k):
        new = valid & ~(sup & keep[:, None, :]).any(dim=-1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


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
    for fn in (lib.fdms_nms_mask, lib.fdms_nms_keep_fixpoint):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.fdms_nms_scan.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p]
    lib.fdms_nms_scan.restype = ctypes.c_int
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


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float,
             kernel_version: str = "seq") -> torch.Tensor:
    """Batched greedy-NMS keep mask. boxes (B, K, 4) float32 contiguous,
    sorted by descending score; valid (B, K) bool. Returns keep (B, K)
    bool in the same order. CPU tensors: the plain version. CUDA tensors:
    the `kernel_version` kernel ("seq" or "fixpoint", the same result),
    for any K (no tiling constraint). `nms_keep.launches` counts calls
    that launch the seq kernel, one per keep mask, although a call is two
    kernels on the stream (pass 1 and pass 2, with a scratch buffer of
    `mask_words(B, K)` int64 between them); `nms_keep.fixpoint_launches`
    counts launches of the fixpoint one."""
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
    if kernel_version == "seq":
        mask = torch.empty(mask_words(b, k), dtype=torch.int64,
                           device=boxes.device)
        launch_mask(boxes, valid, iou_thres, mask)
        launch_scan(mask, valid, keep)
        nms_keep.launches += 1
    else:
        _raise_on(_library().fdms_nms_keep_fixpoint(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k,
            float(iou_thres), boxes.device.index,
            torch.cuda.current_stream(boxes.device).cuda_stream),
            kernel_version)
        nms_keep.fixpoint_launches += 1
    return keep


nms_keep.launches = 0
nms_keep.fixpoint_launches = 0
