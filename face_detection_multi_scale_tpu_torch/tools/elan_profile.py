"""Where the fused-ELAN kernel's time goes, phase by phase, on one CUDA card.

    python -m face_detection_multi_scale_tpu_torch.tools.elan_profile \\
        --model yolov7-w6-face [--dtype bfloat16]

Builds csrc/fused_elan.cu with -DFDMS_ELAN_PROFILE (the first thread of
each warpgroup adds the SM clocks of each phase into its block's
counters), runs every fused group of one b8@640 forward of
FaceDetector(model, fuse_elan=True, dtype=--dtype) (seeded weights, noise
frames; bfloat16 runs the bf16 kernel, whose split phase is empty) after a
warm-up, and prints per group its time (CUDA events, profiling build) and
each phase's share of the kernel's clocks, summed over blocks and
warpgroups, then the same over all groups. The phases: wait (a chunk's
cp.async copies landing), split (the weights' 3xTF32 split), barrier (the
block barrier of a chunk), issue (issuing the next chunk's copies), math
(A fragments, wgmma, the f32 flush), epilogue (bias, activation, stores),
setup (window and block-step geometry, zeros outside the image), cluster
sync. The counters cost time of their own: read the shares, not the
times, and time the plain build with tools/elan_plan_ab.py.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch

from face_detection_multi_scale_tpu_torch.infer.detector import (
    DTYPES, FaceDetector)
from face_detection_multi_scale_tpu_torch.ops import elan_kernel as E
from face_detection_multi_scale_tpu_torch.tools.elan_plan_ab import (
    capture, time_ms)

# the source's enum Phase, in order
PHASES = ("wait", "split", "barrier", "issue", "math", "epilogue", "setup",
          "cluster sync", "total", "chunks")
SHOWN = PHASES[:8]


def read_counters(lib: ctypes.CDLL, blocks: int) -> np.ndarray:
    """The profiling build's counters of `blocks` blocks, summed over
    blocks and warpgroups (one entry per PHASES), and zeroed."""
    lib.fdms_fused_elan_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fdms_fused_elan_profile.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * (blocks * 2 * len(PHASES)))()
    rc = lib.fdms_fused_elan_profile(buf, blocks)
    if rc != len(PHASES):
        raise RuntimeError(f"fdms_fused_elan_profile returned {rc}")
    return np.frombuffer(buf, dtype=np.uint64).reshape(
        blocks, 2, len(PHASES)).sum(axis=(0, 1)).astype(np.float64)


def shares(c: np.ndarray) -> str:
    return ", ".join(f"{n} {100 * c[i] / c[PHASES.index('total')]:.1f}%"
                     for i, n in enumerate(SHOWN))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="yolov7-w6-face")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("elan_profile needs a CUDA card")
    frames = np.random.default_rng(0).integers(
        0, 256, (args.batch, args.size, args.size, 3), dtype=np.uint8)
    det = FaceDetector(args.model, img_sizes=(args.size,), fuse_elan=True,
                       dtype=DTYPES[args.dtype], device="cuda")
    calls = capture(det, frames)
    E.NVCC_FLAGS = E.NVCC_FLAGS + ("-DFDMS_ELAN_PROFILE",)
    E._library.cache_clear()
    lib = E._library()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    tag = "" if args.dtype == "float32" else f" {args.dtype}"
    print(f"{args.model}{tag} b{args.batch}@{args.size}, {len(calls)} "
          f"groups, profiling build on {smi}:")
    total = np.zeros(len(PHASES))
    for g, (x, ws, shape) in enumerate(calls):
        h, w = E._check(x, ws, shape)
        blocks = E.elan_plan(shape, x.shape[0], h, w, n_sm)["grid"]
        E.fused_elan(x, ws, shape)
        torch.cuda.synchronize()
        read_counters(lib, blocks)
        ms = time_ms(lambda: E.fused_elan(x, ws, shape), 1)
        c = read_counters(lib, blocks) / 2  # warm-up and timed run
        total += c
        chunks = c[PHASES.index("chunks")]
        print(f"  group {g} ({h}x{w}, {shape.cin}->{shape.cout}): {ms:.3f} "
              f"ms, {c[PHASES.index('total')] / max(chunks, 1):.0f} clocks "
              f"a chunk a warpgroup; {shares(c)}")
    print(f"  all groups: {shares(total)}")


if __name__ == "__main__":
    main()
