"""Where the fused-ELAN kernel's time goes, phase by phase, on one CUDA card.

    python -m face_detection_multi_scale_tpu_torch.tools.elan_profile \\
        --model yolov7-w6-face [--dtype bfloat16]

float32 builds csrc/fused_elan.cu with -DFDMS_ELAN_PROFILE (the first
thread of each warpgroup adds the SM clocks of each phase into its
block's counters); bfloat16 builds csrc/fused_elan_bf16.cu, the TMA route
that bf16 groups of a channels_last forward take, the same way (the
first thread of each consumer warpgroup and of the epilogue warpgroup,
and the producer's issuing thread). It runs every fused group of one
b8@640 forward of
FaceDetector(model, fuse_elan=True, dtype=--dtype) (seeded weights, noise
frames) after a warm-up, and prints per group its time (CUDA events,
profiling build) and each phase's share of the kernel's clocks, summed
over blocks and warpgroups, then the same over all groups.

float32 phases: wait (a chunk's cp.async copies landing), split (the
weights' 3xTF32 split), barrier (the block barrier of a chunk), issue
(issuing the next chunk's copies), math (A fragments, wgmma, the f32
flush), epilogue (bias, activation, stores), setup (window and block-step
geometry, zeros outside the image), cluster sync. bfloat16 phases, of the
roles' own clocks: the consumer warpgroups' wait (a stage's full
mbarrier), math (issuing a stage's wgmmas and waiting for the stage
before), hand (the last products and the hand-over of the f32 sums,
waiting for the epilogue to be done with the last ones), cluster sync;
the epilogue warpgroup's hand wait (for the consumers' sums), epilogue
(bias, activation, the 16-byte stores), zero (window rows outside the
image), cluster sync; the producer's empty-mbarrier waits. The counters
cost time of their own: read the shares, not the times, and time the
plain build with tools/elan_plan_ab.py.
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

# the sources' enum Phase, in order
PHASES = ("wait", "split", "barrier", "issue", "math", "epilogue", "setup",
          "cluster sync", "total", "chunks")
SHOWN = PHASES[:8]
TMA_PHASES = ("wait", "math", "hand", "hand wait", "epilogue", "zero",
              "cluster sync", "producer wait", "total", "steps")


def read_counters(lib: ctypes.CDLL, blocks: int, tma: bool = False
                  ) -> np.ndarray:
    """The profiling build's counters of `blocks` blocks, summed over
    blocks and warpgroups (one entry per PHASES), and zeroed. The TMA
    route's (tma=True) come per TMA_PHASES and role: (the two consumer
    warpgroups summed, the epilogue warpgroup, the producer)."""
    fn = (lib.fdms_fused_elan_tma_profile if tma
          else lib.fdms_fused_elan_profile)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    names = TMA_PHASES if tma else PHASES
    slots = 4 if tma else 2
    buf = (ctypes.c_ulonglong * (blocks * slots * len(names)))()
    rc = fn(buf, blocks)
    if rc != len(names):
        raise RuntimeError(f"profile counters returned {rc}")
    c = np.frombuffer(buf, dtype=np.uint64).reshape(
        blocks, slots, len(names)).astype(np.float64)
    if tma:
        return np.stack([c[:, :2].sum(axis=(0, 1)), c[:, 2].sum(axis=0),
                         c[:, 3].sum(axis=0)])
    return c.sum(axis=(0, 1))


def shares(c: np.ndarray) -> str:
    return ", ".join(f"{n} {100 * c[i] / c[PHASES.index('total')]:.1f}%"
                     for i, n in enumerate(SHOWN))


def tma_shares(c: np.ndarray) -> str:
    """Each role's phase shares of its own clocks."""
    total = TMA_PHASES.index("total")

    def part(row, names):
        return ", ".join(
            f"{n} {100 * row[TMA_PHASES.index(n)] / max(row[total], 1):.1f}%"
            for n in names)

    cons, epi, prod = c
    cons_phases = ('wait', 'math', 'hand', 'cluster sync')
    return (f"consumers: {part(cons, cons_phases)}"
            f"; epilogue: "
            f"{part(epi, ('hand wait', 'epilogue', 'zero', 'cluster sync'))}"
            f"; producer: {part(prod, ('producer wait',))}")


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
    tma = args.dtype == "bfloat16"
    if tma:
        E.TMA_NVCC_FLAGS = E.TMA_NVCC_FLAGS + ("-DFDMS_ELAN_PROFILE",)
        E._tma_library.cache_clear()
        lib = E._tma_library()
    else:
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
          f"groups, profiling build of "
          f"{(E.TMA_SOURCE if tma else E.SOURCE).name} on {smi}:")
    total = np.zeros((3, len(TMA_PHASES)) if tma else len(PHASES))
    for g, (x, ws, shape) in enumerate(calls):
        h, w = E._check(x, ws, shape)
        route = E.elan_route(x, ws, shape)
        if tma and route != "tma":
            raise SystemExit(f"group {g} takes the {route} route, not the "
                             f"TMA route the profiling build measures")
        blocks = (E.elan_tma_plan(shape, x.shape[0], h, w, n_sm).grid if tma
                  else E.elan_plan(shape, x.shape[0], h, w, n_sm)["grid"])
        E.fused_elan(x, ws, shape)
        torch.cuda.synchronize()
        read_counters(lib, blocks, tma)
        ms = time_ms(lambda: E.fused_elan(x, ws, shape), 1)
        c = read_counters(lib, blocks, tma) / 2  # warm-up and timed run
        total += c
        if tma:
            steps = c[0][TMA_PHASES.index("steps")]
            per = c[0][TMA_PHASES.index("total")] / max(steps, 1)
            print(f"  group {g} ({h}x{w}, {shape.cin}->{shape.cout}): "
                  f"{ms:.3f} ms, {per:.0f} clocks a stage a warpgroup; "
                  f"{tma_shares(c)}")
            continue
        chunks = c[PHASES.index("chunks")]
        print(f"  group {g} ({h}x{w}, {shape.cin}->{shape.cout}): {ms:.3f} "
              f"ms, {c[PHASES.index('total')] / max(chunks, 1):.0f} clocks "
              f"a chunk a warpgroup; {shares(c)}")
    print(f"  all groups: {tma_shares(total) if tma else shares(total)}")


if __name__ == "__main__":
    main()
