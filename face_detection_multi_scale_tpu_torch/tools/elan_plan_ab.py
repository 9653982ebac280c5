"""Time every fused_elan group of a fused detector's forward under variants
of the kernel's launch plan, on one CUDA card.

    python -m face_detection_multi_scale_tpu_torch.tools.elan_plan_ab \\
        --model yolov7-tiny-face --rounds 7 base BLOCKS_PER_SM=1 \\
        WS_TILE_H=16,WS_TILE_W=16 [--dtype bfloat16]

A variant is "base" (the plan as it stands) or comma-separated NAME=VALUE
overrides of ops/elan_kernel.py's module constants, which `elan_plan` and
the build read at call time (a Path constant such as SOURCE or TMA_SOURCE
takes a file path, to time a changed kernel source; TMA_STRIP_ROWS and
TMA_SINGLE_ROWS change the TMA route's plan). The group inputs are
captured from one b8@640 forward of FaceDetector(model, fuse_elan=True,
dtype=--dtype) with seeded weights and noise frames (bfloat16: the
channels_last inputs of the TMA route, csrc/fused_elan_bf16.cu). Each
round times every variant, in an order
that rotates from round to round, each group by CUDA events (mean of 3
runs after one warm-up). Each block starts its K loop at a chunk that
depends on its place in the grid, so another plan (or another kernel,
SOURCE) sums in another order: every variant is held within 1e-5 of max
|base| per group (1e-2 in bf16), the bound the kernel is held to against
its plain version. Prints each round's per-variant sums, then per variant the
median, min and max of the sums and the per-group medians.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from face_detection_multi_scale_tpu_torch.infer.detector import (
    DTYPES, FaceDetector)
from face_detection_multi_scale_tpu_torch.models import fused as FUSED
from face_detection_multi_scale_tpu_torch.ops import elan_kernel as E

REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def parse_variant(text: str):
    """"base" -> {}; "A=1,B=x" -> {"A": 1, "B": Path("x") or int}."""
    if text == "base":
        return {}
    out = {}
    for part in text.split(","):
        name, value = part.split("=", 1)
        if not hasattr(E, name):
            raise SystemExit(f"elan_kernel has no constant {name}")
        old = getattr(E, name)
        out[name] = Path(value) if isinstance(old, Path) else type(old)(value)
    return out


def capture(det: FaceDetector, frames: np.ndarray):
    """The (x, weights, shape) of each fused_elan call of one forward."""
    calls, real = [], FUSED.fused_elan

    def record(x, weights, shape):
        calls.append((x.clone(), weights, shape))
        return real(x, weights, shape)

    FUSED.fused_elan = record
    try:
        det.forward_rows(frames)
    finally:
        FUSED.fused_elan = real
    torch.cuda.synchronize()
    return calls


def time_ms(fn, iters: int = 3) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="yolov7-w6-face")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    ap.add_argument("variants", nargs="*", default=["base"])
    args = ap.parse_args()
    dtype = DTYPES[args.dtype]
    if not torch.cuda.is_available():
        raise SystemExit("elan_plan_ab needs a CUDA card")
    variants = {v: parse_variant(v) for v in ["base"] + [
        v for v in args.variants if v != "base"]}
    defaults = {n: getattr(E, n) for ov in variants.values() for n in ov}

    def use(overrides):
        for name, value in {**defaults, **overrides}.items():
            setattr(E, name, value)
        E._library.cache_clear()
        E._tma_library.cache_clear()

    frames = np.random.default_rng(0).integers(
        0, 256, (args.batch, args.size, args.size, 3), dtype=np.uint8)
    det = FaceDetector(args.model, img_sizes=(args.size,), fuse_elan=True,
                       dtype=dtype, device="cuda")
    calls = capture(det, frames)
    want = [E.fused_elan(x, ws, shape) for x, ws, shape in calls]
    for name, ov in variants.items():
        use(ov)
        t0 = time.perf_counter()
        E.build()
        E.build_tma()
        print(f"{name}: build {time.perf_counter() - t0:.2f} s")
        for (x, ws, shape), ref in zip(calls, want):
            got = E.fused_elan(x, ws, shape)
            rel = float((got.float() - ref.float()).abs().max()
                        / ref.float().abs().max())
            if not rel < REL_TOL[dtype]:
                raise SystemExit(f"{name}: output differs from base by "
                                 f"{rel:.3g} of max |base|")
    names = list(variants)
    per = {n: [[] for _ in calls] for n in names}
    for r in range(args.rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        line = []
        for name in order:
            use(variants[name])
            for g, (x, ws, shape) in enumerate(calls):
                per[name][g].append(time_ms(
                    lambda: E.fused_elan(x, ws, shape)))
            line.append(f"{name} {sum(t[-1] for t in per[name]):.3f}")
        print(f"round {r}: " + ", ".join(line), flush=True)
    use({})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    tag = "" if dtype == torch.float32 else f" {args.dtype}"
    print(f"{args.model}{tag} b{args.batch}@{args.size}, {len(calls)} "
          f"groups, {args.rounds} rounds on {smi}:")
    for name in names:
        sums = [sum(t[r] for t in per[name]) for r in range(args.rounds)]
        print(f"  {name}: sum median {statistics.median(sums):.3f} ms, min "
              f"{min(sums):.3f}, max {max(sums):.3f}; per group "
              + " ".join(f"{statistics.median(t):.3f}" for t in per[name]))


if __name__ == "__main__":
    main()
