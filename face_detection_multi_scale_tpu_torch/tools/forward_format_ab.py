"""Time the w6 forward in each memory format in which its input can reach
cuDNN, on one CUDA card.

    python -m face_detection_multi_scale_tpu_torch.tools.forward_format_ab \\
        --rounds 3

The float32 forward+decode (`FaceDetector.forward_input`, TF32 off) of
yolov7-w6-face at full width with seeded weights, at the shapes the port
serves: b8@640x640 (a serving request), b1@384x640 and b1@2176x3840 (the
TTA scales of a 1080x1920 frame), b8@2176x2176 (two frames' tiles of a
3840 scale tiled 2 x 2 with a 256 px halo). Each shape runs with its
input in each of
  nchw               NCHW-contiguous, as device preprocessing gives it;
  channels_last      an NHWC array permuted, as the host upload gives it:
                     the backbone runs channels_last, but the neck's 2x
                     upsample (repeat_interleave) returns NCHW-contiguous
                     memory, so the neck and the head run NCHW;
  channels_last_all  the same input with a 2x upsample that keeps the
                     format (F.interpolate nearest: the same values), so
                     every layer runs channels_last;
each with torch.backends.cudnn.benchmark off and on (measured only: the
port leaves it off). Each round times every cell in turn, in an order
that rotates from round to round, by CUDA events (the mean over the
shape's iterations). Every cell's decoded rows must lie within atol 5e-3
/ rtol 1e-3 of the nchw cell's with benchmark off. Prints one JSON line:
per cell the median over rounds, the rounds' times, ms per megapixel of
input, the first call's host-clock ms (cuDNN's search, with benchmark
on) and the peak memory; per cudnn.benchmark setting, the format that
is fastest on every shape, or null when the shapes disagree. With
--profile, one more nchw forward of each shape (cudnn.benchmark off) runs
under torch.profiler: its wall time, the device time summed over its
kernels, and the kernels that take the most device time.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import time

import torch
import torch.nn.functional as F

from face_detection_multi_scale_tpu_torch.infer.detector import FaceDetector
from face_detection_multi_scale_tpu_torch.models import layers as L

# (name, batch, height, width, iterations a round)
SHAPES = [("b8@640x640", 8, 640, 640, 5), ("b1@384x640", 1, 384, 640, 10),
          ("b1@2176x3840", 1, 2176, 3840, 2),
          ("b8@2176x2176", 8, 2176, 2176, 1)]
FORMATS = ("nchw", "channels_last", "channels_last_all")
ROW_TOL = dict(atol=5e-3, rtol=1e-3)


def upsample_keeping_format(x: torch.Tensor) -> torch.Tensor:
    """L.upsample2x_nearest's values in the input's memory format."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


@contextlib.contextmanager
def cell_setting(fmt: str, benchmark: bool):
    saved = torch.backends.cudnn.benchmark, L.upsample2x_nearest
    torch.backends.cudnn.benchmark = benchmark
    if fmt == "channels_last_all":
        L.upsample2x_nearest = upsample_keeping_format
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark, L.upsample2x_nearest = saved


def inputs(b, h, w, seed):
    """The same [0, 1) values as float32 NHWC views in both layouts:
    NCHW-contiguous memory, and NHWC-contiguous memory (channels_last
    once the network permutes it)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    nchw = torch.rand(b, 3, h, w, generator=gen, device="cuda")
    x = nchw.permute(0, 2, 3, 1)
    nhwc = x.contiguous()
    return {"nchw": x, "channels_last": nhwc, "channels_last_all": nhwc}


def time_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_profile(fn, top: int = 12):
    """One traced call of fn (after an untraced one): host-clock wall ms,
    device ms summed over the kernels, and the `top` kernels by device
    time as (name, ms, launches)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_time_total > 0), key=lambda k: -k[1])
    return {"wall_ms": wall, "kernel_ms": sum(k[1] for k in kernels),
            "top": [{"name": n[:120], "ms": ms, "launches": c}
                    for n, ms, c in kernels[:top]]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    det = FaceDetector("yolov7-w6-face", img_sizes=(640,), seed=0,
                       device="cuda")
    cells, profiles = [], {}
    for name, b, h, w, iters in SHAPES:
        xs = inputs(b, h, w, seed=0)
        keys = [(fmt, bench) for bench in (False, True) for fmt in FORMATS]
        found = {}
        ref = None
        for fmt, bench in keys:  # first calls: search, memory, agreement
            with cell_setting(fmt, bench):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                rows = det.forward_input(xs[fmt])
                torch.cuda.synchronize()
                first = (time.perf_counter() - t0) * 1e3
            if ref is None:
                ref = rows
            err = (rows - ref).abs()
            lim = ROW_TOL["atol"] + ROW_TOL["rtol"] * ref.abs()
            if not bool((err <= lim).all()):
                raise SystemExit(f"{name} {fmt} benchmark={bench}: rows "
                                 f"beyond {ROW_TOL} of the nchw forward")
            found[fmt, bench] = {
                "shape": name, "format": fmt, "cudnn_benchmark": bench,
                "first_ms": first, "max_abs_diff": float(err.max()),
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "ms_all": []}
            del rows
        del ref
        for r in range(args.rounds):
            for fmt, bench in keys[r % len(keys):] + keys[:r % len(keys)]:
                with cell_setting(fmt, bench):
                    found[fmt, bench]["ms_all"].append(time_ms(
                        lambda: det.forward_input(xs[fmt]), iters))
        for cell in found.values():
            cell["ms"] = statistics.median(cell["ms_all"])
            cell["ms_per_mp"] = cell["ms"] / (b * h * w / 1e6)
            cells.append(cell)
            print(f"{name} {cell['format']} cudnn.benchmark="
                  f"{cell['cudnn_benchmark']}: {cell['ms']:.3f} ms "
                  f"({cell['ms_per_mp']:.2f} ms/MP), first call "
                  f"{cell['first_ms']:.1f} ms, peak "
                  f"{cell['peak_gib']:.2f} GiB", flush=True)
        if args.profile:
            with cell_setting("nchw", False):
                prof = kernel_profile(lambda: det.forward_input(xs["nchw"]))
            profiles[name] = prof
            print(f"{name} nchw profile: wall {prof['wall_ms']:.3f} ms, "
                  f"kernels {prof['kernel_ms']:.3f} ms; "
                  + "; ".join(f"{k['name'][:60]} {k['ms']:.2f} ms x"
                              f"{k['launches']}" for k in prof["top"][:6]),
                  flush=True)
        del xs
        torch.cuda.empty_cache()
    fastest = {}
    for bench in (False, True):
        best = {c["shape"]: min((d for d in cells if d["shape"] == c["shape"]
                                 and d["cudnn_benchmark"] == bench),
                                key=lambda d: d["ms"])["format"]
                for c in cells}
        fastest[f"cudnn_benchmark={bench}"] = (
            next(iter(best.values())) if len(set(best.values())) == 1
            else None)
    print(json.dumps({"tool": "forward_format_ab", "card": card,
                      "device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "rounds": args.rounds,
                      "fastest_everywhere": fastest, "cells": cells,
                      "profiles": profiles}))


if __name__ == "__main__":
    main()
