"""Matmul-layout probe on the card's tensor cores: the hand-written kernel,
its plain version, and the command-line tool.

    python -m face_detection_multi_scale_tpu_torch.tools.probe_mm \\
        [--cells 512] [--iters 6] [--variants pre2d,flat,taps,cat9] [--cpu]

The counterpart of the JAX package's tools/probe_mosaic_mm.py, whose Pallas
kernel `kern` this module's CUDA kernel (csrc/probe_mm.cu, built at first
use by ops/cuda_build.py, bound with ctypes) replaces. It times the inner
strip products of the fused-ELAN kernel at the geometry of a deep group:
bf16 strips x (36, 176, 128) = x2 (6336, 128) against w (128, 64), f32
accumulation, over a grid of `cells` blocks that all do the same work:
  pre2d  x2 @ w, the product on rows already 2-D
  flat   the same product, rows addressed as (r, c) over the same bytes
  taps   the sum over the 9 taps (dy, dx) of x[dy:dy+34, dx:dx+174] @ w
  cat9   the 9 shifted windows side by side along K (1152), times w9
Each cell's output row is the column sum of its product, (cells, 64) f32.
Inputs are the JAX tool's: RandomState(0) normals x 0.1, cast to bf16.

Per variant the tool prints one JSON line and appends it to PROBE_MM.json
beside this file (gitignored): the JAX tool's keys (variant, cells,
us_per_cell, total_ms; kernel time by CUDA events) plus the plain
version's and the library yardstick's times, the bound, and the kernel's
difference from the plain version. Unlike the JAX tool, which logs a
variant's exception and goes on, this one stops with a non-zero exit on
any error or on a difference above REL_TOL.

It runs on the card unless given --cpu; on CPU tensors the wrapper runs
the plain version, so a --cpu run times that.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from face_detection_multi_scale_tpu_torch.ops import cuda_build

R, C, K, N = 36, 176, 128, 64
RQ, CQ = R - 2, C - 2  # the tap window
TAPS = [(dy, dx) for dy in range(3) for dx in range(3)]
VARIANTS = ("pre2d", "flat", "taps", "cat9")
SOURCE = cuda_build.CSRC / "probe_mm.cu"
NVCC_FLAGS = cuda_build.BASE_FLAGS
OUT = Path(__file__).parent / "PROBE_MM.json"
# float32 sums over 6k-54k rows taken in another order: the kernel must be
# within this share of max |plain| of the plain version
REL_TOL = 1e-4
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12


def make_inputs(device="cuda"):
    """(x, x2, w, w9) in bf16 on `device`, drawn as the JAX tool draws them."""
    rng = np.random.RandomState(0)
    x, w, w9 = (torch.from_numpy(rng.randn(*shape) * 0.1).to(torch.bfloat16)
                for shape in ((R, C, K), (K, N), (9 * K, N)))
    x, w, w9 = (t.to(device) for t in (x, w, w9))
    return x, x.reshape(R * C, K), w, w9


def _windows(xf: torch.Tensor):
    """The 9 shifted (RQ * CQ, K) windows, dy-major then dx."""
    return [xf[dy:dy + RQ, dx:dx + CQ].reshape(RQ * CQ, K)
            for dy, dx in TAPS]


def probe_mm_plain(variant: str, x, x2, w, w9, cells: int) -> torch.Tensor:
    """Plain PyTorch probe: the bf16 inputs upcast to float32 (exactly),
    torch.matmul, a float32 column sum, repeated to (cells, N)."""
    xf, wf = x.float(), w.float()
    if variant == "pre2d":
        y = x2.float() @ wf
    elif variant == "flat":
        y = xf.reshape(R * C, K) @ wf
    elif variant == "taps":
        y = sum(t @ wf for t in _windows(xf))
    elif variant == "cat9":
        y = torch.cat(_windows(xf), dim=1) @ w9.float()
    else:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    return y.sum(0).repeat(cells, 1)


def build():
    """Compile csrc/probe_mm.cu (once per source and flags); returns the
    shared library's path."""
    return cuda_build.build(SOURCE, NVCC_FLAGS)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.fdms_probe_mm.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.fdms_probe_mm.restype = ctypes.c_int
    return lib


def probe_mm(variant: str, x, x2, w, w9, cells: int) -> torch.Tensor:
    """The probe: (cells, N) float32, each row the column sum of the
    variant's product. x (R, C, K), x2 (R*C, K), w (K, N), w9 (9K, N), all
    bf16 and contiguous on one device. CPU tensors: the plain version.
    CUDA tensors: one launch of the kernel over `cells` blocks, counted in
    `probe_mm.launches`."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    tensors = {"x": x, "x2": x2, "w": w, "w9": w9}
    for (name, t), shape in zip(tensors.items(), (
            (R, C, K), (R * C, K), (K, N), (9 * K, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if not 0 <= cells < 2 ** 31:
        raise ValueError(f"cells must be in [0, 2**31), got {cells}")
    if x.device.type == "cpu":
        return probe_mm_plain(variant, x, x2, w, w9, cells)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty((cells, N), dtype=torch.float32, device=x.device)
    if cells == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().fdms_probe_mm(
        VARIANTS.index(variant), x.data_ptr(), x2.data_ptr(), w.data_ptr(),
        w9.data_ptr(), out.data_ptr(), cells, x.device.index, stream)
    if err != 0:
        raise RuntimeError(f"probe_mm ({variant}) kernel launch failed: "
                           f"CUDA error {err}")
    probe_mm.launches += 1
    return out


probe_mm.launches = 0


def library_call(variant: str, x, x2, w, w9, cells: int):
    """A zero-argument callable computing the probe with one PyTorch call
    and the column sum, on `cells` copies of the input made here, outside
    what it times: torch.matmul for pre2d/flat, a bf16 3x3 F.conv2d
    (weights from w or w9) for taps/cat9. A yardstick only: the port never
    calls it."""
    if variant in ("pre2d", "flat"):
        a = x2.repeat(cells, 1)
        return lambda: torch.matmul(a, w).view(cells, R * C, N).sum(
            1, dtype=torch.float32)
    weight = (w.t().reshape(N, K, 1, 1).expand(N, K, 3, 3)
              if variant == "taps" else
              w9.reshape(3, 3, K, N).permute(3, 2, 0, 1))
    weight = weight.contiguous(memory_format=torch.channels_last)
    inp = x.permute(2, 0, 1)[None].expand(cells, K, R, C).contiguous(
        memory_format=torch.channels_last)
    return lambda: F.conv2d(inp, weight).sum((2, 3), dtype=torch.float32)


def cost(variant: str, cells: int):
    """(FLOPs, bytes) the probe must do and move: 2 FLOPs a multiply-add of
    every row's product; the A source, the weight and the output once."""
    taps = variant in ("taps", "cat9")
    flops = cells * 2 * (RQ * CQ if taps else R * C) * K * N * (9 if taps
                                                                 else 1)
    nbytes = 2 * R * C * K + 2 * K * N * (9 if variant == "cat9" else 1) \
        + 4 * cells * N
    return flops, nbytes


def time_ms(fn, iters: int, device: torch.device) -> float:
    """Mean milliseconds of fn() over `iters` runs after one warm-up run:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def measure(variant: str, cells: int, iters: int, inputs) -> dict:
    """One variant: the kernel once against the plain version, then the
    kernel's, the plain version's and the library call's times, and the
    bound. Raises when the kernel is further than REL_TOL from plain."""
    device = inputs[0].device
    got = probe_mm(variant, *inputs, cells)
    want = probe_mm_plain(variant, *inputs, cells)
    diff = float((got - want).abs().max()) if cells else 0.0
    rel = diff / float(want.abs().max()) if cells else 0.0
    if not rel <= REL_TOL:
        raise SystemExit(f"probe_mm[{variant}] differs from its plain "
                         f"version by {rel:.3g} of max |plain| (limit "
                         f"{REL_TOL})")
    ms = time_ms(lambda: probe_mm(variant, *inputs, cells), iters, device)
    plain_ms = time_ms(lambda: probe_mm_plain(variant, *inputs, cells),
                       iters, device)
    library_ms = time_ms(library_call(variant, *inputs, cells), iters,
                         device)
    flops, nbytes = cost(variant, cells)
    t_ops = flops / BF16_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"variant": variant, "cells": cells,
            "us_per_cell": ms / max(cells, 1) * 1e3, "total_ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_diff": diff, "rel_diff": rel,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=512)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain version)")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --cpu to run "
                         "on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")
    inputs = make_inputs(device)

    def emit(row):
        print(json.dumps(row), flush=True)
        with OUT.open("a") as fh:
            fh.write(json.dumps(row) + "\n")

    run = {"section": "run", "argv": sys.argv[1:] if argv is None
           else list(argv), "at": time.strftime("%Y-%m-%dT%H:%M:%S")}
    if device.type == "cuda":
        run["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    emit(run)
    for variant in args.variants.split(","):
        emit(measure(variant, args.cells, args.iters, inputs))


if __name__ == "__main__":
    main()
