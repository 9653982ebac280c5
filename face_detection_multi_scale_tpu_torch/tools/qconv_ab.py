"""Time variants of the int8 conv kernel's source against each other on the
convs of int8 forwards, on one CUDA card.

    python -m face_detection_multi_scale_tpu_torch.tools.qconv_ab \\
        --rounds 2 --table base \\
        'kBN = 64;=>kBN = 128; && kThreads = 128;=>kThreads = 256;'

A variant is "base" (csrc/qconv.cu as it stands) or one or more OLD=>NEW
replacements joined by " && ", each applied to every occurrence of its
text (ops/cuda_build.variant_source). The convs are those of one int8
forward of each model (`--models`) at b8@640: seeded weights, noise frames
that also calibrate it, every qconv call captured with its own inputs.
Every source's output of every conv must equal the base's bit for bit
(the same arithmetic). Each round times every source on every conv by
CUDA events, in an order that rotates from round to round. Prints one
JSON line per model and source (the median, min and max over rounds of
the ms summed over the convs) and, with --table, one per conv of the
first model: its shapes, int8 operations and median ms per source.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from face_detection_multi_scale_tpu_torch.infer.detector import FaceDetector
from face_detection_multi_scale_tpu_torch.models import quant
from face_detection_multi_scale_tpu_torch.ops import cuda_build
from face_detection_multi_scale_tpu_torch.ops import qconv_kernel as QK

MODELS = "yolov7-w6-face,yolov7-tiny-face,yolov7-lite-t"


def source_for(variant: str, i: int):
    """The source file of `variant` ("base" or OLD=>NEW && ...)."""
    src = QK.SOURCE
    for j, part in enumerate(variant.split(" && ")):
        src = cuda_build.variant_source(src, part, f"qconv_ab{i}_{j}")
    return src


def use(source) -> None:
    """Point the conv's wrapper at `source`'s library."""
    QK.SOURCE = source
    QK._library.cache_clear()


def captured_convs(name: str, batch: int, size: int, seed: int = 0):
    """Each qconv call's arguments in one int8 forward of `name`."""
    frames = np.random.default_rng(seed).integers(
        0, 256, (batch, size, size, 3), dtype=np.uint8)
    det = FaceDetector(name, img_sizes=(size,), seed=seed, quantize="int8",
                       calib_images=frames, device="cuda")
    calls = []
    real = quant.qconv
    quant.qconv = lambda *a, **kw: calls.append((a, kw)) or real(*a, **kw)
    try:
        det.forward_rows(frames)
    finally:
        quant.qconv = real
    return calls


def event_ms(fn, iters: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default=MODELS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--table", action="store_true")
    ap.add_argument("sources", nargs="+")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"section": "run", "card": card, "argv": vars(args)}),
          flush=True)
    sources = [source_for(v, i) for i, v in enumerate(args.sources)]
    for mi, name in enumerate(args.models.split(",")):
        calls = captured_convs(name, args.batch, args.size)
        want = [None] * len(calls)
        per = {v: [[] for _ in calls] for v in args.sources}
        for r in range(args.rounds):
            k = r % len(sources)
            order = list(zip(sources, args.sources))
            for src, v in order[k:] + order[:k]:
                use(src)
                for c, (a, kw) in enumerate(calls):
                    if r == 0:  # the base runs first in round 0
                        got = QK.qconv(*a, **kw)
                        if want[c] is None:
                            want[c] = got
                        elif not torch.equal(got, want[c]):
                            raise SystemExit(f"{v}: conv {c} differs from "
                                             f"{args.sources[0]}")
                    per[v][c].append(event_ms(lambda: QK.qconv(*a, **kw),
                                              args.iters))
        for v in args.sources:
            sums = [sum(t[r] for t in per[v]) for r in range(args.rounds)]
            print(json.dumps({"model": name, "source": v,
                              "convs": len(calls), "batch": args.batch,
                              "size": args.size,
                              "median_ms": statistics.median(sums),
                              "min_ms": min(sums), "max_ms": max(sums),
                              "card": card}), flush=True)
        if args.table and mi == 0:
            for c, (a, kw) in enumerate(calls):
                print(json.dumps({
                    "model": name, "conv": c, "x": list(a[0].shape),
                    "w": list(a[1].shape), "stride": kw["stride"],
                    "groups": kw["groups"],
                    "ops": 2 * want[c].numel() * a[1][0].numel(),
                    "ms": {v: statistics.median(per[v][c])
                           for v in args.sources}}), flush=True)
        del calls
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
