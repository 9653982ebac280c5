"""Time variants of the int8 conv kernel against each other on the convs of
int8 forwards, on one CUDA card.

    python -m face_detection_multi_scale_tpu_torch.tools.qconv_ab \\
        --rounds 2 --table base 'kStages = 4;=>kStages = 3;' \\
        'py:SPLIT_MAX=1' --baseline chip_archive/parent

A variant is "base" (csrc/qconv.cu and ops/qconv_kernel.py as they stand),
or one or more parts joined by " && ": OLD=>NEW replaces every occurrence
of the text OLD in the source (ops/cuda_build.variant_source: the tile,
stage or cluster constants), py:NAME=VALUE sets a plan constant of
ops/qconv_kernel.py for that variant (PLAN_CONSTANTS below: the split's,
and the route rule's WGMMA_MIN_K; py:WGMMA_MIN_K=0 keeps every conv that
TMA takes on the wgmma route). A variant prefixed "diag:" may compute
something else (say, an epilogue cut out to see what it costs): it is
timed but never compared. `--baseline DIR` (repeatable) adds the wrapper
and source of another checkout of the repo (DIR/face_detection_multi_
scale_tpu_torch/ops/qconv_kernel.py with DIR's csrc/qconv.cu), so an
earlier kernel is timed in the same run. The convs are those of one int8
forward of each model (`--models`) at b8@640: seeded weights, noise frames that also calibrate
it, every qconv call captured with its own inputs. Every variant's output
of every conv must equal the base's bit for bit (the same arithmetic).
Each round times every variant on every conv by CUDA events over `iters`
launches (host launch gaps included) and by replaying a CUDA graph of
them (device time), in an order that rotates from round to round, and
the wrapper's host time a conv (the median of 5 passes over the convs
without a synchronize). Prints one JSON line per model and variant
(medians, min and max over rounds of the sums over the convs) and, with
--table, one per conv of every model: its shapes, the first variant's
route, tile and split, int8 operations, and median ms, device ms and TOPS
per variant.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from face_detection_multi_scale_tpu_torch.infer.detector import FaceDetector
from face_detection_multi_scale_tpu_torch.models import quant
from face_detection_multi_scale_tpu_torch.ops import cuda_build
from face_detection_multi_scale_tpu_torch.ops import qconv_kernel as QK

MODELS = "yolov7-w6-face,yolov7-tiny-face,yolov7-lite-t"
PLAN_CONSTANTS = ("SPLIT_MAX", "SPLIT_MIN_STEPS", "SPLIT_REDUCE_STEPS",
                  "WGMMA_MIN_K")
DEFAULTS = {name: getattr(QK, name) for name in PLAN_CONSTANTS}


class Variant:
    """One kernel to time: `qconv` is its wrapper; `activate` points the
    port's wrapper at its source and plan constants."""

    def __init__(self, label: str, i: int):
        self.label, self.qconv = label, QK.qconv
        self.source, self.consts = QK.SOURCE, dict(DEFAULTS)
        # a diagnostic variant may compute something else: never compared
        self.diagnostic = label.startswith("diag:")
        parts = label[len("diag:"):] if self.diagnostic else label
        if parts == "base":
            return
        for j, part in enumerate(parts.split(" && ")):
            if part.startswith("py:"):
                name, value = part[3:].split("=", 1)
                if name not in PLAN_CONSTANTS:
                    raise SystemExit(f"no plan constant {name!r}")
                self.consts[name] = int(value)
            else:
                self.source = cuda_build.variant_source(
                    self.source, part, f"qconv_ab{i}_{j}")

    def activate(self) -> None:
        QK.SOURCE = self.source
        QK._library.cache_clear()
        for name, value in self.consts.items():
            setattr(QK, name, value)
        QK.reset_plans()


class Baseline(Variant):
    """The wrapper and source of another checkout, loaded by path."""

    def __init__(self, root: str):
        root = Path(root).resolve()
        pkg = root / "face_detection_multi_scale_tpu_torch"
        spec = importlib.util.spec_from_file_location(
            "qconv_kernel_baseline", pkg / "ops" / "qconv_kernel.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod  # its dataclasses look themselves up
        spec.loader.exec_module(mod)
        mod.SOURCE = pkg / "csrc" / "qconv.cu"
        self.label, self.qconv = f"baseline {root.name}", mod.qconv
        self.source, self.consts = QK.SOURCE, dict(DEFAULTS)
        self.diagnostic = False


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


def graph_ms(fn, iters: int) -> float:
    """Mean device milliseconds of fn() over `iters` launches replayed
    from one CUDA graph (no host launch gaps between them), after a warm-up
    run on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def host_us(fn, calls, passes: int = 5) -> float:
    """Host microseconds a conv: the median over `passes` passes over
    `calls` without a synchronize (the host's clock is noisy)."""
    times = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a, kw in calls:
            fn(*a, **kw)
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(times) / len(calls) * 1e6


def plan_of(a, kw) -> QK.QconvPlan:
    return QK.plan_for(a[0], a[1], kw["stride"], kw["pads"], kw["groups"])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default=MODELS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--table", action="store_true")
    ap.add_argument("--baseline", action="append", default=[],
                    help="root of another checkout to time beside "
                         "(repeatable)")
    ap.add_argument("sources", nargs="+")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"section": "run", "card": card, "argv": vars(args)}),
          flush=True)
    variants = [Variant(v, i) for i, v in enumerate(args.sources)]
    variants += [Baseline(root) for root in args.baseline]
    for name in args.models.split(","):
        variants[0].activate()
        calls = captured_convs(name, args.batch, args.size)
        want = [None] * len(calls)
        per = {v.label: {"ms": [[] for _ in calls],
                         "dev": [[] for _ in calls], "host": []}
               for v in variants}
        for r in range(args.rounds):
            k = r % len(variants)
            for v in variants[k:] + variants[:k]:
                v.activate()
                t = per[v.label]
                for c, (a, kw) in enumerate(calls):
                    if r == 0:  # the base runs first in round 0
                        got = v.qconv(*a, **kw)
                        if want[c] is None:
                            want[c] = got
                        elif not v.diagnostic and not torch.equal(
                                got, want[c]):
                            raise SystemExit(f"{v.label}: conv {c} differs "
                                             f"from {variants[0].label}")
                    t["ms"][c].append(event_ms(
                        lambda: v.qconv(*a, **kw), args.iters))
                    t["dev"][c].append(graph_ms(
                        lambda: v.qconv(*a, **kw), args.iters))
                t["host"].append(host_us(v.qconv, calls))
        for v in variants:
            t = per[v.label]
            row = {"model": name, "source": v.label,
                   "diagnostic": v.diagnostic, "convs": len(calls),
                   "batch": args.batch, "size": args.size, "card": card,
                   "host_us_per_conv": statistics.median(t["host"])}
            for key in ("ms", "dev"):
                sums = [sum(c[r] for c in t[key])
                        for r in range(args.rounds)]
                label = "ms" if key == "ms" else "device_ms"
                row.update({f"median_{label}": statistics.median(sums),
                            f"min_{label}": min(sums),
                            f"max_{label}": max(sums)})
            print(json.dumps(row), flush=True)
        if args.table:
            variants[0].activate()
            for c, (a, kw) in enumerate(calls):
                plan = plan_of(a, kw)
                ops = 2 * want[c].numel() * a[1][0].numel()
                dev = {v.label: statistics.median(per[v.label]["dev"][c])
                       for v in variants}
                print(json.dumps({
                    "model": name, "conv": c, "x": list(a[0].shape),
                    "w": list(a[1].shape), "stride": kw["stride"],
                    "groups": kw["groups"], "route": plan.route,
                    "tile": [plan.bm, plan.bn, plan.bk],
                    "split": plan.split, "k_steps": plan.k_steps,
                    "ops": ops,
                    "ms": {v.label: statistics.median(per[v.label]["ms"][c])
                           for v in variants},
                    "device_ms": dev,
                    "tops": {k: ops / d / 1e9 for k, d in dev.items()}}),
                    flush=True)
        del calls
        torch.cuda.empty_cache()
    variants[0].activate()


if __name__ == "__main__":
    main()
