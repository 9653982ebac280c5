"""Time variants of the probe kernel's source against each other, on one
CUDA card.

    python -m face_detection_multi_scale_tpu_torch.tools.probe_mm_ab \\
        --cells 512 --rounds 3 base 'cp.async.ca.=>cp.async.cg.'

A variant is "base" (csrc/probe_mm.cu as it stands) or OLD=>NEW, the
source with every occurrence of the text OLD (at least one) replaced by
NEW, written beside the build outputs and built like the base. Each round
times every source on every probe variant, in an order that rotates from
round to round, by CUDA events (tools/probe_mm.time_ms); each source is
first held within REL_TOL of the plain version, and its cp.async bytes a
cell are counted on the card (tools/probe_mm.count_staged). Prints one
JSON line per source and probe variant: the median, min and max of its
times, and the bytes it staged a cell.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from face_detection_multi_scale_tpu_torch.ops import cuda_build
from face_detection_multi_scale_tpu_torch.tools import probe_mm as PM


def source_for(variant: str, i: int):
    """The source file of `variant` ("base" or OLD=>NEW)."""
    return cuda_build.variant_source(PM.SOURCE, variant, f"probe_mm_ab{i}")


def use(source) -> None:
    """Point the probe's wrapper at `source`'s library."""
    PM.SOURCE = source
    PM._library.cache_clear()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=512)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--variants", default=",".join(PM.VARIANTS))
    ap.add_argument("sources", nargs="+")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"section": "run", "card": card, "argv": vars(args)}),
          flush=True)
    inputs = PM.make_inputs("cuda")
    probes = args.variants.split(",")
    sources = [source_for(v, i) for i, v in enumerate(args.sources)]
    staged, times = {}, {}
    for src, name in zip(sources, args.sources):
        use(src)
        for v in probes:
            out, staged[name, v] = PM.count_staged(v, *inputs, args.cells)
            want = PM.probe_mm_plain(v, *inputs, args.cells)
            for got in (out, PM.probe_mm(v, *inputs, args.cells)):
                rel = float((got - want).abs().max() / want.abs().max())
                if not rel <= PM.REL_TOL:
                    raise SystemExit(f"{name} {v}: {rel:.3g} of max |plain|")
            times[name, v] = []
    for r in range(args.rounds):
        k = r % len(sources)
        for src, name in list(zip(sources, args.sources))[k:] + list(
                zip(sources, args.sources))[:k]:
            use(src)
            for v in probes:
                times[name, v].append(PM.time_ms(
                    lambda: PM.probe_mm(v, *inputs, args.cells),
                    args.iters, inputs[0].device))
    for (name, v), ts in times.items():
        print(json.dumps({"source": name, "variant": v, "cells": args.cells,
                          "median_ms": statistics.median(ts),
                          "min_ms": min(ts), "max_ms": max(ts), "ms": ts,
                          "staged_bytes": staged[name, v], "card": card}),
              flush=True)


if __name__ == "__main__":
    main()
