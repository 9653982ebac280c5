"""Time variants of the fixpoint keep-mask kernel's source against each
other, on one CUDA card.

    python -m face_detection_multi_scale_tpu_torch.tools.nms_sweep_ab \\
        --rounds 2 --clusters 8,16 base \\
        'kFixThreads = 512;=>kFixThreads = 1024;'

A variant is "base" (csrc/nms_keep.cu as it stands) or OLD=>NEW, the
source with every occurrence of the text OLD replaced by NEW
(ops/cuda_build.variant_source). On each case (CASES: synthetic
candidates as chip_smoke.py makes them, and the alternating chains of
tests/test_torch_gpu.py) pass 1 runs once into the scratch; then each
round times the sweep kernel of every source at every cluster size
through the launch helper (which counts nothing), by CUDA events, in an
order that rotates from round to round. Every launch's keep mask and
sweep counts must equal the plain version's. Prints one JSON line per
case, source and cluster size: the median, min and max of its times, the
largest sweep count, and pass 1's time.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from face_detection_multi_scale_tpu_torch.ops import cuda_build
from face_detection_multi_scale_tpu_torch.ops import nms_kernel as K

# (name, B, K, valid share or "chain", seed, iterations)
CASES = [("b8k4096", 8, 4096, 1.0, 7, 20), ("b16k4096", 16, 4096, 1.0, 7, 20),
         ("b2k16384", 2, 16384, 0.8, 9, 10), ("b64k1024", 64, 1024, 1.0, 3, 20),
         ("chain1x4097", 1, 4097, "chain", 0, 2),
         ("chain2x200", 2, 200, "chain", 0, 10)]
THR = 0.5


def case_inputs(b, k, frac, seed):
    """Score-sorted boxes (B, K, 4) and valid (B, K) on the card: uniform
    boxes 5-150 px wide over 600 px, the first `frac` of each image valid;
    or, for "chain", boxes 10 wide and 3 apart, each overlapping the next
    by IoU 7/13 (the keep mask alternates, K sweeps)."""
    if frac == "chain":
        x = torch.arange(k, dtype=torch.float32) * 3
        one = torch.stack([x, torch.zeros(k), x + 10,
                           torch.full((k,), 10.)], 1)
        return (one.expand(b, k, 4).contiguous().cuda(),
                torch.ones(b, k, dtype=torch.bool, device="cuda"))
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 600, (b, k, 2)).astype(np.float32)
    wh = rng.uniform(5, 150, (b, k, 2)).astype(np.float32)
    valid = np.zeros((b, k), bool)
    valid[:, :int(k * frac)] = True
    return (torch.from_numpy(np.concatenate([xy, xy + wh], -1)).cuda(),
            torch.from_numpy(valid).cuda())


def time_ms(fn, iters: int) -> float:
    """Mean ms of fn() over `iters` runs by CUDA events, after 2 warm-ups."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def use(source) -> None:
    """Point the keep-mask wrapper at `source`'s library."""
    K.SOURCE = source
    K._library.cache_clear()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--clusters", default="8,16")
    ap.add_argument("--cases", default=",".join(c[0] for c in CASES))
    ap.add_argument("sources", nargs="+")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"section": "run", "card": card, "argv": vars(args)}),
          flush=True)
    clusters = [int(c) for c in args.clusters.split(",")]
    sources = [(name, cuda_build.variant_source(K.SOURCE, name,
                                                f"nms_sweep_ab{i}"))
               for i, name in enumerate(args.sources)]
    for src_name, src in sources:  # build each before any timing
        use(src)
        K.build()
    for name, b, k, frac, seed, iters in CASES:
        if name not in args.cases.split(","):
            continue
        boxes, valid = case_inputs(b, k, frac, seed)
        want = K.nms_keep_plain(boxes, valid, THR)
        want_sweeps = K.fixpoint_sweeps_plain(boxes, valid, THR)
        mask = torch.empty(K.mask_words(b, k), dtype=torch.int64,
                           device="cuda")
        keep = torch.empty_like(valid)
        sweeps = torch.empty(b, dtype=torch.int32, device="cuda")
        pass1 = time_ms(lambda: K.launch_mask(boxes, valid, THR, mask), iters)
        times = {(s, c): [] for s, _ in sources for c in clusters}
        for r in range(args.rounds):
            order = sources[r % len(sources):] + sources[:r % len(sources)]
            for src_name, src in order:
                use(src)
                for c in clusters:
                    keep.zero_()
                    sweeps.zero_()
                    times[src_name, c].append(time_ms(
                        lambda: K.launch_sweeps(mask, valid, keep, sweeps,
                                                c), iters))
                    if not (torch.equal(keep, want)
                            and torch.equal(sweeps, want_sweeps)):
                        raise SystemExit(f"{src_name} in clusters of {c} "
                                         f"differs from plain on {name}")
        for (src_name, c), ts in times.items():
            print(json.dumps({
                "case": name, "source": src_name, "cluster": c,
                "median_ms": statistics.median(ts), "min_ms": min(ts),
                "max_ms": max(ts), "ms": ts,
                "sweeps_max": int(want_sweeps.max()), "pass1_ms": pass1,
                "card": card}), flush=True)


if __name__ == "__main__":
    main()
