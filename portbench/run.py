"""The benchmark of face_detection_multi_scale_tpu_torch on one H100.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json: set-up (weights and inputs from the
seed, the gate from the reference, the program built and every input
served once), a closed-loop window of `--seconds`, the program's own
counters checked against the route and load the cell names, and every
judged output compared with the plain reference. The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` `breakdown`, and last
`checks`, each compared number beside its limit. Without a card it exits
with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every build and kernel cache inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".portbench_cache"
                                              / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".portbench_cache"
                                                  / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")

import torch  # noqa: E402

from portbench import compare, counts, harness  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "face_detection_multi_scale_tpu"}


def cell_metrics(manifest, cell, trace: bool):
    """The names of the metrics this cell reports in this kind of run."""
    name = cell["name"]

    def has(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in manifest["end_to_end"] if has(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in moved
                             else [])]


def read_metric(name: str, reading):
    spec = importlib.util.spec_from_file_location(
        "portbench_metric", ROOT / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(reading)


def window_flops(run, calls: int) -> float:
    return calls * counts.forward_flops(run.cfg, run.mix["batch"],
                                        run.mix["hw"])


def run_once(manifest, cell, seed: int, seconds: float, trace: bool,
             device, t_start: float = None):
    """One run; returns (result dict, fault lines)."""
    from portbench import trace as T

    t_start = time.perf_counter() if t_start is None else t_start
    run = harness.Run(cell, seed, device)
    run.setup()
    setup_s = time.perf_counter() - t_start
    on_card = run.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(run.device)
    if trace:
        spans = T.Spans().install()
        try:
            with T.profiler() as prof:
                w = run.window(seconds)
                harness.sync(run.device)
        finally:
            spans.remove()
    else:
        w = run.window(seconds)
    peak = torch.cuda.max_memory_allocated(run.device) if on_card else 0
    faults = run.route_checks(w)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(run.device) if on_card
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    metrics, extra = {}, {}
    wanted = cell_metrics(manifest, cell, trace)
    if trace:
        reading = T.Reading(prof, spans, w["window_s"])
        del prof
        reading.flops = window_flops(run, w["calls"])
        dev.update(busy_s=reading.busy_s, window_s=reading.window_s)
        for m in wanted:
            v = read_metric(m["name"], reading)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
            else:
                faults.append(f"per-layer metric {m['name']}: nothing to "
                              f"read in this cell")
        extra["breakdown"] = reading.breakdown()
        del reading
    else:
        e2e = run.end_to_end(w)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]} for m in wanted}
    run.det = None
    run.free()
    numbers = run.judge(w["kept"])
    correct, checks = compare.limit_checks(numbers, cell["limits"])
    result = {"correct": bool(correct and not faults),
              "attempted": w["calls"], "failed": len(faults),
              "metrics": metrics, "device": dev, **extra,
              "checks": checks}
    return result, faults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.load_cell(manifest, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, faults = run_once(manifest, cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_start=T_START)
    for line in faults:
        print("fault: " + line, file=sys.stderr)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"the process holds {loaded}: the benchmark measures the "
              f"PyTorch port alone", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
