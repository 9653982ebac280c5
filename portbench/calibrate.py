"""Readings for the limits of a cell's compared numbers, in one process:
the program as the configuration states it on `--seeds`, each a run of
`--seconds` at the cell's own load, then the control on `--control-seeds`:
the reference in the program's place with its convolutions in float8
e4m3 (`harness.Run.control_outputs`), over every input of the pool, then
on `--int8-seeds` the program's own W8A8 int8 path (calibrated on the
pool's first batch) over every input of the pool.

    python3 portbench/calibrate.py --workload w6-bulk-b32-640 \
        --seeds 1 2 3 --control-seeds 4 5 6 --int8-seeds 7 --seconds 3

One JSON line a run on standard output (and appended to `--out`): mode,
seed, the numbers, the faults of the route checks, the end-to-end
metrics. With `--write-limits`, the cell's `limits/<cell>.json` is
written from the program's and the control's readings (`limits_from`).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness, run as R  # noqa: E402


def control_numbers(cell, seed: int, device) -> dict:
    """The cell's numbers for the control at `seed`: the gate and inputs
    of a run, the float8 reference's outputs judged as the program's."""
    run = harness.Run(cell, seed, device)
    run.make_inputs()
    run.set_gate(run.reference())
    run.free()
    return run.judge(run.control_outputs())


def int8_numbers(cell, seed: int, device) -> dict:
    """The cell's numbers for the program's int8 path at `seed`."""
    from face_detection_multi_scale_tpu_torch.infer.detector import (
        FaceDetector)
    from face_detection_multi_scale_tpu_torch.ops.nms import (
        detections_to_numpy)

    run = harness.Run(cell, seed, device)
    run.make_inputs()
    run.set_gate(run.reference())
    run.free()
    det = FaceDetector(cell["cfg"]["model"], variables=run.weights,
                       conf_thres=run.gate, iou_thres=run.iou,
                       dtype=torch.bfloat16, max_det=run.max_det,
                       max_candidates=run.max_cand, device=run.device,
                       quantize="int8", calib_images=run.pool[0])
    kept = []
    for idx in range(len(run.pool)):
        dets = det.run_network(run.pool[idx])
        kept.append((idx, detections_to_numpy(dets),
                     dets.n_gated.cpu().numpy()))
    del det, dets
    run.free()
    return run.judge(kept)


# the numbers a limit may hold, when the control separates them; box_gap
# (px) is box_rel_gap's in absolute terms and is not held
COMPARED = ("conf_gap", "box_rel_gap", "kpt_gap", "n_gated_gap", "keep_gap")
SEPARATION = 3.0   # the least upper / lower reading of a compared number
ROOM = 0.6         # the limit: lower x (upper / lower) ** ROOM


def limits_from(lines) -> dict:
    """A cell's limits from its readings: for each number in COMPARED, the
    lower reading is the largest of the program's seeds and the upper the
    smallest of the control's; a number is held where upper is SEPARATION
    times lower or more, at lower x (upper / lower) ** ROOM (upper / 4
    where the program read 0), to 3 figures; `keep_overlaps` and
    `empty_answers` are exact."""
    prog = [ln["numbers"] for ln in lines if ln["mode"] == "program"]
    ctrl = [ln["numbers"] for ln in lines if ln["mode"] == "control"]
    out = {}
    for k in COMPARED:
        if not prog or not ctrl or k not in prog[0]:
            continue
        lower = max(n[k] for n in prog)
        upper = min(n[k] for n in ctrl)
        if upper <= 0 or upper < SEPARATION * lower:
            continue
        limit = (lower * (upper / lower) ** ROOM if lower > 0
                 else upper / 4)
        out[k] = {"limit": float(f"{limit:.3g}"), "lower": lower,
                  "upper": upper, "program_seeds": len(prog),
                  "control_seeds": len(ctrl)}
    out["keep_overlaps"] = {"limit": 0}
    out["empty_answers"] = {"limit": 0}
    return out


def readings(workload: str, seeds, control_seeds, seconds: float,
             device="cuda", trace: bool = False, out=None, int8_seeds=()):
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.load_cell(manifest, workload)
    cell["limits"] = None  # every number, not only the compared ones
    lines = []
    other = {"control": control_numbers, "int8": int8_numbers}
    for mode, seed_list in (("program", seeds), ("control", control_seeds),
                            ("int8", int8_seeds)):
        for seed in seed_list:
            if mode in other:
                line = {"workload": workload, "mode": mode, "seed": seed,
                        "numbers": other[mode](cell, seed, device)}
            else:
                res, faults = R.run_once(manifest, cell, seed, seconds,
                                         trace, device)
                line = {"workload": workload, "mode": mode, "seed": seed,
                        "numbers": {k: c["value"]
                                    for k, c in res["checks"].items()},
                        "faults": faults, "metrics": res["metrics"],
                        "device": res["device"],
                        "attempted": res["attempted"]}
                if "breakdown" in res:
                    line["breakdown"] = res["breakdown"]
            print(json.dumps(line), flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(json.dumps(line) + "\n")
            lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--int8-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--write-limits", action="store_true")
    args = ap.parse_args(argv)
    lines = readings(args.workload, args.seeds, args.control_seeds,
                     args.seconds, trace=bool(args.trace), out=args.out,
                     int8_seeds=args.int8_seeds)
    if args.write_limits:
        path = harness.ROOT / "limits" / f"{args.workload}.json"
        path.write_text(json.dumps(limits_from(lines), indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
