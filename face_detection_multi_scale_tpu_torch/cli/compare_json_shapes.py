"""Regression diff of two production-JSON output directories by frame
count.

    python -m face_detection_multi_scale_tpu_torch.cli.compare_json_shapes \
        DIR_A DIR_B [--report comparison_report.txt]

The port's counterpart of the JAX package's cli/compare_json_shapes.py
(the reference compare_json_shapes.py), over
`infer/production.compare_json_shapes`. Host-only: it reads JSON files
and runs no model, so it takes no `--device`. Exits 1 on a mismatch."""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dir_a")
    ap.add_argument("dir_b")
    ap.add_argument("--report", default="comparison_report.txt")
    args = ap.parse_args(argv)

    from face_detection_multi_scale_tpu_torch.infer.production import (
        compare_json_shapes)

    r = compare_json_shapes(args.dir_a, args.dir_b)
    lines = [
        f"dir A: {args.dir_a} ({r['total_a']} files)",
        f"dir B: {args.dir_b} ({r['total_b']} files)",
        f"common: {r['common']}  match: {r['match']}  "
        f"mismatch: {len(r['mismatches'])}",
        f"only in A: {len(r['only_a'])}",
        f"only in B: {len(r['only_b'])}",
    ]
    for name, a, b in r["mismatches"]:
        lines.append(f"MISMATCH {name}: {a} vs {b} frames")
    report = "\n".join(lines)
    print(report)
    with open(args.report, "w") as f:
        f.write(report + "\n")
    return 0 if not r["mismatches"] else 1


if __name__ == "__main__":
    sys.exit(main())
