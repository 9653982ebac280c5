"""Scan for interrupted training runs and resume them.

    python -m face_detection_multi_scale_tpu_torch.cli.resume_runs \
        [--root runs/train] [--dry-run]

The port's counterpart of the JAX package's cli/resume_runs.py (the
reference utils/aws/resume.py:14-37: find every **/last checkpoint and
relaunch its training command). A run is interrupted when its
`weights/last.meta.json` epoch is short of its `opt.json` epochs; the
relaunch is `python -m face_detection_multi_scale_tpu_torch.cli.train
--resume` with the run's project, name and the JAX CLI's keys, plus the
run's own `--device`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
from pathlib import Path

# opt.json keys carried into the relaunch, the JAX CLI's
RESUME_KEYS = ("model", "data", "hyp", "epochs", "batch_size", "img_size",
               "kpt_label")


def find_interrupted(root: str):
    """Runs with a `last` checkpoint whose opt.json epochs exceed the
    checkpointed epoch: (run_dir, epochs done, epochs wanted, opt)."""
    out = []
    for meta_path in glob.glob(os.path.join(root, "**", "weights",
                                            "last.meta.json"),
                               recursive=True):
        run_dir = Path(meta_path).parent.parent
        opt_path = run_dir / "opt.json"
        if not opt_path.exists():
            continue
        with open(meta_path) as f:
            meta = json.load(f)
        with open(opt_path) as f:
            opt = json.load(f)
        done = int(meta.get("epoch", -1)) + 1
        want = int(opt.get("epochs", 0))
        if done < want:
            out.append((str(run_dir), done, want, opt))
    return out


def resume_command(run_dir: str, opt: dict):
    """The training command that resumes `run_dir` from its `last`
    checkpoint, on the device the run was started on."""
    cmd = [sys.executable, "-m", "face_detection_multi_scale_tpu_torch.cli."
           "train", "--resume", "--exist-ok",
           "--project", str(Path(run_dir).parent),
           "--name", Path(run_dir).name]
    for key in RESUME_KEYS + ("device",):
        if opt.get(key) is not None:
            cmd += [f"--{key.replace('_', '-')}", str(opt[key])]
    return cmd


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="runs/train")
    ap.add_argument("--dry-run", action="store_true",
                    help="print commands without launching")
    args = ap.parse_args(argv)

    runs = find_interrupted(args.root)
    if not runs:
        print(f"no interrupted runs under {args.root}")
        return 0
    for run_dir, done, want, opt in runs:
        cmd = resume_command(run_dir, opt)
        print(f"resume {run_dir} (epoch {done}/{want}):")
        print("  " + " ".join(cmd))
        if not args.dry_run:
            subprocess.run(cmd, check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
