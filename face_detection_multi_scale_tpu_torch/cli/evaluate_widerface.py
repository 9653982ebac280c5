"""WIDER FACE evaluation CLI.

    python -m face_detection_multi_scale_tpu_torch.cli.evaluate_widerface \
        -p widerface_txt/ -g ground_truth/

The port's counterpart of the JAX package's cli/evaluate_widerface.py,
over the port's `eval.widerface.evaluation`. Same surface as the
reference harness (reference widerface_evaluate/evaluation.py:284-291:
`-p/--pred`, `-g/--gt`), prints the identical Easy/Medium/Hard AP block,
exits nonzero if --expect-* gates fail (for CI-style regression runs).
It runs on the host (numpy and the native IoU), so it takes no
`--device`.
"""

from __future__ import annotations

import argparse
import sys

from face_detection_multi_scale_tpu_torch.eval.widerface import evaluation


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-p", "--pred", default="./widerface_txt/")
    ap.add_argument("-g", "--gt", default="./ground_truth/")
    ap.add_argument("--expect-easy", type=float, default=None)
    ap.add_argument("--expect-medium", type=float, default=None)
    ap.add_argument("--expect-hard", type=float, default=None)
    args = ap.parse_args(argv)

    aps = evaluation(args.pred, args.gt)
    ok = True
    for setting in ("easy", "medium", "hard"):
        want = getattr(args, f"expect_{setting}")
        if want is not None and aps[setting] < want:
            print(f"FAIL: {setting} AP {aps[setting]:.4f} < {want}")
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
