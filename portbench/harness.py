"""One run of one cell: set-up, the measured window, the traced reading
and the comparison with the reference.

A cell is a configuration (`configs/<config>.json`: the model's layer
table, its serving mode and how its weights are seeded) under a traffic
mix (`traffic/<traffic>.json`: what one closed-loop client sends):
`FaceDetector.run_network` on uint8 batches already on the card, from a
rotating pool of distinct batches, each call done when
`detections_to_numpy` has the rows on the host.

The gate (`conf_thres`) is the mix's fixed one, or comes from the
reference's rows on the pool, so that the median image gates `gate.rows`
rows.
"""

from __future__ import annotations

import gc
import json
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from portbench import compare, inputs
from portbench.reference import model as RM
from portbench.reference import postprocess as RP

ROOT = Path(__file__).resolve().parent
SAMPLE_P = 0.1      # share of calls after the first pool cycle that are judged
SAMPLE_MAX = 32


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(manifest: Dict, name: str) -> Dict:
    """The manifest's entry `name` with its configuration and traffic."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the manifest has "
                         f"{sorted(cells)}")
    cell = dict(cells[name])
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    cell["cfg"] = load_json(ROOT.parent / conf["file"])
    cell["mix"] = load_json(ROOT / "traffic" / f"{cell['traffic']}.json")
    limits = ROOT / "limits" / f"{name}.json"
    cell["limits"] = load_json(limits) if limits.exists() else None
    return cell


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """Set-up, window and check of one cell at one seed."""

    def __init__(self, cell: Dict, seed: int, device):
        self.cell, self.cfg, self.mix = cell, cell["cfg"], cell["mix"]
        self.seed, self.device = seed, torch.device(device)
        serving = self.cfg["serving"]
        self.iou = serving["iou_thres"]
        self.max_det = self.mix.get("max_det", serving["max_det"])
        self.max_cand = self.mix.get("max_candidates",
                                     serving["max_candidates"])

    # ------------------------------------------------------------------
    # set-up
    # ------------------------------------------------------------------

    def make_inputs(self) -> None:
        """The pool of batches and the weights, from the seed; the BN
        statistics measured on the first images of the pool."""
        mix = self.mix
        pool = inputs.make_frames(self.seed, mix["pool"] * mix["batch"],
                                  (*mix["hw"], 3), self.device)
        self.pool = pool.view(mix["pool"], mix["batch"], *mix["hw"], 3)
        n_cal = self.cfg["seeded_weights"]["calib_images"]
        self.weights = inputs.calibrate_bn(
            self.cfg, inputs.make_weights(self.cfg, self.seed, self.device),
            pool[:n_cal])

    def reference(self, control: bool = False):
        return RM.build(self.cfg, self.weights, self.device, control=control)

    def set_gate(self, ref) -> None:
        """conf_thres: `gate.fixed` where the mix states one; otherwise the
        median over the pool's images of each one's `gate.rows`-th conf by
        the reference."""
        g = self.mix["gate"]
        if "fixed" in g:
            self.gate = float(g["fixed"])
            return
        conf = torch.cat([(lambda r: r[..., 4] * r[..., 5])(
            RM.rows_of(ref, batch)) for batch in self.pool])
        kth = conf.sort(dim=1, descending=True)[0][:, g["rows"] - 1]
        self.gate = float(kth.median())

    def build_program(self):
        from face_detection_multi_scale_tpu_torch.infer.detector import (
            FaceDetector)

        serving = self.cfg["serving"]
        dtype = {"bfloat16": torch.bfloat16,
                 "float32": torch.float32}[serving["dtype"]]
        self.det = FaceDetector(
            self.cfg["model"], variables=self.weights, conf_thres=self.gate,
            iou_thres=self.iou, dtype=dtype, max_det=self.max_det,
            max_candidates=self.max_cand, device=self.device,
            fuse_elan=serving["fuse_elan"])

    def call(self, i: int):
        """Call `i` of the closed loop: its rows on the host, and its
        Detections."""
        from face_detection_multi_scale_tpu_torch.ops.nms import (
            detections_to_numpy)

        dets = self.det.run_network(self.pool[i % len(self.pool)])
        return detections_to_numpy(dets), dets

    def setup(self) -> None:
        self.make_inputs()
        ref = self.reference()
        self.set_gate(ref)
        del ref
        self.free()
        self.build_program()
        for i in range(len(self.pool)):  # every input once: builds, loads
            self.call(i)
        sync(self.device)

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # the window
    # ------------------------------------------------------------------

    def counters(self) -> Dict[str, int]:
        from face_detection_multi_scale_tpu_torch.ops import (
            elan_kernel, nms_kernel)

        rep = self.det.truncation_report()
        return {"tma": elan_kernel.fused_elan.bf16_tma_launches,
                "bf16": elan_kernel.fused_elan.bf16_launches,
                "f32": elan_kernel.fused_elan.launches,
                "keep": nms_kernel.nms_keep.launches,
                "images": rep["images"],
                "truncated": rep["truncated_images"]}

    def window(self, seconds: float) -> Dict:
        """The closed loop for `seconds`: the calls completed, and the
        outputs of the judged calls (the first pool cycle and a seeded
        sample of the rest)."""
        rng = np.random.default_rng(self.seed % 2 ** 63)
        before = self.counters()
        kept = []
        i = 0
        t0 = time.perf_counter()
        while True:
            rows, dets = self.call(i)
            now = time.perf_counter()
            if i < len(self.pool) or (rng.random() < SAMPLE_P
                                      and len(kept) < SAMPLE_MAX):
                kept.append((i % len(self.pool), rows,
                             dets.n_gated.cpu().numpy()))
            i += 1
            if now - t0 >= seconds:
                break
        after = self.counters()
        return {"calls": i, "window_s": now - t0, "kept": kept,
                "delta": {k: after[k] - before[k] for k in after}}

    def end_to_end(self, w: Dict) -> Dict[str, float]:
        return {"img_per_s": w["calls"] * self.mix["batch"] / w["window_s"]}

    # ------------------------------------------------------------------
    # checks
    # ------------------------------------------------------------------

    def route_checks(self, w: Dict) -> List[str]:
        """What the window ran, from the program's own counters: the
        faults, one line each (empty when it ran what the cell says)."""
        d, calls, faults = w["delta"], w["calls"], []
        on_card = self.device.type == "cuda"
        groups = self.cfg["serving"]["fused_groups"]
        want_tma = groups * calls if on_card else 0
        if d["tma"] != want_tma or d["bf16"] != want_tma or d["f32"]:
            faults.append(f"fused groups: {d['tma']} TMA-route launches, "
                          f"{d['bf16']} bf16, {d['f32']} float32; the cell "
                          f"wants {want_tma} on the TMA route")
        want_keep = calls if on_card else 0
        if d["keep"] != want_keep:
            faults.append(f"nms_keep: {d['keep']} launches, the cell wants "
                          f"{want_keep}")
        trunc = self.mix["truncation"]
        if (d["truncated"] > 0) != (trunc == "some"):
            faults.append(f"top-K truncation: {d['truncated']} of "
                          f"{d['images']} images truncated (the most gated: "
                          f"{self.det.truncation_report()['max_gated']}); "
                          f"the cell wants {trunc}")
        rows = self.mix["gate"].get("rows")
        if rows:  # the load the cell states, within a factor of two
            n = float(np.median(np.concatenate([k[2] for k in w["kept"]])))
            if not rows / 2 <= n <= 2 * rows:
                faults.append(f"gated rows: the median judged image gated "
                              f"{n:.0f}, the cell states {rows}")
        return faults

    @torch.no_grad()
    def control_outputs(self) -> List:
        """The control in the program's place: the reference with its
        convolutions in float8 e4m3, the nearest precision below the
        configuration's bf16, served through the reference's own
        postprocess, once over every input of the pool, in the form the
        window keeps judged outputs."""
        ref = self.reference(control=True)
        kept = []
        for idx in range(len(self.pool)):
            post = RP.postprocess(RM.rows_of(ref, self.pool[idx]), self.gate,
                                  self.iou, self.max_cand, self.max_det)
            kept.append((idx, [p["rows"].astype(np.float32) for p in post],
                         np.array([p["n_gated"] for p in post])))
        return kept

    @torch.no_grad()
    def judge(self, kept: List) -> Dict[str, float]:
        """The cell's numbers: every judged output against the reference
        run on the same input (once per pool entry)."""
        ref = self.reference()
        parts = []
        by_input: Dict[int, list] = {}
        for k in kept:
            by_input.setdefault(k[0], []).append(k)
        for idx, outs in sorted(by_input.items()):
            rows = RM.rows_of(ref, self.pool[idx])
            post = RP.postprocess(rows, self.gate, self.iou, self.max_cand,
                                  self.max_det)
            parts += [compare.judge_images(o[1], o[2], rows, post, self.gate,
                                           self.iou) for o in outs]
        return compare.summarize(parts)
