#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each fatal on failure (nothing is caught to carry on):
  1. device: the card's name and power limit (nvidia-smi); no card -> exit 1
  2. build: nvcc compiles every kernel of the path from the checkout
  3. kernels vs plain, bit for bit, on the card: nms_keep (the CUDA
     greedy-NMS keep mask) on the CPU tests' cases, the serving point
     (B=16, K=4096), the eval point (B=2, K=16384), ragged K, invalid tails,
     long suppression chains, duplicate and zero-area boxes
  4. path w6: FaceDetector("yolov7-w6-face") at full width, seeded random
     weights, serves a few requests of 8 synthetic 640x640 frames through
     run_network with the launch counters reset just before and read just
     after; its Detections must equal the port's CPU postprocess of the
     card's decoded rows exactly, and its float32 forward (TF32 off) must
     match a CPU forward on 2 frames within atol 5e-3 / rtol 1e-3 on the
     decoded rows (the decoded-row tolerance of the CPU parity tests)
  5. path tiny: the same for yolov7-tiny-face
  6. one JSON line with every kernel's launches, error, times and bound
  7. the last line: {"ok": true, "device": {...}}

Kernel times are CUDA-event averages after warm-up, at the inputs the w6
path hands the kernel. bound_ms is the larger of bytes / 3.35 TB/s and
operations / 67 TFLOP/s (H100 SXM f32 peak without tensor cores), counting
what this run's data needs (see `nms_bound`).
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from face_detection_multi_scale_tpu_torch.infer.detector import FaceDetector
from face_detection_multi_scale_tpu_torch.ops import nms as NMS
from face_detection_multi_scale_tpu_torch.ops import nms_kernel as K

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_IOU = 12  # 4 min/max, 2 sub, 2 clamp, mul, add, sub, div (+ compare)
BATCH = 8
REQUESTS = 4
SIZE = 640
MAX_CANDIDATES = 4096  # the serving default; w6@640 has N = 25,500 rows
ROW_TOL = dict(atol=5e-3, rtol=1e-3)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() over `iters` runs, by CUDA events, after
    two warm-up runs."""
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


def candidates(b, k, seed, frac_valid=1.0, degenerate=False):
    """Score-sorted boxes (B, K, 4) and valid (B, K) as the CPU tests make
    them; `degenerate` adds duplicates, zero-width, zero-height and
    point boxes."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 600, (b, k, 2)).astype(np.float32)
    wh = rng.uniform(5, 150, (b, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    valid = np.zeros((b, k), bool)
    valid[:, :int(k * frac_valid)] = True
    if degenerate and k >= 32:
        for i in range(b):
            dst = rng.choice(np.arange(1, k), size=k // 8, replace=False)
            boxes[i, dst] = boxes[i, rng.integers(0, dst)]
            z = rng.choice(k, size=k // 16, replace=False)
            boxes[i, z, 2] = boxes[i, z, 0]
            z = rng.choice(k, size=k // 16, replace=False)
            boxes[i, z, 3] = boxes[i, z, 1]
            z = rng.choice(k, size=4, replace=False)
            boxes[i, z, 2:] = boxes[i, z, :2]
    return (torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda())


def nms_bound(keep: torch.Tensor, valid: torch.Tensor):
    """(bound_ms, bound_by) for one keep-mask call: bytes = boxes + valid
    read once, keep written once; operations = OPS_PER_IOU for every pair
    of a valid candidate and an earlier keeper, the IoUs a greedy scan of
    this data must evaluate to settle every candidate."""
    b, k = keep.shape
    kept_before = keep.long().cumsum(1) - keep.long()
    pairs = int((kept_before * valid.long()).sum())
    t_bytes = b * k * (16 + 1 + 1) / HBM_BYTES_PER_S * 1e3
    t_ops = pairs * OPS_PER_IOU / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def check_kernel_cases() -> int:
    """Phase 3: nms_keep vs nms_keep_plain, bit for bit. Returns the
    largest |kernel - plain| over every case (0 when they agree) and the
    number of rows that differ."""
    cases = [  # (b, k, thr, frac_valid, degenerate)
        (2, 1024, .5, 1., False), (1, 2048, .3, 1., False),
        (3, 1024, .7, 1., False), (1, 1024, .5, .4, False),
        (1, 1024, .9, 1., False),                       # the CPU tests
        (2, 1024, .3, .8, True), (2, 1024, .5, .8, True),
        (16, 4096, .5, 1., False), (16, 4096, .5, .6, True),  # serving
        (2, 16384, .5, 1., False), (2, 16384, .45, .7, True),  # eval
        (2, 1, .5, 1., False), (3, 300, .5, .7, True),
        (2, 1000, .9, .5, True), (2, 4095, .5, .9, True),   # ragged K
        (1, 4096, .9, 1., True)]                        # long chains
    worst = mismatches = 0
    for n, (b, k, thr, frac, degen) in enumerate(cases):
        boxes, valid = candidates(b, k, seed=1000 + n, frac_valid=frac,
                                  degenerate=degen)
        got = K.nms_keep(boxes, valid, thr)
        torch.cuda.synchronize()
        want = K.nms_keep_plain(boxes, valid, thr)
        err = int((got.int() - want.int()).abs().max())
        worst = max(worst, err)
        mismatches += int((got != want).sum())
        print(f"nms_keep B={b} K={k} thr={thr} valid={frac} "
              f"degenerate={degen}: kept {int(want.sum())}, "
              f"mismatches {int((got != want).sum())}")
        check(err == 0, f"nms_keep differs from its plain version at "
                        f"B={b} K={k} thr={thr}")
        check(not bool(got[~valid].any()), "an invalid row was kept")
    boxes, valid = candidates(16, 4096, seed=7)
    ms = cuda_ms(lambda: K.nms_keep(boxes, valid, 0.5), 50)
    plain = cuda_ms(lambda: K.nms_keep_plain(boxes, valid, 0.5), 5)
    print(f"nms_keep B=16 K=4096 synthetic: kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms")
    return worst, mismatches


def same_detections(a: NMS.Detections, b: NMS.Detections) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def drive_path(name: str, smi: str, seed: int):
    """Phases 4/5 for one zoo model. Returns (launches in the served run,
    the kernel's inputs from the first request)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (REQUESTS, BATCH, SIZE, SIZE, 3),
                          dtype=np.uint8)
    det = FaceDetector(name, img_sizes=(SIZE,), conf_thres=0.5,
                       iou_thres=0.5, max_candidates=MAX_CANDIDATES,
                       seed=seed, device="cuda")
    # a gate low enough that the busiest frame overfills K: random weights
    # put conf near 1e-3 at stride 8 and near 0.25 on the rows that the
    # reference's anchor-major view fills from the kpt conv
    rows = det.forward_rows(frames[0])
    conf = (rows[..., 4] * rows[..., 5]).sort(dim=1, descending=True)[0]
    det.conf_thres = float(conf[:, 3 * MAX_CANDIDATES // 2].max())
    det.warmup(SIZE, BATCH)

    K.nms_keep.launches = 0
    times, n_gated = [], []
    for r in range(REQUESTS):
        t0 = time.perf_counter()
        dets = det.run_network(frames[r])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(dets.boxes.shape == (BATCH, min(det.max_det,
                                               det.max_candidates), 4),
              f"{name}: Detections shape {tuple(dets.boxes.shape)}")
        check(all(bool(torch.isfinite(t).all()) for t in dets[:4]),
              f"{name}: non-finite detections")
        n_gated += dets.n_gated.cpu().tolist()
    launches = K.nms_keep.launches
    check(launches == REQUESTS, f"{name}: nms_keep launched {launches} "
                                f"times for {REQUESTS} engine calls")
    print(f"{name}: conf_thres {det.conf_thres:.6g}, n_gated {n_gated}, "
          f"max_candidates {det.max_candidates}, kept per image "
          f"{dets.valid.sum(1).cpu().tolist()}, nms_keep launches "
          f"{launches} in {REQUESTS} requests")
    check(max(n_gated) > det.max_candidates,
          f"{name}: no image filled K = {det.max_candidates}")
    ms = [t * 1e3 for t in times]
    print(f"{name} run_network b{BATCH}@{SIZE} on {smi}: ms/batch "
          f"{[round(m, 3) for m in ms]}, median {np.median(ms):.3f}, "
          f"img/s {BATCH / np.median(times):.1f}")

    # where one request's time goes: forward (with decode) vs postprocess
    t0 = time.perf_counter()
    rows = det.forward_rows(frames[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dets_card = det.postprocess(rows)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"{name}: forward+decode {1e3 * (t1 - t0):.3f} ms, postprocess "
          f"{1e3 * (t2 - t1):.3f} ms (host clock, synchronized)")

    # the card's postprocess == the CPU postprocess of the same rows
    dets_cpu = det.postprocess(rows.cpu())
    check(same_detections(dets_card, dets_cpu),
          f"{name}: card Detections differ from the CPU postprocess")
    print(f"{name}: card Detections == CPU postprocess of the card's rows")

    # the card's float32 forward vs a CPU forward with the same weights
    cpu = FaceDetector(name, img_sizes=(SIZE,), seed=seed, device="cpu")
    rows_card = det.forward_rows(frames[0][:2]).cpu()
    rows_cpu = cpu.forward_rows(frames[0][:2])
    check(rows_card.shape == rows_cpu.shape and
          bool(torch.isfinite(rows_card).all()), f"{name}: bad rows")
    err = (rows_card - rows_cpu).abs()
    lim = ROW_TOL["atol"] + ROW_TOL["rtol"] * rows_cpu.abs()
    print(f"{name}: card vs CPU forward, decoded rows {tuple(rows_card.shape)}"
          f", max |diff| {float(err.max()):.3g}, worst diff/limit "
          f"{float((err / lim).max()):.3g}")
    check(bool((err <= lim).all()), f"{name}: card forward differs from "
                                    f"the CPU forward beyond {ROW_TOL}")

    _, _, _, nms_boxes, valid, _, _ = NMS._gather_candidates_planar(
        rows, nc=det.spec.nc, conf_thres=det.conf_thres,
        k=min(det.max_candidates, rows.shape[1]))
    return launches, (nms_boxes.contiguous(), valid, det.iou_thres)


def main() -> None:
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    t0 = time.perf_counter()
    K.build()
    print(f"build: nms_keep {time.perf_counter() - t0:.2f} s")

    worst, mismatches = check_kernel_cases()
    launches, (boxes, valid, thr) = drive_path("yolov7-w6-face", smi, 0)
    drive_path("yolov7-tiny-face", smi, 1)

    keep = K.nms_keep(boxes, valid, thr)
    want = K.nms_keep_plain(boxes, valid, thr)
    worst = max(worst, int((keep.int() - want.int()).abs().max()))
    mismatches += int((keep != want).sum())
    check(worst == 0, "nms_keep differs from its plain version on the "
                      "w6 path's inputs")
    ms = cuda_ms(lambda: K.nms_keep(boxes, valid, thr), 50)
    plain_ms = cuda_ms(lambda: K.nms_keep_plain(boxes, valid, thr), 5)
    bound_ms, bound_by = nms_bound(keep, valid)
    b, k = valid.shape
    dense_ms = b * k * k / 2 * OPS_PER_IOU / F32_OPS_PER_S * 1e3
    print(f"nms_keep at the w6 path's inputs B={b} K={k}: kept "
          f"{int(keep.sum())}, bound {bound_ms:.5f} ms by {bound_by} "
          f"(all K^2/2 pairs would bound it at {dense_ms:.5f} ms)")
    print(json.dumps({"kernels": [{
        "name": "nms_keep", "route": "cuda",
        "source": "face_detection_multi_scale_tpu_torch/csrc/nms_keep.cu",
        "replaces": "face_detection_multi_scale_tpu/ops/pallas_nms.py:94",
        "launches": launches, "max_abs_err": worst,
        "mismatches": mismatches, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
