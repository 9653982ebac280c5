#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each fatal on failure (nothing is caught to carry on):
  1. device: the card's name and power limit (nvidia-smi); no card -> exit 1
  2. build: nvcc compiles every kernel from the checkout, one process per
     source, all started together; seconds per source. fused_elan.cu
     builds while phases 3-5, which do not need it, run
  3. keep-mask kernels vs plain, bit for bit, on the card: nms_keep (seq,
     the serving kernel) and its fixpoint version on the CPU tests' cases,
     the serving point (B=16, K=4096), the eval point (B=2, K=16384),
     ragged K, invalid tails, long suppression chains, duplicate and
     zero-area boxes; the fixpoint kernel's sweep counts equal to
     fixpoint_sweeps_plain's on every case (the largest printed); the
     fixpoint kernel's launches in the kernels line are this phase's, the
     one that drives it (every path checks that it launches 0 times
     there); how many sweep clusters of 8 and of 16 blocks the card holds
  3b. probe_mm: the matmul-layout probe tool's measurement
     (tools/probe_mm.measure, its entry point) for each variant at the JAX
     geometry and 512 cells, the launch counter zeroed before and read
     after; each variant within a scale-relative 1e-4 of its plain version
     (float32 sums over 6k-54k rows in another order); kernel, plain,
     library and bound times; then one launch of the kernel's counting
     instantiation (tools/probe_mm.count_staged, outside the counted
     window) measures the bytes its cp.asyncs stage into shared memory a
     cell, which must equal the plan's (tools/probe_mm.staged_bytes), and
     its output must equal the probe's bit for bit
  4. path w6: FaceDetector("yolov7-w6-face") at full width, seeded random
     weights, serves a few requests of 8 synthetic 640x640 frames through
     run_network with the launch counters reset just before and read just
     after (one seq nms_keep launch a request; the fixpoint kernel, a
     cross-check entry point, must not launch); its Detections must equal the port's CPU postprocess of the
     card's decoded rows exactly, and its float32 forward (TF32 off) must
     match a CPU forward on 2 frames within atol 5e-3 / rtol 1e-3 on the
     decoded rows (the decoded-row tolerance of the CPU parity tests)
  5. path tiny: the same for yolov7-tiny-face
  5b. path w6-tta: the TTA pyramid, FaceDetector("yolov7-w6-face",
     img_sizes=(640, 3840), use_device_preprocess=True) at full width with
     phase 4's seeded weights, `detect_multi_scale` on 2 synthetic 1080x1920
     BGR frames (384x640 and 2176x3840 letterboxed): the device preprocess
     within 1e-5 of the same on the CPU; each scale's Detections equal to
     the CPU postprocess of the card's rows; the merge's keep indices equal
     to the CPU merge's on the same rows; per image 3 nms_keep launches (2
     scales + the merge), 0 fixpoint, 0 fused_elan; ms per image by part
  5c. path w6-tiled: FaceDetector("yolov7-w6-face", img_sizes=(640, 3840),
     use_api_preprocess=True, tile_top_scale=2, tile_halo=256,
     tile_min_size=2048) with phase 4's seeded weights and phase 5b's gate.
     The card machine has no OpenCV, so the host letterbox cannot run:
     phase 5b's 2 frames become 3840x3840 API frames through the port's
     device_preprocess_api on the card, rounded to uint8 on the host, and
     drive _run_tiled_batch, the one tiled call sequence of every tiled
     entry point: one (8, 2176, 2176, 3) engine call (plan_tiles(3840, 2,
     256, 64): tile 2176, origins 0 and 1664), then each frame's
     assemble_rows with its seam dedup on the card. The tile batch's
     Detections equal to the CPU postprocess of the card's rows; each
     frame's rows equal to assemble_rows(..., device="cpu") of the same
     tile rows; truncation_report()["images"] grows by 2, not 8; nms_keep
     launches 1 + one per frame that owned a row, 0 fixpoint, 0 fused_elan;
     rows finite, their centers inside the 3840^2 frame. Printed (as
     information: tiling is approximate near seams): how many untiled
     rows have a tiled row at IoU >= 0.5; medians of 3 (host clock,
     synchronized) of the tiled call per frame, split into the b8@2176^2
     tile forward+decode, the postprocess and assemble_rows, beside the
     untiled b1@3840^2 forward of the same frame (host upload, as the
     tiles) and phase 5b's b1@2176x3840 device-preprocess forward
  6. fused_elan vs plain: the kernel on the inputs the w6 and tiny fused
     paths hand each E-ELAN group at b8@640 (captured in one forward), held
     against reference_elan through cuDNN with TF32 off within a
     scale-relative 1e-5 (max |diff| / max |plain|, the JAX suite's bound,
     tests/test_fused_elan.py); per group: kernel, plain, library and bound
     times, the plan's tile, cluster and grid, the recompute share
     (positions computed / output positions, per conv and for the group)
     and the kernel's effective TFLOP/s
  7. path w6-fused: FaceDetector("yolov7-w6-face", fuse_elan=True), the
     same weights and requests as phase 4: 11 fused_elan launches and one
     nms_keep launch per request; decoded rows within the phase 4
     tolerance of the unfused card forward and of the CPU forward; its
     Detections equal the CPU postprocess of its rows. Then once more with
     fuse_elan="pre:" (5 groups absorb their downsample conv)
  8. path tiny-fused: the same for tiny, 8 launches per request
  9. one JSON line with every kernel's launches, error, times and bound;
     for nms_keep_fixpoint also its sweeps at the w6 path's inputs and
     its two launches timed apart, with the sweeps in clusters of 8 and
     of 16 blocks
 10. the last line: {"ok": true, "device": {...}}

Kernel times are CUDA-event averages after warm-up. bound_ms is the larger
of bytes / 3.35 TB/s and operations / the peak of the arithmetic the kernel
does (H100 SXM, dense): 67 TFLOP/s f32 without tensor cores for nms_keep;
495 / 3 = 165 TFLOP/s for fused_elan, whose f32-accurate products are three
TF32 tensor-core products a multiply-add (3xTF32; the 67 TFLOP/s SIMT bound
is printed beside it); 989 TFLOP/s bf16 for probe_mm. Operations count what
this run's data needs (`nms_bound`, `elan_cost`, `probe_mm.cost`).
"""

from __future__ import annotations

import concurrent.futures
import json
import subprocess
import time

import numpy as np
import torch

from face_detection_multi_scale_tpu_torch.infer import device_preprocess as DP
from face_detection_multi_scale_tpu_torch.infer import tiling
from face_detection_multi_scale_tpu_torch.infer.detector import (
    FaceDetector, full_fp32)
from face_detection_multi_scale_tpu_torch.models import fused as FUSED
from face_detection_multi_scale_tpu_torch.ops import elan_kernel as E
from face_detection_multi_scale_tpu_torch.ops import nms as NMS
from face_detection_multi_scale_tpu_torch.ops import nms_kernel as K
from face_detection_multi_scale_tpu_torch.tools import probe_mm as PM

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32X3_OPS_PER_S = 495e12 / 3  # 3xTF32: three TF32 products a multiply-add
OPS_PER_IOU = 12  # 4 min/max, 2 sub, 2 clamp, mul, add, sub, div (+ compare)
BATCH = 8
REQUESTS = 4
SIZE = 640
MAX_CANDIDATES = 4096  # the serving default; w6@640 has N = 25,500 rows
ROW_TOL = dict(atol=5e-3, rtol=1e-3)
ELAN_REL_TOL = 1e-5
GROUPS = {"yolov7-w6-face": 11, "yolov7-tiny-face": 8}
PROBE_CELLS, PROBE_ITERS = 512, 6  # the JAX tool's defaults
TTA_SIZES = (640, 3840)  # the JAX FaceDetector's default pyramid
TTA_FRAMES, TTA_HW = 2, (1080, 1920)  # video frames of the production pipeline
TILE_GRID, TILE_HALO, TILE_MIN = 2, 256, 2048  # the JAX tiling example
TIMING_ROUNDS = 3
T_START = time.perf_counter()


def stamp(what: str) -> None:
    """The seconds since the imports, after `what`."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {what}", flush=True)


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


def start_builds(pool):
    """Phase 2: one nvcc per source, all started together; returns a
    future per kernel module, each giving the build's seconds."""
    def timed(mod):
        t0 = time.perf_counter()
        mod.build()
        return time.perf_counter() - t0

    return {mod: pool.submit(timed, mod) for mod in (K, PM, E)}


def built(builds, mod) -> None:
    """Wait for `mod`'s build (a failed build raises here)."""
    secs = builds[mod].result()
    print(f"build: {mod.SOURCE.name} {secs:.2f} s")


def check_kernel_cases():
    """Phase 3: nms_keep and its fixpoint version vs nms_keep_plain, bit for
    bit. Returns, per version, the largest |kernel - plain| over every case
    (0 when they agree) and the number of rows that differ, and the
    fixpoint kernel's launches in this phase, the one that drives it (no
    serving path does). The fixpoint kernel's sweep counts must equal
    fixpoint_sweeps_plain's."""
    for cluster in (8, 16):
        print(f"nms_keep[fixpoint] sweep clusters of {cluster} blocks the "
              f"card holds at once: "
              f"{K.fixpoint_max_active_clusters(4096, cluster, 0)}")
    K.nms_keep.fixpoint_launches = 0
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
    stats = {v: [0, 0] for v in K.KERNEL_VERSIONS}
    for n, (b, k, thr, frac, degen) in enumerate(cases):
        boxes, valid = candidates(b, k, seed=1000 + n, frac_valid=frac,
                                  degenerate=degen)
        want = K.nms_keep_plain(boxes, valid, thr)
        want_sweeps = K.fixpoint_sweeps_plain(boxes, valid, thr)
        for version in K.KERNEL_VERSIONS:
            got = K.nms_keep(boxes, valid, thr, kernel_version=version)
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max())
            bad = int((got != want).sum())
            stats[version][0] = max(stats[version][0], err)
            stats[version][1] += bad
            sweeps = ""
            if version == "fixpoint":
                got_sweeps = K.nms_keep.last_fixpoint_sweeps
                check(torch.equal(got_sweeps, want_sweeps),
                      f"nms_keep[fixpoint] swept {got_sweeps.tolist()} "
                      f"times, fixpoint_sweeps_plain "
                      f"{want_sweeps.tolist()}, at B={b} K={k} thr={thr}")
                sweeps = (f", sweeps at most {int(got_sweeps.max())} (= "
                          f"plain)")
            print(f"nms_keep[{version}] B={b} K={k} thr={thr} valid={frac} "
                  f"degenerate={degen}: kept {int(want.sum())}, "
                  f"mismatches {bad}{sweeps}")
            check(err == 0, f"nms_keep[{version}] differs from its plain "
                            f"version at B={b} K={k} thr={thr}")
            check(not bool(got[~valid].any()), "an invalid row was kept")
    boxes, valid = candidates(16, 4096, seed=7)
    for version, iters in (("seq", 20), ("fixpoint", 20)):
        ms = cuda_ms(lambda: K.nms_keep(boxes, valid, 0.5,
                                        kernel_version=version), iters)
        print(f"nms_keep[{version}] B=16 K=4096 synthetic: kernel "
              f"{ms:.4f} ms")
    plain = cuda_ms(lambda: K.nms_keep_plain(boxes, valid, 0.5), 5)
    print(f"nms_keep_plain B=16 K=4096 synthetic: {plain:.4f} ms")
    return stats, K.nms_keep.fixpoint_launches


def check_probe(smi: str):
    """Phase 3b: the probe tool's measurement of each variant, the launch
    counter zeroed just before and read just after. Returns the kernels
    line's entries."""
    inputs = PM.make_inputs("cuda")
    entries = []
    for variant in PM.VARIANTS:
        PM.probe_mm.launches = 0
        row = PM.measure(variant, PROBE_CELLS, PROBE_ITERS, inputs)
        launches = PM.probe_mm.launches
        check(launches > 0, f"probe_mm[{variant}] never launched")
        out, staged = PM.count_staged(variant, *inputs, PROBE_CELLS)
        check(staged == PM.staged_bytes(variant),
              f"probe_mm[{variant}] staged {staged} B a cell, its plan "
              f"{PM.staged_bytes(variant)}")
        staged = int(staged)  # a whole number: it equals the plan's
        check(bool((out == PM.probe_mm(variant, *inputs, 1)[0]).all()),
              f"probe_mm[{variant}]'s counting instantiation computes "
              f"another result")
        print(f"probe_mm[{variant}] {PROBE_CELLS} cells on {smi}: kernel "
              f"{row['total_ms']:.4f} ms ({row['us_per_cell']:.4f} us a "
              f"cell), plain {row['plain_ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"by {row['bound_by']}; max |diff| {row['max_abs_diff']:.3g}, "
              f"/ max |plain| {row['rel_diff']:.3g}; {launches} launches; "
              f"staged {staged} B a cell (counted on the card, as planned), "
              f"{staged * PROBE_CELLS / row['total_ms'] / 1e9:.3f} TB/s over "
              f"the kernel's time")
        entries.append({
            "name": f"probe_mm[{variant}]", "route": "cuda",
            "source": "face_detection_multi_scale_tpu_torch/csrc/probe_mm.cu",
            "replaces": "tools/probe_mosaic_mm.py:62",
            "launches": launches, "max_abs_err": row["max_abs_diff"],
            "max_rel_err": row["rel_diff"], "ms": row["total_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "per": f"{PROBE_CELLS} cells", "staged_bytes": staged})
    return entries


def same_detections(a: NMS.Detections, b: NMS.Detections) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def rows_within(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{what}: bad rows")
    err = (got - want).abs()
    lim = ROW_TOL["atol"] + ROW_TOL["rtol"] * want.abs()
    print(f"{what}, decoded rows {tuple(got.shape)}, max |diff| "
          f"{float(err.max()):.3g}, worst diff/limit "
          f"{float((err / lim).max()):.3g}")
    check(bool((err <= lim).all()), f"{what} beyond {ROW_TOL}")


def drive_path(name: str, smi: str, seed: int, frames: np.ndarray,
               fuse_elan=False, requests=None, ref=None):
    """Phases 4/5/7/8 for one zoo model. `ref` holds the unfused phase's
    card and CPU rows on 2 frames; without it the CPU forward is run here.
    Returns (the launch counts of the requests: seq, fixpoint and fused,
    the keep mask's inputs from the first request, the rows on 2 frames:
    card and CPU, the detector)."""
    tag = name if not fuse_elan else f"{name} fuse_elan={fuse_elan!r}"
    requests = requests or REQUESTS
    det = FaceDetector(name, img_sizes=(SIZE,), conf_thres=0.5,
                       iou_thres=0.5, max_candidates=MAX_CANDIDATES,
                       seed=seed, fuse_elan=fuse_elan, device="cuda")
    # a gate low enough that the busiest frame overfills K: random weights
    # put conf near 1e-3 at stride 8 and near 0.25 on the rows that the
    # reference's anchor-major view fills from the kpt conv
    rows = det.forward_rows(frames[0])
    conf = (rows[..., 4] * rows[..., 5]).sort(dim=1, descending=True)[0]
    det.conf_thres = float(conf[:, 3 * MAX_CANDIDATES // 2].max())
    det.warmup(SIZE, BATCH)

    K.nms_keep.launches = K.nms_keep.fixpoint_launches = 0
    E.fused_elan.launches = 0
    times, n_gated = [], []
    for r in range(requests):
        t0 = time.perf_counter()
        dets = det.run_network(frames[r])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(dets.boxes.shape == (BATCH, min(det.max_det,
                                               det.max_candidates), 4),
              f"{tag}: Detections shape {tuple(dets.boxes.shape)}")
        check(all(bool(torch.isfinite(t).all()) for t in dets[:4]),
              f"{tag}: non-finite detections")
        n_gated += dets.n_gated.cpu().tolist()
    launches, fused = K.nms_keep.launches, E.fused_elan.launches
    fixpoint = K.nms_keep.fixpoint_launches
    check(launches == requests, f"{tag}: nms_keep launched {launches} "
                                f"times for {requests} engine calls")
    check(fixpoint == 0, f"{tag}: the fixpoint keep-mask kernel launched "
                         f"{fixpoint} times; serving runs the seq kernel")
    want_fused = GROUPS[name] * requests if fuse_elan else 0
    check(fused == want_fused, f"{tag}: fused_elan launched {fused} times "
                               f"for {requests} engine calls, want "
                               f"{want_fused}")
    if fuse_elan:
        pres = sum(b.pre is not None for b in det._elan_blocks)
        print(f"{tag}: {len(det._elan_blocks)} fused groups ({pres} with an "
              f"absorbed pre conv)")
    print(f"{tag}: conf_thres {det.conf_thres:.6g}, n_gated {n_gated}, "
          f"max_candidates {det.max_candidates}, kept per image "
          f"{dets.valid.sum(1).cpu().tolist()}, nms_keep launches "
          f"{launches}, fixpoint launches {fixpoint}, fused_elan launches "
          f"{fused} in {requests} requests")
    check(max(n_gated) > det.max_candidates,
          f"{tag}: no image filled K = {det.max_candidates}")
    ms = [t * 1e3 for t in times]
    print(f"{tag} run_network b{BATCH}@{SIZE} on {smi}: ms/batch "
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
    print(f"{tag}: forward+decode {1e3 * (t1 - t0):.3f} ms, postprocess "
          f"{1e3 * (t2 - t1):.3f} ms (host clock, synchronized)")

    # the card's postprocess == the CPU postprocess of the same rows
    stamp(f"{tag}: requests done")
    dets_cpu = det.postprocess(rows.cpu())
    check(same_detections(dets_card, dets_cpu),
          f"{tag}: card Detections differ from the CPU postprocess")
    stamp(f"{tag}: card Detections == CPU postprocess of the card's rows")

    # the card's float32 forward vs a CPU forward with the same weights
    rows_card = det.forward_rows(frames[0][:2]).cpu()
    if ref is None:
        cpu = FaceDetector(name, img_sizes=(SIZE,), seed=seed, device="cpu")
        rows_cpu = cpu.forward_rows(frames[0][:2])
    else:
        rows_unfused, rows_cpu = ref
        rows_within(rows_card, rows_unfused, f"{tag}: vs the unfused card "
                                             f"forward")
    rows_within(rows_card, rows_cpu, f"{tag}: card vs CPU forward")

    _, _, _, nms_boxes, valid, _, _ = NMS._gather_candidates_planar(
        rows, nc=det.spec.nc, conf_thres=det.conf_thres,
        k=min(det.max_candidates, rows.shape[1]))
    stamp(f"path {tag} done")
    counts = {"seq": launches, "fixpoint": fixpoint, "fused": fused}
    return (counts, (nms_boxes.contiguous(), valid, det.iou_thres),
            (rows_card, rows_cpu), det)


def tta_frames() -> np.ndarray:
    """Phase 5b's noise frames (BGR, uint8)."""
    return np.random.default_rng(2).integers(
        0, 256, (TTA_FRAMES, *TTA_HW, 3), dtype=np.uint8)


def timed(fn):
    """(fn(), its host-clock ms), synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def drive_tta(smi: str):
    """Phase 5b: the w6 TTA pyramid through detect_multi_scale with device
    preprocessing. Returns the nms_keep launches of the counted run and
    the gate."""
    det = FaceDetector("yolov7-w6-face", img_sizes=TTA_SIZES,
                       max_candidates=MAX_CANDIDATES, seed=0,
                       use_device_preprocess=True, device="cuda")
    frames = tta_frames()
    raw = det.upload(frames[:1])
    # the gate of phase 4: the small scale gates 1.5 K rows of frame 0
    x, _ = det.device_input(raw, TTA_SIZES[0], auto=True)
    rows = det.forward_input(x)
    conf = (rows[..., 4] * rows[..., 5]).sort(dim=1, descending=True)[0]
    det.conf_thres = float(conf[0, 3 * MAX_CANDIDATES // 2])
    for size in TTA_SIZES:
        x, geom = det.device_input(raw, size, auto=True)
        want = DP.device_letterbox(torch.from_numpy(frames[:1]), geom)
        err = float((x.cpu() - want).abs().max())
        print(f"w6-tta: device preprocess {TTA_HW} -> {geom.out_hw} at "
              f"{size}: card vs CPU max |diff| {err:.3g}")
        check(x.shape[1:3] == geom.out_hw and err <= 1e-5,
              f"w6-tta: device preprocess at {size} differs from the CPU")
    det.detect_multi_scale(frames[0])  # first-call allocations
    torch.cuda.synchronize()

    # the main path, with each scale's postprocess and the merge recorded
    posts, merges = [], []
    post, merge = det.postprocess, NMS.weighted_nms_merge

    def record_post(rows):
        dets = post(rows)
        posts.append((rows, dets))
        return dets

    def record_merge(merged, *args, **kwargs):
        keep = merge(merged, *args, **kwargs)
        merges.append((merged, keep))
        return keep

    det.postprocess, NMS.weighted_nms_merge = record_post, record_merge
    K.nms_keep.launches = K.nms_keep.fixpoint_launches = 0
    E.fused_elan.launches = 0
    outs, ms = [], []
    try:
        for frame in frames:
            t0 = time.perf_counter()
            out, shape = det.detect_multi_scale(frame)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
            check(shape == frame.shape, f"w6-tta: img0_shape {shape}")
    finally:
        del det.postprocess
        NMS.weighted_nms_merge = merge
    seq, fixpoint = K.nms_keep.launches, K.nms_keep.fixpoint_launches
    fused = E.fused_elan.launches
    print(f"w6-tta: {TTA_FRAMES} frames, nms_keep launches {seq}, fixpoint "
          f"{fixpoint}, fused_elan {fused}; detect_multi_scale ms per image "
          f"{[round(m, 3) for m in ms]} (host clock, synchronized)")
    want_seq = (len(TTA_SIZES) + 1) * TTA_FRAMES  # every scale + the merge
    check(seq == want_seq and fixpoint == 0 and fused == 0,
          f"w6-tta: launches seq {seq}, fixpoint {fixpoint}, fused {fused}; "
          f"want {want_seq}, 0, 0")
    check(len(posts) == len(TTA_SIZES) * TTA_FRAMES
          and len(merges) == TTA_FRAMES, "w6-tta: calls not recorded")
    for i, (rows, dets) in enumerate(posts):
        check(same_detections(dets, det.postprocess(rows.cpu())),
              f"w6-tta: card Detections of call {i} differ from the CPU "
              f"postprocess")
        print(f"w6-tta: scale {TTA_SIZES[i % len(TTA_SIZES)]} rows "
              f"{tuple(rows.shape)}, n_gated {dets.n_gated.tolist()}, kept "
              f"{int(dets.valid.sum())}; == CPU postprocess")
    for merged, keep in merges:
        want = merge(merged, len(TTA_SIZES), det.iou_thres, device="cpu")
        check(np.array_equal(keep, want), "w6-tta: the merge's keep indices "
                                          "differ from the CPU merge's")
        print(f"w6-tta: merge of {len(merged)} rows kept {len(keep)}; == CPU "
              f"merge")
    h, w = TTA_HW
    for out in outs:
        check(out.shape[1] == 7 and len(out) > 0
              and bool(np.isfinite(out).all())
              and bool((out[:, [0, 2]] >= 0).all() and (out[:, [0, 2]] <= w)
                       .all() and (out[:, [1, 3]] >= 0).all()
                       and (out[:, [1, 3]] <= h).all())
              and set(out[:, 6].tolist()) <= {0, 1}, "w6-tta: bad output")
    print(f"w6-tta: {[len(o) for o in outs]} final detections; "
          f"truncation_report {det.truncation_report()}")

    # where one image's time goes (frame 0, every part synchronized)
    raw, t_up = timed(lambda: det.upload(frames[:1]))
    parts = [f"upload {t_up:.3f}"]
    for size in TTA_SIZES:
        (x, _), t_pre = timed(lambda: det.device_input(raw, size, auto=True))
        rows, t_fwd = timed(lambda: det.forward_input(x))
        _, t_post = timed(lambda: det.postprocess(rows))
        parts.append(f"scale {size} {tuple(x.shape[1:3])}: preprocess "
                     f"{t_pre:.3f}, forward+decode {t_fwd:.3f}, postprocess "
                     f"{t_post:.3f}")
    _, t_merge = timed(lambda: merge(merges[0][0], len(TTA_SIZES),
                                     det.iou_thres, device=det.device))
    parts.append(f"merge {t_merge:.3f}")
    print(f"w6-tta per image ms on {smi}: " + "; ".join(parts))
    conf_thres = det.conf_thres
    del det
    torch.cuda.empty_cache()
    stamp("path w6-tta done")
    return seq, conf_thres


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes a (n, 4) and b (m, 4)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    return inter / (area(a)[:, None] + area(b)[None, :] - inter + 1e-9)


def drive_tiled(smi: str, conf_thres: float) -> int:
    """Phase 5c: the w6 top scale tiled, through _run_tiled_batch. Returns
    the nms_keep launches of the counted run."""
    size = TTA_SIZES[-1]
    det = FaceDetector("yolov7-w6-face", img_sizes=TTA_SIZES,
                       use_api_preprocess=True, tile_top_scale=TILE_GRID,
                       tile_halo=TILE_HALO, tile_min_size=TILE_MIN,
                       max_candidates=MAX_CANDIDATES, seed=0, device="cuda")
    det.conf_thres = conf_thres
    plan = det._tile_plan(size)
    check(plan is not None and plan.tile == 2176 and plan.origins == (0, 1664)
          and det._tile_plan(TTA_SIZES[0]) is None,
          f"w6-tiled: tile plan {plan}")
    frames = tta_frames()
    # the API frames, built on the card, rounded to uint8 on the host
    inputs = []
    for frame in frames:
        x, geom = det.device_input(det.upload(frame[None]), size, auto=True)
        check(geom.out_hw == (size, size), f"w6-tiled: frame {geom.out_hw}")
        inputs.append(np.rint(x[0].cpu().numpy() * 255.0).clip(0, 255)
                      .astype(np.uint8))
        del x

    # the counted run, each postprocess and merge recorded
    posts, merges = [], []
    post, merge = det.postprocess, NMS.weighted_nms_merge

    def record_post(rows):
        dets = post(rows)
        posts.append((rows, dets))
        return dets

    def record_merge(merged, *args, **kwargs):
        keep = merge(merged, *args, **kwargs)
        merges.append(len(merged))
        return keep

    images = det.truncation_report()["images"]
    det.postprocess, NMS.weighted_nms_merge = record_post, record_merge
    K.nms_keep.launches = K.nms_keep.fixpoint_launches = 0
    E.fused_elan.launches = 0
    try:
        outs, t_first = timed(lambda: det._run_tiled_batch(inputs, plan))
    finally:
        del det.postprocess
        NMS.weighted_nms_merge = merge
    seq, fixpoint = K.nms_keep.launches, K.nms_keep.fixpoint_launches
    fused = E.fused_elan.launches
    check(len(posts) == 1 and posts[0][1].boxes.shape[0] == plan.n_tiles
          * TTA_FRAMES, "w6-tiled: not one engine call for every tile")
    rows, dets = posts[0]
    check(same_detections(dets, det.postprocess(rows.cpu())),
          "w6-tiled: the tile batch's Detections differ from the CPU "
          "postprocess")
    print(f"w6-tiled: tile batch rows {tuple(rows.shape)}, n_gated "
          f"{dets.n_gated.tolist()}, kept {dets.valid.sum(1).tolist()}; == "
          f"CPU postprocess")
    del rows
    tile_rows = NMS.detections_to_numpy(dets)
    n = plan.n_tiles
    owned = 0
    for i, out in enumerate(outs):
        want = tiling.assemble_rows(tile_rows[i * n:(i + 1) * n], plan,
                                    det.iou_thres, device="cpu")
        check(out.shape == want.shape and np.array_equal(out, want),
              f"w6-tiled: frame {i}'s card assemble_rows differs from the "
              f"CPU's")
        owned += len(want) > 0
        cx, cy = (out[:, 0] + out[:, 2]) / 2, (out[:, 1] + out[:, 3]) / 2
        check(out.shape[1] == 21 and bool(np.isfinite(out).all())
              and bool(((cx >= 0) & (cx < size) & (cy >= 0) & (cy < size))
                       .all()), f"w6-tiled: frame {i}: bad rows")
        print(f"w6-tiled: frame {i}: {len(out)} rows; == CPU "
              f"assemble_rows; centers inside the {size}^2 frame, boxes "
              f"span x [{out[:, 0].min():.1f}, {out[:, 2].max():.1f}], y "
              f"[{out[:, 1].min():.1f}, {out[:, 3].max():.1f}]")
    want_seq = 1 + owned
    check(len(merges) == owned, f"w6-tiled: {len(merges)} seam merges for "
                                f"{owned} frames with owned rows")
    check(seq == want_seq and fixpoint == 0 and fused == 0,
          f"w6-tiled: launches seq {seq}, fixpoint {fixpoint}, fused {fused};"
          f" want {want_seq}, 0, 0")
    grown = det.truncation_report()["images"] - images
    check(grown == TTA_FRAMES, f"w6-tiled: truncation_report images grew by "
                               f"{grown}, want {TTA_FRAMES}")
    print(f"w6-tiled: {TTA_FRAMES} frames of {size}^2, {n} tiles of "
          f"{plan.tile}^2 each (origins {plan.origins}), nms_keep launches "
          f"{seq} (1 engine call + {owned} seam merges of {merges} rows), "
          f"fixpoint {fixpoint}, fused_elan {fused}; first call "
          f"{t_first:.3f} ms; "
          f"truncation_report {det.truncation_report()}")

    # information: untiled rows that a tiled row matches
    for i, inp in enumerate(inputs):
        untiled = NMS.detections_to_numpy(det.run_network(inp[None]))[0]
        hit = (iou_matrix(untiled[:, :4], outs[i][:, :4]).max(1) >= 0.5
               if len(untiled) and len(outs[i]) else np.zeros(0, bool))
        print(f"w6-tiled: frame {i}: {int(hit.sum())} of {len(untiled)} "
              f"untiled rows have a tiled row at IoU >= 0.5 "
              f"({len(outs[i])} tiled rows)")

    # where a frame's time goes, medians of TIMING_ROUNDS
    tiles_dev = det.upload(np.concatenate([tiling.extract_tiles(inp, plan)
                                           for inp in inputs]))
    frame_dev = det.upload(inputs[0][None])
    geom = DP.letterbox_geometry(TTA_HW, size, auto=True, stride=det.stride)
    x_dev = DP.device_letterbox(det.upload(frames[:1]), geom)
    ms = {k: [] for k in ("call", "forward", "post", "assemble", "untiled",
                          "device")}
    for _ in range(TIMING_ROUNDS):
        ms["call"].append(timed(lambda: det._run_tiled_batch(inputs,
                                                             plan))[1])
        rows, t = timed(lambda: det.forward_rows(tiles_dev))
        ms["forward"].append(t)
        dets, t = timed(lambda: det.postprocess(rows))
        ms["post"].append(t)
        del rows
        tile_rows = NMS.detections_to_numpy(dets)
        ms["assemble"].append(timed(lambda: [tiling.assemble_rows(
            tile_rows[i * n:(i + 1) * n], plan, det.iou_thres,
            device=det.device) for i in range(TTA_FRAMES)])[1])
        ms["untiled"].append(timed(lambda: det.forward_rows(frame_dev))[1])
        ms["device"].append(timed(lambda: det.forward_input(x_dev))[1])
    med = {k: float(np.median(v)) for k, v in ms.items()}
    per = {k: med[k] / TTA_FRAMES for k in ("call", "forward", "post",
                                            "assemble")}
    print(f"w6-tiled per frame ms on {smi} (medians of {TIMING_ROUNDS}, host "
          f"clock, synchronized): tiled call {per['call']:.3f} (tile "
          f"forward+decode b{n * TTA_FRAMES}@{plan.tile}^2 "
          f"{med['forward']:.3f} / {TTA_FRAMES} = {per['forward']:.3f}, "
          f"postprocess {per['post']:.3f}, assemble_rows "
          f"{per['assemble']:.3f}); untiled "
          f"b1@{size}x{size} forward+decode {med['untiled']:.3f} (host "
          f"upload); b1@{geom.out_hw[0]}x{geom.out_hw[1]} device-preprocess "
          f"forward+decode {med['device']:.3f}; all rounds "
          f"{ {k: [round(t, 3) for t in v] for k, v in ms.items()} }")
    del det, tiles_dev, frame_dev, x_dev
    torch.cuda.empty_cache()
    stamp("path w6-tiled done")
    return seq


def capture_groups(det: FaceDetector, frames: np.ndarray):
    """The (x, weights, shape) that each fused_elan call of one forward
    receives."""
    calls = []
    real = FUSED.fused_elan

    def record(x, weights, shape):
        calls.append((x.clone(), weights, shape))
        return real(x, weights, shape)

    FUSED.fused_elan = record
    try:
        det.forward_rows(frames)
    finally:
        FUSED.fused_elan = real
    torch.cuda.synchronize()
    return calls


def elan_cost(x: torch.Tensor, weights, shape, out_hw):
    """(flops, bytes) the group must do and move: x, weights and out once;
    2 FLOPs per multiply-add of each conv over the group's output size."""
    b, (h, w) = x.shape[0], out_hw
    macs = 2 * shape.cin * shape.ccv + 9 * shape.ccv * shape.cch + \
        (shape.n_chain - 1) * 9 * shape.cch ** 2 + \
        shape.concat_width * shape.cout
    if shape.has_pre:
        macs += 9 * shape.pre_cin * shape.cin
    flops = 2 * b * h * w * macs
    nbytes = 4 * (x.numel() + sum(t.numel() for t in weights)
                  + b * shape.cout * h * w)
    return flops, nbytes


def unfused_group(model, blk, x):
    """The same group through the port's own unfused modules (cuDNN): the
    library yardstick of the fused kernel, never called by the port."""
    if blk.pre is not None:
        x = model.model[blk.pre](x)
    out = {blk.a: model.model[blk.a](x), blk.b: model.model[blk.b](x)}
    cur = out[blk.b]
    for c in blk.chain:
        cur = model.model[c](cur)
        out[c] = cur
    cat = model.model[blk.concat]([out[j] for j in
                                   model.spec.nodes[blk.concat].f])
    return model.model[blk.trans](cat)


@torch.inference_mode()
def check_groups(det: FaceDetector, frames: np.ndarray, smi: str,
                 timed: bool):
    """Phase 6 for one fused detector: each group's kernel vs plain on the
    captured inputs; with `timed`, the kernel, plain, library and bound
    times. Returns the worst abs and relative errors and the time sums."""
    calls = capture_groups(det, frames)
    check(len(calls) == len(det._elan_blocks),
          f"captured {len(calls)} groups, want {len(det._elan_blocks)}")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    worst_abs = worst_rel = 0.0
    sums = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "t_bytes": 0.0,
            "t_ops": 0.0, "t_simt": 0.0, "flops": 0.0}
    for blk, (x, ws, shape) in zip(det._elan_blocks, calls):
        # NaN in the block the allocator hands the kernel's output next,
        # so an output the kernel failed to write cannot pass
        h, w = x.shape[2] // shape.pre_stride, x.shape[3] // shape.pre_stride
        torch.full((x.shape[0], shape.cout, h, w), float("nan"),
                   device=x.device)
        got = E.fused_elan(x, ws, shape)
        with full_fp32():
            want = E.reference_elan(x, ws, shape)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f"fused_elan left non-finite values at nodes {blk.start}-"
              f"{blk.trans}")
        diff = float((got - want).abs().max())
        rel = diff / float(want.abs().max())
        worst_abs, worst_rel = max(worst_abs, diff), max(worst_rel, rel)
        plan = E.elan_plan(shape, x.shape[0], h, w, n_sm)
        share = E.recompute_share(shape, plan, h, w)
        line = (f"fused_elan nodes {blk.start}-{blk.trans} {shape.cin}->"
                f"{shape.ccv}/{shape.cch}x{shape.n_chain}->{shape.cout}"
                f"{' pre ' + str(shape.pre_cin) if shape.has_pre else ''} "
                f"at {x.shape[0]}x{h}x{w}, tile {plan['tile_h']}x"
                f"{plan['tile_w']} grid {plan['grid']} cluster "
                f"{plan['cluster']}, recompute "
                + " ".join(f"{c} {v:.3f}" for c, v in share.items())
                + f": max |diff| {diff:.3g}, / max |plain| {rel:.3g}")
        if timed:
            ms = cuda_ms(lambda: E.fused_elan(x, ws, shape), 3)
            with full_fp32():
                plain = cuda_ms(lambda: E.reference_elan(x, ws, shape), 3)
                lib = cuda_ms(lambda: unfused_group(det.model, blk, x), 3)
            flops, nbytes = elan_cost(x, ws, shape, (h, w))
            t_b = nbytes / HBM_BYTES_PER_S * 1e3
            t_o = flops / TF32X3_OPS_PER_S * 1e3
            t_s = flops / F32_OPS_PER_S * 1e3
            for key, v in (("ms", ms), ("plain_ms", plain),
                           ("library_ms", lib), ("t_bytes", t_b),
                           ("t_ops", t_o), ("t_simt", t_s), ("flops", flops)):
                sums[key] += v
            line += (f"; kernel {ms:.3f} ms ({flops / ms / 1e9:.2f} TFLOP/s "
                     f"effective), plain {plain:.3f} ms, library {lib:.3f} "
                     f"ms, bound {max(t_b, t_o):.4f} ms at 3xTF32 "
                     f"({max(t_b, t_s):.4f} at f32 SIMT; {flops / 1e9:.2f} "
                     f"GFLOP, {nbytes / 1e6:.1f} MB)")
        print(line)
        check(rel < ELAN_REL_TOL, f"fused_elan differs from reference_elan "
                                  f"by {rel:.3g} of max |plain| at nodes "
                                  f"{blk.start}-{blk.trans}")
    if timed:
        print(f"fused_elan {det.spec.name} b{BATCH}@{SIZE} on {smi}, sums "
              f"over {len(calls)} groups: kernel {sums['ms']:.3f} ms "
              f"({sums['flops'] / sums['ms'] / 1e9:.2f} TFLOP/s effective), "
              f"plain {sums['plain_ms']:.3f} ms, library "
              f"{sums['library_ms']:.3f} ms, bound "
              f"{max(sums['t_bytes'], sums['t_ops']):.4f} ms at 3xTF32 "
              f"(the kernels line's), "
              f"{max(sums['t_bytes'], sums['t_simt']):.4f} ms at f32 SIMT")
    return worst_abs, worst_rel, sums


def main() -> None:
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    # fused_elan.cu builds while the keep-mask phases and the unfused paths,
    # which do not need it, run
    pool = concurrent.futures.ThreadPoolExecutor(3)
    builds = start_builds(pool)
    built(builds, K)
    nms_stats, fixpoint_launches = check_kernel_cases()
    stamp("keep-mask cases done")
    built(builds, PM)
    probe_entries = check_probe(smi)
    stamp("probe_mm done")

    frames = {name: np.random.default_rng(seed).integers(
        0, 256, (REQUESTS, BATCH, SIZE, SIZE, 3), dtype=np.uint8)
        for name, seed in (("yolov7-w6-face", 0), ("yolov7-tiny-face", 1))}
    w6, tiny = "yolov7-w6-face", "yolov7-tiny-face"
    counts_w6, (boxes, valid, thr), ref_w6, _ = drive_path(
        w6, smi, 0, frames[w6])
    _, _, ref_tiny, _ = drive_path(tiny, smi, 1, frames[tiny], requests=2)
    tta_launches, tta_gate = drive_tta(smi)
    tiled_launches = drive_tiled(smi, tta_gate)
    built(builds, E)
    pool.shutdown()

    # phases 6-8: the fused paths, each group checked on its own inputs
    fused_launches, elan = 0, {"abs": 0.0, "rel": 0.0}
    elan_sums = None
    for name, seed, flag, requests, ref in (
            (w6, 0, True, REQUESTS, ref_w6), (w6, 0, "pre:", 2, ref_w6),
            (tiny, 1, True, REQUESTS, ref_tiny)):
        counts, _, _, det = drive_path(name, smi, seed, frames[name],
                                       fuse_elan=flag, requests=requests,
                                       ref=ref)
        if name == w6 and flag is True:
            fused_launches = counts["fused"]
        worst_abs, worst_rel, sums = check_groups(
            det, frames[name][0], smi, timed=flag is True)
        elan["abs"], elan["rel"] = max(elan["abs"], worst_abs), \
            max(elan["rel"], worst_rel)
        if name == w6 and flag is True:
            elan_sums = sums
        del det
        torch.cuda.empty_cache()
        stamp(f"groups of {name} fuse_elan={flag!r} checked")

    # the keep-mask kernels at the w6 path's own inputs
    keep = K.nms_keep(boxes, valid, thr)
    want = K.nms_keep_plain(boxes, valid, thr)
    entries = []
    bound_ms, bound_by = nms_bound(keep, valid)
    plain_ms = cuda_ms(lambda: K.nms_keep_plain(boxes, valid, thr), 5)
    for version, name, line, launches, iters in (
            ("seq", "nms_keep", 94, counts_w6["seq"], 20),
            ("fixpoint", "nms_keep_fixpoint", 35, fixpoint_launches, 20)):
        got = K.nms_keep(boxes, valid, thr, kernel_version=version)
        err = int((got.int() - want.int()).abs().max())
        check(err == 0, f"nms_keep[{version}] differs from its plain version "
                        f"on the w6 path's inputs")
        if version == "fixpoint":
            sweeps = K.nms_keep.last_fixpoint_sweeps
            check(torch.equal(sweeps, K.fixpoint_sweeps_plain(boxes, valid,
                                                              thr)),
                  "nms_keep[fixpoint]'s sweep counts differ from "
                  "fixpoint_sweeps_plain's on the w6 path's inputs")
        ms = cuda_ms(lambda: K.nms_keep(boxes, valid, thr,
                                        kernel_version=version), iters)
        worst, mismatches = nms_stats[version]
        entries.append({
            "name": name, "route": "cuda",
            "source": "face_detection_multi_scale_tpu_torch/csrc/nms_keep.cu",
            "replaces": f"face_detection_multi_scale_tpu/ops/pallas_nms.py:"
                        f"{line}",
            "launches": launches, "max_abs_err": max(worst, err),
            "mismatches": mismatches, "ms": ms, "plain_ms": plain_ms,
            # launches on the w6 TTA path; on the serving paths the
            # fixpoint kernel is checked to launch 0 times
            "tta_launches": tta_launches if version == "seq" else 0,
            "tiled_launches": tiled_launches if version == "seq" else 0,
            "serving_launches": counts_w6[version],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    b, k = valid.shape
    dense_ms = b * k * k / 2 * OPS_PER_IOU / F32_OPS_PER_S * 1e3
    # the seq kernel's two passes timed apart (the wrapper's launch helpers,
    # which count nothing)
    mask = torch.empty(K.mask_words(b, k), dtype=torch.int64,
                       device=boxes.device)
    scan_keep = torch.empty_like(keep)
    pass1 = cuda_ms(lambda: K.launch_mask(boxes, valid, thr, mask), 20)
    pass2 = cuda_ms(lambda: K.launch_scan(mask, valid, scan_keep), 20)
    check(torch.equal(scan_keep, want), "nms_keep's passes run apart differ "
                                        "from the plain version")
    entries[0].update(pass1_ms=pass1, pass2_ms=pass2, dense_bound_ms=dense_ms)
    # the fixpoint version's sweep kernel apart, in clusters of 8 and 16
    sweep_keep = torch.empty_like(keep)
    counts = torch.empty(b, dtype=torch.int32, device=boxes.device)
    by_cluster = {}
    for cluster in sorted({8, 16, K.FIXPOINT_CLUSTER}):
        by_cluster[cluster] = cuda_ms(lambda: K.launch_sweeps(
            mask, valid, sweep_keep, counts, cluster), 20)
        check(torch.equal(sweep_keep, want) and torch.equal(counts, sweeps),
              f"the fixpoint sweeps run apart in clusters of {cluster} "
              f"differ from the plain version")
    entries[1].update(
        sweeps=sweeps.tolist(), pass1_ms=pass1,
        sweep_ms=by_cluster[K.FIXPOINT_CLUSTER], cluster=K.FIXPOINT_CLUSTER,
        sweep_ms_by_cluster={str(c): by_cluster[c] for c in (8, 16)})
    print(f"nms_keep at the w6 path's inputs B={b} K={k}: kept "
          f"{int(keep.sum())}, seq {entries[0]['ms']:.4f} ms (pass 1 "
          f"{pass1:.4f}, pass 2 {pass2:.4f} apart), fixpoint "
          f"{entries[1]['ms']:.4f} ms (sweeps {sweeps.tolist()}; pass 1, "
          f"then the sweeps apart: {by_cluster[8]:.4f} ms in clusters of "
          f"8, {by_cluster[16]:.4f} in clusters of 16), plain "
          f"{plain_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms by {bound_by} (all K^2/2 pairs, what pass 1 "
          f"computes, would bound it at {dense_ms:.5f} ms)")
    s = elan_sums
    entries.append({
        "name": "fused_elan", "route": "cuda",
        "source": "face_detection_multi_scale_tpu_torch/csrc/fused_elan.cu",
        "replaces": "face_detection_multi_scale_tpu/ops/pallas_elan.py:194",
        "launches": fused_launches, "max_abs_err": elan["abs"],
        "max_rel_err": elan["rel"], "ms": s["ms"], "plain_ms": s["plain_ms"],
        "bound_ms": max(s["t_bytes"], s["t_ops"]),
        "bound_by": "operations" if s["t_ops"] >= s["t_bytes"] else "bytes",
        "bound_rate": "3xTF32: 495/3 = 165 TFLOP/s, 3.35 TB/s",
        "simt_bound_ms": max(s["t_bytes"], s["t_simt"]),
        "library_ms": s["library_ms"],
        "per": "sum over the 11 w6 groups of one b8@640 forward"})
    entries += probe_entries
    stamp("kernel times done")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
