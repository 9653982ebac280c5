#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py        # from the repository root, one card
    python3 chip_smoke.py --mesh-noise 8,9,10   # phase 26's float32
                                 # ratios alone, a JSON line a seed

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
  9. path w6-bf16: FaceDetector("yolov7-w6-face", dtype=torch.bfloat16)
     with phase 4's seeded weights and frames: its raws on 2 frames within
     5e-2 of max |f32 raw| per level of phase 4's card forward (each
     share printed); Detections equal to the CPU postprocess of the same
     rows; one nms_keep launch and no fused_elan launch a request; the
     request's ms (median of 4), img/s, forward+decode and postprocess ms
 10. paths w6-bf16-fused (fuse_elan True and "pre:") and tiny-bf16-fused:
     each group's bf16 kernel output on its own captured inputs within
     1e-2 of max |plain| of its bf16 reference_elan on the card (float32
     convs of the bf16 values, TF32 off); the fused raws within 5e-2 of
     max |raw| per level of phase 9's (w6) or of phase 5's float32 card
     forward (tiny); 11 and 8 bf16 launches a request, none of the f32
     kernel; the kernel's ms summed over the groups (CUDA events), the
     same groups' cuDNN bf16 modules' ms, the bound (FLOPs at 989 TFLOP/s
     bf16 against bytes at 3.35 TB/s) and the request ms
 11. paths w6-tta-bf16 and w6-tiled-bf16: phases 5b and 5c in bf16 (the
     device preprocess within 2/255 of the CPU's float32 one); then one
     torch.profiler pass over the b1@2176x3840 bf16 forward, which counts
     its cuBLAS GEMV launches (the products of cuDNN's FFT convolutions
     at batch 1 in float32)
 12. paths yolov7-face, yolov7s-face, yolov7-lite-t, yolov7-lite-s: phase
     4 for each of the other four zoo models at full width and depth
     (seeded weights, b8@640 noise frames, 2 requests): one nms_keep
     launch a request, no fixpoint or fused_elan launch; Detections equal
     to the CPU postprocess of the card's rows; the float32 forward (TF32
     off) within atol 5e-3 / rtol 1e-3 of a CPU forward on 2 frames; then
     hub.create("yolov7-lite-s") on the card with the lite-s path's seed
     and gate serves one request (one nms_keep launch) whose Detections
     equal the lite-s path's on the same frames
 13. the same four in bf16: raws within 5e-2 of max |f32 raw| per level
     of phase 12's card forward; Detections equal to the CPU postprocess
 14. fused paths of yolov7-face and yolov7s-face (fuse_elan True and
     "pre:", float32 then bf16): 8 launches of the dtype's kernel a
     request, none of the other; every group on its own captured inputs
     within 1e-5 (f32) or 1e-2 (bf16) of max |plain|; the fused rows
     within the phase 4 tolerance of the unfused card and CPU forwards
     (f32), the fused raws within 5e-2 of max |raw| per level of the
     unfused bf16 card forward (bf16); with True, the kernel's ms summed
     over the groups (CUDA events) beside the same groups' cuDNN modules,
     their plain version and the bound
 15. predict: FaceDetector("yolov7-w6-face") with phase 4's seeded
     weights, then hub.create("yolov7-lite-s"): det([a, b]) on two
     640x640 and det(c) on one 512x640 uint8 RGB array (already at the
     common rectangle, so no OpenCV): one nms_keep launch a call, nothing
     else; `s` the common rectangle; each image's rows equal to the CPU
     postprocess of the rows the card's engine saw (captured), through
     the same inverse letterbox; res.t and the call's ms printed
 16. non_max_suppression_from_raws: w6 b8@640 raws in the JAX conv layout
     (reshape_heads=False), float32 and bf16, K = 2048 (the JAX default);
     max_det = K; the gate and IoU threshold where no decision differs
     between the card's and the CPU's decoded values (`decisive_settings`:
     random weights put most conf values within ulps of one another, and
     the sigmoids differ by an ulp between the devices); one nms_keep
     launch; the CPU version on the same raws gives the same n_gated and
     valid counts and the same kept rows within atol 1e-3 / rtol 1e-5,
     and so does the card's decode + non_max_suppression; ms of both
     routes
 17. agnostic= and merge_nms_boxes: seeded nc = 3 rows at B = 8, N =
     25,500 through non_max_suppression(agnostic=False/True): one nms_keep
     launch each, Detections equal to the CPU's bit for bit; then
     merge_nms_boxes on phase 16's w6 Detections within 1e-5 of max |box|
     of the CPU
 18. forward_augment and forward_flip_test of the w6 model at b2@640:
     rows within phase 4's forward tolerance of the CPU's, then
     non_max_suppression (one nms_keep launch), Detections equal to the
     CPU postprocess of the card's rows
 19. EnsembleDetector((w6, tiny)) at b8@640, N = 50,700 rows: one nms_keep
     launch and no fused_elan launch a run_network; Detections equal to
     the CPU postprocess of the concatenated rows its NMS got
 20. int8 serving (W8A8): FaceDetector(name, quantize="int8",
     calib_images=<the request's frames>) for yolov7-w6-face, -tiny-face
     (phase 4/5's seeds and frames) and yolov7-lite-t (phase 12's) at
     b8@640: per request one qconv launch a conv of the int8 walk (the
     grouped ones on its direct path), one nms_keep launch, nothing else,
     and the plain conv never called; each conv's kernel output on its own
     captured inputs equal to qconv_plain's on the card, except at most 1
     apart where the plain pre-round value lies within 1e-4 of a half
     integer (their count printed); the walk with qconv_plain swapped in
     gives raws within 1e-2 of max |raw| per level; Detections equal to
     the CPU postprocess of the card's rows; printed, not gated: the int8
     raws against the float32 model's. The launches of a request by route
     (wgmma, split over a cluster, direct) equal what `qconv_plan` gives
     its convs (w6 106 of 107 on wgmma, tiny 54 of 55, lite-t 29 and 21
     direct, w6 splitting some), and each captured conv's launched plan
     (fdms_qconv_last_plan) equals `qconv_plan`'s. Times: the request
     (median, img/s), the wrapper's host time a conv, and summed over one
     forward's convs the kernel (CUDA events, and device time replayed
     from a CUDA graph, by route and by class: 3x3 on maps of 40 px and
     up, maps of 20 px and less), the mma route on the convs that take
     wgmma (the first kernel's design, in the same run), the wgmma route
     on the convs TMA takes that the route rule keeps on mma, the plain
     version, the bound (int8 operations at 1979 TOPS against x + w + out
     bytes at 3.35 TB/s, per conv the larger), torch._int_mm after an
     int8 im2col (the non-grouped convs) and cuDNN bf16 convs of the same
     shapes
 21. evaluation and production (w6 at full width, phase 4's seeded
     weights; launches counted per call, counters zeroed just before):
     (a) cli/test_widerface.write_buckets at the eval point (K = 16384,
     max_det 4096, B = 16), float32: the host route on two buckets of 16
     seeded frames already letterboxed (512x640 and 640x512, standing for
     frames twice their size: no OpenCV), the device route on 16 raw
     768x1024 frames (run_network_raw, letterboxed on the card to
     512x640); a gate at which the busiest frame gates 17,000 rows, so the
     truncation report shows truncated images; one nms_keep launch an
     engine call; on the first batch the kernel's keep mask on two images
     equal to nms_keep_plain's, their Detections equal to the CPU
     postprocess of their rows, the kernel, its passes apart and the plain
     version timed at B = 16, K = 16384 beside the bound (`nms_bound`:
     inputs and output once at 3.35 TB/s against the keeper pairs'
     operations at 67 TFLOP/s; the design's scratch, written and read,
     and all K^2/2 pairs' operations printed apart); every txt
     parsed back with read_pred_file to its count and its image's kept
     rows, the first two images' to the rows their Detections give; then
     eval.widerface.evaluation() on the written directory against seeded
     ground truth written with scipy.io.savemat, the same APs through the
     native IoU (native/, built with g++, required) and through numpy;
     the writer's ms a batch and img/s. (b) the same writer with
     --quantize semantics: one bucket at B = 16, calibrated on its first
     batch; every qconv launch equal to qconv_plain, every launched plan
     equal to qconv_plan's, the launches by route as planned. (c)
     infer/validate.validate at b8@640 (float32, unfused) over 16 seeded
     in-memory images and labels (a FaceDataset subclass here): one
     nms_keep launch a batch; P / R / mAP equal to the CPU postprocess
     and scoring of the card's decoded rows. (d) ProductionPipeline at
     the production defaults (640 + 3840, conf 0.6, IoU 0.3, API
     preprocessing, bf16 as cli/batch_predict, device preprocessing) on 2
     seeded 1080x1920 frames: detect_frame a frame, then the batched
     branch (detect_frames, its host API preprocess made on the card and
     rounded to uint8); one nms_keep launch a scale call and a merge;
     frames_to_json with the contract's tensors; ms a frame
 22. path train (yolov7-face at full width, the JAX CLI's default
     --model, seeded weights; float32 with TF32 off, then each part again
     in bf16 mixed precision, `YoloFace(spec, dtype=torch.bfloat16)` and
     `--dtype bfloat16`: float32 parameters, gradients, optimizer state,
     EMA and BN statistics, checked, and the bf16 loss within rtol 0.05
     of the float32 loss on the card; (b) prints bf16 beside float32):
     (a) one micro-step
     at b2@256 from the same state on the card and on the CPU in float32
     and on the CPU in float64 (the exact step), each compared in units
     of its tolerance (loss components rtol 5e-4, every parameter and EMA
     parameter after the SGD apply rtol 5e-3 / atol 5e-5, BN running
     statistics rtol 1e-4, means also atol 1e-6): the card's float32
     step within the tolerance of the exact one, or within twice the
     CPU's float32 step's distance from it (a random model's float32
     step is that ill-conditioned; train_step_parity); (b) b16@640 at nominal
     batch 64 (4 micro-steps an apply), 8 micro-steps from an in-memory
     non-augmenting FaceDataset through the DataLoader: the micro-step
     (forward + loss + backward) and apply by CUDA events (medians), img/s,
     the losses and torch.cuda.max_memory_allocated; (c)
     yolov7-tiny-face overfits one b2@128 batch in 120 steps (the last
     total loss under half the first, the box loss under 0.1); (d)
     cli/train.train_run for one epoch over in-memory sets: the
     epoch-end validate on the EMA model launches nms_keep once a
     validation batch and the fixpoint kernel never, `last` and `best`
     load back equal to the final state, and best_inference.npz, loaded
     by FaceDetector(torch_weights=), serves the EMA model's Detections
 23. export (w6 at full width, phase 4's seeded weights, frames and gate):
     (a) export_model.trace_program of the b8@640 inference function with
     its postprocess (decode, non_max_suppression at max_candidates 2048,
     max_det 300, iou 0.5) on the card, float32 (TF32 off) then bf16;
     saved to a .pt2, the in-memory program dropped, load_program; the
     graph holds exactly one fdms_torch.nms_keep node; each call of the
     loaded program launches nms_keep once (counters zeroed just before,
     read just after REQUESTS calls), the fixpoint and fused_elan kernels
     never; `valid` equal to the live card pipeline's (the same weights
     and dtype: the served model, decode, non_max_suppression at K =
     2048) and the other four fields exact or within phase 4's
     decoded-row tolerance (float32) or phase 9's bf16 share (which held
     is printed); export, save and load seconds, the artifact's bytes,
     and medians of 9 b8 requests of the loaded program and of the live
     pipeline, interleaved, synchronized. (b) w6 b1@640 exported with raw
     heads: the loaded program's maps on the card, native.dump_raw_heads,
     the port's fdms_detect app (g++) at a gate that 300-800 rows of the
     frame pass (no truncation on either side), iou 0.45, max_det 300:
     the same rows as the card's live Detections of the frame, boxes
     within 2e-2 and conf within 1e-4 (tests/test_native_app.py), each
     app row paired with the nearest card row (confs within ulps may
     swap); the app's ms a frame beside a bare process start. (c) phase 20's w6 int8 request still launches 107
     qconv (106 wgmma): the live int8 walk calls the wrapper, not the
     custom op; its ms printed beside PERF.md §5's 13.088
 24. extra blocks (models/layers_extra.py): the extra cfg
     tests/data/yolov7s-face-extra.json (yolov7s-face at full width with
     ConvFocus, MixConv2d, GhostConv, GhostBottleneck at s = 1 and 2,
     CrossConv, C3TR, SPPCSP, Contract / Expand, BottleneckCSP2 and
     BottleneckCSPF, a weighted Sum, and its 8 E-ELAN groups) through
     FaceDetector(spec) at b8@640 with phase 4's gate rule: (a) float32
     unfused, decoded rows within phase 4's tolerance of the CPU forward,
     Detections equal to the CPU postprocess of the card's rows, one
     nms_keep a request; (b) bf16, raws within 5e-2 of max |float32 raw|,
     Detections equal to the CPU postprocess of the card's bf16 rows;
     (c) fuse_elan=True in float32 and bf16, each group within phase 6's
     (10's) bound of its plain version, fused_elan launched 8 times a
     request; (d) quantize="int8" raises NotImplementedError naming
     ConvFocus; (e) each extra block, activation module, Classify and
     function alone on the card against its CPU output (atol 2e-4, rtol
     1e-3; C3TR on a 20 x 36 map); (f) one float32 train micro-step at
     b2@256, the card's step as close to the float64 one as twice the
     CPU's, its loss within 1e-3 of the CPU's; (g) model_info of w6 and
     of the extra cfg, the C3TR block's ms at b8@640 in float32 and bf16,
     the request ms of each path, and one unfused request of each dtype
     traced with utils/profiling.trace: its busy share and top kernels
 25. the data-parallel mesh (parallel/mesh.py), w6 at b8@640 on phase
     4's seed, frames and gate: (a) a world of one process over NCCL in
     this process: FaceDetector(mesh=make_data_mesh()) in float32, bf16,
     fuse_elan=True and int8 (calibrated on its first batch, its qparams
     broadcast; the mesh-less detector then serves the same qparams),
     each request's Detections equal bit for bit to the same detector's
     without a mesh, the same launches of every kernel, one nms_keep a
     call; (b) two spawned processes sharing the card in a gloo group
     (NCCL refuses two ranks on one device), 4 frames a rank (each rank
     makes phase 4's frames from its seed; their digest is checked
     against phase 4's): both ranks' Detections and gathered rows equal,
     the gathered rows within phase 4's tolerance of the one-process b8
     forward, the Detections equal to the CPU postprocess of the gathered
     rows, one nms_keep a rank
 26. in the same two processes: yolov7-face (full width, scratch.p6)
     trains at global b16@640 (8 rows a rank), 2 micro-steps of
     make_accum_steps(mesh=) and an apply, in float32 with TF32 off and
     in float64, against the one-process b16 step of the same dtype (rank
     0 runs the references first, in a process as fresh as the ranks'):
     in float64 the losses (rtol 1e-5), components (rtol 1e-5, atol
     1e-7), parameters (rtol 2e-3, atol 1e-4) and BN statistics (rtol
     1e-4, atol 1e-6) within those tolerances; in float32 the losses,
     components and BN statistics too, and each parameter tensor within
     them or, where float32 rounding alone parts the two steps by more
     (a random model's first convs: the one-process float32 step is
     itself beyond the tolerance of the exact one there), as near the
     exact float64 step in L2 as the one-process float32 step is, within
     a factor 2; parameters bit-identical across the ranks in both
     dtypes; a rank's first micro-step ms, then its traced micro-step,
     apply (the gradient all-reduce) and the window's busy share, beside
     the one-process step's times. Then cli/train.train_run for one
     epoch over the two ranks (global b2@256, nominal 4): rank 0's
     epoch-end validate
     launches nms_keep once a validation batch, rank 1 launches nothing,
     both ranks end bit-identical, and rank 0 alone wrote results.txt and
     the weights
 27. the spatial mesh (parallel/mesh.spatial_infer, parallel/spatial.py):
     phase 4's w6 (seed 0, BN folded) on noise frames at b1@3840^2 and
     b1@2176x3840, phase 4's gate, K = 4096. (a) A world of one over
     NCCL in this process, a 1x1 grid: in float32 (TF32 off) and bf16,
     rows bit-equal to the one-process forward and decode, no exchange,
     and with the NMS as the postprocess one nms_keep launch and the
     one-process Detections. (b) Four spawned processes sharing the card
     in a gloo group as a (2, 2) grid (rank 0 computes the one-process
     references first): float32 rows within rtol 1e-4 / atol 1e-4 of
     the one-process card rows (else, by how much, and held to phase 4's
     row tolerance), bf16 rows within 5e-2 of the largest value of each
     field of the one-process bf16 rows (the share printed); with the NMS
     as the postprocess, Detections equal across ranks and to the CPU
     postprocess of the gathered rows, one nms_keep a rank a call. (c)
     The same processes as a (4, 1) grid over 2176 x 3840 (544-px rows,
     not a multiple of 64), float32. Per grid: a rank's call ms (host
     clock; four processes sharing one card, not a multi-card speed),
     its busy share (its own device time inside the call, torch.profiler)
     and its exchanges and halo bytes a call
 28. the examples (examples/*_torch.py) and the weights fetch: each
     example's `run(device="cuda")` counted and timed (host clock; the
     demo and detect_simple after a warm-up call, the exported program
     after the settings' forward at its shapes), then the same `run` on
     the CPU with the same
     seeded frames (640x640 for tiny, 256x256 for lite-t: the host
     letterbox then needs no OpenCV), noisy seeded weights saved as .pt
     and thresholds from `decisive_settings` over every network input of
     the example (at most 32 gated rows): (a) demo_torch, tiny at
     (640, 1280) with the API chain on the device, single-scale and
     multi-scale rows within atol 5e-3 / rtol 1e-3 of the CPU run's, one
     nms_keep an engine call and one for the merge; (b)
     detect_simple_torch, tiny at 640, one nms_keep; (c)
     exported_inference_torch, lite-t's .pt2 at 256 exported on the card,
     loaded and called once (one nms_keep), its rows against the CPU
     run's, and the ONNX consumer on the host runner keeping what the CPU
     run's keeps; (d) FaceDetector(torch_weights=<missing>.pt) fetching
     the file from a local release through `download_url` on a file://
     URL, its Detections equal to those of a detector loaded from the
     local file
 29. one JSON line with every kernel's launches, error, times and bound;
     for nms_keep_fixpoint also its sweeps at the w6 path's inputs and
     its two launches timed apart, with the sweeps in clusters of 8 and
     of 16 blocks; fused_elan_bf16 beside fused_elan; `launches` sums
     every counted path's run, `launches_by_path` splits it,
     `api_launches` holds phases 15-19's counted calls and
     `phase21_launches` phase 21's and `train_launches` phase 22's
     and `export_launches` phase 23's (nms_keep's `launches` includes
     them all), `export` phase 23's numbers, `train_timed` phase 22(b)'s
     numbers by dtype;
     nms_keep's `eval_*` fields hold the eval point (B = 16, K = 16384):
     `eval_bound_ms` is `nms_bound`'s, `eval_scratch_ms` the scratch's
     bytes at 3.35 TB/s, and `eval_launches` its launches there; qconv's `eval_launches` the
     int8 eval's launches by route; the fused entries' `by_model` hold
     the yolov7-face and yolov7s-face group sums; nms_keep's `extra` holds
     phase 24's numbers, its `mesh_launches` phases 25-26's calls (every
     rank's; they are in every kernel's `launches` and
     `launches_by_path`) and `mesh` their seconds, train tolerance
     ratios and the ranks' busy shares; its `spatial_launches` phase
     27's calls with the NMS (every rank's; in its `launches`) and
     `spatial` each grid's numbers; its `example_launches` phase 28's
     counted calls (in its `launches`) and `examples` their host-clock
     ms
 30. the last line: {"ok": true, "device": {...}}

Kernel times are CUDA-event averages after warm-up. bound_ms is the larger
of bytes / 3.35 TB/s and operations / the peak of the arithmetic the kernel
does (H100 SXM, dense): 67 TFLOP/s f32 without tensor cores for nms_keep;
495 / 3 = 165 TFLOP/s for fused_elan, whose f32-accurate products are three
TF32 tensor-core products a multiply-add (3xTF32; the 67 TFLOP/s SIMT bound
is printed beside it); 989 TFLOP/s bf16 for probe_mm and the bf16
fused_elan; 1979 TOPS int8 for qconv. Operations count what this run's data needs (`nms_bound`,
`elan_cost`, `probe_mm.cost`).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import json
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from face_detection_multi_scale_tpu_torch import export_model as EXPORT
from face_detection_multi_scale_tpu_torch import native as NAT
from face_detection_multi_scale_tpu_torch.cli import test_widerface as TW
from face_detection_multi_scale_tpu_torch.cli import train as TRAIN_CLI
from face_detection_multi_scale_tpu_torch.data import dataset as DS
from face_detection_multi_scale_tpu_torch.data import letterbox as LB
from face_detection_multi_scale_tpu_torch.eval import widerface as WF
from face_detection_multi_scale_tpu_torch.infer import augment as AUG
from face_detection_multi_scale_tpu_torch.infer import device_preprocess as DP
from face_detection_multi_scale_tpu_torch.infer import ensemble as ENS
from face_detection_multi_scale_tpu_torch.infer import production as PROD
from face_detection_multi_scale_tpu_torch.infer import validate as VAL
from face_detection_multi_scale_tpu_torch.infer import tiling
from face_detection_multi_scale_tpu_torch import hub
from face_detection_multi_scale_tpu_torch.infer.detector import (
    FaceDetector, full_fp32)
from face_detection_multi_scale_tpu_torch.infer.results import Detections
from face_detection_multi_scale_tpu_torch.models import fused as FUSED
from face_detection_multi_scale_tpu_torch.models import layers_extra as LX
from face_detection_multi_scale_tpu_torch.models import quant as QUANT
from face_detection_multi_scale_tpu_torch.models import zoo
from face_detection_multi_scale_tpu_torch.models.model import (
    YoloFace, cast_model, init_weights)
from face_detection_multi_scale_tpu_torch.models.head import (
    decode, reshape_level)
from face_detection_multi_scale_tpu_torch.models.spec import (
    spec_from_yolo_yaml)
from face_detection_multi_scale_tpu_torch.ops.boxes import box_iou
from face_detection_multi_scale_tpu_torch.ops import elan_kernel as E
from face_detection_multi_scale_tpu_torch.ops import nms as NMS
from face_detection_multi_scale_tpu_torch.ops import nms_kernel as K
from face_detection_multi_scale_tpu_torch.ops import qconv_kernel as QK
from face_detection_multi_scale_tpu_torch.parallel import mesh as PMESH
from face_detection_multi_scale_tpu_torch.tools import probe_mm as PM
from face_detection_multi_scale_tpu_torch.tools import qconv_ab as QAB
from face_detection_multi_scale_tpu_torch.train import checkpoint as CKPT
from face_detection_multi_scale_tpu_torch.train import loss as TLOSS
from face_detection_multi_scale_tpu_torch.train import trainer as TR
from face_detection_multi_scale_tpu_torch.train.hyp import HYP_SCRATCH_P6
from face_detection_multi_scale_tpu_torch.train.targets import (
    build_targets_batched)
from face_detection_multi_scale_tpu_torch.tools.forward_format_ab import (
    kernel_profile)
from face_detection_multi_scale_tpu_torch.utils import profiling as PROF

# the helpers that the port's tests share with this script
sys.path.append(str(Path(__file__).resolve().parent / "tests"))
from torch_shared import (  # noqa: E402
    MESH_BN_TOL, MESH_LOSS_RTOL, MESH_PARAM_TOL, MemoryFaces, face_labels,
    memory_faces, step_ratios, tolerance_ratio)

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32X3_OPS_PER_S = 495e12 / 3  # 3xTF32: three TF32 products a multiply-add
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
OPS_PER_IOU = 12  # 4 min/max, 2 sub, 2 clamp, mul, add, sub, div (+ compare)
BATCH = 8
REQUESTS = 4
SIZE = 640
MAX_CANDIDATES = 4096  # the serving default; w6@640 has N = 25,500 rows
ROW_TOL = dict(atol=5e-3, rtol=1e-3)
ELAN_REL_TOL = 1e-5
BF16_ELAN_REL_TOL = 1e-2  # a few bf16 roundings (2^-8 each) apart
BF16_RAW_SHARE = 5e-2     # bf16 raws against float32 ones, per level
BF16_PIXEL_TOL = 2 / 255  # bf16 preprocess: its roundings of [0, 255]
GROUPS = {"yolov7-w6-face": 11, "yolov7-tiny-face": 8, "yolov7-face": 8,
          "yolov7s-face": 8, "yolov7-lite-t": 0, "yolov7-lite-s": 0}
NEW_MODELS = (("yolov7-face", 3), ("yolov7s-face", 4), ("yolov7-lite-t", 5),
              ("yolov7-lite-s", 6))  # (zoo name, seed of weights and frames)
NEW_REQUESTS = 2
# each counted path's run: {tag: {"seq": n, "fixpoint": n, "fused": n}},
# and its median request ms (host clock, synchronized)
PATH_LAUNCHES = {}
PATH_MS = {}
PROBE_CELLS, PROBE_ITERS = 512, 6  # the JAX tool's defaults
TTA_SIZES = (640, 3840)  # the JAX FaceDetector's default pyramid
TTA_FRAMES, TTA_HW = 2, (1080, 1920)  # video frames of the production pipeline
TILE_GRID, TILE_HALO, TILE_MIN = 2, 256, 2048  # the JAX tiling example
TIMING_ROUNDS = 3
API_K = 2048  # max_candidates of phases 15-19 (JAX from_raws' default)
API_ROUNDS = 3  # timed repeats of each phase 15-19 call (host clock)
MERGE_REL_TOL = 1e-5  # merge_nms_boxes card vs CPU, of max |box|
# raws -> Detections card vs CPU: the sigmoids differ by ulps, so boxes
# (up to ~1000 px through (2 sigmoid)^2 * anchor) by ~1e-4 px at most
RAWS_TOL = dict(atol=1e-3, rtol=1e-5)
# each counted call of phases 15-19: {tag: {"seq": n, "fixpoint": n,
# "fused": n}}
API_LAUNCHES = {}
# phase 20: (zoo name, seed of weights and frames); w6 and tiny take
# phases 4/5's, lite-t phase 12's
INT8_MODELS = (("yolov7-w6-face", 0), ("yolov7-tiny-face", 1),
               ("yolov7-lite-t", 5))
INT8_REQUESTS = 2
INT8_RAW_SHARE = 1e-2  # kernel walk against the plain-conv walk, per level
# a request's qconv launches on the wgmma route (all the rest: the stem on
# mma; lite-t also 7 ragged and 5 short-K convs on mma, 21 depthwise on
# direct)
INT8_WGMMA = {"yolov7-w6-face": 106, "yolov7-tiny-face": 54,
              "yolov7-lite-t": 29}
HALF_TOL = 1e-4
# phase 21: the WIDER writer at the eval point of cli/test_widerface.py
# (its defaults: K = 16384, max_det 4096, batches of 16), its host route
# on two letterboxed buckets (multiples of w6's stride 64) of frames
# letterboxed from twice their size, its device route on raw frames
EVAL_K, EVAL_DET, EVAL_BATCH = 16384, 4096, 16
EVAL_BUCKETS = ((512, 640), (640, 512))
EVAL_RAW_HW = (768, 1024)  # letterboxed on the card to 512 x 640
EVAL_GATED = 17000  # rows the busiest frame of the gate's batch gates
VAL_IMAGES, VAL_BATCH = 16, 8
# each counted call of phase 21: {tag: nms_keep launches}
EVAL_LAUNCHES = {}
# phase 22: single-card training of the JAX CLI's default --model
TRAIN_MODEL = "yolov7-face"
PARITY_SIZE, PARITY_BATCH = 256, 2            # (a) one micro-step, card/CPU
TIMED_SIZE, TIMED_BATCH, TIMED_NOMINAL = 640, 16, 64  # (b) 4 micro-steps
TIMED_STEPS = 8                                       # an apply
LEARN_MODEL, LEARN_SIZE, LEARN_BATCH, LEARN_STEPS = (
    "yolov7-tiny-face", 128, 2, 120)          # (c) tests/test_training_learns
EPOCH_SIZE, EPOCH_TRAIN, EPOCH_VAL, EPOCH_VAL_BATCH = 256, 4, 16, 8  # (d)
# card against CPU after one train step (tests/test_trainer_lockstep.py's
# parameter bounds); a running mean moves by 0.03 x a batch mean, and a
# mean near 0 is also held absolutely (0.03 x the forwards' ~3e-5)
TRAIN_LOSS_RTOL = 5e-4
TRAIN_PARAM_TOL = dict(rtol=5e-3, atol=5e-5)
TRAIN_BN_RTOL, TRAIN_BN_MEAN_ATOL = 1e-4, 1e-6
# phase 22's counted calls: {tag: nms_keep launches}
TRAIN_LAUNCHES = {}
# bf16 training (22, bf16 parts): its loss against the float32 step's
# (tests/test_train_features.py::test_bf16_mixed_precision_train_step)
TRAIN_BF16_LOSS_RTOL = 0.05
# phase 23: export. The JAX export's NMS capacity; timed rounds of the
# loaded program against the live pipeline; the raw-heads frame's gated
# rows for the native app (a band, the gate in its widest gap)
EXPORT_K = EXPORT.MAX_CANDIDATES
EXPORT_ROUNDS = 9
APP_GATED = (300, 800)
APP_IOU, APP_MAX_DET = 0.45, 300  # tests/test_native_app.py's
APP_BOX_ATOL, APP_CONF_ATOL = 2e-2, 1e-4
INT8_W6_RECORDED_MS = 13.088  # the w6 int8 request in PERF.md §5's table
# phase 23's counted program calls: {tag: nms_keep launches}
EXPORT_LAUNCHES = {}
# phase 24: the extra cfg, its seed (weights and frames) and requests; a
# block alone on the card against the CPU at the raw-map tolerance; the
# train step's loss card against CPU
EXTRA_NAME = "yolov7s-face-extra"
EXTRA_CFG = Path(__file__).resolve().parent / "tests" / "data" / \
    f"{EXTRA_NAME}.json"
EXTRA_OPS = {"ConvFocus", "MixConv2d", "GhostConv", "GhostBottleneck",
             "CrossConv", "C3TR", "SPPCSP", "Contract", "Expand",
             "BottleneckCSP2", "BottleneckCSPF", "Sum"}
EXTRA_SEED, EXTRA_REQUESTS = 8, 2
EXTRA_BLOCK_TOL = dict(atol=2e-4, rtol=1e-3)
EXTRA_STEP_LOSS_RTOL = 1e-3
DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
CONTRACT_TENSORS = {
    "yolo-face-bboxes", "yolo-face-confidence", "yolo-face-class_names",
    "yolo-face-class_indexes", "yolo-face-class_groups",
    "yolo-face-scale_used", "yolo-face-ckpt_version",
    "yolo-face-infer_time", "yolo-face-total_time"}
ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()


def stamp(what: str) -> None:
    """The seconds since the imports, after `what`."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {what}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def zero_counters() -> None:
    """Every kernel wrapper's launch counts to 0."""
    K.nms_keep.launches = K.nms_keep.fixpoint_launches = 0
    E.fused_elan.launches = E.fused_elan.bf16_launches = 0
    QK.qconv.launches = QK.qconv.depthwise_launches = 0
    QK.qconv.wgmma_launches = QK.qconv.split_launches = 0
    PMESH.spatial_infer.calls = PMESH.spatial_infer.exchanges = 0
    PMESH.spatial_infer.halo_bytes = 0


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() over `iters` runs, by CUDA events, after
    `warmup` warm-up runs."""
    for _ in range(warmup):
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

    return {mod: pool.submit(timed, mod) for mod in (K, PM, E, QK)}


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


def raw_share(got, want, what: str) -> None:
    """Per level max |got - want| / max |want| of raw maps, printed; fatal
    beyond BF16_RAW_SHARE."""
    shares = [float((g.float() - w.float()).abs().max() / w.float().abs()
                    .max()) for g, w in zip(got, want)]
    print(f"{what}: raws off by {[f'{s:.4g}' for s in shares]} of max "
          f"|raw| per level (bound {BF16_RAW_SHARE})")
    check(len(got) == len(want) and all(
        g.shape == w.shape and bool(torch.isfinite(g).all())
        for g, w in zip(got, want)), f"{what}: bad raws")
    check(max(shares) < BF16_RAW_SHARE, f"{what}: raws beyond "
                                        f"{BF16_RAW_SHARE} of max |raw|")


def card_raws(det: FaceDetector, frames: np.ndarray):
    """The detector's raw maps of uint8 frames, on the host as float32."""
    x = torch.as_tensor(frames).to(det.device).to(det.dtype) / 255.0
    return [r.float().cpu() for r in det._forward(x)]


def set_gate(det: FaceDetector, batch: np.ndarray) -> None:
    """A gate low enough that the busiest frame of `batch` overfills the
    detector's K: random weights put conf near 1e-3 at stride 8 and near
    0.25 on the rows that the reference's anchor-major view fills from the
    kpt conv."""
    rows = det.forward_rows(batch)
    conf = (rows[..., 4] * rows[..., 5]).sort(dim=1, descending=True)[0]
    det.conf_thres = float(conf[:, 3 * det.max_candidates // 2].max())


def drive_path(name: str, smi: str, seed: int, frames: np.ndarray,
               fuse_elan=False, requests=None, ref=None,
               dtype=torch.float32, ref_raws=None, spec_fn=None):
    """Phases 4/5/7/8/12/14 for one zoo model, and 9/10/13/14 in bf16;
    phase 24 for the extra cfg, whose spec `spec_fn()` makes (`name` is
    then its tag and GROUPS key). `ref` holds the
    unfused phase's card and CPU rows on 2 frames; without it the CPU
    forward is run here (float32 only). In bf16 the raws on 2 frames are
    held against `ref_raws` (label, raws) instead. Returns (the launch
    counts of the requests: seq, fixpoint and fused, the keep mask's
    inputs from the first request, the rows on 2 frames: card and CPU
    (None in bf16), the detector, its raws on 2 frames)."""
    bf16 = dtype == torch.bfloat16
    tag = name + (" bf16" if bf16 else "") + \
        (f" fuse_elan={fuse_elan!r}" if fuse_elan else "")
    requests = requests or REQUESTS
    model = spec_fn() if spec_fn else name
    det = FaceDetector(model, img_sizes=(SIZE,), conf_thres=0.5,
                       iou_thres=0.5, max_candidates=MAX_CANDIDATES,
                       seed=seed, fuse_elan=fuse_elan, dtype=dtype,
                       device="cuda")
    set_gate(det, frames[0])
    det.warmup(SIZE, BATCH)

    zero_counters()
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
    launches = K.nms_keep.launches
    fused, other = ((E.fused_elan.bf16_launches, E.fused_elan.launches)
                    if bf16 else
                    (E.fused_elan.launches, E.fused_elan.bf16_launches))
    fixpoint = K.nms_keep.fixpoint_launches
    check(launches == requests, f"{tag}: nms_keep launched {launches} "
                                f"times for {requests} engine calls")
    check(fixpoint == 0, f"{tag}: the fixpoint keep-mask kernel launched "
                         f"{fixpoint} times; serving runs the seq kernel")
    want_fused = GROUPS[name] * requests if fuse_elan else 0
    check(fused == want_fused and other == 0,
          f"{tag}: fused_elan launched {fused} times in this dtype and "
          f"{other} in the other for {requests} engine calls, want "
          f"{want_fused} and 0")
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
    PATH_MS[tag] = float(np.median(ms))
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

    raws = card_raws(det, frames[0][:2])
    if bf16:
        # a bf16 network against a float32 (or another bf16) one
        rows_card = rows_cpu = None
        for label, want in ref_raws:
            raw_share(raws, want, f"{tag}: vs {label}")
    else:
        # the card's float32 forward vs a CPU forward with the same weights
        rows_card = det.forward_rows(frames[0][:2]).cpu()
        if ref is None:
            cpu = FaceDetector(spec_fn() if spec_fn else name,
                               img_sizes=(SIZE,), seed=seed, device="cpu")
            rows_cpu = cpu.forward_rows(frames[0][:2])
        else:
            rows_unfused, rows_cpu = ref
            rows_within(rows_card, rows_unfused, f"{tag}: vs the unfused "
                                                 f"card forward")
        rows_within(rows_card, rows_cpu, f"{tag}: card vs CPU forward")

    _, _, _, nms_boxes, valid, _, _ = NMS._gather_candidates_planar(
        rows, nc=det.spec.nc, conf_thres=det.conf_thres,
        k=min(det.max_candidates, rows.shape[1]))
    stamp(f"path {tag} done")
    counts = {"seq": launches, "fixpoint": fixpoint, "fused": fused}
    PATH_LAUNCHES[tag] = counts
    return (counts, (nms_boxes.float().contiguous(), valid, det.iou_thres),
            (rows_card, rows_cpu), det, raws)


def seeded_frames(seed: int, shape=None) -> np.ndarray:
    """Phase 4's noise frames of a path's seed: (REQUESTS, BATCH, SIZE,
    SIZE, 3) uint8 unless `shape` says otherwise. A spawned rank makes its
    own from the seed (phases 25b-26)."""
    shape = (REQUESTS, BATCH, SIZE, SIZE, 3) if shape is None else shape
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


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


def drive_tta(smi: str, dtype=torch.float32):
    """Phase 5b (and in bf16 the first half of 11): the w6 TTA pyramid
    through detect_multi_scale with device preprocessing; in bf16 also
    one torch.profiler pass of the top scale's b1 forward. Returns the
    nms_keep launches of the counted run and the gate."""
    bf16 = dtype == torch.bfloat16
    tag = "w6-tta" + ("-bf16" if bf16 else "")
    det = FaceDetector("yolov7-w6-face", img_sizes=TTA_SIZES,
                       max_candidates=MAX_CANDIDATES, seed=0,
                       use_device_preprocess=True, dtype=dtype,
                       device="cuda")
    frames = tta_frames()
    raw = det.upload(frames[:1])
    # the gate of phase 4: the small scale gates 1.5 K rows of frame 0
    x, _ = det.device_input(raw, TTA_SIZES[0], auto=True)
    rows = det.forward_input(x)
    conf = (rows[..., 4] * rows[..., 5]).sort(dim=1, descending=True)[0]
    det.conf_thres = float(conf[0, 3 * MAX_CANDIDATES // 2])
    # bf16: against the CPU's float32 preprocess, within bf16's roundings
    tol = BF16_PIXEL_TOL if bf16 else 1e-5
    for size in TTA_SIZES:
        x, geom = det.device_input(raw, size, auto=True)
        want = DP.device_letterbox(torch.from_numpy(frames[:1]), geom)
        err = float((x.float().cpu() - want).abs().max())
        print(f"{tag}: device preprocess {TTA_HW} -> {geom.out_hw} at "
              f"{size}: card vs CPU max |diff| {err:.3g}")
        check(x.shape[1:3] == geom.out_hw and x.dtype == dtype
              and err <= tol,
              f"{tag}: device preprocess at {size} differs from the CPU")
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
    zero_counters()
    outs, ms = [], []
    try:
        for frame in frames:
            t0 = time.perf_counter()
            out, shape = det.detect_multi_scale(frame)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
            check(shape == frame.shape, f"{tag}: img0_shape {shape}")
    finally:
        del det.postprocess
        NMS.weighted_nms_merge = merge
    seq, fixpoint = K.nms_keep.launches, K.nms_keep.fixpoint_launches
    fused = E.fused_elan.launches + E.fused_elan.bf16_launches
    print(f"{tag}: {TTA_FRAMES} frames, nms_keep launches {seq}, fixpoint "
          f"{fixpoint}, fused_elan {fused}; detect_multi_scale ms per image "
          f"{[round(m, 3) for m in ms]} (host clock, synchronized)")
    want_seq = (len(TTA_SIZES) + 1) * TTA_FRAMES  # every scale + the merge
    check(seq == want_seq and fixpoint == 0 and fused == 0,
          f"{tag}: launches seq {seq}, fixpoint {fixpoint}, fused {fused}; "
          f"want {want_seq}, 0, 0")
    check(len(posts) == len(TTA_SIZES) * TTA_FRAMES
          and len(merges) == TTA_FRAMES, f"{tag}: calls not recorded")
    for i, (rows, dets) in enumerate(posts):
        check(same_detections(dets, det.postprocess(rows.cpu())),
              f"{tag}: card Detections of call {i} differ from the CPU "
              f"postprocess")
        print(f"{tag}: scale {TTA_SIZES[i % len(TTA_SIZES)]} rows "
              f"{tuple(rows.shape)}, n_gated {dets.n_gated.tolist()}, kept "
              f"{int(dets.valid.sum())}; == CPU postprocess")
    for merged, keep in merges:
        want = merge(merged, len(TTA_SIZES), det.iou_thres, device="cpu")
        check(np.array_equal(keep, want), f"{tag}: the merge's keep indices "
                                          f"differ from the CPU merge's")
        print(f"{tag}: merge of {len(merged)} rows kept {len(keep)}; == CPU "
              f"merge")
    h, w = TTA_HW
    for out in outs:
        check(out.shape[1] == 7 and len(out) > 0
              and bool(np.isfinite(out).all())
              and bool((out[:, [0, 2]] >= 0).all() and (out[:, [0, 2]] <= w)
                       .all() and (out[:, [1, 3]] >= 0).all()
                       and (out[:, [1, 3]] <= h).all())
              and set(out[:, 6].tolist()) <= {0, 1}, f"{tag}: bad output")
    print(f"{tag}: {[len(o) for o in outs]} final detections; "
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
    print(f"{tag} per image ms on {smi}: " + "; ".join(parts))
    if bf16:
        # x: the top scale's b1 input; do cuDNN's batch-1 FFT convolutions
        # (and their cuBLAS GEMV products) run in bf16 too?
        fwd = [timed(lambda: det.forward_input(x))[1]
               for _ in range(TIMING_ROUNDS)]
        prof = kernel_profile(lambda: det.forward_input(x))
        print(f"{tag}: b1@{x.shape[1]}x{x.shape[2]} forward+decode "
              f"{np.median(fwd):.3f} ms (median of {TIMING_ROUNDS}: "
              f"{[round(t, 3) for t in fwd]}); under "
              f"torch.profiler: wall {prof['wall_ms']:.3f} ms, kernels "
              f"{prof['kernel_ms']:.3f} ms in {prof['launches']} launches, "
              f"of which {prof['gemv_launches']} cuBLAS GEMV launches "
              f"({prof['gemv_ms']:.3f} ms); top "
              + "; ".join(f"{k['name'][:50]} {k['ms']:.2f} ms x"
                          f"{k['launches']}" for k in prof["top"][:5]))
    conf_thres = det.conf_thres
    del det, x
    torch.cuda.empty_cache()
    stamp(f"path {tag} done")
    return seq, conf_thres


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes a (n, 4) and b (m, 4)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    return inter / (area(a)[:, None] + area(b)[None, :] - inter + 1e-9)


def drive_tiled(smi: str, conf_thres: float, dtype=torch.float32) -> int:
    """Phase 5c (and in bf16 the second half of 11): the w6 top scale
    tiled, through _run_tiled_batch. Returns the nms_keep launches of the
    counted run."""
    tag = "w6-tiled" + ("-bf16" if dtype == torch.bfloat16 else "")
    size = TTA_SIZES[-1]
    det = FaceDetector("yolov7-w6-face", img_sizes=TTA_SIZES,
                       use_api_preprocess=True, tile_top_scale=TILE_GRID,
                       tile_halo=TILE_HALO, tile_min_size=TILE_MIN,
                       max_candidates=MAX_CANDIDATES, seed=0, dtype=dtype,
                       device="cuda")
    det.conf_thres = conf_thres
    plan = det._tile_plan(size)
    check(plan is not None and plan.tile == 2176 and plan.origins == (0, 1664)
          and det._tile_plan(TTA_SIZES[0]) is None,
          f"{tag}: tile plan {plan}")
    frames = tta_frames()
    # the API frames, built on the card, rounded to uint8 on the host
    inputs = []
    for frame in frames:
        x, geom = det.device_input(det.upload(frame[None]), size, auto=True)
        check(geom.out_hw == (size, size), f"{tag}: frame {geom.out_hw}")
        inputs.append(np.rint(x[0].float().cpu().numpy() * 255.0)
                      .clip(0, 255).astype(np.uint8))
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
    zero_counters()
    try:
        outs, t_first = timed(lambda: det._run_tiled_batch(inputs, plan))
    finally:
        del det.postprocess
        NMS.weighted_nms_merge = merge
    seq, fixpoint = K.nms_keep.launches, K.nms_keep.fixpoint_launches
    fused = E.fused_elan.launches + E.fused_elan.bf16_launches
    check(len(posts) == 1 and posts[0][1].boxes.shape[0] == plan.n_tiles
          * TTA_FRAMES, f"{tag}: not one engine call for every tile")
    rows, dets = posts[0]
    check(same_detections(dets, det.postprocess(rows.cpu())),
          f"{tag}: the tile batch's Detections differ from the CPU "
          f"postprocess")
    print(f"{tag}: tile batch rows {tuple(rows.shape)}, n_gated "
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
              f"{tag}: frame {i}'s card assemble_rows differs from the "
              f"CPU's")
        owned += len(want) > 0
        cx, cy = (out[:, 0] + out[:, 2]) / 2, (out[:, 1] + out[:, 3]) / 2
        check(out.shape[1] == 21 and bool(np.isfinite(out).all())
              and bool(((cx >= 0) & (cx < size) & (cy >= 0) & (cy < size))
                       .all()), f"{tag}: frame {i}: bad rows")
        print(f"{tag}: frame {i}: {len(out)} rows; == CPU "
              f"assemble_rows; centers inside the {size}^2 frame, boxes "
              f"span x [{out[:, 0].min():.1f}, {out[:, 2].max():.1f}], y "
              f"[{out[:, 1].min():.1f}, {out[:, 3].max():.1f}]")
    want_seq = 1 + owned
    check(len(merges) == owned, f"{tag}: {len(merges)} seam merges for "
                                f"{owned} frames with owned rows")
    check(seq == want_seq and fixpoint == 0 and fused == 0,
          f"{tag}: launches seq {seq}, fixpoint {fixpoint}, fused {fused};"
          f" want {want_seq}, 0, 0")
    grown = det.truncation_report()["images"] - images
    check(grown == TTA_FRAMES, f"{tag}: truncation_report images grew by "
                               f"{grown}, want {TTA_FRAMES}")
    print(f"{tag}: {TTA_FRAMES} frames of {size}^2, {n} tiles of "
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
        print(f"{tag}: frame {i}: {int(hit.sum())} of {len(untiled)} "
              f"untiled rows have a tiled row at IoU >= 0.5 "
              f"({len(outs[i])} tiled rows)")

    # where a frame's time goes, medians of TIMING_ROUNDS
    tiles_dev = det.upload(np.concatenate([tiling.extract_tiles(inp, plan)
                                           for inp in inputs]))
    frame_dev = det.upload(inputs[0][None])
    geom = DP.letterbox_geometry(TTA_HW, size, auto=True, stride=det.stride)
    x_dev = DP.device_letterbox(det.upload(frames[:1]), geom, dtype=dtype)
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
    print(f"{tag} per frame ms on {smi} (medians of {TIMING_ROUNDS}, host "
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
    stamp(f"path {tag} done")
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
    """(flops, bytes) the group must do and move: x, weights and out once
    (each in its own element size: bf16 x, kernels and out, float32
    biases in the bf16 form); 2 FLOPs per multiply-add of each conv over
    the group's output size."""
    b, (h, w) = x.shape[0], out_hw
    macs = 2 * shape.cin * shape.ccv + 9 * shape.ccv * shape.cch + \
        (shape.n_chain - 1) * 9 * shape.cch ** 2 + \
        shape.concat_width * shape.cout
    if shape.has_pre:
        macs += 9 * shape.pre_cin * shape.cin
    flops = 2 * b * h * w * macs
    nbytes = sum(t.numel() * t.element_size() for t in (x, *weights)) + \
        b * shape.cout * h * w * x.element_size()
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
    """Phase 6 (and 10 in bf16) for one fused detector: each group's
    kernel vs plain on the captured inputs; with `timed`, the kernel,
    plain, library and bound times. Returns the worst abs and relative
    errors and the time sums."""
    bf16 = det.dtype == torch.bfloat16
    tol, rate, rate_name = ((BF16_ELAN_REL_TOL, BF16_OPS_PER_S, "bf16")
                            if bf16 else
                            (ELAN_REL_TOL, TF32X3_OPS_PER_S, "3xTF32"))
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
                   dtype=x.dtype, device=x.device)
        got = E.fused_elan(x, ws, shape)
        with full_fp32():
            want = E.reference_elan(x, ws, shape)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()) and got.dtype == x.dtype,
              f"fused_elan left non-finite values at nodes {blk.start}-"
              f"{blk.trans}")
        diff = float((got.float() - want.float()).abs().max())
        rel = diff / float(want.float().abs().max())
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
            t_o = flops / rate * 1e3
            t_s = flops / F32_OPS_PER_S * 1e3
            for key, v in (("ms", ms), ("plain_ms", plain),
                           ("library_ms", lib), ("t_bytes", t_b),
                           ("t_ops", t_o), ("t_simt", t_s), ("flops", flops)):
                sums[key] += v
            line += (f"; kernel {ms:.3f} ms ({flops / ms / 1e9:.2f} TFLOP/s "
                     f"effective), plain {plain:.3f} ms, library {lib:.3f} "
                     f"ms, bound {max(t_b, t_o):.4f} ms at {rate_name} "
                     f"({max(t_b, t_s):.4f} at f32 SIMT; {flops / 1e9:.2f} "
                     f"GFLOP, {nbytes / 1e6:.1f} MB)")
        print(("bf16 " if bf16 else "") + line)
        check(rel < tol, f"fused_elan differs from reference_elan by "
                         f"{rel:.3g} of max |plain| at nodes "
                         f"{blk.start}-{blk.trans} ({x.dtype})")
    if timed:
        print(f"fused_elan {x.dtype} {det.spec.name} b{BATCH}@{SIZE} on "
              f"{smi}, sums over {len(calls)} groups: kernel "
              f"{sums['ms']:.3f} ms ({sums['flops'] / sums['ms'] / 1e9:.2f} "
              f"TFLOP/s effective), plain {sums['plain_ms']:.3f} ms, library "
              f"{sums['library_ms']:.3f} ms, bound "
              f"{max(sums['t_bytes'], sums['t_ops']):.4f} ms at {rate_name} "
              f"(the kernels line's; bytes {sums['t_bytes']:.4f}), "
              f"{max(sums['t_bytes'], sums['t_simt']):.4f} ms at f32 SIMT")
    return worst_abs, worst_rel, sums


def drive_new_models(smi: str):
    """Phases 12-14: the other four zoo models, unfused in float32 and
    bf16, hub.create on the card, and the fused paths of the two with
    E-ELAN groups. Returns the worst group errors and the timed group sums
    per (model, dtype)."""
    bf16 = torch.bfloat16
    frames = {name: np.random.default_rng(seed).integers(
        0, 256, (NEW_REQUESTS, BATCH, SIZE, SIZE, 3), dtype=np.uint8)
        for name, seed in NEW_MODELS}
    refs, raws32, raws_bf = {}, {}, {}
    # phase 12: float32, unfused; then hub.create beside the lite-s path
    for name, seed in NEW_MODELS:
        _, _, refs[name], det, raws32[name] = drive_path(
            name, smi, seed, frames[name], requests=NEW_REQUESTS)
        if name == "yolov7-lite-s":
            hub_det = hub.create(name, img_sizes=(SIZE,),
                                 conf_thres=det.conf_thres,
                                 iou_thres=det.iou_thres,
                                 max_candidates=MAX_CANDIDATES, seed=seed)
            check(hub_det.device.type == "cuda" and hub_det.spec.name == name,
                  "hub.create: not the lite-s model on the card")
            zero_counters()
            got = hub_det.run_network(frames[name][0])
            torch.cuda.synchronize()
            counts = {"seq": K.nms_keep.launches,
                      "fixpoint": K.nms_keep.fixpoint_launches,
                      "fused": E.fused_elan.launches
                      + E.fused_elan.bf16_launches}
            PATH_LAUNCHES["hub.create(yolov7-lite-s)"] = counts
            check(counts == {"seq": 1, "fixpoint": 0, "fused": 0},
                  f"hub.create(yolov7-lite-s): launches {counts}, want one "
                  f"nms_keep and nothing else")
            want = det.run_network(frames[name][0])
            check(same_detections(got, want), "hub.create(yolov7-lite-s)'s "
                  "Detections differ from the lite-s path's")
            print(f"hub.create({name!r}) on {smi}: one request, kept per "
                  f"image {got.valid.sum(1).cpu().tolist()}, launches "
                  f"{counts}; Detections == the {name} path's")
            del hub_det
        del det
        torch.cuda.empty_cache()
    # phase 13: bf16, unfused, against phase 12's float32 card raws
    for name, seed in NEW_MODELS:
        *_, det, raws_bf[name] = drive_path(
            name, smi, seed, frames[name], requests=NEW_REQUESTS, dtype=bf16,
            ref_raws=[("the float32 card forward", raws32[name])])
        del det
        torch.cuda.empty_cache()
    # phase 14: the fused paths, each group checked on its own inputs
    worst = {torch.float32: [0.0, 0.0], bf16: [0.0, 0.0]}
    sums = {}
    for dtype in (torch.float32, bf16):
        for name, seed in NEW_MODELS:
            if not GROUPS[name]:
                continue
            for flag in (True, "pre:"):
                ref_raws = [("the bf16 unfused card forward", raws_bf[name])]
                *_, det, _ = drive_path(
                    name, smi, seed, frames[name], fuse_elan=flag,
                    requests=NEW_REQUESTS, dtype=dtype,
                    ref=refs[name] if dtype == torch.float32 else None,
                    ref_raws=ref_raws)
                w_abs, w_rel, group_sums = check_groups(
                    det, frames[name][0], smi, timed=flag is True)
                worst[dtype] = [max(worst[dtype][0], w_abs),
                                max(worst[dtype][1], w_rel)]
                if flag is True:
                    sums[(name, dtype)] = group_sums
                del det
                torch.cuda.empty_cache()
                stamp(f"groups of {name} {dtype} fuse_elan={flag!r} "
                      f"checked")
    return worst, sums


# ---------------------------------------------------------------------------
# phases 15-19: the inference API (predict, the other NMS entry points,
# augment, the ensemble)
# ---------------------------------------------------------------------------

def counted(tag: str, fn):
    """fn() with every launch counter zeroed just before and read just
    after; the counts go into API_LAUNCHES[tag]. Returns (fn(), its
    host-clock ms)."""
    zero_counters()
    out, ms = timed(fn)
    API_LAUNCHES[tag] = {"seq": K.nms_keep.launches,
                         "fixpoint": K.nms_keep.fixpoint_launches,
                         "fused": E.fused_elan.launches
                         + E.fused_elan.bf16_launches}
    return out, ms


def check_launches(tag: str, seq: int) -> None:
    got = API_LAUNCHES[tag]
    check(got == {"seq": seq, "fixpoint": 0, "fused": 0},
          f"{tag}: launches {got}, want {seq} nms_keep and nothing else")


def match_rows(got: np.ndarray, want: np.ndarray, tol: dict, what: str):
    """Equal row counts, then each card row paired with the nearest CPU
    row (box and score), one to one, within `tol`; returns the worst
    |diff|."""
    check(got.shape == want.shape, f"{what}: rows {got.shape} against "
                                   f"{want.shape}")
    if not len(got):
        return 0.0
    pair = np.abs(got[:, None, :5] - want[None, :, :5]).max(-1).argmin(1)
    check(len(set(pair.tolist())) == len(pair), f"{what}: rows pair up "
                                                f"twice")
    err = np.abs(got - want[pair])
    check(bool(np.isfinite(got).all()) and bool(
        (err <= tol["atol"] + tol["rtol"] * np.abs(want[pair])).all()),
        f"{what}: rows beyond {tol}, max |diff| {err.max():.3g}")
    return float(err.max())


def conv_to_levels(raws, spec):
    """Conv-layout raws (B, ny, nx, na*no) -> the (B, na, ny, nx, no)
    levels `decode` takes."""
    return [reshape_level(r.permute(0, 3, 1, 2), spec.na, spec.no)
            for r in raws]


def decisive_settings(rows_card: torch.Tensor, rows_cpu: torch.Tensor,
                      k: int):
    """(conf_thres, iou_thres) at which the card's and the CPU's decoded
    rows (B, N, no) of the same raws, whose sigmoids differ by an ulp on
    some rows, make every decision of the postprocess alike:

    - the gate is a midpoint of a gap of the UNION of both devices' conf
      values, so no row is gated on one device only; it gates at most K
      rows of any image, so no top-K cut decides;
    - the IoU threshold is the midpoint of the widest gap in [0.4, 0.6] of
      the union of both devices' IoUs over the gated pairs, so no
      suppression test differs;
    - the greedy scan depends on the order only between candidates that
      suppress one another, and random weights put many conf values
      within ulps of each other: the gate is the lowest at which every
      such pair is ordered alike on both devices (stable descending
      sorts). Fewer gated rows keep that, so a binary search finds it.

    With max_det >= K the kept candidates are then the same on both
    devices."""
    dev = rows_card.device
    rows_cpu = rows_cpu.to(dev)
    conf = [(r[..., 4] * r[..., 5]).float() for r in (rows_card, rows_cpu)]
    xyxy = [torch.cat([r[..., :2] - r[..., 2:4] / 2,
                       r[..., :2] + r[..., 2:4] / 2], -1).float()
            for r in (rows_card, rows_cpu)]
    u = torch.cat([c.flatten() for c in conf]).unique().double()
    mid = ((u[:-1] + u[1:]) / 2).float()
    cands = mid[(mid.double() > u[:-1]) & (mid.double() < u[1:])].flip(0)
    asc = conf[1].sort(dim=1)[0]
    busiest = torch.stack([asc.shape[1] - torch.searchsorted(
        a.contiguous(), cands, right=True) for a in asc]).amax(0)
    last = int((busiest <= k).nonzero().max())  # the lowest gate <= K rows
    ious = []
    gated = conf[1] > float(cands[last])
    for xy in xyxy:
        for b in range(len(xy)):
            iou = box_iou(xy[b][gated[b]], xy[b][gated[b]])
            ious.append(iou[(iou > 0.4) & (iou < 0.6)].double())
    band = torch.cat(ious + [torch.tensor([0.4, 0.6], dtype=torch.float64,
                                          device=dev)]).unique()
    g = int(torch.diff(band).argmax())
    iou_thres = float((band[g] + band[g + 1]) / 2)

    def alike(t: float) -> bool:
        for b in range(len(conf[0])):
            sel = conf[1][b] > t
            pos = []
            for c in conf:
                order = torch.sort(c[b][sel], descending=True,
                                   stable=True)[1]
                p = torch.empty_like(order)
                p[order] = torch.arange(len(order), device=dev)
                pos.append(p)
            clash = box_iou(xyxy[1][b][sel], xyxy[1][b][sel]) > iou_thres
            before = [p[:, None] < p[None, :] for p in pos]
            if bool((clash & (before[0] != before[1])).any()):
                return False
        return True

    good, bad = 0, last + 1  # cands[good] keeps the order, cands[bad] not
    check(alike(float(cands[0])), "the top conf values already order "
                                  "clashing candidates differently")
    if alike(float(cands[last])):
        good = last
    while bad - good > 1:
        m = (good + bad) // 2
        good, bad = (m, bad) if alike(float(cands[m])) else (good, m)
    return float(cands[good]), iou_thres


def check_predict(det: FaceDetector, tag: str, smi: str, seed: int) -> None:
    """Phase 15 for one detector: det([a, b]) on two 640x640 RGB arrays
    and det(c) on one 512x640 array (already at the common rectangle, so
    no OpenCV), each one counted call; the rows in each image's frame
    equal to the CPU postprocess of the rows the card's engine saw, put
    through the same inverse letterbox; `s` as the common rectangle."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    c = rng.integers(0, 256, (SIZE * 4 // 5, SIZE, 3), dtype=np.uint8)
    set_gate(det, np.stack([a, b]))
    det.predict([a, b], size=SIZE)  # warm-up
    for batch, want_s in (([a, b], (2, SIZE, SIZE, 3)),
                          (c, (1, SIZE * 4 // 5, SIZE, 3))):
        seen = []
        post = det.postprocess
        det.postprocess = lambda rows: seen.append(rows) or post(rows)
        try:
            call = f"{tag} predict {want_s[0]}x{want_s[1]}x{want_s[2]}"
            res, ms = counted(call, lambda: det(batch, size=SIZE))
        finally:
            del det.postprocess
        check_launches(call, 1)
        check(isinstance(res, Detections) and res.s == want_s
              and len(res) == want_s[0], f"{call}: s {res.s}, want "
                                         f"{want_s}")
        want = NMS.detections_to_numpy(det.postprocess(seen[0].cpu()))
        kept = []
        for got, w in zip(res.pred, want):
            w = w[:, :6].astype(np.float64)
            if len(w):
                LB.scale_coords(want_s[1:3], w[:, :4], want_s[1:3])
            check(np.array_equal(got, w), f"{call}: rows differ from the "
                                          f"CPU postprocess")
            kept.append(len(got))
        times = [timed(lambda: det(batch, size=SIZE))[1]
                 for _ in range(API_ROUNDS)]
        print(f"{call} on {smi}: kept {kept}, t (pre, inference, NMS ms "
              f"an image) {[round(t, 3) for t in res.t]}, call ms "
              f"{[round(ms, 3)] + [round(t, 3) for t in times]}, nms_keep "
              f"launches {API_LAUNCHES[call]['seq']}; rows == CPU "
              f"postprocess")


def drive_predict(smi: str) -> None:
    """Phase 15: predict on w6 and on hub.create("yolov7-lite-s")."""
    det = FaceDetector("yolov7-w6-face", img_sizes=(SIZE,), iou_thres=0.5,
                       max_candidates=API_K, seed=0, device="cuda")
    check_predict(det, "w6", smi, seed=20)
    del det
    hub_det = hub.create("yolov7-lite-s", max_candidates=API_K, seed=6)
    check(hub_det.device.type == "cuda", "hub.create: not on the card")
    check_predict(hub_det, "hub.create(yolov7-lite-s)", smi, seed=21)
    del hub_det
    torch.cuda.empty_cache()
    stamp("phase 15 (predict) done")


def drive_from_raws(smi: str, batch: np.ndarray):
    """Phase 16: w6 b8@640 conv-layout raws (reshape_heads=False) in
    float32 and bf16 through non_max_suppression_from_raws on the card
    (max_det = K), against the same function on the same raws on the CPU
    (same n_gated and valid counts, the same kept candidates within
    RAWS_TOL) and against the card's decode + non_max_suppression at the
    same K, under `decisive_settings`. Returns the w6 float32 Detections
    of decode + non_max_suppression, the candidates they came from and the
    IoU threshold, for phase 17."""
    out = None
    for dtype in (torch.float32, torch.bfloat16):
        tag = "w6" + (" bf16" if dtype == torch.bfloat16 else "")
        det = FaceDetector("yolov7-w6-face", img_sizes=(SIZE,),
                           max_candidates=API_K, seed=0, dtype=dtype,
                           device="cuda")
        spec = det.spec
        x = torch.as_tensor(batch).cuda().to(dtype) / 255.0
        raws = det._forward(x, reshape_heads=False)
        check([tuple(r.shape) for r in raws] == [
            (BATCH, SIZE // s, SIZE // s, spec.na * spec.no)
            for s in spec.strides], f"{tag}: conv-layout raw shapes")
        raws_cpu = [r.cpu() for r in raws]
        with torch.inference_mode():
            rows = decode(conv_to_levels(raws, spec), spec)
            rows_cpu = decode(conv_to_levels(raws_cpu, spec), spec)
        conf, iou = decisive_settings(rows, rows_cpu, API_K)
        run = lambda: NMS.non_max_suppression_from_raws(  # noqa: E731
            raws, spec, conf, iou, max_candidates=API_K, max_det=API_K)
        run()  # warm-up
        call = f"{tag} non_max_suppression_from_raws"
        got, ms = counted(call, run)
        check_launches(call, 1)
        want = NMS.non_max_suppression_from_raws(
            raws_cpu, spec, conf, iou, max_candidates=API_K, max_det=API_K)
        std_run = lambda: NMS.non_max_suppression(  # noqa: E731
            rows, conf, iou, nc=spec.nc, max_candidates=API_K,
            max_det=API_K)
        std = std_run()
        worst = {}
        for label, ref in (("CPU", want), ("decode + non_max_suppression",
                                           std)):
            check(torch.equal(got.n_gated.cpu(), ref.n_gated.cpu())
                  and torch.equal(got.valid.sum(1).cpu(),
                                  ref.valid.sum(1).cpu()),
                  f"{call}: n_gated / valid counts differ from the {label}'s")
            worst[label] = max(
                match_rows(g, w, RAWS_TOL, f"{call} vs {label}")
                for g, w in zip(NMS.detections_to_numpy(got),
                                NMS.detections_to_numpy(ref)))
        ms_raws = sorted(timed(run)[1] for _ in range(API_ROUNDS))
        ms_std = sorted(timed(std_run)[1] for _ in range(API_ROUNDS))
        ms_dec = sorted(timed(lambda: decode(conv_to_levels(raws, spec),
                                             spec))[1]
                        for _ in range(API_ROUNDS))
        print(f"{call} b{BATCH}@{SIZE} K={API_K} on {smi}: conf_thres "
              f"{conf:.9g}, iou_thres {iou:.9g}, n_gated "
              f"{got.n_gated.tolist()}, kept {got.valid.sum(1).tolist()}; "
              f"max |diff| vs the CPU {worst['CPU']:.3g}, vs decode + "
              f"non_max_suppression "
              f"{worst['decode + non_max_suppression']:.3g} (bound "
              f"{RAWS_TOL}); ms {[round(t, 3) for t in [ms] + ms_raws]} "
              f"against decode {ms_dec[1]:.3f} + non_max_suppression "
              f"{ms_std[1]:.3f} (medians of {API_ROUNDS}); nms_keep "
              f"launches {API_LAUNCHES[call]['seq']}")
        if dtype == torch.float32:
            cand = NMS._gather_candidates_planar(rows, nc=spec.nc,
                                                 conf_thres=conf, k=API_K)
            out = (std, cand, iou)
        del det, raws, rows
        torch.cuda.empty_cache()
    stamp("phase 16 (non_max_suppression_from_raws) done")
    return out


def drive_agnostic_merge(smi: str, w6_dets) -> None:
    """Phase 17: seeded nc = 3 decoded rows at B = 8, N = 25,500 through
    non_max_suppression(agnostic=False/True) on the card, each equal to
    the CPU's bit for bit; then merge_nms_boxes on phase 16's w6
    Detections and their gated top-K candidates, within MERGE_REL_TOL of
    max |box| of the CPU."""
    rng = np.random.default_rng(30)
    n = 25500
    centers = rng.uniform(0, SIZE, (BATCH, 64, 2))
    cxy = np.take_along_axis(centers, rng.integers(0, 64, (BATCH, n, 1)),
                             1) + rng.normal(0, 12, (BATCH, n, 2))
    pred = np.concatenate([cxy, rng.uniform(8, 120, (BATCH, n, 2)),
                           rng.uniform(0, 1, (BATCH, n, 4)),
                           rng.uniform(0, SIZE, (BATCH, n, 15))], -1)
    pred = torch.from_numpy(pred.astype(np.float32))
    pred_card = pred.cuda()
    for agnostic in (False, True):
        run = lambda: NMS.non_max_suppression(  # noqa: E731
            pred_card, 0.3, 0.45, nc=3, max_candidates=API_K,
            agnostic=agnostic)
        run()
        call = f"nc=3 non_max_suppression agnostic={agnostic}"
        got, ms = counted(call, run)
        check_launches(call, 1)
        want = NMS.non_max_suppression(pred, 0.3, 0.45, nc=3,
                                       max_candidates=API_K,
                                       agnostic=agnostic)
        check(same_detections(got, want), f"{call}: card Detections "
                                          f"differ from the CPU's")
        times = [timed(run)[1] for _ in range(API_ROUNDS)]
        print(f"{call} b{BATCH} N={n} K={API_K} on {smi}: kept "
              f"{got.valid.sum(1).tolist()}, n_gated "
              f"{got.n_gated.tolist()}, ms "
              f"{[round(t, 3) for t in [ms] + times]}"
              f"; Detections == CPU, bit for bit")
    dets, (boxes, conf, _, _, valid, _, _), iou = w6_dets
    all_conf = torch.where(valid, conf, torch.zeros_like(conf))
    merged, ms = timed(lambda: NMS.merge_nms_boxes(dets, boxes, all_conf,
                                                   iou))
    want = NMS.merge_nms_boxes(NMS.Detections(*(
        t.cpu() for t in dets[:5]), dets.n_gated.cpu()), boxes.cpu(),
        all_conf.cpu(), iou)
    scale = float(want.boxes.abs().max())
    err = float((merged.boxes.cpu() - want.boxes).abs().max())
    check(bool(torch.isfinite(merged.boxes).all())
          and err <= MERGE_REL_TOL * scale,
          f"merge_nms_boxes: card off the CPU by {err:.3g}, beyond "
          f"{MERGE_REL_TOL} of max |box| {scale:.4g}")
    print(f"merge_nms_boxes on the w6 Detections (B={BATCH}, max_det "
          f"{dets.boxes.shape[1]}, K={boxes.shape[1]}) on {smi}: max |diff| "
          f"{err:.3g} ({err / scale:.3g} of max |box|), {ms:.3f} ms")
    stamp("phase 17 (agnostic=, merge_nms_boxes) done")


def drive_augment(smi: str, frames: np.ndarray) -> None:
    """Phase 18: forward_augment and forward_flip_test of the w6 model at
    b2@640 on the card, their rows within phase 4's forward tolerance of
    the CPU's; then non_max_suppression of the card's rows (one counted
    keep-mask launch), equal to the CPU postprocess of those rows."""
    det = FaceDetector("yolov7-w6-face", img_sizes=(SIZE,),
                       max_candidates=API_K, seed=0, device="cuda")
    cpu = FaceDetector("yolov7-w6-face", img_sizes=(SIZE,), seed=0,
                       device="cpu")
    x = torch.as_tensor(frames[:2]).float() / 255.0
    for name, fn in (("forward_augment", AUG.forward_augment),
                     ("forward_flip_test", AUG.forward_flip_test)):
        fn(det.model, x.cuda())  # warm-up
        rows, ms = timed(lambda: fn(det.model, x.cuda()))
        rows_within(rows.cpu(), fn(cpu.model, x), f"w6 {name} b2@{SIZE}: "
                                                  f"card vs CPU")
        conf = (rows[..., 4] * rows[..., 5]).sort(dim=1, descending=True)[0]
        thr = float(conf[:, 3 * API_K // 2].max())
        call = f"w6 {name} + non_max_suppression"
        dets, nms_ms = counted(call, lambda: NMS.non_max_suppression(
            rows, thr, 0.5, max_candidates=API_K))
        check_launches(call, 1)
        check(same_detections(dets, NMS.non_max_suppression(
            rows.cpu(), thr, 0.5, max_candidates=API_K)),
            f"{call}: card Detections differ from the CPU postprocess")
        print(f"w6 {name} b2@{SIZE} on {smi}: rows {tuple(rows.shape)}, "
              f"{ms:.3f} ms, then non_max_suppression {nms_ms:.3f} ms "
              f"(conf_thres {thr:.6g}, kept {dets.valid.sum(1).tolist()}, "
              f"nms_keep launches {API_LAUNCHES[call]['seq']}); Detections "
              f"== CPU postprocess")
    del det, cpu
    torch.cuda.empty_cache()
    stamp("phase 18 (forward_augment, forward_flip_test) done")


def drive_ensemble(smi: str, frames: np.ndarray) -> None:
    """Phase 19: EnsembleDetector over (w6, tiny) at b8@640: one counted
    run_network (N = 50,700 rows, one keep-mask launch, no fused_elan),
    its Detections equal to the CPU postprocess of the concatenated rows
    the card's NMS got (captured)."""
    members = [FaceDetector(name, img_sizes=(SIZE,), max_candidates=API_K,
                            seed=seed, device="cuda")
               for name, seed in (("yolov7-w6-face", 0),
                                  ("yolov7-tiny-face", 1))]
    set_gate(members[0], frames)
    ens = ENS.EnsembleDetector(members)
    ens.run_network(frames)  # warm-up
    seen = []
    nms = ENS.NMS.non_max_suppression
    ENS.NMS.non_max_suppression = lambda pred, *a, **kw: (
        seen.append(pred) or nms(pred, *a, **kw))
    try:
        call = "ensemble(w6, tiny) run_network"
        got, ms = counted(call, lambda: ens.run_network(frames))
    finally:
        ENS.NMS.non_max_suppression = nms
    check_launches(call, 1)
    rows = seen[0]
    check(tuple(rows.shape[:2]) == (BATCH, 25500 + 25200),
          f"{call}: rows {tuple(rows.shape)}, want N = 50,700")
    want = NMS.non_max_suppression(rows.cpu(), ens.conf_thres,
                                   ens.iou_thres, nc=ens.spec.nc,
                                   max_candidates=API_K)
    check(same_detections(got, want), f"{call}: card Detections differ "
                                      f"from the CPU postprocess")
    times = [timed(lambda: ens.run_network(frames))[1]
             for _ in range(API_ROUNDS)]
    print(f"{call} b{BATCH}@{SIZE} on {smi}: N = {rows.shape[1]}, n_gated "
          f"{got.n_gated.tolist()}, kept {got.valid.sum(1).tolist()}, ms "
          f"{[round(t, 3) for t in [ms] + times]}, nms_keep launches "
          f"{API_LAUNCHES[call]['seq']}; Detections == CPU postprocess")
    del ens, members
    torch.cuda.empty_cache()
    stamp("phase 19 (EnsembleDetector) done")


# ---------------------------------------------------------------------------
# phase 20: int8 serving
# ---------------------------------------------------------------------------

def capture_qconvs(det: FaceDetector, x: torch.Tensor):
    """The raws of one int8 forward of `x` and the arguments of each
    qconv call in it (the path's own inputs)."""
    calls = []
    real = QUANT.qconv

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    QUANT.qconv = record
    try:
        raws = det._forward(x)
    finally:
        QUANT.qconv = real
    torch.cuda.synchronize()
    return raws, calls


def im2col_int8(x: torch.Tensor, w: torch.Tensor, stride: int, pads):
    """(A, B) of the int8 GEMM of a non-grouped conv: A (M, K') the im2col
    of NHWC x, B (K', N') column-major, K' and N' padded with zeros to
    multiples of 8 (torch._int_mm's rule); a 1x1 stride-1 conv needs no
    im2col."""
    b, h, wd, c = x.shape
    cout, kh, kw, _ = w.shape
    ho, wo = QK.out_hw(h, wd, (kh, kw), stride, pads)
    k = kh * kw * c
    kp, np_ = -(-k // 8) * 8, -(-cout // 8) * 8
    if (kh, kw, stride) == (1, 1, 1) and kp == k:
        a = x.reshape(-1, c)
    else:
        xp = torch.nn.functional.pad(x, (0, 0, pads[1], pads[1], pads[0],
                                         pads[0]))
        cols = [xp[:, dy:dy + stride * (ho - 1) + 1:stride,
                   dx:dx + stride * (wo - 1) + 1:stride]
                for dy in range(kh) for dx in range(kw)]
        if kp > k:
            cols.append(torch.zeros((b, ho, wo, kp - k), dtype=x.dtype,
                                    device=x.device))
        a = torch.cat(cols, -1).reshape(-1, kp)
    bmat = torch.zeros((np_, kp), dtype=w.dtype, device=w.device)
    bmat[:cout, :k] = w.reshape(cout, k)
    return a, bmat.t()


def library_int_mm(x, w, stride, pads):
    """The yardstick: an int8 im2col, then torch._int_mm (int32 out, no
    requant)."""
    a, bmat = im2col_int8(x, w, stride, pads)
    return torch._int_mm(a, bmat)


def qconv_class(w: torch.Tensor, ho: int) -> str:
    """The conv classes of the kernel's table: 3x3 on maps of 40 px and
    up, maps of 20 px and less, the rest."""
    if w.shape[1] == 3 and ho >= 40:
        return "3x3 >= 40 px"
    return "<= 20 px" if ho <= 20 else "other"


@torch.inference_mode()
def qconv_exact(args, kw, tag: str):
    """One captured conv launched again: the plan `fdms_qconv` launched
    must equal `qconv_plan`'s, and the output qconv_plain's (at most 1
    apart where the plain pre-round value lies within HALF_TOL of a half
    integer). Returns (kernel output, plain output, plan, max |diff|,
    outputs 1 apart)."""
    x, w, alpha, bias, inv_out = args
    stride, pads, groups, act = (kw["stride"], kw["pads"], kw["groups"],
                                 kw["act"])
    plan = QK.plan_for(x, w, stride, pads, groups)
    got = QK.qconv(*args, **kw)
    launched = QK.last_plan()
    check(launched == plan.row(), f"{tag}: qconv.cu launched plan "
                                  f"{launched} at {tuple(x.shape)} "
                                  f"k{tuple(w.shape[1:3])} s{stride}, "
                                  f"qconv_plan {plan.row()}")
    z = QK.pre_round(QK.conv_sums(x, w, stride, pads, groups), alpha,
                     bias, inv_out, act)
    want = torch.clamp(torch.round(z), -127, 127).to(torch.int8)
    diff = (got.int() - want.int()).abs()
    near = (z - torch.floor(z) - 0.5).abs() < HALF_TOL
    check(got.shape == want.shape and int(diff.max()) <= 1
          and not bool(diff[~near].any()),
          f"{tag}: qconv differs from qconv_plain at {tuple(x.shape)} "
          f"-> {tuple(want.shape)} k{tuple(w.shape[1:3])} s{stride} "
          f"g{groups} {act} ({plan.route} route): max "
          f"{int(diff.max())}, {int((diff[~near] > 0).sum())} away "
          f"from a half integer")
    return got, want, plan, int(diff.max()), int((diff > 0).sum())


def check_qconvs(calls, smi: str, tag: str):
    """Each captured conv: the kernel against the plain version on the
    card, its launched plan against `qconv_plan`, and kernel (events and
    graph-replayed device time, by route and class), mma route on the
    wgmma convs, plain, bound, _int_mm and cuDNN bf16 times. Returns (sums,
    worst |kernel - plain|, near-half differences, elements)."""
    sums = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "bf16_cudnn_ms": 0.0, "t_bytes": 0.0, "t_ops": 0.0,
            "bound_ms": 0.0, "ops_bound_ms": 0.0, "ops": 0.0,
            "mma_route_ms": 0.0, "mma_route_device_ms": 0.0,
            "wgmma_route_ms": 0.0, "wgmma_route_device_ms": 0.0,
            "ruled_convs": 0, "ruled_mma_device_ms": 0.0,
            "ruled_wgmma_device_ms": 0.0}
    by_route, by_class = {}, {}
    worst = flips = elements = 0
    lib_convs = 0
    for args, kw in calls:
        x, w, alpha, bias, inv_out = args
        stride, pads, groups, act = (kw["stride"], kw["pads"],
                                     kw["groups"], kw["act"])
        got, want, plan, w_, f_ = qconv_exact(args, kw, tag)
        worst = max(worst, w_)
        flips += f_
        elements += want.numel()
        ms = cuda_ms(lambda: QK.qconv(*args, **kw), 5)
        dev = QAB.graph_ms(lambda: QK.qconv(*args, **kw), 10)
        plain = cuda_ms(lambda: QK.qconv_plain(*args, **kw), 1)
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)
        wb = w.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        cudnn = cuda_ms(lambda: torch.nn.functional.conv2d(
            xb, wb, None, stride, pads, 1, groups), 5)
        m = want.numel() // want.shape[-1]
        ops = 2 * m * want.shape[-1] * w[0].numel()
        nbytes = x.numel() + w.numel() + want.numel() + 8 * want.shape[-1]
        t_o = ops / INT8_OPS_PER_S * 1e3
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        for key, v in (("ms", ms), ("device_ms", dev), ("plain_ms", plain),
                       ("bf16_cudnn_ms", cudnn), ("t_ops", t_o),
                       ("t_bytes", t_b), ("ops", ops)):
            sums[key] += v
        sums["ops_bound_ms"] += t_o if t_o >= t_b else 0.0
        sums["bound_ms"] += max(t_o, t_b)
        for table, key in ((by_route, plan.route),
                           (by_class, qconv_class(w, want.shape[1]))):
            row = table.setdefault(key, {"convs": 0, "ms": 0.0,
                                         "device_ms": 0.0, "ops": 0.0,
                                         "bound_ms": 0.0})
            row["convs"] += 1
            row["ms"] += ms
            row["device_ms"] += dev
            row["ops"] += ops
            row["bound_ms"] += max(t_o, t_b)
        if plan.route == "wgmma":
            # the first kernel's design (the mma route) on the same conv
            mma = QK._route_plan("mma", *x.shape, w.shape[0],
                                 *w.shape[1:3], stride, groups,
                                 QK.ptr_align(x.data_ptr()),
                                 QK.ptr_align(w.data_ptr()), tuple(pads))

            def launch_mma():
                return QK._launch(mma, *args, stride, pads, groups, act)

            check(torch.equal(launch_mma(), got),
                  f"{tag}: the mma route differs from the wgmma route at "
                  f"{tuple(x.shape)} k{tuple(w.shape[1:3])} s{stride}")
            sums["mma_route_ms"] += cuda_ms(launch_mma, 5)
            sums["mma_route_device_ms"] += QAB.graph_ms(launch_mma, 10)
            sums["wgmma_route_ms"] += ms
            sums["wgmma_route_device_ms"] += dev
        elif plan.route == "mma" and QK.takes_wgmma(
                x.shape[3], *w.shape[1:3], stride, groups, tuple(pads),
                QK.ptr_align(x.data_ptr()), QK.ptr_align(w.data_ptr())):
            # a conv the route rule keeps off wgmma (K < WGMMA_MIN_K): the
            # wgmma route on it, so each run shows the rule's choice
            wg = QK._route_plan("wgmma", *x.shape, w.shape[0],
                                *w.shape[1:3], stride, groups, 16, 16,
                                tuple(pads),
                                sms=QK.device_sms(x.get_device()))

            def launch_wgmma():
                return QK._launch(wg, *args, stride, pads, groups, act)

            check(torch.equal(launch_wgmma(), got),
                  f"{tag}: the wgmma route differs from the mma route at "
                  f"{tuple(x.shape)} k{tuple(w.shape[1:3])} s{stride}")
            sums["ruled_convs"] += 1
            sums["ruled_mma_device_ms"] += dev
            sums["ruled_wgmma_device_ms"] += QAB.graph_ms(launch_wgmma, 10)
        if groups == 1:
            sums["library_ms"] += cuda_ms(
                lambda: library_int_mm(x, w, stride, pads), 5)
            lib_convs += 1
    sums["library_convs"] = lib_convs
    sums["bound_by"] = ("operations" if sums["ops_bound_ms"]
                        >= sums["bound_ms"] / 2 else "bytes")
    for table in (by_route, by_class):
        for row in table.values():
            row["tops"] = row["ops"] / row["device_ms"] / 1e9
    sums["by_route"], sums["by_class"] = by_route, by_class
    print(f"qconv {tag} b{BATCH}@{SIZE} on {smi}, sums over {len(calls)} "
          f"convs: kernel {sums['ms']:.3f} ms by events, "
          f"{sums['device_ms']:.3f} device ms replayed from a CUDA graph "
          f"({sums['ops'] / sums['device_ms'] / 1e9:.1f} TOPS effective), "
          f"plain {sums['plain_ms']:.3f} ms, bound {sums['bound_ms']:.4f} ms "
          f"by {sums['bound_by']} (ops alone {sums['t_ops']:.4f}, bytes "
          f"alone {sums['t_bytes']:.4f}), torch._int_mm after im2col "
          f"{sums['library_ms']:.3f} ms over the {lib_convs} non-grouped "
          f"convs, cuDNN bf16 {sums['bf16_cudnn_ms']:.3f} ms; on the convs "
          f"that take wgmma: wgmma {sums['wgmma_route_ms']:.3f} ms "
          f"({sums['wgmma_route_device_ms']:.3f} device), the mma route "
          f"{sums['mma_route_ms']:.3f} ms "
          f"({sums['mma_route_device_ms']:.3f} device); on the "
          f"{sums['ruled_convs']} convs the route rule keeps on mma (K < "
          f"{QK.WGMMA_MIN_K} bytes): mma {sums['ruled_mma_device_ms']:.3f} "
          f"device ms, the wgmma route "
          f"{sums['ruled_wgmma_device_ms']:.3f}; kernel vs plain: "
          f"{flips} of {elements} outputs 1 apart, all within {HALF_TOL} of "
          f"a half integer; every launched plan == qconv_plan")
    for what, table in (("route", by_route), ("class", by_class)):
        print(f"qconv {tag} by {what}: " + "; ".join(
            f"{k}: {r['convs']} convs, {r['ms']:.3f} ms events, "
            f"{r['device_ms']:.4f} device ms, {r['tops']:.1f} TOPS, bound "
            f"{r['bound_ms']:.4f}" for k, r in table.items()))
    return sums, worst, flips, elements


def drive_int8(smi: str, frames_by_model) -> dict:
    """Phase 20: int8 serving on the card for INT8_MODELS. Returns the
    kernels line's qconv entry."""
    by_model, launches_by_path, worst, flips, elements = {}, {}, 0, 0, 0
    for name, seed in INT8_MODELS:
        tag = f"{name} int8"
        frames = frames_by_model.get(name)
        if frames is None:
            frames = np.random.default_rng(seed).integers(
                0, 256, (INT8_REQUESTS, BATCH, SIZE, SIZE, 3),
                dtype=np.uint8)
        det = FaceDetector(name, img_sizes=(SIZE,), conf_thres=0.5,
                           iou_thres=0.5, max_candidates=MAX_CANDIDATES,
                           seed=seed, quantize="int8",
                           calib_images=frames[0], device="cuda")
        set_gate(det, frames[0])
        det.warmup(SIZE, BATCH)
        convs = det._qparams["convs"]
        grouped = sum(q["w"].shape[-1] == 1 and q["w"].shape[0] > 1
                      for q in convs.values())

        def plain_forbidden(*args, **kw):
            raise AssertionError("qconv_plain ran on the card's int8 path")

        plain = QK.qconv_plain
        QK.qconv_plain = plain_forbidden
        zero_counters()
        times = []
        try:
            for r in range(INT8_REQUESTS):
                t0 = time.perf_counter()
                dets = det.run_network(frames[r])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                check(all(bool(torch.isfinite(t).all()) for t in dets[:4]),
                      f"{tag}: non-finite detections")
        finally:
            QK.qconv_plain = plain
        counts = {"seq": K.nms_keep.launches,
                  "fixpoint": K.nms_keep.fixpoint_launches,
                  "fused": E.fused_elan.launches + E.fused_elan.bf16_launches}
        qc = {"qconv": QK.qconv.launches,
              "depthwise": QK.qconv.depthwise_launches,
              "wgmma": QK.qconv.wgmma_launches,
              "split": QK.qconv.split_launches}
        check(counts == {"seq": INT8_REQUESTS, "fixpoint": 0, "fused": 0},
              f"{tag}: launches {counts}, want {INT8_REQUESTS} nms_keep")
        check(qc["qconv"] == INT8_REQUESTS * len(convs) > 0
              and qc["depthwise"] == INT8_REQUESTS * grouped,
              f"{tag}: qconv launches {qc}, want {len(convs)} a request "
              f"({grouped} of them direct)")
        PATH_LAUNCHES[tag] = counts
        launches_by_path[tag] = qc
        ms = [t * 1e3 for t in times]
        print(f"{tag} run_network b{BATCH}@{SIZE} on {smi}: "
              f"ms/batch {[round(v, 3) for v in ms]}, median "
              f"{np.median(ms):.3f}, img/s {BATCH / np.median(times):.1f}; "
              f"launches a request: qconv {qc['qconv'] // INT8_REQUESTS} "
              f"({qc['wgmma'] // INT8_REQUESTS} wgmma, "
              f"{qc['split'] // INT8_REQUESTS} of them split over a "
              f"cluster; {qc['depthwise'] // INT8_REQUESTS} direct; the "
              f"rest mma), nms_keep 1; "
              f"kept per image {dets.valid.sum(1).cpu().tolist()}")

        # where a request's time goes: forward+decode, postprocess, and
        # one traced request's device time by kernel
        rows, fwd_ms = timed(lambda: det.forward_rows(frames[0]))
        dets_card, post_ms = timed(lambda: det.postprocess(rows))
        prof = kernel_profile(lambda: det.run_network(frames[0]), top=10**4)
        busy = prof["kernel_ms"] / prof["wall_ms"]
        traced = [k for k in prof["top"] if "qconv_" in k["name"]]
        print(f"{tag}: forward+decode {fwd_ms:.3f} ms, postprocess "
              f"{post_ms:.3f} ms (host clock, synchronized); one traced "
              f"request: wall {prof['wall_ms']:.3f} ms, device busy "
              f"{prof['kernel_ms']:.3f} ms ({busy:.1%}, idle "
              f"{1 - busy:.1%}) in {prof['launches']} launches, qconv "
              f"{sum(k['ms'] for k in traced):.3f} ms in "
              f"{sum(k['launches'] for k in traced)}; top: "
              + "; ".join(f"{k['name'][:60]} {k['ms']:.3f} ms x"
                          f"{k['launches']}" for k in prof["top"][:6]))
        # the card's postprocess == the CPU postprocess of the same rows
        check(same_detections(dets_card, det.postprocess(rows.cpu())),
              f"{tag}: card Detections differ from the CPU postprocess")
        # each conv on its own inputs, then the walk with the plain conv
        x = torch.as_tensor(frames[0]).cuda().float() / 255.0
        raws, calls = capture_qconvs(det, x)
        check(len(calls) == len(convs), f"{tag}: captured {len(calls)} "
                                        f"convs, want {len(convs)}")
        # the request's launches by route are what the plans of its convs
        # give: w6 106 wgmma, tiny 54, lite-t 29 (and 21 direct)
        routes = [QK.plan_for(a[0], a[1], k["stride"], k["pads"],
                              k["groups"]) for a, k in calls]
        planned = {"wgmma": sum(p.route == "wgmma" for p in routes),
                   "split": sum(p.split > 1 for p in routes),
                   "depthwise": sum(p.route == "direct" for p in routes)}
        check(all(qc[key] == INT8_REQUESTS * v for key, v in planned.items())
              and planned["wgmma"] == INT8_WGMMA[name]
              and (name != "yolov7-w6-face" or planned["split"] > 0),
              f"{tag}: qconv launches by route {qc}, planned {planned} a "
              f"request ({INT8_WGMMA[name]} wgmma)")
        host_us = QAB.host_us(QK.qconv, calls)
        print(f"{tag}: the qconv wrapper's host time {host_us:.2f} us a "
              f"conv (median of 5 passes over the {len(calls)} convs, no "
              f"synchronize)")
        sums, w_, f_, e_ = check_qconvs(calls, smi, tag)
        worst, flips, elements = max(worst, w_), flips + f_, elements + e_
        del calls
        kernel = QUANT.qconv
        QUANT.qconv = QK.qconv_plain
        try:
            raws_plain = det._forward(x)
        finally:
            QUANT.qconv = kernel
        shares = [float((g - p).abs().max() / p.abs().max())
                  for g, p in zip(raws, raws_plain)]
        print(f"{tag}: raws against the plain-conv walk off by "
              f"{[f'{v:.3g}' for v in shares]} of max |raw| per level "
              f"(bound {INT8_RAW_SHARE})")
        check(all(bool(torch.isfinite(r).all()) for r in raws)
              and max(shares) <= INT8_RAW_SHARE,
              f"{tag}: raws beyond {INT8_RAW_SHARE} of the plain walk's")
        with full_fp32(), torch.inference_mode():
            raws_f32 = det._float_model(x)
        err = [float((g - f).abs().max() / f.abs().max())
               for g, f in zip(raws, raws_f32)]
        corr = [float(torch.corrcoef(torch.stack([g.flatten(),
                                                  f.flatten()]))[0, 1])
                for g, f in zip(raws, raws_f32)]
        print(f"{tag}: int8 against float32 raws (not gated): max |diff| / "
              f"max |raw| {[f'{v:.4g}' for v in err]}, correlation "
              f"{[f'{v:.6f}' for v in corr]}")
        by_model[name] = {
            "ms": sums["ms"], "device_ms": sums["device_ms"],
            "plain_ms": sums["plain_ms"],
            "bound_ms": sums["bound_ms"], "bound_by": sums["bound_by"],
            "library_ms": sums["library_ms"],
            "bf16_cudnn_ms": sums["bf16_cudnn_ms"], "convs": len(convs),
            "request_ms": float(np.median(ms)),
            "img_per_s": BATCH / float(np.median(times)),
            "forward_decode_ms": fwd_ms, "postprocess_ms": post_ms,
            "device_busy_share": busy,
            "traced_ms": sum(k["ms"] for k in traced),
            "host_us_per_conv": host_us,
            "wgmma_route_ms": sums["wgmma_route_ms"],
            "wgmma_route_device_ms": sums["wgmma_route_device_ms"],
            "mma_route_ms": sums["mma_route_ms"],
            "mma_route_device_ms": sums["mma_route_device_ms"],
            "ruled_convs": sums["ruled_convs"],
            "ruled_mma_device_ms": sums["ruled_mma_device_ms"],
            "ruled_wgmma_device_ms": sums["ruled_wgmma_device_ms"],
            "by_route": sums["by_route"], "by_class": sums["by_class"]}
        del det, raws, raws_plain, raws_f32
        torch.cuda.empty_cache()
        stamp(f"path {tag} done")
    w6 = by_model["yolov7-w6-face"]
    return {
        "name": "qconv", "route": "cuda",
        "source": "face_detection_multi_scale_tpu_torch/csrc/qconv.cu",
        "replaces": "face_detection_multi_scale_tpu/models/quant.py:521",
        "launches": sum(c["qconv"] for c in launches_by_path.values()),
        "depthwise_launches": sum(c["depthwise"]
                                  for c in launches_by_path.values()),
        "wgmma_launches": sum(c["wgmma"] for c in launches_by_path.values()),
        "split_launches": sum(c["split"] for c in launches_by_path.values()),
        "launches_by_path": launches_by_path,
        "max_abs_err": worst, "half_integer_flips": flips,
        "elements": elements, "ms": w6["ms"], "card_ms": w6["ms"],
        "device_ms": w6["device_ms"],
        "mma_route_ms": w6["mma_route_ms"],
        "mma_route_device_ms": w6["mma_route_device_ms"],
        "wgmma_route_ms": w6["wgmma_route_ms"],
        "wgmma_route_device_ms": w6["wgmma_route_device_ms"],
        "by_route": w6["by_route"], "by_class": w6["by_class"],
        "host_us_per_conv": w6["host_us_per_conv"],
        "plain_ms": w6["plain_ms"], "bound_ms": w6["bound_ms"],
        "traced_ms": w6["traced_ms"],
        "bound_by": w6["bound_by"], "library_ms": w6["library_ms"],
        "library": "torch._int_mm after an int8 im2col, non-grouped convs",
        "bf16_cudnn_ms": w6["bf16_cudnn_ms"],
        "bound_rate": "int8: 1979 TOPS, 3.35 TB/s",
        "per": "sum over the convs of one w6 b8@640 int8 forward",
        "by_model": by_model}


def eval_buckets(seed: int):
    """Phase 21's host-route buckets: for each EVAL_BUCKETS shape,
    EVAL_BATCH seeded BGR frames at that letterboxed shape, each standing
    for a frame of twice its size (the auto=True letterbox at SIZE of a
    (2h, 2w) frame is an exact half, with no pad: no OpenCV needed)."""
    rng = np.random.default_rng(seed)
    buckets = {}
    for b, (h, w) in enumerate(EVAL_BUCKETS):
        frames = rng.integers(0, 256, (EVAL_BATCH, h, w, 3), dtype=np.uint8)
        buckets[(h, w)] = [(f"0--Host/host_{b}_{i}.jpg", (2 * h, 2 * w, 3),
                            f) for i, f in enumerate(frames)]
    return buckets


def txt_rows(rows: np.ndarray, inp_hw, img0_shape) -> np.ndarray:
    """What `write_pred_file` writes for Detections rows, as
    `read_pred_file` parses it: x1 y1 w h conf after the inverse
    letterbox, int(v + 0.5) coordinates, conf clamped to 1 at 3 decimals."""
    r = rows[:, :5].astype(np.float64)
    if len(r):
        LB.scale_coords(inp_hw, r[:, :4], img0_shape)
    out = []
    for x1, y1, x2, y2, c in r:
        ix1, iy1, ix2, iy2 = (int(v + 0.5) for v in (x1, y1, x2, y2))
        out.append([ix1, iy1, ix2 - ix1, iy2 - iy1,
                    float("%.03f" % (c if c <= 1 else 1))])
    return np.array(out, np.float64).reshape(-1, 5)


def counts_since_zero():
    return {"seq": K.nms_keep.launches,
            "fixpoint": K.nms_keep.fixpoint_launches,
            "fused": E.fused_elan.launches + E.fused_elan.bf16_launches,
            "qconv": QK.qconv.launches}


def check_eval_point(det: FaceDetector, rows: torch.Tensor,
                     dets: NMS.Detections, smi: str) -> dict:
    """Phase 21a on one counted eval batch (B = 16, its rows as the
    engine gave them to the postprocess and its Detections): the keep
    mask kernel on the batch's candidates, bit for bit against
    nms_keep_plain on two images; those two images' Detections against
    the CPU postprocess of their rows; the kernel, its two passes apart,
    and the plain version timed at this point, beside its bound. Returns
    the kernels line's eval fields."""
    b = rows.shape[0]
    k = min(det.max_candidates, rows.shape[1])
    check((b, k) == (EVAL_BATCH, EVAL_K), f"eval batch {b} x K {k}")
    cpu = det.postprocess(rows[:2].cpu())
    check(same_detections(NMS.Detections(*(t[:2] for t in dets)), cpu),
          "eval: the card's Detections of 2 images differ from the CPU "
          "postprocess of their rows")
    _, _, _, nms_boxes, valid, _, _ = NMS._gather_candidates_planar(
        rows, nc=det.spec.nc, conf_thres=det.conf_thres, k=k)
    boxes = nms_boxes.float().contiguous()
    thr = det.iou_thres
    keep = K.nms_keep(boxes, valid, thr)
    want = K.nms_keep_plain(boxes[:2], valid[:2], thr)
    check(torch.equal(keep[:2], want), "eval: nms_keep differs from "
                                       "nms_keep_plain at B=16, K=16384")
    ms = cuda_ms(lambda: K.nms_keep(boxes, valid, thr), 10)
    mask = torch.empty(K.mask_words(b, k), dtype=torch.int64,
                       device=boxes.device)
    scan_keep = torch.empty_like(keep)
    pass1 = cuda_ms(lambda: K.launch_mask(boxes, valid, thr, mask), 10)
    pass2 = cuda_ms(lambda: K.launch_scan(mask, valid, scan_keep), 10)
    check(torch.equal(scan_keep, keep), "eval: nms_keep's passes run apart "
                                        "differ from the kernel's call")
    del mask
    # the plain version materializes (B, K, K): two images at a time
    plain = cuda_ms(lambda: [K.nms_keep_plain(boxes[i:i + 2], valid[i:i + 2],
                                              thr) for i in range(0, b, 2)],
                    1, warmup=0)
    # the function's bound, as at every other point: inputs and output
    # once against the keeper pairs' operations. The scratch is this
    # design's own traffic, not the function's: its time stands apart.
    bound, by = nms_bound(keep, valid)
    scratch = 2 * K.mask_words(b, k) * 8  # pass 1 writes it, pass 2 reads
    t_scratch = scratch / HBM_BYTES_PER_S * 1e3
    t_dense = b * k * k / 2 * OPS_PER_IOU / F32_OPS_PER_S * 1e3
    print(f"nms_keep at the eval point B={b} K={k} on {smi} (the w6 eval "
          f"batch's own candidates, {int(valid.sum())} valid, kept "
          f"{int(keep.sum())}): kernel {ms:.4f} ms (pass 1 {pass1:.4f}, "
          f"pass 2 {pass2:.4f} apart), plain {plain:.4f} ms (2 images at "
          f"a time); bound {bound:.4f} ms by {by} (inputs and output "
          f"once, keeper pairs' operations), kernel at "
          f"{ms / bound:.1f}x it; the design's scratch "
          f"{scratch / 1e6:.1f} MB written and read {t_scratch:.4f} ms, "
          f"all K^2/2 pairs' operations {t_dense:.4f} ms; "
          f"kernel == plain on 2 images, Detections == CPU postprocess")
    return {"eval_ms": ms, "eval_pass1_ms": pass1, "eval_pass2_ms": pass2,
            "eval_plain_ms": plain, "eval_bound_ms": bound,
            "eval_bound_by": by, "eval_scratch_bytes": scratch,
            "eval_scratch_ms": t_scratch, "eval_dense_ops_ms": t_dense,
            "eval_kept": int(keep.sum()), "eval_valid": int(valid.sum())}


def check_written(save: str, buckets, seen, device_hw=None) -> int:
    """Every txt of the written buckets parses back with read_pred_file
    to as many rows as its count line and as its image's Detections
    kept; the first two images' rows equal what the writer makes of their
    Detections (the host route's equal the CPU postprocess,
    `check_eval_point`). `seen` holds each engine call's (rows,
    Detections) in the writer's order. Returns the rows written."""
    total, call = 0, 0
    for shape, items in sorted(buckets.items(), key=lambda kv: -len(kv[1])):
        for i in range(0, len(items), EVAL_BATCH):
            chunk = items[i:i + EVAL_BATCH]
            rows, dets = seen[call]
            kept = dets.valid.sum(1).cpu().tolist()
            want = (NMS.detections_to_numpy(
                NMS.Detections(*(t[:2] for t in dets)))
                if call == 0 else None)
            for j, (name, img0_shape, _) in enumerate(chunk):
                path = os.path.join(save, name[:-4] + ".txt")
                count = int(open(path).read().splitlines()[1])
                stem, got = WF.read_pred_file(path)
                check(stem == Path(name).stem and count == len(got)
                      == kept[j], f"eval: {name} wrote {count} rows, parsed "
                                  f"{len(got)}, kept {kept[j]}")
                if want is not None and j < 2:
                    inp_hw = device_hw or shape
                    check(np.array_equal(got, txt_rows(want[j], inp_hw,
                                                       img0_shape)),
                          f"eval: {name}'s txt differs from its rows")
                total += len(got)
            call += 1
    return total


def eval_gt(save: str, events_dirs) -> dict:
    """Seeded ground truth for the written predictions: per image its
    first three written boxes and two random ones, easy keeping the
    first, medium two, hard all."""
    rng = np.random.default_rng(33)
    events = {}
    for event in events_dirs:
        images = []
        for txt in sorted(os.listdir(os.path.join(save, event))):
            stem, rows = WF.read_pred_file(os.path.join(save, event, txt))
            xy = rng.uniform(0, 900, (2, 2))
            faces = np.concatenate([rows[:3, :4], np.concatenate(
                [xy, rng.uniform(8, 120, (2, 2))], 1)]).round()
            n = len(faces)
            images.append((stem, faces, {"easy": [1], "medium": [1, 2],
                                         "hard": list(range(1, n + 1))}))
        events[event] = images
    return events


def drive_eval_writer(smi: str, gt_dir: str, save: str):
    """Phase 21a: cli/test_widerface.write_buckets at the eval point,
    float32 w6, host route on two buckets and device route on raw
    frames; then evaluation() against seeded .mat files through the
    native IoU and numpy. Returns (the kernels line's nms_keep eval
    fields, the gate, the host buckets)."""
    tag = "w6 eval"
    det = FaceDetector("yolov7-w6-face", img_sizes=(SIZE,), conf_thres=0.01,
                       iou_thres=0.5, max_det=EVAL_DET,
                       max_candidates=EVAL_K, seed=0, device="cuda")
    buckets = eval_buckets(30)
    batch0 = np.ascontiguousarray(np.stack(
        [f[:, :, ::-1] for _, _, f in buckets[EVAL_BUCKETS[0]]]))
    # a gate at which the busiest frame of the first bucket gates
    # EVAL_GATED > K rows, so the truncation report must show it
    rows = det.forward_rows(batch0)
    conf = (rows[..., 4] * rows[..., 5]).sort(dim=1, descending=True)[0]
    det.conf_thres = float(conf[:, EVAL_GATED].max())
    del rows, conf
    raw = np.random.default_rng(31).integers(
        0, 256, (EVAL_BATCH, *EVAL_RAW_HW, 3), dtype=np.uint8)
    raw_buckets = {EVAL_RAW_HW: [(f"1--Device/dev_{i}.jpg", raw[i].shape,
                                  raw[i]) for i in range(EVAL_BATCH)]}
    for items in buckets.values():  # warm-ups of each shape, not counted
        det.run_network(np.ascontiguousarray(np.stack(
            [f[:, :, ::-1] for _, _, f in items])))
    det.run_network_raw(det.upload(raw), SIZE, auto=True)
    torch.cuda.synchronize()

    seen, outs = [], {}
    post = det.postprocess

    def record(rows):
        dets = post(rows)
        seen.append((rows, dets))
        return dets

    det.postprocess = record
    try:
        for route, bks, dev in (("host", buckets, False),
                                ("device", raw_buckets, True)):
            start = len(seen)
            zero_counters()
            out, ms = timed(lambda: TW.write_buckets(
                det, bks, save, img_size=SIZE, batch_size=EVAL_BATCH,
                device_preprocess=dev))
            got = counts_since_zero()
            check(got == {"seq": out["batches"], "fixpoint": 0, "fused": 0,
                          "qconv": 0} and out["batches"] == len(seen) - start
                  == sum(-(-len(v) // EVAL_BATCH) for v in bks.values()),
                  f"{tag} {route}: launches {got} for {out['batches']} "
                  f"engine calls")
            EVAL_LAUNCHES[f"{tag} {route}"] = got["seq"]
            outs[route] = (out, ms, len(seen) - start)
    finally:
        del det.postprocess
    gated = outs["host"][0]["gated"] + outs["device"][0]["gated"]
    trunc = TW.report_truncation(gated, EVAL_K)
    check(trunc["truncated_images"] > 0 and trunc["max_gated"] > EVAL_K,
          f"{tag}: no image gated more than K = {EVAL_K}: {trunc}")
    for route, (out, ms, calls) in outs.items():
        bm = out["batch_ms"]
        print(f"{tag} {route} route on {smi}: {out['written']} txts in "
              f"{ms:.3f} ms, {calls} engine calls of B={EVAL_BATCH} at "
              f"K={EVAL_K} (ms a batch {[round(v, 3) for v in bm]}, "
              f"median {np.median(bm):.3f}), "
              f"{out['written'] / ms * 1e3:.1f} img/s; nms_keep launches "
              f"{EVAL_LAUNCHES[f'{tag} {route}']}")
    stamp(f"{tag}: counted runs done")
    fields = check_eval_point(det, *seen[0], smi)
    stamp(f"{tag}: eval point checked and timed")
    geom = DP.letterbox_geometry(EVAL_RAW_HW, SIZE, auto=True,
                                 stride=det.stride)
    n_rows = (check_written(save, buckets, seen)
              + check_written(save, raw_buckets, seen[outs["host"][2]:],
                              device_hw=geom.out_hw))
    stamp(f"{tag}: txts parsed back")
    check(NAT.available(), "the native postprocess library (g++) did not "
                           "build")
    write_widerface_gt(gt_dir, eval_gt(save, ("0--Host", "1--Device")))
    aps = WF.evaluation(save, gt_dir, verbose=False)
    available = NAT.available
    NAT.available = lambda: False
    try:
        aps_numpy = WF.evaluation(save, gt_dir, verbose=False)
    finally:
        NAT.available = available
    check(aps == aps_numpy and all(0 < v <= 1 for v in aps.values()),
          f"{tag}: evaluation {aps} through the native IoU, {aps_numpy} "
          f"through numpy")
    host_bm = outs["host"][0]["batch_ms"]
    # where an eval batch's time goes: forward (with decode) and postprocess
    rows, fwd_ms = timed(lambda: det.forward_rows(batch0))
    _, post_ms = timed(lambda: det.postprocess(rows))
    print(f"{tag}: a B={EVAL_BATCH} batch at {EVAL_BUCKETS[0][0]}x"
          f"{EVAL_BUCKETS[0][1]}: forward+decode {fwd_ms:.3f} ms, "
          f"postprocess {post_ms:.3f} ms (host clock, synchronized)")
    print(f"{tag}: {n_rows} rows written and parsed back; truncation "
          f"{trunc}; evaluation() easy/medium/hard {aps['easy']:.6f} / "
          f"{aps['medium']:.6f} / {aps['hard']:.6f} (native IoU == numpy)")
    host_out, host_ms, _ = outs["host"]
    fields.update(
        eval_batch_ms=float(np.median(host_bm)),
        eval_img_per_s=EVAL_BATCH / float(np.median(host_bm)) * 1e3,
        eval_writer_img_per_s=host_out["written"] / host_ms * 1e3,
        eval_forward_ms=fwd_ms, eval_postprocess_ms=post_ms,
        eval_device_batch_ms=float(np.median(outs["device"][0]["batch_ms"])),
        eval_truncated_images=trunc["truncated_images"])
    gate = det.conf_thres
    del det, seen, rows
    torch.cuda.empty_cache()
    stamp("phase 21a (the WIDER writer at the eval point) done")
    return fields, gate, buckets


def drive_eval_int8(smi: str, gate: float, buckets, save: str) -> dict:
    """Phase 21b: the writer with --quantize semantics, one bucket at
    B = 16 (640 x 512 network input, 512 x 640 frames), calibrated on its
    first batch; every qconv launch of the counted run equals qconv_plain
    and its launched plan qconv_plan's. Returns the launches by route."""
    tag = "w6 int8 eval"
    det = FaceDetector("yolov7-w6-face", img_sizes=(SIZE,), conf_thres=gate,
                       iou_thres=0.5, max_det=EVAL_DET, max_candidates=EVAL_K,
                       seed=0, quantize="int8", device="cuda")
    bucket = {EVAL_BUCKETS[0]: buckets[EVAL_BUCKETS[0]]}
    calls = []
    real = QUANT.qconv

    def record(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out

    zero_counters()
    QUANT.qconv = record
    try:
        out, ms = timed(lambda: TW.write_buckets(
            det, bucket, save, img_size=SIZE, batch_size=EVAL_BATCH))
    finally:
        QUANT.qconv = real
    got = counts_since_zero()
    qc = {"qconv": QK.qconv.launches, "wgmma": QK.qconv.wgmma_launches,
          "split": QK.qconv.split_launches,
          "depthwise": QK.qconv.depthwise_launches}
    convs = len(det._qparams["convs"])
    check(got["seq"] == out["batches"] == 1 and got["fixpoint"] == 0
          and got["fused"] == 0 and qc["qconv"] == len(calls) == convs,
          f"{tag}: launches {got} {qc}, want 1 nms_keep and {convs} qconv")
    EVAL_LAUNCHES[tag] = got["seq"]
    plans = [QK.plan_for(a[0], a[1], k["stride"], k["pads"], k["groups"])
             for a, k, _ in calls]
    planned = {"qconv": convs,
               "wgmma": sum(p.route == "wgmma" for p in plans),
               "split": sum(p.split > 1 for p in plans),
               "depthwise": sum(p.route == "direct" for p in plans)}
    check(qc == planned, f"{tag}: launches by route {qc}, planned {planned}")
    worst = flips = elements = 0
    for args, kw, launched in calls:
        again, want, _, w_, f_ = qconv_exact(args, kw, tag)
        check(torch.equal(again, launched), f"{tag}: a conv's eval launch "
                                            f"differs from its relaunch")
        worst, flips, elements = max(worst, w_), flips + f_, \
            elements + want.numel()
    print(f"{tag} on {smi}: one bucket of B={EVAL_BATCH} at "
          f"{EVAL_BUCKETS[0][0]}x{EVAL_BUCKETS[0][1]}, calibrated on it, "
          f"{ms:.3f} ms (batch {out['batch_ms'][0]:.3f}); qconv launches "
          f"{qc['qconv']} ({qc['wgmma']} wgmma, {qc['split']} split, "
          f"{qc['depthwise']} direct, the rest mma) == qconv_plan's routes; "
          f"each launch == qconv_plain ({flips} of {elements} outputs 1 "
          f"apart at half integers), every launched plan == qconv_plan")
    del det, calls
    torch.cuda.empty_cache()
    stamp("phase 21b (int8 eval) done")
    return qc


def validation_labels(det: FaceDetector, images: np.ndarray):
    """Labels from the card's own detections: per image its first three
    kept boxes, jittered, and one random box, as normalized `0 cx cy w h`
    rows with 5 keypoints inside the box (the occlusion column dropped,
    as load_label_file does)."""
    rng = np.random.default_rng(41)
    labels = []
    for i in range(0, len(images), VAL_BATCH):
        batch = np.ascontiguousarray(images[i:i + VAL_BATCH][..., ::-1])
        for rows in NMS.detections_to_numpy(det.run_network(batch)):
            xy = rng.uniform(0.05, 0.6, 2) * SIZE
            boxes = np.concatenate([rows[:3, :4], [[*xy, *(
                xy + rng.uniform(0.05, 0.25, 2) * SIZE)]]])
            n = len(boxes)
            boxes = np.clip(boxes + rng.normal(0, 6, (n, 4)), 1, SIZE - 1)
            boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 4)
            c = (boxes[:, :2] + boxes[:, 2:]) / 2
            wh = boxes[:, 2:] - boxes[:, :2]
            kpts = c[:, None] + rng.uniform(-1 / 3, 1 / 3, (n, 5, 2)) \
                * wh[:, None]
            labels.append(np.concatenate(
                [np.zeros((n, 1)), c, wh, kpts.reshape(n, 10)], 1)
                .astype(np.float32) / np.float32([1] + [SIZE] * 14))
    return labels


def drive_validate(smi: str) -> None:
    """Phase 21c: infer/validate.validate on the card, w6 float32 unfused
    at b8@640 over a MemoryFaces dataset: one nms_keep launch a batch;
    P / R / mAP equal to those of the same decoded rows postprocessed and
    scored on the CPU."""
    tag = "w6 validate"
    det = FaceDetector("yolov7-w6-face", img_sizes=(SIZE,), conf_thres=0.001,
                       iou_thres=0.6, max_candidates=VAL.MAX_CANDIDATES,
                       seed=0, device="cuda")
    images = np.random.default_rng(40).integers(
        0, 256, (VAL_IMAGES, SIZE, SIZE, 3), dtype=np.uint8)
    hw0 = [(2 * SIZE, 2 * SIZE)] * VAL_IMAGES
    ds = MemoryFaces(images, hw0, validation_labels(det, images),
                     img_size=SIZE, kpt_label=5, stride=det.stride,
                     batch_size=VAL_BATCH)
    real = NMS.non_max_suppression
    preds = []

    def record(pred, *args, **kw):
        preds.append(pred)
        return real(pred, *args, **kw)

    zero_counters()
    NMS.non_max_suppression = record
    try:
        res, ms = timed(lambda: VAL.validate(det.model, ds,
                                             batch_size=VAL_BATCH,
                                             verbose=False))
    finally:
        NMS.non_max_suppression = real
    got = counts_since_zero()
    batches = VAL_IMAGES // VAL_BATCH
    check(got == {"seq": batches, "fixpoint": 0, "fused": 0, "qconv": 0}
          and len(preds) == batches, f"{tag}: launches {got} for "
                                     f"{batches} batches")
    EVAL_LAUNCHES[tag] = got["seq"]
    engine, it = VAL._engine, iter(preds)
    VAL._engine = lambda model, images_u8, **kw: real(
        next(it).cpu(), kw["conf_thres"], kw["iou_thres"], nc=1, nkpt=5,
        max_candidates=VAL.MAX_CANDIDATES, max_det=kw["max_det"])
    try:
        res_cpu = VAL.validate(det.model, ds, batch_size=VAL_BATCH,
                               verbose=False)
    finally:
        VAL._engine = engine
    keys = ("mp", "mr", "map50", "map", "images", "truncated_images")
    check(all(res[k] == res_cpu[k] for k in keys) and 0 < res["map50"] < 1,
          f"{tag}: card {res} against the CPU scoring {res_cpu}")
    print(f"{tag} b{VAL_BATCH}@{SIZE} on {smi}: {res['images']} images, P "
          f"{res['mp']:.6f} R {res['mr']:.6f} mAP50 {res['map50']:.6f} mAP "
          f"{res['map']:.6f} (== the CPU postprocess and scoring of the "
          f"card's rows), {res['truncated_images']} truncated at K="
          f"{VAL.MAX_CANDIDATES}; {ms:.3f} ms, "
          f"{res['ms_per_image']:.3f} ms an image; nms_keep launches "
          f"{got['seq']}")
    del det, preds
    torch.cuda.empty_cache()
    stamp("phase 21c (validate) done")


def drive_production(smi: str, tmp: str) -> None:
    """Phase 21d: ProductionPipeline at the production defaults (w6,
    scales 640 + 3840, conf 0.6, IoU 0.3, API preprocessing, bf16 as the
    batch CLI), device preprocessing: detect_frame a frame, then the
    batched branch (detect_frames) over 2 seeded 1080x1920 frames, whose
    host API preprocess (OpenCV) becomes the card's, rounded to uint8;
    nms_keep launches: one a scale call and one a merge; frames_to_json
    with the contract's tensors."""
    tag = "w6 production"
    det = FaceDetector("yolov7-w6-face", img_sizes=TTA_SIZES, conf_thres=0.6,
                       iou_thres=0.3, use_api_preprocess=True,
                       use_device_preprocess=True, dtype=torch.bfloat16,
                       seed=0, device="cuda")
    pipe = PROD.ProductionPipeline(det, os.path.join(tmp, "json"),
                                   os.path.join(tmp, "faces"))
    frames = tta_frames()

    def card_api(img_bgr, img_size):
        x, _ = det.device_input(det.upload(img_bgr[None]), img_size,
                                auto=True)
        return (x[0].float() * 255.0).round().clamp(0, 255).to(
            torch.uint8).cpu().numpy()

    det.preprocess = card_api
    merge = NMS.weighted_nms_merge
    merges = []

    def record_merge(*args, **kw):
        merges.append(1)
        return merge(*args, **kw)

    pipe.detect_frame(frames[0])  # warm-ups, not counted
    pipe.detect_frames(frames)
    NMS.weighted_nms_merge = record_merge
    try:
        results = {}
        for branch, fn, calls in (
                ("detect_frame", lambda: [pipe.detect_frame(f)[0]
                                          for f in frames],
                 len(frames) * len(TTA_SIZES)),
                ("batched", lambda: pipe.detect_frames(frames)[0],
                 len(TTA_SIZES))):
            merges.clear()
            zero_counters()
            found, ms = timed(fn)
            got = counts_since_zero()
            check(got == {"seq": calls + len(merges), "fixpoint": 0,
                          "fused": 0, "qconv": 0},
                  f"{tag} {branch}: launches {got}, want {calls} scale "
                  f"calls and {len(merges)} merges")
            EVAL_LAUNCHES[f"{tag} {branch}"] = got["seq"]
            data = PROD.frames_to_json(found, ms / 1e3)
            names = {t["name"]: t for t in data["yolo_face_prediction"]}
            check(set(names) == CONTRACT_TENSORS and names[
                "yolo-face-bboxes"]["shape"][0] == len(frames),
                f"{tag} {branch}: frames_to_json tensors {sorted(names)}")
            results[branch] = ms
            print(f"{tag} {branch} on {smi} (API preprocessing on the "
                  f"card: cli/batch_predict's default host OpenCV "
                  f"preprocess is not in this time): {len(frames)} frames "
                  f"{TTA_HW[0]}x{TTA_HW[1]}, {ms / len(frames):.3f} ms a "
                  f"frame, faces {[f['num_faces'] for f in found]}, "
                  f"nms_keep launches {got['seq']} ({calls} scale calls, "
                  f"{len(merges)} merges); frames_to_json has the "
                  f"contract's tensors")
    finally:
        NMS.weighted_nms_merge = merge
        del det.preprocess
    del det
    torch.cuda.empty_cache()
    stamp("phase 21d (production) done")


def drive_phase21(smi: str):
    """Phase 21: evaluation and production on the card. Returns (the
    nms_keep entry's eval fields, the qconv entry's eval launches)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_",
                                     dir=ROOT) as tmp:
        save = os.path.join(tmp, "widerface_txt")
        fields, gate, buckets = drive_eval_writer(
            smi, os.path.join(tmp, "ground_truth"), save)
        qconv_eval = drive_eval_int8(smi, gate, buckets,
                                     os.path.join(tmp, "int8_txt"))
        drive_validate(smi)
        drive_production(smi, tmp)
    fields["eval_launches"] = sum(EVAL_LAUNCHES[t] for t in (
        "w6 eval host", "w6 eval device", "w6 int8 eval"))
    return fields, qconv_eval


def write_widerface_gt(gt_dir: str, events) -> None:
    """The four WIDER FACE ground-truth .mat files in `gt_dir`, the layout
    `eval.widerface.load_gt` reads: `events` maps an event name to its
    images, each (name, faces (n, 4) as x y w h, {"easy" | "medium" |
    "hard": 1-based indices of the faces that setting keeps})."""
    from scipy.io import savemat

    def cells(values):
        out = np.empty((len(values), 1), object)
        for i, v in enumerate(values):
            out[i, 0] = v
        return out

    os.makedirs(gt_dir, exist_ok=True)
    images = list(events.values())
    savemat(os.path.join(gt_dir, "wider_face_val.mat"), {
        "event_list": cells(list(events)),
        "file_list": cells([cells([name for name, _, _ in imgs])
                            for imgs in images]),
        "face_bbx_list": cells([cells([np.asarray(f, np.float64)
                                       .reshape(-1, 4)
                                       for _, f, _ in imgs])
                                for imgs in images])})
    for setting in ("easy", "medium", "hard"):
        savemat(os.path.join(gt_dir, f"wider_{setting}_val.mat"), {
            "gt_list": cells([cells([np.asarray(k[setting], np.int32)
                                     .reshape(-1, 1)
                                     for _, _, k in imgs])
                              for imgs in images])})


# ---------------------------------------------------------------------------
# phase 22: training
# ---------------------------------------------------------------------------

def face_batch(rng, b: int, size: int):
    """A seeded uint8 NHWC batch and its collated label rows."""
    images = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    labels = DS.collate([(images[i], l, "", None) for i, l in
                         enumerate(face_labels(rng, b))])[1]
    return images, labels


def train_step_parity(spec_fn, size: int, batch: int, seed: int,
                      accumulate: bool = False,
                      compute: torch.dtype = torch.float32) -> dict:
    """One train step of the same seeded model and state on the card and on
    the CPU in float32 (TF32 off, as the trainer runs), and on the CPU in
    float64, the exact step: make_train_step, or with `accumulate` two
    make_accum_steps micro-steps and an apply. The state is past the
    warmup, so kernels move too. With `compute=torch.bfloat16` the card's
    and the CPU's steps are bf16 mixed precision (`YoloFace(spec,
    dtype=)`, float32 parameters), still held against the float64 step,
    and every parameter, gradient, optimizer-state tensor, EMA tensor and
    BN running statistic of the card's run must be float32.

    Each comparison is a tolerance ratio, max |got - want| / (atol + rtol
    |want|), over the loss components (rtol TRAIN_LOSS_RTOL), every
    parameter and EMA parameter (TRAIN_PARAM_TOL) and every BN running
    statistic (TRAIN_BN_RTOL; means also TRAIN_BN_MEAN_ATOL). A random
    model's float32 step is ill-conditioned: the CPU's own float32 step
    can miss the float64 one by more than these tolerances (yolov7-face
    b2@256: 2.65x on its first convs' weights). So the check is that the
    card's float32 step is as close to the exact step as the CPU's float32
    step, within a factor 2, or within the tolerance itself. Returns the
    ratios card/exact ("card"), CPU/exact ("cpu") and card/CPU
    ("card_cpu"), and the card step's components."""
    mixed = compute != torch.float32
    cfg = TR.TrainConfig(epochs=300, steps_per_epoch=10, warmup_epochs=0.0,
                         min_warmup_steps=1, batch_size=batch)
    rng = np.random.default_rng(seed)
    batches = [face_batch(rng, batch, size) for _ in range(2)]
    init = init_weights(YoloFace(spec_fn()),
                        torch.Generator().manual_seed(seed)).state_dict()
    runs = {}
    for key, device, dtype in (("exact", "cpu", torch.float64),
                               ("cpu", "cpu", torch.float32),
                               ("card", "cuda", torch.float32)):
        net = YoloFace(spec_fn(), dtype=torch.float32 if key == "exact"
                       else compute)
        net.load_state_dict(init)
        net.to(device, dtype)
        spec = net.spec
        grids = [(size // st, size // st) for st in spec.strides]
        targets = [build_targets_batched(l, batch, spec, grids)
                   for _, l in batches]
        state = TR.create_train_state(net)
        state.step = state.ema_updates = 1
        hyp = dict(HYP_SCRATCH_P6)
        if accumulate:
            grad_fn, apply_fn = TR.make_accum_steps(net, cfg, hyp, size)
            acc = TR.zero_grads_like(state.params)
            comps = []
            for (images, _), tg in zip(batches, targets):
                state, acc, _, c = grad_fn(state, images, tg, acc)
                comps.append(c)
            state = apply_fn(state, acc, 2)
            comps = torch.stack(comps)
        else:
            state, _, comps = TR.make_train_step(net, cfg, hyp, size)(
                state, batches[0][0], targets[0])
        check(state.step == 2, f"{key} train step: {state.step} applies")
        if key == "card" and mixed:
            # the gradients of a further step, on a copy (the state
            # dicts kept below alias the model's tensors)
            twin = copy.deepcopy(net)
            grads = TR._grad_fn(twin, TR.scale_loss_gains(
                hyp, spec.nl, spec.nc, size))(batches[0][0], targets[0])[2]
            dtypes = {t.dtype for tree in (
                net.state_dict(), state.momentum_buf, state.ema_params,
                grads) for k, t in tree.items()
                if not k.endswith("num_batches_tracked")}
            check(dtypes == {torch.float32}, f"bf16 train step: state and "
                                             f"gradient dtypes {dtypes}")
            del twin, grads
        runs[key] = (comps.cpu(), net.state_dict(), state.ema_params,
                     list(state.params))

    def ratios(a, b):
        (ca, sa, ea, names), (cb, sb, eb, _) = runs[a], runs[b]
        out = {"loss": tolerance_ratio(ca, cb, TRAIN_LOSS_RTOL, 1e-7),
               "param": 0.0, "ema": 0.0, "bn": 0.0}
        for name in names:
            out["param"] = max(out["param"], tolerance_ratio(
                sa[name], sb[name], **TRAIN_PARAM_TOL))
            out["ema"] = max(out["ema"], tolerance_ratio(
                ea[name], eb[name], **TRAIN_PARAM_TOL))
        for name in sb:
            if name.endswith(("running_mean", "running_var")):
                atol = TRAIN_BN_MEAN_ATOL if name.endswith("mean") else 0.0
                out["bn"] = max(out["bn"], tolerance_ratio(
                    sa[name], sb[name], TRAIN_BN_RTOL, atol))
        return out

    out = {"card": ratios("card", "exact"), "cpu": ratios("cpu", "exact"),
           "card_cpu": ratios("card", "cpu"),
           "components": runs["card"][0]}
    moved = max(float((runs["card"][1][n].cpu() - init[n]).abs().max())
                for n in runs["card"][3])
    check(moved > 0, "the train step moved nothing")
    what = "bf16" if mixed else "float32"
    check(all(out["card"][k] <= max(1.0, 2.0 * out["cpu"][k])
              for k in out["card"]),
          f"train step{' (accumulated)' if accumulate else ''}: the card's "
          f"{what} step against the exact (float64) one {out['card']}, "
          f"beyond twice the CPU's {what} step's {out['cpu']}")
    return out


def drive_train_timed(smi: str, dtype: torch.dtype = torch.float32
                      ) -> dict:
    """Phase 22(b): yolov7-face b16@640, nominal batch 64 (4 micro-steps an
    apply), TIMED_STEPS micro-steps from an in-memory non-augmenting
    FaceDataset through the DataLoader, the targets and
    make_accum_steps; each micro-step (forward + loss + backward, the
    batch's host-to-card copy included) and each apply timed by CUDA
    events, the whole run by the host clock; the peak memory. `dtype` is
    the model's compute dtype (bf16: mixed precision, float32
    parameters)."""
    spec = zoo.get_spec(TRAIN_MODEL)
    net = init_weights(YoloFace(spec, dtype=dtype),
                       torch.Generator().manual_seed(0))
    net.cuda()
    ds = memory_faces(np.random.default_rng(50),
                      TIMED_BATCH * TIMED_STEPS, TIMED_SIZE,
                      spec.max_stride)
    loader = DS.DataLoader(ds, TIMED_BATCH, shuffle=True, seed=0, workers=1)
    accumulate = TIMED_NOMINAL // TIMED_BATCH
    hyp = dict(HYP_SCRATCH_P6)
    cfg = TR.TrainConfig(steps_per_epoch=len(loader),
                         batch_size=TIMED_BATCH, nominal_batch=TIMED_NOMINAL)
    grad_fn, apply_fn = TR.make_accum_steps(net, cfg, hyp, TIMED_SIZE)
    state = TR.create_train_state(net)
    acc = TR.zero_grads_like(state.params)
    grids = [(TIMED_SIZE // st,) * 2 for st in spec.strides]
    events = lambda: [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
    micro, applies, comps = [], [], []
    # a warm-up micro-step (cuDNN's first calls, the allocator) on its own
    # batch, its gradients dropped
    images, labels = face_batch(np.random.default_rng(51), TIMED_BATCH,
                                TIMED_SIZE)
    (_, warm_ms) = timed(lambda: grad_fn(
        state, images, build_targets_batched(labels, TIMED_BATCH, spec,
                                             grids),
        TR.zero_grads_like(state.params)))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ni, (images, labels, _, _) in enumerate(loader, 1):
        targets = build_targets_batched(labels, len(images), spec, grids)
        ev = events()
        ev[0].record()
        state, acc, _, c = grad_fn(state, images, targets, acc)
        ev[1].record()
        micro.append(ev)
        comps.append(c)
        if ni % accumulate == 0:
            ev = events()
            ev[0].record()
            state = apply_fn(state, acc, ni - 1)
            ev[1].record()
            applies.append(ev)
            acc = TR.zero_grads_like(state.params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ms = [a.elapsed_time(b) for a, b in micro]
    apply_ms = [a.elapsed_time(b) for a, b in applies]
    comps = torch.stack(comps).cpu().numpy()
    check(len(ms) == TIMED_STEPS and state.step == TIMED_STEPS // accumulate
          and np.isfinite(comps).all(), f"timed training: {len(ms)} "
                                        f"micro-steps, {state.step} applies")
    images, labels = face_batch(np.random.default_rng(52), TIMED_BATCH,
                                TIMED_SIZE)
    targets = build_targets_batched(labels, TIMED_BATCH, spec, grids)
    prof = kernel_profile(lambda: grad_fn(state, images, targets, acc))
    out = {"dtype": DTYPE_NAMES[dtype],
           "micro_ms": float(np.median(ms)), "micro_ms_all": ms,
           "apply_ms": float(np.median(apply_ms)), "apply_ms_all": apply_ms,
           "img_s": TIMED_BATCH * TIMED_STEPS / wall, "wall_s": wall,
           "warmup_ms": warm_ms, "busy_share": prof["kernel_ms"]
           / prof["wall_ms"], "launches": prof["launches"],
           "img_s_micro": TIMED_BATCH / (np.median(ms) / 1e3),
           "peak_bytes": peak,
           "losses": dict(zip(("box", "obj", "cls", "kpt", "kptv", "total"),
                              comps[-1].tolist()))}
    what = ("bf16 mixed precision" if dtype == torch.bfloat16
            else "float32, TF32 off")
    print(f"train {TRAIN_MODEL} b{TIMED_BATCH}@{TIMED_SIZE} ({what}; "
          f"nominal batch {TIMED_NOMINAL}: {accumulate} micro-steps an "
          f"apply) on {smi}: micro-step (forward + loss + backward) median "
          f"{out['micro_ms']:.3f} ms (all {[round(v, 3) for v in ms]}), "
          f"apply (SGD + EMA) median {out['apply_ms']:.3f} ms, "
          f"{out['img_s_micro']:.2f} img/s by the micro-step, "
          f"{out['img_s']:.2f} img/s over the {TIMED_STEPS} micro-steps "
          f"and applies by the host clock ({wall:.3f} s, loader and "
          f"targets included; a warm-up micro-step before, "
          f"{warm_ms:.1f} ms); losses {out['losses']}; peak memory "
          f"{peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated); "
          f"one traced micro-step: {prof['wall_ms']:.3f} ms, kernels "
          f"{prof['kernel_ms']:.3f} ms in {prof['launches']} launches "
          f"(busy {out['busy_share']:.3f}), top "
          f"{[(k['name'][:60], round(k['ms'], 3), k['launches']) for k in prof['top'][:5]]}")
    del net, state, acc, loader, ds
    torch.cuda.empty_cache()
    return out


def drive_train_learns(smi: str, dtype: torch.dtype = torch.float32
                       ) -> dict:
    """Phase 22(c): yolov7-tiny-face overfits one fixed b2@128 batch for
    LEARN_STEPS steps (tests/test_training_learns.py's setup and
    criteria): the last total loss under half the first, the box loss
    after the run under 0.1; in the compute `dtype`."""
    spec = zoo.get_spec(LEARN_MODEL)
    net = init_weights(YoloFace(spec, dtype=dtype),
                       torch.Generator().manual_seed(1))
    net.cuda()
    s, b = LEARN_SIZE, LEARN_BATCH
    images = np.random.default_rng(0).integers(0, 255, (b, s, s, 3),
                                               np.uint8)
    labels = np.array([[0, 0, 0.3, 0.4, 0.2, 0.25] + [0.3, 0.4] * 5,
                       [0, 0, 0.7, 0.6, 0.15, 0.2] + [0.7, 0.6] * 5,
                       [1, 0, 0.5, 0.5, 0.3, 0.3] + [0.5, 0.5] * 5],
                      np.float32)
    # the fixed batch's targets on the card once, as the JAX test puts
    # them on the device once
    targets = TLOSS.targets_to_device(build_targets_batched(
        labels, b, spec, [(s // st, s // st) for st in spec.strides],
        cap_per_image=64), "cuda")
    cfg = TR.TrainConfig(epochs=10, steps_per_epoch=40, lr0=0.01,
                         warmup_epochs=0.5, min_warmup_steps=20,
                         batch_size=b)
    step = TR.make_train_step(net, cfg, dict(HYP_SCRATCH_P6,
                                             weight_decay=0.0), s)
    state = TR.create_train_state(net)
    x = torch.as_tensor(images).cuda()
    first = None
    t0 = time.perf_counter()
    for _ in range(LEARN_STEPS):
        state, _, comps = step(state, x, targets)
        if first is None:
            first = comps.cpu().numpy()
    last = comps.cpu().numpy()
    _, _, after = step(state, x, targets)
    after = after.cpu().numpy()
    secs = time.perf_counter() - t0
    check(last[5] < 0.5 * first[5] and after[0] < 0.1,
          f"{LEARN_MODEL} ({DTYPE_NAMES[dtype]}) did not overfit: total "
          f"{first[5]} -> {last[5]}, box after {after[0]}")
    prof = kernel_profile(lambda: step(state, x, targets))
    print(f"train {LEARN_MODEL} ({DTYPE_NAMES[dtype]}) overfits b{b}@{s} "
          f"on {smi}: total loss "
          f"{first[5]:.5f} -> {last[5]:.5f} in {LEARN_STEPS} steps (< half), "
          f"box {after[0]:.5f} (< 0.1); {secs * 1e3 / (LEARN_STEPS + 1):.3f} "
          f"ms a step by the host clock; one traced step: "
          f"{prof['wall_ms']:.3f} ms, kernels {prof['kernel_ms']:.3f} ms in "
          f"{prof['launches']} launches (busy "
          f"{prof['kernel_ms'] / prof['wall_ms']:.3f})")
    del net, state
    return {"first_total": float(first[5]), "last_total": float(last[5]),
            "box_after": float(after[0])}


def states_equal(a: TR.TrainState, b: TR.TrainState) -> bool:
    pairs = [(a.model.state_dict(), b.model.state_dict()),
             (a.momentum_buf, b.momentum_buf), (a.ema_params, b.ema_params),
             (a.second_moment or {}, b.second_moment or {})]
    return (a.step, a.ema_updates) == (b.step, b.ema_updates) and all(
        x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
        for x, y in pairs)


def drive_train_epoch(smi: str, tmp: str,
                      dtype: torch.dtype = torch.float32) -> None:
    """Phase 22(d): cli/train.train_run on the card over in-memory sets
    (EPOCH_TRAIN training and EPOCH_VAL validation images at EPOCH_SIZE,
    batch 2, nominal batch 4: 2 micro-steps and an apply), one epoch, with
    `--dtype` the compute dtype: the epoch-end validate on the EMA model
    launches nms_keep once a validation batch and the fixpoint kernel
    never; `last` and `best` load back equal to the final state, every
    tensor float32; best_inference.npz, loaded by
    FaceDetector(torch_weights=) on the card, serves the EMA model's
    Detections."""
    name = DTYPE_NAMES[dtype]
    tag = f"{TRAIN_MODEL} train validate" + (
        "" if dtype == torch.float32 else f" {name}")
    spec = zoo.get_spec(TRAIN_MODEL)
    rng = np.random.default_rng(60)
    train_ds = memory_faces(rng, EPOCH_TRAIN, EPOCH_SIZE, spec.max_stride)
    val_ds = memory_faces(rng, EPOCH_VAL, EPOCH_SIZE, spec.max_stride)
    args = TRAIN_CLI.parse_args([
        "--model", TRAIN_MODEL, "--data", "in-memory", "--img-size",
        str(EPOCH_SIZE), "--batch-size", "2", "--nominal-batch", "4",
        "--epochs", "1", "--val-batch-size", str(EPOCH_VAL_BATCH),
        "--min-warmup-steps", "1", "--project", tmp, "--name", "train",
        "--noautoanchor", "--no-tensorboard", "--workers", "1",
        "--dtype", name, "--device", "cuda"])
    zero_counters()
    (_, ms) = timed(lambda: TRAIN_CLI.train_run(
        args, quiet=True, datasets=(train_ds, val_ds)))
    got = counts_since_zero()
    batches = EPOCH_VAL // EPOCH_VAL_BATCH
    check(got == {"seq": batches, "fixpoint": 0, "fused": 0, "qconv": 0},
          f"{tag}: launches {got} for {batches} validation batches")
    TRAIN_LAUNCHES[tag] = got["seq"]
    state = TRAIN_CLI.train_run.last["state"]
    check(state.step == 1 and state.ema_updates == 1
          and state.model.compute_dtype == (
              None if dtype == torch.float32 else dtype),
          f"{tag}: {state.step} applies, want 1")
    weights = os.path.join(tmp, "train", "weights")
    for ckpt in ("last", "best"):
        other = TR.create_train_state(init_weights(
            YoloFace(zoo.get_spec(TRAIN_MODEL), dtype=dtype),
            torch.Generator().manual_seed(9)).cuda())
        _, meta = CKPT.load_checkpoint(weights, ckpt, other)
        dtypes = {t.dtype for t in list(other.model.state_dict().values())
                  + list(other.momentum_buf.values())
                  + list(other.ema_params.values()) if t.is_floating_point()}
        check(states_equal(other, state) and meta["epoch"] == 0
              and dtypes == {torch.float32},
              f"{tag}: {ckpt} loaded back differs from the saved state "
              f"(dtypes {dtypes})")
    frames = np.ascontiguousarray(val_ds.images[:EPOCH_VAL_BATCH])
    kw = dict(img_sizes=(EPOCH_SIZE,), conf_thres=0.001, device="cuda")
    stripped = FaceDetector(TRAIN_MODEL, torch_weights=os.path.join(
        weights, "best_inference.npz"), **kw)
    served = FaceDetector(TRAIN_MODEL, variables=TR.ema_model(
        state).state_dict(), **kw)
    a, b = stripped.run_network(frames), served.run_network(frames)
    kept = int(a.valid.sum())
    check(same_detections(a, b) and kept > 0,
          f"{tag}: best_inference.npz serves other Detections than the "
          f"EMA model ({kept} kept)")
    res = json.loads(open(os.path.join(tmp, "train", "results.txt"))
                     .read().split(" ", 7)[-1].rsplit(" ", 1)[0])
    print(f"{tag} on {smi}: 1 epoch of {EPOCH_TRAIN // 2} micro-steps "
          f"b2@{EPOCH_SIZE} (1 apply), validate b{EPOCH_VAL_BATCH} over "
          f"{EPOCH_VAL} images on the EMA model: nms_keep launches "
          f"{got['seq']}, fixpoint 0; P {res['mp']:.6f} R {res['mr']:.6f} "
          f"mAP50 {res['map50']:.6f}; last and best load back equal; "
          f"best_inference.npz serves the EMA model's Detections ({kept} "
          f"kept on {EPOCH_VAL_BATCH} frames); train_run {ms:.1f} ms")
    del stripped, served, state
    torch.cuda.empty_cache()


def drive_phase22(smi: str) -> dict:
    """Phase 22: the training path on the card, in float32 and in bf16
    mixed precision. Returns the timed runs' numbers by dtype."""
    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    parity = {}
    for dtype in (torch.float32, bf16):
        parity[dtype] = p = train_step_parity(
            lambda: zoo.get_spec(TRAIN_MODEL), PARITY_SIZE, PARITY_BATCH,
            seed=7, compute=dtype)
        print(f"train {TRAIN_MODEL} one micro-step b{PARITY_BATCH}@"
              f"{PARITY_SIZE} ({DTYPE_NAMES[dtype]}) on {smi}, tolerance "
              f"ratios (loss rtol {TRAIN_LOSS_RTOL}, params and EMA "
              f"{TRAIN_PARAM_TOL}, BN rtol {TRAIN_BN_RTOL}): card against "
              f"the exact float64 step {p['card']}, the CPU's "
              f"{DTYPE_NAMES[dtype]} step against it {p['cpu']}, card "
              f"against CPU {p['card_cpu']}; components "
              f"{p['components'].tolist()}")
    total32 = float(parity[torch.float32]["components"][5])
    total16 = float(parity[bf16]["components"][5])
    check(abs(total16 - total32) <= TRAIN_BF16_LOSS_RTOL * abs(total32),
          f"bf16 train step: loss {total16} against the float32 step's "
          f"{total32}, beyond rtol {TRAIN_BF16_LOSS_RTOL}")
    print(f"train {TRAIN_MODEL} bf16 micro-step loss {total16:.6f} against "
          f"float32 {total32:.6f} on the card (rel "
          f"{abs(total16 - total32) / abs(total32):.5f}, rtol "
          f"{TRAIN_BF16_LOSS_RTOL})")
    stamp("phase 22a (train step parity, float32 and bf16) done")
    timed_out = {DTYPE_NAMES[d]: drive_train_timed(smi, d)
                 for d in (torch.float32, bf16)}
    a, b = timed_out["float32"], timed_out["bfloat16"]
    print(f"train {TRAIN_MODEL} b{TIMED_BATCH}@{TIMED_SIZE} bf16 beside "
          f"float32 on {smi}: micro-step {b['micro_ms']:.3f} / "
          f"{a['micro_ms']:.3f} ms, apply {b['apply_ms']:.3f} / "
          f"{a['apply_ms']:.3f} ms, {b['img_s_micro']:.2f} / "
          f"{a['img_s_micro']:.2f} img/s, peak {b['peak_bytes'] / 2**30:.3f}"
          f" / {a['peak_bytes'] / 2**30:.3f} GiB, traced busy share "
          f"{b['busy_share']:.3f} / {a['busy_share']:.3f}, launches "
          f"{b['launches']} / {a['launches']}")
    stamp("phase 22b (timed training, float32 and bf16) done")
    for dtype in (torch.float32, bf16):
        drive_train_learns(smi, dtype)
    stamp("phase 22c (overfit, float32 and bf16) done")
    for dtype in (torch.float32, bf16):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_",
                                         dir=ROOT) as tmp:
            drive_train_epoch(smi, tmp, dtype)
    stamp(f"phase 22d (epoch end, float32 and bf16) done; phase 22 took "
          f"{time.perf_counter() - t0:.1f} s")
    return timed_out


# ---------------------------------------------------------------------------
# phase 23: export
# ---------------------------------------------------------------------------

def live_request(net, spec, frames, dtype, conf, iou, max_det):
    """The live card pipeline of an exported program: uint8 frames to the
    card, `dtype` / 255, the served model, decode, non_max_suppression at
    the export's capacity."""
    x = torch.as_tensor(frames).cuda().to(dtype) / 255.0
    with torch.inference_mode(), full_fp32():
        return NMS.non_max_suppression(
            decode(net(x), spec), conf, iou, nc=spec.nc, nkpt=spec.nkpt,
            max_candidates=EXPORT_K, max_det=max_det)


def fields_agree(got, want: NMS.Detections, dtype, tag: str) -> str:
    """`valid` equal; the other four fields exact, or within phase 4's
    decoded-row tolerance (float32) or phase 9's bf16 share of max |field|
    (bf16). Returns which held."""
    check(len(got) == 5 and torch.equal(got[4], want.valid),
          f"{tag}: valid differs from the live pipeline's")
    if all(torch.equal(g, w) for g, w in zip(got[:4], want[:4])):
        return "exact"
    for name, g, w in zip(("boxes", "scores", "classes", "extras"),
                          got[:4], want[:4]):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{tag}: {name} {tuple(g.shape)} {g.dtype} against "
              f"{tuple(w.shape)} {w.dtype}")
        g, w = g.float(), w.float()
        if dtype == torch.bfloat16:
            share = float((g - w).abs().max() / w.abs().max().clamp(
                min=1e-30))
            check(share < BF16_RAW_SHARE, f"{tag}: {name} {share:.4g} of "
                                          f"max |{name}| off the live")
        else:
            check(bool(((g - w).abs() <= ROW_TOL["atol"]
                        + ROW_TOL["rtol"] * w.abs()).all()),
                  f"{tag}: {name} beyond {ROW_TOL} of the live pipeline")
    return ("within phase 9's bf16 share" if dtype == torch.bfloat16
            else f"within {ROW_TOL}")


def export_and_load(model, spec, tmp: str, tag: str, **kw):
    """trace_program on the card, save, drop the in-memory program, then
    load_program. Returns (the loaded program, {export_s, save_s, load_s,
    bytes})."""
    t0 = time.perf_counter()
    exported = EXPORT.trace_program(model, spec, device="cuda", **kw)
    t1 = time.perf_counter()
    path = os.path.join(tmp, tag.replace(" ", "_") + ".pt2")
    EXPORT.save_program(exported, path, {})
    t2 = time.perf_counter()
    del exported
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    prog = EXPORT.load_program(path)
    t4 = time.perf_counter()
    return prog, {"export_s": t1 - t0, "save_s": t2 - t1,
                  "load_s": t4 - t3, "bytes": os.path.getsize(path)}


def app_gate(rows: torch.Tensor) -> float:
    """The native app's gate on one frame's decoded rows (1, N, no): the
    midpoint of the widest gap between consecutive conf = obj * cls values
    ranked APP_GATED, so that between 300 and 800 rows gate (the app does
    not truncate; the card's K of 2048 then holds them all) and no row
    lies near the gate. With one class conf <= obj, so the two-stage gate
    is conf > gate."""
    conf = (rows[0, :, 4] * rows[0, :, 5]).float().sort(descending=True)[0]
    lo, hi = APP_GATED
    band = conf[lo - 1:hi + 1].cpu().double()
    i = int(torch.argmax(band[:-1] - band[1:]))
    return float((band[i] + band[i + 1]) / 2)


def drive_native_app(model, spec, frames: np.ndarray, smi: str, tmp: str,
                     live_net) -> dict:
    """Phase 23(b): w6 b1@640 exported with raw heads, the loaded program on
    the card, dump_raw_heads, the port's fdms_detect against the card's
    live Detections of the frame."""
    prog, costs = export_and_load(model, spec, tmp, "w6 raw", img_size=SIZE,
                                  batch=1, raw_heads=True)
    frame = frames[:1]
    raws = prog(frame)
    check(len(raws) == spec.nl and all(
        r.shape[:2] == (1, spec.na) and bool(torch.isfinite(r).all())
        for r in raws), "w6 raw program: bad raw maps")
    with torch.inference_mode(), full_fp32():
        x = torch.as_tensor(frame).cuda().float() / 255.0
        raws_live = live_net(x)
        rows = decode(raws_live, spec)
    raw_err = max(float((a - b).abs().max()) for a, b in zip(raws,
                                                             raws_live))
    gate = app_gate(rows)
    with torch.inference_mode():
        dets = NMS.non_max_suppression(rows, gate, APP_IOU, nc=spec.nc,
                                       max_candidates=EXPORT_K,
                                       max_det=APP_MAX_DET)
    n_gated = int(dets.n_gated[0])
    check(n_gated <= EXPORT_K, f"native app: {n_gated} rows gated, more "
                               f"than K = {EXPORT_K}")
    want = NMS.detections_to_numpy(dets)[0][:, :5]
    path = os.path.join(tmp, "w6_heads.bin")
    t0 = time.perf_counter()
    NAT.dump_raw_heads(path, raws, spec)
    dump_ms = (time.perf_counter() - t0) * 1e3
    NAT.build_app()
    app_ms, got = [], None
    for _ in range(3):
        t0 = time.perf_counter()
        got = NAT.run_native_detector(path, gate, APP_IOU, APP_MAX_DET)
        app_ms.append((time.perf_counter() - t0) * 1e3)
    spawn_ms = []  # what starting a process costs there, apart
    for _ in range(3):
        t0 = time.perf_counter()
        subprocess.run(["true"], check=True)
        spawn_ms.append((time.perf_counter() - t0) * 1e3)
    check(got.shape == want.shape and len(got) > 0,
          f"native app: {got.shape[0]} rows, the card's Detections "
          f"{want.shape[0]}")
    # rows whose confs agree to a few ulps may come out in either order
    # (the app's sigmoid is C++'s): each app row is paired with the
    # nearest card row, one to one
    pair = np.abs(got[:, None] - want[None]).max(-1).argmin(1)
    check(len(set(pair.tolist())) == len(pair),
          "native app: rows pair up twice with the card's")
    swapped = int((pair != np.arange(len(pair))).sum())
    want = want[pair]
    box_err = float(np.abs(got[:, :4] - want[:, :4]).max())
    conf_err = float(np.abs(got[:, 4] - want[:, 4]).max())
    check(box_err <= APP_BOX_ATOL and conf_err <= APP_CONF_ATOL,
          f"native app: boxes {box_err:.4g} (atol {APP_BOX_ATOL}), conf "
          f"{conf_err:.4g} (atol {APP_CONF_ATOL}) off the card's")
    out = {**costs, "gate": gate, "gated": n_gated, "rows": len(got),
           "rows_in_another_order": swapped, "raw_err_vs_live": raw_err,
           "max_box_err": box_err, "max_conf_err": conf_err,
           "dump_ms": dump_ms, "app_ms": float(np.median(app_ms)),
           "spawn_ms": float(np.median(spawn_ms))}
    print(f"phase 23(b) native app on w6 b1@{SIZE} raw heads ({smi}): "
          f"export {costs['export_s']:.2f} s, save {costs['save_s']:.2f} s, "
          f"load {costs['load_s']:.2f} s, {costs['bytes']} bytes; its maps "
          f"within {raw_err:.3g} of the live forward's; gate "
          f"{gate:.6g} ({n_gated} rows gated), {len(got)} rows as the "
          f"card's Detections ({swapped} of them in another order: "
          f"confs within ulps), boxes within {box_err:.3g}, conf within "
          f"{conf_err:.3g}; dump {dump_ms:.3f} ms, the app "
          f"{out['app_ms']:.3f} ms a frame (median of 3, process start "
          f"and file read included; starting `true` alone "
          f"{out['spawn_ms']:.3f} ms)")
    return out


def drive_export(smi: str, frames: np.ndarray, gate: float,
                 qconv_entry: dict) -> dict:
    """Phase 23: (a) w6 b8@640 exported with its postprocess on the card,
    saved, loaded and served, float32 then bf16, against the live card
    pipeline; (b) the native app on a raw-heads export; (c) phase 20's w6
    int8 request, unchanged. Returns the numbers for the kernels line."""
    name = "yolov7-w6-face"
    spec = zoo.get_spec(name).resolve()
    model = init_weights(YoloFace(spec), torch.Generator().manual_seed(0))
    out = {"gate": gate}
    with tempfile.TemporaryDirectory() as tmp:
        live_f32 = None
        for dtype in (torch.float32, torch.bfloat16):
            dn = DTYPE_NAMES[dtype]
            tag = f"w6 {dn} pt2"
            kw = dict(img_size=SIZE, batch=BATCH, conf_thres=gate,
                      iou_thres=0.5, max_det=300, dtype=dtype)
            prog, costs = export_and_load(model, spec, tmp, tag, **kw)
            nodes = EXPORT.op_count(prog.exported, "fdms_torch.nms_keep")
            check(nodes == 1, f"{tag}: {nodes} fdms_torch.nms_keep nodes")
            live = EXPORT.serving_model(model, dtype, "cuda")
            prog(frames[0])  # warm-up, not counted
            zero_counters()
            for r in range(REQUESTS):
                got = prog(frames[r])
                torch.cuda.synchronize()
                check(K.nms_keep.launches == r + 1,
                      f"{tag}: nms_keep launched {K.nms_keep.launches} "
                      f"times in {r + 1} calls of the loaded program")
            counts = {"seq": K.nms_keep.launches,
                      "fixpoint": K.nms_keep.fixpoint_launches,
                      "fused": E.fused_elan.launches
                      + E.fused_elan.bf16_launches}
            check(counts == {"seq": REQUESTS, "fixpoint": 0, "fused": 0},
                  f"{tag}: launches {counts}")
            EXPORT_LAUNCHES[tag] = counts["seq"]
            want = live_request(live, spec, frames[REQUESTS - 1], dtype,
                                gate, 0.5, 300)
            held = fields_agree(got, want, dtype, tag)
            kept = got[4].sum(1).tolist()
            # the loaded program against the live pipeline, interleaved
            times = {"program": [], "live": []}
            for r in range(EXPORT_ROUNDS):
                order = (("program", "live") if r % 2 == 0
                         else ("live", "program"))
                for which in order:
                    fn = (lambda: prog(frames[r % REQUESTS])) \
                        if which == "program" else \
                        (lambda: live_request(live, spec,
                                              frames[r % REQUESTS], dtype,
                                              gate, 0.5, 300))
                    _, ms = timed(fn)
                    times[which].append(ms)
            med = {k: float(np.median(v)) for k, v in times.items()}
            out[dn] = {**costs, "launches": counts["seq"],
                       "agreement": held, "kept": kept,
                       "program_ms": med["program"], "live_ms": med["live"],
                       "program_ms_all": times["program"],
                       "live_ms_all": times["live"]}
            print(f"phase 23(a) {tag} b{BATCH}@{SIZE} on {smi}: export "
                  f"{costs['export_s']:.2f} s, save {costs['save_s']:.2f} s, "
                  f"load {costs['load_s']:.2f} s, {costs['bytes']} bytes; 1 "
                  f"fdms_torch.nms_keep node; nms_keep launches "
                  f"{counts['seq']} in {REQUESTS} calls, fixpoint 0, "
                  f"fused_elan 0; fields against the live pipeline: valid "
                  f"exact, the rest {held}; kept {kept}; a b{BATCH} request "
                  f"(median of {EXPORT_ROUNDS}, interleaved, host clock, "
                  f"synchronized): loaded program {med['program']:.3f} ms "
                  f"{[round(v, 3) for v in times['program']]}, live "
                  f"{med['live']:.3f} ms "
                  f"{[round(v, 3) for v in times['live']]}")
            del prog
            if dtype == torch.float32:
                live_f32 = live
            else:
                del live
            torch.cuda.empty_cache()
            stamp(f"phase 23(a) {tag} done")
        out["app"] = drive_native_app(model, spec, frames[0], smi, tmp,
                                      live_f32)
        del live_f32
        torch.cuda.empty_cache()
    stamp("phase 23(b) native app done")
    # (c): the live int8 walk still calls the wrapper (no custom op)
    qc = qconv_entry["launches_by_path"][f"{name} int8"]
    w6_int8 = qconv_entry["by_model"][name]
    check(qc["qconv"] == INT8_REQUESTS * 107
          and qc["wgmma"] == INT8_REQUESTS * INT8_WGMMA[name],
          f"phase 23(c): the w6 int8 request's qconv launches {qc}, want "
          f"107 ({INT8_WGMMA[name]} wgmma) a request")
    out["int8_request_ms"] = w6_int8["request_ms"]
    print(f"phase 23(c) w6 int8 b{BATCH}@{SIZE} (phase 20, one run, not a "
          f"claim): {qc['qconv'] // INT8_REQUESTS} qconv launches a request "
          f"({qc['wgmma'] // INT8_REQUESTS} wgmma), request "
          f"{w6_int8['request_ms']:.3f} ms beside the "
          f"{INT8_W6_RECORDED_MS} ms that PERF.md §5 records")
    stamp("phase 23 (export) done")
    return out


# ---------------------------------------------------------------------------
# phase 24: the extra blocks (models/layers_extra.py) on the card
# ---------------------------------------------------------------------------

def extra_spec():
    """The extra cfg, yolov7s-face at full width with extra ops in its
    nodes (tests/data/yolov7s-face-extra.json, a reference-format cfg
    written as JSON)."""
    return spec_from_yolo_yaml(json.loads(EXTRA_CFG.read_text()), EXTRA_NAME)


def extra_blocks():
    """Phase 24(e): (label, module, inputs) of each extra block, activation
    module, Classify and function, NCHW, at widths of the extra cfg's
    stride-16 and stride-32 levels (C3TR on a non-square map); seeded."""
    torch.manual_seed(24)
    gen = torch.Generator().manual_seed(24)

    def maps(*shapes):
        return [torch.randn(s, generator=gen) for s in shapes]

    return [
        ("CrossConv", LX.CrossConv(104, 104, 3, 1), maps((2, 104, 40, 40))),
        ("CrossConv s2", LX.CrossConv(56, 104, 3, 2, e=0.5),
         maps((2, 56, 40, 24))),
        ("Sum weighted", LX.Sum(3, True), [maps(*[(2, 56, 80, 80)] * 3)]),
        ("GhostConv", LX.GhostConv(32, 56, 3, 2), maps((2, 32, 160, 160))),
        ("GhostBottleneck s1", LX.GhostBottleneck(104, 104, 3, 1),
         maps((2, 104, 40, 40))),
        ("GhostBottleneck s2", LX.GhostBottleneck(56, 56, 3, 2),
         maps((2, 56, 80, 80))),
        ("MixConv2d", LX.MixConv2d(32, 32, (1, 3, 5)),
         maps((2, 32, 80, 120))),
        ("C3TR 20x36", LX.C3TR(208, 208, 2), maps((2, 208, 20, 36))),
        ("TransformerLayer", LX.TransformerLayer(104, 4),
         maps((400, 2, 104))),
        ("BottleneckCSPF", LX.BottleneckCSPF(104, 56, 2),
         maps((2, 104, 40, 40))),
        ("BottleneckCSP2", LX.BottleneckCSP2(416, 104, 2),
         maps((2, 416, 40, 40))),
        ("SPPCSP", LX.SPPCSP(416, 208), maps((2, 416, 20, 20))),
        ("ConvFocus", LX.ConvFocus(3, 32, 3), maps((2, 3, 128, 192))),
        ("Classify", LX.Classify(208 + 104, 10),
         [maps((2, 208, 20, 20), (2, 104, 40, 40))]),
        ("FReLU", LX.FReLU(104), maps((2, 104, 40, 40))),
        ("AconC", LX.AconC(104, gen), maps((2, 104, 40, 40))),
        ("MetaAconC", LX.MetaAconC(104, generator=gen),
         maps((2, 104, 40, 40))),
        ("contract", FnModule(LX.contract, 2), maps((2, 104, 40, 40))),
        ("expand", FnModule(LX.expand, 2), maps((2, 416, 20, 20))),
        ("silu", FnModule(LX.silu), maps((2, 104, 40, 40))),
        ("hardswish", FnModule(LX.hardswish), maps((2, 104, 40, 40))),
        ("mish", FnModule(LX.mish), maps((2, 104, 40, 40)))]


class FnModule(torch.nn.Module):
    """A function of models/layers_extra.py as a module."""

    def __init__(self, f, *args):
        super().__init__()
        self.f, self.args = f, args

    def forward(self, x):
        return self.f(x, *self.args)


@torch.inference_mode()
def check_extra_blocks(smi: str) -> float:
    """Phase 24(e): each block alone on the card against its CPU output at
    the forward tolerance (TF32 off). Returns the worst diff / limit."""
    worst = 0.0
    for label, mod, inputs in extra_blocks():
        mod = mod.eval()
        want = mod(*inputs)
        card = copy.deepcopy(mod).cuda()
        args = [[x.cuda() for x in a] if isinstance(a, list) else a.cuda()
                for a in inputs]
        with full_fp32():
            got = card(*args)
        torch.cuda.synchronize()
        got = got.cpu()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"extra block {label}: bad card output")
        err = (got - want).abs()
        lim = EXTRA_BLOCK_TOL["atol"] + EXTRA_BLOCK_TOL["rtol"] * want.abs()
        ratio = float((err / lim).max())
        worst = max(worst, ratio)
        print(f"extra block {label} {tuple(want.shape)} on {smi}: card vs "
              f"CPU max |diff| {float(err.max()):.3g}, worst diff/limit "
              f"{ratio:.3g}")
        check(ratio <= 1.0, f"extra block {label}: card beyond "
                            f"{EXTRA_BLOCK_TOL} of the CPU output")
    return worst


def traced_request(det: FaceDetector, frames: np.ndarray, smi: str):
    """One request traced with utils/profiling.trace (after an untraced
    one), printed: host-clock ms, device busy ms and its share, device
    events, and the top kernels by device time. Returns them."""
    det.run_network(frames)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_",
                                     dir=ROOT) as tmp:
        with PROF.trace(tmp) as prof:
            t0 = time.perf_counter()
            det.run_network(frames)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    busy = PROF.device_busy_ms(prof)
    out = {"wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall,
           "device_events": sum(n for _, n in by_name.values()),
           "top": [{"name": k[:120], "ms": ms, "launches": n}
                   for k, (ms, n) in top]}
    print(f"{det.spec.name} {DTYPE_NAMES[det.dtype]} request traced "
          f"(utils/profiling.trace) on {smi}: {wall:.3f} ms host clock, "
          f"device busy {busy:.3f} ms (share {busy / wall:.3f}), "
          f"{out['device_events']} device events; top "
          + "; ".join(f"{t['name'][:70]} {t['ms']:.3f} ms x{t['launches']}"
                      for t in out["top"]))
    return out


def drive_phase24(smi: str) -> dict:
    """Phase 24: the extra cfg served on the card (float32, bf16, fused in
    both), int8's refusal, each extra block alone, one float32 train
    micro-step, and the printed numbers. Returns the kernels line's
    `extra` fields."""
    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    spec = extra_spec()
    ops = {n.op for n in spec.nodes}
    check(EXTRA_OPS <= ops, f"the extra cfg lacks {EXTRA_OPS - ops}")
    GROUPS[EXTRA_NAME] = len(FUSED.find_elan_blocks(spec))
    check(GROUPS[EXTRA_NAME] >= 2, "the extra cfg keeps no E-ELAN group")
    frames = np.random.default_rng(EXTRA_SEED).integers(
        0, 256, (EXTRA_REQUESTS, BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    c3tr = next(i for i, n in enumerate(spec.nodes) if n.op == "C3TR")
    c3tr_in = torch.randn(BATCH, spec.nodes[c3tr].c1, SIZE // 32,
                          SIZE // 32, generator=torch.Generator()
                          .manual_seed(EXTRA_SEED)).cuda()
    out = {"groups": GROUPS[EXTRA_NAME], "c3tr_ms": {}}

    # (a) float32, unfused: rows against the CPU forward, Detections
    # against the CPU postprocess of the card's rows, one nms_keep a
    # request
    _, _, ref, det, raws32 = drive_path(
        EXTRA_NAME, smi, EXTRA_SEED, frames, requests=EXTRA_REQUESTS,
        spec_fn=extra_spec)
    with torch.inference_mode(), full_fp32():
        out["c3tr_ms"]["float32"] = cuda_ms(
            lambda: det.model.model[c3tr](c3tr_in), 10)
    out["traced"] = {"float32": traced_request(det, frames[0], smi)}
    gate = det.conf_thres
    del det
    torch.cuda.empty_cache()

    # (d) int8: the W8A8 walker has no extra op, in either package
    try:
        FaceDetector(extra_spec(), quantize="int8", device="cuda")
    except NotImplementedError as err:
        check("ConvFocus" in str(err), f"int8 on the extra cfg raised "
                                       f"without naming its op: {err}")
        print(f"{EXTRA_NAME} quantize='int8': NotImplementedError({err})")
    else:
        raise SystemExit("chip_smoke: FAILED: int8 on the extra cfg did "
                         "not raise")

    # (b) bf16, unfused, against the float32 card raws
    *_, det, raws16 = drive_path(
        EXTRA_NAME, smi, EXTRA_SEED, frames, requests=EXTRA_REQUESTS,
        dtype=bf16, ref_raws=[("the float32 card forward", raws32)],
        spec_fn=extra_spec)
    with torch.inference_mode():
        out["c3tr_ms"]["bfloat16"] = cuda_ms(
            lambda: det.model.model[c3tr](c3tr_in.to(bf16)), 10)
    out["traced"]["bfloat16"] = traced_request(det, frames[0], smi)
    del det
    torch.cuda.empty_cache()

    # (c) fused in float32 and bf16: each group against its plain version,
    # the launches as find_elan_blocks predicts, Sum and the extra blocks
    # between the groups through the model's own modules
    worst = {}
    for dtype in (torch.float32, bf16):
        *_, det, _ = drive_path(
            EXTRA_NAME, smi, EXTRA_SEED, frames, fuse_elan=True,
            requests=EXTRA_REQUESTS, dtype=dtype,
            ref=ref if dtype == torch.float32 else None,
            ref_raws=[("the bf16 unfused card forward", raws16)],
            spec_fn=extra_spec)
        w_abs, w_rel, _ = check_groups(det, frames[0], smi, timed=False)
        worst[DTYPE_NAMES[dtype]] = {"abs": w_abs, "rel": w_rel}
        del det
        torch.cuda.empty_cache()
    out["group_err"] = worst
    stamp("phase 24(a)-(d) (the extra cfg served) done")

    # (e) each block alone
    out["block_worst_ratio"] = check_extra_blocks(smi)
    stamp("phase 24(e) (extra blocks alone) done")

    # (f) one float32 micro-step of the extra cfg, card against CPU
    p = train_step_parity(extra_spec, PARITY_SIZE, PARITY_BATCH,
                          seed=EXTRA_SEED)
    loss_rel = p["card_cpu"]["loss"] * TRAIN_LOSS_RTOL
    check(loss_rel <= EXTRA_STEP_LOSS_RTOL,
          f"{EXTRA_NAME} train step: card loss off the CPU's by "
          f"{loss_rel:.3g} (rtol {EXTRA_STEP_LOSS_RTOL})")
    print(f"train {EXTRA_NAME} one float32 micro-step b{PARITY_BATCH}@"
          f"{PARITY_SIZE} on {smi}, tolerance ratios (loss rtol "
          f"{TRAIN_LOSS_RTOL}, params and EMA {TRAIN_PARAM_TOL}, BN rtol "
          f"{TRAIN_BN_RTOL}): card against the exact float64 step "
          f"{p['card']}, the CPU's float32 step against it {p['cpu']}, "
          f"card against CPU {p['card_cpu']}; components "
          f"{p['components'].tolist()}")
    out["train_step"] = {k: p[k] for k in ("card", "cpu", "card_cpu")}
    stamp("phase 24(f) (extra cfg train step) done")

    # (g) the numbers
    info = {name: PROF.model_info(YoloFace(fn()), img_size=SIZE,
                                  verbose=False)
            for name, fn in (("yolov7-w6-face",
                              lambda: zoo.get_spec("yolov7-w6-face")),
                             (EXTRA_NAME, extra_spec))}
    out["model_info"] = info
    out["request_ms"] = {tag[len(EXTRA_NAME) + 1:] or "float32": ms
                         for tag, ms in PATH_MS.items()
                         if tag.startswith(EXTRA_NAME)}
    out["gate"] = gate
    # the plain yolov7s-face's requests of phases 12-13, where this run had
    # them (the same card, one call)
    out["yolov7s_face_request_ms"] = {
        tag[len("yolov7s-face") + 1:] or "float32": ms
        for tag, ms in PATH_MS.items()
        if tag in ("yolov7s-face", "yolov7s-face bf16")}
    print(f"phase 24 on {smi}: model_info {info}; C3TR b{BATCH}@{SIZE} "
          f"(node {c3tr}, {tuple(c3tr_in.shape)}) float32 "
          f"{out['c3tr_ms']['float32']:.4f} ms, bf16 "
          f"{out['c3tr_ms']['bfloat16']:.4f} ms; requests b{BATCH}@{SIZE} "
          f"(median ms, host clock) {out['request_ms']}, yolov7s-face's "
          f"{out['yolov7s_face_request_ms']}; traced request busy share "
          f"{ {d: round(t['busy_share'], 4) for d, t in out['traced'].items()} }")
    stamp(f"phase 24 (extra blocks) took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phases 25-26: the data-parallel mesh (parallel/mesh.py)
# ---------------------------------------------------------------------------

MESH_RANKS = 2     # phases 25b and 26: processes sharing the card over gloo
MESH_REQUESTS = 2  # phase 25a: requests a serving mode
MESH_MODES = (("float32", {}), ("bf16", {"dtype": torch.bfloat16}),
              ("fused", {"fuse_elan": True}), ("int8", {"quantize": "int8"}))
MESH_TRAIN_SIZE, MESH_TRAIN_BATCH, MESH_MICRO = 640, 16, 2   # phase 26
MESH_SEED = 8
MESH_TIMEOUT = 600.0
# every counted mesh call: {tag: counts_since_zero() of the call(s)}
MESH_LAUNCHES = {}


def qconv_routes() -> dict:
    return {"qconv": QK.qconv.launches, "wgmma": QK.qconv.wgmma_launches,
            "split": QK.qconv.split_launches,
            "depthwise": QK.qconv.depthwise_launches}


def add_counts(acc: dict, more: dict) -> dict:
    for key, v in more.items():
        acc[key] = acc.get(key, 0) + v
    return acc


def drive_mesh_world_of_one(smi: str, frames: np.ndarray, gate: float
                            ) -> dict:
    """Phase 25a: a world of one process over NCCL, in this process:
    FaceDetector("yolov7-w6-face", mesh=make_data_mesh()) in each serving
    mode on phase 4's seed, frames and gate, beside the same detector
    without a mesh; every request's Detections equal bit for bit, the
    same launches of every kernel, one nms_keep a call. The int8 mesh
    detector calibrates on its first batch (before the mesh splits it)
    and broadcasts its qparams; the mesh-less one serves the same
    qparams. Returns qconv's launches by route."""
    routes = {}
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{PMESH._free_port()}",
        world_size=1, rank=0)
    try:
        mesh = PMESH.make_data_mesh()
        check(mesh.backend == "nccl" and mesh.size == 1
              and mesh.group is not None, f"phase 25a mesh {mesh}")
        for mode, kw in MESH_MODES:
            tag = f"yolov7-w6-face {mode} mesh of 1 (nccl)"
            common = dict(img_sizes=(SIZE,), conf_thres=gate, iou_thres=0.5,
                          max_candidates=MAX_CANDIDATES, seed=0,
                          device="cuda", **kw)
            meshed = FaceDetector("yolov7-w6-face", mesh=mesh, **common)
            plain = FaceDetector("yolov7-w6-face", **common)
            counts, ms = {}, []
            for r in range(MESH_REQUESTS):
                zero_counters()
                got, t = timed(lambda: meshed.run_network(frames[r]))
                call = counts_since_zero()
                if mode == "int8":
                    add_counts(routes, qconv_routes())
                    plain._qparams = meshed._qparams
                add_counts(counts, call)
                ms.append(t)
                zero_counters()
                want = plain.run_network(frames[r])
                check(same_detections(got, want),
                      f"{tag}: request {r}'s Detections differ from the "
                      f"mesh-less detector's")
                check(counts_since_zero() == call,
                      f"{tag}: launches {counts_since_zero()} without the "
                      f"mesh against {call} with it")
            check(counts["seq"] == MESH_REQUESTS and counts["fixpoint"] == 0,
                  f"{tag}: nms_keep launches {counts} for {MESH_REQUESTS} "
                  f"calls")
            MESH_LAUNCHES[tag] = counts
            print(f"{tag} b{BATCH}@{SIZE} on {smi}: Detections equal to the "
                  f"mesh-less detector's in {MESH_REQUESTS} requests; "
                  f"launches {counts}; ms/batch "
                  f"{[round(m, 3) for m in ms]}")
            del meshed, plain
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    stamp("phase 25a (mesh of 1 over NCCL, four modes) done")
    return routes


def mesh_batches(seed: int = MESH_SEED):
    """Phase 26's global batches: MESH_MICRO seeded b16@640 (images,
    targets) pairs."""
    spec = zoo.get_spec(TRAIN_MODEL)
    rng = np.random.default_rng(seed)
    grids = [(MESH_TRAIN_SIZE // s,) * 2 for s in spec.strides]
    out = []
    for _ in range(MESH_MICRO):
        images, labels = face_batch(rng, MESH_TRAIN_BATCH, MESH_TRAIN_SIZE)
        out.append((images, build_targets_batched(
            labels, MESH_TRAIN_BATCH, spec, grids,
            anchor_t=HYP_SCRATCH_P6["anchor_t"])))
    return out


def mesh_train(mesh, batches, dtype=torch.float32, trace=False,
               seed: int = MESH_SEED):
    """Phase 26's step: yolov7-face from `seed`'s weights, MESH_MICRO
    micro-steps of make_accum_steps (under `mesh` on this rank's rows)
    and one apply, in `dtype` (float32 with TF32 off; float64 is the
    exact step). The first micro-step (with the process's warm-up for
    the shapes) is timed alone, then the others and the apply (the
    gradient all-reduce under a mesh), with `trace` in a torch.profiler
    window (one a process: a later one in the same process ran several
    times slower on the card). Returns (losses, components, the model's
    state dict on the host, times: first micro-step ms, ms of each later
    micro-step, apply ms, the window's ms and, traced, its device busy
    ms)."""
    model = init_weights(YoloFace(zoo.get_spec(TRAIN_MODEL)),
                         torch.Generator().manual_seed(seed)).to(
                             "cuda", dtype)
    state = TR.create_train_state(model)
    cfg = TR.TrainConfig(epochs=300, steps_per_epoch=10, warmup_epochs=0.0,
                         min_warmup_steps=1, batch_size=MESH_TRAIN_BATCH)
    grad_fn, apply_fn = TR.make_accum_steps(model, cfg, HYP_SCRATCH_P6,
                                            MESH_TRAIN_SIZE, mesh=mesh)
    acc, losses, comps = TR.zero_grads_like(state.params), [], []

    def micro(batch):
        nonlocal acc, state
        images, targets = (batch if mesh is None
                           else PMESH.shard_batch(mesh, batch))
        state, acc, loss, c = grad_fn(state, images, targets, acc)
        losses.append(float(loss))
        comps.append(c.cpu().numpy())

    times = {"first_ms": timed(lambda: micro(batches[0]))[1]}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="chip_smoke_mesh_"
                                     ) as tmp, (PROF.trace(tmp) if trace
                                                else contextlib.nullcontext()
                                                ) as prof:
        t0 = time.perf_counter()
        times["micro_ms"] = [timed(lambda: micro(b))[1] for b in batches[1:]]
        times["apply_ms"] = timed(lambda: apply_fn(state, acc,
                                                   MESH_MICRO - 1))[1]
        times["window_ms"] = (time.perf_counter() - t0) * 1e3
    if trace:
        times["busy_ms"] = PROF.device_busy_ms(prof)
    host = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return losses, comps, host, times


def mesh_rank(seed: int, shape, gate: float, tmp: str) -> dict:
    """Phases 25b and 26 in one of MESH_RANKS processes that share the
    card in a gloo group: (25b) the w6 mesh detector on phase 4's first
    request (`seeded_frames(seed, shape)[0]`, made here: frames in the
    spawn arguments would pass through a pipe and start the ranks one
    after another), BATCH / MESH_RANKS a rank, its Detections and the
    gathered rows; (26)
    rank 0 alone runs the one-process step and the exact float64 step
    (the references, in a process as fresh as the ranks'), then every
    rank the sharded step; then cli/train.train_run for one epoch over
    the ranks. Returns what the parent checks."""
    mesh = PMESH.make_data_mesh()
    out = {"rank": mesh.rank, "backend": mesh.backend}
    frames = seeded_frames(seed, shape)[0]
    out["frames"] = digest({"frames": torch.from_numpy(frames)})
    det = FaceDetector("yolov7-w6-face", img_sizes=(SIZE,), conf_thres=gate,
                       iou_thres=0.5, max_candidates=MAX_CANDIDATES, seed=0,
                       mesh=mesh, device="cuda")
    det.run_network(frames)  # warm-up
    zero_counters()
    dets, out["serve_ms"] = timed(lambda: det.run_network(frames))
    out["serve_launches"] = counts_since_zero()
    local = det.forward_rows(frames[mesh.rows(len(frames))])
    rows = PMESH.gather_rows(mesh, local, len(frames))
    out["dets"] = [t.cpu().numpy() for t in dets]
    out["rows"] = rows.cpu().numpy()
    if mesh.rank == 0:
        out["post_equal"] = same_detections(dets, det.postprocess(rows.cpu()))
    del det, local, rows, dets
    torch.cuda.empty_cache()

    batches = mesh_batches()
    if mesh.rank == 0:
        one = mesh_train(None, batches)
        torch.cuda.empty_cache()
        exact = mesh_train(None, batches, torch.float64)
        torch.cuda.empty_cache()
    dist.barrier()
    f32 = mesh_train(mesh, batches, trace=True)
    torch.cuda.empty_cache()
    f64 = mesh_train(mesh, batches, torch.float64)
    torch.cuda.empty_cache()
    out["train"] = {"times": f32[3], "times64": f64[3],
                    "digest": digest(f32[2]), "digest64": digest(f64[2])}
    if mesh.rank == 0:
        out["train"].update(
            f32=step_ratios(f32, one, exact), f64=step_ratios(f64, exact),
            losses=f32[0], one_losses=one[0], one_times=one[3],
            exact_times=exact[3])
        del one, exact
    del f32, f64
    torch.cuda.empty_cache()

    spec = zoo.get_spec(TRAIN_MODEL)
    rng = np.random.default_rng(61)
    sets = (memory_faces(rng, EPOCH_TRAIN, EPOCH_SIZE, spec.max_stride),
            memory_faces(rng, EPOCH_VAL, EPOCH_SIZE, spec.max_stride))
    args = TRAIN_CLI.parse_args([
        "--model", TRAIN_MODEL, "--data", "in-memory", "--img-size",
        str(EPOCH_SIZE), "--batch-size", "2", "--nominal-batch", "4",
        "--epochs", "1", "--val-batch-size", str(EPOCH_VAL_BATCH),
        "--min-warmup-steps", "1", "--project", tmp, "--name", "mesh",
        "--noautoanchor", "--no-tensorboard", "--workers", "1",
        "--device", "cuda"])
    zero_counters()
    (_, out["epoch_ms"]) = timed(lambda: TRAIN_CLI.train_run(
        args, quiet=True, datasets=sets))
    out["epoch_launches"] = counts_since_zero()
    state = TRAIN_CLI.train_run.last["state"]
    out["epoch_steps"] = (state.step, state.ema_updates)
    out["epoch_digest"] = digest(state.model.state_dict())
    return out


def digest(tensors: dict) -> str:
    """A hash of the tensors' bytes in key order (equal hashes: the same
    bits)."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def drive_mesh(smi: str, frames: np.ndarray, gate: float, seed: int = 0
               ) -> dict:
    """Phases 25-26: the data-parallel mesh on the one card; `frames` are
    `seeded_frames(seed)`, which the ranks make again. Returns the
    launches by tag and the numbers for the kernels line."""
    t0 = time.perf_counter()
    routes = drive_mesh_world_of_one(smi, frames[:MESH_REQUESTS], gate)
    t25a = time.perf_counter() - t0

    # 25b's reference: w6's b8 rows in one process
    ref_det = FaceDetector("yolov7-w6-face", img_sizes=(SIZE,),
                           conf_thres=gate, iou_thres=0.5,
                           max_candidates=MAX_CANDIDATES, seed=0,
                           device="cuda")
    rows_b8 = ref_det.forward_rows(frames[0]).cpu()
    del ref_det
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="chip_smoke_mesh_"
                                     ) as tmp:
        res = PMESH.run_ranks(mesh_rank, MESH_RANKS,
                              (seed, frames.shape, gate, tmp), device="cuda",
                              backend="gloo", timeout=MESH_TIMEOUT)
        lines = (Path(tmp) / "mesh" / "results.txt").read_text().splitlines()
        weights = sorted(p.name for p in (Path(tmp) / "mesh" / "weights")
                         .iterdir())
    t_ranks = time.perf_counter() - t1

    # 25b: two ranks sharing the card
    tag = f"yolov7-w6-face float32 mesh of {MESH_RANKS} (gloo, one card)"
    check([r["backend"] for r in res] == ["gloo"] * MESH_RANKS,
          f"{tag}: backends {[r['backend'] for r in res]}")
    want = digest({"frames": torch.from_numpy(frames[0])})
    check(all(r["frames"] == want for r in res),
          f"{tag}: a rank's seeded frames differ from phase 4's")
    for r in res[1:]:
        check(all(np.array_equal(a, b) for a, b in zip(r["dets"],
                                                       res[0]["dets"]))
              and np.array_equal(r["rows"], res[0]["rows"]),
              f"{tag}: rank {r['rank']}'s fields differ from rank 0's")
    rows_within(torch.from_numpy(res[0]["rows"]), rows_b8,
                f"{tag}: gathered rows vs the one-process b{BATCH} forward")
    check(res[0]["post_equal"], f"{tag}: Detections differ from the CPU "
                                f"postprocess of the gathered rows")
    serve = [r["serve_launches"] for r in res]
    check(all(c == {"seq": 1, "fixpoint": 0, "fused": 0, "qconv": 0}
              for c in serve), f"{tag}: launches a rank {serve}")
    MESH_LAUNCHES[tag] = add_counts({}, serve[0])
    for c in serve[1:]:
        add_counts(MESH_LAUNCHES[tag], c)
    print(f"{tag} b{BATCH}@{SIZE} ({BATCH // MESH_RANKS} a rank) on {smi}: "
          f"both ranks' fields equal, gathered rows within {ROW_TOL} of the "
          f"b{BATCH} forward, Detections == the CPU postprocess of the "
          f"gathered rows; launches a rank {serve}; ms/batch a rank "
          f"{[round(r['serve_ms'], 3) for r in res]}")

    # 26: the sharded train step against the one-process step
    tag = (f"{TRAIN_MODEL} train mesh of {MESH_RANKS} b{MESH_TRAIN_BATCH}@"
           f"{MESH_TRAIN_SIZE}")
    check(len({r["train"]["digest"] for r in res}) == 1
          and len({r["train"]["digest64"] for r in res}) == 1,
          f"{tag}: the ranks' parameters differ")
    got = res[0]["train"]
    r32, r64 = got["f32"], got["f64"]
    print(f"{tag} ({MESH_MICRO} micro-steps, {MESH_TRAIN_BATCH // MESH_RANKS}"
          f" rows a rank, an apply) on {smi}: float32 (TF32 off) losses "
          f"{got['losses']} against one process {got['one_losses']}; "
          f"tolerance ratios (loss rtol {MESH_LOSS_RTOL}, params "
          f"{MESH_PARAM_TOL}, BN {MESH_BN_TOL}) against the one-process "
          f"step: float32 {r32}, float64 {r64}; parameters bit-identical "
          f"across ranks in both; ms (first micro-step; traced: micro-steps, "
          f"apply, window, busy) a rank float32 "
          f"{[r['train']['times'] for r in res]}, float64 "
          f"{[r['train']['times64'] for r in res]}; one process "
          f"{got['one_times']} (float64 {got['exact_times']})")
    check(max(r64[k] for k in ("loss", "components", "param", "bn")) <= 1.0,
          f"{tag}: the float64 step beyond the sharded-step tolerances of "
          f"the one-process float64 step: {r64}")
    check(max(r32[k] for k in ("loss", "components", "bn")) <= 1.0,
          f"{tag}: float32 losses or BN statistics beyond the sharded-step "
          f"tolerances: {r32}")
    # a random model's float32 step is ill-conditioned (the first convs'
    # weight gradients cancel over the maps; train_step_parity): the
    # one-process float32 step is itself beyond the tolerance of the
    # exact one there. A parameter tensor beyond the tolerance of the
    # one-process step must be as near the exact step, in L2, as the
    # one-process step is, within a factor 2
    check(r32["param"] <= 1.0 or r32["noise_ratio"] <= 2.0,
          f"{tag}: float32 parameters {r32['param']} tolerance units from "
          f"the one-process step, {r32['noise_ratio']} times its L2 "
          f"distance from the exact step on {r32['noisy']}")
    ratios = r32

    # 26b: train_run over the two ranks
    tag = f"{TRAIN_MODEL} train_run mesh of {MESH_RANKS}"
    batches = EPOCH_VAL // EPOCH_VAL_BATCH
    launches = [r["epoch_launches"] for r in res]
    check(launches[0] == {"seq": batches, "fixpoint": 0, "fused": 0,
                          "qconv": 0}
          and all(c == {"seq": 0, "fixpoint": 0, "fused": 0, "qconv": 0}
                  for c in launches[1:]),
          f"{tag}: launches a rank {launches}, want {batches} nms_keep on "
          f"rank 0's validate and none elsewhere")
    check(len({r["epoch_digest"] for r in res}) == 1
          and all(r["epoch_steps"] == (1, 1) for r in res),
          f"{tag}: the ranks end apart: {[r['epoch_steps'] for r in res]}")
    check(len(lines) == 1 and {"last.pt", "best.pt", "best_inference.npz"}
          <= set(weights), f"{tag}: rank 0's files {lines} {weights}")
    MESH_LAUNCHES[tag] = launches[0]
    print(f"{tag} on {smi}: 1 epoch of {EPOCH_TRAIN // 2} micro-steps "
          f"b2@{EPOCH_SIZE} (1 row a rank, 1 apply), rank 0's validate "
          f"launches {launches[0]['seq']} nms_keep, ranks equal, rank 0 "
          f"alone wrote results.txt and {weights}; train_run ms a rank "
          f"{[round(r['epoch_ms'], 1) for r in res]}")
    total = time.perf_counter() - t0
    stamp(f"phases 25-26 (the mesh) took {total:.1f} s (25a {t25a:.1f} s, "
          f"the ranks {t_ranks:.1f} s with their start)")
    return {"routes": routes, "seconds": total, "ranks_seconds": t_ranks,
            "train_ratios": ratios, "train_ratios_float64": r64,
            "rank_times": [r["train"]["times"] for r in res],
            "rank_times_float64": [r["train"]["times64"] for r in res],
            "one_process_times": got["one_times"],
            "float64_times": got["exact_times"],
            "busy_share": [r["train"]["times"]["busy_ms"]
                           / r["train"]["times"]["window_ms"] for r in res]}


def mesh_noise_rank(seeds) -> list:
    """`--mesh-noise`'s work in one of MESH_RANKS processes sharing the
    card in a gloo group: for each seed, phase 26's float32 step over the
    ranks from the seed's weights and batches, and on rank 0 the
    one-process float32 step and the exact float64 one; rank 0's
    step_ratios of each seed."""
    mesh = PMESH.make_data_mesh()
    out = []
    for seed in seeds:
        batches = mesh_batches(seed)
        if mesh.rank == 0:
            one = mesh_train(None, batches, seed=seed)
            torch.cuda.empty_cache()
            exact = mesh_train(None, batches, torch.float64, seed=seed)
            torch.cuda.empty_cache()
        dist.barrier()
        f32 = mesh_train(mesh, batches, seed=seed)
        torch.cuda.empty_cache()
        if mesh.rank == 0:
            out.append({"seed": seed, **step_ratios(f32, one, exact)})
            del one, exact
        del f32
    return out


def mesh_noise(seeds) -> None:
    """python3 chip_smoke.py --mesh-noise 8,9,10: phase 26's float32
    comparison alone, one seed after another, one JSON line of ratios a
    seed (step_ratios: the tolerance units of the sharded step from the
    one-process step, the parameter tensors beyond the tolerance, and
    their L2 distance from the exact float64 step over the one-process
    step's)."""
    check(torch.cuda.is_available(), "no CUDA device")
    smi = smi_line()
    print(smi)
    t0 = time.perf_counter()
    res = PMESH.run_ranks(mesh_noise_rank, MESH_RANKS, (seeds,),
                          device="cuda", backend="gloo",
                          timeout=MESH_TIMEOUT)
    for r in res[0]:
        print(json.dumps({"card": smi, **r}))
    stamp(f"--mesh-noise over {len(seeds)} seeds took "
          f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 27: the spatial mesh (parallel/mesh.spatial_infer, parallel/spatial.py)
# ---------------------------------------------------------------------------

SPATIAL_SIZE = 3840           # the reference pyramid's top scale
SPATIAL_RECT = (2176, 3840)   # 27c: 544-px rows over 4, not a multiple of 64
SPATIAL_RANKS = 4             # 27b-c: processes sharing the card over gloo
SPATIAL_ROW_TOL = dict(rtol=1e-4, atol=1e-4)   # __graft_entry__.py:230
# every counted spatial call: {tag: nms_keep launches}
SPATIAL_LAUNCHES = {}


def spatial_frames():
    """Phase 27's noise frames: b1@3840^2 and b1@2176x3840 (uint8 NHWC)."""
    rng = np.random.default_rng(27)
    return (rng.integers(0, 256, (1, SPATIAL_SIZE, SPATIAL_SIZE, 3),
                         dtype=np.uint8),
            rng.integers(0, 256, (1, *SPATIAL_RECT, 3), dtype=np.uint8))


def spatial_weights() -> dict:
    """Phase 4's w6 weights (seed 0's init), made once for phase 27."""
    return init_weights(YoloFace(zoo.get_spec("yolov7-w6-face")),
                        torch.Generator().manual_seed(0)).state_dict()


def spatial_models(gate: float, weights: dict):
    """Phase 4's w6 detector (`weights`, BN folded) on the card with phase
    4's gate and K = MAX_CANDIDATES, whose `postprocess` is the NMS, and
    the models spatial_infer runs: {float32: its model, bf16: a copy cast
    as FaceDetector(dtype=bfloat16) casts it}."""
    det = FaceDetector("yolov7-w6-face", variables=weights, img_sizes=(SIZE,),
                       conf_thres=gate, iou_thres=0.5,
                       max_candidates=MAX_CANDIDATES, device="cuda")
    return det, {torch.float32: det.model, torch.bfloat16: cast_model(
        copy.deepcopy(det.model), torch.bfloat16)}


def one_process_rows(model, frame: np.ndarray, dtype):
    """The one-process forward and decode of the uint8 `frame` (uploaded,
    cast to `dtype`, then / 255, as spatial_infer does), and its host
    ms."""
    x = torch.as_tensor(frame)

    def run():
        with torch.inference_mode(), full_fp32():
            return decode(model(x.cuda().to(dtype) / 255.0), model.spec)

    return timed(run)


@contextlib.contextmanager
def card_profile():
    """A torch.profiler window over the host and the card, kept in memory
    (no Chrome trace written: phase 27 reads only its events)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        yield prof


def column_share(got, want) -> float:
    """The largest, over the row fields, of max |got - want| / max |want|
    (bf16: PERF.md §2's share of the largest value)."""
    got, want = got.double().flatten(0, -2), want.double().flatten(0, -2)
    return float(((got - want).abs().amax(0)
                  / want.abs().amax(0).clamp_min(1e-30)).max())


def busy_in(prof, tag: str) -> float:
    """The device-busy milliseconds inside the host range of the
    record_function `tag` of a trace (the union of the card's kernel,
    copy and set intervals clipped to it; the range's own annotations on
    the card's streams are not work)."""
    cuda = torch.autograd.DeviceType.CUDA
    rng = [e.time_range for e in prof.events()
           if e.name == tag and e.device_type != cuda]
    check(len(rng) == 1, f"trace: {len(rng)} host ranges named {tag}")
    lo, hi = rng[0].start, rng[0].end
    spans = sorted((max(lo, e.time_range.start), min(hi, e.time_range.end))
                   for e in prof.events()
                   if e.device_type == cuda and e.name != tag
                   and e.time_range.end > lo and e.time_range.start < hi)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def spatial_call(model, frame, mesh, dtype, tag=None, post=None):
    """One counted spatial_infer call (counters zeroed before, read after):
    (its output, {ms, exchanges, halo_bytes, launches})."""
    zero_counters()
    ctx = (torch.profiler.record_function(tag) if tag
           else contextlib.nullcontext())
    with ctx:
        out, ms = timed(lambda: PMESH.spatial_infer(
            model, frame, mesh, dtype=dtype, postprocess=post))
    return out, {"ms": ms, "calls": PMESH.spatial_infer.calls,
                 "exchanges": PMESH.spatial_infer.exchanges,
                 "halo_bytes": PMESH.spatial_infer.halo_bytes,
                 "launches": counts_since_zero()}


def drive_spatial_world_of_one(smi: str, frame: np.ndarray, gate: float,
                               weights: dict) -> dict:
    """Phase 27a: a world of one over NCCL, in this process, as a 1x1 grid:
    w6 b1@3840^2 through spatial_infer in float32 and bf16, bit-equal to
    the one-process forward and decode, and with the NMS as the
    postprocess (one nms_keep launch) to its Detections."""
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{PMESH._free_port()}",
        world_size=1, rank=0)
    out = {}
    try:
        mesh = PMESH.make_spatial_mesh()
        check(mesh.backend == "nccl" and mesh.shape == (1, 1)
              and mesh.group is not None, f"phase 27a mesh {mesh}")
        det, models = spatial_models(gate, weights)
        for name, dtype in (("float32", torch.float32),
                            ("bf16", torch.bfloat16)):
            tag = f"yolov7-w6-face {name} spatial 1x1 (nccl)"
            model = models[dtype]
            spatial_call(model, frame, mesh, dtype)  # warm-up
            want, one_ms = one_process_rows(model, frame, dtype)
            got, call = spatial_call(model, frame, mesh, dtype)
            with card_profile() as prof:
                _, traced = spatial_call(model, frame, mesh, dtype, tag=tag)
            call["busy_share"] = busy_in(prof, tag) / traced["ms"]
            check(torch.equal(got, want), f"{tag}: rows differ from the "
                                          f"one-process forward and decode")
            dets, post = spatial_call(model, frame, mesh, dtype,
                                      post=det.postprocess)
            check(same_detections(dets, det.postprocess(want)),
                  f"{tag}: Detections differ from the one-process "
                  f"postprocess")
            check(post["launches"] == {"seq": 1, "fixpoint": 0, "fused": 0,
                                       "qconv": 0}
                  and call["exchanges"] == 0 == call["halo_bytes"],
                  f"{tag}: launches {post['launches']}, exchanges "
                  f"{call['exchanges']}")
            SPATIAL_LAUNCHES[tag] = post["launches"]["seq"]
            out[name] = {"ms": call["ms"], "busy_share": call["busy_share"],
                         "nms_ms": post["ms"], "one_process_ms": one_ms}
            print(f"{tag} b1@{SPATIAL_SIZE}^2 on {smi}: rows "
                  f"{tuple(got.shape)} and Detections bit-equal to one "
                  f"process; ms a call "
                  f"{call['ms']:.3f} (busy share {call['busy_share']:.4f} "
                  f"in a traced call of {traced['ms']:.3f} ms; with the NMS "
                  f"{post['ms']:.3f}; "
                  f"the one-process forward+decode {one_ms:.3f}); exchanges "
                  f"0, halo bytes 0")
            del want, got, dets
        del det, models, model
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def spatial_rank(gate: float, weights_path: str, go) -> dict:
    """Phases 27b-c in one of SPATIAL_RANKS processes sharing the card in a
    gloo group. Each makes the frames (`spatial_frames`: arguments larger
    than a pipe's buffer would hold each spawned rank's start until the
    one before it had imported this script) and its models, then waits
    for the event `go` (set once phase 27a has left the card). Rank 0 first computes the
    one-process references (in a process as fresh as the ranks'); then
    every rank: (27b) the (2, 2)
    grid on the 3840^2 frame in float32 and bf16, a warm-up call, a timed
    call and a call with the NMS; (27c) the (4, 1) grid on the 2176 x
    3840 frame in float32. The timed calls run untraced, then once more
    in one profiler window for the busy shares.
    Every rank returns its counts, times and the digests of its rows and
    Detections; rank 0 also holds its rows to the references."""
    clock = {"start": time.perf_counter()}
    grid22, grid41 = PMESH.make_spatial_mesh(), PMESH.make_spatial_mesh(
        rows=SPATIAL_RANKS)
    rank = grid22.rank
    out = {"rank": rank, "backend": grid22.backend,
           "grids": (grid22.shape, grid41.shape)}
    f32, bf16 = torch.float32, torch.bfloat16
    frame, rect = spatial_frames()
    det, models = spatial_models(gate, torch.load(weights_path))
    cases = (("2x2 float32", f32, frame, grid22),
             ("2x2 bf16", bf16, frame, grid22),
             ("4x1 float32", f32, rect, grid41))
    clock["built"] = time.perf_counter()
    go.wait()
    clock["waited"] = time.perf_counter()
    ref = {}
    if rank == 0:
        for case, dtype, x, _ in cases:
            one_process_rows(models[dtype], x, dtype)  # warm-up
            rows, ms = one_process_rows(models[dtype], x, dtype)
            ref[case] = (rows.cpu(), ms)
            del rows
            torch.cuda.empty_cache()
    dist.barrier()
    clock["references"] = time.perf_counter()
    for case, dtype, x, grid in cases:
        spatial_call(models[dtype], x, grid, dtype)  # warm-up: record, plans
    clock["warm-up"] = time.perf_counter()
    res, rows, traced = {}, {}, {}
    for case, dtype, x, grid in cases:
        got, res[case] = spatial_call(models[dtype], x, grid, dtype)
        rows[case] = got.cpu()
        res[case]["digest"] = digest({"rows": rows[case]})
    clock["timed"] = time.perf_counter()
    with card_profile() as prof:
        for case, dtype, x, grid in cases:
            traced[case] = spatial_call(models[dtype], x, grid, dtype,
                                        tag=case)[1]["ms"]
    for case in res:
        res[case]["busy_share"] = busy_in(prof, case) / traced[case]
        res[case]["traced_ms"] = traced[case]
    clock["traced"] = time.perf_counter()
    for case, dtype, x, grid in cases[:2]:
        got, post = spatial_call(models[dtype], x, grid, dtype,
                                 post=det.postprocess)
        res[case].update(nms_ms=post["ms"], nms_launches=post["launches"],
                         dets_digest=digest({str(i): t for i, t in
                                             enumerate(got)}))
        if rank == 0:
            res[case]["post_equal"] = same_detections(
                got, det.postprocess(rows[case]))
    clock["nms"] = time.perf_counter()
    if rank == 0:
        for case, (want, ms) in ref.items():
            got = rows[case]
            res[case].update(one_process_ms=ms, shape=tuple(got.shape),
                             want_shape=tuple(want.shape),
                             finite=bool(torch.isfinite(got).all()))
            if got.shape == want.shape and "bf16" in case:
                res[case]["share"] = column_share(got, want)
            elif got.shape == want.shape:
                res[case]["units"] = tolerance_ratio(got, want,
                                                     **SPATIAL_ROW_TOL)
                res[case]["gate_units"] = tolerance_ratio(got, want,
                                                          **ROW_TOL)
    out["cases"] = res
    names = list(clock)
    out["seconds"] = {b: round(clock[b] - clock[a], 2)
                      for a, b in zip(names, names[1:])}
    return out


def drive_spatial(smi: str, gate: float) -> dict:
    """Phase 27: the spatial mesh on the one card. Returns the numbers for
    the kernels line."""
    t0 = time.perf_counter()
    frame, _ = spatial_frames()
    weights = spatial_weights()
    torch.cuda.empty_cache()
    # the ranks start and build their models while 27a runs, and wait for
    # `go` before they use the card
    go = mp.get_context("spawn").Event()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="chip_smoke_spatial_"
                                     ) as tmp:
        path = os.path.join(tmp, "w6.pt")
        torch.save(weights, path)
        ranks = pool.submit(PMESH.run_ranks, spatial_rank, SPATIAL_RANKS,
                            (gate, path, go), device="cuda",
                            backend="gloo", timeout=MESH_TIMEOUT)
        try:
            one = drive_spatial_world_of_one(smi, frame, gate, weights)
        finally:
            go.set()
            pool.shutdown(wait=False)
        t27a = time.perf_counter() - t0
        stamp("phase 27a (spatial 1x1 over NCCL, float32 and bf16) done")
        res = ranks.result()
    t_ranks = time.perf_counter() - t0
    print(f"phase 27b-c: seconds a rank by part {[r['seconds'] for r in res]}")
    check([r["backend"] for r in res] == ["gloo"] * SPATIAL_RANKS
          and all(r["grids"] == ((2, 2), (4, 1)) for r in res),
          f"phase 27b: backends and grids "
          f"{[(r['backend'], r['grids']) for r in res]}")
    fields = {}
    for case in res[0]["cases"]:
        tag = f"yolov7-w6-face {case} spatial (gloo, one card)"
        got = [r["cases"][case] for r in res]
        first = got[0]
        check(len({g["digest"] for g in got}) == 1,
              f"{tag}: the ranks' rows differ")
        check(first["shape"] == first["want_shape"] and first["finite"],
              f"{tag}: rows {first['shape']} against the one-process "
              f"{first['want_shape']}, finite {first['finite']}")
        if "bf16" in case:
            share = first["share"]
            print(f"{tag}: rows off the one-process bf16 rows by {share:.4g}"
                  f" of the largest value of a field (bound "
                  f"{BF16_RAW_SHARE})")
            check(share < BF16_RAW_SHARE, f"{tag}: beyond {BF16_RAW_SHARE}")
            gate_units = share / BF16_RAW_SHARE
        else:
            units, gate_units = first["units"], first["gate_units"]
            print(f"{tag}: rows {units:.4g} units of rtol 1e-4 / atol 1e-4 "
                  f"from the one-process card rows"
                  + ("" if units <= 1 else
                     f" (missed by {units:.4g}x; held to {ROW_TOL}: "
                     f"{gate_units:.4g} units)"))
            check(units <= 1 or gate_units <= 1,
                  f"{tag}: rows beyond {ROW_TOL} of one process")
        if "nms_launches" in first:
            check(all(g["nms_launches"] == {"seq": 1, "fixpoint": 0,
                                            "fused": 0, "qconv": 0}
                      for g in got),
                  f"{tag}: launches a rank {[g['nms_launches'] for g in got]}")
            check(len({g["dets_digest"] for g in got}) == 1,
                  f"{tag}: the ranks' Detections differ")
            check(first["post_equal"], f"{tag}: Detections differ from the "
                                       f"CPU postprocess of the gathered "
                                       f"rows")
            SPATIAL_LAUNCHES[tag] = sum(g["nms_launches"]["seq"] for g in got)
        check(all(g["launches"]["seq"] == 0 for g in got),
              f"{tag}: nms_keep launched without a postprocess")
        per = {k: [g[k] for g in got] for k in ("ms", "exchanges",
                                                 "halo_bytes", "busy_share",
                                                 "traced_ms")}
        busy = per["busy_share"]
        one_ms = first["one_process_ms"]
        fields[case] = {"ms": per["ms"], "busy_share": busy,
                        "traced_ms": per["traced_ms"],
                        "exchanges": per["exchanges"],
                        "halo_bytes": per["halo_bytes"],
                        "one_process_ms": one_ms, "gate_units": gate_units,
                        "nms_ms": [g.get("nms_ms") for g in got]}
        print(f"{tag} on {smi}: a rank's call ms (host clock, {SPATIAL_RANKS}"
              f" processes sharing the card) "
              f"{[round(m, 3) for m in per['ms']]}, busy share "
              f"{[round(b, 4) for b in busy]} (in traced calls of "
              f"{[round(m, 3) for m in per['traced_ms']]} ms), exchanges "
              f"{per['exchanges']}, halo bytes {per['halo_bytes']}; the "
              f"one-process forward+decode {one_ms:.3f} ms"
              + (f"; with the NMS {[round(g['nms_ms'], 3) for g in got]} ms,"
                 f" Detections equal across ranks and to the CPU "
                 f"postprocess of the gathered rows, one nms_keep a rank"
                 if "nms_ms" in first else ""))
    total = time.perf_counter() - t0
    stamp(f"phase 27 (the spatial mesh) took {total:.1f} s (27a {t27a:.1f} "
          f"s; the ranks {t_ranks:.1f} s from their start beside 27a)")
    return {"seconds": total, "ranks_seconds": t_ranks, "world_of_one": one,
            "grids": fields}


# ---------------------------------------------------------------------------
# phase 28: the examples (examples/*_torch.py) and the weights fetch
# ---------------------------------------------------------------------------

EXAMPLE_SEED = 28
DEMO_SIZES = (640, 1280)  # examples/demo_torch.py's pyramid
PROGRAM_SIZE = 256        # examples/exported_inference_torch.py's size
EXAMPLE_ROWS = 32  # rows gated at most over an example's network inputs
# every counted example call: {tag: counts_since_zero() of the call}
EXAMPLE_LAUNCHES = {}


def example(name: str):
    """The module examples/<name>.py, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@torch.no_grad()
def noisy_state_dict(name: str, seed: int) -> dict:
    """A state dict of zoo model `name` drawn from `seed` as the CPU
    tests' numpy-seeded variables are (tests/test_torch_model.
    random_variables: fan-in-scaled kernels, BN statistics and affine
    away from identity, biases N(0, 0.1), implicit priors near 0 and 1),
    loaded as a user's checkpoint. The seeded init's confidences all lie
    within ulps of 0.25; these spread over about 0.2-0.3 (tiny at 640),
    still with ties, so the examples' thresholds come from
    `example_settings`."""
    from face_detection_multi_scale_tpu_torch.models import layers as LAY

    net = YoloFace(zoo.get_spec(name).resolve())
    gen = torch.Generator().manual_seed(seed)

    def normal(t, std, mean=0.0):
        t.copy_(torch.randn(t.shape, generator=gen) * std + mean)

    def uniform(t, lo, hi):
        t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=gen))

    for mod in net.modules():
        if isinstance(mod, torch.nn.Conv2d):
            normal(mod.weight, mod.weight[0].numel() ** -0.5)
            if mod.bias is not None:
                normal(mod.bias, 0.1)
        elif isinstance(mod, torch.nn.BatchNorm2d):
            uniform(mod.weight, 0.8, 1.2)
            normal(mod.bias, 0.1)
            normal(mod.running_mean, 0.1)
            uniform(mod.running_var, 0.5, 1.5)
        elif isinstance(mod, (LAY.ImplicitA, LAY.ImplicitM)):
            normal(mod.implicit, 0.02, float(isinstance(mod, LAY.ImplicitM)))
    return net.state_dict()


def example_settings(rows_fn):
    """(conf_thres, iou_thres) at which an example's card and CPU runs
    decide alike: `decisive_settings` over `rows_fn(device)`, the decoded
    rows (1, N, no) of every network input the example gives the engine,
    side by side, gating at most EXAMPLE_ROWS of them in all, so no top-K
    or max_det cut decides either. Random weights put many confidences
    within ulps of one another; the examples' 0.25 default sits among
    them."""
    return decisive_settings(rows_fn("cuda"), rows_fn("cpu"), EXAMPLE_ROWS)


def check_example_launches(tag: str, seq: int) -> None:
    got = EXAMPLE_LAUNCHES[tag]
    check(got == {"seq": seq, "fixpoint": 0, "fused": 0, "qconv": 0},
          f"{tag}: launches {got}, want {seq} nms_keep and nothing else")


def counted_example(tag: str, fn, warmup: bool = True):
    """fn() (after one warm-up call with `warmup`) with every launch
    counter zeroed just before and read just after, into
    EXAMPLE_LAUNCHES[tag]. Returns (fn(), its host-clock ms)."""
    if warmup:
        fn()
    zero_counters()
    out, ms = timed(fn)
    EXAMPLE_LAUNCHES[tag] = counts_since_zero()
    return out, ms


def drive_phase28(smi: str) -> dict:
    """Phase 28: each example's `run` on the card against the same `run`
    on the CPU with the same seed, frames and weights (noisy tiny and
    lite-t state dicts saved as .pt, `weights=`), rows within ROW_TOL;
    then FaceDetector(torch_weights=<missing>.pt) fetching the file from a
    local release through the real `download_url` on a file:// URL.
    Returns the host-clock ms of each counted call and the seconds of
    each part."""
    from face_detection_multi_scale_tpu_torch.utils import downloads as DL
    from torch_shared import release_redirect

    t0 = time.perf_counter()
    demo, simple, exported = (example(n) for n in (
        "demo_torch", "detect_simple_torch", "exported_inference_torch"))
    rng = np.random.default_rng(EXAMPLE_SEED)
    # frames at the first scale and at the program's size: the host
    # letterbox then neither resizes nor pads, which needs OpenCV
    frame = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    small = rng.integers(0, 256, (PROGRAM_SIZE, PROGRAM_SIZE, 3),
                         dtype=np.uint8)
    ms, seconds = {}, {}
    clock = time.perf_counter()

    def lap(part):
        nonlocal clock
        now = time.perf_counter()
        seconds[part], clock = now - clock, now

    with tempfile.TemporaryDirectory(dir=ROOT, prefix="chip_smoke_examples_"
                                     ) as tmp:
        release = Path(tmp) / "release"
        release.mkdir()
        tiny_pt, lite_pt = release / "tiny.pt", release / "lite-t.pt"
        torch.save(noisy_state_dict("yolov7-tiny-face", EXAMPLE_SEED),
                   tiny_pt)
        torch.save(noisy_state_dict("yolov7-lite-t", EXAMPLE_SEED + 1),
                   lite_pt)
        # the settings' detectors, one a device, switched between the
        # demo's API chain on the device and detect_simple's letterbox
        tiny = {dev: FaceDetector("yolov7-tiny-face",
                                  torch_weights=str(tiny_pt),
                                  img_sizes=DEMO_SIZES,
                                  use_api_preprocess=True,
                                  use_device_preprocess=True, device=dev)
                for dev in ("cuda", "cpu")}
        lap("weights")

        # (28a) the demo: single-scale, then the (640, 1280) pyramid; the
        # API chain on the device (the host one resizes with OpenCV)
        tag = f"demo_torch.run yolov7-tiny-face {DEMO_SIZES}"

        def demo_rows(device):
            det = tiny[device]
            raw = det.upload(frame[None])
            return torch.cat([det.forward_input(det.device_input(
                raw, size, auto=True)[0]) for size in DEMO_SIZES], 1)

        conf, iou = example_settings(demo_rows)
        kw = dict(weights=str(tiny_pt), conf_thres=conf, iou_thres=iou,
                  use_device_preprocess=True)
        card, ms["demo"] = counted_example(tag, lambda: demo.run(
            frame, device="cuda", **kw))
        cpu = demo.run(frame, device="cpu", **kw)
        sizes = card["det"].img_sizes
        check(sizes == list(DEMO_SIZES), f"{tag}: sizes {sizes}")
        # one engine call for detect_single_scale and one a scale for
        # detect_multi_scale, and one merge when a scale kept a row
        # (ops/nms.weighted_nms_merge returns early on none)
        check_example_launches(tag, 1 + len(sizes) + int(len(card["final"])
                                                         > 0))
        check(len(card["rows"]) > 0 and len(card["final"]) > 0,
              f"{tag}: no rows ({len(card['rows'])}, {len(card['final'])})")
        match_rows(card["rows"], cpu["rows"], ROW_TOL,
                   f"{tag}: single-scale rows against the CPU run's")
        match_rows(card["final"], cpu["final"], ROW_TOL,
                   f"{tag}: multi-scale rows against the CPU run's")
        print(f"{tag} on {smi}: conf {conf:.9g}, iou {iou:.6g}: "
              f"{len(card['rows'])} single-scale rows, "
              f"{len(card['final'])} after the merge, within {ROW_TOL} of "
              f"the CPU run's; launches {EXAMPLE_LAUNCHES[tag]}")
        del card, cpu
        lap("28a")

        # (28b) detect_simple: one detect_batch([img], 640, kpt=True)
        tag = f"detect_simple_torch.run yolov7-tiny-face {SIZE}"
        x = LB.preprocess_standard(frame, SIZE, tiny["cpu"].stride)[None]
        conf, iou = example_settings(lambda dev: tiny[dev].forward_rows(x))
        kw = dict(conf_thres=conf, iou_thres=iou)
        (card, _), ms["detect_simple"] = counted_example(
            tag, lambda: simple.run(frame, str(tiny_pt), device="cuda", **kw))
        cpu, _ = simple.run(frame, str(tiny_pt), device="cpu", **kw)
        check_example_launches(tag, 1)
        check(len(card) > 0 and card.shape[1] == 6 + 15,
              f"{tag}: rows {card.shape}")
        match_rows(card, cpu, ROW_TOL, f"{tag}: rows against the CPU run's")
        print(f"{tag} on {smi}: conf {conf:.9g}, iou {iou:.6g}: "
              f"{len(card)} rows with landmarks within {ROW_TOL} of the "
              f"CPU run's; launches {EXAMPLE_LAUNCHES[tag]}")
        lap("28b")

        # (28d) attempt_download: a detector fetches a missing .pt from
        # the release, here a local directory behind a file:// URL, and
        # serves (28b)'s input at (28b)'s thresholds as the card detector
        # loaded from the local file does
        tag = "FaceDetector(torch_weights=<missing>.pt) fetched"
        calls, real = [], DL.download_url
        DL.download_url = release_redirect(DL, release.as_uri(), calls)
        try:
            missing = Path(tmp) / "missing" / "tiny.pt"
            fetched = FaceDetector("yolov7-tiny-face",
                                   torch_weights=str(missing),
                                   img_sizes=(SIZE,), device="cuda", **kw)
        finally:
            DL.download_url = real
        local = tiny["cuda"]
        local.conf_thres, local.iou_thres = conf, iou
        check(calls == [f"{DL.DEFAULT_RELEASE}/tiny.pt"]
              and missing.read_bytes() == tiny_pt.read_bytes(),
              f"{tag}: fetched {calls}")
        zero_counters()
        got, want = fetched.run_network(x), local.run_network(x)
        EXAMPLE_LAUNCHES[tag] = counts_since_zero()
        check_example_launches(tag, 2)
        check(same_detections(got, want) and int(got.valid.sum()) > 0,
              f"{tag}: Detections differ from the local file's detector's")
        print(f"{tag} on {smi}: requested {calls}, the file's bytes, "
              f"Detections equal to the local file's detector's "
              f"({int(got.valid.sum())} kept); launches "
              f"{EXAMPLE_LAUNCHES[tag]}")
        del fetched, local, tiny
        lap("28d")

        # (28c) the exported program on the card (export, load, one call),
        # then the ONNX consumer on the host runner. The settings' forward
        # at the program's shapes warms the card's convolutions (and in
        # the whole script phase 23 warms torch.export): no full warm-up
        # run, whose export and ONNX parts would cost ~7 s of host time
        tag = f"exported_inference_torch.run yolov7-lite-t {PROGRAM_SIZE}"
        lb, _, _ = LB.letterbox(small, PROGRAM_SIZE, auto=False,
                                scaleup=False)
        x = np.ascontiguousarray(lb[None, ..., ::-1])

        def program_rows(device):
            return FaceDetector("yolov7-lite-t", torch_weights=str(lite_pt),
                                img_sizes=(PROGRAM_SIZE,),
                                device=device).forward_rows(x)

        conf, iou = example_settings(program_rows)
        kw = dict(weights=str(lite_pt), conf_thres=conf, iou_thres=iou)
        card, ms["exported"] = counted_example(tag, lambda: exported.run(
            small, device="cuda", **kw), warmup=False)
        cpu = exported.run(small, device="cpu", **kw)
        check_example_launches(tag, 1)  # the loaded program's one call
        check(len(card["rows"]) > 0, f"{tag}: no rows")
        match_rows(card["rows"], cpu["rows"], ROW_TOL,
                   f"{tag}: the program's rows against the CPU run's")
        check(np.array_equal(card["onnx_keep"], cpu["onnx_keep"])
              and len(card["onnx_keep"]) > 0,
              f"{tag}: the ONNX consumer kept {len(card['onnx_keep'])} "
              f"against {len(cpu['onnx_keep'])} on the CPU run")
        ms["exported_parts"] = {k: v * 1e3
                                for k, v in card["seconds"].items()}
        print(f"{tag} on {smi}: conf {conf:.9g}, iou {iou:.6g}: "
              f"{len(card['rows'])} program rows within {ROW_TOL} of the "
              f"CPU run's; the ONNX consumer kept "
              f"{len(card['onnx_keep'])}, as on the CPU; .pt2 "
              f"{card['pt2_bytes']} bytes; launches "
              f"{EXAMPLE_LAUNCHES[tag]}")
        del card, cpu
        lap("28c")
    torch.cuda.empty_cache()
    ms["seconds"] = time.perf_counter() - t0
    ms["part_seconds"] = seconds
    print(f"phase 28 host-clock ms of a call on {smi} (demo and "
          f"detect_simple after a warm-up call): demo {ms['demo']:.1f}, "
          f"detect_simple {ms['detect_simple']:.1f}, exported "
          f"{ms['exported']:.1f} (parts "
          f"{ {k: round(v, 1) for k, v in ms['exported_parts'].items()} })"
          f"; seconds by part "
          f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    stamp(f"phase 28 (the examples, the weights fetch) took "
          f"{ms['seconds']:.1f} s")
    return ms


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def group_entry(s):
    """The time fields of a kernels-line entry from check_groups' sums."""
    return {"ms": s["ms"], "plain_ms": s["plain_ms"],
            "library_ms": s["library_ms"],
            "bound_ms": max(s["t_bytes"], s["t_ops"]),
            "bound_by": "operations" if s["t_ops"] >= s["t_bytes"]
            else "bytes"}


def main() -> None:
    check(torch.cuda.is_available(), "no CUDA device")
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    # fused_elan.cu builds while the keep-mask phases and the unfused paths,
    # which do not need it, run
    pool = concurrent.futures.ThreadPoolExecutor(4)
    builds = start_builds(pool)
    built(builds, K)
    nms_stats, fixpoint_launches = check_kernel_cases()
    stamp("keep-mask cases done")
    built(builds, PM)
    probe_entries = check_probe(smi)
    stamp("probe_mm done")

    frames = {name: seeded_frames(seed) for name, seed in (
        ("yolov7-w6-face", 0), ("yolov7-tiny-face", 1))}
    w6, tiny = "yolov7-w6-face", "yolov7-tiny-face"
    counts_w6, (boxes, valid, thr), ref_w6, det_w6, raws_w6 = drive_path(
        w6, smi, 0, frames[w6])
    w6_gate = det_w6.conf_thres  # phase 23 exports at phase 4's gate
    del det_w6
    _, _, ref_tiny, _, raws_tiny = drive_path(tiny, smi, 1, frames[tiny],
                                              requests=2)
    tta_launches, tta_gate = drive_tta(smi)
    tiled_launches = drive_tiled(smi, tta_gate)
    built(builds, E)
    built(builds, QK)
    pool.shutdown()

    # phases 6-8: the fused paths, each group checked on its own inputs
    fused_launches, elan = 0, {"abs": 0.0, "rel": 0.0}
    elan_sums = None
    for name, seed, flag, requests, ref in (
            (w6, 0, True, REQUESTS, ref_w6), (w6, 0, "pre:", 2, ref_w6),
            (tiny, 1, True, REQUESTS, ref_tiny)):
        counts, _, _, det, _ = drive_path(
            name, smi, seed, frames[name], fuse_elan=flag,
            requests=requests, ref=ref)
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

    # phase 9: w6 in bf16, unfused, against phase 4's float32 raws
    bf16 = torch.bfloat16
    _, _, _, det, raws_w6_bf16 = drive_path(
        w6, smi, 0, frames[w6], dtype=bf16,
        ref_raws=[("the float32 card forward", raws_w6)])
    del det
    torch.cuda.empty_cache()

    # phase 10: the bf16 fused paths, each group checked on its own inputs
    bf16_elan, bf16_sums, bf16_launches = {"abs": 0.0, "rel": 0.0}, None, 0
    for name, seed, flag, requests, ref_raws in (
            (w6, 0, True, REQUESTS, [("the bf16 unfused card forward",
                                      raws_w6_bf16)]),
            (w6, 0, "pre:", 2, [("the bf16 unfused card forward",
                                 raws_w6_bf16)]),
            (tiny, 1, True, REQUESTS, [("the float32 card forward",
                                        raws_tiny)])):
        counts, _, _, det, _ = drive_path(
            name, smi, seed, frames[name], fuse_elan=flag,
            requests=requests, dtype=bf16, ref_raws=ref_raws)
        worst_abs, worst_rel, sums = check_groups(
            det, frames[name][0], smi, timed=flag is True)
        bf16_elan["abs"] = max(bf16_elan["abs"], worst_abs)
        bf16_elan["rel"] = max(bf16_elan["rel"], worst_rel)
        if name == w6 and flag is True:
            bf16_launches, bf16_sums = counts["fused"], sums
        del det
        torch.cuda.empty_cache()
        stamp(f"bf16 groups of {name} fuse_elan={flag!r} checked")

    # phase 11: the bf16 pyramid and tiles, and the batch-1 3840 profile
    _, bf16_gate = drive_tta(smi, bf16)
    drive_tiled(smi, bf16_gate, bf16)

    # phases 12-14: the other four zoo models
    new_worst, new_sums = drive_new_models(smi)

    # phases 15-19: the inference API on the card
    drive_predict(smi)
    w6_dets = drive_from_raws(smi, frames[w6][0])
    drive_agnostic_merge(smi, w6_dets)
    del w6_dets
    drive_augment(smi, frames[w6][0])
    drive_ensemble(smi, frames[w6][1])
    check(all(c["fixpoint"] == 0 and c["fused"] == 0
              for c in API_LAUNCHES.values()), f"phases 15-19 launched a "
          f"kernel other than nms_keep: {API_LAUNCHES}")

    # phase 20: int8 serving
    qconv_entry = drive_int8(smi, {w6: frames[w6], tiny: frames[tiny]})

    # phase 21: evaluation and production
    eval_fields, qconv_eval = drive_phase21(smi)

    # phase 22: training (the epoch-end validate launches nms_keep)
    train_timed = drive_phase22(smi)

    # phase 23: the exported program, the native app, int8 unchanged
    export_fields = drive_export(smi, frames[w6], w6_gate, qconv_entry)

    # phase 24: the extra blocks, served, alone and in a train step
    extra_fields = drive_phase24(smi)

    # phases 25-26: the data-parallel mesh (one process a card)
    mesh_fields = drive_mesh(smi, frames[w6], w6_gate, seed=0)
    mesh_routes = mesh_fields.pop("routes")

    # phase 27: the spatial mesh (one image's plane over a grid of ranks)
    spatial_fields = drive_spatial(smi, w6_gate)

    # phase 28: the examples and the weights fetch
    example_fields = drive_phase28(smi)
    mesh_tag = "yolov7-w6-face int8 mesh of 1 (nccl)"
    qconv_entry["launches"] += mesh_routes["qconv"]
    for key in ("depthwise", "wgmma", "split"):
        qconv_entry[f"{key}_launches"] += mesh_routes[key]
    qconv_entry["launches_by_path"][mesh_tag] = mesh_routes
    qconv_entry["eval_launches"] = qconv_eval
    qconv_entry["launches"] += qconv_eval["qconv"]
    for key in ("depthwise", "wgmma", "split"):
        qconv_entry[f"{key}_launches"] += qconv_eval[key]
    qconv_entry["launches_by_path"]["yolov7-w6-face int8 eval b16"] = \
        qconv_eval
    api_seq = sum(c["seq"] for c in API_LAUNCHES.values())
    for d, acc in ((torch.float32, elan), (bf16, bf16_elan)):
        acc["abs"] = max(acc["abs"], new_worst[d][0])
        acc["rel"] = max(acc["rel"], new_worst[d][1])
    by_model = {d: {name: group_entry(new_sums[(name, d)])
                    for name, seed in NEW_MODELS if (name, d) in new_sums}
                for d in (torch.float32, bf16)}
    total = {key: sum(c[key] for c in PATH_LAUNCHES.values())
             for key in ("seq", "fixpoint")}
    fused_by_path = {d: {tag: c["fused"] for tag, c in PATH_LAUNCHES.items()
                         if c["fused"] and ("bf16" in tag) == (d == bf16)}
                     for d in (torch.float32, bf16)}
    fused_by_path[torch.float32].update(
        {tag: c["fused"] for tag, c in MESH_LAUNCHES.items() if c["fused"]})

    # the keep-mask kernels at the w6 path's own inputs
    keep = K.nms_keep(boxes, valid, thr)
    want = K.nms_keep_plain(boxes, valid, thr)
    entries = []
    bound_ms, bound_by = nms_bound(keep, valid)
    plain_ms = cuda_ms(lambda: K.nms_keep_plain(boxes, valid, thr), 5)
    for version, name, line, launches, iters in (
            ("seq", "nms_keep", 94,
             total["seq"] + tta_launches + tiled_launches + api_seq
             + sum(EVAL_LAUNCHES.values()) + sum(TRAIN_LAUNCHES.values())
             + sum(EXPORT_LAUNCHES.values())
             + sum(c["seq"] for c in MESH_LAUNCHES.values())
             + sum(SPATIAL_LAUNCHES.values())
             + sum(c["seq"] for c in EXAMPLE_LAUNCHES.values()), 20),
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
            "serving_launches": total[version],
            "launches_by_path": {tag: c[version] for tag, c in
                                 PATH_LAUNCHES.items()},
            # phases 15-19: predict, from_raws, agnostic=, augment and
            # the ensemble, one entry a counted call
            "api_launches": {tag: c[version] for tag, c in
                             API_LAUNCHES.items()},
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
    entries[0].update(pass1_ms=pass1, pass2_ms=pass2, dense_bound_ms=dense_ms,
                      # phase 21: evaluation and production, one entry a
                      # counted call; the eval point B = 16, K = 16384
                      phase21_launches=dict(EVAL_LAUNCHES), **eval_fields,
                      # phase 22: the training path's epoch-end validate
                      train_launches=dict(TRAIN_LAUNCHES),
                      # phase 23: the loaded .pt2 programs' calls, and
                      # what the export, load and serving cost
                      export_launches=dict(EXPORT_LAUNCHES),
                      export=export_fields,
                      # phase 24: the extra cfg (its paths' launches are
                      # in launches_by_path)
                      extra=extra_fields,
                      # phases 25-26: the mesh calls (every rank's), and
                      # the phases' seconds, train tolerance ratios and
                      # the ranks' busy shares
                      mesh_launches={tag: c["seq"] for tag, c in
                                     MESH_LAUNCHES.items()},
                      mesh=mesh_fields,
                      # phase 27: the spatial calls with the NMS (every
                      # rank's), and each grid's numbers
                      spatial_launches=dict(SPATIAL_LAUNCHES),
                      spatial=spatial_fields,
                      # phase 28: the examples' counted calls and their
                      # host-clock ms
                      example_launches={tag: c["seq"] for tag, c in
                                        EXAMPLE_LAUNCHES.items()},
                      examples=example_fields,
                      train_timed={
                          d: {k: v for k, v in t.items()
                              if not k.endswith("_all")}
                          for d, t in train_timed.items()})
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
        "launches": sum(fused_by_path[torch.float32].values()),
        "launches_by_path": fused_by_path[torch.float32],
        "w6_launches": fused_launches, "max_abs_err": elan["abs"],
        "max_rel_err": elan["rel"], **group_entry(s),
        "bound_rate": "3xTF32: 495/3 = 165 TFLOP/s, 3.35 TB/s",
        "simt_bound_ms": max(s["t_bytes"], s["t_simt"]),
        "per": "sum over the 11 w6 groups of one b8@640 forward",
        "by_model": by_model[torch.float32]})
    s = bf16_sums
    entries.append({
        "name": "fused_elan_bf16", "route": "cuda",
        "source": "face_detection_multi_scale_tpu_torch/csrc/fused_elan.cu",
        "replaces": "face_detection_multi_scale_tpu/ops/pallas_elan.py:194",
        "dtype": "bfloat16",
        "launches": sum(fused_by_path[bf16].values()),
        "launches_by_path": fused_by_path[bf16],
        "w6_launches": bf16_launches,
        "max_abs_err": bf16_elan["abs"], "max_rel_err": bf16_elan["rel"],
        **group_entry(s), "bound_rate": "bf16: 989 TFLOP/s, 3.35 TB/s",
        "per": "sum over the 11 w6 groups of one b8@640 bf16 forward",
        "by_model": by_model[bf16]})
    entries.append(qconv_entry)
    entries += probe_entries
    stamp("kernel times done")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-noise"]:
        mesh_noise([int(v) for v in sys.argv[2].split(",")])
    else:
        main()
