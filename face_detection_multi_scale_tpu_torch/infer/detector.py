"""The inference engine: single-scale, batched, and multi-scale TTA
detection.

Counterpart of the JAX package's infer/detector.py `FaceDetector` (its
engine at detector.py:338-344 and `run_network` without a mesh):
uint8 NHWC batch -> /255 -> YoloFace forward with BN folded (or, with
`fuse_elan`, the fused-ELAN executor of models/fused.py, or, with
`quantize="int8"`, the W8A8 executor of models/quant.py, as the JAX
`_forward` at detector.py:270-285) -> grid decode -> fixed-capacity NMS
(the keep mask through the CUDA kernel on the card) -> Detections, then
the host-side inverse letterbox. With a data mesh (parallel/mesh.py, one
process a card) `run_network` takes the JAX `run_network`'s mesh branch:
every rank is called with the global batch, runs its rows on its card
and returns the Detections of the whole batch. The TTA pyramid
(`detect_multi_scale`) runs every scale and merges them with the scale-weighted NMS, whose keep
mask goes through the same kernel. A giant scale can run as one batch of
halo'd tiles (`tile_top_scale`, infer/tiling.py), and a large batch as a
loop over chunks (`micro_batch`). `predict` (also `__call__`) is the hub
surface: any image input, one common letterboxed rectangle, one engine
call, an infer/results.py `Detections` object.

PyTorch runs eagerly, so there is no per-shape executable to cache.
Preprocessing (letterbox / pad-to-square) stays on the host in cv2 for
parity with the reference pipeline, and the division by 255 happens on the
device, so the upload is uint8; with `use_device_preprocess` the whole
preprocess runs on the device instead (infer/device_preprocess.py).
"""

from __future__ import annotations

import copy
import dataclasses
import time
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from face_detection_multi_scale_tpu_torch.data import letterbox as LB
from face_detection_multi_scale_tpu_torch.infer import device_preprocess as DP
from face_detection_multi_scale_tpu_torch.infer import tiling
from face_detection_multi_scale_tpu_torch.models import zoo
from face_detection_multi_scale_tpu_torch.models.convert import (
    jax_to_state_dict, load_inference_weights, load_reference_state_dict,
    load_torch_checkpoint)
from face_detection_multi_scale_tpu_torch.models.fuse import fold_bn
from face_detection_multi_scale_tpu_torch.models.fused import (
    apply_variant, elan_weights, find_elan_blocks, fused_apply)
from face_detection_multi_scale_tpu_torch.models.head import decode
from face_detection_multi_scale_tpu_torch.models import quant
from face_detection_multi_scale_tpu_torch.models.model import (
    YoloFace, cast_model, compute_strides, full_fp32, init_weights)
from face_detection_multi_scale_tpu_torch.models.spec import ModelSpec
from face_detection_multi_scale_tpu_torch.ops import nms as NMS
from face_detection_multi_scale_tpu_torch.parallel.mesh import (
    active_mesh, gather_rows, replicated)
from face_detection_multi_scale_tpu_torch.utils.downloads import (
    attempt_download)
from face_detection_multi_scale_tpu_torch.utils.general import (
    check_img_size, make_divisible)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


# the serving dtypes of the JAX FaceDetector that the port runs, by name
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class FaceDetector:
    """Face detector over a zoo model (or a custom spec, whose strides
    `compute_strides` derives), in float32 by default or in bfloat16.

    In float32 the forward runs in full float32: cuDNN's TF32 is switched
    off around it (`full_fp32`), so the card computes what the CPU
    computes, up to the order of sums.

    `dtype=torch.bfloat16` serves as the JAX FaceDetector's
    `dtype=jnp.bfloat16` (its batch tool's default): BN is folded in
    float32 and the model then cast (models/model.cast_model), the uint8
    input cast to bf16 before the /255 (and the device preprocess resizes
    and pads in bf16), every conv runs in bf16, and with `fuse_elan` each
    group runs the bf16 form of the fused kernel (bf16 kernels, float32
    biases). As in the JAX package, the head's implicit priors stay
    float32, so the raw maps of these implicit heads, the decode, the
    rows and `Detections` are float32 (the kpt channels carry bf16
    values); the postprocess takes bf16 rows as well, with the keep mask
    on float32 boxes as the JAX package's TPU route, and
    `detections_to_numpy` returns float32. Any other dtype raises
    NotImplementedError.

    Args mirror the JAX FaceDetector, in its order (then `device`), so a
    positional call builds the same serving mode in both packages.
    `mesh` is a parallel.mesh.DataMesh (`make_data_mesh()`, one process a
    card; every rank builds the detector and makes every call): the
    serving weights (and the int8 qparams, once calibrated) are rank 0's
    on every rank, and `run_network` pads the batch with zero frames to a
    multiple of the mesh size, runs this rank's rows on `device` (one
    `nms_keep` launch a call on the card) and gathers every row's
    Detections to every rank, the padding dropped. The paths that
    preprocess on the device run whole on every rank, as in the JAX
    package, and `micro_batch` is inert under a mesh (warned once). A
    world of one without a process group serves as without a mesh.
    `variables` is either
    a JAX-layout variables tree of numpy arrays (carried over by the
    weight bridge, models/convert.py) or a torch state dict with
    reference key names;
    `torch_weights` is the path of a checkpoint that replaces
    `variables`: a reference `.pt` (EMA preferred) or the JAX package's
    flat inference `.npz`; a missing one is fetched from the release
    first (utils/downloads.attempt_download), as in JAX. With neither,
    weights are the seeded init (`seed`). `fuse` folds BN into the convs
    for serving. `device` defaults to the card and raises when there is
    none.

    `micro_batch` runs a larger batch as a loop of engine calls over
    chunks of that many images (peak activation memory is the chunk's),
    when it divides the batch; otherwise the batch runs whole.

    `tile_top_scale` (a grid g >= 2, or True for 2) runs every scale of
    at least `tile_min_size` px as one batch of g x g tiles with a
    `tile_halo` px overlap context, reassembled by tile ownership and a
    seam dedup (infer/tiling.py): an approximation near seams, off by
    default.

    `fuse_elan` runs each E-ELAN group as one fused kernel launch
    (models/fused.py, ops/elan_kernel.py): True with the default kernel,
    or a variant expression of the JAX package's grammar, optionally
    prefixed "pre:" to absorb each group's feeding downsample conv
    (`apply_variant` per block; the layout parts change no numbers).

    `quantize="int8"` serves W8A8 (models/quant.py, the JAX package's
    quantized mode): int8 weights and int8 activations between convs, each
    conv one launch of the int8 kernel (ops/qconv_kernel.py) on the card,
    the head in `dtype` on dequantized inputs. The scales come from a
    float32 calibration walk: pass `calib_images` (uint8 NHWC network-input
    frames, at most 8 used) or call `calibrate_int8`; otherwise the first
    batch that `run_network` serves calibrates. The device-preprocess
    paths and `warmup` need the calibration first. It excludes
    `fuse_elan`, as in the JAX package.

    `use_device_preprocess` letterboxes, resizes and normalizes on the
    device (infer/device_preprocess.py): the raw uint8 frame is the only
    upload, one upload serves every pyramid scale, and the host needs no
    OpenCV for arrays; pixels differ from the cv2 path by at most about
    2/255.
    """

    def __init__(self, model: Union[str, ModelSpec] = "yolov7-w6-face",
                 variables=None, torch_weights: Optional[str] = None,
                 img_sizes: Sequence[int] = (640, 3840),
                 conf_thres: float = 0.5, iou_thres: float = 0.5,
                 use_api_preprocess: bool = False,
                 dtype: torch.dtype = torch.float32, max_det: int = 300,
                 max_candidates: int = 4096, seed: int = 0,
                 mesh=None, fuse: bool = True,
                 use_device_preprocess: bool = False,
                 fuse_elan: Union[bool, str] = False,
                 micro_batch: Optional[int] = None,
                 tile_top_scale: Union[bool, int] = False,
                 tile_halo: int = 256, tile_min_size: int = 2048,
                 quantize: Optional[str] = None, calib_images=None,
                 device="cuda"):
        if dtype not in DTYPES.values():
            raise NotImplementedError(
                f"FaceDetector: dtype {dtype} is not ported (float32 and "
                f"bfloat16 are)")
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', "
                             f"got {quantize!r}")
        if quantize and fuse_elan:
            raise ValueError("quantize and fuse_elan are mutually "
                             "exclusive serving modes")
        self.dtype = dtype
        self.device = _device(device)
        # the mesh that splits batches (None for a world of one without a
        # process group, which serves as without a mesh)
        self._mesh = active_mesh(mesh)
        if isinstance(model, str):
            spec = zoo.get_spec(model)  # pinned strides
        else:
            # a custom spec (hub.custom, a cfg yaml): strides from a
            # shape-only forward, as the JAX detector does; the parser's
            # P3-start default is wrong for a P4/P5 cfg
            spec = model
            compute_strides(spec)
        self.spec = spec.resolve()
        net = YoloFace(self.spec)
        if torch_weights is not None:
            # a missing weights file is fetched first, as in JAX
            path = attempt_download(str(torch_weights))
            variables = (load_inference_weights(path)
                         if path.endswith(".npz")
                         else load_torch_checkpoint(path))
        if variables is None:
            init_weights(net, torch.Generator().manual_seed(seed))
        else:  # a JAX-layout tree, or a state dict with reference keys
            load_reference_state_dict(net, jax_to_state_dict(variables)
                                      if "params" in variables else variables)
        if fuse:
            fold_bn(net)
        self._elan_blocks = []
        if fuse_elan:
            expr = fuse_elan if isinstance(fuse_elan, str) else ""
            absorb = expr.startswith("pre:")
            expr = expr[4:] if absorb else expr
            blocks = find_elan_blocks(self.spec, absorb_pre=absorb)
            if expr:
                blocks = [dataclasses.replace(
                    b, shape=apply_variant(b.shape, expr)) for b in blocks]
            self._elan_blocks = blocks
        # packed group weights from the float32 model, before the cast:
        # kernels in `dtype`, biases float32 (the JAX packer's)
        self._elan_weights = elan_weights(net, self._elan_blocks, dtype,
                                          self.device)
        # int8 serving calibrates and quantizes from the float32 model
        self._quantize = quantize
        self._qparams = None
        self._float_model = None
        if quantize:
            self._float_model = (net if dtype == torch.float32
                                 else copy.deepcopy(net)).eval().to(
                                     self.device)
        self.model = cast_model(net.eval().to(self.device), dtype)
        if self._mesh is not None:
            replicated(self._mesh, [*self.model.state_dict().values(), *(
                t for ws in self._elan_weights.values()
                for t in ws.tensors()), *(
                self._float_model.state_dict().values()
                if self._float_model is not None else ())])
        if quantize:
            # the op set is checked now (NotImplementedError outside the
            # int8 executor) by the compute-free structural walk
            quant.calibrate_shape_only(self.spec, self._float_model)
            if calib_images is not None:
                self.calibrate_int8(calib_images)

        self.stride = self.spec.max_stride
        self.img_sizes = [check_img_size(s, self.stride) for s in img_sizes]
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.use_api_preprocess = use_api_preprocess
        self.use_device_preprocess = use_device_preprocess
        self.max_det = max_det
        self.max_candidates = max_candidates
        self.micro_batch = micro_batch
        self._warned_mb_divide = False
        self._warned_mb_mesh = False
        self.tile_grid = 2 if tile_top_scale is True else \
            int(tile_top_scale or 0)
        if self.tile_grid == 1:
            raise ValueError(
                "tile_top_scale=1 is not a tiling (grid must be >= 2); "
                "pass 0/False for the untiled path")
        self.tile_halo = tile_halo
        self.tile_min_size = tile_min_size
        self._warned_tile_standard = False
        self._trunc_images = 0
        self._trunc_total = 0
        self._trunc_max_gated = 0
        self._trunc_dropped = 0

    def _record_truncation(self, dets: NMS.Detections) -> None:
        n = dets.n_gated.cpu().numpy().reshape(-1)
        self._trunc_images += int((n > self.max_candidates).sum())
        self._trunc_total += int(n.size)
        self._trunc_max_gated = max(self._trunc_max_gated, int(n.max()))
        self._trunc_dropped += int(
            np.clip(n - self.max_candidates, 0, None).sum())

    def _record_truncation_tiled(self, dets: NMS.Detections,
                                 n_tiles: int) -> None:
        """Tiled-scale telemetry: one report entry per IMAGE, not per tile
        (the capacity is per tile, so an image is truncated iff any of its
        tiles overflowed; dropped counts sum over its tiles)."""
        n = dets.n_gated.cpu().numpy().reshape(-1, n_tiles)
        self._trunc_images += int((n > self.max_candidates)
                                  .any(axis=1).sum())
        self._trunc_total += int(n.shape[0])
        self._trunc_max_gated = max(self._trunc_max_gated, int(n.max()))
        self._trunc_dropped += int(
            np.clip(n - self.max_candidates, 0, None).sum())

    def truncation_report(self) -> Dict[str, int]:
        """Accumulated candidate-truncation stats over every network call
        served; truncated_images > 0 means crowded inputs exceeded
        `max_candidates` and recall was capped."""
        return {"images": self._trunc_total,
                "truncated_images": self._trunc_images,
                "max_gated": self._trunc_max_gated,
                "max_candidates": int(self.max_candidates),
                "dropped_total": self._trunc_dropped}

    # ------------------------------------------------------------------
    # the engine
    # ------------------------------------------------------------------

    def calibrate_int8(self, images_u8) -> None:
        """Post-training calibration for quantize="int8": a float32 walk
        over `images_u8` (uint8 NHWC network-input frames, or float in [0,
        1]; at most 8 used) records each tensor's range, then the int8
        qparams that serving uses are built."""
        x = images_u8[:8]
        x = torch.as_tensor(x if isinstance(x, torch.Tensor)
                            else np.asarray(x)).to(self.device)
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        qparams = quant.quantize_model(self.spec, self._float_model, x)
        if self._mesh is not None:  # rank 0's scales on every rank
            with torch.inference_mode():  # inference tensors, in place
                replicated(self._mesh, [
                    t for conv in qparams["convs"].values()
                    for t in conv.values()]
                    + list(qparams["adds"].values())
                    + [qparams["head_scales"]])
        self._qparams = qparams

    def _ensure_calibrated(self, images_u8) -> None:
        if self._quantize and self._qparams is None:
            self.calibrate_int8(images_u8)

    def _require_calibrated_for_dev(self) -> None:
        """The device preprocess letterboxes on the device, so there is no
        network-input frame on the host to calibrate on lazily: quantized
        serving there needs an explicit calibration."""
        if self._quantize and self._qparams is None:
            raise RuntimeError(
                "quantize='int8' with use_device_preprocess needs "
                "explicit calibration: pass calib_images= or call "
                "calibrate_int8(frames) before serving")

    @torch.inference_mode()
    def forward_rows(self, images_u8) -> torch.Tensor:
        """uint8 NHWC (bs, h, w, 3) -> decoded rows (bs, N, no) in the
        detector's dtype on its device (the cast before the /255, as the
        JAX engine's `images_u8.astype(dtype) / 255.0`)."""
        x = torch.as_tensor(images_u8).to(self.device)
        return self.forward_input(x.to(self.dtype) / 255.0)

    @torch.inference_mode()
    def forward_input(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC network input in [0, 1] in the detector's dtype on its
        device -> decoded rows (bs, N, no)."""
        return decode(self._forward(x), self.spec)

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor,
                 reshape_heads: bool = True) -> List[torch.Tensor]:
        """The network of every engine call (the JAX `_forward`): the
        model, the W8A8 executor with `quantize` (x in [0, 1] is quantized
        to int8 there), or the fused-ELAN executor with `fuse_elan`; raw
        per-level maps (with `reshape_heads=False` in the conv layout (bs,
        ny, nx, na*no), the input of
        `NMS.non_max_suppression_from_raws`)."""
        with full_fp32():
            if self._quantize:
                if self._qparams is None:
                    raise RuntimeError(
                        "quantize='int8': not calibrated; pass "
                        "calib_images= or call calibrate_int8(frames)")
                return quant.quant_apply(self.spec, self._qparams, x,
                                         self.model.model[-1],
                                         reshape_heads, dtype=self.dtype)
            if self._elan_blocks:
                return fused_apply(self.model, x, self._elan_blocks,
                                   self._elan_weights, reshape_heads)
            return self.model(x, reshape_heads)

    @torch.inference_mode()
    def postprocess(self, preds: torch.Tensor) -> NMS.Detections:
        """Decoded rows -> Detections with this detector's thresholds and
        capacities (on the rows' device)."""
        return NMS.non_max_suppression(
            preds, self.conf_thres, self.iou_thres, nc=self.spec.nc,
            max_candidates=self.max_candidates, max_det=self.max_det)

    def _microbatched(self, engine, batch) -> NMS.Detections:
        """`engine` (a chunk of frames -> Detections) over the whole batch:
        one call per `micro_batch` frames, the chunks' Detections
        concatenated in batch order, when micro-batching is on and the
        chunk divides the batch; else one call on the whole batch (with a
        warning, once, when the chunk does not divide it). Under a mesh
        the engine runs on the whole batch (warned once when micro_batch
        is set), as in the JAX package."""
        mb, n = self.micro_batch, batch.shape[0]
        if mb and self._mesh is not None:
            if not self._warned_mb_mesh:
                self._warned_mb_mesh = True
                warnings.warn(
                    f"micro_batch={mb} is inert under a mesh (the batch "
                    "dim carries the data sharding; per-card chunking is "
                    "not implemented) — running whole-batch",
                    RuntimeWarning, stacklevel=3)
            return engine(batch)
        if not mb or n <= mb or n % mb:
            if mb and n > mb and not self._warned_mb_divide:
                self._warned_mb_divide = True
                warnings.warn(
                    f"micro_batch={mb} does not divide batch {n} — "
                    "running whole-batch (pad or resize the batch to a "
                    "multiple to get micro-batching)",
                    RuntimeWarning, stacklevel=3)
            return engine(batch)
        chunks = [engine(batch[i:i + mb]) for i in range(0, n, mb)]
        return NMS.Detections(*(torch.cat(parts) for parts in zip(*chunks)))

    def run_network(self, images_u8, *,
                    _record: bool = True) -> NMS.Detections:
        """Raw engine call: uint8 NHWC (bs, h, w, 3) -> Detections on the
        detector's device. _record=False leaves the truncation telemetry
        to the caller (the tiled paths record one entry per image, not
        per tile). A quantized detector that is not calibrated yet
        calibrates on this batch first (the whole batch, before a mesh
        splits it)."""
        self._ensure_calibrated(images_u8)
        engine = lambda chunk: self.postprocess(self.forward_rows(chunk))
        if self._mesh is None:
            dets = self._microbatched(engine, images_u8)
        else:
            dets = self._run_mesh(engine, images_u8)
        if _record:
            self._record_truncation(dets)
        return dets

    def _run_mesh(self, engine, images_u8) -> NMS.Detections:
        """The mesh branch of run_network (the JAX one at detector.py:
        417-433): the batch padded with zero frames to a multiple of the
        mesh size, this rank's rows through `engine`, and every row's
        Detections gathered to every rank, bit for bit, the padded tail
        dropped."""
        mesh = self._mesh
        x = torch.as_tensor(images_u8)
        bs = x.shape[0]
        n = bs + (-bs) % mesh.size
        if n > bs:
            x = torch.cat([x, x.new_zeros((n - bs, *x.shape[1:]))])
        dets = self._microbatched(engine, x[mesh.rows(n)])
        return NMS.Detections(*(None if t is None else
                                gather_rows(mesh, t, n)[:bs] for t in dets))

    @torch.inference_mode()
    def device_input(self, raw_u8: torch.Tensor, img_size: int,
                     auto: bool):
        """Device preprocess of raw uint8 NHWC BGR frames on the detector's
        device -> (NHWC network input in the detector's dtype,
        LetterboxGeometry), whose `out_hw` is the input shape the
        coordinate inverse needs."""
        src_hw = tuple(raw_u8.shape[1:3])
        if self.use_api_preprocess:
            # raw frames are BGR (cv2); the API chain expects RGB
            return (DP.device_preprocess_api(raw_u8.flip(-1), img_size,
                                             dtype=self.dtype),
                    DP.geometry_for_api(src_hw, img_size))
        geom = DP.letterbox_geometry(src_hw, img_size, auto=auto,
                                     stride=self.stride)
        return DP.device_letterbox(raw_u8, geom, dtype=self.dtype), geom

    def run_network_raw(self, raw_u8: torch.Tensor, img_size: int,
                        auto: bool):
        """Engine call with device preprocessing: raw uint8 NHWC frames on
        the device -> (Detections, LetterboxGeometry), the counterpart of
        the JAX `_executable_dev` run."""
        self._require_calibrated_for_dev()
        geom = None

        def engine(chunk):
            nonlocal geom
            x, geom = self.device_input(chunk, img_size, auto)
            return self.postprocess(self.forward_input(x))

        dets = self._microbatched(engine, raw_u8)
        self._record_truncation(dets)
        return dets, geom

    # ------------------------------------------------------------------
    # preprocessing
    # ------------------------------------------------------------------

    def _load(self, img) -> np.ndarray:
        if isinstance(img, (str, bytes)):
            import cv2
            im = cv2.imread(img)
            if im is None:
                raise ValueError(f"could not read image: {img!r}")
            return im
        return img

    def upload(self, images: np.ndarray) -> torch.Tensor:
        """Host uint8 NHWC frames -> the same on the detector's device."""
        return torch.from_numpy(np.ascontiguousarray(images)).to(self.device)

    def preprocess(self, img_bgr: np.ndarray, img_size: int) -> np.ndarray:
        """BGR HWC uint8 -> RGB HWC uint8 network input (reference
        multi_scale_face_detector.py:69-107 semantics for both modes)."""
        if self.use_api_preprocess:
            return LB.preprocess_api(img_bgr[:, :, ::-1], img_size,
                                     self.stride)
        return LB.preprocess_standard(img_bgr, img_size, self.stride,
                                      auto=True)

    # ------------------------------------------------------------------
    # tiled giant scales
    # ------------------------------------------------------------------

    def _tile_plan(self, img_size: int) -> Optional[tiling.TilePlan]:
        """TilePlan when tiling applies to this scale, else None."""
        if self.tile_grid < 2 or img_size < self.tile_min_size:
            return None
        return tiling.plan_tiles(img_size, self.tile_grid, self.tile_halo,
                                 self.stride)

    def _run_tiled_batch(self, inputs, plan) -> List[np.ndarray]:
        """Letterboxed square uint8 frames -> per-frame (n, 6+E) rows in
        frame coordinates: ALL frames' g^2 halo'd tiles in one engine
        call, reassembled per frame by tile ownership and a seam dedup on
        the detector's device, with per-image (not per-tile) truncation
        telemetry. The one tiled call sequence of every tiled path."""
        tiles = np.concatenate([tiling.extract_tiles(inp, plan)
                                for inp in inputs])
        dets = self.run_network(tiles, _record=False)
        self._record_truncation_tiled(dets, plan.n_tiles)
        tile_rows = NMS.detections_to_numpy(dets)
        n = plan.n_tiles
        return [tiling.assemble_rows(tile_rows[i * n:(i + 1) * n], plan,
                                     self.iou_thres, device=self.device)
                for i in range(len(inputs))]

    def _run_scale_tiled(self, inp: np.ndarray, plan) -> np.ndarray:
        """One letterboxed S x S frame -> (n, 6+E) rows in the S x S
        frame."""
        return self._run_tiled_batch([inp], plan)[0]

    # ------------------------------------------------------------------
    # detection APIs
    # ------------------------------------------------------------------

    def detect_single_scale(self, img, img_size: int, _raw_dev=None):
        """One image, one pyramid scale. Returns (detections, img0_shape,
        seconds): detections is (n, 7) [x1, y1, x2, y2, conf, cls,
        scale_idx] in original-image pixels (multi_scale_face_detector.py:
        109-166 contract, including the 6-column truncation, the
        API-inverse rescale and the .round()).

        `_raw_dev` (internal): the (1, h, w, 3) uint8 raw frame already on
        the device; the multi-scale loop uploads the frame once and reuses
        it at every scale when device preprocessing is on.

        A tiled scale (`tile_top_scale`) needs a SQUARE scale frame, which
        only the API mode's pad-to-square gives here; the standard mode
        letterboxes auto=True (rectangular), so there tiling applies only
        through detect_multi_scale_batch (warned once). The tiled scale
        letterboxes on the host even with device preprocessing, from the
        host frame when the caller handed one."""
        if _raw_dev is not None:
            img0_shape = tuple(int(v) for v in _raw_dev.shape[1:])
            img0 = None
        else:
            img0 = self._load(img)
            img0_shape = img0.shape
        plan = (self._tile_plan(img_size) if self.use_api_preprocess
                else None)
        if (plan is None and not self.use_api_preprocess
                and self.tile_grid >= 2 and img_size >= self.tile_min_size
                and not self._warned_tile_standard):
            self._warned_tile_standard = True
            warnings.warn(
                "tile_top_scale is inert on the per-image standard-"
                "preprocess path (rectangular auto=True letterbox); use "
                "use_api_preprocess=True or detect_multi_scale_batch "
                "for tiled giant scales", RuntimeWarning, stacklevel=2)
        t1 = time.perf_counter()
        if plan is not None:
            if img0 is None:
                img0 = (self._load(img) if img is not None
                        else _raw_dev[0].cpu().numpy())
            inp = self.preprocess(img0, img_size)
            rows = self._run_scale_tiled(inp, plan)
            inp_hw = inp.shape[:2]
        elif self.use_device_preprocess:
            raw = _raw_dev if _raw_dev is not None else self.upload(img0[None])
            dets, geom = self.run_network_raw(raw, img_size, auto=True)
            inp_hw = geom.out_hw
            rows = NMS.detections_to_numpy(dets)[0]
        else:
            inp = self.preprocess(img0, img_size)
            dets = self.run_network(inp[None])
            inp_hw = inp.shape[:2]
            rows = NMS.detections_to_numpy(dets)[0]
        t2 = time.perf_counter()

        rows = rows[:, :6]
        if len(rows):
            rows[:, :4] = LB.scale_coords_api(
                inp_hw, rows[:, :4].astype(np.float64), img0_shape).round()
        scale_idx = self.img_sizes.index(img_size) if img_size in \
            self.img_sizes else -1
        out = np.hstack([rows, np.full((len(rows), 1), scale_idx,
                                       rows.dtype)])
        return out, img0_shape, t2 - t1

    def detect_multi_scale(self, img):
        """Full TTA pyramid: detect at every scale, merge with the
        scale-aware weighted NMS (multi_scale_face_detector.py:242-288),
        whose keep mask runs on the detector's device. Returns (final
        (n, 7) array, img0_shape)."""
        all_dets: List[np.ndarray] = []
        img0_shape = None
        img0 = self._load(img)
        # device preprocessing: ONE raw-frame upload serves all scales
        raw_dev = (self.upload(img0[None]) if self.use_device_preprocess
                   else None)
        for img_size in self.img_sizes:
            det, img0_shape, _ = self.detect_single_scale(
                img0, img_size, _raw_dev=raw_dev)
            if len(det):
                all_dets.append(det)
        if not all_dets:
            return np.zeros((0, 7)), img0_shape
        merged = np.vstack(all_dets)
        keep = NMS.weighted_nms_merge(merged, len(self.img_sizes),
                                      self.iou_thres, device=self.device)
        return merged[keep], img0_shape

    def detect_multi_scale_batch(self, imgs: Sequence) -> List[np.ndarray]:
        """Batched TTA pyramid: all images go through each scale as ONE
        engine call (host preprocessing), then merge per image with the
        weighted NMS.

        In API mode this is functionally identical to detect_multi_scale
        per image (same pad-to-square preprocess + top-left-scale
        inverse). In standard mode the images are letterboxed to a
        centered square (auto=False, the only batchable variant) and
        inverted with the exact gain+pad `scale_coords`, so boxes land in
        true original-image coordinates; for non-square images that
        differs from the per-image standard path, which applies the API
        inverse to an auto=True letterbox (multi_scale_face_detector.py:
        144, a reference quirk mirrored there)."""
        loaded = [self._load(im) for im in imgs]
        per_image: List[List[np.ndarray]] = [[] for _ in loaded]
        for scale_idx, img_size in enumerate(self.img_sizes):
            if self.use_api_preprocess:
                inputs = [self.preprocess(im, img_size) for im in loaded]
            else:
                inputs = [LB.preprocess_standard(im, img_size, self.stride,
                                                 auto=False)
                          for im in loaded]
            plan = self._tile_plan(img_size)
            if plan is not None:
                # giant scale: every image's g^2 tiles in ONE engine call
                rows_list = self._run_tiled_batch(inputs, plan)
            else:
                rows_list = NMS.detections_to_numpy(
                    self.run_network(np.stack(inputs)))
            frame_hw = inputs[0].shape[:2]
            for i, rows in enumerate(rows_list):
                rows = rows[:, :6].astype(np.float64)
                if len(rows):
                    if self.use_api_preprocess:
                        rows[:, :4] = LB.scale_coords_api(
                            frame_hw, rows[:, :4], loaded[i].shape).round()
                    else:
                        rows[:, :4] = LB.scale_coords(
                            frame_hw, rows[:, :4],
                            loaded[i].shape[:2]).round()
                per_image[i].append(np.hstack([
                    rows, np.full((len(rows), 1), scale_idx)]))
        out = []
        for dets_per_scale in per_image:
            merged = np.vstack(dets_per_scale)
            if not len(merged):
                out.append(np.zeros((0, 7)))
                continue
            keep = NMS.weighted_nms_merge(merged, len(self.img_sizes),
                                          self.iou_thres, device=self.device)
            out.append(merged[keep])
        return out

    def detect_batch(self, imgs: Sequence, img_size: int,
                     kpt: bool = True) -> List[np.ndarray]:
        """Throughput path: a batch of images at one scale in one engine
        call, letterboxed to the same square (auto=False). With device
        preprocessing and frames of one shape (video), the raw frames are
        uploaded and letterboxed on the device. A tiled scale letterboxes
        on the host and runs every image's tiles in one engine call.
        Returns per-image (n, 6 [+3*nkpt]) arrays in original
        coordinates."""
        img_size = check_img_size(img_size, self.stride)
        loaded = [self._load(img) for img in imgs]
        shapes = [im.shape for im in loaded]
        plan = self._tile_plan(img_size)
        if (plan is None and self.use_device_preprocess
                and self._mesh is None and len(set(shapes)) == 1):
            dets, _ = self.run_network_raw(self.upload(np.stack(loaded)),
                                           img_size, auto=False)
            rows_list = NMS.detections_to_numpy(dets)
        else:
            inputs = []
            for img0 in loaded:
                if self.use_api_preprocess:
                    inputs.append(LB.preprocess_api(
                        img0[:, :, ::-1], img_size, self.stride))
                else:
                    inputs.append(LB.preprocess_standard(
                        img0, img_size, self.stride, auto=False))
            if plan is not None:
                rows_list = self._run_tiled_batch(inputs, plan)
            else:
                rows_list = NMS.detections_to_numpy(
                    self.run_network(np.stack(inputs)))
        out = []
        for rows, shape in zip(rows_list, shapes):
            rows = rows.astype(np.float64)
            if not kpt:
                rows = rows[:, :6]
            if len(rows):
                if self.use_api_preprocess:
                    rows[:, :4] = LB.scale_coords_api(
                        (img_size, img_size), rows[:, :4], shape)
                    if kpt and rows.shape[1] > 6:
                        # same pad-to-square inverse for landmarks: pure
                        # scale by max(orig)/input, then clip
                        scale = max(shape[0], shape[1]) / img_size
                        rows[:, 6::3] = (rows[:, 6::3] * scale).clip(
                            0, shape[1])
                        rows[:, 7::3] = (rows[:, 7::3] * scale).clip(
                            0, shape[0])
                else:
                    rows[:, :4] = LB.scale_coords(
                        (img_size, img_size), rows[:, :4], shape[:2])
                    if kpt and rows.shape[1] > 6:
                        rows[:, 6:] = LB.scale_coords(
                            (img_size, img_size), rows[:, 6:], shape[:2],
                            kpt=True, step=3)
            out.append(rows)
        return out

    def predict(self, imgs, size: int = 640):
        """Input-robust hub inference — the autoShape forward equivalent
        (reference models/common.py:572-639, the JAX `predict`): accepts
        a filename, an http URL, a PIL image, an HWC numpy array (RGB, per
        the autoShape convention), a CHW array, a grayscale array, or a
        list of any of those; letterboxes the batch to ONE stride-aligned
        common rectangle (max of the per-image scaled shapes), runs the
        engine once, and returns a `Detections` results object
        (xyxy/xywh/normalized/pandas/save/crop/render) in each image's
        own pixels.

        Reading a file needs OpenCV, a URL `requests` and Pillow; arrays
        already at the common rectangle (e.g. 640x640 or 512x640 at
        size=640) are letterboxed without OpenCV."""
        from face_detection_multi_scale_tpu_torch.infer.results import (
            Detections)

        t = [time.perf_counter()]
        batch = imgs if isinstance(imgs, (list, tuple)) else [imgs]
        n = len(batch)
        loaded, files, shape0, shape1 = [], [], [], []
        for i, im in enumerate(batch):
            f = f"image{i}"
            if isinstance(im, str):
                if im.startswith("http"):
                    import requests
                    from PIL import Image

                    im, f = np.asarray(Image.open(
                        requests.get(im, stream=True).raw)), im
                else:
                    f = im
                    im = np.asarray(self._load(im))[:, :, ::-1]  # RGB
            elif hasattr(im, "filename"):  # PIL Image
                f = getattr(im, "filename", None) or f
                im = np.asarray(im)
            im = np.asarray(im)
            files.append(Path(f).with_suffix(".jpg").name)
            if im.shape[0] < 5:  # CHW input
                im = im.transpose((1, 2, 0))
            im = (im[:, :, :3] if im.ndim == 3
                  else np.tile(im[:, :, None], 3))
            s = im.shape[:2]
            shape0.append(s)
            g = size / max(s)
            shape1.append([y * g for y in s])
            loaded.append(np.ascontiguousarray(im))
        # one common stride-aligned inference rectangle
        # (models/common.py:619)
        shape1 = [make_divisible(x, self.stride)
                  for x in np.stack(shape1, 0).max(0)]
        x = np.stack([LB.letterbox(im, tuple(shape1), auto=False)[0]
                      for im in loaded])
        t.append(time.perf_counter())
        # detections_to_numpy waits for the card: t[2] is taken after it
        rows_list = NMS.detections_to_numpy(self.run_network(x))
        t.append(time.perf_counter())
        pred = []
        for rows, s0 in zip(rows_list, shape0):
            rows = rows[:, :6].astype(np.float64)
            if len(rows):
                LB.scale_coords(tuple(shape1), rows[:, :4], s0)
            pred.append(rows)
        t.append(time.perf_counter())
        names = (["face"] if self.spec.nc == 1
                 else [str(i) for i in range(self.spec.nc)])
        return Detections(loaded, pred, files, times=t, names=names,
                          shape=(n, *shape1, 3))

    __call__ = predict

    # ------------------------------------------------------------------
    # visualization / export helpers
    # (reference multi_scale_face_detector.py:290-688)
    # ------------------------------------------------------------------

    def save_detection_result(self, img, detections, output_path: str):
        """Draw final multi-scale detections on the image and save
        (multi_scale_face_detector.py:424-490)."""
        import cv2

        from face_detection_multi_scale_tpu_torch.utils.plotting import (
            draw_detection)

        img0 = self._load(img).copy()
        for det in np.asarray(detections):
            scale_idx = int(det[6]) if len(det) >= 7 else -1
            scale = (self.img_sizes[scale_idx]
                     if 0 <= scale_idx < len(self.img_sizes) else "?")
            draw_detection(img0, det[:4], det[4], 0,
                           f"{det[4]:.2f}@{scale}")
        cv2.imwrite(output_path, img0)
        return output_path

    def visualize_multi_scale_results(self, img, save_path: str):
        """Per-scale detection grid: one panel per pyramid scale plus the
        weighted-NMS merge (multi_scale_face_detector.py:290-422); saved
        with matplotlib's Agg backend. Returns (per-scale rows, merged
        rows)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        img0 = self._load(img)
        rgb = img0[:, :, ::-1]
        per_scale = []
        for size in self.img_sizes:
            det, _, _ = self.detect_single_scale(img0, size)
            per_scale.append(det)
        final, _ = self.detect_multi_scale(img0)

        n = len(self.img_sizes) + 1
        fig, axes = plt.subplots(1, n, figsize=(6 * n, 6))
        panels = list(zip([f"scale {s}" for s in self.img_sizes],
                          per_scale)) + [("weighted NMS merge", final)]
        for ax, (title, dets) in zip(np.atleast_1d(axes), panels):
            ax.imshow(rgb)
            for d in dets:
                x1, y1, x2, y2 = d[:4]
                ax.add_patch(plt.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                           fill=False, color="lime",
                                           linewidth=1.5))
            ax.set_title(f"{title}: {len(dets)} faces")
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(save_path, dpi=100)
        plt.close(fig)
        return per_scale, final

    def export_to_json(self, detections, img0_shape, path: str):
        """Single-image Triton-style JSON export
        (multi_scale_face_detector.py:574-616)."""
        import json

        from face_detection_multi_scale_tpu_torch.infer.production import (
            frames_to_json)

        dets = np.asarray(detections)
        frame = {
            "bboxes": [[float(v) for v in d[:4]] for d in dets],
            "confidence": [float(d[4]) for d in dets],
            "class_names": ["face"] * len(dets),
            "class_indexes": [int(d[5]) for d in dets],
            "class_groups": ["face"] * len(dets),
            "scale_used": [str(self.img_sizes[int(d[6])])
                           if 0 <= int(d[6]) < len(self.img_sizes)
                           else "unknown" for d in dets],
            "num_faces": len(dets),
            "infer_time": 0.0,
        }
        data = frames_to_json([frame], 0.0)
        with open(path, "w") as f:
            json.dump(data, f, indent=2)
        return path

    def compare_preprocessing_methods(self, img, img_size: Optional[int]
                                      = None):
        """Quantitative A/B of API vs standard preprocessing on one image
        (multi_scale_face_detector.py:618-688): runs both, returns
        detection counts, mean confidences and seconds."""
        size = img_size or self.img_sizes[0]
        img0 = self._load(img)
        saved = self.use_api_preprocess
        out = {}
        try:
            for mode, flag in (("api", True), ("standard", False)):
                self.use_api_preprocess = flag
                det, _, dt = self.detect_single_scale(img0, size)
                out[mode] = {
                    "count": int(len(det)),
                    "mean_conf": float(det[:, 4].mean()) if len(det)
                    else 0.0,
                    "seconds": dt,
                }
        finally:
            self.use_api_preprocess = saved
        return out

    def warmup(self, img_size: Optional[int] = None, batch: int = 1):
        """Run the engine once on zeros (first-call allocations, the
        kernel's build and load) before serving. A quantized detector
        must be calibrated first."""
        if self._quantize and self._qparams is None:
            # zeros would calibrate to degenerate scales and keep them
            raise RuntimeError(
                "calibrate_int8(frames) (or calib_images=) before "
                "warmup() on a quantize='int8' detector — warming up on "
                "the zero dummy would calibrate to degenerate scales")
        size = check_img_size(img_size or self.img_sizes[0], self.stride)
        self.run_network(np.zeros((batch, size, size, 3), np.uint8))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
