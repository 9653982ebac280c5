"""ctypes bindings for the native C++ host postprocess (csrc/postprocess.cpp)
and the standalone native detector app (csrc/fdms_detect.cpp).

The port's counterpart of the JAX package's native/__init__.py: pairwise
IoU with the +1 pixel convention (the WIDER FACE evaluation's), greedy
NMS, the grid decode of one level and the letterbox inverse, and the app
that decodes and suppresses a raw-heads dump (`dump_raw_heads`, the
format of a raw-heads export) in C++ alone. This is host code, not a
device kernel. The sources are built on demand with g++ (the JAX
loader's flags) into the package's gitignored `_build/`, each named by a
hash of its sources and flags, and the library is opened once per
process. Where there is no compiler, `available()` is false, every
binding raises, and `build_app` raises: eval/widerface.py alone takes its
numpy IoU then.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG / "csrc" / "postprocess.cpp"
APP_SRC = _PKG / "csrc" / "fdms_detect.cpp"
BUILD_DIR = _PKG / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
APP_FLAGS = ("-O3", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _tagged(stem: str, sources, flags) -> Path:
    """`_build/<stem>_<hash of the sources and flags>`."""
    h = hashlib.sha256()
    for src in sources:
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}"


def library_path() -> Path:
    """The shared library's path for the current source and flags."""
    p = _tagged("libfdms_postprocess", (SRC,), FLAGS)
    return p.with_name(p.name + ".so")


def app_path() -> Path:
    """The detector app's path for the current sources and flags."""
    return _tagged("fdms_detect", (APP_SRC, SRC), APP_FLAGS)


def _gxx(args, out: Path, timeout: int) -> None:
    """g++ into a file of this process, then an atomic rename, so that
    processes building at once never run a half-written file. Raises
    where the compiler is missing or fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *args, "-o", str(tmp)], check=True,
                   capture_output=True, timeout=timeout)
    os.replace(tmp, out)


def load() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library, or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = library_path()
    if not so.exists():
        try:
            _gxx([*FLAGS, str(SRC)], so, 120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.bbox_overlaps_plus1.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double)]
    lib.greedy_nms.restype = ctypes.c_int64
    lib.greedy_nms.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_float, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.decode_level.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_float,
        ctypes.POINTER(ctypes.c_float)]
    lib.scale_coords_inverse.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double]
    _LIB = lib
    return _LIB


def available() -> bool:
    return load() is not None


def _lib() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def bbox_overlaps_plus1(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Native +1-convention IoU of (n, 4) xyxy `boxes` against (k, 4)
    `query` -> (n, k) float64; raises where the library does not build."""
    lib = _lib()
    b = np.ascontiguousarray(boxes, np.float64)
    q = np.ascontiguousarray(query, np.float64)
    out = np.empty((len(b), len(q)), np.float64)
    lib.bbox_overlaps_plus1(_ptr(b, ctypes.c_double), len(b),
                            _ptr(q, ctypes.c_double), len(q),
                            _ptr(out, ctypes.c_double))
    return out


def greedy_nms(boxes: np.ndarray, scores: np.ndarray, iou_thres: float,
               max_det: Optional[int] = None) -> np.ndarray:
    """Native greedy NMS returning kept indices (descending score)."""
    lib = _lib()
    n = len(boxes)
    max_det = max_det or n
    b = np.ascontiguousarray(boxes, np.float32)
    s = np.ascontiguousarray(scores, np.float32)
    keep = np.empty(max_det, np.int32)
    kept = lib.greedy_nms(_ptr(b, ctypes.c_float), _ptr(s, ctypes.c_float),
                          n, iou_thres, max_det,
                          _ptr(keep, ctypes.c_int32))
    return keep[:kept].copy()


def decode_level(raw: np.ndarray, anchors: np.ndarray, stride: float,
                 nc: int, nkpt: int) -> np.ndarray:
    """Native decode of one (na, ny, nx, no) raw map -> (na*ny*nx, no)."""
    lib = _lib()
    na, ny, nx, no = raw.shape
    r = np.ascontiguousarray(raw, np.float32)
    a = np.ascontiguousarray(anchors, np.float32)
    out = np.empty((na * ny * nx, no), np.float32)
    lib.decode_level(_ptr(r, ctypes.c_float), na, ny, nx, no, nc, nkpt,
                     _ptr(a, ctypes.c_float), stride,
                     _ptr(out, ctypes.c_float))
    return out


def scale_coords_inverse(coords: np.ndarray, in_shape, out_shape
                         ) -> np.ndarray:
    """Native letterbox inverse: (n, 4) xyxy coords from the padded
    `in_shape` (h, w) frame back to `out_shape`, clipped to it."""
    lib = _lib()
    c = np.ascontiguousarray(coords, np.float64)
    lib.scale_coords_inverse(_ptr(c, ctypes.c_double), len(c),
                             float(in_shape[0]), float(in_shape[1]),
                             float(out_shape[0]), float(out_shape[1]))
    return c


def build_app() -> str:
    """Build the standalone native detector (csrc/fdms_detect.cpp with
    csrc/postprocess.cpp) once per sources and flags; returns its path.
    Raises where g++ is missing or fails."""
    app = app_path()
    if not app.exists():
        _gxx([*APP_FLAGS, str(APP_SRC), str(SRC)], app, 180)
    return str(app)


def _host(raw) -> np.ndarray:
    """A raw map (a torch tensor on any device, or an array) as float32
    numpy."""
    if hasattr(raw, "detach"):
        raw = raw.detach().float().cpu().numpy()
    return np.asarray(raw, np.float32)


def dump_raw_heads(path: str, raws, spec) -> str:
    """Write per-level raw head maps (torch tensors or numpy arrays) in the
    fdms_detect binary format: header (n_levels, nc, nkpt int64) then per
    level (na, ny, nx, no int64; stride f32; anchors f32; raw map f32)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<3q", len(raws), spec.nc, spec.nkpt))
        for lvl, raw in enumerate(raws):
            raw = _host(raw)
            if raw.ndim == 5:  # (1, na, ny, nx, no)
                raw = raw[0]
            na, ny, nx, no = raw.shape
            f.write(struct.pack("<4q", na, ny, nx, no))
            f.write(struct.pack("<f", float(spec.strides[lvl])))
            anchors = np.asarray(spec.anchors[lvl],
                                 np.float32).reshape(-1, 2)
            f.write(anchors.tobytes())
            f.write(np.ascontiguousarray(raw).tobytes())
    return path


def run_native_detector(raw_path: str, conf_thres: float = 0.25,
                        iou_thres: float = 0.45,
                        max_det: int = 300) -> np.ndarray:
    """Run the native app on a raw-heads dump; returns (n, 5) rows
    [x1, y1, x2, y2, conf] in input-frame pixels."""
    out = subprocess.run(
        [build_app(), raw_path, str(conf_thres), str(iou_thres),
         str(max_det)],
        check=True, capture_output=True, text=True, timeout=120)
    rows = [[float(v) for v in line.split()]
            for line in out.stdout.strip().splitlines() if line]
    return np.array(rows, np.float64).reshape(-1, 5)
