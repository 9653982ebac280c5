"""ctypes bindings for the native C++ host IoU (csrc/postprocess.cpp):
pairwise IoU with the +1 pixel convention, the WIDER FACE evaluation's.

The port's counterpart of the JAX package's native/__init__.py, for the
one entry the port's evaluation calls. This is host code, not a device
kernel. The source is built on demand with g++ (the JAX loader's flags)
into the package's gitignored `_build/`, named by a hash of the source,
and opened once per process. Where there is no compiler, `available()` is
false and eval/widerface.py takes its numpy IoU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG / "csrc" / "postprocess.cpp"
BUILD_DIR = _PKG / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    """The shared library's path for the current source and flags."""
    tag = hashlib.sha256(SRC.read_bytes()
                         + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfdms_postprocess_{tag}.so"


def _build(so: Path) -> bool:
    """g++ into a file of this process, then an atomic rename, so that
    processes building at once never open a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except Exception:
        return False
    os.replace(tmp, so)
    return True


def load() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library, or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = library_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.bbox_overlaps_plus1.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double)]
    _LIB = lib
    return _LIB


def available() -> bool:
    return load() is not None


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def bbox_overlaps_plus1(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Native +1-convention IoU of (n, 4) xyxy `boxes` against (k, 4)
    `query` -> (n, k) float64; raises where the library does not build."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    b = np.ascontiguousarray(boxes, np.float64)
    q = np.ascontiguousarray(query, np.float64)
    out = np.empty((len(b), len(q)), np.float64)
    lib.bbox_overlaps_plus1(_ptr(b, ctypes.c_double), len(b),
                            _ptr(q, ctypes.c_double), len(q),
                            _ptr(out, ctypes.c_double))
    return out
