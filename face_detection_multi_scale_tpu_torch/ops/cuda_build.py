"""nvcc build of the port's CUDA sources.

Every kernel of the port is CUDA C++ for sm_90a with a plain C interface:
`build` compiles one source into a shared library under `BUILD_DIR`
(gitignored), named by a hash of the source and the flags, so a changed
source or flag set builds anew and an unchanged one is reused; the kernel
modules open it with ctypes, once per process. Nothing here runs at
import: the CPU paths of the kernel modules never call it.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# the flags every source shares; a kernel module adds its own
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")


def build(source: Path, flags: Tuple[str, ...]) -> Path:
    """Compile `source` with nvcc and `flags` (once per source and flags)
    and return the shared library's path."""
    from torch.utils.cpp_extension import CUDA_HOME

    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    if lib.exists():
        return lib
    if CUDA_HOME is None:
        raise RuntimeError(f"nvcc not found: set CUDA_HOME to the CUDA "
                           f"toolkit to build {source.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [str(Path(CUDA_HOME) / "bin" / "nvcc"), *flags, "-o", str(tmp),
           str(source)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({done.returncode}):\n{done.stderr}")
    os.replace(tmp, lib)
    return lib


def variant_source(source: Path, variant: str, tag: str) -> Path:
    """The source of an A/B `variant` of `source`: "base" is `source` as it
    stands; OLD=>NEW is `source` with every occurrence of the text OLD (at
    least one) replaced by NEW, written into BUILD_DIR as `tag`.cu."""
    if variant == "base":
        return source
    old, new = variant.split("=>", 1)
    text = source.read_text()
    if old not in text:
        raise SystemExit(f"{source.name} has no {old!r}")
    path = BUILD_DIR / f"{tag}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text.replace(old, new))
    return path
