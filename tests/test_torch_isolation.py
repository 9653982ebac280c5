"""The port stands alone: no module of face_detection_multi_scale_tpu_torch
and not chip_smoke.py imports JAX, Flax or the JAX package (an AST scan of
every import statement), and its entry points run on the card unless told
otherwise."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "face_detection_multi_scale_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "face_detection_multi_scale_tpu")


def port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: stays inside the port package
                yield "face_detection_multi_scale_tpu_torch"
            else:
                yield node.module
            if node.module in (None, "face_detection_multi_scale_tpu"):
                yield from (f"{node.module}.{a.name}" for a in node.names)


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = port_files()
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
    bad = []
    for path in files:
        for mod in imported_modules(path):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_scan_catches_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("def f():\n    from face_detection_multi_scale_tpu.ops "
                 "import nms\n    import jax.numpy\n")
    mods = list(imported_modules(p))
    assert "face_detection_multi_scale_tpu.ops" in mods
    assert "jax.numpy" in mods


def test_detector_defaults_to_the_card(monkeypatch):
    """With no card, FaceDetector() without device= raises instead of
    running on the CPU."""
    import torch

    from face_detection_multi_scale_tpu_torch.infer.detector import (
        FaceDetector)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaceDetector("yolov7-tiny-face")
