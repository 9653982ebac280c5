"""The port stands alone: no module of face_detection_multi_scale_tpu_torch,
no torch example (examples/*_torch.py and the code cells of
examples/demo_torch.ipynb) and not chip_smoke.py imports JAX, Flax or the
JAX package (an AST scan of every import statement), and its entry points
run on the card unless told otherwise."""

import ast
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "face_detection_multi_scale_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "face_detection_multi_scale_tpu")


def port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("*_torch.py")))


def notebook_cells(path):
    """The code cells' sources of a notebook."""
    nb = json.loads(path.read_text())
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def imported_modules(path, source=None):
    tree = ast.parse(path.read_text() if source is None else source,
                     filename=str(path))
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


def test_torch_notebook_imports_nothing_of_jax_or_the_jax_package():
    path = ROOT / "examples" / "demo_torch.ipynb"
    cells = notebook_cells(path)
    mods = [m for src in cells for m in imported_modules(path, src)]
    assert len(cells) > 5 and "face_detection_multi_scale_tpu_torch" in {
        m.split(".")[0] for m in mods}
    bad = [m for m in mods if m.split(".")[0] in FORBIDDEN]
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


# the port's CLIs that run no model: the WIDER scoring of written txts, a
# file diff, a relauncher (the runs it relaunches keep their --device),
# the blur and WIDER-annotation data tools and the WIDER downloader
HOST_ONLY_CLIS = {"evaluate_widerface.py", "compare_json_shapes.py",
                  "resume_runs.py", "blur_dataset.py",
                  "visualize_widerface.py", "download_widerface.py"}


@pytest.mark.parametrize("name", sorted(
    p.name for p in (PORT / "cli").glob("*.py") if p.name != "__init__.py"))
def test_every_cli_is_scanned_and_takes_the_card_by_default(name):
    """Each port CLI is among the scanned files, and each one that runs
    a model takes `--device` with the card as its default."""
    path = PORT / "cli" / name
    assert path in port_files()
    src = path.read_text()
    takes_device = 'add_argument("--device", default="cuda"' in src
    assert takes_device != (name in HOST_ONLY_CLIS), name


def test_new_modules_are_scanned():
    """The demo entry points' and the dataset tools' modules (streams,
    detect, serve, the two small CLIs, resume_runs) are scanned."""
    scanned = {str(p.relative_to(PORT)) for p in port_files()
               if PORT in p.parents}
    assert {"data/streams.py", "data/dataset.py", "cli/detect.py",
            "cli/serve.py", "cli/compare_json_shapes.py",
            "cli/compare_resize_methods.py", "cli/resume_runs.py"} <= scanned


def test_extra_blocks_and_data_tool_modules_are_scanned():
    """The extra blocks, the blur and WIDER-annotation tools with their
    CLIs, and the helpers of utils/ are scanned, and import with neither
    OpenCV nor PIL loaded (both are imported inside the functions that
    need them; the card's machine has no OpenCV)."""
    import subprocess
    import sys

    new = ("models/layers_extra.py", "data/blur.py",
           "data/widerface_annotations.py", "cli/blur_dataset.py",
           "cli/visualize_widerface.py", "utils/general.py",
           "utils/profiling.py")
    scanned = {str(p.relative_to(PORT)) for p in port_files()
               if PORT in p.parents}
    assert set(new) <= scanned
    mods = ", ".join("face_detection_multi_scale_tpu_torch." +
                     m[:-3].replace("/", ".") for m in new)
    code = (f"import importlib, sys\n"
            f"for m in '{mods}'.split(', '):\n"
            f"    importlib.import_module(m)\n"
            f"print(sorted(k for k in ('cv2', 'PIL') if k in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"


def test_export_modules_are_scanned():
    """The export slice's modules (the program and ONNX exports, the
    emitter, the runner and the bindings copied from the JAX package, the
    native app's bindings, the CLI) are scanned."""
    scanned = {str(p.relative_to(PORT)) for p in port_files()
               if PORT in p.parents}
    assert {"export_model.py", "onnx/__init__.py", "onnx/export.py",
            "onnx/runner.py", "onnx/onnx_pb2.py", "native/__init__.py",
            "cli/export.py"} <= scanned


def test_parallel_modules_are_scanned():
    """The data-parallel mesh's modules (parallel/) are scanned."""
    scanned = {str(p.relative_to(PORT)) for p in port_files()
               if PORT in p.parents}
    assert {"parallel/__init__.py", "parallel/mesh.py"} <= scanned


def test_cli_export_defaults_to_the_card(monkeypatch, tmp_path):
    """cli.export without --device asks for the card and raises where
    there is none, before it builds anything; it does not move to the
    CPU."""
    import torch

    from face_detection_multi_scale_tpu_torch.cli import export as CLI
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "m.pt2"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLI.main(["--model", "yolov7-lite-t", "--img-size", "64",
                  "--output", str(out)])
    assert not out.exists()


def test_downloads_and_examples_are_scanned():
    """The download helpers, the WIDER downloader and the torch examples
    are scanned, and the examples and the two modules import with neither
    OpenCV nor PIL loaded (the examples import cv2 only in `main`, to
    read and write image files; the card's machine has no OpenCV)."""
    import subprocess
    import sys

    scanned = set(port_files())
    examples = [ROOT / "examples" / f"{n}_torch.py" for n in
                ("demo", "detect_simple", "exported_inference")]
    assert {PORT / "utils" / "downloads.py",
            PORT / "cli" / "download_widerface.py", *examples} <= scanned
    code = ("import importlib, sys\n"
            "sys.path.insert(0, 'examples')\n"
            "for m in ('face_detection_multi_scale_tpu_torch.utils.downloads',"
            " 'face_detection_multi_scale_tpu_torch.cli.download_widerface',"
            " 'demo_torch', 'detect_simple_torch',"
            " 'exported_inference_torch'):\n"
            "    importlib.import_module(m)\n"
            "print(sorted(k for k in ('cv2', 'PIL') if k in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"
