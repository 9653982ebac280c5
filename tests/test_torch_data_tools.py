"""The port's dataset tools (data/dataset.py: create_folder,
flatten_recursive, autosplit, extract_boxes) and cli/resume_runs.py
against the JAX package's on the CPU.

The tools run on two copies of one tree of images and labels (nested
folders, one image without a label file): the same files with the same
bytes, the same split lists at one seed (`autosplit` draws from the
global `random`), and the same crops, pixel for pixel. The resume
scanner runs on one tree of fake runs: the same runs found, and the same
relaunch commands except for the training module (the port's `python -m
face_detection_multi_scale_tpu_torch.cli.train`) and the port's own
`--device`, taken from the run's opt.json."""

import json
import random
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from face_detection_multi_scale_tpu.data import dataset as JD
from face_detection_multi_scale_tpu_torch.cli import resume_runs as TRR
from face_detection_multi_scale_tpu_torch.data import dataset as TD

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import cli.resume_runs as JRR  # noqa: E402


@pytest.fixture()
def trees(tmp_path):
    """Two copies (`jax/set`, `port/set`) of a WIDER-style tree: 7 images in
    two event folders and a nested one, labels for all but one, 1-3
    faces each (class 0 or 1, boxes partly outside the frame)."""
    import cv2

    rng = np.random.default_rng(0)
    base = tmp_path / "base"
    for i in range(7):
        event = ("0--A", "1--B", "1--B/deep")[i % 3]
        img_dir = base / "images" / event
        img_dir.mkdir(parents=True, exist_ok=True)
        h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        cv2.imwrite(str(img_dir / f"im{i}.jpg"),
                    rng.integers(0, 256, (h, w, 3), np.uint8))
        if i == 5:
            continue
        lbl_dir = base / "labels" / event
        lbl_dir.mkdir(parents=True, exist_ok=True)
        rows = [[int(rng.integers(0, 2)), *rng.uniform(0.1, 0.95, 2),
                 *rng.uniform(0.1, 0.6, 2)]
                for _ in range(int(rng.integers(1, 4)))]
        (lbl_dir / f"im{i}.txt").write_text("".join(
            " ".join(f"{v:.6f}" if j else str(v) for j, v in enumerate(r))
            + "\n" for r in rows))
    out = {}
    for pkg in ("jax", "port"):
        # one stem for both: extract_boxes names crops after it
        out[pkg] = tmp_path / pkg / "set"
        shutil.copytree(base, out[pkg])
    return out


def files_of(root: Path):
    """{relative path: bytes} of every file under root."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_create_folder_and_flatten_recursive_match_jax(trees):
    for pkg, mod in (("jax", JD), ("port", TD)):
        stale = trees[pkg] / "out"
        stale.mkdir()
        (stale / "old.txt").write_text("x")
        mod.create_folder(str(stale))
        assert stale.is_dir() and not any(stale.iterdir())
        flat = mod.flatten_recursive(trees[pkg] / "images")
        assert flat == Path(str(trees[pkg] / "images") + "_flat")
    got = files_of(trees["port"] / "images_flat")
    assert got == files_of(trees["jax"] / "images_flat") and len(got) == 7


@pytest.mark.parametrize("annotated_only", [False, True])
def test_autosplit_matches_jax(trees, annotated_only):
    """One seed, the same three lists (paths relative to each copy)."""
    lists = {}
    for pkg, mod in (("jax", JD), ("port", TD)):
        images = trees[pkg] / "images"
        random.seed(3)
        mod.autosplit(images, weights=(0.5, 0.3, 0.2),
                      annotated_only=annotated_only)
        lists[pkg] = {name: [str(Path(l).relative_to(trees[pkg]))
                             for l in (images / name).read_text().split()]
                      for name in ("autosplit_train.txt",
                                   "autosplit_val.txt",
                                   "autosplit_test.txt")
                      if (images / name).exists()}
    assert lists["port"] == lists["jax"]
    assert sum(map(len, lists["port"].values())) == 6 + (not annotated_only)
    # a second call replaces the lists
    random.seed(3)
    TD.autosplit(trees["port"] / "images", weights=(0.5, 0.3, 0.2),
                 annotated_only=annotated_only)
    assert sum(len((trees["port"] / "images" / n).read_text().split())
               for n in lists["port"]) == sum(map(len,
                                                  lists["port"].values()))


def test_extract_boxes_matches_jax(trees):
    """The same crops under classifier/<cls>/, pixel for pixel; a second
    call replaces them."""
    import cv2

    for pkg, mod in (("jax", JD), ("port", TD)):
        mod.extract_boxes(trees[pkg])
    crops = {}
    for pkg in ("jax", "port"):
        root = trees[pkg] / "classifier"
        crops[pkg] = {str(p.relative_to(root)): cv2.imread(str(p))
                      for p in sorted(root.rglob("*.jpg"))}
    assert crops["port"].keys() == crops["jax"].keys()
    assert len(crops["port"]) >= 6
    for name, crop in crops["port"].items():
        assert np.array_equal(crop, crops["jax"][name]), name
    TD.extract_boxes(trees["port"])
    assert len(list((trees["port"] / "classifier").rglob("*.jpg"))) == \
        len(crops["port"])


def make_run(root: Path, name, done_epoch, want_epochs, opt=True, **extra):
    w = root / name / "weights"
    w.mkdir(parents=True)
    (w / "last.meta.json").write_text(json.dumps({"epoch": done_epoch}))
    if opt:
        (root / name / "opt.json").write_text(json.dumps(dict({
            "epochs": want_epochs, "model": "yolov7-lite-t",
            "data": "d.yaml", "hyp": "scratch.p6", "batch_size": 8,
            "img_size": 128, "kpt_label": 5}, **extra)))


def test_resume_runs_match_jax(tmp_path, capsys):
    """The same interrupted runs, and the same commands but for the
    module and the port's --device."""
    make_run(tmp_path, "done", 9, 10)
    make_run(tmp_path, "mid", 3, 10, device="cpu")
    make_run(tmp_path / "nested", "gpu", 0, 5, device="cuda",
             dtype="bfloat16")
    make_run(tmp_path, "noopt", 0, 10, opt=False)
    key = lambda r: r[0]
    got = sorted(TRR.find_interrupted(str(tmp_path)), key=key)
    want = sorted(JRR.find_interrupted(str(tmp_path)), key=key)
    assert got == want
    assert [(Path(r).name, d, w) for r, d, w, _ in got] == [
        ("mid", 4, 10), ("gpu", 1, 5)]

    def commands(main):
        assert main(["--root", str(tmp_path), "--dry-run"]) == 0
        lines = capsys.readouterr().out.splitlines()
        return dict(zip(lines[0::2], (l.split() for l in lines[1::2])))

    port, jax_ = commands(TRR.main), commands(JRR.main)
    assert port.keys() == jax_.keys() and len(port) == 2
    for head, cmd in port.items():
        theirs = jax_[head]
        assert cmd[:3] == [sys.executable, "-m",
                           "face_detection_multi_scale_tpu_torch.cli.train"]
        assert theirs[1].endswith("cli/train.py")
        device = "cpu" if "mid" in head else "cuda"
        assert cmd[3:] == theirs[2:] + ["--device", device]
    assert TRR.main(["--root", str(tmp_path / "none")]) == 0
    assert "no interrupted runs" in capsys.readouterr().out
