"""The port's host data tools and helpers against the JAX package's on the
CPU: data/blur.py with cli/blur_dataset.py, data/widerface_annotations.py
with cli/visualize_widerface.py, the rest of utils/general.py and of
utils/profiling.py.

The blur kernels are held bit for bit; the generators and the CLIs run on
two copies of one seeded synthetic WIDER tree and must write the same
files with the same bytes (images, labels, metadata.json, the `show`
png); `check_dataset` must never run a download recipe. model_info's
GFLOPs are the one stated tolerance: the port counts every multiply-add
of every conv and matmul, the padded taps included
(torch.utils.flop_counter, the reference thop's convention), where XLA's
cost analysis (the JAX package's) counts only the taps inside the image
and adds the elementwise ops; on yolov7-tiny-face narrowed to width 0.25
at 128 px JAX / port is 0.925 (0.957 on the full tiny at 640 px, 0.815 on
w6 at 640 px, whose stride-32 and stride-64 maps are small), and the test
holds it within [0.9, 1]."""

import contextlib
import functools
import io
import json
import os
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.data import blur as JB
from face_detection_multi_scale_tpu.data import widerface_annotations as JA
from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.utils import general as JG
from face_detection_multi_scale_tpu.utils import profiling as JP
from face_detection_multi_scale_tpu_torch.cli import blur_dataset as TBC
from face_detection_multi_scale_tpu_torch.cli import (
    visualize_widerface as TVC)
from face_detection_multi_scale_tpu_torch.data import blur as TB
from face_detection_multi_scale_tpu_torch.data import (
    widerface_annotations as TA)
from face_detection_multi_scale_tpu_torch.models import model as TM
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.ops.nms import Detections
from face_detection_multi_scale_tpu_torch.train import checkpoint as TCK
from face_detection_multi_scale_tpu_torch.train import trainer as TR
from face_detection_multi_scale_tpu_torch.utils import general as TG
from face_detection_multi_scale_tpu_torch.utils import profiling as TP

from test_torch_model import narrowed

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import cli.blur_dataset as JBC  # noqa: E402
import cli.visualize_widerface as JVC  # noqa: E402

GFLOPS_RATIO = (0.9, 1.0)  # JAX (XLA) / port GFLOPs, see the docstring
CATEGORIES = ("22--Picnic", "12--Group", "3--Riot", "61--Street_Battle")


def tree_bytes(root: Path):
    """{relative path: bytes} of every file under root."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# ---------------------------------------------------------------------------
# blur
# ---------------------------------------------------------------------------

def _image(seed, h=120, w=160):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("level,idx", [(lvl, i) for lvl in
                                       ("light", "medium", "heavy")
                                       for i in range(3)])
def test_apply_blur_matches_jax_bit_for_bit(level, idx):
    cfg = TB.BLUR_LEVELS[level][idx]
    img = _image(idx)
    got = TB.apply_blur(img.copy(), cfg["type"], cfg["strength"])
    want = JB.apply_blur(img.copy(), cfg["type"], cfg["strength"])
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_blur_tables_and_fallback_match_jax():
    assert TB.BLUR_LEVELS == JB.BLUR_LEVELS
    assert (TB.EASY_CATEGORIES, TB.MEDIUM_CATEGORIES, TB.HARD_CATEGORIES) \
        == (JB.EASY_CATEGORIES, JB.MEDIUM_CATEGORIES, JB.HARD_CATEGORIES)
    img = _image(9)
    np.testing.assert_array_equal(TB.apply_blur(img.copy(), "unknown", 5),
                                  JB.apply_blur(img.copy(), "unknown", 5))
    rows = np.array([[0, .5, .5, .4, .5], [0, .5, .5, .1, .1]])
    assert TB.has_quality_faces(rows, 160, 120) == \
        JB.has_quality_faces(rows, 160, 120) == 1
    assert TB.has_quality_faces(np.zeros((0, 5)), 10, 10) == 0


@pytest.fixture()
def wider(tmp_path):
    """A seeded WIDER-style tree (train: images/ + labels/ in four event
    folders, 3 images each, one without labels and one with small faces
    only; val: two events), the same for both packages."""
    import cv2

    rng = np.random.default_rng(0)
    root = tmp_path / "wider"
    for split, cats in (("train", CATEGORIES), ("val", CATEGORIES[:2])):
        for cat in cats:
            for i in range(3):
                img_dir = root / split / "images" / cat
                lbl_dir = root / split / "labels" / cat
                img_dir.mkdir(parents=True, exist_ok=True)
                lbl_dir.mkdir(parents=True, exist_ok=True)
                h, w = int(rng.integers(90, 140)), int(rng.integers(110, 170))
                cv2.imwrite(str(img_dir / f"{cat}_{i}.jpg"),
                            rng.integers(0, 256, (h, w, 3), np.uint8))
                if i == 2 and cat == CATEGORIES[0]:
                    continue  # no label file
                size = 0.05 if (i == 1 and cat == CATEGORIES[1]) else 0.4
                rows = [[0, *rng.uniform(0.3, 0.7, 2), size, size]
                        for _ in range(int(rng.integers(1, 3)))]
                (lbl_dir / f"{cat}_{i}.txt").write_text("".join(
                    " ".join(f"{v:.6f}" if j else str(v)
                             for j, v in enumerate(r)) + "\n"
                    for r in rows))
    return root


def test_blur_generator_matches_jax(wider, tmp_path):
    """create_blur_dataset and create_blur_val at one seed: the same
    stats, the same files with the same bytes (metadata.json included)."""
    out = {}
    for name, mod in (("jax", JB), ("port", TB)):
        gen = mod.BlurDatasetGenerator(str(wider / "train"), seed=3)
        stats = gen.create_blur_dataset(10, str(tmp_path / name))
        n_val = gen.create_blur_val(str(wider / "val"), str(tmp_path / name),
                                    "heavy")
        out[name] = (stats, n_val, tree_bytes(tmp_path / name))
    assert out["port"] == out["jax"]
    stats, n_val, files = out["port"]
    assert stats["total"] == 6 and n_val == 5
    assert "metadata.json" in files


def test_blur_cli_matches_jax(wider, tmp_path):
    for name, mod in (("jax", JBC), ("port", TBC)):
        assert mod.main(["--wider-path", str(wider / "train"),
                         "--output-dir", str(tmp_path / name),
                         "--total-images", "7", "--val-path",
                         str(wider / "val"), "--val-blur-level", "light",
                         "--seed", "5"]) == 0
    assert tree_bytes(tmp_path / "port") == tree_bytes(tmp_path / "jax")
    meta = json.loads((tmp_path / "port" / "metadata.json").read_text())
    assert len(meta) == 5 and {m["difficulty"] for m in meta} == {
        "easy", "medium", "hard"}


# ---------------------------------------------------------------------------
# WIDER annotations
# ---------------------------------------------------------------------------

@pytest.fixture()
def annotations(tmp_path):
    """A wider_face_*_bbx_gt.txt of four images (one empty, one with a
    short row and an invalid face) and the images it names."""
    import cv2

    text = ("0--Parade/0_a.jpg\n3\n"
            "10 20 30 40 1 0 0 0 2 0\n"
            "50 60 15 18 0 0 1 1 0 0\n"
            "100 5 200 150 2 1 0 0 1 1\n"
            "0--Parade/0_b.jpg\n0\n0 0 0 0 0 0 0 0 0 0\n"
            "1--Handshaking/1_c.jpg\n2\n"
            "3 4 5 6 0 0 0 0 0 0\n"
            "7 8\n"
            "9--Press/9_d.jpg\n1\n"
            "0 0 0 12 1 0 0 0 0 0\n")
    annot = tmp_path / "wider_face_val_bbx_gt.txt"
    annot.write_text(text)
    images = tmp_path / "images"
    rng = np.random.default_rng(1)
    for rel in ("0--Parade/0_a.jpg", "0--Parade/0_b.jpg",
                "1--Handshaking/1_c.jpg"):
        (images / rel).parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(images / rel),
                    rng.integers(0, 256, (180, 320, 3), np.uint8))
    return annot, images


def test_annotation_functions_match_jax(annotations, tmp_path):
    annot, images = annotations
    got, want = TA.load_annotations(str(annot)), JA.load_annotations(
        str(annot))
    assert got == want and len(got) == 4
    assert TA.dataset_statistics(got) == JA.dataset_statistics(want)
    for w, h in ((10, 10), (32, 32), (33, 40), (128, 128), (129, 200)):
        assert TA.size_bucket(w, h) == JA.size_bucket(w, h)
    for skip in (False, True):
        n = {name: mod.annotations_to_labels(
            got, str(images), str(tmp_path / f"{name}{skip}"),
            skip_invalid=skip) for name, mod in (("jax", JA), ("port", TA))}
        assert n["port"] == n["jax"] == 3
        assert tree_bytes(tmp_path / f"port{skip}") == \
            tree_bytes(tmp_path / f"jax{skip}")


def test_visualize_cli_matches_jax(annotations, tmp_path):
    """stats prints the same JSON; show writes the same png; to-labels the
    same label files."""
    annot, images = annotations
    for command, extra in (
            ("stats", []),
            ("show", ["--images", str(images), "--image",
                      "0--Parade/0_a.jpg"]),
            ("to-labels", ["--images", str(images), "--skip-invalid"])):
        printed, files = {}, {}
        for name, mod in (("jax", JVC), ("port", TVC)):
            out = tmp_path / f"{command}-{name}"
            args = [command, "--annot", str(annot)] + extra
            if command == "show":
                out.mkdir()
                args += ["--out", str(out / "view.png")]
            elif command == "to-labels":
                args += ["--out", str(out)]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert mod.main(args) == 0
            printed[name] = buf.getvalue().replace(str(out), "OUT")
            files[name] = tree_bytes(out) if out.exists() else {}
        assert printed["port"] == printed["jax"], command
        assert files["port"] == files["jax"], command
        if command != "stats":
            assert files["port"], command


# ---------------------------------------------------------------------------
# utils/general.py
# ---------------------------------------------------------------------------

def test_check_file_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "a" / "b").mkdir(parents=True)
    (tmp_path / "a" / "b" / "data.yaml").write_text("x")
    (tmp_path / "one.txt").write_text("x")
    for f in ("", "one.txt", "data.yaml"):
        assert TG.check_file(f) == JG.check_file(f)
    (tmp_path / "a" / "data.yaml").write_text("x")
    # the JAX package asserts; the port raises what a caller can catch
    for mod, several, missing in ((JG, AssertionError, AssertionError),
                                  (TG, ValueError, FileNotFoundError)):
        with pytest.raises(several, match="Multiple files"):
            mod.check_file("data.yaml")
        with pytest.raises(missing, match="File Not Found"):
            mod.check_file("missing.yaml")


def test_check_dataset_never_fetches(tmp_path, monkeypatch):
    """Present paths pass in both; missing ones without a recipe (or with
    autodownload off) raise in both; with a recipe the port raises naming
    the missing path and the recipe, and runs nothing (the recipe here
    would write a file)."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "val").mkdir()
    for mod in (JG, TG):
        assert mod.check_dataset({"val": str(tmp_path / "val")}) is None
        assert mod.check_dataset({"train": "x"}) is None
        with pytest.raises(FileNotFoundError, match="Dataset not found"):
            mod.check_dataset({"val": ["nowhere"]})
        with pytest.raises(FileNotFoundError, match="Dataset not found"):
            mod.check_dataset({"val": "nowhere", "download": "x = 1"},
                              autodownload=False)
    recipe = "open('fetched.txt', 'w').write('ran')"
    with pytest.raises(FileNotFoundError) as err:
        TG.check_dataset({"val": "nowhere", "download": recipe})
    assert recipe in str(err.value) and "nowhere" in str(err.value)
    assert not (tmp_path / "fetched.txt").exists()


def test_get_latest_run(tmp_path):
    """On a tree of reference `last*.pt` files both packages pick the
    newest; on the port's own checkpoints (`<tag>.pt` + `.meta.json`)
    the port picks the newest run's `last.pt`, what a resume loads."""
    assert TG.get_latest_run(str(tmp_path)) == JG.get_latest_run(
        str(tmp_path)) == ""
    for run in ("exp", "exp2"):
        d = tmp_path / "ref" / run / "weights"
        d.mkdir(parents=True)
        (d / "last.pt").write_bytes(b"x")
        time.sleep(0.02)
    got = TG.get_latest_run(str(tmp_path / "ref"))
    assert got == JG.get_latest_run(str(tmp_path / "ref"))
    assert got.endswith(os.path.join("exp2", "weights", "last.pt"))
    net = TM.YoloFace(narrowed(TZ, "yolov7-lite-t", 0.25))
    for run in ("a", "b"):
        weights = tmp_path / "port" / run / "weights"
        weights.mkdir(parents=True)
        TCK.save_checkpoint(str(weights), "last",
                            TR.create_train_state(net, "sgd"), {"epoch": 0})
        time.sleep(0.02)
    got = TG.get_latest_run(str(tmp_path / "port"))
    assert got.endswith(os.path.join("b", "weights", "last.pt"))


def test_small_helpers_match_jax(tmp_path):
    s = "rtsp://user@cam:554/stream?x=1&y=2;z"
    assert TG.clean_str(s) == JG.clean_str(s)
    f = tmp_path / "blob"
    f.write_bytes(b"0" * 2_500_000)
    assert TG.file_size(f) == JG.file_size(f) == 2.5
    assert TG.emojis("ok ✅") == JG.emojis("ok ✅")
    assert TG.coco80_to_coco91_class() == JG.coco80_to_coco91_class()
    for args in (("hello",), ("red", "bold", "x"),
                 ("bright_cyan", "underline", "y")):
        assert TG.colorstr(*args) == JG.colorstr(*args)
    boxes = np.random.default_rng(2).uniform(-50, 700, (6, 4))
    for step in (2, 3):
        b = np.random.default_rng(3).uniform(-50, 700, (5, 9))
        np.testing.assert_array_equal(TG.clip_coords(b.copy(), (480, 640),
                                                     step),
                                      JG.clip_coords(b.copy(), (480, 640),
                                                     step))
    np.testing.assert_array_equal(TG.clip_coords(boxes.copy(), (480, 640)),
                                  JG.clip_coords(boxes.copy(), (480, 640)))


def test_segment_helpers_match_jax():
    rng = np.random.default_rng(4)
    segs = [rng.uniform(-0.1, 1.1, (int(rng.integers(3, 9)), 2))
            for _ in range(5)]
    for s in segs:
        np.testing.assert_array_equal(TG.xyn2xy(s, 320, 240, 3, 4),
                                      JG.xyn2xy(s, 320, 240, 3, 4))
        px = s * 640
        np.testing.assert_array_equal(TG.segment2box(px),
                                      JG.segment2box(px))
    outside = np.array([[-5.0, -5.0], [-1.0, -2.0]])
    np.testing.assert_array_equal(TG.segment2box(outside),
                                  JG.segment2box(outside))
    np.testing.assert_array_equal(TG.segments2boxes(segs),
                                  JG.segments2boxes(segs))
    got = TG.resample_segments([s.copy() for s in segs], 50)
    want = JG.resample_segments([s.copy() for s in segs], 50)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_apply_classifier_matches_jax():
    """Two images' detections in network-input space, one image without
    any: the crops reach one numpy classify_fn batch, and the kept rows
    are the JAX ones."""
    rng = np.random.default_rng(5)
    im0s = [rng.integers(0, 256, (300, 400, 3), np.uint8) for _ in range(3)]
    dets = []
    for n in (4, 0, 3):
        xy = rng.uniform(10, 300, (n, 2))
        wh = rng.uniform(10, 90, (n, 2))
        dets.append(np.concatenate([xy, xy + wh, rng.uniform(0, 1, (n, 1)),
                                    rng.integers(0, 2, (n, 1))], 1))
    seen = {}

    def classify(batch, tag):
        seen[tag] = batch.shape
        assert batch.dtype == np.float32 and batch.max() <= 1.0
        return (batch.mean(axis=(1, 2, 3)) > 0.5).astype(int)

    got = TG.apply_classifier(dets, functools.partial(classify, tag="port"),
                              (384, 512), im0s)
    want = JG.apply_classifier(dets, functools.partial(classify, tag="jax"),
                               (384, 512), im0s)
    assert seen["port"] == seen["jax"] == (7, 224, 224, 3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert TG.apply_classifier([np.zeros((0, 6))], None, (64, 64),
                               im0s[0])[0].shape == (0, 6)


# ---------------------------------------------------------------------------
# utils/profiling.py
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def tiny_pair():
    spec_j = narrowed(JZ, "yolov7-tiny-face", 0.25)
    variables = jax.eval_shape(
        functools.partial(JM.YoloFace(spec=spec_j).init, train=False),
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                             variables)
    return spec_j, variables, TM.YoloFace(narrowed(TZ, "yolov7-tiny-face",
                                                   0.25))


def test_param_count_and_model_info_match_jax():
    """The same parameter count and model_info keys and values, the
    GFLOPs within GFLOPS_RATIO (the docstring says why they differ)."""
    spec_j, variables, net = tiny_pair()
    assert TP.param_count(net) == JP.param_count(variables) > 0
    want = JP.model_info(JM.YoloFace(spec=spec_j), variables, img_size=128,
                         verbose=False)
    got = TP.model_info(net, img_size=128, verbose=False)
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k != "gflops"} == \
        {k: v for k, v in want.items() if k != "gflops"}
    ratio = want["gflops"] / got["gflops"]
    assert GFLOPS_RATIO[0] <= ratio <= GFLOPS_RATIO[1], ratio


def test_cost_analysis_counts_multiply_adds():
    """2 FLOPs a multiply-add, the padded taps included: a 3x3 conv of 8
    to 16 channels on 10 x 12 (pad 1) and a (5, 7) @ (7, 3) matmul."""
    conv = torch.nn.Conv2d(8, 16, 3, padding=1, bias=False)
    x = torch.zeros(2, 8, 10, 12)
    assert TP.cost_analysis(conv, x)["flops"] == 2 * 2 * 16 * 10 * 12 * 8 * 9
    a, b = torch.zeros(5, 7), torch.zeros(7, 3)
    assert TP.cost_analysis(torch.matmul, a, b)["flops"] == 2 * 5 * 7 * 3


def test_time_synchronized_and_trace(tmp_path):
    """time_synchronized takes nothing, a tensor or a nest of them (a
    Detections) and returns the host clock; trace yields the profiler and
    writes a Chrome trace whose events include the traced ops."""
    t0 = TP.time_synchronized()
    dets = Detections(*(torch.zeros(1, 2) for _ in range(6)))
    assert len(dets) == 6
    t1 = TP.time_synchronized(dets)
    t2 = TP.time_synchronized([torch.ones(3), {"a": torch.zeros(1)}])
    assert t0 <= t1 <= t2 <= time.perf_counter()
    assert isinstance(JP.time_synchronized(), float)
    with TP.trace(str(tmp_path / "tr")) as prof:
        torch.nn.functional.conv2d(torch.ones(1, 3, 16, 16),
                                   torch.ones(4, 3, 3, 3))
    path = tmp_path / "tr" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
    assert any("conv" in e.key for e in prof.key_averages())


def test_device_busy_ms_merges_overlapping_events():
    """device_busy_ms is the union of the device events' intervals (us in,
    ms out); host events do not count."""
    from types import SimpleNamespace as NS

    def ev(lo, hi, device=True):
        return NS(time_range=NS(start=lo, end=hi),
                  device_type=(torch.autograd.DeviceType.CUDA if device
                               else torch.autograd.DeviceType.CPU))

    prof = NS(events=lambda: [ev(0, 1000), ev(500, 1500), ev(3000, 3500),
                              ev(3100, 3200), ev(0, 9000, device=False)])
    assert TP.device_busy_ms(prof) == 2.0
    assert TP.device_busy_ms(NS(events=lambda: [])) == 0.0
