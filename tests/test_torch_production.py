"""The port's production pipeline (infer/production.py) and its two
corpus CLIs (cli/test_widerface.py, cli/batch_predict.py) against the JAX
package's, on the CPU.

- `get_image_paths_from_base`, `frames_to_json`, `read_existing_json`,
  `compare_json_shapes`, `check_progress`, `detections_to_dataframe`,
  `analyze_results` and `generate_report` on the same inputs — exact;
  `run` shards items by `torch.distributed` rank when it is initialized.
- The CLIs run yolov7-lite-t at full width on one weights file, the JAX
  package's inference `.npz` (`save_inference_weights` of a numpy-seeded
  tree, tests/test_torch_model.random_variables), read by both packages.
  The gate and IoU threshold lie in the widest gaps of the decoded rows
  of every network input the run makes (`settings_for_rows`, on the
  port's rows, which the JAX ones match far inside those gaps), so both
  packages keep the same candidates; kept values then agree within the
  forward tolerance ROW_TOL (atol 5e-3, rtol 1e-3).
  * `cli.test_widerface` (host route: two letterbox buckets; device
    route: two raw shapes): the same txt files, each with the same name
    and count lines and rows paired one to one, coordinates within 1 px
    (the writer's int(x + 0.5) can round two values a hair apart to
    neighbours) and scores within ROW_TOL plus the 3-decimal rounding;
    the same truncation report.
  * `cli.batch_predict` over 2 items of 2 frames, scales (128, 192), API
    preprocessing: the same JSON tensors (names, datatypes, shapes,
    padding), boxes within 1 px (the pipeline rounds them to pixels) and
    confidences within ROW_TOL, the same scale tags, and a max-faces
    image per item; then resume (the port alone): `--check-progress`
    says every item is done, and a second (skipping) run prints the JAX
    run's totals and rewrites nothing; with one JSON gone the item is partial,
    and `--force-restart` reprocesses every item.
"""

import io
import json
import os
import shutil
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.data.letterbox import (
    letterbox as jletterbox, preprocess_api as jpreprocess_api)
from face_detection_multi_scale_tpu.infer import production as JP
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.train.checkpoint import (
    save_inference_weights)
from face_detection_multi_scale_tpu_torch.infer import device_preprocess as DP
from face_detection_multi_scale_tpu_torch.infer.detector import (
    FaceDetector as TFaceDetector)
from face_detection_multi_scale_tpu_torch.infer import production as TP

from test_torch_detector import ROW_TOL, settings_for_rows
from test_torch_model import random_variables

MODEL = "yolov7-lite-t"
SIZE = 128
BUCKETS = ((120, 160), (160, 120))  # raw (h, w): letterboxed 96x128, 128x96
PER_BUCKET = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU forwards on one thread for this module: beside the
    other test workers, torch's thread pool oversubscribes the cores and
    runs these small convs about 100x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def frame(n, t=0.1, scale="640"):
    return {"bboxes": [[1.0, 2.0, 3.0, 4.0]] * n, "confidence": [0.9] * n,
            "class_names": ["face"] * n, "class_indexes": [0] * n,
            "class_groups": ["face"] * n, "scale_used": [scale] * n,
            "num_faces": n, "infer_time": t}


# ---------------------------------------------------------------------------
# the module's functions
# ---------------------------------------------------------------------------

def test_frames_json_and_resume_helpers(tmp_path):
    for frames in ([frame(2), frame(0), frame(3)], [frame(1)], []):
        assert TP.frames_to_json(frames, 1.5) == JP.frames_to_json(frames,
                                                                   1.5)
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    for d, shapes in ((a, (1, 2, 3)), (b, (1, 4))):
        for i, n in enumerate(shapes):
            (d / f"{i}.json").write_text(json.dumps(
                TP.frames_to_json([frame(1)] * n, 0.5 * n)))
    (a / "bad.json").write_text("{not json")
    for p in sorted(a.glob("*.json")) + [a / "missing.json"]:
        assert TP.read_existing_json(str(p)) == JP.read_existing_json(str(p))
    assert TP.compare_json_shapes(str(a), str(b)) == \
        JP.compare_json_shapes(str(a), str(b))


def test_frame_expansion_and_check_progress(tmp_path):
    base = tmp_path / "footage"
    (base / "x").mkdir(parents=True)
    for f in ("7_original_0.jpg", "7_original_1.jpg", "8_original.jpg",
              "9.jpg"):
        (base / "x" / f).write_bytes(b"")
    for path in ("x/7_original.jpg", "x/8_original.jpg", "x/9.jpg",
                 "x/10_original.jpg", "x/11.jpg"):
        assert TP.get_image_paths_from_base(path, str(base)) == \
            JP.get_image_paths_from_base(path, str(base))
    assert len(TP.get_image_paths_from_base("x/7_original.jpg",
                                            str(base))) == 2
    out, faces = tmp_path / "json", tmp_path / "faces"
    items = [("done", "a"), ("json_only", "b"), ("img_only", "c"),
             ("none", "d")]
    tpipe = TP.ProductionPipeline(None, str(out), str(faces))
    jpipe = JP.ProductionPipeline(None, str(out), str(faces))
    for item in ("done", "json_only"):
        (out / f"{item}.json").write_text(json.dumps(
            TP.frames_to_json([frame(1)], 0.1)))
    for item in ("done", "img_only"):
        (faces / f"{item}_max_1_faces.jpg").write_bytes(b"")
    got = tpipe.check_progress(items)
    assert got == jpipe.check_progress(items)
    assert got == {"done": ["done"], "partial": ["json_only", "img_only"],
                   "missing": ["none"]}


def test_dataframe_analysis_and_report(tmp_path):
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 500, (9, 2))
    dets = np.concatenate([xy, xy + rng.uniform(5, 200, (9, 2)),
                           rng.uniform(0.5, 1, (9, 1)), np.zeros((9, 1)),
                           rng.integers(-1, 3, (9, 1))], 1)
    frames = []
    for lo, hi, img in ((0, 5, "a/1.jpg"), (5, 9, "a/2.jpg")):
        got = TP.detections_to_dataframe(dets[lo:hi], img, "/r/" + img,
                                         [640, 3840])
        want = JP.detections_to_dataframe(dets[lo:hi], img, "/r/" + img,
                                          [640, 3840])
        pd.testing.assert_frame_equal(got, want)
        frames.append(got)
    df = pd.concat(frames, ignore_index=True)
    for empty in (True, False):
        d = df.iloc[:0] if empty else df
        assert TP.analyze_results(d) == JP.analyze_results(d)
    analysis = TP.analyze_results(df)
    TP.generate_report(analysis, str(tmp_path / "port.md"))
    JP.generate_report(analysis, str(tmp_path / "jax.md"))
    assert (tmp_path / "port.md").read_text() == \
        (tmp_path / "jax.md").read_text()


def test_run_shards_items_by_distributed_rank(tmp_path, monkeypatch):
    import torch.distributed as dist

    pipe = TP.ProductionPipeline(None, str(tmp_path / "j"),
                                 str(tmp_path / "f"))
    seen = []
    monkeypatch.setattr(pipe, "process_item", lambda item_id, base, skip:
                        seen.append(item_id) or (item_id, 1, 0, 0.0))
    items = [(i, f"p{i}") for i in range(7)]
    assert TP.shard_of_process() == (0, 1)
    assert [r[0] for r in pipe.run(items)] == list(range(7))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    seen.clear()
    assert [r[0] for r in pipe.run(items)] == [1, 4]
    assert [r[0] for r in pipe.run(items, shard=False)] == list(range(7))


# ---------------------------------------------------------------------------
# the CLIs against the JAX CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(the .npz both CLIs load, the port's detector on it)."""
    variables = random_variables(JZ.get_spec(MODEL), seed=7)
    path = tmp_path_factory.mktemp("w") / "lite_t.npz"
    save_inference_weights(str(path), variables)
    return str(path), TFaceDetector(MODEL, torch_weights=str(path),
                                    device="cpu")


def decoded_rows(weights, inputs):
    """The decoded rows of float NHWC inputs in [0, 1], one block an
    image, from the port's forward (within ROW_TOL of the JAX one, far
    inside the widest gaps `settings_for_rows` picks)."""
    det = weights[1]
    return [det.forward_input(torch.from_numpy(
        np.ascontiguousarray(x[None], np.float32)))[0].numpy()
        for x in inputs]


def run_cli(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def wider_corpus(tmp_path_factory):
    """A WIDER-layout val folder: wider_val.txt beside images/ with
    PER_BUCKET noise images of each BUCKETS shape."""
    import cv2

    root = tmp_path_factory.mktemp("wider")
    rng = np.random.default_rng(3)
    names = []
    for b, (h, w) in enumerate(BUCKETS):
        for i in range(PER_BUCKET):
            name = f"{b}--Event/{b}_img_{i}.jpg"
            (root / "images" / f"{b}--Event").mkdir(parents=True,
                                                    exist_ok=True)
            cv2.imwrite(str(root / "images" / name),
                        rng.integers(0, 256, (h, w, 3), np.uint8))
            names.append(name)
    (root / "wider_val.txt").write_text("\n".join(names) + "\n")
    return root, names


def read_txts(folder):
    from face_detection_multi_scale_tpu.eval.widerface import read_pred_file

    out = {}
    for dirpath, _, files in os.walk(folder):
        for f in files:
            path = os.path.join(dirpath, f)
            lines = open(path).read().splitlines()
            out[os.path.relpath(path, folder)] = (lines[:2],
                                                  read_pred_file(path)[1])
    return out


def assert_pred_rows_match(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not len(got):
        return
    pair = np.abs(got[:, None] - want[None]).max(-1).argmin(1)
    assert len(set(pair.tolist())) == len(pair), f"{what}: rows pair twice"
    want = want[pair]
    assert (np.abs(got[:, :4] - want[:, :4]) <= 1).all(), what
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=ROW_TOL["rtol"],
                               atol=ROW_TOL["atol"] + 5e-4, err_msg=what)


@pytest.mark.parametrize("device_preprocess", [False, True])
def test_test_widerface_cli_matches_jax(weights, wider_corpus, tmp_path,
                                        device_preprocess):
    import cli.test_widerface as jcli
    import cv2
    from face_detection_multi_scale_tpu_torch.cli import test_widerface as tcli

    root, names = wider_corpus
    inputs = []
    for name in names:
        img0 = cv2.imread(str(root / "images" / name))
        if device_preprocess:
            geom = DP.letterbox_geometry(img0.shape[:2], SIZE, auto=True,
                                         stride=32)
            inputs.append(DP.device_letterbox(
                torch.from_numpy(img0[None]), geom)[0].numpy())
        else:
            lb = jletterbox(img0, SIZE, stride=32, auto=True)[0]
            inputs.append(lb[:, :, ::-1].astype(np.float32) / 255.0)
    conf, iou, _ = settings_for_rows(decoded_rows(weights, inputs), None)
    outs = {}
    for pkg, mod in (("port", tcli), ("jax", jcli)):
        argv = ["--weights", weights[0], "--model", MODEL,
                "--img-size", str(SIZE), "--conf-thres", str(conf),
                "--iou-thres", str(iou), "--batch-size", str(PER_BUCKET),
                "--max-candidates", "2048",
                "--dataset_folder", str(root / "images") + "/",
                "--save_folder", str(tmp_path / pkg) + "/"]
        if device_preprocess:
            argv.append("--device-preprocess")
        if pkg == "port":
            argv += ["--device", "cpu"]
        rc, printed = run_cli(mod.main, argv)
        assert rc == 0
        outs[pkg] = (read_txts(tmp_path / pkg), printed)
    (got, got_out), (want, want_out) = outs["port"], outs["jax"]
    assert sorted(got) == sorted(want) and len(got) == len(names)
    kept = 0
    for f in got:
        assert got[f][0] == want[f][0], f  # name and count lines
        assert_pred_rows_match(got[f][1], want[f][1], f)
        kept += len(got[f][1])
    assert kept > 0
    assert got_out.splitlines()[-1] == want_out.splitlines()[-1]
    assert f"({len(BUCKETS)} shape buckets)" in got_out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    import cv2
    import pandas as pd

    root = tmp_path_factory.mktemp("corpus")
    base = root / "footage"
    rng = np.random.default_rng(0)
    rows = []
    for item in ("aaa", "bbb"):
        (base / item).mkdir(parents=True)
        for f in range(2):
            cv2.imwrite(str(base / item / f"7_original_{f}.jpg"),
                        rng.integers(0, 255, (120, 160, 3), np.uint8))
        rows.append({"item_id": item, "path": f"{item}/7_original.jpg"})
    csv = root / "items.csv"
    pd.DataFrame(rows).to_csv(csv, index=False)
    return root, csv, base


def tensors(path):
    return {t["name"]: t for t in
            json.load(open(path))["yolo_face_prediction"]}


def test_batch_predict_cli_matches_jax_with_resume(weights, corpus,
                                                   tmp_path):
    import cli.batch_predict as jcli
    import cv2
    from face_detection_multi_scale_tpu_torch.cli import batch_predict as tcli

    root, csv, base = corpus
    sizes = (128, 192)
    inputs = [jpreprocess_api(cv2.imread(str(p))[:, :, ::-1], s, 32)
              .astype(np.float32) / 255.0
              for p in sorted(base.rglob("*.jpg")) for s in sizes]
    conf, iou, _ = settings_for_rows(decoded_rows(weights, inputs), None)
    argvs = {}
    for pkg in ("port", "jax"):
        argvs[pkg] = [
            "--csv", str(csv), "--base-path", str(base),
            "--output-dir", str(tmp_path / pkg / "json"),
            "--max-faces-dir", str(tmp_path / pkg / "faces"),
            "--model", MODEL, "--weights", weights[0], "--img-sizes",
            *map(str, sizes), "--conf-thres", str(conf), "--iou-thres",
            str(iou), "--dtype", "float32", "--num-workers", "2"] + (
            ["--device", "cpu"] if pkg == "port" else [])
    mods = {"port": tcli, "jax": jcli}

    first = {pkg: run_cli(mods[pkg].main, argvs[pkg]) for pkg in mods}
    for pkg, (rc, printed) in first.items():
        assert rc == 0 and "2 items" in printed
    lines = [out.splitlines() for _, out in first.values()]
    assert lines[0][:2] == lines[1][:2]  # item count, progress
    assert lines[0][-1].split(", ")[:2] == lines[1][-1].split(", ")[:2]
    faces = 0
    for item in ("aaa", "bbb"):
        got = tensors(tmp_path / "port" / "json" / f"{item}.json")
        want = tensors(tmp_path / "jax" / "json" / f"{item}.json")
        assert got.keys() == want.keys()
        for name in got:
            assert (got[name]["datatype"], got[name]["shape"]) == \
                (want[name]["datatype"], want[name]["shape"]), name
        for f in range(got["yolo-face-bboxes"]["shape"][0]):
            g = np.array([b + [c] for b, c in zip(
                got["yolo-face-bboxes"]["data"][f],
                got["yolo-face-confidence"]["data"][f])])
            w = np.array([b + [c] for b, c in zip(
                want["yolo-face-bboxes"]["data"][f],
                want["yolo-face-confidence"]["data"][f])])
            assert_pred_rows_match(g, w, f"{item} frame {f}")
            assert sorted(got["yolo-face-scale_used"]["data"][f]) == \
                sorted(want["yolo-face-scale_used"]["data"][f])
            faces += int((g[:, 4] > 0).sum())
        for pkg in ("port", "jax"):
            assert len(list((tmp_path / pkg / "faces").glob(
                f"{item}_max_*_faces.jpg"))) == 1
    assert faces > 0

    # resume (the port alone): progress says done, and a second run skips
    # every item, rewrites nothing and prints the first run's totals
    stamp = {p: p.stat().st_mtime_ns
             for p in (tmp_path / "port" / "json").glob("*.json")}
    progress = run_cli(tcli.main, argvs["port"] + ["--check-progress"])
    assert progress[0] == 0
    assert progress[1].splitlines()[1] == \
        "progress: 2 done, 0 partial, 0 missing"
    rc, printed = run_cli(tcli.main, argvs["port"] + ["--force-continue"])
    assert rc == 0
    assert printed.splitlines()[-1].split(", ")[:2] == \
        lines[1][-1].split(", ")[:2]
    assert stamp == {p: p.stat().st_mtime_ns
                     for p in (tmp_path / "port" / "json").glob("*.json")}
    (tmp_path / "port" / "json" / "aaa.json").unlink()
    assert "1 done, 1 partial" in run_cli(
        tcli.main, argvs["port"] + ["--check-progress"])[1]
    rc, printed = run_cli(tcli.main, argvs["port"] + ["--force-restart"])
    assert rc == 0 and (tmp_path / "port" / "json" / "aaa.json").exists()
    assert stamp[tmp_path / "port" / "json" / "bbb.json"] != \
        (tmp_path / "port" / "json" / "bbb.json").stat().st_mtime_ns
    shutil.rmtree(tmp_path / "port")


def test_clis_ask_for_the_card_without_device(wider_corpus, corpus,
                                              tmp_path):
    """Without `--device` the writer and the batch CLI take the card, and
    raise here, where there is none."""
    from face_detection_multi_scale_tpu_torch.cli import batch_predict
    from face_detection_multi_scale_tpu_torch.cli import test_widerface

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    root, _ = wider_corpus
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_widerface.main(["--model", MODEL, "--dataset_folder",
                             str(root / "images") + "/", "--save_folder",
                             str(tmp_path / "w") + "/"])
    _, csv, base = corpus
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_predict.main(["--csv", str(csv), "--base-path", str(base),
                            "--model", MODEL, "--output-dir",
                            str(tmp_path / "j"), "--max-faces-dir",
                            str(tmp_path / "f")])
