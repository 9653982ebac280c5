"""The port's mAP protocol (infer/validate.py) and its CLI (cli/test.py)
against the JAX package's, on the CPU.

`validate` runs narrowed yolov7-tiny-face (width 0.25, the JAX tree from
tests/test_torch_model.random_variables through the weight bridge) over
the validation split of `data/synthetic.make_synthetic_face_dataset`,
whose labels are rewritten from the model's own detections (jittered,
and a random box an image) so that P / R / mAP are far from 0 and 1.
The gate and IoU threshold lie in the widest gaps of the decoded rows
(`settings_for_rows` of tests/test_torch_detector.py), so no decision
differs between the two forwards, which agree within the decoded-row
tolerance ROW_TOL (atol 5e-3, rtol 1e-3). With the same kept rows the matching is the same, so
mAP@.5 and mAP@.5:.95 are equal; P and R are read off a curve
interpolated at the predictions' confidences (ap_per_class), which move
within ROW_TOL, so they agree within 1e-3. The save_txt and save_json
files hold the same records, their numbers within ROW_TOL plus the
files' rounding (6 significant digits; bbox 3 decimals).

The CLI: `cli.test --task val --device cpu` on the same dataset writes the
JAX CLI's formats (normalized `cls x y w h conf` label lines, COCO records
with bbox, score and 15 keypoint values) and `--task speed` prints its
line. Without `--device` the CLI asks for the card and raises here."""

import json
import shutil

import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.data import dataset as JD
from face_detection_multi_scale_tpu.data.synthetic import (
    make_synthetic_face_dataset)
from face_detection_multi_scale_tpu.infer.validate import (
    validate as jvalidate)
from face_detection_multi_scale_tpu.models import model as JM
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu_torch.data import dataset as TD
from face_detection_multi_scale_tpu_torch.infer.detector import (
    FaceDetector as TFaceDetector)
from face_detection_multi_scale_tpu_torch.infer.validate import (
    validate as tvalidate)
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.ops import nms as TN

from test_torch_detector import (
    ROW_TOL, settings_for_rows, shared_variables)
from test_torch_model import narrowed

NAME = "yolov7-tiny-face"
SIZE = 128
PR_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU forwards on one thread for this module: beside the
    other test workers, torch's thread pool oversubscribes the cores and
    runs these small convs about 100x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_labels_from(rows_list, label_dir, rng):
    """Rewrite each image's label file from the first 3 rows of its
    detections (xyxy in the 128 px frame, which is the image itself),
    jittered, and one random box: normalized `0 cx cy w h` plus 5
    keypoints `x y 2` inside the box."""
    for path, rows in rows_list:
        lines = []
        xy = rng.uniform(10, SIZE - 50, 2)
        boxes = np.concatenate([rows[:3, :4],
                                [[*xy, *(xy + rng.uniform(10, 40, 2))]]])
        for x1, y1, x2, y2 in boxes:
            j = rng.normal(0, 3.0, 4)
            x1, y1 = np.clip([x1 + j[0], y1 + j[1]], 1, SIZE - 2)
            x2, y2 = np.clip([x2 + j[2], y2 + j[3]], x1 + 2, SIZE - 1)
            cx, cy, w, h = (x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1
            kp = []
            for _ in range(5):
                kp += [cx + rng.uniform(-w / 3, w / 3),
                       cy + rng.uniform(-h / 3, h / 3)]
            vals = [cx, cy, w, h] + kp
            vals = [v / SIZE for v in vals]
            row = [0] + vals[:4] + sum(([vals[4 + 2 * k], vals[5 + 2 * k],
                                         2.0] for k in range(5)), [])
            lines.append(" ".join(f"{v:.6f}" for v in row))
        (label_dir / path).write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(port dataset, JAX dataset, data yaml, validate keywords, JAX
    model and variables, port model): one val split, labels from the
    model's detections, a copy per package."""
    root = tmp_path_factory.mktemp("val")
    data_yaml = make_synthetic_face_dataset(str(root / "base"), n_images=16,
                                            img_size=SIZE, val_fraction=0.5,
                                            seed=11)
    val = root / "base" / "val"
    spec_j = narrowed(JZ, NAME)
    variables = shared_variables(NAME)
    tdet = TFaceDetector(narrowed(TZ, NAME), variables=variables,
                         device="cpu")
    ds0 = JD.FaceDataset(str(val / "images"), img_size=SIZE, kpt_label=5,
                         stride=spec_j.max_stride, batch_size=4)
    frames = np.stack([ds0.get(i)[0] for i in range(len(ds0))])
    # the port's rows: within ROW_TOL of the JAX ones, far inside the
    # widest gaps that settings_for_rows picks
    rows = tdet.forward_rows(frames)
    conf, iou, _ = settings_for_rows(rows.numpy(), None)
    dets = TN.detections_to_numpy(TN.non_max_suppression(
        rows, conf, iou, nc=1, max_candidates=4096, max_det=300))
    rng = np.random.default_rng(12)
    names = [ds0.img_files[i].split("/")[-1][:-4] + ".txt"
             for i in range(len(ds0))]
    write_labels_from(list(zip(names, [np.asarray(d) for d in dets])),
                      val / "labels" / "0--Syn", rng)
    (val / "labels.labels.npz").unlink(missing_ok=True)
    dirs = {}
    for pkg in ("port", "jax"):
        shutil.copytree(val, root / pkg)
        dirs[pkg] = str(root / pkg / "images")
    kw = dict(img_size=SIZE, augment=False, hyp={}, kpt_label=5,
              stride=spec_j.max_stride, batch_size=4)
    return (TD.FaceDataset(dirs["port"], **kw),
            JD.FaceDataset(dirs["jax"], **kw), data_yaml,
            dict(conf_thres=conf, iou_thres=iou, batch_size=4),
            JM.YoloFace(spec=spec_j), variables, tdet.model)


def paired(got, want):
    """`want`'s rows reordered to pair one to one with `got`'s nearest
    (max |diff| over every column), as assert_rows_match pairs rows."""
    assert got.shape == want.shape, (got.shape, want.shape)
    pair = np.abs(got[:, None] - want[None]).max(-1).argmin(1)
    assert len(set(pair.tolist())) == len(pair), "rows pair up twice"
    return want[pair]


def parse_txt(path):
    return np.array([[float(v) for v in line.split()]
                     for line in open(path)])


def test_validate_matches_jax_with_saved_files(setup, tmp_path):
    tds, jds, _, kw, jmodel, variables, tmodel = setup
    got = tvalidate(tmodel, tds, verbose=False, save_dir=tmp_path / "port",
                    save_txt=True, save_conf=True, save_json=True,
                    weights_name="w.npz", **kw)
    want = jvalidate(jmodel, variables, jds, verbose=False,
                     save_dir=tmp_path / "jax", save_txt=True,
                     save_conf=True, save_json=True, weights_name="w.npz",
                     **kw)
    assert got["images"] == want["images"] == 8
    assert got["truncated_images"] == want["truncated_images"] == 0
    assert 0.1 < want["map50"] < 0.99 and 0 < want["map"] < want["map50"]
    for key in ("map50", "map"):
        assert got[key] == want[key], (key, got[key], want[key])
    for key in ("mp", "mr"):
        assert abs(got[key] - want[key]) <= PR_TOL, (key, got, want)

    # save_txt: the same label files; lines paired up (equal-score
    # neighbours may come out in either order) within ROW_TOL over the
    # native frame (the boxes are normalized) plus %g's rounding
    tl = sorted(p.name for p in (tmp_path / "port" / "labels").iterdir())
    jl = sorted(p.name for p in (tmp_path / "jax" / "labels").iterdir())
    assert tl == jl and len(tl) == 8
    for name in tl:
        g = parse_txt(tmp_path / "port" / "labels" / name)
        w = paired(g, parse_txt(tmp_path / "jax" / "labels" / name))
        assert g.shape[1] == 6
        np.testing.assert_allclose(g, w, rtol=ROW_TOL["rtol"],
                                   atol=ROW_TOL["atol"] / SIZE + 1e-5)

    # save_json: the same records, paired up within each image, numbers
    # within ROW_TOL plus 1e-3 for the 3-decimal rounding of boxes and
    # keypoints
    tj = json.load(open(got["pred_json"]))
    jj = json.load(open(want["pred_json"]))
    assert got["pred_json"].endswith("w_predictions.json")
    assert len(tj) == len(jj) > 0
    keys = ("image_id", "category_id", "bbox", "score", "keypoints")
    assert all(tuple(r) == keys for r in tj + jj)
    for image in {r["image_id"] for r in jj}:
        g, w = ([[r["category_id"], *r["bbox"], r["score"], *r["keypoints"]]
                 for r in recs if r["image_id"] == image] for recs in (tj, jj))
        g = np.array(g)
        np.testing.assert_allclose(g, paired(g, np.array(w)),
                                   rtol=ROW_TOL["rtol"],
                                   atol=ROW_TOL["atol"] + 1e-3)


def test_cli_test_val_and_speed_on_cpu(setup, tmp_path, capsys):
    from face_detection_multi_scale_tpu_torch.cli import test as tcli

    _, _, data_yaml, _, _, _, _ = setup
    rc = tcli.main(["--model", "yolov7-lite-t", "--data", data_yaml,
                    "--img-size", "64", "--batch-size", "4",
                    "--conf-thres", "0.05", "--save-txt", "--save-conf",
                    "--save-json", "--project", str(tmp_path / "runs"),
                    "--name", "t", "--exist-ok", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "val: 8 images" in out
    run_dir = tmp_path / "runs" / "t"
    txts = sorted((run_dir / "labels").glob("*.txt"))
    assert txts
    for t in txts:
        rows = parse_txt(t)
        assert rows.shape[1] == 6 and (rows[:, 0] == 0).all()
        assert ((0 <= rows[:, 5]) & (rows[:, 5] <= 1)).all()
    records = json.load(open(run_dir / "yolov7-lite-t_predictions.json"))
    assert records and all(
        set(r) == {"image_id", "category_id", "bbox", "score", "keypoints"}
        and len(r["keypoints"]) == 15 for r in records)

    assert tcli.main(["--model", "yolov7-lite-t", "--task", "speed",
                      "--img-size", "64", "--batch-size", "2",
                      "--device", "cpu"]) == 0
    assert "ms/image inference+NMS per 64x64 image at batch-size 2" in \
        capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["--model", "yolov7-lite-t", "--task", "speed"])

